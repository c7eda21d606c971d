"""pggan_tpu_torch Discriminator (and D's share of the primitives) against
pggan_tpu's ``Discriminator.apply`` on the CPU.

Both packages get the same parameters (the JAX init, carried across by
``d_params_from_jax``) and the same images (numpy). The JAX side runs its
Pallas head in interpret mode (tests/conftest.py), the port its plain
versions. The network bar is tests/test_torch_parity_network.py's: rtol
2e-3, atol 3e-4; single ops rtol/atol 1e-5 (float32 sums in another order).
Each JAX reference is traced once (``lru_cache``); depth 5 (128 px) reaches
the NHCW head.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.models import Discriminator as JDiscriminator
from pggan_tpu.ops import primitives as jprim
from pggan_tpu_torch.checkpoint import d_params_from_jax, d_params_to_jax
from pggan_tpu_torch.models.discriminator import CONFIG_FIELDS, Discriminator
from pggan_tpu_torch.ops import _build, primitives

SHAPE = (8, 3, 128, 128)
SMALL = dict(fmap_base=512, fmap_max=32)
NET_TOL = dict(rtol=2e-3, atol=3e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 4


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel is launched."""
    _build.LAUNCHES.clear()
    yield
    assert not _build.LAUNCHES, dict(_build.LAUNCHES)


@functools.lru_cache(maxsize=None)
def _jax_params():
    d = JDiscriminator(SHAPE, **SMALL)
    return jax.tree_util.tree_map(np.asarray, d.init(jax.random.PRNGKey(1)))


def _images(depth, seed=3):
    res = 4 * 2 ** depth
    return np.random.RandomState(seed).randn(BATCH, res, res, 3).astype(
        np.float32)


def _port(**kw) -> Discriminator:
    D = Discriminator(SHAPE, **SMALL, **kw)
    D.load_state_dict(d_params_from_jax(_jax_params()))
    return D


@functools.lru_cache(maxsize=None)
def _jax_scores(depth, alpha, fade, stat_groups, fused_scale=True):
    d = JDiscriminator(SHAPE, **SMALL, fused_scale=fused_scale)
    fn = jax.jit(lambda p, x: d.apply(p, x, depth, alpha, fade,
                                      stat_groups=stat_groups))
    return np.asarray(fn(_jax_params(), _images(depth)))


def _port_scores(D, depth, alpha, fade, stat_groups=1):
    with torch.no_grad():
        return D(torch.from_numpy(_images(depth)), depth, alpha, fade,
                 stat_groups=stat_groups).numpy()


# -- carrying weights across ---------------------------------------------------

def test_d_params_round_trip_exactly():
    tree = _jax_params()
    back = d_params_to_jax(_port())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    assert isinstance(back["blocks"], tuple)


def test_port_init_matches_jax_tree_structure():
    """A fresh port D has the JAX init's tree and shapes (the random
    streams differ), its dense layer torch.nn.Linear's (out, in) weight."""
    D = Discriminator(SHAPE, **SMALL, generator=torch.Generator().manual_seed(2))
    mine, ref = d_params_to_jax(D), _jax_params()
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert D.linear["w"].shape == (1, 32)
    assert D.blocks[-1]["c1"]["w"].shape == (32, 33, 3, 3)  # + stddev channel


def test_config_fields_match_jax_dataclass():
    jfields = tuple(f.name for f in dataclasses.fields(JDiscriminator)
                    if f.name != "dtype")
    assert CONFIG_FIELDS == jfields


# -- the Discriminator against JAX apply ----------------------------------------

@pytest.mark.parametrize("stat_groups", [1, 2])
@pytest.mark.parametrize("fade,alpha", [(True, 0.3), (False, 1.0)])
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5])
def test_discriminator_matches_jax(depth, fade, alpha, stat_groups):
    D = _port()
    assert D._pallas_span(depth) == JDiscriminator(
        SHAPE, **SMALL)._pallas_span(depth)
    want = _jax_scores(depth, alpha, fade, stat_groups)
    got = _port_scores(D, depth, alpha, fade, stat_groups)
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got, want, **NET_TOL)


def test_depth5_runs_the_nhcw_head():
    D = _port()
    assert D._pallas_span(5) == 1
    off = _port(pallas_tail=False)
    assert off._pallas_span(5) == 0
    np.testing.assert_allclose(_port_scores(off, 5, 0.3, True),
                               _jax_scores(5, 0.3, True, 1), **NET_TOL)


@pytest.mark.parametrize("depth", [1, 3])
def test_fused_scale_off_matches_jax(depth):
    want = _jax_scores(depth, 0.6, True, 1, fused_scale=False)
    got = _port_scores(_port(fused_scale=False), depth, 0.6, True)
    np.testing.assert_allclose(got, want, **NET_TOL)
    fused = _port_scores(_port(), depth, 0.6, True)
    np.testing.assert_allclose(got, fused, **NET_TOL)


def test_stat_groups_equals_separate_calls():
    """D(cat(a, b), stat_groups=2) == cat(D(a), D(b)): the paired pass."""
    D = _port()
    x = torch.from_numpy(_images(5))
    with torch.no_grad():
        both = D(x, 5, 0.5, True, stat_groups=2)
        sep = torch.cat([D(x[:2], 5, 0.5, True), D(x[2:], 5, 0.5, True)])
    np.testing.assert_allclose(both.numpy(), sep.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_depth_out_of_range_and_bf16_raise():
    with pytest.raises(ValueError):
        _port()(torch.zeros(1, 256, 256, 3), 6, 1.0)
    with pytest.raises(NotImplementedError):
        Discriminator(SHAPE, **SMALL, compute_dtype="bfloat16")


# -- D's share of the primitives -------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_minibatch_stddev_matches_jax(groups):
    x = np.random.RandomState(4).randn(4, 5, 3, 3).astype(np.float32)  # NCHW
    want = jprim.minibatch_stddev(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                  groups=groups)
    got = primitives.minibatch_stddev(torch.from_numpy(x), groups=groups)
    assert got.shape == (4, 6, 3, 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)


def _layer_pair(rng, ksize, c, k):
    w = rng.randn(ksize, ksize, c, k).astype(np.float32)
    b = (rng.randn(k) * 0.1).astype(np.float32)
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
             "b": torch.from_numpy(b)})


def test_pool_in_conv_matches_jax_and_the_composition():
    rng = np.random.RandomState(5)
    jp, tp = _layer_pair(rng, 1, 3, 8)
    x = rng.randn(2, 3, 8, 6).astype(np.float32)  # NCHW
    want = jprim.equalized_conv2d_pool_in(jp, jnp.asarray(
        x.transpose(0, 2, 3, 1)))
    got = primitives.equalized_conv2d_pool_in(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)
    composed = primitives.equalized_conv2d(
        tp, primitives.avg_pool_2x(torch.from_numpy(x)), padding=0,
        use_pixelnorm=False)
    np.testing.assert_allclose(got.numpy(), composed.numpy(), **TOL)


def test_dense_and_nchw_pool_match_jax():
    rng = np.random.RandomState(6)
    w = rng.randn(16, 1).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    x = rng.randn(3, 16).astype(np.float32)
    want = jprim.equalized_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x))
    got = primitives.equalized_dense(
        {"w": torch.from_numpy(w.T.copy()), "b": torch.from_numpy(b)},
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    img = rng.randn(2, 3, 6, 10).astype(np.float32)
    want = jprim.avg_pool_2x(jnp.asarray(img.transpose(0, 2, 3, 1)))
    got = primitives.avg_pool_2x(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-6, atol=1e-7)


def test_dense_init_distribution():
    g = torch.Generator().manual_seed(0)
    p = primitives.dense_init(g, 64, 1)
    assert p["w"].shape == (1, 64) and p["b"].shape == (1,)
    assert float(p["w"].abs().max()) <= 1.0 / 8.0
