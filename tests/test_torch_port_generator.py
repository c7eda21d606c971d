"""pggan_tpu_torch Generator against pggan_tpu's Generator.apply on the CPU.

Both packages get the same parameters (the JAX init, carried across by
``params_from_jax``) and the same latents (numpy). The JAX side runs its
Pallas tail in interpret mode (tests/conftest.py), the port its plain
versions. The bar is tests/test_torch_parity_network.py's: rtol 2e-3,
atol 3e-4. A jitted JAX apply that reaches Pallas costs ~10 s here, so each
depth-5 reference is computed once and held against both the port's
chain-on and chain-off outputs; depths 0-4 never reach Pallas and sweep
fused_scale.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from pggan_tpu.models import Generator as JGenerator
from pggan_tpu_torch.checkpoint import (
    model_config,
    params_from_jax,
    params_to_jax,
)
from pggan_tpu_torch.models.generator import CONFIG_FIELDS, Generator

SHAPE = (8, 3, 128, 128)
SMALL = dict(fmap_base=512, fmap_max=32, latent_size=16)
NET_TOL = dict(rtol=2e-3, atol=3e-4)


@functools.lru_cache(maxsize=None)
def _jax_params():
    g = JGenerator(SHAPE, **SMALL)
    return jax.tree_util.tree_map(np.asarray, g.init(jax.random.PRNGKey(0)))


def _latents(n=2, seed=2):
    return np.random.RandomState(seed).randn(n, SMALL["latent_size"]).astype(
        np.float32)


def _port(**kw) -> Generator:
    G = Generator(SHAPE, **SMALL, **kw)
    G.load_state_dict(params_from_jax(_jax_params()))
    return G


def _jax_images(depth, alpha, fade, **kw):
    g = JGenerator(SHAPE, **SMALL, **kw)
    fn = jax.jit(lambda p, z: g.apply(p, z, depth, alpha, fade))
    return np.asarray(fn(_jax_params(), _latents()))


def _port_images(G, depth, alpha, fade):
    with torch.no_grad():
        return G(torch.from_numpy(_latents()), depth, alpha, fade).numpy()


# -- (b) carrying weights across ---------------------------------------------

def test_params_round_trip_exactly():
    tree = _jax_params()
    G = Generator(SHAPE, **SMALL)
    G.load_state_dict(params_from_jax(tree))
    back = params_to_jax(G)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    assert isinstance(back["blocks"], tuple)
    assert G.block0["c1"]["w"].shape == (32, 16, 4, 4)  # OIHW


def test_port_init_matches_jax_tree_structure():
    """A fresh port Generator has the JAX init's tree, shapes and layer
    distributions (the random streams differ)."""
    G = Generator(SHAPE, **SMALL, generator=torch.Generator().manual_seed(1))
    mine = params_to_jax(G)
    ref = _jax_params()
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    w = np.concatenate([b["c2"]["w"].ravel() for b in mine["blocks"]])
    assert abs(w.std() - 1.0) < 0.05


def test_config_fields_match_jax_dataclass():
    import dataclasses
    jfields = tuple(f.name for f in dataclasses.fields(JGenerator)
                    if f.name != "dtype")
    assert CONFIG_FIELDS == jfields
    G = Generator(SHAPE, fmap_base=512, fmap_max=32, latent_size=None)
    assert model_config(G)["latent_size"] == G.nf(0) == 32


# -- (c) the Generator against JAX apply --------------------------------------

@pytest.mark.parametrize("fused_scale", [True, False])
@pytest.mark.parametrize("fade,alpha", [(True, 0.3), (False, 1.0)])
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
def test_generator_matches_jax_low_depths(depth, fade, alpha, fused_scale):
    want = _jax_images(depth, alpha, fade, fused_scale=fused_scale)
    got = _port_images(_port(fused_scale=fused_scale), depth, alpha, fade)
    assert got.shape == (2, 4 * 2 ** depth, 4 * 2 ** depth, 3)
    np.testing.assert_allclose(got, want, **NET_TOL)


@pytest.mark.parametrize("fade,alpha", [(True, 0.4), (False, 1.0)])
def test_generator_matches_jax_through_the_tail(fade, alpha):
    """Depth 5 at 128 px: the NHCW tail (stage 4 on) runs Pallas on the JAX
    side and the kernels' plain versions here, with the chain on and off,
    fused_scale on and off for the low-res stages."""
    G = _port()
    assert G._pallas_tail_start(5) == 4
    want = _jax_images(5, alpha, fade)
    for chain in (True, False):
        for fused in (True, False):
            G.inference_chain, G.fused_scale = chain, fused
            got = _port_images(G, 5, alpha, fade)
            np.testing.assert_allclose(got, want, **NET_TOL,
                                       err_msg=f"chain={chain} fused={fused}")


def test_stable_graph_equals_fade_at_alpha_one():
    G = _port(inference_chain=True)
    a = _port_images(G, 5, 1.0, True)
    b = _port_images(G, 5, 1.0, False)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_tail_off_matches_tail_on():
    """pallas_tail=False serves the whole net on F.conv2d; same images."""
    a = _port_images(_port(), 5, 0.6, True)
    b = _port_images(_port(pallas_tail=False), 5, 0.6, True)
    np.testing.assert_allclose(a, b, **NET_TOL)


@pytest.mark.parametrize("leakyrelu,pixelnorm", [(False, True), (True, False)])
def test_generator_variants_match_jax_at_low_depth(leakyrelu, pixelnorm):
    kw = dict(leakyrelu=leakyrelu, pixelnorm=pixelnorm)
    want = _jax_images(3, 0.5, True, **kw)
    got = _port_images(_port(**kw), 3, 0.5, True)
    np.testing.assert_allclose(got, want, **NET_TOL)


# -- (h) contracts -----------------------------------------------------------

def test_bfloat16_raises():
    """bf16 builds (ported since the bf16 slice, without the tail:
    tests/test_torch_port_bf16.py); an unknown compute dtype raises."""
    assert Generator(SHAPE, **SMALL,
                     compute_dtype="bfloat16")._pallas_tail_start(5) is None
    with pytest.raises(ValueError, match="compute_dtype"):
        Generator(SHAPE, **SMALL, compute_dtype="float16")


def test_depth_out_of_range_raises():
    with pytest.raises(ValueError):
        _port()(torch.zeros(1, 16), 6, 1.0)


def test_tail_under_grad_raises():
    """The tail's kernels are forward-only: a forward that builds a graph
    through them raises (the training slice adds autograd)."""
    G = _port(inference_chain=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        G(torch.zeros(1, 16), 5, 1.0)
