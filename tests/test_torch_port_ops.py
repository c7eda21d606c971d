"""pggan_tpu_torch ops against pggan_tpu on the CPU.

Each kernel's plain PyTorch version (the route a CPU tensor takes through
the wrapper) is held against the JAX function it ports, run as the JAX
package's own tests run it: Pallas in interpret mode (tests/conftest.py).
The same inputs come from numpy seeds. Tolerances: the upsample is a copy
and must match exactly; convs differ only in the order of f32 sums, so
rtol/atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pggan_tpu.ops import primitives as jprim
from pggan_tpu.ops import spatial as jspatial
from pggan_tpu.ops.pallas_chain import conv3x3_chain as j_chain
from pggan_tpu.ops.pallas_conv import conv3x3_act_small_c, conv3x3_small_c
from pggan_tpu.ops.pallas_resample import upsample2x_nhcw
from pggan_tpu_torch.ops import _build, primitives, resample, spatial
from pggan_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_act,
    conv3x3_act_pn,
    k_tier,
    supported,
)
from pggan_tpu_torch.ops.conv_chain import chain_supported, conv3x3_chain

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors must take the plain versions: no kernel is launched."""
    _build.LAUNCHES.clear()
    yield
    assert not _build.LAUNCHES, dict(_build.LAUNCHES)


# -- (a) each kernel's plain version against the TPU kernel in interpret mode

@pytest.mark.parametrize("n,h,c,w", [(1, 8, 8, 128), (2, 4, 16, 128)])
def test_upsample_matches_jax_kernel_exactly(n, h, c, w):
    x = _np(np.random.RandomState(0), n, h, c, w)
    want = np.asarray(upsample2x_nhcw(jnp.asarray(x), interpret=True))
    got = resample.upsample_2x(_t(x), h_axis=1, w_axis=3).numpy()
    assert got.shape == (n, 2 * h, c, 2 * w)
    np.testing.assert_array_equal(got, want)


# T = H / th row tiles of the TPU kernel: 1, 2 and 4
CONV_CASES = [
    (2, 8, 8, 16, 128, 8),     # T=1
    (1, 16, 16, 8, 128, 8),    # T=2
    (1, 32, 8, 8, 128, 8),     # T=4
    (1, 16, 12, 20, 128, 8),   # channel counts off the 8-grid (interpret)
]


def _conv_inputs(n, h, c, k, w, seed=0):
    rng = np.random.RandomState(seed)
    return (_np(rng, n, h, c, w), _np(rng, 3, 3, c, k, scale=0.2),
            _np(rng, k, scale=0.1))


@pytest.mark.parametrize("n,h,c,k,w,th", CONV_CASES)
def test_conv3x3_matches_jax_kernel(n, h, c, k, w, th):
    x, wt, _b = _conv_inputs(n, h, c, k, w)
    want = conv3x3_small_c(jnp.asarray(x), jnp.asarray(wt), interpret=True,
                           th=th)
    got = conv3x3(_t(x), _t(wt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,h,c,k,w,th", CONV_CASES)
def test_conv3x3_act_matches_jax_kernel(n, h, c, k, w, th):
    x, wt, b = _conv_inputs(n, h, c, k, w, seed=1)
    want = conv3x3_act_small_c(jnp.asarray(x), jnp.asarray(wt),
                               jnp.asarray(b), slope=0.2, interpret=True,
                               th=th)
    got = conv3x3_act(_t(x), _t(wt), _t(b), slope=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,h,c,k,w,th", CONV_CASES)
def test_conv3x3_act_pn_matches_jax_kernel(n, h, c, k, w, th):
    x, wt, b = _conv_inputs(n, h, c, k, w, seed=2)
    want_o, want_r = conv3x3_act_small_c(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), slope=0.2,
        pn_eps=1e-8, interpret=True, th=th)
    o, r = conv3x3_act_pn(_t(x), _t(wt), _t(b), slope=0.2, eps=1e-8)
    assert r.shape == (n, h, w)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), **TOL)


CHAIN_CASES = [
    (2, 8, 8, 16, 8, 128, 1e-8, 8),    # T=1, pixelnorm on
    (1, 16, 16, 8, 8, 128, None, 8),   # T=2, pixelnorm off
    (1, 16, 8, 8, 16, 128, 1e-8, 8),   # T=2, pixelnorm on
    (1, 32, 8, 8, 8, 128, None, 8),    # T=4, pixelnorm off
    (1, 32, 8, 8, 8, 128, 1e-8, 8),    # T=4, pixelnorm on
]


@pytest.mark.parametrize("n,h,c,k1,k2,w,pn,th", CHAIN_CASES)
def test_chain_matches_jax_kernel(n, h, c, k1, k2, w, pn, th):
    rng = np.random.RandomState(3)
    x = _np(rng, n, h, c, w)
    w1, b1 = _np(rng, 3, 3, c, k1, scale=0.2), _np(rng, k1, scale=0.1)
    w2, b2 = _np(rng, 3, 3, k1, k2, scale=0.2), _np(rng, k2, scale=0.1)
    want = j_chain(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                   slope=0.2, pn_eps=pn, interpret=True, th=th)
    got = conv3x3_chain(*(_t(a) for a in (x, w1, b1, w2, b2)), slope=0.2,
                        pn_eps=pn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the modules around the kernels ------------------------------------------

def _layer_pair(rng, ksize, c, k):
    """The same layer for both packages: JAX {"w": HWIO, "b"}, port
    {"w": OIHW, "b"}."""
    w = _np(rng, ksize, ksize, c, k)
    b = _np(rng, k, scale=0.1)
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": _t(w.transpose(3, 2, 0, 1)), "b": _t(b)})


@pytest.mark.parametrize("use_pn", [True, False])
@pytest.mark.parametrize("act", ["lrelu", "relu"])
def test_conv3x3_block_matches_jax(act, use_pn):
    rng = np.random.RandomState(4)
    jp, tp = _layer_pair(rng, 3, 8, 16)
    x = _np(rng, 2, 16, 8, 128)
    want = jspatial.conv3x3_block(jp, jnp.asarray(x), act=act,
                                  use_pixelnorm=use_pn)
    got = spatial.conv3x3_block(tp, _t(x), act=act, use_pixelnorm=use_pn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pn", [True, False])
def test_conv3x3_block_pair_matches_jax(use_pn):
    rng = np.random.RandomState(5)
    jp1, tp1 = _layer_pair(rng, 3, 16, 8)
    jp2, tp2 = _layer_pair(rng, 3, 8, 8)
    x = _np(rng, 1, 16, 16, 128)
    assert spatial.chain_pair_supported(x.shape, tp1, tp2)
    want = jspatial.conv3x3_block_pair(jp1, jp2, jnp.asarray(x),
                                       use_pixelnorm=use_pn)
    got = spatial.conv3x3_block_pair(tp1, tp2, _t(x), use_pixelnorm=use_pn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act,use_pn", [(None, False), ("lrelu", True)])
def test_conv1x1_matches_jax(act, use_pn):
    rng = np.random.RandomState(6)
    jp, tp = _layer_pair(rng, 1, 8, 3)
    x = _np(rng, 2, 4, 8, 16)
    want = jspatial.conv1x1(jp, jnp.asarray(x), act=act, use_pixelnorm=use_pn)
    got = spatial.conv1x1(tp, _t(x), act=act, use_pixelnorm=use_pn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ksize,pad,act,use_pn", [
    (3, 1, "lrelu", True), (4, 3, "lrelu", True), (1, 0, None, False),
    (3, 1, "relu", False)])
def test_equalized_conv2d_matches_jax(ksize, pad, act, use_pn):
    rng = np.random.RandomState(7)
    jp, tp = _layer_pair(rng, ksize, 8, 16)
    x = _np(rng, 2, 8, 6, 6)  # NCHW
    want = jprim.equalized_conv2d(jp, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                  padding=pad, act=act, use_pixelnorm=use_pn)
    got = primitives.equalized_conv2d(tp, _t(x), padding=pad, act=act,
                                      use_pixelnorm=use_pn)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w", [(4, 4), (5, 7)])
def test_equalized_conv2d_up2x_matches_jax(h, w):
    """The transposed-conv form of the fused-scale conv equals the JAX
    package's dilated conv, and upsample-then-conv up to reassociation."""
    rng = np.random.RandomState(8)
    jp, tp = _layer_pair(rng, 3, 8, 16)
    x = _np(rng, 2, 8, h, w)
    want = jprim.equalized_conv2d_up2x(jp, jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = primitives.equalized_conv2d_up2x(tp, _t(x))
    assert got.shape == (2, 16, 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)
    composed = primitives.equalized_conv2d(
        tp, primitives.upsample_nearest_2x(_t(x)))
    np.testing.assert_allclose(got.numpy(), composed.numpy(), **TOL)


def test_pixelnorm_and_constants_match_jax():
    x = _np(np.random.RandomState(9), 2, 8, 3, 5)
    want = jprim.pixelnorm(jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = primitives.pixelnorm(_t(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)
    for s in range(10):
        assert primitives.nf(s) == jprim.nf(s)
        assert primitives.nf(s, 512, 1.0, 32) == jprim.nf(s, 512, 1.0, 32)
    assert primitives.he_constant(9 * 64) == jprim.he_constant(9 * 64)
    lr = primitives.leaky_relu(_t(x))
    np.testing.assert_array_equal(lr.numpy(),
                                  np.asarray(jprim.leaky_relu(jnp.asarray(x))))


def test_nchw_upsample_matches_jax_exactly():
    x = _np(np.random.RandomState(10), 2, 3, 4, 5)
    want = jprim.upsample_nearest_2x(jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = primitives.upsample_nearest_2x(_t(x))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


@pytest.mark.parametrize("res,cin,cout", [
    (64, 32, 32), (128, 32, 16), (128, 64, 32), (256, 64, 32), (256, 128, 64),
    (512, 32, 16), (1024, 16, 8), (1024, 12, 8), (384, 16, 8)])
def test_stage_envelope_matches_jax(res, cin, cout):
    assert (spatial.stage_in_envelope(res, cin, cout)
            == jspatial.stage_in_envelope(res, cin, cout))


def test_conv_init_distributions():
    """The streams differ from JAX's; the distributions do not."""
    g = torch.Generator().manual_seed(0)
    p = primitives.conv_init(g, 3, 64, 32)
    assert p["w"].shape == (32, 64, 3, 3) and p["b"].shape == (32,)
    assert abs(float(p["w"].std()) - 1.0) < 0.05
    bound = 1.0 / np.sqrt(9 * 64)
    assert float(p["b"].abs().max()) <= bound
    q = primitives.conv_init(g, 3, 64, 32, wscale=False)
    assert float(q["w"].abs().max()) <= bound
    again = primitives.conv_init(torch.Generator().manual_seed(0), 3, 64, 32)
    assert torch.equal(again["w"], p["w"])


# -- the wrappers' contracts -------------------------------------------------

def test_kernel_shape_gates():
    assert supported((2, 16, 64, 256), (3, 3, 64, 32))
    assert supported((1, 37, 5, 45), (3, 3, 5, 7))  # ragged shapes too
    # more than one K tile: groups of 64 without pixelnorm, refused with it
    assert supported((2, 16, 64, 256), (3, 3, 64, 65))
    assert not supported((2, 16, 64, 256), (3, 3, 64, 65), pixelnorm=True)
    assert not supported((2, 16, 64, 256), (3, 3, 32, 32))  # C mismatch
    assert not supported((2, 16, 64, 256), (1, 1, 64, 32))
    assert chain_supported((16, 256, 64, 256), (3, 3, 64, 32), (3, 3, 32, 32))
    assert chain_supported((1, 33, 8, 45), (3, 3, 8, 8), (3, 3, 8, 8))
    assert not chain_supported((1, 8, 8, 8), (3, 3, 8, 8), (3, 3, 16, 8))
    # the chain streams input channels in chunks of 8, so shared memory no
    # longer grows with C: C = 128 fits; more than 64 channels out does not
    assert chain_supported((1, 8, 128, 8), (3, 3, 128, 64), (3, 3, 64, 8))
    assert not chain_supported((1, 8, 128, 8), (3, 3, 128, 65),
                               (3, 3, 65, 8))
    assert not chain_supported((1, 8, 8, 8), (3, 3, 8, 8), (3, 3, 8, 65))
    assert [k_tier(k) for k in (1, 8, 9, 16, 24, 32, 64)] == \
        [8, 8, 16, 16, 32, 32, 64]
    with pytest.raises(ValueError):
        k_tier(65)


def test_chain_raises_under_requires_grad():
    x = torch.randn(1, 8, 8, 16, requires_grad=True)
    w1, w2 = torch.randn(3, 3, 8, 8), torch.randn(3, 3, 8, 8)
    b = torch.zeros(8)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv3x3_chain(x, w1, b, w2, b, slope=0.2, pn_eps=1e-8)
    with torch.no_grad():
        assert conv3x3_chain(x, w1, b, w2, b, slope=0.2,
                             pn_eps=1e-8).shape == (1, 8, 8, 16)


def test_other_devices_raise():
    x = torch.empty(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        resample.upsample_2x(x, 1, 3)
