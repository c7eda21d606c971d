"""Autograd of the port's kernel Functions, on the CPU.

- ``gradcheck`` and ``gradgradcheck`` in float64 hold every hand-written
  backward rule (and the rule's own backward, which the gradient penalty
  runs) against finite differences, with torch's default tolerances.
- First- and second-order gradients against ``jax.grad`` of the JAX
  package's primitives (Pallas in interpret mode) on the same numpy
  inputs, in float32: rtol 1e-4, and atol 1e-5 times the largest element
  of the reference (the same math, float32 sums in another order, through
  two levels of derivatives; where terms cancel, an element near zero
  keeps the absolute error of its largest terms).
- The plain versions of the two kernels this slice adds against the TPU
  kernels in interpret mode: the weight gradient within rtol 1e-5 and atol
  1e-5 times its largest element (float32 sums over all pixels in another
  order); the pool exactly (both sum the four terms in the same order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.ops import pallas_conv as jconv
from pggan_tpu.ops.pallas_resample import avgpool2x_nhcw
from pggan_tpu_torch.ops import _build, resample
from pggan_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_act,
    conv3x3_act_pn,
    conv3x3_dw,
    conv3x3_dw_plain,
    supported,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SLOPE = 0.2


def _close(got, want, rtol, scaled_atol=1e-5, err_msg=""):
    """allclose with the absolute bar scaled to the reference's largest
    element."""
    atol = scaled_atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel is launched."""
    _build.LAUNCHES.clear()
    yield
    assert not _build.LAUNCHES, dict(_build.LAUNCHES)


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


# -- gradcheck / gradgradcheck in float64 ------------------------------------

N, H, C, K, W = 1, 5, 3, 6, 6  # ragged on purpose: no tile divides them


def _fn_and_inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    x = _f64(rng, N, H, C, W)
    w = _f64(rng, 3, 3, C, K, scale=0.3)
    b = _f64(rng, K, scale=0.1)
    if name == "conv3x3":
        return conv3x3, (x, w)
    if name == "conv3x3_dw":
        return conv3x3_dw, (x, _f64(rng, N, H, K, W))
    if name == "conv3x3_act":
        return functools.partial(conv3x3_act, slope=SLOPE), (x, w, b)
    if name == "conv3x3_act_pn":  # o only: r gets no cotangent
        return (lambda *a: conv3x3_act_pn(*a, slope=SLOPE)[0]), (x, w, b)
    if name == "conv3x3_act_pn_r":  # both outputs carry a cotangent
        return functools.partial(conv3x3_act_pn, slope=SLOPE), (x, w, b)
    if name == "upsample_2x":
        return (lambda t: resample.upsample_2x(t, 1, 3)), (x,)
    if name == "avg_pool_2x":
        return (lambda t: resample.avg_pool_2x(t, 1, 3)), (
            _f64(rng, N, 4, C, W),)
    if name == "avg_pool_2x_nchw":
        return (lambda t: resample.avg_pool_2x(t, 2, 3)), (
            _f64(rng, 2, C, 4, W),)
    raise KeyError(name)


FUNCTIONS = ["conv3x3", "conv3x3_dw", "conv3x3_act", "conv3x3_act_pn",
             "conv3x3_act_pn_r", "upsample_2x", "avg_pool_2x",
             "avg_pool_2x_nchw"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_gradcheck(name):
    fn, inputs = _fn_and_inputs(name)
    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_gradgradcheck(name):
    fn, inputs = _fn_and_inputs(name, seed=1)
    assert torch.autograd.gradgradcheck(fn, inputs)


@pytest.mark.parametrize("name,node", [
    ("conv3x3", "_Conv3x3"), ("conv3x3_dw", "_Conv3x3Dw"),
    ("conv3x3_act", "_Conv3x3Act"), ("conv3x3_act_pn_r", "_Conv3x3ActPn"),
    ("upsample_2x", "_Upsample2x"), ("avg_pool_2x", "_AvgPool2x")])
def test_cpu_route_runs_the_hand_written_backward(name, node):
    """The route is chosen inside each Function's forward, so the CPU
    graph holds the port's Function and not F.conv2d's own backward."""
    fn, inputs = _fn_and_inputs(name)
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    assert type(out.grad_fn).__name__.startswith(node)


def test_act_weight_gradient_is_dw_of_masked_cotangent():
    """With only w requiring grad, its gradient is the weight gradient of
    the cotangent masked by the output's sign."""
    rng = np.random.RandomState(2)
    x = _f64(rng, N, H, C, W).detach()
    w = _f64(rng, 3, 3, C, K)
    b = _f64(rng, K).detach()
    y = conv3x3_act(x, w, b, slope=SLOPE)
    gw, = torch.autograd.grad(y.sum(), w)
    assert gw.shape == w.shape
    assert torch.allclose(gw, conv3x3_dw(
        x, torch.where(y.detach() >= 0, 1.0, SLOPE).to(x.dtype)))


# -- first and second order against jax.grad ---------------------------------

JN, JH, JC, JK, JW = 1, 8, 8, 8, 128


def _jax_inputs(seed):
    rng = np.random.RandomState(seed)

    def a(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return dict(x=a(JN, JH, JC, JW), w=a(3, 3, JC, JK, scale=0.2),
                b=a(JK, scale=0.1), c1=a(JN, JH, JK, JW), cr=a(JN, JH, JW),
                c2=a(JN, JH, JC, JW), c3=a(3, 3, JC, JK))


def _jax_fwd(mode):
    if mode == "conv3x3":
        return lambda x, w, b: (jconv.conv3x3(x, w) + 0.0 * b.sum(), None)
    if mode == "conv3x3_act":
        return lambda x, w, b: (jconv.conv3x3_act(x, w, b, slope=SLOPE), None)
    return lambda x, w, b: tuple(jconv.conv3x3_act_pn_p.bind(
        x, w, b, slope=SLOPE, eps=1e-8))


def _torch_fwd(mode):
    if mode == "conv3x3":
        return lambda x, w, b: (conv3x3(x, w), None)
    if mode == "conv3x3_act":
        return lambda x, w, b: (conv3x3_act(x, w, b, slope=SLOPE), None)
    return lambda x, w, b: conv3x3_act_pn(x, w, b, slope=SLOPE, eps=1e-8)


@functools.lru_cache(maxsize=None)
def _jax_grads(mode, with_r, seed):
    """(g1 = grad of L1 over (x, w, b), g2 = grad over (x, w, b) of
    L2 = <gx, c2> + <gw, c3>), traced once per case."""
    fwd = _jax_fwd(mode)

    def l1(x, w, b, c1, cr):
        o, r = fwd(x, w, b)
        out = jnp.sum(o * c1)
        return out + jnp.sum(r * cr) if with_r else out

    def l2(x, w, b, c1, cr, c2, c3):
        gx, gw, _gb = jax.grad(l1, argnums=(0, 1, 2))(x, w, b, c1, cr)
        return jnp.sum(gx * c2) + jnp.sum(gw * c3)

    d = {k: jnp.asarray(v) for k, v in _jax_inputs(seed).items()}
    args = (d["x"], d["w"], d["b"], d["c1"], d["cr"])
    g1 = jax.jit(jax.grad(l1, argnums=(0, 1, 2)))(*args)
    g2 = jax.jit(jax.grad(l2, argnums=(0, 1, 2)))(*args, d["c2"], d["c3"])
    return [np.asarray(t) for t in g1], [np.asarray(t) for t in g2]


@pytest.mark.parametrize("mode,with_r", [
    ("conv3x3", False), ("conv3x3_act", False), ("conv3x3_act_pn", False),
    ("conv3x3_act_pn", True)])
def test_first_and_second_order_grads_match_jax(mode, with_r):
    seed = 3
    want1, want2 = _jax_grads(mode, with_r, seed)
    d = {k: torch.from_numpy(v) for k, v in _jax_inputs(seed).items()}
    x, w, b = (d[k].clone().requires_grad_(True) for k in ("x", "w", "b"))
    o, r = _torch_fwd(mode)(x, w, b)
    l1 = torch.sum(o * d["c1"])
    if with_r:
        l1 = l1 + torch.sum(r * d["cr"])
    got1 = torch.autograd.grad(l1, (x, w, b), create_graph=True,
                               allow_unused=True, materialize_grads=True)
    l2 = torch.sum(got1[0] * d["c2"]) + torch.sum(got1[1] * d["c3"])
    got2 = torch.autograd.grad(l2, (x, w, b), allow_unused=True,
                               materialize_grads=True)
    for name, g, want in zip(("gx", "gw", "gb"), got1, want1):
        _close(g.detach().numpy(), want, 1e-4, err_msg=f"first order {name}")
    for name, g, want in zip(("ggx", "ggw", "ggb"), got2, want2):
        _close(g.numpy(), want, 1e-4, err_msg=f"second order {name}")


# -- the new kernels' plain versions against the TPU kernels ------------------

@pytest.mark.parametrize("n,h,c,k,w", [(2, 8, 8, 16, 128), (1, 16, 16, 8, 128)])
def test_dw_plain_matches_jax_dw(n, h, c, k, w):
    rng = np.random.RandomState(4)
    x = rng.randn(n, h, c, w).astype(np.float32)
    ct = rng.randn(n, h, k, w).astype(np.float32)
    got = conv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(ct)).numpy()
    assert got.shape == (3, 3, c, k)
    einsum = np.asarray(jconv._dw_einsum(jnp.asarray(x), jnp.asarray(ct)))
    kernel = np.asarray(jconv.conv3x3_dw_small_c(
        jnp.asarray(x), jnp.asarray(ct), interpret=True))
    _close(got, einsum, 1e-5)
    _close(got, kernel, 1e-5)
    # and the Function's CPU route is the plain version
    np.testing.assert_array_equal(
        conv3x3_dw(torch.from_numpy(x), torch.from_numpy(ct)).numpy(), got)


@pytest.mark.parametrize("n,h,c,w", [(1, 4, 8, 256), (2, 8, 16, 512)])
def test_pool_plain_matches_jax_kernel_exactly(n, h, c, w):
    x = np.random.RandomState(5).randn(n, h, c, w).astype(np.float32)
    want = np.asarray(avgpool2x_nhcw(jnp.asarray(x), interpret=True))
    got = resample.avgpool2x_plain(torch.from_numpy(x), 1, 3).numpy()
    assert got.shape == (n, h // 2, c, w // 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        resample.avg_pool_2x(torch.from_numpy(x), 1, 3).numpy(), want)


def test_pool_and_upsample_are_transposes():
    """<up(x), y> == <x, 4 pool(y)>, in float64."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 3, 4, 5))
    y = torch.from_numpy(rng.randn(2, 6, 4, 10))
    lhs = torch.sum(resample.upsample_2x(x, 1, 3) * y)
    rhs = torch.sum(x * 4.0 * resample.avg_pool_2x(y, 1, 3))
    assert torch.allclose(lhs, rhs, rtol=1e-12, atol=1e-12)


# -- contracts ------------------------------------------------------------------

def test_k_split_rule():
    """K = 128 runs without pixelnorm (groups of 64 on the card) and
    matches the TPU kernel; with pixelnorm it is refused."""
    assert supported((2, 8, 64, 128), (3, 3, 64, 128))
    assert not supported((2, 8, 64, 128), (3, 3, 64, 128), pixelnorm=True)
    rng = np.random.RandomState(7)
    x = rng.randn(1, 8, 8, 128).astype(np.float32)
    w = (rng.randn(3, 3, 8, 128) * 0.2).astype(np.float32)
    b = (rng.randn(128) * 0.1).astype(np.float32)
    want = jconv.conv3x3_act_small_c(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), slope=SLOPE,
                                     interpret=True)
    got = conv3x3_act(*map(torch.from_numpy, (x, w, b)), slope=SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="pixelnorm"):
        conv3x3_act_pn(*map(torch.from_numpy, (x, w, b)), slope=SLOPE)


@pytest.mark.parametrize("dtype,ok", [(torch.float32, True),
                                      (torch.float64, True),
                                      (torch.float16, False)])
def test_cpu_route_dtypes(dtype, ok):
    x = torch.randn(1, 4, 3, 6, dtype=dtype)
    w = torch.randn(3, 3, 3, 5, dtype=dtype)
    ct = torch.randn(1, 4, 5, 6, dtype=dtype)
    calls = [lambda: conv3x3(x, w), lambda: conv3x3_dw(x, ct),
             lambda: resample.avg_pool_2x(x, 1, 3),
             lambda: resample.upsample_2x(x, 1, 3)]
    for call in calls:
        if ok:
            assert call().dtype == dtype
        else:
            with pytest.raises(TypeError, match="float32"):
                call()


def test_dw_shape_mismatch_raises():
    with pytest.raises(ValueError, match="conv3x3_dw"):
        conv3x3_dw(torch.randn(1, 4, 3, 6), torch.randn(1, 4, 5, 7))
