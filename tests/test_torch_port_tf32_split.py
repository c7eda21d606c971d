"""The arithmetic of the conv, weight-gradient and chain kernels (the split
in ``csrc/hopper.cuh``), held on the CPU: each f32 operand is split into
two TF32 values, a = hi + lo, and a product is taken as three TF32 products
(hi hi + hi lo + lo hi), which keeps the plain version's tolerances, where
a single TF32 product does not. The tensor cores multiply TF32 values
exactly and sum in f32; here the sums run in float64, so the tests hold
the split alone."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pggan_tpu_torch.ops import conv3x3 as C

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

SHAPES = [(8, 8), (64, 128), (128, 64)]  # (C, K); C = 128 as in the D head


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits' range
    to the magnitude bits and clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def three_products(fn, a, b):
    """fn(a, b) with each product taken as hi hi + hi lo + lo hi of the
    TF32 halves, summed in float64, rounded to f32 at the end."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = lambda t: t.double()  # noqa: E731
    return (fn(d(al), d(bh)) + fn(d(ah), d(bl)) + fn(d(ah), d(bh))).float()


def one_product(fn, a, b):
    return fn(tf32(a).double(), tf32(b).double()).float()


def _inputs(c, k, dw: bool):
    rng = np.random.RandomState(c * 1000 + k)
    x = torch.from_numpy(rng.randn(2, 16, c, 16).astype(np.float32))
    if dw:
        other = torch.from_numpy(rng.randn(2, 16, k, 16).astype(np.float32))
    else:  # He-scaled, as the layers' weights
        other = torch.from_numpy(
            (rng.randn(3, 3, c, k) * np.sqrt(2.0 / (9 * c))).astype(
                np.float32))
    return x, other


def _close(got, want, tol):
    if "scaled_atol" in tol:
        tol = dict(rtol=tol["rtol"],
                   atol=tol["scaled_atol"] * float(want.abs().max()))
    return torch.allclose(got, want, **tol), float((got - want).abs().max())


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    a = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0]
    assert tf32(a).tolist() == want
    hi, lo = split(a)  # hi + lo keeps 22 significant bits of a
    assert torch.all((hi + lo - a).abs() <= 2.0 ** -22 * a.abs())


@pytest.mark.parametrize("c, k", SHAPES)
@pytest.mark.parametrize("op", ["conv", "dw"])
def test_three_products_keep_the_plain_tolerance(op, c, k):
    x, other = _inputs(c, k, op == "dw")
    fn = C.conv3x3_dw_plain if op == "dw" else C.conv3x3_plain
    tol = smoke.DW_TOL if op == "dw" else smoke.CONV_TOL
    want = fn(x.double(), other.double())
    ok, err = _close(three_products(fn, x, other), want.float(), tol)
    assert ok, f"three TF32 products: max err {err:.2e} outside {tol}"
    assert err < 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("c, k", SHAPES)
@pytest.mark.parametrize("op", ["conv", "dw"])
def test_one_tf32_product_misses_the_plain_tolerance(op, c, k):
    x, other = _inputs(c, k, op == "dw")
    fn = C.conv3x3_dw_plain if op == "dw" else C.conv3x3_plain
    tol = smoke.DW_TOL if op == "dw" else smoke.CONV_TOL
    want = fn(x.double(), other.double()).float()
    ok, err = _close(one_product(fn, x, other), want, tol)
    assert not ok, f"one TF32 product: max err {err:.2e} inside {tol}"
