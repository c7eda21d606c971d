"""The yardsticks ``chip_smoke.py`` prints beside each kernel's time: the
work of a call (FLOPs, bytes), the least time the card could take for it,
and the one PyTorch call that computes the same function. Counted here on
the CPU from the call signatures; the times are the card's."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pggan_tpu_torch.ops import conv3x3 as C
from pggan_tpu_torch.ops import resample as R

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


@pytest.mark.parametrize("name, sig, gflop, mb", [
    # the conv in its dx role at the D head and the G tail (depth 8)
    ("conv3x3", ((6, 128, 128, 128), (3, 3, 128, 64)), 14.50, 75.8),
    ("conv3x3", ((3, 128, 64, 128), (3, 3, 64, 128)), 7.25, 38.0),
    ("conv3x3", ((6, 1024, 16, 1024), (3, 3, 16, 8)), 14.50, 604.0),
    # the weight gradient: x and the cotangent are read, (3, 3, C, K) written
    ("conv3x3_dw", ((6, 1024, 8, 1024), (6, 1024, 8, 1024)), 7.25, 402.7),
    ("conv3x3_dw", ((3, 1024, 16, 1024), (3, 1024, 8, 1024)), 7.25, 302.0),
    ("conv3x3_dw", ((6, 128, 64, 128), (6, 128, 128, 128)), 14.50, 75.8),
    # the epilogues add the bias read, and pixelnorm's r written
    ("conv3x3_act", ((3, 128, 64, 128), (3, 3, 64, 128), (128,), 0.2),
     7.25, 38.04),
    ("conv3x3_act_pn", ((3, 1024, 16, 1024), (3, 3, 16, 8), (8,), 0.2, 1e-8),
     7.25, 314.6),
    # resamples move bytes only: the pool reads 4 and writes 1, the upsample
    # reads 1 and writes 4
    ("avgpool2x", ((6, 1024, 16, 1024), 1, 3), 0.0, 503.3),
    ("upsample2x", ((16, 128, 64, 128), 1, 3), 0.0, 335.5),
    # their bf16 modes move two bytes an element: the bf16 D's NCHW pool at
    # 1024 px, and G's fade upsample
    ("avgpool2x_bf16", ((6, 16, 1024, 1024), 2, 3), 0.0, 251.66),
    ("upsample2x_bf16", ((3, 3, 512, 512), 2, 3), 0.0, 23.59),
    ("conv3x3_chain_pn",
     ((16, 256, 64, 256), (3, 3, 64, 32), (32,), (3, 3, 32, 32), (32,)),
     57.98, 402.8),
])
def test_work_counts(name, sig, gflop, mb):
    flops, nbytes = smoke.work(name, sig)
    assert flops / 1e9 == pytest.approx(gflop, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.05)


@pytest.mark.parametrize("gflop, mb, bound_ms, by, fma_ms", [
    # 14.5 GFLOP at 165 TFLOP/s (three TF32 products) over 75.8 MB at 3.35 TB/s
    (14.4955, 75.79, 0.08785, "operations", 0.21635),
    (7.2478, 402.66, 0.12020, "bytes", 0.10818),
    (0.0, 503.32, 0.15024, "bytes", 0.0),
])
def test_bounds(gflop, mb, bound_ms, by, fma_ms):
    got_ms, got_by, got_fma = smoke.bounds(gflop * 1e9, mb * 1e6)
    assert got_ms == pytest.approx(bound_ms, rel=1e-3)
    assert got_by == by
    assert got_fma == pytest.approx(fma_ms, rel=1e-3)


@pytest.mark.parametrize("shape, ms, gb_s", [
    # the serve's three upsamples at their bytes bound (3.35 TB/s) and at
    # half of it
    ((16, 128, 64, 128), 0.1001625, 3350.0),
    ((16, 256, 32, 256), 0.4006499, 1675.0),
    ((16, 512, 16, 512), 0.8012999, 1675.0),
])
def test_achieved_rate_of_the_upsample(shape, ms, gb_s):
    sig = (shape, 1, 3)
    assert smoke.achieved_gb_per_s("upsample2x", sig, ms) == pytest.approx(
        gb_s, rel=1e-4)
    bound_ms = smoke.bounds(*smoke.work("upsample2x", sig))[0]
    assert bound_ms / ms == pytest.approx(gb_s / 3350.0, rel=1e-4)


@pytest.mark.parametrize("name", ["avgpool2x", "upsample2x"])
def test_bf16_modes_move_half_the_bytes(name):
    sig = ((3, 8, 64, 32), 2, 3)
    assert smoke.element_bytes(name) == 4
    assert smoke.element_bytes(name + "_bf16") == 2
    assert 2 * smoke.work(name + "_bf16", sig)[1] == smoke.work(name, sig)[1]
    assert smoke.work(name + "_bf16", sig)[0] == 0


def test_bf16_library_calls_take_bf16():
    x = _rand(2, 6, 3, 8).to(torch.bfloat16)
    for name in ("avgpool2x_bf16", "upsample2x_bf16"):
        y = smoke.library_call(torch, name, (x, 1, 3))()
        assert y.dtype == torch.bfloat16
        want = smoke.plain_versions()[name](x, 1, 3)
        n, h, c, w = want.shape  # NHCW
        torch.testing.assert_close(y.reshape(n, c, h, w).float(),
                                   want.transpose(1, 2).float(), rtol=1e-2,
                                   atol=1e-2)


def _rand(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def test_library_calls_compute_the_kernels_functions():
    """Each yardstick call, on its NCHW copies, computes what the kernel's
    plain version computes (up to layout)."""
    x, w, ct = _rand(2, 6, 3, 8), _rand(3, 3, 3, 5, seed=1), \
        _rand(2, 6, 5, 8, seed=2)
    nhcw = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731
    y = smoke.library_call(torch, "conv3x3", (x, w))()
    torch.testing.assert_close(nhcw(y), C.conv3x3_plain(x, w))
    dw = smoke.library_call(torch, "conv3x3_dw", (x, ct))()[1]
    torch.testing.assert_close(dw.permute(2, 3, 1, 0),
                               C.conv3x3_dw_plain(x, ct), rtol=1e-5,
                               atol=1e-5)
    p = smoke.library_call(torch, "avgpool2x", (x, 1, 3))()
    torch.testing.assert_close(p.reshape(2, 3, 3, 4),
                               nhcw(R.avgpool2x_plain(x, 1, 3)))
    u = smoke.library_call(torch, "upsample2x", (x, 1, 3))()
    torch.testing.assert_close(u.reshape(2, 3, 12, 16),
                               nhcw(R.upsample2x_plain(x, 1, 3)))
    b = _rand(5, seed=3)
    for name, args in (("conv3x3_act", (x, w, b, 0.2)),
                       ("conv3x3_act_pn", (x, w, b, 0.2, 1e-8)),
                       ("conv3x3_chain", (x, w, b, w, b))):
        assert smoke.library_call(torch, name, args) is None
