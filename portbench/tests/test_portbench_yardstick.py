"""The yardstick on the CPU: the model FLOPs against ``FlopCounterMode``
over the reference run on real tensors, and each kernel's work against
hand counts and against the operations and bytes a route that computes
the same function cannot avoid.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import yardstick
from portbench.reference import pggan

TINY = dict(resolution=32, num_channels=3, fmap_base=64, fmap_decay=1.0,
            fmap_max=16, latent_size=16)
HP = dict(iwass_lambda=10.0, iwass_epsilon=0.001, iwass_target=1.0)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("depth,fade", [(0, False), (2, True), (3, False)])
def test_step_flops_match_a_real_step(depth, fade):
    """The meta count equals the count over the reference's step on real
    tensors, at a small size."""
    torch.manual_seed(0)
    p = {n: torch.randn(s) * 0.1 for n, s, _ in pggan.layers(TINY)}
    net, batch = pggan.Net(TINY, "float32"), 4
    res = 4 * 2 ** depth
    reals = torch.randn(batch, res, res, 3)
    gen = torch.Generator().manual_seed(1)
    noise = pggan.draws(gen, batch, TINY["latent_size"], torch.float32)
    real = counted(lambda: pggan.train_step(
        net, p, pggan.Adam(p), pggan.Adam(p), reals, noise, depth, 0.5,
        fade, 1e-3, 1e-3, HP))
    assert yardstick.step_flops(TINY, depth, batch, fade, HP) == real > 0


def g_forward_by_hand(cfg, depth, fade):
    """2 FLOPs a multiply-add of every conv of G's forward."""
    def conv(res, k, cin, cout):
        return 2 * res * res * k * k * cin * cout
    nf = [pggan.nf(cfg, s) for s in range(12)]
    c, lat = cfg["num_channels"], cfg["latent_size"]
    total = conv(4, 4, lat, nf[1]) + conv(4, 3, nf[1], nf[1])
    for i in range(depth):
        res = 8 * 2 ** i
        total += conv(res, 3, nf[i + 1], nf[i + 2]) + \
            conv(res, 3, nf[i + 2], nf[i + 2])
    res = 4 * 2 ** depth
    total += conv(res, 1, nf[depth + 1], c)
    if fade:
        total += conv(res // 2, 1, nf[depth], c)
    return total


@pytest.mark.parametrize("depth,alpha", [(2, 1.0), (3, 0.5)])
def test_image_flops_by_hand(depth, alpha):
    assert yardstick.image_flops(TINY, depth, alpha) == \
        g_forward_by_hand(TINY, depth, alpha < 1.0)


def conv_args(n, h, c, w, k, pn=False):
    """A conv3x3 launch's arguments (pointers as 1)."""
    return (1, 1, 1, 1, 1 if pn else None, n, h, c, w, k, 16, 1, 0.2, 1e-8)


def test_conv_work_by_hand():
    n, h, c, w, k = 3, 8, 16, 32, 8
    dims = yardstick.call_dims("pggan_conv3x3", conv_args(n, h, c, w, k))
    assert dims == dict(n=n, h=h, c=c, w=w, k=k)
    flops, nbytes = yardstick.work("conv3x3_act_pn", "pggan_conv3x3", dims)
    assert flops == 2 * 9 * n * h * w * c * k
    # x, w, b in; y and the pixelnorm factor r out; four bytes each
    assert nbytes == 4 * (n * h * c * w + 9 * c * k + k + n * h * k * w
                          + n * h * w)
    assert yardstick.work("conv3x3", "pggan_conv3x3", dims)[1] == \
        4 * (n * h * c * w + 9 * c * k + n * h * k * w)


def test_call_dims_refuse_another_arity():
    assert yardstick.call_dims("pggan_conv3x3", (1,) * 13) is None
    assert yardstick.call_dims("pggan_unknown", (1,) * 14) is None


@pytest.mark.parametrize("n,h,c,w,k", [(1, 4, 8, 8, 16), (2, 8, 16, 4, 8)])
def test_work_is_what_any_route_must_do(n, h, c, w, k):
    """The FLOPs counted are those the library's own routes count for the
    same function, and the bytes those of the operands and results, read
    or written once: no route that computes it does less, so no share of
    this bound passes 100%."""
    x = torch.randn(n, c, h, w)
    wt = torch.randn(k, c, 3, 3)
    ct = torch.randn(n, k, h, w)
    conv = yardstick.work("conv3x3", "pggan_conv3x3",
                          yardstick.call_dims("pggan_conv3x3",
                                              conv_args(n, h, c, w, k)))
    assert conv[0] == counted(lambda: F.conv2d(x, wt, padding=1))
    assert conv[1] == 4 * (x.numel() + wt.numel() + ct.numel())
    dw = yardstick.work("conv3x3_dw", "pggan_conv3x3_dw",
                        yardstick.call_dims(
                            "pggan_conv3x3_dw",
                            (1, 1, 1, 1, n, h, c, w, k, 16, 16, 4, 1, 1)))
    assert dw[0] == counted(lambda: torch.ops.aten.convolution_backward(
        ct, x, wt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False]))
    assert dw[1] == 4 * (x.numel() + ct.numel() + wt.numel())
    w2 = torch.randn(k, k, 3, 3)
    chain = yardstick.work("conv3x3_chain", "pggan_conv3x3_chain",
                           yardstick.call_dims(
                               "pggan_conv3x3_chain",
                               (1,) * 6 + (n, h, c, w, w, k, k, 16, 2, 0,
                                           0.2, 1e-8)))
    assert chain[0] == counted(
        lambda: F.conv2d(F.conv2d(x, wt, padding=1), w2, padding=1))
    assert chain[1] == 4 * (x.numel() + wt.numel() + k + w2.numel() + k
                            + ct.numel())


def test_bound_takes_the_slower_of_the_two_rates():
    assert yardstick.bound_s(495e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.bound_s(495e12, 2 * 3.35e12) == pytest.approx(2.0)
    assert math.isclose(yardstick.PEAK_TF32_FLOP_S, 495e12)
