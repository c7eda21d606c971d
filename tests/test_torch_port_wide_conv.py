"""The wide-channel NCHW conv pair (``ops/wide_conv.py``,
``csrc/wide_conv.cu``) on the CPU: the plain twins against ``F.conv2d`` and
``torch.nn.grad.conv2d_weight`` in float64, both autograd Functions under
``gradcheck`` and ``gradgradcheck``, the route rule, the operation counter
on a discriminator step, the two benchmark metrics that read them, and an
emulation of the kernels' walks.

The emulation mirrors the kernels' index arithmetic in torch, float64,
without the TF32 split: ``plan_box``, the forward's 128-pixel tiles (TMA
boxes with their zero fill, each thread's A-fragment addresses, the packed
weights' core matrices, the stores), and the weight gradient's stages of
64 flat pixels (the output gradient's transposed B operand, the 189 (tap,
channel) rows, a last channel chunk past C, the partials and their sum).
Change it with the kernels.
"""

from __future__ import annotations

import importlib.util
import math
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import wide_conv as wc
from pggan_tpu_torch.ops.primitives import equalized_conv2d

ROOT = Path(__file__).resolve().parent.parent


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


# -- plain twins against the library ------------------------------------------

WIDE = [(2, 64, 16, 16, 64), (1, 128, 32, 32, 64), (1, 64, 64, 64, 128),
        (1, 512, 16, 16, 128), (2, 128, 16, 16, 512)]


@pytest.mark.parametrize("n,c,h,w,k", WIDE)
def test_twins_match_library(n, c, h, w, k):
    x, wt = _rand(n, c, h, w, seed=1), _rand(k, 3, 3, c, seed=2)
    y = wc.wide_conv_plain(x, wt)
    ref = F.conv2d(x, wt.permute(0, 3, 1, 2), padding=1)
    assert torch.allclose(y, ref, rtol=1e-12, atol=1e-10)
    gy = _rand(n, k, h, w, seed=3)
    dw = wc.wide_conv_dw_plain(x, gy)
    ref = torch.nn.grad.conv2d_weight(x, (k, c, 3, 3), gy, padding=1)
    assert torch.allclose(dw, ref.permute(0, 2, 3, 1), rtol=1e-12,
                          atol=1e-9)


def test_functions_gradcheck_and_gradgradcheck():
    """Both Functions to second order (the gradient penalty's), in float64
    on the CPU route, with random projections (``fast_mode``)."""
    x = _rand(1, 64, 16, 16, seed=4).requires_grad_()
    w = (0.1 * _rand(64, 3, 3, 64, seed=5)).requires_grad_()
    gy = _rand(1, 64, 16, 16, seed=6).requires_grad_()
    assert torch.autograd.gradcheck(wc.wide_conv, (x, w), fast_mode=True)
    assert torch.autograd.gradgradcheck(wc.wide_conv, (x, w),
                                        fast_mode=True)
    assert torch.autograd.gradcheck(wc.wide_conv_dw, (x, gy),
                                    fast_mode=True)
    assert torch.autograd.gradgradcheck(wc.wide_conv_dw, (x, gy),
                                        fast_mode=True)


def test_functions_transpose_into_each_other():
    """The forward's gradients are the input-gradient conv and the weight
    gradient, and the weight gradient's are convs again: the graph of a
    gradient penalty through ``wide_conv`` holds only the two Functions."""
    x = _rand(1, 64, 16, 16, seed=7).requires_grad_()
    w = _rand(64, 3, 3, 64, seed=8).requires_grad_()
    y = wc.wide_conv(x, w)
    gx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    names = set()
    stack = [gx.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or type(node).__name__ in names:
            continue
        names.add(type(node).__name__)
        stack.extend(f for f, _ in node.next_functions)
    assert "ConvolutionBackward0" not in names
    assert {"_WideConvBackward"} <= names
    ref = torch.autograd.grad(
        F.conv2d(x, w.permute(0, 3, 1, 2), padding=1).square().sum(), x)[0]
    assert torch.allclose(gx, ref, rtol=1e-10, atol=1e-8)


# -- the route rule -----------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("args,kw,want", [
    (("cuda", F32, (16, 512, 16, 16), (512, 512, 3, 3), 1), {}, "kernel"),
    (("cuda", F32, (3, 64, 128, 128), (64, 64, 3, 3), 1), {}, "kernel"),
    (("cuda", F32, (16, 128, 64, 64), (256, 128, 3, 3), 1), {}, "kernel"),
    (("cuda", F32, (16, 512, 8, 8), (512, 512, 3, 3), 1), {}, "cudnn"),
    (("cuda", F32, (16, 513, 4, 4), (512, 513, 3, 3), 1), {}, "cudnn"),
    (("cuda", F32, (16, 32, 64, 64), (32, 32, 3, 3), 1), {}, "cudnn"),
    (("cuda", F32, (16, 128, 256, 256), (64, 128, 3, 3), 1), {}, "cudnn"),
    (("cuda", F32, (16, 512, 16, 16), (512, 512, 3, 3), 1),
     {"kernels": False}, None),
    (("cuda", F32, (16, 512, 4, 4), (512, 512, 4, 4), 0), {}, None),
    (("cuda", F32, (16, 512, 16, 16), (3, 512, 1, 1), 0), {}, None),
    (("cuda", F32, (16, 512, 16, 16), (512, 512, 3, 3), 0), {}, None),
    (("cuda", BF16, (16, 512, 16, 16), (512, 512, 3, 3), 1),
     {"compute_dtype": BF16}, None),
    (("cuda", F32, (16, 512, 16, 16), (512, 512, 3, 3), 1),
     {"compute_dtype": BF16}, None),
    (("cpu", F32, (16, 512, 16, 16), (512, 512, 3, 3), 1), {}, None),
])
def test_route(args, kw, want):
    assert wc.route(*args, **kw) == want


def test_cpu_conv_keeps_library():
    """On the CPU ``equalized_conv2d`` keeps ``F.conv2d`` and counts
    nothing."""
    wc.FLOPS.clear()
    x = torch.randn(1, 64, 16, 16)
    p = {"w": torch.randn(64, 64, 3, 3), "b": torch.zeros(64)}
    y = equalized_conv2d(p, x, act=None, use_pixelnorm=False)
    ref = F.conv2d(x, p["w"] * math.sqrt(2 / 576), padding=1)
    assert torch.equal(y, ref)
    assert not wc.FLOPS


# -- the operation counter ----------------------------------------------------

def _d_step(monkeypatch, kernels_on: bool):
    """A depth-4 (64 px) discriminator at 64-128 channels: its forward on
    reals, the gradient penalty and the backward to its parameters, with
    the route taking the CPU as the card (the kernel route then runs the
    twins) and, without ``kernels_on``, every conv on the library."""
    from pggan_tpu_torch.losses import calc_gradient_penalty
    from pggan_tpu_torch.models import Discriminator
    orig = wc.route

    def as_card(_device, *args, **kw):
        got = orig("cuda", *args, **kw)
        return "cudnn" if got == "kernel" and not kernels_on else got
    monkeypatch.setattr(wc, "route", as_card)
    D = Discriminator((2, 3, 64, 64), fmap_base=1024, fmap_max=128,
                      pallas_tail=False)
    g = torch.Generator().manual_seed(0)
    real = torch.randn(2, 64, 64, 3, generator=g)
    fake = torch.randn(2, 64, 64, 3, generator=g)
    wc.FLOPS.clear()

    def d_fn(v):
        return D(v, 4, 0.5)
    loss = d_fn(real).mean() + calc_gradient_penalty(
        d_fn, real, fake, torch.rand(2, generator=g)).mean()
    loss.backward()
    return dict(wc.FLOPS)


def test_counter_tally_on_a_d_step(monkeypatch):
    """Every counted conv of a D forward-backward-GP counts 9 times its
    forward: the reals' and the mixed forward, the GP's input gradient,
    the reals' and the mixed input and weight gradients, and the two
    gradients of the GP's input gradient; on the kernel route and on the
    library's alike. The 4 px c1 after the minibatch stddev counts 7: no
    gradient of the penalty reaches its mixed forward (its leaky ReLU's
    masks are constant), so that node computes nothing."""
    nf = {1: 128, 2: 128, 3: 128, 4: 64, 5: 32}  # fmap_base 1024, max 128
    kernel = cudnn = 0
    for i, res in ((5, 64), (4, 32), (3, 16), (2, 8)):
        for c, k in ((nf[i], nf[i]), (nf[i], nf[i - 1])):
            f = wc.conv_flops((2, c, res, res), k)
            if wc.in_shape_rule(res, res, c, k):
                kernel += f
            else:
                cudnn += f
    last = wc.conv_flops((2, nf[1] + 1, 4, 4), nf[1])  # the 4 px c1
    on = _d_step(monkeypatch, True)
    assert kernel and cudnn
    assert sum(v for (r, _), v in on.items() if r == "kernel") == 9 * kernel
    assert (sum(v for (r, _), v in on.items() if r == "cudnn")
            == 9 * cudnn + 7 * last)
    assert on["kernel", "forward"] == 2 * kernel
    assert on["cudnn", "forward"] == 2 * (cudnn + last)
    off = _d_step(monkeypatch, False)
    assert set(r for r, _ in off) == {"cudnn"}
    assert sum(off.values()) == 9 * (kernel + cudnn) + 7 * last
    wc.FLOPS.clear()
    wc.FLOPS.update(on)
    assert wc.kernel_share() == pytest.approx(
        100 * 9 * kernel / (9 * kernel + 9 * cudnn + 7 * last))
    wc.FLOPS.clear()
    assert wc.kernel_share() is None


# -- the benchmark metrics ----------------------------------------------------

def _metric(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["wide_conv_flop_share.train",
                                  "wide_conv_ms_per_step.train"])
def test_metrics_read_none_without_trace_or_import(name, monkeypatch):
    import builtins
    mod = _metric(name)
    cell = types.SimpleNamespace(layer={}, counters={})
    assert mod.read(cell) is None  # no trace
    trace = types.SimpleNamespace(by_name={}, by_group={})
    cell = types.SimpleNamespace(layer={"trace": trace, "steps": 32},
                                 counters={})
    real_import = builtins.__import__

    def no_module(name, *args, **kw):
        if name.startswith("pggan_tpu_torch.ops.wide_conv") or (
                name == "pggan_tpu_torch.ops" and args
                and "wide_conv" in (args[2] or ())):
            raise ImportError(name)
        return real_import(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_module)
    assert mod.read(cell) is None  # a program without the kernel pair


def test_metrics_read_the_counter_and_the_trace():
    share = _metric("wide_conv_flop_share.train")
    ms = _metric("wide_conv_ms_per_step.train")
    trace = types.SimpleNamespace(
        by_name={"(anonymous namespace)::wide_conv_fwd(CUtensorMap)": 0.5,
                 "(anonymous namespace)::wide_conv_dw_sum(float)": 0.1,
                 "sm90_xmma_fprop": 2.0},
        by_group={})
    cell = types.SimpleNamespace(layer={"trace": trace, "steps": 10},
                                 counters={})
    assert ms.read(cell) == pytest.approx(60.0)
    wc.FLOPS.clear()
    assert share.read(cell) is None
    wc.FLOPS.update({("kernel", "forward"): 3, ("cudnn", "forward"): 1})
    assert share.read(cell) == pytest.approx(75.0)
    wc.FLOPS.clear()


# -- the kernels' walks, emulated ---------------------------------------------

def plan_box(width, rows, fwd):
    """Mirror of ``csrc/wide_conv.cu:plan_box``: (sw, rb)."""
    best = None
    for r in range(rows + 2, rows + 6):
        for s in range(width + 8, width + 41, 4):
            units = r * s // 4
            ok = units % 4 == 2 if fwd else units % 2 == 1
            if ok and (best is None or r * s < best[0]):
                best = (r * s, s, r)
    return best[1], best[2]


def tma_box(t, start, size):
    """A TMA box of ``t`` (dims outermost first, as torch holds them) from
    ``start`` (may be negative), zero outside the tensor."""
    out = t.new_zeros(size)
    src, dst = [], []
    for s0, n, d in zip(start, size, t.shape):
        lo, hi = max(s0, 0), min(s0 + n, d)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = t[tuple(src)]
    return out


@pytest.mark.parametrize("w", [16, 32, 64, 128])
def test_plan_box_banks(w):
    """Forward: 8 pixels x 4 channels a warp's A load hit 32 banks;
    weight gradient: 8 channels x 4 pixels."""
    sw, rb = plan_box(w, 128 // w, True)
    lanes = {(t * rb * sw + g) % 32 for g in range(8) for t in range(4)}
    assert len(lanes) == 32 and sw >= w + 8 and 8 * rb * sw <= 3328
    tw = min(w, 64)
    sw, rb = plan_box(tw, 64 // tw, False)
    lanes = {(g * rb * sw + t) % 32 for g in range(8) for t in range(4)}
    assert len(lanes) == 32 and sw >= tw + 8 and rb * sw <= 228


def emulate_fwd(x, w):
    """``wide_conv_fwd``'s walk: every tile, stage and thread."""
    n_img, c, h, wd = x.shape
    k = w.shape[0]
    tr = 128 // wd
    sw, rb = plan_box(wd, tr, True)
    wp = wc.pack(w).reshape(k // 64, c // 8, 9 * 512)
    y = x.new_full((n_img, k, h, wd), float("nan"))
    chunks, groups, row_tiles = c // 8, k // 64, h // tr
    tid = torch.arange(256)
    warp, lane = tid // 32, tid % 32
    wg, wl, g, t = warp // 4, warp % 4, lane // 4, lane % 4
    tp = wg * 64 + wl * 16 + g
    pr, pc = tp // wd, tp % wd
    abase = (t * rb + pr) * sw + pc + 3
    c4 = 4 * rb * sw
    # B[tap][k][c] from the packed stage: tap * 512 + (k / 8) 64 +
    # (c / 4) 32 + (k % 8) 4 + c % 4
    kk, cc = torch.meshgrid(torch.arange(64), torch.arange(8), indexing="ij")
    bidx = (kk // 8) * 64 + (cc // 4) * 32 + (kk % 8) * 4 + cc % 4
    for tile in range(n_img * row_tiles * groups):
        kg, rest = tile % groups, tile // groups
        rt, n = rest % row_tiles, rest // row_tiles
        acc = x.new_zeros(256, 32)
        for ch in range(chunks):
            box = tma_box(x[n], (ch * 8, rt * tr - 1, -4), (8, rb, sw))
            xs = box.reshape(-1)
            stage = wp[kg, ch]
            for tap in range(9):
                a0 = abase + (tap // 3) * sw + tap % 3
                # A rows (pixels of each warpgroup) x 8 channels
                a = torch.stack([xs[a0], xs[a0 + 8], xs[a0 + c4],
                                 xs[a0 + c4 + 8]], 1)
                b = stage[tap * 512 + bidx]  # (64 k, 8 c)
                for wgi in range(2):
                    sel = wg == wgi
                    rows = torch.zeros(64, 8, dtype=x.dtype)
                    r0 = (wl[sel] * 16 + g[sel])
                    rows[r0, t[sel]] = a[sel, 0]
                    rows[r0 + 8, t[sel]] = a[sel, 1]
                    rows[r0, t[sel] + 4] = a[sel, 2]
                    rows[r0 + 8, t[sel] + 4] = a[sel, 3]
                    d = rows @ b.T  # (64 pixels, 64 k)
                    gi, ti = r0, t[sel]
                    for j in range(8):
                        for hh in range(2):
                            for e in range(2):
                                acc[sel, 4 * j + 2 * hh + e] += \
                                    d[gi + 8 * hh, 8 * j + 2 * ti + e]
        row = rt * tr + pr
        for j in range(8):
            for hh in range(2):
                for e in range(2):
                    y[n, kg * 64 + 2 * t + 8 * j + e, row, pc + 8 * hh] = \
                        acc[:, 4 * j + 2 * hh + e]
    return y


def emulate_dw(x, gy):
    """``wide_conv_dw``'s walk: every item, stage and thread, the two
    warpgroups' partials and their sum."""
    n_img, c, h, wd = x.shape
    k = gy.shape[1]
    tw = min(wd, 64)
    sw, rb = plan_box(tw, 64 // tw, False)
    per_image = h * wd // 64
    total = n_img * per_image
    length = wc.dw_slice(n_img, h, wd, c, k)
    slices = -(-total // length)
    cc = wc._DW_CC
    c_chunks, k_tiles = -(-c // cc), k // 64
    ws = x.new_full((2 * slices, k, 9, c), float("nan"))
    gflat = gy.reshape(n_img, k, h * wd)
    tid = torch.arange(256)
    warp, lane = tid // 32, tid % 32
    wg, wl, g, t = warp // 4, warp % 4, lane // 4, lane % 4
    off = torch.zeros(256, 3, 2, dtype=torch.long)
    rows_of = torch.zeros(256, 3, 2, dtype=torch.long)
    for m in range(3):
        for hf in range(2):
            row = (64 * m + 16 * wl + g + 8 * hf).clamp(max=9 * cc - 1)
            tap, ch = row // cc, row % cc
            off[:, m, hf] = (ch * rb + tap // 3) * sw + tap % 3 + 3
            rows_of[:, m, hf] = 64 * m + 16 * wl + g + 8 * hf
    e = torch.arange(4096)
    p4, k8, half, blk = e & 3, (e >> 2) & 7, (e >> 5) & 1, e >> 6
    kk, ks = blk % 8 * 8 + k8, blk // 8
    raw_idx = kk * 68 + ks * 8 + half * 4 + p4
    for it in range(slices * c_chunks * k_tiles):
        k0, rest = it % k_tiles * 64, it // k_tiles
        c0, sl = rest % c_chunks * cc, rest // c_chunks
        g0 = sl * length
        steps = min(total - g0, length)
        acc = x.new_zeros(256, 3, 32)
        for j in range(steps):
            gs = g0 + j
            n, p0 = gs // per_image, gs % per_image * 64
            xs = tma_box(x[n], (c0, p0 // wd - 1, p0 % wd - 4),
                         (cc, rb, sw)).reshape(-1)
            raw = tma_box(gflat[n], (k0, p0), (64, 68)).reshape(-1)
            b = raw[raw_idx]  # B[ks][k / 8][px / 4 % 2][k % 8][px % 4]
            sel = wg == j % 2
            for gi in range(24):
                m, p = gi // 8, gi % 8 * 8
                pix = p // tw * sw + p % tw + t
                a = torch.stack([xs[off[:, m, 0] + pix],
                                 xs[off[:, m, 1] + pix],
                                 xs[off[:, m, 0] + pix + 4],
                                 xs[off[:, m, 1] + pix + 4]], 1)
                rows = torch.zeros(64, 8, dtype=x.dtype)
                r0 = wl[sel] * 16 + g[sel]
                rows[r0, t[sel]] = a[sel, 0]
                rows[r0 + 8, t[sel]] = a[sel, 1]
                rows[r0, t[sel] + 4] = a[sel, 2]
                rows[r0 + 8, t[sel] + 4] = a[sel, 3]
                bks = b[p // 8 * 512:(p // 8 + 1) * 512]
                kv, pv = torch.meshgrid(torch.arange(64), torch.arange(8),
                                        indexing="ij")
                bm = bks[(kv // 8) * 64 + (pv // 4) * 32 + (kv % 8) * 4
                         + pv % 4]  # (64 k, 8 px)
                d = rows @ bm.T  # (64 rows, 64 k)
                for jj in range(8):
                    for hh in range(2):
                        for ee in range(2):
                            acc[sel, m, 4 * jj + 2 * hh + ee] += d[
                                r0 + 8 * hh, 8 * jj + 2 * t[sel] + ee]
        for wgi in range(2):
            part = ws[2 * sl + wgi]
            sel = wg == wgi
            for m in range(3):
                for ee in range(32):
                    row = rows_of[sel, m, (ee >> 1) & 1]
                    kv = k0 + (ee >> 2) * 8 + 2 * t[sel] + (ee & 1)
                    keep = (row < 9 * cc) & (c0 + row % cc < c)
                    part[kv[keep], row[keep] // cc,
                         c0 + row[keep] % cc] = acc[sel, m, ee][keep]
    return ws.sum(0).reshape(k, 3, 3, c)


@pytest.mark.parametrize("n,c,h,w,k", [(1, 64, 16, 16, 64),
                                       (1, 16 * 4, 32, 32, 128),
                                       (2, 64, 64, 64, 64),
                                       (1, 64, 16, 128, 64)])
def test_emulated_fwd_walk(n, c, h, w, k):
    x, wt = _rand(n, c, h, w, seed=9), _rand(k, 3, 3, c, seed=10)
    y = emulate_fwd(x, wt)
    ref = F.conv2d(x, wt.permute(0, 3, 1, 2), padding=1)
    assert torch.allclose(y, ref, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("n,c,h,w,k", [(2, 16, 16, 16, 64),
                                       (1, 32, 32, 32, 128),
                                       (1, 21, 64, 64, 64),
                                       (1, 64, 16, 128, 64)])
def test_emulated_dw_walk(n, c, h, w, k):
    x, gy = _rand(n, c, h, w, seed=11), _rand(n, k, h, w, seed=12)
    dw = emulate_dw(x, gy)
    ref = torch.nn.grad.conv2d_weight(x, (k, c, 3, 3), gy, padding=1)
    assert torch.allclose(dw, ref.permute(0, 2, 3, 1), rtol=1e-12,
                          atol=1e-9)
