"""The tile plans of the TMA / wgmma conv and weight-gradient kernels
(``Plan`` in ``csrc/conv3x3.cu``, ``DwPlan`` in ``csrc/conv3x3_dw.cu``,
mirrored here: change both together), emulated in torch on the CPU.

The conv emulation walks the persistent grid: block b takes tiles b, b +
grid, ... of (image, channel group, row tile, column tile), and for each
tile stages 8 input channels at a time: a TMA box, (TH + 2 rows, 8
channels, 72 columns) of x from (row0 - 1, c0, col0 - 4), zero outside the
tensor (TMA's fill, the padding), and a TMA box of the (9, 8, KT) weights
from (0, c0, k0), zero beyond C and K; a stage's 9 taps are one group of
products added to the accumulators, then the epilogue, and only pixels and
channels inside the output are stored. The weight-gradient emulation walks
its grid of pixel slices, channel chunks and k tiles: per image row, x
boxes of (CC, TW + 36) from (row, c0, j0 - 4), read at the three column
shifts, and a cotangent box of (KT, TW + 4) from (row, k0, j0); the two
warpgroups take alternate rows, each 8-pixel k-step of a row one group of
products added to its warpgroup's sums in k-step order; each warpgroup's
sums are a partial of their own, and the 2 P partials of the P slices are
summed in the second pass's order (8 contiguous runs, then the runs in
order). Both take a W that is not a multiple of 4 as the wrappers pass it
(``tma_operand``: padded with zero columns, sliced off the output), and
the conv a K that is not (the weights padded with zero columns).

In float64 each walk equals the plain version to rounding; with the
kernels' arithmetic (TF32 products of split operands a group, summed
exactly and rounded to f32, then a rounded f32 add) it stays within the
kernels' tolerances of float64. The shapes cover W ragged against the
tiles and against TMA's 16 bytes, K > 64 in groups, pixelnorm at K = 8-64
and images smaller than one tile."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops import conv3x3 as C
from test_torch_port_tf32_split import one_product, smoke, three_products

CONV_TOL, DW_TOL = smoke.CONV_TOL, smoke.DW_TOL
SMEM_LIMIT = 232448  # the H100's dynamic shared memory a block, bytes
SMS = 132  # the H100's SMs: the conv's persistent grid is min(tiles, SMS)
# csrc/conv3x3.cu: output columns a tile, input channels a stage, staged
# halo row (floats), stages
TW, CC, SW, STAGES = 64, 8, 72, 4


def _round_up(v, m):
    return -(-v // m) * m


def conv_plan(kt):
    """``Plan<KT>``: rows a warpgroup ``rw`` (two warpgroups a tile, so
    ``th = 2 rw`` rows), shared memory (stages of the halo box and the
    hi / lo weights, two raw weight boxes, the barriers)."""
    rw = 1 if kt == 64 else 2 if kt == 32 else 4
    th = 2 * rw
    x_floats, w_floats = (th + 2) * CC * SW, 9 * CC * kt
    stage = _round_up((x_floats + 2 * w_floats) * 4, 1024)
    smem = STAGES * stage + 2 * w_floats * 4 + (2 * STAGES + 2) * 8 + 1024
    return {"rw": rw, "th": th, "smem": smem, "x_box": (th + 2, CC, SW),
            "w_box": (9, CC, kt)}


def dw_plan_mirror(kt, cc):
    """``DwPlan<KT, CC>``: m16 ``mma.sync`` tiles at KT <= 16, m64
    ``wgmma`` above; column tile, staged x and cotangent rows, k-steps a
    row, m-tiles, shared memory (stages, and beside them the warps' sums
    (m16) or the warpgroups' hi / lo B operands (m64))."""
    small = kt <= 16
    tw = 64 if kt == 64 else 128
    mt = -(-9 * cc // (16 if small else 64))
    xpx, xpc = tw + 36, tw + 4
    stage = _round_up((cc * xpx + kt * xpc) * 4, 128)
    side = 2 * 4 * 32 * mt * kt // 2 if small else 4 * (tw // 8 * 8 * kt)
    # as many stages as fit beside them, at most 12
    stages = min(12, (SMEM_LIMIT - 128 - side * 4 - 2 * 12 * 8) // stage)
    smem = stages * stage + side * 4 + 2 * stages * 8 + 128
    return {"small": small, "tw": tw, "xpx": xpx, "xpc": xpc,
            "ks": tw // 8, "mt": mt, "smem": smem, "stages": stages}


def tma_box(t, start, size):
    """A TMA box of ``t`` (dims outermost first) at ``start`` of ``size``,
    zero outside the tensor. Holds TMA's rules that the kernels rely on:
    every box dim at most 256, the innermost a multiple of 16 bytes and
    its start 16-byte aligned (the card faults on a box starting at -1)."""
    assert all(s <= 256 for s in size) and size[-1] % 4 == 0
    assert start[-1] % 4 == 0
    return window(t, start, size)


def window(t, start, size):
    """``t[start:start + size]`` in every dim, zero outside ``t``."""
    out = torch.zeros(size, dtype=t.dtype)
    src, dst = [], []
    for d, (s0, sz) in enumerate(zip(start, size)):
        lo, hi = max(0, s0), min(t.shape[d], s0 + sz)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _f64_product(a, b):
    return a.double() @ b.double()


def _f64_add(acc, s):
    return acc + s


def _tf32_product(a, b):
    return three_products(torch.matmul, a, b)  # rounded to f32


def _f32_add(acc, s):
    return (acc.float() + s.float()).float()


def emulate_conv(x, w, b, *, epi, slope=0.2, eps=1e-8, grid=SMS,
                 product=_f64_product, add=_f64_add):
    """The conv kernel's walk; returns y (N, H, K, W) and r (N, H, W) (NaN
    where nothing was stored) and the tiles each block took."""
    n, h, c, w_out = x.shape
    # as the wrapper passes them: W and the weights' K padded to 4
    x, w_pad = C.tma_operand(x), C.tma_operand(w)
    wd = x.shape[3]
    k = w.shape[3]
    kt = C.k_tier(min(k, 64))
    p = conv_plan(kt)
    th = p["th"]
    groups, row_tiles, col_tiles = -(-k // kt), -(-h // th), -(-wd // TW)
    tiles = n * groups * row_tiles * col_tiles
    blocks = min(tiles, grid)
    w9 = w_pad.reshape(9, c, w_pad.shape[3])
    dtype = torch.float64 if product is _f64_product else torch.float32
    y = torch.full((n, h, k, wd), float("nan"), dtype=torch.float64)
    r = torch.full((n, h, wd), float("nan"), dtype=torch.float64)
    walked = []
    for blk in range(blocks):
        for tile in range(blk, tiles, blocks):
            walked.append(tile)
            col0 = tile % col_tiles * TW
            rest = tile // col_tiles
            row0 = rest % row_tiles * th
            rest //= row_tiles
            k0, nn = rest % groups * kt, rest // groups
            kg = min(kt, k - k0)
            acc = torch.zeros(th, TW, kt, dtype=dtype)
            for ch in range(-(-c // CC)):
                xs = tma_box(x[nn], (row0 - 1, ch * CC, col0 - 4),
                             p["x_box"])
                wb = tma_box(w9, (0, ch * CC, k0), p["w_box"])
                # the stage's 9 taps, one contraction: staged column sc
                # holds image column col0 - 4 + sc
                a = torch.cat([xs[u:u + th, :, v + 3:v + 3 + TW]
                               for u in range(3) for v in range(3)], 1)
                acc = add(acc, product(a.transpose(1, 2),
                                       wb.reshape(9 * CC, kt)))
            z = acc.double()
            rr = None
            if epi:
                bias = torch.zeros(kt, dtype=torch.float64)
                bias[:kg] = b[k0:k0 + kg].double()
                z = z + bias
                z = torch.where(z >= 0, z, z * slope)
                if epi == 2:
                    rr = torch.rsqrt((z * z).sum(-1) / k + eps)
                    z = z * rr[..., None]
            rows = min(th, h - row0)
            cols = min(TW, wd - col0)
            y[nn, row0:row0 + rows, k0:k0 + kg, col0:col0 + cols] = z[
                :rows, :cols, :kg].transpose(1, 2)
            if rr is not None:
                r[nn, row0:row0 + rows, col0:col0 + cols] = rr[:rows, :cols]
    return y[..., :w_out], r[..., :w_out], walked


def emulate_dw(x, ct, *, product=_f64_product, add=_f64_add, kt=None):
    """The weight-gradient kernel's walk and second pass; returns dw (3, 3,
    C, K) and the workspace of partials (P, 9, C, K). ``kt`` overrides
    ``dw_plan``'s k tile."""
    x, ct = C.tma_operand(x), C.tma_operand(ct)  # as the wrapper passes them
    n, h, c, wd = x.shape
    k = ct.shape[2]
    kt, cc, rpb, row_chunks, col_tiles = C.dw_plan(n, h, c, wd, k, kt=kt)
    p = dw_plan_mirror(kt, cc)
    tw = p["tw"]
    assert tw == C.dw_cols(kt)
    # sums a warpgroup: the four warps' (a quarter of each row's k-steps
    # each) at m16 tiles, added in warp order at the end; one at m64
    warps = 4 if p["small"] else 1
    dtype = torch.float64 if product is _f64_product else torch.float32
    slices = n * row_chunks * col_tiles
    # a partial for each warpgroup of each pixel slice: 2 s + wg
    ws = torch.full((2 * slices, 9, c, k), float("nan"), dtype=dtype)
    for s in range(slices):
        j0 = s % col_tiles * tw
        chunk, nn = s // col_tiles % row_chunks, s // col_tiles // row_chunks
        i0 = chunk * rpb
        steps = min(h - i0, rpb) + 2
        for c0 in range(0, c, cc):
            for k0 in range(0, k, kt):
                # stage q: x row i0 - 1 + q; cotangent row i0 + q - 2
                xrow = [tma_box(x[nn], (i0 - 1 + q, c0, j0 - 4),
                                (1, cc, p["xpx"]))[0] for q in range(steps)]
                sums = [[torch.zeros(9 * cc, kt, dtype=dtype)
                         for _ in range(warps)] for _ in (0, 1)]
                for q in range(2, steps):
                    cb = tma_box(ct[nn], (i0 + q - 2, k0, j0),
                                 (1, kt, p["xpc"]))[0]
                    a = torch.stack([xrow[q - 2 + u][:, v + 3:v + 3 + tw]
                                     for u in range(3) for v in range(3)])
                    a = a.reshape(9 * cc, tw)  # (tap, c) rows, tap-major
                    # warpgroup (q - 2) % 2 takes the row; each 8-pixel
                    # k-step one group of products, added in k-step order
                    # to the sums of the warp that takes it
                    wg = (q - 2) % 2
                    for ks in range(tw // 8):
                        pix = slice(8 * ks, 8 * ks + 8)
                        w = ks * warps // (tw // 8)
                        sums[wg][w] = add(sums[wg][w],
                                          product(a[:, pix], cb[:, pix].T))
                cg, kg = min(cc, c - c0), min(kt, k - k0)
                for wg in (0, 1):
                    total = sums[wg][0]
                    for w in range(1, warps):
                        total = add(total, sums[wg][w])
                    part = total.reshape(9, cc, kt)
                    ws[2 * s + wg, :, c0:c0 + cg, k0:k0 + kg] = part[
                        :, :cg, :kg]
    assert not ws.isnan().any()  # every partial written once
    per = -(-2 * slices // 8)
    runs = []
    for g in range(8):
        run = torch.zeros(9, c, k, dtype=dtype)
        for q in range(g * per, min(2 * slices, (g + 1) * per)):
            run = add(run, ws[q])
        runs.append(run)
    total = runs[0]
    for run in runs[1:]:
        total = add(total, run)
    return total.reshape(3, 3, c, k), ws


def _conv_inputs(n, h, c, w, k, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32))
    return (f(n, h, c, w), f(3, 3, c, k, scale=(2.0 / (9 * c)) ** 0.5),
            f(k, scale=0.1))


# (N, H, C, W, K): W and H ragged against the tiles (K tier 32, TH 4);
# K > 64 in two groups of 64 (TH 2) over three channel chunks; an image
# smaller than one tile in both axes (TH 8); pixelnorm's tiers 8-64; W
# not a multiple of 4 (padded) with C and K of no tier
CONV_SHAPES = [(2, 20, 16, 76, 24), (1, 6, 24, 68, 72), (1, 3, 8, 4, 16),
               (1, 9, 8, 44, 8), (2, 5, 16, 8, 64), (1, 5, 5, 45, 7)]


def _conv_plain(x, w, b, epi):
    if epi == 0:
        return C.conv3x3_plain(x, w), None
    if epi == 1:
        return C.conv3x3_act_plain(x, w, b, slope=0.2), None
    return C.conv3x3_act_pn_plain(x, w, b, slope=0.2, eps=1e-8)


@pytest.mark.parametrize("grid", [3, SMS])
@pytest.mark.parametrize("shape,epi", [
    (shape, epi) for shape in CONV_SHAPES for epi in (0, 1, 2)
    if epi < 2 or shape[4] <= 64])  # pixelnorm takes K <= 64 (one group)
def test_conv_walk_equals_plain_in_float64(shape, epi, grid):
    x, w, b = (a.double() for a in _conv_inputs(*shape))
    want, want_r = _conv_plain(x, w, b, epi)
    y, r, walked = emulate_conv(x, w, b, epi=epi, grid=grid)
    assert sorted(walked) == list(range(len(walked)))  # each tile once
    assert not y.isnan().any()  # every output written
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    if epi == 2:
        np.testing.assert_allclose(r.numpy(), want_r.numpy(), rtol=1e-12)


@pytest.mark.parametrize("products,within", [("three", True), ("one", False)])
@pytest.mark.parametrize("shape", [(2, 20, 16, 76, 24), (1, 6, 64, 12, 64)])
def test_conv_tf32_split_against_float64(shape, products, within):
    """The kernel's arithmetic: a stage's 9 taps x three TF32 products of
    split operands summed from zero, then a rounded f32 add, keep CONV_TOL
    of float64 (pixelnorm's mode, which also holds r); one product does
    not."""
    x, w, b = _conv_inputs(*shape)
    want, want_r = _conv_plain(x.double(), w.double(), b.double(), 2)
    if products == "three":
        product = _tf32_product
    else:
        def product(a, bb):
            return one_product(torch.matmul, a, bb)
    y, r, _ = emulate_conv(x, w, b, epi=2, product=product, add=_f32_add)
    ok = (torch.allclose(y, want, **CONV_TOL)
          and torch.allclose(r, want_r, **CONV_TOL))
    assert ok == within, float((y - want).abs().max())


# (N, H, C, W, K, KT): KT 32 / CC 16 with W ragged against 128 columns and
# H against the row runs; K > 64 in two k tiles of 64 (64-column items)
# with C not a multiple of 8, and the same in three k tiles of 32; an
# image smaller than one tile (m16 tiles, KT 16 / CC 8); KT 8 / CC 8; W
# not a multiple of 4 (padded), KT 16 / CC 16; KT 8 / CC 16; KT 32 at
# C <= 8 (CC 16)
DW_SHAPES = [(2, 20, 16, 140, 24, None), (1, 9, 12, 68, 72, None),
             (1, 9, 12, 68, 72, 32), (1, 3, 8, 4, 16, None),
             (1, 6, 8, 36, 8, None), (1, 5, 12, 45, 11, None),
             (1, 6, 20, 36, 6, None), (1, 4, 5, 20, 30, None)]


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_walk_equals_plain_in_float64(shape):
    n, h, c, w, k, kt = shape
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, h, c, w))
    ct = torch.from_numpy(rng.randn(n, h, k, w))
    got, _ws = emulate_dw(x, ct, kt=kt)
    want = C.conv3x3_dw_plain(x, ct)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", DW_SHAPES[:3] + DW_SHAPES[4:])
def test_dw_tf32_split_against_float64(shape):
    """Each k-step's three TF32 products summed from zero, then a rounded
    f32 add into its warp's (m16) or warpgroup's (m64) sums, the warps'
    sums added in order, and the partials summed in the second pass's
    order: within DW_TOL of float64."""
    n, h, c, w, k, kt = shape
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(n, h, c, w).astype(np.float32))
    ct = torch.from_numpy(rng.randn(n, h, k, w).astype(np.float32))
    got, _ws = emulate_dw(x, ct, product=_tf32_product, add=_f32_add, kt=kt)
    want = C.conv3x3_dw_plain(x.double(), ct.double())
    tol = dict(rtol=DW_TOL["rtol"],
               atol=DW_TOL["scaled_atol"] * float(want.abs().max()))
    assert torch.allclose(got.double(), want, **tol), float(
        (got.double() - want).abs().max())


@pytest.mark.parametrize("kt", C.K_TIERS)
def test_conv_plan_fits_a_block(kt):
    """One block an SM: its shared memory fits and the boxes follow TMA's
    rules (checked by ``tma_box``)."""
    p = conv_plan(kt)
    assert p["smem"] <= SMEM_LIMIT
    assert p["th"] == 2 * p["rw"]
    x = torch.zeros(1, 2 * p["th"], CC, 2 * TW)
    tma_box(x[0], (-1, 0, TW - 4), p["x_box"])
    tma_box(torch.zeros(9, CC, kt), (0, 0, 0), p["w_box"])


# every DwPlan the entry point instantiates
DW_TIERS = [(8, 8), (8, 16), (16, 8), (16, 16), (32, 16), (64, 16)]


@pytest.mark.parametrize("kt,cc", DW_TIERS)
def test_dw_plan_fits_a_block(kt, cc):
    """Every ``DwPlan`` the entry point instantiates: shared memory fits
    with at least the five stages that two warpgroups' rows need; the
    staged rows are = 4 mod 32 floats (conflict-free A loads and split
    reads) and x's row covers the TW + 2 halo columns from its aligned
    start; m16 tiles waste at most 10% of M (9 x CC rows), where m64 tiles
    would waste 25-44%."""
    p = dw_plan_mirror(kt, cc)
    assert p["smem"] <= SMEM_LIMIT and p["stages"] >= 5
    assert p["xpx"] % 32 == 4 and p["xpc"] % 32 == 4
    assert p["xpx"] >= p["tw"] + 5  # columns j0 - 4 .. j0 + TW
    rows = p["mt"] * (16 if p["small"] else 64)
    assert p["small"] == (kt <= 16)
    if p["small"]:
        assert 9 * cc / rows >= 0.9 and 9 * cc / -(-9 * cc // 64) / 64 <= 0.75


# every weight-gradient shape (x's C, the cotangent's K) of a depth-8
# step's NHCW stages at batch 3: G's tail at 256-1024 px, D's head at
# 1024-128 px
STEP_DW = smoke.STEP_DW


@pytest.mark.parametrize("res,c,k", STEP_DW)
def test_dw_plan_at_the_step_shapes(res, c, k):
    """The plan fills the card (at least one block an SM) over runs of 8
    to 24 rows, and the rows cover each image once; m16 tiles at K <=
    16 (CC 8 at C = 8), m64 tiles above, K = 128 in two k tiles of 64."""
    kt, cc, rpb, row_chunks, col_tiles = C.dw_plan(3, res, c, res, k)
    assert (kt, cc) in DW_TIERS
    assert kt == C.k_tier(min(k, 64)) and cc == (8 if c <= 8 else 16)
    blocks = 3 * row_chunks * col_tiles * -(-c // cc) * -(-k // kt)
    assert blocks >= SMS and 8 <= rpb <= 24
    assert (row_chunks - 1) * rpb < res <= row_chunks * rpb
    assert col_tiles * C.dw_cols(kt) == res


def test_tma_route_by_shape():
    """``tma_operand``: a W (or the weights' K) that is not a multiple of 4
    padded with zero columns, an unaligned tensor copied to an aligned one,
    and every tensor of the step taken as it is (no copy)."""
    x = torch.arange(2 * 3 * 5 * 45, dtype=torch.float32).view(2, 3, 5, 45)
    p = C.tma_operand(x)
    assert p.shape == (2, 3, 5, 48) and p.data_ptr() % 16 == 0
    assert torch.equal(p[..., :45], x) and not p[..., 45:].any()
    unaligned = torch.ones(2 * 8 * 16 * 64 + 1)[1:].view(2, 8, 16, 64)
    assert unaligned.data_ptr() % 16
    p = C.tma_operand(unaligned)
    assert p.data_ptr() % 16 == 0 and torch.equal(p, unaligned)
    for res, c, k in STEP_DW:  # every NHCW shape and weight of the step
        for t in (torch.zeros(1, 1, c, res), torch.zeros(3, 3, c, k)):
            assert C.tma_operand(t) is t
    w = torch.ones(3, 3, 5, 7)
    p = C.tma_operand(w)
    assert p.shape == (3, 3, 5, 8) and torch.equal(p[..., :7], w)
    assert not p[..., 7:].any()


# (N, H, C, W, K) and route: the conv at KT 32 and the dw on m64 tiles;
# a ragged W; K = 7 (the conv's weights padded, the dw on m16 tiles, CC
# 16); C = 8 (the dw's m16 tiles over CC 8); K = 72 (the conv in two
# groups of 64, the dw in two k tiles of 64)
@pytest.mark.parametrize("shape,route", [((1, 6, 16, 64, 24), "tma"),
                                         ((1, 6, 16, 45, 24), "padded"),
                                         ((1, 6, 16, 64, 7), "any_k"),
                                         ((1, 6, 8, 64, 16), "dw_m16_c8"),
                                         ((1, 6, 16, 64, 72), "k_groups")])
def test_launch_routes_by_shape(monkeypatch, shape, route):
    """The wrappers' launches, with the library stubbed out: the conv's
    entry point without a workspace, a ragged W passed padded to a multiple
    of 4 and the output sliced back to W, a ragged K with the weights
    padded; the dw's plan arguments at the padded W, its tile family
    (m16 at K <= 16, CC 8 at C <= 8) and workspace (a partial a
    warpgroup and pixel slice)."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *a: calls.append((name, fn, a)))
    n, h, c, w, k = shape
    wp = -(-w // 4) * 4
    assert (wp != w) == (route == "padded")
    x, wt, b = _conv_inputs(n, h, c, w, k)
    y, _r = C._launch("conv3x3_act", 1, x, wt, b, 0.2, 0.0)
    assert y.shape == (n, h, k, w) and y.is_contiguous()
    name, fn, args = calls[0]
    assert (name, fn) == ("conv3x3_act", "pggan_conv3x3")
    assert len(args) == 14
    # .., KT, epi: K > 64 in groups of 64
    assert args[-9:-2] == (n, h, c, wp, k, C.k_tier(min(k, 64)), 1)
    # x and w as they are, or padded copies
    assert (args[0] == x.data_ptr()) == (wp == w)
    assert (args[1] == wt.data_ptr()) == (k % 4 == 0)
    monkeypatch.setattr(_build, "use_plain", lambda t: False)
    monkeypatch.setattr(torch, "empty", _recording_empty(calls))
    C._dw_fwd(x, torch.zeros(n, h, k, w))
    ws_shape = calls[-2]
    name, fn, args = calls[-1]
    assert (name, fn) == ("conv3x3_dw", "pggan_conv3x3_dw")
    assert args[-10:-5] == (n, h, c, wp, k)
    plan = C.dw_plan(n, h, c, wp, k)
    assert args[-5:] == plan
    kt, cc, _rpb, row_chunks, col_tiles = plan
    assert (kt <= 16, cc) == {"tma": (False, 16), "padded": (False, 16),
                              "any_k": (True, 16), "dw_m16_c8": (True, 8),
                              "k_groups": (False, 16)}[route]
    assert ws_shape == (2 * n * row_chunks * col_tiles, 9, c, k)


def _recording_empty(calls):
    """``torch.empty`` that records each shape it makes in ``calls``."""
    empty = torch.empty

    def record(shape, **kw):
        calls.append(tuple(shape))
        return empty(shape, **kw)
    return record
