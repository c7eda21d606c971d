"""The CUDA chain kernel's walk (``Plan`` in ``csrc/conv_chain.cu``,
mirrored by ``plan_mirror`` here, and ``ops/conv_chain.py:chain_rows``)
and the upsample kernel's index map (``csrc/upsample2x.cu``), emulated in
torch on the CPU.

The chain emulation walks the kernel's persistent grid of work items: a
strip of 64 output columns of one image down a run of L rows. Per band,
stage 1 computes the next 2 MW x 64 positions of the run's flattened
intermediate (rows i0 - 1 .., 66 columns from col0 - 1), 8 input
channels a stage, from a TMA box of x (SPAN + 2 rows from the band's
first row - 1, 72 columns from col0 - 4, zero outside the tensor), and
stores them in a ring of ZR intermediate rows, positions outside the
image as 0 (the second conv's padding, not ``ep(conv(0))``); stage 2
computes every output row whose three ring rows are complete, 8
intermediate channels a stage, and stores the pixels inside the image.
The ring records which row each of its slots holds, so a read of a row
the ring no longer (or does not yet) hold fails. In float64 the walk
equals the plain version to rounding; with the kernel's arithmetic (each
stage's 9 taps as TF32 products of split operands summed exactly, then a
rounded f32 add; the intermediate stored in f32) it stays within the
kernels' tolerance of float64, where one TF32 product does not.

The upsample emulation enumerates the 2-D grid: blocks over input rows and
W chunks, threads over 2^lx columns and 256 / 2^lx rows, kE vectors a
thread, and counts where every vector lands."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import pytest
import torch

from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops import conv_chain as CH
from pggan_tpu_torch.ops.conv3x3 import K_TIERS, k_tier, tma_operand
from test_torch_port_conv_tiles import tma_box
from test_torch_port_tf32_split import one_product, three_products

CONV_TOL = dict(rtol=1e-4, atol=1e-5)  # chip_smoke.CONV_TOL
# the chain kernel's constants: output columns a strip, intermediate
# positions a row, channels a stage, staged x row and intermediate row
# (floats)
TW, IW, CC, SW, ZS = 64, 66, 8, 72, 72
SMEM_LIMIT = 232448  # the H100's dynamic shared memory a block, bytes
KE = 2  # the upsample's vectors a thread (csrc/upsample2x.cu kE)


def _round_up(v, m):
    return -(-v // m) * m


def plan_mirror(kt):
    """``Plan<KT>`` of the source: M-tiles a warpgroup ``mw``, positions a
    band ``bp``, the most rows a band touches ``span``, x box rows ``xr``,
    ring rows ``zr``, stages, and dynamic shared memory in bytes (the
    stages' x box and hi / lo weights, the two raw weight boxes, the ring,
    the barriers)."""
    mw = {64: 1, 32: 2, 16: 4, 8: 5}[kt]
    bp = 2 * mw * TW
    span = (IW - 1 + bp - 1) // IW + 1
    stages = 2 if kt == 64 else 4
    x_floats, w_floats = (span + 2) * CC * SW, 9 * CC * kt
    stage = _round_up((x_floats + 2 * w_floats) * 4, 1024)
    smem = (stages * stage + 2 * w_floats * 4 + (span + 2) * kt * ZS * 4
            + (2 * stages + 2) * 8 + 1024)
    return {"mw": mw, "bp": bp, "span": span, "xr": span + 2,
            "zr": span + 2, "stages": stages, "smem": smem,
            "x_box": (span + 2, CC, SW), "w_box": (9, CC, kt)}


def _ep(z, b, slope, pn_eps, k):
    """bias_act_pn on channels-last sums: channels >= k are zero padding
    (no bias, zero weights)."""
    bias = torch.zeros(z.shape[-1], dtype=z.dtype)
    bias[:k] = b.to(z.dtype)
    z = z + bias
    z = torch.where(z >= 0, z, z * slope)
    if pn_eps is not None:
        z = z * torch.rsqrt((z * z).sum(-1, keepdim=True) / k + pn_eps)
    return z


class Ring:
    """The intermediate ring: ``zr`` rows of (66 positions, KT channels),
    each slot tagged with the run row it holds."""

    def __init__(self, zr, kt, dtype):
        self.zr = zr
        self.z = torch.full((zr, IW, kt), float("nan"), dtype=dtype)
        self.tag = [None] * zr

    def store(self, rr, cc, vals):
        for slot in set((rr % self.zr).tolist()):
            rows = set(rr[rr % self.zr == slot].tolist())
            assert len(rows) == 1  # a band's positions: one row a slot
            self.tag[slot] = rows.pop()
        self.z[rr % self.zr, cc] = vals

    def load(self, rows, cols):
        for r in set(rows.tolist()):
            assert self.tag[r % self.zr] == r, (r, self.tag)
        return self.z[rows % self.zr, cols]


def emulate_chain(x, w1, b1, w2, b2, *, slope, pn_eps, product=None,
                  add=None, zero_outside=True, rows=None):
    """The kernel's walk over its grid. ``product(a, b)`` is one stage's
    contraction ``a @ b`` (its 9 taps x 8 channels at once) as the kernel
    takes it, ``add(acc, s)`` its addition to the sums; the intermediate
    is kept in the dtype ``product`` returns. ``zero_outside=False``
    leaves out-of-image intermediate positions as the walk computes them;
    ``rows`` overrides the run length of ``chain_rows``."""
    product = product or (lambda a, b: a @ b)
    add = add or (lambda acc, s: acc + s)
    n, h, c, w = x.shape
    k1, k2 = w1.shape[3], w2.shape[3]
    kt = k_tier(max(k1, k2))
    p = plan_mirror(kt)
    bp, zr = p["bp"], p["zr"]
    # as the wrapper passes them: W and the weights' K padded to 4
    xp, w1p, w2p = tma_operand(x), tma_operand(w1), tma_operand(w2)
    w9 = [wt.reshape(9, wt.shape[2], wt.shape[3]) for wt in (w1p, w2p)]
    run = rows or CH.chain_rows(n, h, w, kt)
    y = torch.full((n, h, k2, w), float("nan"), dtype=torch.float64)
    for nn in range(n):
        for col0 in range(0, w, TW):
            for i0 in range(0, h, run):
                rows_ = min(run, h - i0)
                bands = -(-(rows_ + 2) * IW // bp)
                assert bands == CH.bands(rows_, kt)
                ring = None
                for band in range(bands):
                    p0 = band * bp
                    fr = p0 // IW
                    pos = torch.arange(p0, p0 + bp)
                    rr, cc = pos // IW, pos % IW
                    acc = 0
                    for ch in range(-(-c // CC)):
                        xs = tma_box(xp[nn], (i0 + fr - 2, ch * CC, col0 - 4),
                                     p["x_box"])
                        wb = tma_box(w9[0], (0, ch * CC, 0), p["w_box"])
                        # tap (u, v): staged row rr - fr + u, column cc +
                        # v + 2; (positions, 9 taps x 8 channels)
                        a = torch.cat([xs[rr - fr + u, :, cc + v + 2]
                                       for u in range(3) for v in range(3)],
                                      1)
                        acc = add(acc, product(a, wb.reshape(9 * CC, kt)))
                    z = _ep(acc, b1, slope, pn_eps, k1)
                    if ring is None:
                        ring = Ring(zr, kt, z.dtype)
                    gr, gc = i0 - 1 + rr, col0 - 1 + cc
                    inside = (gr >= 0) & (gr < h) & (gc >= 0) & (gc < w)
                    if zero_outside:
                        z = torch.where(inside[:, None], z, torch.zeros(()))
                    ring.store(rr, cc, z)
                    # stage 2: run rows o_first .. o_last, 2 MW M-tiles
                    done = (p0 + bp) // IW - 1
                    o_first, o_last = max(0, fr - 2), min(rows_ - 1, done - 2)
                    assert o_last - o_first + 1 <= 2 * p["mw"]
                    if o_last < o_first:
                        continue
                    o = torch.arange(o_first, o_last + 1)
                    q = torch.arange(TW)
                    oo, qq = o.repeat_interleave(TW), q.repeat(len(o))
                    acc = 0
                    for ch in range(-(-k1 // CC)):
                        wb = tma_box(w9[1], (0, ch * CC, 0), p["w_box"])
                        a = torch.cat([
                            ring.load(oo + u, qq + v)[:, ch * CC:ch * CC + CC]
                            for u in range(3) for v in range(3)], 1)
                        acc = add(acc, product(a, wb.reshape(9 * CC, kt)))
                    out = _ep(acc, b2, slope, pn_eps, k2)[:, :k2].double()
                    keep = col0 + qq < w
                    y[nn, i0 + oo[keep], :, col0 + qq[keep]] = out[keep]
    return y


def _inputs(n, h, c, k1, k2, w, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32))
    return (f(n, h, c, w), f(3, 3, c, k1, scale=(2.0 / (9 * c)) ** 0.5),
            f(k1, scale=0.1), f(3, 3, k1, k2, scale=(2.0 / (9 * k1)) ** 0.5),
            f(k2, scale=0.1))


# the ragged shape of chip_smoke's phase 3 (W not a multiple of 4, K2 <
# K1: KT 16), the 256 px stage's widths (KT 32) and K = 64 (KT 64, one
# M-tile a warpgroup) with C, K1 and K2 of no tier
SHAPES = [(2, 37, 24, 16, 8, 45), (1, 16, 64, 32, 32, 40),
          (1, 9, 5, 40, 60, 70)]


@pytest.mark.parametrize("rows", ["plan", "whole"])
@pytest.mark.parametrize("pn_eps", [1e-8, None])
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_walk_equals_plain_in_float64(shape, pn_eps, rows):
    """At the wrapper's run length and at one run a strip (many bands, the
    ring turning over)."""
    args = [a.double() for a in _inputs(*shape)]
    want = CH.conv3x3_chain_plain(*args, slope=0.2, pn_eps=pn_eps)
    got = emulate_chain(*args, slope=0.2, pn_eps=pn_eps,
                        rows=shape[1] if rows == "whole" else None)
    assert not got.isnan().any()  # every output pixel written
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_out_of_image_intermediate_is_zero_padding(shape):
    """Without the mask the walk would leave ep(conv(0)) at out-of-image
    intermediate positions (nonzero: ep of the bias), and the border
    pixels would differ from the plain version."""
    args = [a.double() for a in _inputs(*shape)]
    want = CH.conv3x3_chain_plain(*args, slope=0.2, pn_eps=None)
    got = emulate_chain(*args, slope=0.2, pn_eps=None, zero_outside=False,
                        rows=shape[1])
    border = (got - want).abs().amax(dim=(0, 2))  # (H, W)
    assert float(border[0].max()) > 1e-3 and float(border[:, 0].max()) > 1e-3
    assert float(border[1:-1, 1:-1].max()) < 1e-12  # the interior agrees


def _tf32_product(a, b):
    return three_products(torch.matmul, a, b)  # rounded to f32


def _f32_add(acc, s):
    return s.float() if isinstance(acc, int) else (acc + s).float()


@pytest.mark.parametrize("products,within", [("three", True), ("one", False)])
@pytest.mark.parametrize("pn_eps", [1e-8, None])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_tf32_split_of_both_stages_against_float64(shape, pn_eps, products,
                                                   within):
    """The kernel's arithmetic: stage 1's A from the staged input and stage
    2's A from the f32 intermediate in the ring, each split into TF32
    (hi, lo) as it is loaded, a stage's 9 taps summed exactly and added
    to the f32 sums with a rounded add; three products keep CONV_TOL of
    float64, one does not."""
    args = _inputs(*shape)
    want = CH.conv3x3_chain_plain(*[a.double() for a in args], slope=0.2,
                                  pn_eps=pn_eps)
    if products == "three":
        product = _tf32_product
    else:
        def product(a, b):
            return one_product(torch.matmul, a, b)
    got = emulate_chain(*args, slope=0.2, pn_eps=pn_eps, product=product,
                        add=_f32_add, rows=shape[1])
    ok = torch.allclose(got, want, **CONV_TOL)
    assert ok == within, float((got - want).abs().max())


PAPER_STAGES = [  # (x, w1, w2) NHCW / HWIO of the depth-8 serve's chains
    ((16, 256, 64, 256), (3, 3, 64, 32), (3, 3, 32, 32)),
    ((16, 512, 32, 512), (3, 3, 32, 16), (3, 3, 16, 16)),
    ((16, 1024, 16, 1024), (3, 3, 16, 8), (3, 3, 8, 8)),
]
# KT, M-tiles a warpgroup, ring rows, shared memory, run length, bands
PAPER_PLANS = [(32, 2, 7, 223312, 129, 34), (16, 4, 11, 200272, 512, 67),
               (8, 5, 13, 174928, 1024, 106)]


@pytest.mark.parametrize("stage,plan", list(zip(PAPER_STAGES, PAPER_PLANS)))
def test_paper_stage_plans(stage, plan):
    x, w1, w2 = stage
    n, h, _c, w = x
    kt = k_tier(max(w1[3], w2[3]))
    assert CH.chain_supported(x, w1, w2)
    p = plan_mirror(kt)
    rows = CH.chain_rows(n, h, w, kt)
    assert (kt, p["mw"], p["zr"], p["smem"], rows,
            CH.bands(rows, kt)) == plan
    # one block an SM; the items fill the card's SMs at least once
    assert p["smem"] + 1024 <= 228 * 1024
    items = n * -(-w // TW) * -(-h // rows)
    assert items >= 0.95 * 132
    # stage 1 computes a run's intermediate once, its halo rows and the
    # last band's rest aside: under 4% above one position an output pixel
    # (66 / 64 of them a row)
    runs = -(-h // rows)
    computed = runs * CH.bands(rows, kt) * p["bp"]
    assert computed / (h * IW) < 1.04


@pytest.mark.parametrize("k2t", K_TIERS)
@pytest.mark.parametrize("k1t", K_TIERS)
def test_every_plan_fits_a_block(k1t, k2t):
    """``chain_supported`` takes every K1, K2 up to 64 without a shared
    memory check: the plan of their tier fits a block, its boxes follow
    TMA's rules, a band's new output rows fit its 2 MW M-tiles, and the
    ring holds a band's rows and the two before them."""
    p = plan_mirror(k_tier(max(k1t, k2t)))
    assert p["smem"] <= SMEM_LIMIT
    tma_box(torch.zeros(p["xr"] + 2, CC, 2 * TW), (-2, 0, -4), p["x_box"])
    tma_box(torch.zeros(9, CC, k2t), (0, 0, 0), p["w_box"])
    for p0 in range(0, 4 * IW * p["bp"], p["bp"]):
        fr, last = p0 // IW, (p0 + p["bp"] - 1) // IW
        done = (p0 + p["bp"]) // IW - 1
        assert done - max(0, fr - 2) - 1 <= 2 * p["mw"]
        assert last - (fr - 2) + 1 <= p["zr"]
        assert last - fr + 1 <= p["span"]
    assert CH.chain_supported((1, 4, 8, 4), (3, 3, 8, k1t), (3, 3, k1t, k2t))


@pytest.mark.parametrize("shape,pn", [((2, 9, 24, 16, 8, 44), True),
                                      ((2, 9, 24, 16, 8, 45), False),
                                      ((1, 5, 8, 7, 60, 12), True)])
def test_chain_launch_arguments(monkeypatch, shape, pn):
    """The wrapper's launch with the library stubbed out: no workspace, x
    and the weights as TMA takes them (a ragged W or K padded with zeros),
    the image's W beside the padded row length, KT of the larger K, the
    run length of ``chain_rows``; the output sliced back to W."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *a: calls.append((name, fn, a)))
    monkeypatch.setattr(_build, "use_plain", lambda t: False)
    n, h, c, k1, k2, w = shape
    x, w1, b1, w2, b2 = _inputs(*shape)
    y = CH.conv3x3_chain(x, w1, b1, w2, b2, slope=0.2,
                         pn_eps=1e-8 if pn else None)
    wp = -(-w // 4) * 4
    assert y.shape == (n, h, k2, w) and y.is_contiguous()
    (name, fn, args), = calls
    assert fn == "pggan_conv3x3_chain"
    assert name == ("conv3x3_chain_pn" if pn else "conv3x3_chain")
    assert len(args) == len(_build._SIGNATURES[fn]) - 1  # and the stream
    kt = k_tier(max(k1, k2))
    assert args[6:16] == (n, h, c, w, wp, k1, k2, kt,
                          CH.chain_rows(n, h, w, kt), int(pn))
    assert args[2] == b1.data_ptr() and args[4] == b2.data_ptr()
    assert (args[0] == x.data_ptr()) == (wp == w)
    assert (args[1] == w1.data_ptr()) == (k1 % 4 == 0)
    assert (args[3] == w2.data_ptr()) == (k2 % 4 == 0)


# -- the upsample's grid ---------------------------------------------------

def upsample_plan(n, h, c, w, offset_floats=0):
    """The kernel's launch: vector width, vectors a row, lx, grid."""
    v2 = w % 2 == 0 and offset_floats % 2 == 0
    wv = w // 2 if v2 else w
    lx = 0
    while lx < 8 and (KE << lx) < wv:
        lx += 1
    rows = n * h * c
    return v2, wv, lx, (-(-rows // (256 >> lx)), -(-wv // (KE << lx)))


def emulate_upsample(x, offset_floats=0):
    """Runs the kernel's index map: every (block, thread, e) that passes
    the bounds reads one input vector and writes it, each element twice,
    into output rows 2h and 2h + 1. Returns the output and a count of
    writes per output element."""
    n, h, c, w = x.shape
    v2, wv, lx, (gx, gy) = upsample_plan(n, h, c, w, offset_floats)
    vec = 2 if v2 else 1
    rows = n * h * c
    xf = x.reshape(rows, w)
    out = torch.zeros(n * 2 * h * c * 2 * w, dtype=x.dtype)
    count = torch.zeros(out.numel(), dtype=torch.int32)
    tid = torch.arange(256)
    tx, ty = tid & ((1 << lx) - 1), tid >> lx
    bx = torch.arange(gx)
    r = (bx[:, None] * (256 >> lx) + ty[None, :]).reshape(-1)   # (gx*256,)
    txr = tx.repeat(gx)
    live = r < rows
    r, txr = r[live], txr[live]
    nh = torch.div(r, c, rounding_mode="floor")
    o0 = r + nh * c  # output row 2h
    ones = torch.ones(r.numel(), dtype=torch.int32)
    for by in range(gy):
        for e in range(KE):
            j = by * (KE << lx) + txr + (e << lx)
            ok = j < wv
            rr, jj, oo = r[ok], j[ok], o0[ok]
            for k in range(vec):  # the elements of one vector
                src = xf[rr, vec * jj + k]
                for a in (0, 1):  # rows 2h, 2h + 1
                    row = (oo + a * c) * 2 * w
                    for b in (0, 1):  # each element twice along W
                        idx = row + 2 * (vec * jj + k) + b
                        out[idx] = src
                        count.index_add_(0, idx, ones[:idx.numel()])
    return out.reshape(n, 2 * h, c, 2 * w), count


@pytest.mark.parametrize("shape,offset", [
    ((16, 128, 64, 128), 0), ((16, 256, 32, 256), 0),
    ((16, 512, 16, 512), 0),          # the serve's three stages
    ((3, 37, 5, 45), 0),              # ragged: odd W, scalar path
    ((9, 512, 1, 512), 0),            # an NCHW toRGB view (N*3, H, 1, W)
    ((2, 6, 5, 46), 0),               # W % 4 == 2: pairs still
    ((3, 16, 8, 64), 1),              # a view at an odd float offset
])
def test_upsample_index_map_writes_each_output_once(shape, offset):
    n, h, c, w = shape
    v2, wv, lx, grid = upsample_plan(n, h, c, w, offset)
    assert v2 == (w % 2 == 0 and offset % 2 == 0)
    assert grid[1] <= 65535 and (KE << lx) * grid[1] >= wv
    if math.prod(shape) > 4 * 2 ** 20:
        # the serve shapes: one image's rows hold every distinct block and
        # thread pattern; the grid repeats them over images (rows = N * H
        # * C, a whole number of blocks an image where 256 >> lx divides
        # H * C)
        assert (h * c) % (256 >> lx) == 0
        n = 1
    x = torch.arange(n * h * c * w, dtype=torch.float64).reshape(n, h, c, w)
    y, count = emulate_upsample(x, offset)
    assert bool((count == 1).all())
    want = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=3)
    assert torch.equal(y, want)


# -- the launch path -------------------------------------------------------

class _StubFunction:
    def __init__(self, log, name):
        self.log, self.name = log, name
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.log.append(("argtypes", self.name))
        self._argtypes = value

    def __call__(self, *args):
        self.log.append(("call", self.name, args))
        return 0


class _StubLibrary:
    """Stands in for the kernel library (no nvcc here): records each
    attribute lookup, argtypes assignment and call."""

    def __init__(self):
        self.log = []
        self.pggan_error_string = lambda e: b"stub error"

    def __getattr__(self, name):
        if not name.startswith("pggan_"):
            raise AttributeError(name)
        self.log.append(("lookup", name))
        return _StubFunction(self.log, name)


CUDA0 = torch.device("cuda", 0)


def _no_guard(monkeypatch):
    """No card here: the device guard does nothing."""
    monkeypatch.setattr(_build, "_device_guard",
                        lambda device: contextlib.nullcontext())


def test_launch_resolves_each_entry_point_once(monkeypatch):
    stub = _StubLibrary()
    monkeypatch.setattr(_build, "_lib", stub)
    monkeypatch.setattr(_build, "_ENTRY", {})
    monkeypatch.setattr(_build, "_current_stream", lambda device: 7)
    monkeypatch.setattr(_build, "_capturing", lambda: False)
    monkeypatch.setattr(_build, "LAUNCHES", _build.collections.Counter())
    _no_guard(monkeypatch)
    for _ in range(3):
        _build.launch("upsample2x", "pggan_upsample2x", CUDA0, 1, 2, 1, 2, 3,
                      4)
    _build.launch("avgpool2x", "pggan_avgpool2x", CUDA0, 1, 2, 1, 2, 3, 4)
    kinds = [e[:2] for e in stub.log]
    assert kinds.count(("lookup", "pggan_upsample2x")) == 1
    assert kinds.count(("argtypes", "pggan_upsample2x")) == 1
    assert kinds.count(("call", "pggan_upsample2x")) == 3
    assert kinds.count(("lookup", "pggan_avgpool2x")) == 1
    assert _build._ENTRY["pggan_upsample2x"].argtypes == list(
        _build._SIGNATURES["pggan_upsample2x"])
    calls = [e for e in stub.log if e[0] == "call"]
    assert calls[0][2] == (1, 2, 1, 2, 3, 4, 7)  # the stream goes last
    assert dict(_build.LAUNCHES) == {"upsample2x": 3, "avgpool2x": 1}


class _FailingFunction(_StubFunction):
    def __call__(self, *args):
        return 1  # cudaErrorInvalidValue


def test_failed_launch_raises_and_is_not_counted(monkeypatch):
    stub = _StubLibrary()
    failing = _FailingFunction(stub.log, "pggan_upsample2x")
    monkeypatch.setattr(_build, "_lib", stub)
    monkeypatch.setattr(_build, "_ENTRY", {"pggan_upsample2x": failing})
    monkeypatch.setattr(_build, "_current_stream", lambda device: 0)
    monkeypatch.setattr(_build, "_capturing", lambda: False)
    monkeypatch.setattr(_build, "LAUNCHES", _build.collections.Counter())
    _no_guard(monkeypatch)
    with pytest.raises(RuntimeError, match="stub error"):
        _build.launch("upsample2x", "pggan_upsample2x", CUDA0, 0, 0, 1, 1, 1,
                      1)
    assert not _build.LAUNCHES


def test_launch_under_graph_capture_counts_as_captured(monkeypatch):
    """A call while a CUDA graph is captured records the kernel for the
    replays and launches nothing: it counts in CAPTURED, not LAUNCHES."""
    stub = _StubLibrary()
    monkeypatch.setattr(_build, "_lib", stub)
    monkeypatch.setattr(_build, "_ENTRY", {})
    monkeypatch.setattr(_build, "_current_stream", lambda device: 7)
    monkeypatch.setattr(_build, "LAUNCHES", _build.collections.Counter())
    monkeypatch.setattr(_build, "CAPTURED", _build.collections.Counter())
    _no_guard(monkeypatch)
    for capturing in (True, True, False):
        monkeypatch.setattr(_build, "_capturing", lambda c=capturing: c)
        _build.launch("avgpool2x", "pggan_avgpool2x", CUDA0, 1, 2, 1, 2, 3, 4)
    assert dict(_build.CAPTURED) == {"avgpool2x": 2}
    assert dict(_build.LAUNCHES) == {"avgpool2x": 1}
