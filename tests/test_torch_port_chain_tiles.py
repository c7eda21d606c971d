"""The CUDA chain kernel's tile plan (``Plan`` in ``csrc/conv_chain.cu``,
mirrored by ``chain_plan`` here) and the upsample kernel's index map
(``csrc/upsample2x.cu``), emulated in torch on the CPU.

The chain emulation walks the kernel's grid: for each TH x 32 output tile
it stages the input halo [row0 - 2, row0 + TH + 2) x [col0 - 4, col0 + 36)
with zeros outside the image, computes stage 1 over the flattened
intermediate positions p = s * 34 + q of the tile (m-tiles of 16), writes
positions outside the image as 0 (the second conv's padding, not
``ep(conv(0))``), and computes stage 2 per output m-tile from the staged
intermediate, storing only pixels inside the image. In float64 it must
equal the plain version to rounding; with the kernel's arithmetic (each
product as three TF32 products of split operands, the intermediate split
as it is loaded for stage 2) it must stay within the kernels' tolerance of
float64, where one TF32 product does not.

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
from pggan_tpu_torch.ops.conv3x3 import K_TIERS, k_tier
from test_torch_port_tf32_split import one_product, three_products

CONV_TOL = dict(rtol=1e-4, atol=1e-5)  # chip_smoke.CONV_TOL
# the chain kernel's constants: warps, output tile columns, intermediate
# row, channels a stage, staged input row and intermediate row (floats)
WARPS, TW, IW, CC, XS, ZS = 8, 32, 34, 8, 40, 40
SMEM_LIMIT = 232448  # the H100's dynamic shared memory a block, bytes
KE = 2  # the upsample's vectors a thread (csrc/upsample2x.cu kE)


def chain_plan(k1t, k2t):
    """``Plan<K1T, K2T>`` of the source, for channel tiers ``k1t``, ``k2t``:
    output rows ``th`` of a 32-column tile; stage 1's ``p1`` intermediate
    positions in ``m1`` m-tiles of 16, ``mt1`` a warp; stage 2's ``mt2``
    output m-tiles a warp; dynamic shared memory in bytes (stage 1's two
    input and w1 buffers, or the intermediate and two w2 buffers, in the
    same memory); the blocks an SM the launch bounds ask for."""
    kt = max(k1t, k2t)
    th = 8 if kt > 16 else 16
    p1 = (th + 2) * IW
    m1 = -(-p1 // 16)
    x_floats = (th + 4) * CC * XS
    w1_floats, w2_floats = 9 * CC * (k1t + 4) * 2, 9 * CC * (k2t + 4) * 2
    z_floats = (th + 2) * k1t * ZS
    return {"th": th, "p1": p1, "m1": m1, "mt1": -(-m1 // WARPS),
            "mt2": th * TW // 16 // WARPS,
            "smem": 4 * max(2 * (x_floats + w1_floats),
                            z_floats + 2 * w2_floats),
            "min_blocks": 1 if kt > 32 else 2 if kt > 8 else 3}


def _ep(z, b, slope, pn_eps):
    z = z + b
    z = torch.where(z >= 0, z, z * slope)
    if pn_eps is not None:
        z = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + pn_eps)
    return z


def emulate_chain(x, w1, b1, w2, b2, *, slope, pn_eps, product,
                  zero_outside=True):
    """The kernel's two-stage walk over its grid. ``product(a, b)`` is one
    tap's contraction ``a @ b`` as the kernel takes it; sums over taps
    run in the dtype ``product`` returns. ``zero_outside=False`` leaves
    out-of-image intermediate positions as the walk computes them."""
    n, h, c, w = x.shape
    k1, k2 = w1.shape[3], w2.shape[3]
    plan = chain_plan(k_tier(k1), k_tier(k2))
    th = plan["th"]
    y = torch.full((n, h, w, k2), float("nan"), dtype=torch.float64)
    p = torch.arange(plan["m1"] * 16)
    p = p[p < plan["p1"]]  # the last m-tile's padding computes nothing
    s, q = p // IW, p % IW
    for row0 in range(0, h, th):
        for col0 in range(0, w, TW):
            # staged halo: row sr, column t hold x[row0 - 2 + sr, :,
            # col0 - 4 + t], zero outside the image (kept channels-last
            # here, so a gather of positions is (n, P, C))
            xs = torch.zeros(n, th + 4, XS, c, dtype=x.dtype)
            r_lo, r_hi = max(0, row0 - 2), min(h, row0 + th + 2)
            c_lo, c_hi = max(0, col0 - 4), min(w, col0 + TW + 4)
            xs[:, r_lo - row0 + 2:r_hi - row0 + 2,
               c_lo - col0 + 4:c_hi - col0 + 4] = x[
                   :, r_lo:r_hi, :, c_lo:c_hi].transpose(2, 3)
            # stage 1 over the flattened positions p: tap (u, v) reads
            # staged row s + u, column q + v + 2
            acc = 0
            for u in range(3):
                for v in range(3):
                    a = xs[:, s + u, q + v + 2]  # (n, P, C)
                    acc = acc + product(a, w1[u, v])
            z1 = _ep(acc.double(), b1.double(), slope, pn_eps).to(x.dtype)
            gr, gc = row0 - 1 + s, col0 - 1 + q
            inside = (gr >= 0) & (gr < h) & (gc >= 0) & (gc < w)
            if zero_outside:
                z1 = torch.where(inside[None, :, None], z1, torch.zeros(()))
            zs = torch.zeros(n, th + 2, IW, k1, dtype=x.dtype)
            zs[:, s, q] = z1
            # stage 2: output m-tile i is row i // 2, columns (i % 2) * 16
            # + [0, 16); tap (u, v) reads intermediate (row + u, col + v)
            for i in range(th * TW // 16):
                orow, ocol = i // 2, (i % 2) * 16 + torch.arange(16)
                acc = 0
                for u in range(3):
                    for v in range(3):
                        a = zs[:, orow + u, ocol + v]  # (n, 16, K1)
                        acc = acc + product(a, w2[u, v])  # (n, 16, K2)
                out = _ep(acc.double(), b2.double(), slope, pn_eps)
                gr, gcs = row0 + orow, col0 + ocol
                keep = gcs < w
                if gr < h and keep.any():
                    y[:, gr, gcs[keep]] = out[:, keep]
    return y.transpose(2, 3)


def _inputs(n, h, c, k1, k2, w, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32))
    return (f(n, h, c, w), f(3, 3, c, k1, scale=(2.0 / (9 * c)) ** 0.5),
            f(k1, scale=0.1), f(3, 3, k1, k2, scale=(2.0 / (9 * k1)) ** 0.5),
            f(k2, scale=0.1))


# the ragged shape of chip_smoke's phase 3, and the 256 px stage's widths
SHAPES = [(2, 37, 24, 16, 8, 45), (1, 16, 64, 32, 32, 40)]


@pytest.mark.parametrize("pn_eps", [1e-8, None])
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_walk_equals_plain_in_float64(shape, pn_eps):
    args = [a.double() for a in _inputs(*shape)]
    want = CH.conv3x3_chain_plain(*args, slope=0.2, pn_eps=pn_eps)
    got = emulate_chain(*args, slope=0.2, pn_eps=pn_eps,
                        product=lambda a, b: a @ b)
    assert not got.isnan().any()  # every output pixel written
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_out_of_image_intermediate_is_zero_padding(shape):
    """Without the mask the walk would leave ep(conv(0)) at out-of-image
    intermediate positions (nonzero: ep of the bias), and the border
    pixels would differ from the plain version."""
    args = [a.double() for a in _inputs(*shape)]
    want = CH.conv3x3_chain_plain(*args, slope=0.2, pn_eps=None)
    got = emulate_chain(*args, slope=0.2, pn_eps=None,
                        product=lambda a, b: a @ b, zero_outside=False)
    border = (got - want).abs().amax(dim=(0, 2))  # (H, W)
    assert float(border[0].max()) > 1e-3 and float(border[:, 0].max()) > 1e-3
    assert float(border[1:-1, 1:-1].max()) < 1e-12  # the interior agrees


@pytest.mark.parametrize("products,within", [("three", True), ("one", False)])
@pytest.mark.parametrize("pn_eps", [1e-8, None])
@pytest.mark.parametrize("shape", SHAPES)
def test_tf32_split_of_both_stages_against_float64(shape, pn_eps, products,
                                                   within):
    """The kernel's arithmetic: stage 1's A from the staged input and stage
    2's A from the intermediate in shared memory, each split into TF32
    (hi, lo) as it is loaded; three products keep CONV_TOL of float64, one
    does not."""
    args = _inputs(*shape)
    want = CH.conv3x3_chain_plain(*[a.double() for a in args], slope=0.2,
                                  pn_eps=pn_eps)
    prod = three_products if products == "three" else one_product
    got = emulate_chain(*args, slope=0.2, pn_eps=pn_eps,
                        product=lambda a, b: prod(torch.matmul, a, b))
    ok = torch.allclose(got, want, **CONV_TOL)
    assert ok == within, float((got - want).abs().max())


PAPER_STAGES = [  # (x, w1, w2) NHCW / HWIO of the depth-8 serve's chains
    ((16, 256, 64, 256), (3, 3, 64, 32), (3, 3, 32, 32)),
    ((16, 512, 32, 512), (3, 3, 32, 16), (3, 3, 16, 16)),
    ((16, 1024, 16, 1024), (3, 3, 16, 8), (3, 3, 8, 8)),
]
# th, m1, mt1, mt2, shared memory, blocks an SM (launch bounds)
PAPER_PLANS = [(8, 22, 3, 2, 92672, 2), (16, 39, 5, 4, 74240, 2),
               (16, 39, 5, 4, 65024, 3)]


@pytest.mark.parametrize("stage,plan", list(zip(PAPER_STAGES, PAPER_PLANS)))
def test_paper_stage_plans(stage, plan):
    x, w1, w2 = stage
    k1, k2 = w1[3], w2[3]
    assert CH.chain_supported(x, w1, w2)
    p = chain_plan(k_tier(k1), k_tier(k2))
    assert (p["th"], p["m1"], p["mt1"], p["mt2"], p["smem"],
            p["min_blocks"]) == plan
    # the blocks the launch bounds ask for fit an SM's 228 KB (1 KB
    # reserved a block), and stage 1 recomputes at most 1.33x
    assert p["min_blocks"] * (p["smem"] + 1024) <= 228 * 1024
    assert p["p1"] / (p["th"] * TW) <= 4 / 3
    # the split weights' scratch: (9, C8, K1T + 4) + (9, K18, K2T + 4) pairs
    assert CH._workspace_floats(x[2], k1, k2) == 2 * 9 * (
        x[2] * (k_tier(k1) + 4) + k1 * (k_tier(k2) + 4))


@pytest.mark.parametrize("k2t", K_TIERS)
@pytest.mark.parametrize("k1t", K_TIERS)
def test_every_plan_fits_a_block(k1t, k2t):
    """``chain_supported`` takes every K1, K2 up to 64 without a shared
    memory check: every plan fits a block, and the blocks an SM its launch
    bounds ask for fit an SM."""
    p = chain_plan(k1t, k2t)
    assert p["smem"] <= SMEM_LIMIT
    assert p["min_blocks"] * (p["smem"] + 1024) <= 228 * 1024
    assert p["mt2"] * WARPS * 16 == p["th"] * TW  # the source's static_assert
    assert CH.chain_supported((1, 4, 8, 4), (3, 3, 8, k1t), (3, 3, k1t, k2t))


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
