"""Same-padding 3x3 convolution on NHCW tensors with an optional fused
epilogue, and its weight gradient, as autograd Functions that can be
differentiated to any order: the counterpart of
``pggan_tpu/ops/pallas_conv.py``.

Four Functions, two CUDA kernels:

- ``conv3x3(x, w)``: the plain conv (TPU kernel ``conv3x3_small_c``);
- ``conv3x3_act(x, w, b, slope=)``: ``lrelu(conv + b)``
  (``conv3x3_act_small_c`` with ``pn_eps=None``);
- ``conv3x3_act_pn(x, w, b, slope=, eps=)``: ``pixelnorm(lrelu(conv + b))``
  over K, returning ``(o, r)`` with ``r = rsqrt(mean_K(z^2) + eps)`` of
  shape (N, H, W) (``conv3x3_act_small_c`` with ``pn_eps`` set);
- ``conv3x3_dw(x, ct)``: the weight gradient, (3, 3, C, K)
  (``conv3x3_dw_small_c``).

The first three run ``csrc/conv3x3.cu``, templated on the epilogue, the
last ``csrc/conv3x3_dw.cu``. x is (N, H, C, W) and w is (3, 3, C, K) HWIO,
already scaled by any equalized-LR constant, as in the JAX package. Each
Function chooses its route inside ``forward``: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain PyTorch version in this
module, and either way the backward below is the one that runs.

The backward rules are the VJPs of the JAX rules (``pallas_conv.py:457-737``)
and are built only from these Functions and differentiable torch ops, so the
gradient penalty can differentiate D's input gradient a second time:
``conv3x3`` and ``conv3x3_dw`` transpose into each other, and the fused
epilogues take the activation mask from the sign of the output and close on
pixelnorm's ``r``. A term whose input needs no gradient is skipped
(``ctx.needs_input_grad``, fixed at forward time). Inside
``input_grad_only()`` the conv Functions' backward takes no weight or bias
gradient either: the gradient penalty's inner ``autograd.grad`` asks only
for the input gradient, and the weights' second-order terms come from the
graph of that input gradient, not from these skipped terms.

Both kernels run on Hopper's tensor cores in TF32 (warpgroup MMAs,
``wgmma``; the weight gradient's tiles for K <= 16 on the warp-level
``mma.sync``), with each f32 operand split into two TF32 values, a = hi +
lo, and each product taken as hi hi + hi lo + lo hi (``csrc/hopper.cuh``):
f32 accuracy (one TF32 product does not), at a third of the card's 495
TFLOP/s TF32 rate where f32 FMAs give 67. Their tiles arrive by TMA on
rings of ``mbarrier`` stages filled by a producer warpgroup
(``csrc/hopper.cuh``), whose zero fill outside the tensor is the
convolution's padding. The conv is an implicit GEMM of output pixels by
output channels on a persistent grid, bound by operations at 128-256 px
and by bytes at 512-1024 px, the weights split inside the kernel; more
than 64 output channels (no pixelnorm) run as groups of 64 in one launch
(output channels are independent, so this is exact), and with pixelnorm a
pixel's K outputs stay in one quad of lanes.
The weight gradient is the transposed GEMM (taps x input channels by
output channels, reduced over pixels), split over pixel slices in two
deterministic passes. TMA wants 16-byte strides, so a W (or the conv's K)
that is not a multiple of 4 reaches the kernels padded with zeros (exact:
the conv's padding is zero, zero weights add nothing, and zero columns
add nothing to the weight gradient), and the padded columns of the output
are sliced off; no step shape needs it. Design notes in the sources.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import _build

K_TIERS = (8, 16, 32, 64)
_EPI_NONE, _EPI_ACT, _EPI_ACT_PN = 0, 1, 2
# the H100's SMs: the dw and chain kernels walk their work items on a
# persistent grid, one block an SM
_SMS = 132
# image rows a dw work item walks, at least and at most: each warpgroup's
# f32 sums run over an item's rows, and whole-image runs let a step on a
# half batch and one on the whole part past chip_smoke.py's phase B bar
_DW_MIN_ROWS, _DW_MAX_ROWS = 8, 24


def k_tier(k: int) -> int:
    """The kernels' register tile for ``k`` output channels: the smallest
    of 8, 16, 32, 64 that holds them."""
    for t in K_TIERS:
        if k <= t:
            return t
    raise ValueError(f"one launch of the conv kernel takes at most "
                     f"{K_TIERS[-1]} output channels, got {k}")


def supported(x_nhcw_shape, w_shape, pixelnorm: bool = False) -> bool:
    """Can the CUDA kernel take this shape? Any H, W and C; a 3x3 kernel
    over the same C; any K without pixelnorm (groups of 64), at most 64 with
    it (the mean over K stays in one block)."""
    _n, _h, c, _w = x_nhcw_shape
    kh, kw, wc, k = w_shape
    k_max = K_TIERS[-1] if pixelnorm else math.inf
    return (kh, kw) == (3, 3) and wc == c and 1 <= k <= k_max


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the kernels' TMA loads take it: its last axis (W of an
    NHCW tensor, K of the weights) a multiple of 4 (TMA's global strides
    are multiples of 16 bytes), padded with zeros where it is not, and the
    data 16-byte aligned, copied where it is not. Every tensor of the step
    is taken as it is."""
    pad = -t.shape[-1] % 4
    if pad:
        return F.pad(t, (0, pad))
    return t.clone() if t.data_ptr() % 16 else t


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """Spatially flipped, in/out-swapped weights (``pallas_conv.py:484``):
    ``conv3x3(ct, flip_io(w))`` is the input gradient of ``conv3x3(x, w)``."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


# -- plain PyTorch versions (the CPU route and the kernels' references) -----

def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 2, 1, 3), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 1, 3).contiguous()


def _act_plain(z, b, slope):
    z = z + b[None, None, :, None]
    return torch.where(z >= 0, z, z * slope)


def conv3x3_act_plain(x, w, b, *, slope: float) -> torch.Tensor:
    return _act_plain(conv3x3_plain(x, w), b, slope)


def conv3x3_act_pn_plain(x, w, b, *, slope: float, eps: float = 1e-8):
    z = _act_plain(conv3x3_plain(x, w), b, slope)
    r = torch.rsqrt(torch.mean(z * z, dim=2) + eps)
    return z * r[:, :, None, :], r


def conv3x3_dw_plain(x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Nine shifted-slice contractions (``pallas_conv.py:431-454``,
    ``_dw_einsum``): for row offset ``du = u - 1`` the cotangent rows
    ``[max(0, -du), H - max(0, du))`` meet x rows ``[max(0, du),
    H + min(0, du))``, and likewise for columns; the zero padding adds
    nothing."""
    n, h, c, w = x.shape
    k = ct.shape[2]
    taps = []
    for u in range(3):
        du = u - 1
        xr0, cr0, rows = max(0, du), max(0, -du), max(0, h - abs(du))
        for v in range(3):
            dv = v - 1
            xc0, cc0, cols = max(0, dv), max(0, -dv), max(0, w - abs(dv))
            xs = x[:, xr0:xr0 + rows, :, xc0:xc0 + cols]
            cs = ct[:, cr0:cr0 + rows, :, cc0:cc0 + cols]
            taps.append(torch.einsum("nhcw,nhkw->ck", xs, cs))
    return torch.stack(taps).reshape(3, 3, c, k)


# -- the kernel routes --------------------------------------------------------

def _check(x, w, b=None, pixelnorm=False):
    """What the kernel takes, checked on both routes so that the CPU tests
    hold callers to the same contract."""
    tensors = (x, w) if b is None else (x, w, b)
    if (x.ndim != 4 or w.ndim != 4
            or not supported(x.shape, w.shape, pixelnorm)):
        raise ValueError(f"conv3x3 kernel cannot take x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}"
                         + (" with pixelnorm" if pixelnorm else ""))
    if b is not None and tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"bias {tuple(b.shape)} for {w.shape[3]} channels")
    _build.check_kernel_inputs(*tensors)


def _launch(name, epi, x, w, b, slope, eps):
    """One launch; more than 64 output channels run as groups of 64 in it
    (output channels are independent, so this is exact). A ragged W or K
    runs padded (``tma_operand``): the padded columns' outputs are sliced
    off, the zero columns are the padding of the last real column, and the
    zero weights' channels are never stored."""
    n, h, c, wd = x.shape
    k = w.shape[3]
    x, w = tma_operand(x), tma_operand(w)
    wp = x.shape[3]
    y = torch.empty((n, h, k, wp), dtype=x.dtype, device=x.device)
    r = (torch.empty((n, h, wp), dtype=x.dtype, device=x.device)
         if epi == _EPI_ACT_PN else None)
    if y.numel():
        _build.launch(name, "pggan_conv3x3", x.device, x.data_ptr(),
                      w.data_ptr(), None if b is None else b.data_ptr(),
                      y.data_ptr(), None if r is None else r.data_ptr(), n,
                      h, c, wp, k, k_tier(min(k, K_TIERS[-1])), epi,
                      float(slope), float(eps))
    if wp != wd:
        y = y[..., :wd].contiguous()
        r = None if r is None else r[..., :wd].contiguous()
    return y, r


def _conv_fwd(x, w):
    _check(x, w)
    if _build.use_plain(x):
        return conv3x3_plain(x, w)
    return _launch("conv3x3", _EPI_NONE, x, w, None, 0.0, 0.0)[0]


def _act_fwd(x, w, b, slope):
    _check(x, w, b)
    if _build.use_plain(x):
        return conv3x3_act_plain(x, w, b, slope=slope)
    return _launch("conv3x3_act", _EPI_ACT, x, w, b, slope, 0.0)[0]


def _act_pn_fwd(x, w, b, slope, eps):
    _check(x, w, b, pixelnorm=True)
    if _build.use_plain(x):
        return conv3x3_act_pn_plain(x, w, b, slope=slope, eps=eps)
    return _launch("conv3x3_act_pn", _EPI_ACT_PN, x, w, b, slope, eps)


def dw_cols(kt: int) -> int:
    """Columns of a dw work item (``csrc/conv3x3_dw.cu`` ``DwPlan::TW``):
    64 at KT = 64 (its hi / lo B operands of a row fill shared memory at
    128), else 128."""
    return 64 if kt == 64 else 128


@functools.lru_cache(maxsize=None)
def dw_plan(n, h, c, w, k, kt=None):
    """The dw kernel's k tile KT, channel chunk CC, image rows per work
    item, row runs per image and column tiles (``csrc/conv3x3_dw.cu``
    ``DwPlan``). KT is K's tier: m16 ``mma.sync`` tiles at 8 and 16,
    ``wgmma`` at 32 and 64, K > 64 in k tiles of 64 (x loaded once for 64
    channels), which an H100 ran as fast as k tiles of 32 or up to 7%
    faster at the K >= 64 shapes of the step (``chip_smoke.py`` phase 3
    times both; ``kt`` overrides). CC is 8 for C <= 8 at KT <= 16 (9 x 8 rows fill
    five m16 tiles), else 16. The run length (``_DW_MIN_ROWS`` to
    ``_DW_MAX_ROWS`` rows where the image has them) makes the least of the
    rounds of items over the card's SMs times an item's stages (its rows
    and two halo rows): the SMs stay evenly busy and the halo rows a small
    share."""
    kt = k_tier(min(k, 64)) if kt is None else kt
    cc = 8 if c <= 8 and kt <= 16 else 16
    col_tiles = -(-w // dw_cols(kt))
    tiles = n * -(-c // cc) * -(-k // kt) * col_tiles

    def cost(rows):
        return -(-tiles * -(-h // rows) // _SMS) * (rows + 2)
    rows = range(min(h, _DW_MIN_ROWS), min(h, _DW_MAX_ROWS) + 1)
    chunks = -(-h // min(rows, key=cost))
    rows_per_block = -(-h // chunks)
    return kt, cc, rows_per_block, -(-h // rows_per_block), col_tiles


def _dw_fwd(x, ct, kt=None):
    if x.ndim != 4 or ct.ndim != 4 or (
            (ct.shape[0], ct.shape[1], ct.shape[3])
            != (x.shape[0], x.shape[1], x.shape[3])):
        raise ValueError(f"conv3x3_dw kernel cannot take x {tuple(x.shape)}, "
                         f"ct {tuple(ct.shape)}")
    _build.check_kernel_inputs(x, ct)
    if _build.use_plain(x):
        return conv3x3_dw_plain(x, ct)
    n, h, c, wd = x.shape
    k = ct.shape[2]
    dw = torch.empty((3, 3, c, k), dtype=x.dtype, device=x.device)
    if not dw.numel():
        return dw
    if not x.numel():
        return dw.zero_()
    # a ragged W padded with zero columns, which add nothing
    x, ct = tma_operand(x), tma_operand(ct)
    wd = x.shape[3]
    kt, cc, rows_per_block, row_chunks, col_tiles = dw_plan(n, h, c, wd, k,
                                                            kt=kt)
    # a partial for each of the kernel's two warpgroups a pixel slice
    ws = torch.empty((2 * n * row_chunks * col_tiles, 9, c, k),
                     dtype=x.dtype, device=x.device)
    _build.launch("conv3x3_dw", "pggan_conv3x3_dw", x.device, x.data_ptr(),
                  ct.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, h, c, wd,
                  k, kt, cc, rows_per_block, row_chunks, col_tiles)
    return dw


# -- autograd -------------------------------------------------------------------

def _mask(g, o, slope):
    """The leaky ReLU's derivative applied to ``g``, from the sign of the
    output (``pallas_conv.py:601-608``): sign(o) == sign(z) for slope > 0."""
    return torch.where(o >= 0, g, g * slope)


# Set while a backward needs only the conv inputs' gradient (see
# ``input_grad_only``). Module-level, not thread-local: on the card the
# autograd engine runs the backward on its own device thread.
_INPUT_GRAD_ONLY = False


@contextlib.contextmanager
def input_grad_only():
    """While inside, the conv Functions' backward computes gx only, no gw
    and no gb: for an ``autograd.grad`` with respect to activations alone,
    whose weight gradients nothing would read. ``ctx.needs_input_grad``
    cannot say so: it is fixed when the forward runs. The flag is read when
    the backward runs, so the second-order terms that a later backward takes
    through the recorded gx are untouched."""
    global _INPUT_GRAD_ONLY
    before, _INPUT_GRAD_ONLY = _INPUT_GRAD_ONLY, True
    try:
        yield
    finally:
        _INPUT_GRAD_ONLY = before


def _conv_grads(ctx, x, w, gy, bias: bool):
    """gx, gw (and gb) of ``conv3x3(x, w) (+ b)`` for output cotangent gy,
    skipping the inputs that need no gradient, and gw and gb inside
    ``input_grad_only()``."""
    need = ctx.needs_input_grad
    weights = not _INPUT_GRAD_ONLY
    gy = gy.contiguous()
    gx = conv3x3(gy, flip_io(w)) if need[0] else None
    gw = conv3x3_dw(x, gy) if need[1] and weights else None
    if not bias:
        return gx, gw
    return gx, gw, (gy.sum((0, 1, 3)) if need[2] and weights else None)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _conv_grads(ctx, x, w, g, bias=False)


class _Conv3x3Dw(torch.autograd.Function):
    # bilinear in (x, ct); its transposes are convs of the other operand
    # with the weight cotangent cw (pallas_conv.py:525-560)
    @staticmethod
    def forward(ctx, x, ct):
        ctx.save_for_backward(x, ct)
        return _dw_fwd(x, ct)

    @staticmethod
    def backward(ctx, cw):
        x, ct = ctx.saved_tensors
        need = ctx.needs_input_grad
        cw = cw.contiguous()
        gx = conv3x3(ct, flip_io(cw)) if need[0] else None
        gct = conv3x3(x, cw) if need[1] else None
        return gx, gct


class _Conv3x3Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, slope):
        o = _act_fwd(x, w, b, slope)
        ctx.slope = slope
        ctx.save_for_backward(x, w, o)
        return o

    @staticmethod
    def backward(ctx, g):
        x, w, o = ctx.saved_tensors
        gy = _mask(g, o, ctx.slope)
        return (*_conv_grads(ctx, x, w, gy, bias=True), None)


class _Conv3x3ActPn(torch.autograd.Function):
    # With z = lrelu(conv(x, w) + b), o = z r and r = (mean_K z^2 + eps)^-1/2,
    # the JAX rule's tangents (pallas_conv.py:668-681) are
    #   s = mean_K(o tz),  to = r (tz - o s),  tr = -r^2 s.
    # Transposing, for cotangents go (N, H, K, W) and gr (N, H, W):
    #   <go, to> + <gr, tr>
    #     = sum_K tz [r go] - sum_pixels s [r sum_K(o go) + gr r^2]
    #     = sum_K tz [r go - (o / K)(r sum_K(o go) + gr r^2)],
    # so gz = r (go - o mean_K(o go)) - gr r^2 o / K, then gy = mask(o) gz.
    # A None cotangent (an output nobody used) drops its term.
    @staticmethod
    def forward(ctx, x, w, b, slope, eps):
        o, r = _act_pn_fwd(x, w, b, slope, eps)
        ctx.slope = slope
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, o, r)
        return o, r

    @staticmethod
    def backward(ctx, go, gr):
        x, w, o, r = ctx.saved_tensors
        rb = r[:, :, None, :]
        gz = None
        if go is not None:
            gz = rb * (go - o * torch.mean(o * go, dim=2, keepdim=True))
        if gr is not None:
            t = gr[:, :, None, :] * (rb * rb) * o / o.shape[2]
            gz = -t if gz is None else gz - t
        if gz is None:
            return None, None, None, None, None
        gy = _mask(gz, o, ctx.slope)
        return (*_conv_grads(ctx, x, w, gy, bias=True), None, None)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padding 3x3 conv, (N, H, C, W) x (3, 3, C, K) -> (N, H, K, W)."""
    return _Conv3x3.apply(x, w)


def conv3x3_dw(x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the 3x3 conv: (N, H, C, W) x (N, H, K, W) ->
    (3, 3, C, K)."""
    return _Conv3x3Dw.apply(x, ct)


def conv3x3_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                slope: float) -> torch.Tensor:
    """Fused ``leaky_relu(conv3x3(x, w) + b, slope)``; slope > 0 (the
    backward takes the mask from the output's sign)."""
    if not slope > 0:
        raise ValueError(f"the fused epilogue needs a leaky slope, got {slope}")
    return _Conv3x3Act.apply(x, w, b, float(slope))


def conv3x3_act_pn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   slope: float, eps: float = 1e-8):
    """Fused ``pixelnorm(leaky_relu(conv3x3(x, w) + b))`` over K; returns
    ``(o, r)`` with ``r = rsqrt(mean_K(z^2) + eps)``, shape (N, H, W)."""
    if not slope > 0:
        raise ValueError(f"the fused epilogue needs a leaky slope, got {slope}")
    return _Conv3x3ActPn.apply(x, w, b, float(slope), float(eps))
