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

Both kernels run on the H100's tensor cores: ``mma.sync`` m16n8k8 in TF32
with each f32 operand split into two TF32 values, a = hi + lo, and each
product taken as hi hi + hi lo + lo hi (``csrc/tf32_mma.cuh``). That keeps
f32 accuracy (one TF32 product does not), at a third of the card's 495
TFLOP/s TF32 rate where f32 FMAs give 67; the operands are staged with
double-buffered ``cp.async`` copies. The conv is an implicit GEMM of
output pixels by output channels, bound by operations at 128-256 px and by
bytes at 512-1024 px; more than 64 output channels (no pixelnorm) run as
groups of 64 in one launch's grid (output channels are independent, so
this is exact), and with pixelnorm a pixel's K outputs stay in one quad of
lanes. The weight gradient is the same GEMM transposed (taps x input
channels by output channels, reduced over pixels), split over pixel slices
in two deterministic passes. Design notes in the sources.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import _build

K_TIERS = (8, 16, 32, 64)
_EPI_NONE, _EPI_ACT, _EPI_ACT_PN = 0, 1, 2
# blocks the dw kernel's first pass aims for: 8 per SM of the H100
_DW_TARGET_BLOCKS = 8 * 132
_DW_COLS = 128  # columns of one dw block tile (csrc/conv3x3_dw.cu kTW)
_DW_MIN_ROWS = 8  # image rows a dw block walks, at least


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
    """One launch; more than 64 output channels run as groups of 64 in its
    grid (output channels are independent, so this is exact)."""
    n, h, c, wd = x.shape
    k = w.shape[3]
    y = torch.empty((n, h, k, wd), dtype=x.dtype, device=x.device)
    r = (torch.empty((n, h, wd), dtype=x.dtype, device=x.device)
         if epi == _EPI_ACT_PN else None)
    if not y.numel():
        return y, r
    kt = k_tier(min(k, K_TIERS[-1]))
    # scratch for the split weights: (groups, 9, C rounded up to 8, KT + 4,
    # 2)
    ws = torch.empty(-(-k // kt) * 9 * -(-c // 8) * 8 * (kt + 4) * 2,
                     dtype=x.dtype, device=x.device)
    _build.launch(name, "pggan_conv3x3", x.data_ptr(), w.data_ptr(),
                  None if b is None else b.data_ptr(), y.data_ptr(),
                  None if r is None else r.data_ptr(), ws.data_ptr(),
                  n, h, c, wd, k, kt, epi, float(slope), float(eps))
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


def _dw_plan(n, h, c, w, k):
    """The dw kernel's k tile, image rows per block, row runs per image and
    column tiles: enough blocks to fill the card, each over a run of at
    least ``_DW_MIN_ROWS`` rows (where the image has them) of one
    128-column tile, so that a run's two halo rows stay a small share."""
    kt = k_tier(min(k, K_TIERS[-1]))
    col_tiles = -(-w // _DW_COLS)
    tiles = n * -(-c // 8) * -(-k // kt) * col_tiles
    chunks = min(-(-h // _DW_MIN_ROWS),
                 max(1, -(-_DW_TARGET_BLOCKS // tiles)))
    rows_per_block = -(-h // chunks)
    return kt, rows_per_block, -(-h // rows_per_block), col_tiles


def _dw_fwd(x, ct):
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
    kt, rows_per_block, row_chunks, col_tiles = _dw_plan(n, h, c, wd, k)
    ws = torch.empty((n * row_chunks * col_tiles, 9, c, k), dtype=x.dtype,
                     device=x.device)
    _build.launch("conv3x3_dw", "pggan_conv3x3_dw", x.data_ptr(),
                  ct.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, h, c, wd, k,
                  kt, rows_per_block, row_chunks, col_tiles)
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
