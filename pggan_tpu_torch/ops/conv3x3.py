"""Same-padding 3x3 convolution on NHCW tensors with an optional fused
epilogue: the forward half of ``pggan_tpu/ops/pallas_conv.py``.

Three entry points, one CUDA kernel (``csrc/conv3x3.cu``) templated on the
epilogue:

- ``conv3x3(x, w)``: the plain conv (TPU kernel ``conv3x3_small_c``);
- ``conv3x3_act(x, w, b, slope=)``: ``lrelu(conv + b)``
  (``conv3x3_act_small_c`` with ``pn_eps=None``);
- ``conv3x3_act_pn(x, w, b, slope=, eps=)``: ``pixelnorm(lrelu(conv + b))``
  over K, returning ``(o, r)`` with ``r = rsqrt(mean_K(z^2) + eps)`` of
  shape (N, H, W) (``conv3x3_act_small_c`` with ``pn_eps`` set).

x is (N, H, C, W) f32 and w is (3, 3, C, K) HWIO, already scaled by any
equalized-LR constant, as in the JAX package. A CUDA tensor launches the
kernel or raises; a CPU tensor takes the plain PyTorch version in this
module. There is no autograd yet: a tensor that requires grad raises.

The kernel replaces ``pggan_tpu/ops/pallas_conv.py:conv3x3_small_c`` and
``conv3x3_act_small_c``. On the H100 it is bound by f32 FMAs (18 C K FLOPs
per output pixel, no TF32, for parity); a block stages a zero-padded halo
tile of 8 input channels at a time in shared memory and keeps all K
outputs of its pixels in registers, so pixelnorm's mean never leaves a
thread (design notes in the source).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import _build

K_TIERS = (8, 16, 32, 64)
_EPI_NONE, _EPI_ACT, _EPI_ACT_PN = 0, 1, 2


def k_tier(k: int) -> int:
    """The kernels' register tile for ``k`` output channels: the smallest
    of 8, 16, 32, 64 that holds them."""
    for t in K_TIERS:
        if k <= t:
            return t
    raise ValueError(f"the conv kernels take at most {K_TIERS[-1]} output "
                     f"channels, got {k}")


def pad_out_channels(t: torch.Tensor, kt: int) -> torch.Tensor:
    """Zero-pad the last (output-channel) axis of a weight or bias to the
    kernel's tile ``kt``; contiguous either way."""
    k = t.shape[-1]
    if k == kt:
        return t.contiguous()
    out = t.new_zeros(t.shape[:-1] + (kt,))
    out[..., :k] = t
    return out


def supported(x_nhcw_shape, w_shape) -> bool:
    """Can the CUDA kernel take this shape? Any H, W and C; a 3x3 kernel
    over the same C; at most 64 output channels (one register tile)."""
    _n, _h, c, _w = x_nhcw_shape
    kh, kw, wc, k = w_shape
    return (kh, kw) == (3, 3) and wc == c and 1 <= k <= K_TIERS[-1]


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


# -- the kernel wrappers ----------------------------------------------------

def _check(x, w, b=None):
    """What the kernel takes, checked on both routes so that the CPU tests
    hold callers to the same contract."""
    tensors = (x, w) if b is None else (x, w, b)
    _build.forbid_grad(*tensors)
    if x.ndim != 4 or w.ndim != 4 or not supported(x.shape, w.shape):
        raise ValueError(f"conv3x3 kernel cannot take x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"bias {tuple(b.shape)} for {w.shape[3]} channels")
    _build.check_kernel_inputs(*tensors)


def _launch(name, epi, x, w, b, slope, eps):
    n, h, c, wd = x.shape
    k = w.shape[3]
    kt = k_tier(k)
    wp = pad_out_channels(w, kt)
    bp = pad_out_channels(b, kt) if b is not None else None
    y = torch.empty((n, h, k, wd), dtype=x.dtype, device=x.device)
    r = (torch.empty((n, h, wd), dtype=x.dtype, device=x.device)
         if epi == _EPI_ACT_PN else None)
    if y.numel():
        _build.launch(name, "pggan_conv3x3", x.data_ptr(), wp.data_ptr(),
                      None if bp is None else bp.data_ptr(), y.data_ptr(),
                      None if r is None else r.data_ptr(),
                      n, h, c, wd, k, kt, epi, float(slope), float(eps))
    return y, r


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padding 3x3 conv, (N, H, C, W) x (3, 3, C, K) -> (N, H, K, W)."""
    _check(x, w)
    if _build.use_plain(x):
        return conv3x3_plain(x, w)
    return _launch("conv3x3", _EPI_NONE, x, w, None, 0.0, 0.0)[0]


def conv3x3_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                slope: float) -> torch.Tensor:
    """Fused ``leaky_relu(conv3x3(x, w) + b, slope)``."""
    _check(x, w, b)
    if _build.use_plain(x):
        return conv3x3_act_plain(x, w, b, slope=slope)
    return _launch("conv3x3_act", _EPI_ACT, x, w, b, slope, 0.0)[0]


def conv3x3_act_pn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   slope: float, eps: float = 1e-8):
    """Fused ``pixelnorm(leaky_relu(conv3x3(x, w) + b))`` over K; returns
    ``(o, r)`` with ``r = rsqrt(mean_K(z^2) + eps)``, shape (N, H, W)."""
    _check(x, w, b)
    if _build.use_plain(x):
        return conv3x3_act_pn_plain(x, w, b, slope=slope, eps=eps)
    return _launch("conv3x3_act_pn", _EPI_ACT_PN, x, w, b, slope, eps)
