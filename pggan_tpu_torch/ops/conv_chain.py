"""Forward-only fused conv3x3 -> conv3x3 pair for the serving path: the
counterpart of ``pggan_tpu/ops/pallas_chain.py``.

``conv3x3_chain`` computes ``ep(conv3x3(ep(conv3x3(x, w1) + b1), w2) + b2)``
with ``ep`` = leaky ReLU, then optional pixelnorm over channels. On a CUDA
tensor it launches ``csrc/conv_chain.cu``, whose intermediate activation
stays in shared memory; on a CPU tensor it runs the plain version below.
It has no backward, ever: a tensor that requires grad raises, on any
device, as the JAX chain fails under AD.

The kernel replaces ``pggan_tpu/ops/pallas_chain.py:conv3x3_chain``. It is
bound by f32 FMAs like the conv; fusing saves the intermediate's write and
read. A block stages the input halo and the intermediate tile in dynamic
shared memory, and zeroes intermediate rows and columns outside the image:
they are the second conv's padding (design notes in the source).
"""

from __future__ import annotations

import torch

from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops.conv3x3 import (
    K_TIERS,
    _act_plain,
    conv3x3_plain,
    k_tier,
    pad_out_channels,
)

# the H100's per-block shared-memory limit, and the kernel's tile sizes
_SMEM_LIMIT = 232448
_TH, _TW = 8, 32


def _smem_bytes(c: int, k1: int) -> int:
    """Dynamic shared memory of one block: the (8+4) x C x (32+4) input halo
    tile plus the (8+2) x K1 x (32+2) intermediate tile, f32."""
    return 4 * ((_TH + 4) * c * (_TW + 4) + (_TH + 2) * k1 * (_TW + 2))


def chain_supported(x_nhcw_shape, w1_shape, w2_shape) -> bool:
    """Can the CUDA chain kernel take this shape pair? 3x3 convs that
    chain, at most 64 channels out of each, and both tiles in one block's
    shared memory (C = 64, K1 = 32 takes 154 KB)."""
    _n, _h, c, _w = x_nhcw_shape
    k1, k2 = w1_shape[3], w2_shape[3]
    return (tuple(w1_shape[:3]) == (3, 3, c)
            and tuple(w2_shape[:3]) == (3, 3, k1)
            and 1 <= k1 <= K_TIERS[-1] and 1 <= k2 <= K_TIERS[-1]
            and _smem_bytes(c, k1) <= _SMEM_LIMIT)


def _ep_plain(z, b, slope, pn_eps):
    z = _act_plain(z, b, slope)
    if pn_eps is not None:
        z = z * torch.rsqrt(torch.mean(z * z, dim=2, keepdim=True) + pn_eps)
    return z


def conv3x3_chain_plain(x, w1, b1, w2, b2, *, slope: float,
                        pn_eps: float | None) -> torch.Tensor:
    """The plain PyTorch version: two convs, each padded with zeros."""
    z = _ep_plain(conv3x3_plain(x, w1), b1, slope, pn_eps)
    return _ep_plain(conv3x3_plain(z, w2), b2, slope, pn_eps)


def conv3x3_chain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, *, slope: float,
                  pn_eps: float | None) -> torch.Tensor:
    """Fused conv pair. x (N, H, C, W) f32, w1 (3, 3, C, K1), w2
    (3, 3, K1, K2) HWIO, already equalized-LR scaled; returns
    (N, H, K2, W). FORWARD-ONLY."""
    _build.forbid_grad(x, w1, b1, w2, b2)
    if (x.ndim != 4 or w1.ndim != 4 or w2.ndim != 4
            or not chain_supported(x.shape, w1.shape, w2.shape)):
        raise ValueError(f"chain kernel cannot take x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    k1, k2 = w1.shape[3], w2.shape[3]
    if tuple(b1.shape) != (k1,) or tuple(b2.shape) != (k2,):
        raise ValueError(f"biases {tuple(b1.shape)}, {tuple(b2.shape)} for "
                         f"{k1}, {k2} channels")
    _build.check_kernel_inputs(x, w1, b1, w2, b2)
    if _build.use_plain(x):
        return conv3x3_chain_plain(x, w1, b1, w2, b2, slope=slope,
                                   pn_eps=pn_eps)
    n, h, c, wd = x.shape
    k1t, k2t = k_tier(k1), k_tier(k2)
    w1p, b1p = pad_out_channels(w1, k1t), pad_out_channels(b1, k1t)
    w2p, b2p = pad_out_channels(w2, k2t), pad_out_channels(b2, k2t)
    y = torch.empty((n, h, k2, wd), dtype=x.dtype, device=x.device)
    if y.numel():
        name = "conv3x3_chain" if pn_eps is None else "conv3x3_chain_pn"
        _build.launch(name, "pggan_conv3x3_chain", x.data_ptr(),
                      w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(),
                      b2p.data_ptr(), y.data_ptr(), n, h, c, wd, k1, k2,
                      k1t, k2t, int(pn_eps is not None), float(slope),
                      float(pn_eps or 0.0))
    return y
