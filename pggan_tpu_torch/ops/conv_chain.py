"""Forward-only fused conv3x3 -> conv3x3 pair for the serving path: the
counterpart of ``pggan_tpu/ops/pallas_chain.py``.

``conv3x3_chain`` computes ``ep(conv3x3(ep(conv3x3(x, w1) + b1), w2) + b2)``
with ``ep`` = leaky ReLU, then optional pixelnorm over channels. On a CUDA
tensor it launches ``csrc/conv_chain.cu``, whose intermediate activation
stays in shared memory; on a CPU tensor it runs the plain version below.
It has no backward, ever: a tensor that requires grad raises, on any
device, as the JAX chain fails under AD.

The kernel replaces ``pggan_tpu/ops/pallas_chain.py:conv3x3_chain``. Both
convs run on the tensor cores in the conv kernel's arithmetic (TF32
``mma.sync`` with the three-product split, f32 accuracy); fusing saves the
intermediate's write and read. A block computes a ``TH`` x 32 output tile:
stage 1 computes the (TH + 2) x 34 intermediate tile (its halo included)
into shared memory, streaming input channels in chunks of 8, and writes
positions outside the image as 0 (the second conv's padding, not
``ep(conv(0))``); stage 2 computes the output tile from it. The tile plan
is the source's ``Plan`` (design notes there).
"""

from __future__ import annotations

import torch

from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops.conv3x3 import (K_TIERS, _act_plain, conv3x3_plain,
                                         k_tier)

_CC = 8  # the kernel's input channels a stage (csrc/conv_chain.cu kCC)


def _workspace_floats(c: int, k1: int, k2: int) -> int:
    """Scratch for the split weights: (9, C8, K1T + 4) and (9, K18, K2T +
    4) (hi, lo) pairs, C8 and K18 = C and K1 rounded up to 8."""
    c8, k18 = -(-c // _CC) * _CC, -(-k1 // _CC) * _CC
    return 2 * 9 * (c8 * (k_tier(k1) + 4) + k18 * (k_tier(k2) + 4))


def chain_supported(x_nhcw_shape, w1_shape, w2_shape) -> bool:
    """Can the CUDA chain kernel take this shape pair? 3x3 convs that
    chain, at most 64 channels out of each; any H, W and C (input channels
    are streamed in chunks of 8, so shared memory does not grow with C, and
    every plan of the source fits a block)."""
    _n, _h, c, _w = x_nhcw_shape
    k1, k2 = w1_shape[3], w2_shape[3]
    return (tuple(w1_shape[:3]) == (3, 3, c)
            and tuple(w2_shape[:3]) == (3, 3, k1)
            and 1 <= k1 <= K_TIERS[-1] and 1 <= k2 <= K_TIERS[-1])


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
    y = torch.empty((n, h, k2, wd), dtype=x.dtype, device=x.device)
    if y.numel():
        ws = torch.empty(_workspace_floats(c, k1, k2), dtype=x.dtype,
                         device=x.device)
        name = "conv3x3_chain" if pn_eps is None else "conv3x3_chain_pn"
        _build.launch(name, "pggan_conv3x3_chain", x.device,
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                      ws.data_ptr(), n, h, c, wd, k1, k2, k_tier(k1),
                      k_tier(k2),
                      int(pn_eps is not None), float(slope),
                      float(pn_eps or 0.0))
    return y
