"""Forward-only fused conv3x3 -> conv3x3 pair for the serving path: the
counterpart of ``pggan_tpu/ops/pallas_chain.py``.

``conv3x3_chain`` computes ``ep(conv3x3(ep(conv3x3(x, w1) + b1), w2) + b2)``
with ``ep`` = leaky ReLU, then optional pixelnorm over channels. On a CUDA
tensor it launches ``csrc/conv_chain.cu``, whose intermediate activation
stays in shared memory; on a CPU tensor it runs the plain version below.
It has no backward, ever: a tensor that requires grad raises, on any
device, as the JAX chain fails under AD.

The kernel replaces ``pggan_tpu/ops/pallas_chain.py:conv3x3_chain``. Both
convs run on Hopper's warpgroup MMAs (``wgmma``) in the conv kernel's
arithmetic (TF32 with the three-product split, f32 accuracy), fed by TMA;
fusing saves the intermediate's write and read. A block walks a strip of
64 output columns down a run of rows (``chain_rows``): stage 1 computes
the strip's intermediate at 66 columns (its halo included), 64 positions
of the flattened (row, column) walk to an M-tile, and keeps the rows the
next output rows need in shared memory, so each intermediate row is
computed once a run; positions outside the image are written as 0 (the
second conv's padding, not ``ep(conv(0))``); stage 2 computes each output
row once its three intermediate rows are complete. The weights are split
inside the kernel: no workspace. Design notes in the source.
"""

from __future__ import annotations

import functools

import torch

from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops.conv3x3 import (K_TIERS, _SMS, _act_plain,
                                         conv3x3_plain, k_tier, tma_operand)

_STRIP = 64  # output columns of a strip (csrc/conv_chain.cu kTW)
_ROW = _STRIP + 2  # intermediate positions a row (kIW)


def band_positions(kt: int) -> int:
    """Intermediate positions a band computes (``Plan<KT>::BP``): 64 to an
    M-tile, MW = 1, 2, 4, 5 M-tiles a warpgroup at KT = 64, 32, 16, 8."""
    return 2 * {8: 5, 16: 4, 32: 2, 64: 1}[kt] * _STRIP


def bands(rows: int, kt: int) -> int:
    """Bands of a run of ``rows`` output rows: its (rows + 2) x 66
    intermediate positions, a band's at a time."""
    return -(-(rows + 2) * _ROW // band_positions(kt))


@functools.lru_cache(maxsize=None)
def chain_rows(n: int, h: int, w: int, kt: int) -> int:
    """Image rows of a work item (a run down one strip): the run length
    whose rounds of items over the card's SMs times a run's bands is least
    (the longest such), so that the SMs stay busy and a run's two halo rows
    stay a small share."""
    strips = n * -(-w // _STRIP)

    def cost(rows):
        return -(-strips * -(-h // rows) // _SMS) * bands(rows, kt)
    return min(range(h, 0, -1), key=cost)


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
    kt = k_tier(max(k1, k2))
    # TMA's 16-byte strides: a ragged W, K1 or K2 padded with zeros (the
    # kernel masks the image at W; the padded columns are sliced off)
    x, w1, w2 = tma_operand(x), tma_operand(w1), tma_operand(w2)
    wp = x.shape[3]
    y = torch.empty((n, h, k2, wp), dtype=x.dtype, device=x.device)
    if y.numel():
        name = "conv3x3_chain" if pn_eps is None else "conv3x3_chain_pn"
        _build.launch(name, "pggan_conv3x3_chain", x.device,
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), y.data_ptr(), n, h, c,
                      wd, wp, k1, k2, kt, chain_rows(n, h, wd, kt),
                      int(pn_eps is not None), float(slope),
                      float(pn_eps or 0.0))
    return y[..., :wd].contiguous() if wp != wd else y
