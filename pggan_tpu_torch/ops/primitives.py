"""Core PGGAN math primitives on NCHW tensors: the generator's share of
``pggan_tpu/ops/primitives.py``.

Semantics follow the JAX package (reference network.py:7-41): equalized-LR
convolution with the static He constant ``sqrt(2 / fan_in)`` folded into
the weight at use, bias -> (leaky) ReLU -> optional pixelnorm over the
channel axis. The low-resolution stages run these as ``F.conv2d`` /
``F.conv_transpose2d``: the JAX package ran them as XLA convolutions, never
as Pallas kernels. Weights are stored OIHW (PyTorch's layout);
``pggan_tpu_torch.checkpoint`` converts to and from the JAX package's HWIO.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def nf(stage: int, fmap_base: int = 4096, fmap_decay: float = 1.0,
       fmap_max: int = 512) -> int:
    """Per-stage feature map count (reference network.py:94-95)."""
    return min(int(fmap_base / (2.0 ** (stage * fmap_decay))), fmap_max)


def he_constant(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    """Static equalized-LR constant ``c = gain / sqrt(fan_in)``."""
    return gain / math.sqrt(fan_in)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def pixelnorm(x: torch.Tensor, eps: float = 1e-8, dim: int = 1) -> torch.Tensor:
    """Pixelwise feature vector normalization over the channel ``dim``
    (1 for NCHW; reference network.py:37-40)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + eps)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NCHW (reference
    network.py:127)."""
    from pggan_tpu_torch.ops.resample import upsample_2x
    return upsample_2x(x, h_axis=2, w_axis=3)


def conv_init(generator: torch.Generator, ksize: int, ch_in: int, ch_out: int,
              wscale: bool = True, device=None) -> dict:
    """Initial parameters of an equalized-LR conv layer: ``{"w": OIHW,
    "b": (ch_out,)}``, drawn from ``generator``.

    With ``wscale`` the weight is unit-normal (the He constant is applied at
    use); without it, torch's default Conv2d uniform ``+-1/sqrt(fan_in)``.
    The bias is that uniform in both cases (reference network.py:16-17).
    The distributions match ``pggan_tpu.ops.primitives.conv_init``; the
    random streams do not.
    """
    shape = (ch_out, ch_in, ksize, ksize)
    bound = 1.0 / math.sqrt(ksize * ksize * ch_in)
    if wscale:
        w = torch.randn(shape, generator=generator)
    else:
        w = torch.rand(shape, generator=generator) * (2 * bound) - bound
    b = torch.rand((ch_out,), generator=generator) * (2 * bound) - bound
    return {"w": w.to(device), "b": b.to(device)}


def _epilogue(y, b, act, use_pixelnorm, eps):
    y = y + b[None, :, None, None]
    if act == "lrelu":
        y = leaky_relu(y, 0.2)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act is not None:
        raise ValueError(f"unknown act: {act!r}")
    if use_pixelnorm:
        y = pixelnorm(y, eps)
    return y


def equalized_conv2d(params, x: torch.Tensor, *, padding: int = 1,
                     wscale: bool = True, act: str | None = "lrelu",
                     use_pixelnorm: bool = True,
                     eps: float = 1e-8) -> torch.Tensor:
    """The reference's ``PGConv2d`` forward (network.py:32-41), NCHW:
    conv(x * c) -> activation -> pixelnorm, with ``c`` folded into the
    weight. ``params`` holds ``w`` (OIHW) and ``b``."""
    w = params["w"]
    if wscale:
        w = w * he_constant(w.shape[1] * w.shape[2] * w.shape[3])
    y = F.conv2d(x, w, padding=padding)
    return _epilogue(y, params["b"], act, use_pixelnorm, eps)


def _superpose_up(w3: torch.Tensor) -> torch.Tensor:
    """(K, C, 3, 3) -> (K, C, 4, 4) with K[p, q] = sum_{a, b in {0, 1}}
    w3[p - a, q - b]: a 3x3 conv over a nearest-2x-upsampled input, written
    as one 4x4 kernel over the dilated input."""
    k = w3.new_zeros(w3.shape[:2] + (4, 4))
    for a in (0, 1):
        for b in (0, 1):
            k[:, :, a:a + 3, b:b + 3] += w3
    return k


def equalized_conv2d_up2x(params, x: torch.Tensor, *, wscale: bool = True,
                          act: str | None = "lrelu",
                          use_pixelnorm: bool = True,
                          eps: float = 1e-8) -> torch.Tensor:
    """Fused ``nearest_up2x -> 3x3 equalized conv -> act -> pixelnorm``,
    NCHW in, (N, K, 2H, 2W) out; equal to
    ``equalized_conv2d(upsample_nearest_2x(x))`` up to float reassociation.

    The JAX package convolves the 2x-dilated input, padded by 2, with the
    superposed 4x4 kernel (``lhs_dilation=2``). That is a transposed conv
    of stride 2 and padding 1 with the kernel flipped and in/out swapped,
    which is how ``F.conv_transpose2d`` takes it.
    """
    w = params["w"]
    assert w.shape[2:] == (3, 3), "up-fusion is for 3x3 convs"
    if wscale:
        w = w * he_constant(9 * w.shape[1])
    k = _superpose_up(w).flip(2, 3).transpose(0, 1)  # (C, K, 4, 4)
    y = F.conv_transpose2d(x, k, stride=2, padding=1)
    return _epilogue(y, params["b"], act, use_pixelnorm, eps)
