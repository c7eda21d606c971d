"""Core PGGAN math primitives on NCHW tensors: the counterpart of
``pggan_tpu/ops/primitives.py``.

Semantics follow the JAX package (reference network.py:7-41): equalized-LR
convolution with the static He constant ``sqrt(2 / fan_in)`` folded into
the weight at use, bias -> (leaky) ReLU -> optional pixelnorm over the
channel axis. The low-resolution stages run these as ``F.conv2d`` /
``F.conv_transpose2d``: the JAX package ran them as XLA convolutions, never
as Pallas kernels. Weights are stored OIHW (PyTorch's layout) and the dense
weight (out, in) as ``F.linear`` takes it; ``pggan_tpu_torch.checkpoint``
converts to and from the JAX package's HWIO and (in, out).

Mixed precision follows the JAX package: with ``compute_dtype`` set
(``torch.bfloat16``), a conv scales its float32 weight (wscale, the 4x4
superposition, the pool-in spread) in float32 first, then casts weight and
input to bf16; the conv emits bf16, and the epilogue adds the bias,
applies the activation and the pixelnorm in float32 and casts back. The
minibatch stddev takes its statistic in float32 and casts its channel to
the input's dtype; under data parallelism it takes it over the global
batch (``parallel/mesh.py``). Parameters and the dense layer stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import wide_conv
from pggan_tpu_torch.parallel.mesh import all_reduce_sum


def nf(stage: int, fmap_base: int = 4096, fmap_decay: float = 1.0,
       fmap_max: int = 512) -> int:
    """Per-stage feature map count (reference network.py:94-95)."""
    return min(int(fmap_base / (2.0 ** (stage * fmap_decay))), fmap_max)


def he_constant(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    """Static equalized-LR constant ``c = gain / sqrt(fan_in)``."""
    return gain / math.sqrt(fan_in)


def f32_scalar(value, device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device``. A tensor passes
    through, so that a CUDA graph reads its value at every replay; a Python
    number is written by a fill on the device, where ``torch.as_tensor``
    would copy it from the host and wait for the card to get there."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def f32_vector(value, device) -> torch.Tensor:
    """``value``, a sequence of numbers, as a float32 vector on ``device``.
    A tensor passes through; on the card a host array is copied from pinned
    memory without a wait (``torch.as_tensor`` would copy it from pageable
    memory and wait for the card to get there)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    host = torch.from_numpy(np.asarray(value, dtype=np.float32))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def pixelnorm(x: torch.Tensor, eps: float = 1e-8, dim: int = 1) -> torch.Tensor:
    """Pixelwise feature vector normalization over the channel ``dim``
    (1 for NCHW; reference network.py:37-40)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + eps)


def minibatch_stddev(x: torch.Tensor, eps: float = 1e-8,
                     groups: int = 1, group=None) -> torch.Tensor:
    """Append one channel (NCHW dim 1) holding the scalar stddev
    ``sqrt(mean((x - mean(x))^2) + eps)`` of the whole activation tensor
    (reference network.py:174-187). ``groups > 1`` takes the statistic over
    each of ``groups`` equal batch slices, exactly as ``groups`` separate
    calls would (``pggan_tpu/ops/primitives.py:62-93``).

    With ``group`` (a ``parallel.Group``) ``x`` is this rank's shard and the
    statistic is the global batch's, as GSPMD makes it under the JAX
    package's mesh: all-reduced sums, first of x and the element count,
    then of the squared deviations from the global mean. The all-reduce's
    backward is an all-reduce again, so the statistic's gradient (and its
    gradient's gradient, for the gradient penalty) sums the upstream
    gradients of every rank. Every rank must call it at the same point."""
    n = x.shape[0]
    if n % groups:
        raise ValueError(f"batch {n} does not split into {groups} groups")
    # the statistic in f32 (or f64, never bf16)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    if group is not None:
        if groups != 1:
            raise ValueError("stat groups under a process group: the merged "
                             "real+fake pass is off under data parallelism")
        # the count in xf's dtype: exact up to 2**24 elements (f32)
        sums = all_reduce_sum(torch.stack([
            xf.sum(), torch.full((), xf.numel(), dtype=xf.dtype,
                                 device=xf.device)]))
        count = sums[1]
        mean = sums[0] / count
        s = torch.sqrt(all_reduce_sum(torch.square(xf - mean).sum()) / count
                       + eps).reshape(1)
    else:
        xg = xf.reshape(groups, -1)
        mean = xg.mean(dim=1, keepdim=True)
        s = torch.sqrt(torch.mean(torch.square(xg - mean), dim=1) + eps)
    tile = s.repeat_interleave(n // s.shape[0]).reshape(n, 1, 1, 1)
    tile = tile.to(x.dtype).expand(n, 1, x.shape[2], x.shape[3])
    return torch.cat([x, tile], dim=1)


def minibatch_stddev_group(x: torch.Tensor, group_size: int = 4,
                           eps: float = 1e-8,
                           stat_groups: int = 1) -> torch.Tensor:
    """StyleGAN's minibatch stddev (NVlabs/stylegan ``networks_stylegan.py``
    minibatch_stddev_layer, one feature): the batch is cut into groups of
    ``group_size``, sample i in group ``i % (N / group_size)``; each
    element's std over its group, ``sqrt(mean((x - mean)^2) + eps)``,
    averaged over C, H and W, is appended as one channel (NCHW dim 1).
    ``stat_groups`` applies it to that many equal batch slices apart, as
    separate calls would."""
    n, c, h, w = x.shape
    if n % stat_groups:
        raise ValueError(f"batch {n} does not split into {stat_groups} "
                         "slices")
    m = n // stat_groups
    g = min(group_size, m)
    if m % g:
        raise ValueError(f"a slice of {m} samples does not split into "
                         f"groups of {g}")
    y = x.reshape(stat_groups, g, m // g, c, h, w)
    y = y - y.mean(dim=1, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=1) + eps).mean(dim=(2, 3, 4))
    tile = y.repeat(1, g).reshape(n, 1, 1, 1).expand(n, 1, h, w)
    return torch.cat([x, tile.to(x.dtype)], dim=1)


# The resample kernels take contiguous tensors. ``F.conv2d`` may return a
# channels-last layout when its input's strides fit both layouts, as a
# one-channel (N, 1, H, W) image's do; ``contiguous`` is free otherwise.

def upsample_nearest_2x(x: torch.Tensor, kernel: bool = True) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NCHW (reference
    network.py:127), on the upsample kernel for a CUDA tensor.
    ``kernel=False`` takes the plain version on every device: the export
    sets it, since a kernel reached through ctypes cannot be traced."""
    from pggan_tpu_torch.ops.resample import upsample_2x, upsample2x_plain
    if not kernel:
        return upsample2x_plain(x, 2, 3)
    return upsample_2x(x.contiguous(), h_axis=2, w_axis=3)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, NCHW (``F.avg_pool2d(h, 2)``, reference
    network.py:229), on the pool kernel for a CUDA tensor."""
    from pggan_tpu_torch.ops.resample import avg_pool_2x as pool
    return pool(x.contiguous(), h_axis=2, w_axis=3)


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


def dense_init(generator: torch.Generator, ch_in: int, ch_out: int,
               device=None) -> dict:
    """torch ``nn.Linear``'s default init, uniform ``+-1/sqrt(ch_in)``
    (reference network.py:219): ``{"w": (ch_out, ch_in), "b": (ch_out,)}``."""
    bound = 1.0 / math.sqrt(ch_in)
    w = torch.rand((ch_out, ch_in), generator=generator) * (2 * bound) - bound
    b = torch.rand((ch_out,), generator=generator) * (2 * bound) - bound
    return {"w": w.to(device), "b": b.to(device)}


def equalized_dense(params, x: torch.Tensor) -> torch.Tensor:
    """The final D layer: a plain linear layer (no equalized-LR scale)."""
    return F.linear(x, params["w"], params["b"])


def _conv_in(compute_dtype, conv, x, w, **kw):
    """``conv(x, w, **kw)``, in float32 (``compute_dtype`` None) or with
    both operands cast to ``compute_dtype`` (after the float32 weight
    scaling): a bf16 conv, which sums in float32 and rounds its output once
    to bf16. On the card that is cuDNN's bf16 conv (held against the CPU
    route call by call in ``chip_smoke.py`` phase 14). On the CPU it is the
    same arithmetic written out: the bf16 operands' values convolved in
    float32, the output rounded to bf16. torch 2.13's CPU bf16 conv has a
    wrong second derivative at some shapes (the weight gradient of its
    input gradient, at batch 8 with 8 or more channels), and the gradient
    penalty takes exactly that."""
    if compute_dtype is None:
        return conv(x, w, **kw)
    x, w = x.to(compute_dtype), w.to(compute_dtype)
    if x.device.type == "cpu":
        return conv(x.float(), w.float(), **kw).to(compute_dtype)
    return conv(x, w, **kw)


def _epilogue(y, b, act, use_pixelnorm, eps, compute_dtype=None):
    """Bias, activation and pixelnorm in float32; the result in
    ``compute_dtype`` when it is set (``_conv_epilogue`` of the JAX
    package)."""
    if compute_dtype is not None:
        y = y.float()
    y = y + b[None, :, None, None]
    if act == "lrelu":
        y = leaky_relu(y, 0.2)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act is not None:
        raise ValueError(f"unknown act: {act!r}")
    if use_pixelnorm:
        y = pixelnorm(y, eps)
    return y if compute_dtype is None else y.to(compute_dtype)


def equalized_conv2d(params, x: torch.Tensor, *, padding: int = 1,
                     wscale: bool = True, act: str | None = "lrelu",
                     use_pixelnorm: bool = True, eps: float = 1e-8,
                     compute_dtype=None, kernels: bool = True) -> torch.Tensor:
    """The reference's ``PGConv2d`` forward (network.py:32-41), NCHW:
    conv(x * c) -> activation -> pixelnorm, with ``c`` folded into the
    weight. ``params`` holds ``w`` (OIHW) and ``b``. A float32 3x3
    padding-1 conv on a CUDA tensor of the wide-channel shapes runs on the
    kernel pair of ``ops/wide_conv.py`` (its ``route``); every other call,
    and every call with ``kernels=False`` (the export), on ``F.conv2d``."""
    y = equalized_conv(params["w"], x, padding=padding, wscale=wscale,
                       compute_dtype=compute_dtype, kernels=kernels)
    return _epilogue(y, params["b"], act, use_pixelnorm, eps, compute_dtype)


def equalized_conv(w: torch.Tensor, x: torch.Tensor, *, padding: int = 1,
                   wscale: bool = True, gain: float = math.sqrt(2.0),
                   compute_dtype=None, kernels: bool = True) -> torch.Tensor:
    """The conv of ``equalized_conv2d`` alone, with no bias or epilogue:
    ``w`` (OIHW) scaled by ``gain / sqrt(fan_in)`` with ``wscale``, on the
    route ``equalized_conv2d`` takes."""
    if wscale:
        w = w * he_constant(w.shape[1] * w.shape[2] * w.shape[3], gain)
    path = wide_conv.route(x.device.type, x.dtype, x.shape, w.shape, padding,
                           compute_dtype, kernels)
    if path == "kernel":
        return wide_conv.wide_conv(x, w.permute(0, 2, 3, 1))
    y = _conv_in(compute_dtype, F.conv2d, x, w, padding=padding)
    if path == "cudnn":
        wide_conv.count_library(x, w, y)
    return y


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
                          use_pixelnorm: bool = True, eps: float = 1e-8,
                          compute_dtype=None) -> torch.Tensor:
    """Fused ``nearest_up2x -> 3x3 equalized conv -> act -> pixelnorm``,
    NCHW in, (N, K, 2H, 2W) out; equal to
    ``equalized_conv2d(upsample_nearest_2x(x))`` up to float reassociation.

    The JAX package convolves the 2x-dilated input, padded by 2, with the
    superposed 4x4 kernel (``lhs_dilation=2``). That is a transposed conv
    of stride 2 and padding 1 with the kernel flipped and in/out swapped,
    which is how ``F.conv_transpose2d`` takes it.
    """
    y = equalized_conv_up2x(params["w"], x, wscale=wscale,
                            compute_dtype=compute_dtype)
    return _epilogue(y, params["b"], act, use_pixelnorm, eps, compute_dtype)


def equalized_conv_up2x(w: torch.Tensor, x: torch.Tensor, *,
                        wscale: bool = True, compute_dtype=None
                        ) -> torch.Tensor:
    """The conv of ``equalized_conv2d_up2x`` alone (no bias or epilogue):
    a 3x3 conv over the nearest-2x-upsampled input as one transposed
    conv."""
    assert w.shape[2:] == (3, 3), "up-fusion is for 3x3 convs"
    if wscale:
        w = w * he_constant(9 * w.shape[1])
    k = _superpose_up(w).flip(2, 3).transpose(0, 1)  # (C, K, 4, 4)
    return _conv_in(compute_dtype, F.conv_transpose2d, x, k, stride=2,
                    padding=1)


def equalized_conv2d_pool_in(params, x: torch.Tensor, *, wscale: bool = True,
                             act: str | None = "lrelu",
                             use_pixelnorm: bool = False, eps: float = 1e-8,
                             compute_dtype=None) -> torch.Tensor:
    """Fused ``2x2 avg-pool -> 1x1 equalized conv``, NCHW: a stride-2 2x2
    conv with the 1x1 weight spread at weight/4, so the pooled input is
    never made (the D fade path ``fromRGB(avg_pool2d(x))``, reference
    network.py:231-232; ``pggan_tpu/ops/primitives.py:274-302``)."""
    w = params["w"]
    assert w.shape[2:] == (1, 1), "pool-in fusion is for 1x1 convs"
    if wscale:
        w = w * he_constant(w.shape[1])
    k = (w * 0.25).expand(-1, -1, 2, 2).contiguous()
    y = _conv_in(compute_dtype, F.conv2d, x, k, stride=2)
    return _epilogue(y, params["b"], act, use_pixelnorm, eps, compute_dtype)
