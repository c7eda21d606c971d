"""2x nearest upsample and 2x2 average pool as two autograd Functions that
are each other's transposes: the counterpart of
``pggan_tpu/ops/resample.py`` and of the TPU kernels
``pggan_tpu/ops/pallas_resample.py:upsample2x_nhcw`` and
``avgpool2x_nhcw``.

Both take any layout whose W axis is last and whose H axis comes before
it. On a CUDA tensor they launch ``csrc/upsample2x.cu`` or
``csrc/avgpool2x.cu``, viewing the tensor as (N', H, C', W) with N' the
product of the axes before H and C' the product of the axes between H and
W: NHCW is used as it is, NCHW as (N*C, H, 1, W). On a CPU tensor they run
the plain versions below. Both kernels are bound by bytes: the upsample
reads each element once and writes it four times, the pool reads four and
writes one, with wide loads and stores on neighbouring addresses. Neither
rounds differently from its plain version: the upsample copies, the pool
sums in the same fixed order.

The backward of each Function calls the other one, as the JAX primitives'
transposes bind each other (``resample.py:106-113``):
``up^T = 4 * pool`` and ``pool^T = 0.25 * up``. Every derivative order
therefore runs one of the two kernels, the gradient penalty's second
derivative included.
"""

from __future__ import annotations

import math

import torch

from pggan_tpu_torch.ops import _build


def upsample2x_plain(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """The plain PyTorch version: repeat each element along both axes."""
    return x.repeat_interleave(2, dim=h_axis).repeat_interleave(2, dim=w_axis)


def avgpool2x_plain(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """The plain PyTorch version, in the kernels' sum order:
    ``0.25 * ((x[2i, 2j] + x[2i+1, 2j]) + (x[2i, 2j+1] + x[2i+1, 2j+1]))``."""
    def half(t, axis, start):
        index = [slice(None)] * t.ndim
        index[axis] = slice(start, None, 2)
        return t[tuple(index)]

    s = half(x, h_axis, 0) + half(x, h_axis, 1)
    return (half(s, w_axis, 0) + half(s, w_axis, 1)) * 0.25


def _view_dims(x: torch.Tensor, h_axis: int, w_axis: int):
    """Check the axes and return them normalised, with the kernels'
    (N', H, C', W) view of ``x``."""
    _build.check_kernel_inputs(x)
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    if w_axis != x.ndim - 1 or h_axis >= w_axis:
        raise ValueError(f"the resample kernels take W as the last axis and "
                         f"H before it; got axes ({h_axis}, {w_axis}) of a "
                         f"{x.ndim}-d tensor")
    shape = x.shape
    view = (math.prod(shape[:h_axis]), shape[h_axis],
            math.prod(shape[h_axis + 1:w_axis]), shape[w_axis])
    return h_axis, w_axis, view


def _scaled(shape, h_axis, w_axis, up: bool):
    out = list(shape)
    for a in (h_axis, w_axis):
        out[a] = out[a] * 2 if up else out[a] // 2
    return out


def _upsample(x, h_axis, w_axis):
    h_axis, w_axis, (n, h, c, w) = _view_dims(x, h_axis, w_axis)
    if _build.use_plain(x):
        return upsample2x_plain(x, h_axis, w_axis)
    y = torch.empty(_scaled(x.shape, h_axis, w_axis, True), dtype=x.dtype,
                    device=x.device)
    if y.numel():
        _build.launch("upsample2x", "pggan_upsample2x", x.data_ptr(),
                      y.data_ptr(), n, h, c, w)
    return y


def _pool(x, h_axis, w_axis):
    h_axis, w_axis, (n, h, c, w) = _view_dims(x, h_axis, w_axis)
    if h % 2 or w % 2:
        raise ValueError(f"the pool takes even H and W, got {tuple(x.shape)}"
                         f" with axes ({h_axis}, {w_axis})")
    if _build.use_plain(x):
        return avgpool2x_plain(x, h_axis, w_axis)
    y = torch.empty(_scaled(x.shape, h_axis, w_axis, False), dtype=x.dtype,
                    device=x.device)
    if y.numel():
        _build.launch("avgpool2x", "pggan_avgpool2x", x.data_ptr(),
                      y.data_ptr(), n, h, c, w)
    return y


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h_axis, w_axis):
        ctx.axes = (h_axis, w_axis)
        return _upsample(x, h_axis, w_axis)

    @staticmethod
    def backward(ctx, g):
        # <g, up(x)> = <4 * pool(g), x>
        return 4.0 * avg_pool_2x(g.contiguous(), *ctx.axes), None, None


class _AvgPool2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h_axis, w_axis):
        ctx.axes = (h_axis, w_axis)
        return _pool(x, h_axis, w_axis)

    @staticmethod
    def backward(ctx, g):
        # <g, pool(x)> = <0.25 * up(g), x>
        return 0.25 * upsample_2x(g.contiguous(), *ctx.axes), None, None


def upsample_2x(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of the two given spatial axes."""
    return _Upsample2x.apply(x, int(h_axis), int(w_axis))


def avg_pool_2x(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """2x2 stride-2 average pool of the two given spatial axes."""
    return _AvgPool2x.apply(x, int(h_axis), int(w_axis))
