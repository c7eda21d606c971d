"""2x nearest upsample: the serving half of ``pggan_tpu/ops/resample.py``
and the counterpart of the TPU kernel
``pggan_tpu/ops/pallas_resample.py:upsample2x_nhcw``.

``upsample_2x`` takes any layout whose W axis is last and whose H axis
comes before it. On a CUDA tensor it launches ``csrc/upsample2x.cu``,
viewing the tensor as (N', H, C', W) with N' the product of the axes before
H and C' the product of the axes between H and W: NHCW is used as it is,
NCHW as (N*C, H, 1, W). On a CPU tensor it runs the plain version. The
kernel is bound by bytes (one read, four writes of each element, nothing
computed): 8-byte loads and 16-byte stores, neighbouring threads on
neighbouring addresses. The average pool comes with the training port.
"""

from __future__ import annotations

import math

import torch

from pggan_tpu_torch.ops import _build


def upsample2x_plain(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """The plain PyTorch version: repeat each element along both axes."""
    return x.repeat_interleave(2, dim=h_axis).repeat_interleave(2, dim=w_axis)


def upsample_2x(x: torch.Tensor, h_axis: int, w_axis: int) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of the two given spatial axes."""
    _build.forbid_grad(x)
    _build.check_kernel_inputs(x)
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    if w_axis != x.ndim - 1 or h_axis >= w_axis:
        raise ValueError(f"the upsample kernel takes W as the last axis and "
                         f"H before it; got axes ({h_axis}, {w_axis}) of a "
                         f"{x.ndim}-d tensor")
    if _build.use_plain(x):
        return upsample2x_plain(x, h_axis, w_axis)
    shape = list(x.shape)
    n = math.prod(shape[:h_axis])
    h, c, w = shape[h_axis], math.prod(shape[h_axis + 1:w_axis]), shape[w_axis]
    out_shape = list(shape)
    out_shape[h_axis], out_shape[w_axis] = 2 * h, 2 * w
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch("upsample2x", "pggan_upsample2x", x.data_ptr(),
                      y.data_ptr(), n, h, c, w)
    return y
