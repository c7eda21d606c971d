"""Same-padding 3x3 convolution of the low-resolution NCHW stages on a
hand-written kernel pair for wide channels on small images, as autograd
Functions that can be differentiated to any order. It replaces no TPU
kernel: the JAX package left these convolutions to XLA.

Two Functions, two CUDA kernels (``csrc/wide_conv.cu``):

- ``wide_conv(x, w)``: (N, C, H, W) x (K, 3, 3, C) -> (N, K, H, W), the
  forward kernel; with ``flip_io``'d weights it is also the input gradient;
- ``wide_conv_dw(x, gy)``: the weight gradient, (K, 3, 3, C).

The two transpose into each other, as ``ops/conv3x3.py``'s ``conv3x3`` and
``conv3x3_dw`` do, so the gradient penalty's second derivative stays on the
two kernels. Weights are OHWI, (K, 3, 3, C): each tap's input channels are
contiguous, which is the K-major layout wgmma reads. A CUDA tensor launches
the kernel or raises; a CPU tensor takes the plain PyTorch twin in this
module (the tests hold the twins against ``F.conv2d`` and
``torch.nn.grad.conv2d_weight``).

``route`` says which calls of ``ops/primitives.py:equalized_conv2d`` take
the kernel: a float32 3x3 conv with padding 1 on a CUDA tensor whose
shape passes ``in_shape_rule``; every other call keeps ``F.conv2d``.
``FLOPS`` counts the operations of those calls and of the float32 3x3
padding-1 convs on CUDA tensors that keep ``F.conv2d`` (but the
export's, ``kernels=False``), by route and
pass, where the route is chosen: each call of the Functions as it is
made (on any device: the CPU tests count a model that way), a cuDNN call
at its forward and, through hooks on its autograd nodes, at its first and
second derivatives. A CUDA graph's replays run without a call, so a
capture counts and a replay does not.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops import conv3x3 as _conv3x3

# the H100's SMs: the weight gradient's work items are planned against them
_SMS = 132
# flat pixels a stage and input channels a work item of the weight
# gradient (csrc/wide_conv.cu kDPix, kDCC)
_DW_PIX, _DW_CC = 64, 21
# operations by (route, pass): route "kernel" or "cudnn"; pass "forward",
# "input_grad", "weight_grad", or "second_order" (a cuDNN node's
# derivative: each gradient it computes counts one conv)
FLOPS: collections.Counter = collections.Counter()


def in_shape_rule(h: int, w: int, c: int, k: int) -> bool:
    """Does the kernel pair take a (H, W) image with ``c`` input and ``k``
    output channels? Both a multiple of 64 (the kernels' output tiles, also
    of the input gradient); W 16, 32, 64 or 128 (whole rows of a 128-pixel
    tile); H a multiple of the tile's rows. Set by measurement on an H100
    against cuDNN (PERF.md): the 4-8 px stages stay on cuDNN."""
    return (c >= 64 and k >= 64 and c % 64 == 0 and k % 64 == 0
            and w in (16, 32, 64, 128) and h >= 16 and h % (128 // w) == 0)


def route(device_type: str, dtype, x_shape, w_shape, padding: int,
          compute_dtype=None, kernels: bool = True) -> str | None:
    """The route of an ``equalized_conv2d`` call: "kernel" (the kernel
    pair), "cudnn" (``F.conv2d``, counted) or None (``F.conv2d``, not
    counted: not a float32 3x3 padding-1 conv on a CUDA tensor, or a call
    with ``kernels=False``, which ``torch.export`` traces with symbolic
    shapes)."""
    if (device_type != "cuda" or dtype != torch.float32
            or compute_dtype is not None or tuple(w_shape[2:]) != (3, 3)
            or padding != 1 or not kernels):
        return None
    _n, c, h, w = x_shape
    return "kernel" if in_shape_rule(h, w, c, w_shape[0]) else "cudnn"


def conv_flops(x_shape, k: int) -> int:
    """2 N H W 9 C K: the operations of a 3x3 conv of ``x_shape`` (NCHW)
    to ``k`` channels, and of each of its gradients."""
    n, c, h, w = x_shape
    return 2 * n * h * w * 9 * c * k


def kernel_share() -> float | None:
    """The kernel's share of the counted operations, in %, or None when
    nothing was counted."""
    total = sum(FLOPS.values())
    if not total:
        return None
    kernel = sum(v for (r, _p), v in FLOPS.items() if r == "kernel")
    return 100.0 * kernel / total


def count_library(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> None:
    """Count a cuDNN call: its forward now, its gradients when its autograd
    node runs, and the gradients of those gradients (the gradient
    penalty's) when their node runs."""
    flops = conv_flops(x.shape, w.shape[0])
    FLOPS["cudnn", "forward"] += flops
    node = y.grad_fn
    if node is None:
        return
    seen = set()

    def second(grad_inputs, _grad_outputs):
        FLOPS["cudnn", "second_order"] += flops * sum(
            g is not None for g in grad_inputs)

    def first(grad_inputs, _grad_outputs):
        for g, name in zip(grad_inputs, ("input_grad", "weight_grad")):
            if g is None:
                continue
            FLOPS["cudnn", name] += flops
            nxt = g.grad_fn
            if nxt is not None and id(nxt) not in seen:
                seen.add(id(nxt))
                nxt.register_hook(second)

    node.register_hook(first)


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """Spatially flipped, in/out-swapped OHWI weights: ``wide_conv(gy,
    flip_io(w))`` is the input gradient of ``wide_conv(x, w)``."""
    return w.flip(1, 2).permute(3, 1, 2, 0)


def pack(w: torch.Tensor) -> torch.Tensor:
    """OHWI weights as the forward kernel loads them: per 64 output and 8
    input channels, one contiguous run of the 9 taps' wgmma B operands,
    each tap core matrices of 8 output x 4 input channels, the two input
    halves inner: (K / 64, C / 8, 9, 8, 2, 8, 4)."""
    k, _u, _v, c = w.shape
    return (w.reshape(k // 64, 8, 8, 9, c // 8, 2, 4)
            .permute(0, 4, 3, 1, 5, 2, 6).contiguous())


# -- plain PyTorch versions (the CPU route and the kernels' references) -----

def wide_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward as the kernel computes it: a sum over the 9 taps of the
    shifted, zero-padded input contracted with the tap's weights."""
    n, _c, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    y = x.new_zeros((n, w.shape[0], h, wd))
    for u in range(3):
        for v in range(3):
            y = y + torch.einsum("nchw,kc->nkhw",
                                 xp[:, :, u:u + h, v:v + wd], w[:, u, v, :])
    return y


def wide_conv_dw_plain(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The weight gradient as the kernel computes it: for each tap, the
    output gradient contracted with the shifted, zero-padded input over
    the batch and the pixels."""
    _n, _c, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    taps = [torch.einsum("nkhw,nchw->kc", gy, xp[:, :, u:u + h, v:v + wd])
            for u in range(3) for v in range(3)]
    return torch.stack(taps, dim=1).reshape(gy.shape[1], 3, 3, x.shape[1])


# -- the kernel routes --------------------------------------------------------

def _check(x, w):
    if (x.ndim != 4 or w.ndim != 4 or tuple(w.shape[1:3]) != (3, 3)
            or w.shape[3] != x.shape[1]
            or not in_shape_rule(x.shape[2], x.shape[3], x.shape[1],
                                 w.shape[0])):
        raise ValueError(f"wide_conv kernel cannot take x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def _fwd(x, w, tag):
    _check(x, w)
    x, w = _conv3x3.tma_operand(x.contiguous()), w.contiguous()
    _build.check_kernel_inputs(x, w)
    FLOPS["kernel", tag] += conv_flops(x.shape, w.shape[0])
    if _build.use_plain(x):
        return wide_conv_plain(x, w)
    n, c, h, wd = x.shape
    k = w.shape[0]
    wp = pack(w)
    y = torch.empty((n, k, h, wd), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch("wide_conv", "pggan_wide_conv", x.device, x.data_ptr(),
                      wp.data_ptr(), y.data_ptr(), n, c, h, wd, k)
    return y


@functools.lru_cache(maxsize=None)
def dw_slice(n: int, h: int, w: int, c: int, k: int) -> int:
    """Stages (64 flat pixels) a pixel slice of the weight gradient: the
    least rounds of work items over the card's SMs times the stages a
    warpgroup walks in one (half the slice, and one for the item's start
    and its partial), the longer slice on a tie (fewer partials)."""
    total = n * h * w // _DW_PIX
    chunks = -(-c // _DW_CC) * (k // 64)

    def cost(length):
        items = chunks * -(-total // length)
        return -(-items // _SMS) * (-(-length // 2) + 1), -length
    return min(range(1, total + 1), key=cost)


def _dw(x, gy):
    if (x.ndim != 4 or gy.ndim != 4 or gy.shape[0] != x.shape[0]
            or tuple(gy.shape[2:]) != tuple(x.shape[2:])
            or not in_shape_rule(x.shape[2], x.shape[3], x.shape[1],
                                 gy.shape[1])):
        raise ValueError(f"wide_conv_dw kernel cannot take x "
                         f"{tuple(x.shape)}, gy {tuple(gy.shape)}")
    x = _conv3x3.tma_operand(x.contiguous())
    gy = _conv3x3.tma_operand(gy.contiguous())
    _build.check_kernel_inputs(x, gy)
    FLOPS["kernel", "weight_grad"] += conv_flops(x.shape, gy.shape[1])
    if _build.use_plain(x):
        return wide_conv_dw_plain(x, gy)
    n, c, h, wd = x.shape
    k = gy.shape[1]
    dw = torch.empty((k, 3, 3, c), dtype=x.dtype, device=x.device)
    if not x.numel():
        return dw.zero_()
    length = dw_slice(n, h, wd, c, k)
    slices = -(-(n * h * wd // _DW_PIX) // length)
    # a partial for each of the kernel's two warpgroups a pixel slice
    ws = torch.empty((2 * slices, k, 9, c), dtype=x.dtype, device=x.device)
    _build.launch("wide_conv_dw", "pggan_wide_conv_dw", x.device,
                  x.data_ptr(), gy.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                  n, c, h, wd, k, length)
    return dw


# -- autograd -----------------------------------------------------------------

class _WideConv(torch.autograd.Function):
    # tag: the pass that ``FLOPS`` counts the call under
    # A None cotangent (an output no loss reaches, such as a forward
    # activation after the minibatch stddev in the gradient penalty's second
    # derivative) runs nothing, as cuDNN's node does for an undefined one.
    @staticmethod
    def forward(ctx, x, w, tag):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w)
        return _fwd(x, w, tag)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        gx = _WideConv.apply(g, flip_io(w), "input_grad") if need[0] else None
        # inside input_grad_only() (the gradient penalty's inner grad) no
        # weight gradient: nothing would read it
        gw = (_WideConvDw.apply(x, g)
              if need[1] and not _conv3x3._INPUT_GRAD_ONLY else None)
        return gx, gw, None


class _WideConvDw(torch.autograd.Function):
    # bilinear in (x, gy); its transposes are convs of the other operand
    # with the weight cotangent cw
    @staticmethod
    def forward(ctx, x, gy):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gy)
        return _dw(x, gy)

    @staticmethod
    def backward(ctx, cw):
        if cw is None:
            return None, None
        x, gy = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx = (_WideConv.apply(gy, flip_io(cw), "input_grad") if need[0]
              else None)
        ggy = _WideConv.apply(x, cw, "forward") if need[1] else None
        return gx, ggy


def wide_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padding 3x3 conv, (N, C, H, W) x (K, 3, 3, C) -> (N, K, H, W)."""
    return _WideConv.apply(x, w, "forward")


def wide_conv_dw(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the 3x3 conv: (N, C, H, W) x (N, K, H, W) ->
    (K, 3, 3, C)."""
    return _WideConvDw.apply(x, gy)
