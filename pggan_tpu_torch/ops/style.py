"""StyleGAN's synthesis-layer epilogue (AdaIN) and its [1, 2, 1] blur as
autograd Functions on the hand-written kernels of ``csrc/style.cu``. No
TPU kernel is replaced: the JAX package has no StyleGAN.

``adain(x, noise, strength, bias, style)`` is the epilogue of one
synthesis layer (NVlabs/stylegan ``networks_stylegan.py`` layer_epilogue):
per sample n and channel c, ``x + strength[c] * noise[n]`` plus ``bias[c]``,
leaky ReLU 0.2, instance norm over H x W (``x - mean``, times
``rsqrt(mean(x^2) + 1e-8)``), then ``x * (s + 1) + b`` with ``[s, b] =
style[n, :C], style[n, C:]``. Its backward gives the gradients of x,
strength, bias and style (noise is a random input, with none). G is never
inside the gradient penalty's double backward, so the backward is
first-order only: differentiating it again raises.

``blur(x)`` is the depthwise ``[1, 2, 1]^T [1, 2, 1] / 16`` with a zero
border of one. The kernel is symmetric, so the blur is its own transpose:
its backward is a blur again, differentiable to any order (D's blur sits
inside the gradient penalty).

Both take ``layout`` "nchw" (the NCHW stages) or "nhcw" (the NHCW tail:
(N, H, C, W)); noise is (N, 1, H, W), or any tensor of N H W elements in
that order. A CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain twin in this module, in float32 or float64 (``gradcheck``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from pggan_tpu_torch.ops import _build

SLOPE, EPS = 0.2, 1e-8
# blocks the card should get for one plane set (the H100 has 132 SMs), and
# the fewest elements a chunk of a plane should hold
_TARGET_BLOCKS, _MIN_CHUNK = 132 * 8, 4096


def _dims(x: torch.Tensor, layout: str) -> tuple:
    """(N, C, H, W) and the element strides (sN, sC, sH) of a contiguous
    tensor in ``layout``."""
    if layout == "nchw":
        n, c, h, w = x.shape
        return (n, c, h, w), (c * h * w, h * w, w)
    if layout == "nhcw":
        n, h, c, w = x.shape
        return (n, c, h, w), (h * c * w, w, c * w)
    raise ValueError(f"unknown layout {layout!r}")


def _to_nchw(x: torch.Tensor, layout: str) -> torch.Tensor:
    return x if layout == "nchw" else x.permute(0, 2, 1, 3)


def _from_nchw(x: torch.Tensor, layout: str) -> torch.Tensor:
    return (x if layout == "nchw" else x.permute(0, 2, 1, 3)).contiguous()


def splits(planes: int, h: int, w: int) -> int:
    """Chunks of whole rows each (n, c) plane is cut into: enough blocks
    for the card, each chunk at least ``_MIN_CHUNK`` elements."""
    want = -(-_TARGET_BLOCKS // planes)
    return max(1, min(h, want, (h * w) // _MIN_CHUNK))


# -- plain twins ------------------------------------------------------------

def _parts(x, noise, strength, bias, layout):
    """x in NCHW view, the pre-activation y0 and the activation a."""
    xc = _to_nchw(x, layout)
    n, c, h, w = xc.shape
    y0 = (xc + strength.view(1, c, 1, 1) * noise.reshape(n, 1, h, w)
          + bias.view(1, c, 1, 1))
    return xc, y0, torch.where(y0 >= 0, y0, y0 * SLOPE)


def adain_plain(x, noise, strength, bias, style, layout="nchw"):
    """The epilogue in plain torch: instance norm with a two-pass
    variance."""
    _xc, _y0, a = _parts(x, noise, strength, bias, layout)
    c = a.shape[1]
    centred = a - a.mean(dim=(2, 3), keepdim=True)
    xh = centred * torch.rsqrt(centred.square().mean(dim=(2, 3), keepdim=True)
                               + EPS)
    out = xh * (style[:, :c, None, None] + 1.0) + style[:, c:, None, None]
    return _from_nchw(out, layout)


def adain_backward_plain(x, noise, strength, bias, style, g, layout="nchw"):
    """(dx, d strength, d bias, d style) of ``adain_plain``, written out as
    the kernel computes them."""
    _xc, y0, a = _parts(x, noise, strength, bias, layout)
    gc = _to_nchw(g, layout)
    n, c, h, w = a.shape
    m = h * w
    centred = a - a.mean(dim=(2, 3), keepdim=True)
    r = torch.rsqrt(centred.square().mean(dim=(2, 3), keepdim=True) + EPS)
    xh = centred * r
    sg = gc.sum(dim=(2, 3))
    sgx = (gc * xh).sum(dim=(2, 3))
    scale = style[:, :c, None, None] + 1.0
    d = (r * scale) * ((gc - (sg / m)[..., None, None])
                       - xh * (sgx / m)[..., None, None])
    d = d * torch.where(y0 >= 0, 1.0, SLOPE).to(d.dtype)
    nz = noise.reshape(n, 1, h, w)
    return (_from_nchw(d, layout), (d * nz).sum(dim=(0, 2, 3)),
            d.sum(dim=(0, 2, 3)), torch.cat([sgx, sg], dim=1))


def blur_plain(x, layout="nchw"):
    """The blur in plain torch, in the kernel's sum order: along W
    ``(x[w - 1] + 2 x[w]) + x[w + 1]``, then the same along H, times
    1/16."""
    h_axis = 2 if layout == "nchw" else 1
    if layout not in ("nchw", "nhcw"):
        raise ValueError(f"unknown layout {layout!r}")

    def along(t, axis):
        pad = [0, 0] * (t.ndim - 1 - axis) + [1, 1]
        p = torch.nn.functional.pad(t, pad)
        size = t.shape[axis]
        return ((p.narrow(axis, 0, size) + 2.0 * p.narrow(axis, 1, size))
                + p.narrow(axis, 2, size))

    return along(along(x, 3), h_axis) * 0.0625


# -- the kernel routes ------------------------------------------------------

def _check(x, layout, *others):
    if x.ndim != 4:
        raise ValueError(f"a 4-d tensor, got {tuple(x.shape)}")
    _build.check_kernel_inputs(x, *others)
    return _dims(x, layout)


def _adain_fwd(x, noise, strength, bias, style, layout):
    (n, c, h, w), strides = _check(x, layout, noise, strength, bias, style)
    if (noise.numel() != n * h * w or tuple(strength.shape) != (c,)
            or tuple(bias.shape) != (c,) or tuple(style.shape) != (n, 2 * c)):
        raise ValueError(f"adain: x {tuple(x.shape)} ({layout}), noise "
                         f"{tuple(noise.shape)}, strength "
                         f"{tuple(strength.shape)}, bias {tuple(bias.shape)},"
                         f" style {tuple(style.shape)}")
    if _build.use_plain(x):
        return adain_plain(x, noise, strength, bias, style, layout), None
    s = splits(n * c, h, w)
    y = torch.empty_like(x)
    stats = torch.empty((n * c, 2), dtype=x.dtype, device=x.device)
    part = torch.empty((n * c * s, 2), dtype=x.dtype, device=x.device)
    _build.launch("style_adain", "pggan_style_adain", x.device,
                  x.data_ptr(), noise.data_ptr(), strength.data_ptr(),
                  bias.data_ptr(), style.data_ptr(), y.data_ptr(),
                  stats.data_ptr(), part.data_ptr(), n, c, h, w, *strides,
                  s, SLOPE, EPS)
    return y, stats


def _adain_bwd(x, noise, strength, bias, style, stats, g, layout):
    g = g.contiguous()
    (n, c, h, w), strides = _check(x, layout, g)
    if _build.use_plain(x):
        return adain_backward_plain(x, noise, strength, bias, style, g,
                                    layout)
    s = splits(n * c, h, w)
    dx = torch.empty_like(x)
    dstyle = torch.empty((n, 2 * c), dtype=x.dtype, device=x.device)
    dsb = torch.empty((n, c, s, 2), dtype=x.dtype, device=x.device)
    part = torch.empty((n * c * s, 2), dtype=x.dtype, device=x.device)
    _build.launch("style_adain_bwd", "pggan_style_adain_bwd", x.device,
                  x.data_ptr(), noise.data_ptr(), strength.data_ptr(),
                  bias.data_ptr(), style.data_ptr(), stats.data_ptr(),
                  g.data_ptr(), dx.data_ptr(), dstyle.data_ptr(),
                  dsb.data_ptr(), part.data_ptr(), n, c, h, w, *strides, s,
                  SLOPE)
    sums = dsb.sum(dim=(0, 2))
    return dx, sums[:, 0], sums[:, 1], dstyle


class _AdaIN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, noise, strength, bias, style, layout):
        y, stats = _adain_fwd(x, noise, strength, bias, style, layout)
        ctx.layout = layout
        ctx.save_for_backward(x, noise, strength, bias, style, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, noise, strength, bias, style, stats = ctx.saved_tensors
        dx, dst, db, dstyle = _adain_bwd(x, noise, strength, bias, style,
                                         stats, g, ctx.layout)
        return dx, None, dst, db, dstyle, None


def adain(x: torch.Tensor, noise: torch.Tensor, strength: torch.Tensor,
          bias: torch.Tensor, style: torch.Tensor,
          layout: str = "nchw") -> torch.Tensor:
    """One synthesis layer's epilogue (module docstring)."""
    noise = noise.reshape(-1).contiguous()
    return _AdaIN.apply(x.contiguous(), noise, strength.contiguous(),
                        bias.contiguous(), style.contiguous(), layout)


def _blur(x, layout):
    (n, c, h, w), strides = _check(x, layout)
    if _build.use_plain(x):
        return blur_plain(x, layout)
    y = torch.empty_like(x)
    if y.numel():
        _build.launch("style_blur", "pggan_style_blur", x.device,
                      x.data_ptr(), y.data_ptr(), n, c, h, w, *strides)
    return y


class _Blur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return _blur(x, layout)

    @staticmethod
    def backward(ctx, g):
        return blur(g, ctx.layout), None


def blur(x: torch.Tensor, layout: str = "nchw") -> torch.Tensor:
    """StyleGAN's [1, 2, 1] blur of each channel (module docstring)."""
    return _Blur.apply(x.contiguous(), layout)
