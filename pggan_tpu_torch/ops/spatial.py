"""NHCW building blocks of the generator's high-resolution tail and the
discriminator's high-resolution head: the counterpart of
``pggan_tpu/ops/spatial.py``.

The tail and the head keep (N, H, C, W) end to end. Their 3x3 convs, the
fused conv pair, the 2x upsample and the 2x2 pool run on the hand-written
CUDA kernels for a CUDA tensor (``conv3x3``, ``conv_chain``, ``resample``);
the 1x1 toRGB / fromRGB conv is a plain channel einsum, as in the JAX
package. Everything but the conv pair is differentiable to any order. Semantics follow
``pggan_tpu_torch/ops/primitives.py``: equalized-LR scaling folded into the
weight, bias -> (leaky) ReLU -> optional pixelnorm over the channel axis.

Layers come as ``{"w": OIHW, "b": (K,)}`` mappings; the kernels take HWIO,
so each block permutes its (small) weight before the call.
"""

from __future__ import annotations

import torch

from pggan_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_act, conv3x3_act_pn
from pggan_tpu_torch.ops.conv_chain import chain_supported, conv3x3_chain
from pggan_tpu_torch.ops.primitives import he_constant, leaky_relu
from pggan_tpu_torch.ops.resample import avg_pool_2x as _avg_pool_2x
from pggan_tpu_torch.ops.resample import upsample_2x

# Which stages run NHCW at all: the JAX package's envelope with the same
# values, so that the same stages run kernels in both packages. Widening it
# for the H100 is a decision to make by measurement.
PALLAS_MIN_RES = 128
PALLAS_MAX_CIN = 32
PALLAS_HI_RES = 256
PALLAS_MAX_CIN_HI = 64


def stage_in_envelope(res: int, ch_in: int, ch_out: int,
                      entry: bool = True) -> bool:
    """Does a conv stage at ``res`` px with ``ch_in -> ch_out`` channels
    belong on the NHCW tail? (``pggan_tpu/ops/spatial.py:43-61``.)"""
    lim_entry = PALLAS_MAX_CIN_HI if res >= PALLAS_HI_RES else PALLAS_MAX_CIN
    lim = lim_entry if entry else PALLAS_MAX_CIN_HI
    return (res >= PALLAS_MIN_RES and res % 128 == 0 and ch_in <= lim
            and ch_in % 8 == 0 and ch_out % 8 == 0)


def _act(y: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "lrelu":
        return leaky_relu(y, 0.2)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act is None:
        return y
    raise ValueError(f"unknown act: {act!r}")


def _hwio(p, wscale: bool) -> torch.Tensor:
    """A 3x3 layer's weight as the kernels take it: HWIO, equalized-LR
    scaled."""
    w = p["w"].permute(2, 3, 1, 0)
    if wscale:
        w = w * he_constant(9 * w.shape[2])
    return w.contiguous()


def pixelnorm_c(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pixelwise feature norm over the channel axis (dim 2 in NHCW)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=2, keepdim=True) + eps)


def conv1x1(params, x: torch.Tensor, *, wscale: bool = True,
            act: str | None = "lrelu", use_pixelnorm: bool = False,
            eps: float = 1e-8) -> torch.Tensor:
    """Equalized 1x1 conv as a channel einsum (fromRGB / toRGB)."""
    w = params["w"][:, :, 0, 0]  # (K, C)
    if wscale:
        w = w * he_constant(w.shape[1])
    # einsum may return a permuted layout; the tail's kernels take NHCW
    y = torch.einsum("nhcw,kc->nhkw", x, w).contiguous()
    y = _act(y + params["b"][None, None, :, None], act)
    return pixelnorm_c(y, eps) if use_pixelnorm else y


def conv3x3_block(params, x: torch.Tensor, *, wscale: bool = True,
                  act: str | None = "lrelu", use_pixelnorm: bool = True,
                  eps: float = 1e-8) -> torch.Tensor:
    """Equalized 3x3 conv + bias/act/pixelnorm. With a leaky activation the
    epilogue runs inside the conv kernel; hard ReLU composes it after the
    plain-conv kernel, as the JAX package does."""
    w = _hwio(params, wscale)
    if act == "lrelu":
        if use_pixelnorm:
            return conv3x3_act_pn(x, w, params["b"], slope=0.2, eps=eps)[0]
        return conv3x3_act(x, w, params["b"], slope=0.2)
    y = conv3x3(x, w)
    y = _act(y + params["b"][None, None, :, None], act)
    return pixelnorm_c(y, eps) if use_pixelnorm else y


def conv3x3_block_pair(p1, p2, x: torch.Tensor, *, wscale: bool = True,
                       use_pixelnorm: bool = True,
                       eps: float = 1e-8) -> torch.Tensor:
    """Both equalized 3x3 convs of a G growth block (leaky ReLU, optional
    pixelnorm) as one fused kernel. FORWARD-ONLY: serving path use."""
    return conv3x3_chain(x, _hwio(p1, wscale), p1["b"], _hwio(p2, wscale),
                         p2["b"], slope=0.2,
                         pn_eps=eps if use_pixelnorm else None)


def chain_pair_supported(x_shape, p1, p2) -> bool:
    """Can the chain kernel fuse this block's conv pair?"""
    def hwio_shape(p):
        k, c, kh, kw = p["w"].shape
        return (kh, kw, c, k)
    return chain_supported(tuple(x_shape), hwio_shape(p1), hwio_shape(p2))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, NHCW."""
    return upsample_2x(x, h_axis=1, w_axis=3)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, NHCW."""
    return _avg_pool_2x(x, h_axis=1, w_axis=3)
