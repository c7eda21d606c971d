"""Progressive-growing Generator as an ``nn.Module``: the counterpart of
``pggan_tpu/models/generator.py``.

The constructor takes every field of the JAX dataclass, because snapshots
store all of them, plus an explicit ``device`` and ``generator``
(``torch.Generator``) for init. ``forward(z, depth, alpha, fade)`` follows
``Generator.apply``: NCHW ``F.conv2d`` stages at low resolution, then the
NHCW tail on the hand-written kernels from the stage that
``ops/spatial.stage_in_envelope`` admits, and it returns NHWC images as
``apply`` does. Parameters keep the JAX tree's structure
(``block0.{c1,c2,torgb}.{w,b}``, ``blocks.<i>.…``) with OIHW weights.

``pallas_tail`` keeps its name so that snapshots load in both packages;
here it means "the NHCW tail on the hand-written kernels".
``inference_chain`` fuses each tail block's conv pair into the forward-only
chain kernel, for serving. ``compute_dtype='bfloat16'`` is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pggan_tpu_torch.ops import spatial
from pggan_tpu_torch.ops.primitives import (
    conv_init,
    equalized_conv2d,
    equalized_conv2d_up2x,
    f32_scalar,
    nf,
    pixelnorm,
    upsample_nearest_2x,
)

# The constructor fields that define a Generator; a snapshot's config holds
# exactly these (pggan_tpu/checkpoint.py:model_config).
CONFIG_FIELDS = ("dataset_shape", "fmap_base", "fmap_decay", "fmap_max",
                 "latent_size", "normalize_latents", "wscale", "pixelnorm",
                 "leakyrelu", "compute_dtype", "fused_scale", "pallas_tail",
                 "inference_chain")


def _layer(generator, ksize, ch_in, ch_out, wscale, device) -> nn.ParameterDict:
    p = conv_init(generator, ksize, ch_in, ch_out, wscale, device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def _block(generator, ch_in, ch_out, num_channels, first, wscale,
           device) -> nn.ModuleDict:
    """One G stage: two convs and its own toRGB (network.py:44-72)."""
    return nn.ModuleDict({
        "c1": _layer(generator, 4 if first else 3, ch_in, ch_out, wscale,
                     device),
        "c2": _layer(generator, 3, ch_out, ch_out, wscale, device),
        "torgb": _layer(generator, 1, ch_out, num_channels, wscale, device),
    })


class Generator(nn.Module):
    """Latent -> image generator (reference network.py:75-139).

    ``dataset_shape`` is (N, C, H, W): the last dim is the full output
    resolution, dim 1 the channel count.
    """

    def __init__(self, dataset_shape, fmap_base: int = 4096,
                 fmap_decay: float = 1.0, fmap_max: int = 512,
                 latent_size: int | None = 512,
                 normalize_latents: bool = True, wscale: bool = True,
                 pixelnorm: bool = True, leakyrelu: bool = True,
                 compute_dtype: str = "float32", fused_scale: bool = True,
                 pallas_tail: bool = True, inference_chain: bool = False, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if str(compute_dtype) in ("bfloat16", "bf16"):
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported yet; the port serves "
                "float32")
        if str(compute_dtype) != "float32":
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.dataset_shape = tuple(int(d) for d in dataset_shape)
        self.fmap_base, self.fmap_decay, self.fmap_max = (
            fmap_base, fmap_decay, fmap_max)
        self.normalize_latents, self.wscale = normalize_latents, wscale
        self.pixelnorm, self.leakyrelu = pixelnorm, leakyrelu
        self.compute_dtype, self.fused_scale = compute_dtype, fused_scale
        self.pallas_tail, self.inference_chain = pallas_tail, inference_chain
        resolution = self.dataset_shape[-1]
        self.num_channels = self.dataset_shape[1]
        self.R = int(math.log2(resolution))
        assert resolution == 2 ** self.R and resolution >= 4, \
            "resolution must be a power of two >= 4 (network.py:92)"
        self.latent_size = self.nf(0) if latent_size is None else latent_size
        self.max_depth = self.R - 2
        self.eps = 1e-8

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.block0 = _block(generator, self.latent_size, self.nf(1),
                             self.num_channels, True, wscale, device)
        self.blocks = nn.ModuleList(
            _block(generator, self.nf(i - 1), self.nf(i), self.num_channels,
                   False, wscale, device)
            for i in range(2, self.R))

    def nf(self, stage: int) -> int:
        return nf(stage, self.fmap_base, self.fmap_decay, self.fmap_max)

    @property
    def act(self) -> str:
        return "lrelu" if self.leakyrelu else "relu"

    # -- low-resolution NCHW stages -------------------------------------------
    def _conv(self, p, x, *, pad, use_pixelnorm=None, act="default"):
        return equalized_conv2d(
            p, x, padding=pad, wscale=self.wscale,
            act=self.act if act == "default" else act,
            use_pixelnorm=self.pixelnorm if use_pixelnorm is None
            else use_pixelnorm,
            eps=self.eps)

    def _block(self, p, h, first: bool):
        h = self._conv(p["c1"], h, pad=3 if first else 1)
        return self._conv(p["c2"], h, pad=1)

    def _block_up(self, p, h):
        """Growth-stage block with the 2x upsample fused into c1."""
        h = equalized_conv2d_up2x(p["c1"], h, wscale=self.wscale,
                                  act=self.act, use_pixelnorm=self.pixelnorm,
                                  eps=self.eps)
        return self._conv(p["c2"], h, pad=1)

    def _torgb(self, p, h):
        return self._conv(p["torgb"], h, pad=0, use_pixelnorm=False, act=None)

    # -- the NHCW tail -----------------------------------------------------------
    def _pallas_tail_start(self, depth: int):
        """First growth stage of the NHCW tail, or None: the start of the
        longest run of stages, ending at ``depth - 1``, that the envelope
        admits (``pggan_tpu/models/generator.py:154-179``)."""
        if not self.pallas_tail or depth < 1:
            return None
        start = None
        for i in reversed(range(depth)):
            if not spatial.stage_in_envelope(2 ** (i + 3), self.nf(i + 1),
                                             self.nf(i + 2)):
                break
            start = i
        return start

    def _tail_stage(self, v, p):
        v = spatial.upsample_nearest_2x(v)
        if (self.inference_chain and self.act == "lrelu"
                and spatial.chain_pair_supported(v.shape, p["c1"], p["c2"])):
            return spatial.conv3x3_block_pair(
                p["c1"], p["c2"], v, wscale=self.wscale,
                use_pixelnorm=self.pixelnorm, eps=self.eps)
        v = spatial.conv3x3_block(p["c1"], v, wscale=self.wscale,
                                  act=self.act, use_pixelnorm=self.pixelnorm,
                                  eps=self.eps)
        return spatial.conv3x3_block(p["c2"], v, wscale=self.wscale,
                                     act=self.act,
                                     use_pixelnorm=self.pixelnorm,
                                     eps=self.eps)

    def _pallas_tail(self, h_nchw, depth, alpha, fade, start):
        """Growth stages ``start .. depth-1``, toRGB and the fade blend in
        NHCW (``pggan_tpu/models/generator.py:181-227``); NHWC out."""
        def torgb(v, p):
            return spatial.conv1x1(p["torgb"], v, wscale=self.wscale,
                                   act=None, use_pixelnorm=False, eps=self.eps)

        h = h_nchw.permute(0, 2, 1, 3).contiguous()  # -> NHCW
        for i in range(start, depth - 1):
            h = self._tail_stage(h, self.blocks[i])
        if fade:
            # prev-stage toRGB of the pre-final features, then upsample
            prev_p = self.blocks[depth - 2] if depth > 1 else self.block0
            prev_rgb = spatial.upsample_nearest_2x(torgb(h, prev_p))
        ult = torgb(self._tail_stage(h, self.blocks[depth - 1]),
                    self.blocks[depth - 1])
        if fade:
            ult = prev_rgb * (1.0 - alpha) + ult * alpha
        return ult.permute(0, 1, 3, 2)  # NHCW -> NHWC

    def forward(self, z: torch.Tensor, depth: int, alpha,
                fade: bool = True) -> torch.Tensor:
        """Images at ``4 * 2**depth`` px, NHWC float32, from latents
        ``z`` (N, latent_size). ``alpha`` weighs the new stage in the fade
        blend; ``fade=False`` serves the stable graph, which equals the fade
        graph at alpha 1 (reference network.py:118-139)."""
        if not (0 <= depth <= self.max_depth):
            raise ValueError(f"depth {depth} out of range "
                             f"[0, {self.max_depth}]")
        alpha = f32_scalar(alpha, z.device)
        h = z.reshape(z.shape[0], z.shape[-1], 1, 1).to(torch.float32)
        if self.normalize_latents:
            h = pixelnorm(h, self.eps)
        h = self._block(self.block0, h, first=True)
        if depth == 0:
            return self._torgb(self.block0, h).permute(0, 2, 3, 1)
        tail = self._pallas_tail_start(depth)
        if tail is not None:
            for i in range(tail):
                h = (self._block_up(self.blocks[i], h) if self.fused_scale
                     else self._block(self.blocks[i], upsample_nearest_2x(h),
                                      first=False))
            return self._pallas_tail(h, depth, alpha, fade, tail)
        prev_p = self.blocks[depth - 2] if depth > 1 else self.block0
        if self.fused_scale:
            for i in range(depth - 1):
                h = self._block_up(self.blocks[i], h)
            ult = self._torgb(self.blocks[depth - 1],
                              self._block_up(self.blocks[depth - 1], h))
            if fade:
                # toRGB (1x1) commutes with nearest upsample: apply at low
                # res, then upsample (reference order network.py:129-135)
                prev_rgb = upsample_nearest_2x(self._torgb(prev_p, h))
        else:
            for i in range(depth - 1):
                h = self._block(self.blocks[i], upsample_nearest_2x(h),
                                first=False)
            h = upsample_nearest_2x(h)
            ult = self._torgb(self.blocks[depth - 1],
                              self._block(self.blocks[depth - 1], h,
                                          first=False))
            if fade:
                prev_rgb = self._torgb(prev_p, h)
        if fade:
            ult = prev_rgb * (1.0 - alpha) + ult * alpha
        return ult.permute(0, 2, 3, 1)  # NCHW -> NHWC
