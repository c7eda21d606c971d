"""Progressive-growing Discriminator as an ``nn.Module``: the counterpart of
``pggan_tpu/models/discriminator.py``.

The constructor takes every field of the JAX dataclass, plus an explicit
``device`` and ``generator`` (``torch.Generator``) for init.
``forward(x_nhwc, depth, alpha, fade, stat_groups)`` follows
``Discriminator.apply``: blocks are stored high-res -> low-res, the entry
block for ``depth`` is ``blocks[-(depth + 1)]``, and it returns (N, 1)
scores. From the entry stage on, the stages that ``ops/spatial``'s envelope
admits run NHCW on the hand-written kernels (the "head": 3x3 convs, the
2x2 pool and the fade blend); the rest runs NCHW on ``F.conv2d`` and the
pool kernel. Parameters keep the JAX tree's structure
(``blocks.<i>.{fromrgb,c1,c2}.{w,b}``, ``linear.{w,b}``) with OIHW conv
weights and an (out, in) dense weight.

``pallas_tail`` keeps its name so that configurations carry over; here it
means "the NHCW head on the hand-written kernels". ``compute_dtype=
'bfloat16'`` is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pggan_tpu_torch.ops import spatial
from pggan_tpu_torch.ops.primitives import (
    avg_pool_2x,
    conv_init,
    dense_init,
    equalized_conv2d,
    equalized_conv2d_pool_in,
    equalized_dense,
    f32_scalar,
    minibatch_stddev,
    nf,
)

# The constructor fields of the JAX dataclass (``dtype`` aside).
CONFIG_FIELDS = ("dataset_shape", "fmap_base", "fmap_decay", "fmap_max",
                 "wscale", "pixelnorm", "leakyrelu", "compute_dtype",
                 "fused_scale", "pallas_tail")


def _layer(generator, ksize, ch_in, ch_out, wscale, device) -> nn.ParameterDict:
    p = conv_init(generator, ksize, ch_in, ch_out, wscale, device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


class Discriminator(nn.Module):
    """Image -> Wasserstein score critic (reference network.py:190-240)."""

    def __init__(self, dataset_shape, fmap_base: int = 4096,
                 fmap_decay: float = 1.0, fmap_max: int = 512,
                 wscale: bool = True, pixelnorm: bool = False,
                 leakyrelu: bool = True, compute_dtype: str = "float32",
                 fused_scale: bool = True, pallas_tail: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if str(compute_dtype) in ("bfloat16", "bf16"):
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported yet; the port trains "
                "float32")
        if str(compute_dtype) != "float32":
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.dataset_shape = tuple(int(d) for d in dataset_shape)
        self.fmap_base, self.fmap_decay, self.fmap_max = (
            fmap_base, fmap_decay, fmap_max)
        self.wscale, self.pixelnorm, self.leakyrelu = wscale, pixelnorm, leakyrelu
        self.compute_dtype, self.fused_scale = compute_dtype, fused_scale
        self.pallas_tail = pallas_tail
        resolution = self.dataset_shape[-1]
        self.num_channels = self.dataset_shape[1]
        self.R = int(math.log2(resolution))
        assert resolution == 2 ** self.R and resolution >= 4, \
            "resolution must be a power of two >= 4 (network.py:204)"
        self.max_depth = self.R - 2
        self.eps = 1e-8

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        blocks = []
        for i in range(self.R - 1, 0, -1):
            last = i == 1  # the 4x4 DLastBlock (network.py:214-217)
            blocks.append(nn.ModuleDict({
                "fromrgb": _layer(generator, 1, self.num_channels, self.nf(i),
                                  wscale, device),
                "c1": _layer(generator, 3, self.nf(i) + int(last), self.nf(i),
                             wscale, device),
                "c2": _layer(generator, 4 if last else 3, self.nf(i),
                             self.nf(i - 1), wscale, device),
            }))
        self.blocks = nn.ModuleList(blocks)
        self.linear = nn.ParameterDict({
            k: nn.Parameter(v)
            for k, v in dense_init(generator, self.nf(0), 1, device).items()})

    def nf(self, stage: int) -> int:
        return nf(stage, self.fmap_base, self.fmap_decay, self.fmap_max)

    @property
    def act(self) -> str:
        return "lrelu" if self.leakyrelu else "relu"

    # -- NCHW stages ------------------------------------------------------------
    def _conv(self, p, x, *, pad, use_pixelnorm=None):
        return equalized_conv2d(
            p, x, padding=pad, wscale=self.wscale, act=self.act,
            use_pixelnorm=self.pixelnorm if use_pixelnorm is None
            else use_pixelnorm,
            eps=self.eps)

    def _fromrgb(self, p, x):
        # act, never pixelnorm (reference network.py:145,160)
        return self._conv(p["fromrgb"], x, pad=0, use_pixelnorm=False)

    def _block(self, p, h, is_last: bool, first: bool, stat_groups: int):
        if first:
            h = self._fromrgb(p, h)
        if is_last:
            h = minibatch_stddev(h, groups=stat_groups)  # network.py:168
            h = self._conv(p["c1"], h, pad=1)
            return self._conv(p["c2"], h, pad=0)  # 4x4 valid -> 1x1
        h = self._conv(p["c1"], h, pad=1)
        return self._conv(p["c2"], h, pad=1)

    # -- the NHCW head -------------------------------------------------------------
    def _pallas_span(self, depth: int) -> int:
        """How many leading stages (the entry block and the DBlocks after
        it) run NHCW (``pggan_tpu/models/discriminator.py:131-153``)."""
        if not self.pallas_tail or depth == 0:
            return 0
        if not spatial.stage_in_envelope(4 * 2 ** depth, self.nf(depth + 1),
                                         self.nf(depth)):
            return 0
        span = 1
        for i in range(depth, 1, -1):
            if not spatial.stage_in_envelope(4 * 2 ** (i - 1), self.nf(i),
                                             self.nf(i - 1), entry=False):
                break
            span += 1
        return span

    def _pallas_head(self, x_nhwc, depth, alpha, fade, span):
        """Entry block, fade blend and the next ``span - 1`` DBlocks in
        NHCW, each stage ending in the pool
        (``pggan_tpu/models/discriminator.py:155-193``); NCHW out."""
        blocks, n = self.blocks, len(self.blocks)

        def conv1x1(v, pp):
            return spatial.conv1x1(pp, v, wscale=self.wscale, act=self.act,
                                   use_pixelnorm=False, eps=self.eps)

        def conv3(v, pp):
            return spatial.conv3x3_block(pp, v, wscale=self.wscale,
                                         act=self.act,
                                         use_pixelnorm=self.pixelnorm,
                                         eps=self.eps)

        x = x_nhwc.permute(0, 1, 3, 2).contiguous()  # -> NHCW
        p = blocks[n - (depth + 1)]
        h = conv3(conv3(conv1x1(x, p["fromrgb"]), p["c1"]), p["c2"])
        h = spatial.avg_pool_2x(h)
        if fade:
            prev = conv1x1(spatial.avg_pool_2x(x), blocks[n - depth]["fromrgb"])
            h = h * alpha + (1.0 - alpha) * prev
        for i in range(depth, depth - span + 1, -1):
            p = blocks[n - i]
            h = spatial.avg_pool_2x(conv3(conv3(h, p["c1"]), p["c2"]))
        return h.permute(0, 2, 1, 3).contiguous()  # NHCW -> NCHW

    def forward(self, x: torch.Tensor, depth: int, alpha,
                fade: bool = True, stat_groups: int = 1) -> torch.Tensor:
        """Scores (N, 1) of NHWC images ``x`` at ``4 * 2**depth`` px
        (reference network.py:225-240). ``fade=False`` drops the fromRGB
        blend path. ``stat_groups`` takes the minibatch-stddev statistic
        over that many equal batch slices, so that
        ``D(cat(xs), stat_groups=len(xs)) == cat(D(x) for x in xs)``."""
        if not (0 <= depth <= self.max_depth):
            raise ValueError(f"depth {depth} out of range "
                             f"[0, {self.max_depth}]")
        blocks, n = self.blocks, len(self.blocks)
        x = x.to(torch.float32)
        alpha = f32_scalar(alpha, x.device)
        span = self._pallas_span(depth)
        if span > 0:
            h = self._pallas_head(x, depth, alpha, fade, span)
            start = depth - span + 1
        else:
            # -> NCHW, contiguous: the pool kernel takes nothing else, and
            # F.conv2d would keep a permuted (channels-last) layout
            x = x.permute(0, 3, 1, 2).contiguous()
            h = self._block(blocks[n - (depth + 1)], x, is_last=(depth == 0),
                            first=True, stat_groups=stat_groups)
            if depth > 0:
                h = avg_pool_2x(h)
            if depth > 0 and fade:
                # fade-in blend with the next block's fromRGB of the pooled
                # input (network.py:230-233)
                p = blocks[n - depth]
                if self.fused_scale:
                    prev = equalized_conv2d_pool_in(
                        p["fromrgb"], x, wscale=self.wscale, act=self.act,
                        use_pixelnorm=False, eps=self.eps)
                else:
                    prev = self._fromrgb(p, avg_pool_2x(x))
                h = h * alpha + (1.0 - alpha) * prev
            start = depth
        for i in range(start, 0, -1):
            h = self._block(blocks[n - i], h, is_last=(i == 1), first=False,
                            stat_groups=stat_groups)
            if i > 1:
                h = avg_pool_2x(h)
        return equalized_dense(self.linear, h.reshape(h.shape[0], -1))
