"""StyleGAN's generator (Karras, Laine, Aila, arXiv:1812.04948; NVlabs/
stylegan ``training/networks_stylegan.py``, ``G_style``, ``G_mapping`` and
``G_synthesis``) as an ``nn.Module`` with the port's generator call
``G(z, depth, alpha, fade)``, so that the trainer, the plugins and
sampling take it as they take ``Generator``.

- Mapping: z -> pixelnorm -> ``mapping_layers`` x [dense ``w_dim``, leaky
  ReLU 0.2], each weight equalized with ``sqrt(2) / sqrt(fan_in) *
  mapping_lrmul`` and its bias scaled by ``mapping_lrmul``. w goes to every
  synthesis layer.
- Synthesis: a learned constant (1, nf(1), 4, 4), then two layers a
  resolution. A layer is a 3x3 conv with no bias (the first of a block
  runs on the 2x nearest upsample and is followed by the [1, 2, 1] blur;
  layer 0 is the constant itself) and the epilogue ``ops/style.py``
  ``adain``: noise times a per-channel strength, bias, leaky ReLU, instance
  norm, then ``x * (s + 1) + b`` with ``[s, b]`` a dense map (gain 1) of
  the layer's w. toRGB is a 1x1 conv of gain 1 with a bias; the fade is
  the port's, the previous stage's toRGB upsampled and blended by alpha.
- ``w_avg``, a buffer, tracks the average w: each training forward first
  sets ``w_avg = mean_n(w) + w_avg_beta * (w_avg - mean_n(w))``.
- A training forward takes ``draws`` (``draw``): the second latents z2,
  a coin and a cutoff, and one noise image a layer. With probability
  ``style_mixing_prob`` the layers from the cutoff, drawn from 1 ..
  cur_layers - 1, take w2 = mapping(z2), where cur_layers = 2 (depth + 1).
  A forward without ``draws`` serves: layers below ``truncation_cutoff``
  take ``w_avg + psi (w - w_avg)`` (``truncation_psi``, or the call's own
  psi; 1 turns it off), and the noise is drawn fresh from the device's
  default generator.

Stages run NCHW (the 3x3 convs on the wide-conv route of
``ops/primitives.py``, the up-convs as one transposed conv, the published
"fused" up-conv being the same function as upsample then conv) up to the
NHCW tail that ``ops/spatial.stage_in_envelope`` admits, where the
upsample and the convs run on the hand-written kernels; the epilogue and
the blur run on ``csrc/style.cu`` in both layouts. Float32 only.
Parameter names: ``mapping.<i>.{w,b}``, ``const``,
``layers.<i>.{noise_strength,bias,style_w,style_b}``, ``convs.<i>.w``
(conv i feeds layer i + 1), ``torgb.<r>.{w,b}`` (r from 4 px up).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pggan_tpu_torch.ops import spatial, style
from pggan_tpu_torch.ops.conv3x3 import conv3x3
from pggan_tpu_torch.ops.primitives import (
    equalized_conv,
    equalized_conv_up2x,
    f32_scalar,
    he_constant,
    leaky_relu,
    nf,
    pixelnorm,
    upsample_nearest_2x,
)

# The constructor fields that define a StyleGenerator; its snapshot's
# config holds exactly these.
CONFIG_FIELDS = ("dataset_shape", "fmap_base", "fmap_decay", "fmap_max",
                 "latent_size", "w_dim", "mapping_layers", "mapping_lrmul",
                 "w_avg_beta", "style_mixing_prob", "truncation_psi",
                 "truncation_cutoff")


def _params(**tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class StyleGenerator(nn.Module):
    """Latent -> image generator of StyleGAN (module docstring).
    ``dataset_shape`` is (N, C, H, W)."""

    def __init__(self, dataset_shape, fmap_base: int = 8192,
                 fmap_decay: float = 1.0, fmap_max: int = 512,
                 latent_size: int = 512, w_dim: int = 512,
                 mapping_layers: int = 8, mapping_lrmul: float = 0.01,
                 w_avg_beta: float = 0.995, style_mixing_prob: float = 0.9,
                 truncation_psi: float = 0.7, truncation_cutoff: int = 8, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dataset_shape = tuple(int(d) for d in dataset_shape)
        self.fmap_base, self.fmap_decay, self.fmap_max = (
            fmap_base, fmap_decay, fmap_max)
        self.latent_size, self.w_dim = int(latent_size), int(w_dim)
        self.mapping_layers = int(mapping_layers)
        self.mapping_lrmul, self.w_avg_beta = mapping_lrmul, w_avg_beta
        self.style_mixing_prob = style_mixing_prob
        self.truncation_psi = truncation_psi
        self.truncation_cutoff = int(truncation_cutoff)
        # the serving CLI sets it on every G; StyleGAN's conv pairs have an
        # epilogue between them that the chain kernel does not compute, so
        # it changes nothing here (the train step refuses a G with it set)
        self.inference_chain = False
        resolution = self.dataset_shape[-1]
        self.num_channels = self.dataset_shape[1]
        self.R = int(math.log2(resolution))
        assert resolution == 2 ** self.R and resolution >= 4, \
            "resolution must be a power of two >= 4"
        self.max_depth = self.R - 2
        self.num_layers = 2 * (self.max_depth + 1)
        self.eps = 1e-8

        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def normal(*shape, std=1.0):
            return (torch.randn(shape, generator=gen) * std).to(device)

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        dims = [self.latent_size] + [self.w_dim] * self.mapping_layers
        self.mapping = nn.ModuleList(
            _params(w=normal(dims[i + 1], dims[i], std=1.0 / mapping_lrmul),
                    b=zeros(dims[i + 1]))
            for i in range(self.mapping_layers))
        self.const = nn.Parameter(torch.ones((1, self.nf(1), 4, 4),
                                             device=device))
        chans = [self.layer_channels(i) for i in range(self.num_layers)]
        self.layers = nn.ModuleList(
            _params(noise_strength=zeros(c), bias=zeros(c),
                    style_w=normal(2 * c, self.w_dim), style_b=zeros(2 * c))
            for c in chans)
        self.convs = nn.ModuleList(
            _params(w=normal(chans[i], chans[i - 1], 3, 3))
            for i in range(1, self.num_layers))
        self.torgb = nn.ModuleList(
            _params(w=normal(self.num_channels, self.nf(r + 1), 1, 1),
                    b=zeros(self.num_channels))
            for r in range(self.max_depth + 1))
        self.register_buffer("w_avg", torch.zeros(self.w_dim, device=device))

    def nf(self, stage: int) -> int:
        return nf(stage, self.fmap_base, self.fmap_decay, self.fmap_max)

    def layer_channels(self, i: int) -> int:
        """Channels of synthesis layer ``i``: two layers a resolution."""
        return self.nf(i // 2 + 1)

    # -- mapping and styles ------------------------------------------------------
    def mapping_fn(self, z: torch.Tensor) -> torch.Tensor:
        """z (N, latent_size) -> w (N, w_dim)."""
        x = pixelnorm(z.to(self.const.dtype), self.eps)
        for p in self.mapping:
            coef = he_constant(p["w"].shape[1]) * self.mapping_lrmul
            x = leaky_relu(F.linear(x, p["w"] * coef,
                                    p["b"] * self.mapping_lrmul), 0.2)
        return x

    def draw(self, noise, batch: int, depth: int) -> dict:
        """A training forward's random draws from ``noise(kind, shape)``
        (the step's callback), in the step's order: z2, the mixing coin,
        the cutoff, then one noise image a layer from layer 0 up."""
        out = {"z2": noise("normal", (batch, self.latent_size)),
               "coin": noise("uniform", ()),
               "cutoff": noise("uniform", ())}
        out["noise"] = [noise("normal", (batch, 1, 4 * 2 ** (i // 2),
                                         4 * 2 ** (i // 2)))
                        for i in range(2 * (depth + 1))]
        return out

    def _styles(self, z, depth, draws, psi):
        """Each used layer's w, (layers, N, w_dim)."""
        layers = 2 * (depth + 1)
        w = self.mapping_fn(z)
        index = torch.arange(layers, device=z.device).view(-1, 1, 1)
        if draws is not None:  # training: the average, then mixing
            with torch.no_grad():
                mean = w.detach().mean(dim=0)
                self.w_avg.copy_(mean + self.w_avg_beta * (self.w_avg - mean))
            w2 = self.mapping_fn(draws["z2"])
            cut = 1.0 + torch.floor(draws["cutoff"] * (layers - 1))
            cut = torch.where(draws["coin"] < self.style_mixing_prob, cut,
                              torch.full_like(cut, float(layers)))
            return torch.where(index < cut, w[None], w2[None])
        ws = w[None].expand(layers, -1, -1)
        psi = self.truncation_psi if psi is None else psi
        if psi == 1:
            return ws
        coefs = torch.where(index < self.truncation_cutoff,
                            torch.full((), float(psi), dtype=w.dtype,
                                       device=z.device),
                            torch.ones((), dtype=w.dtype, device=z.device))
        return self.w_avg + coefs * (ws - self.w_avg)

    # -- synthesis ---------------------------------------------------------------
    def _epilogue(self, i, x, ws, noises, layout="nchw"):
        p = self.layers[i]
        st = F.linear(ws[i], p["style_w"] * he_constant(self.w_dim, 1.0),
                      p["style_b"])
        return style.adain(x, noises[i].to(x.dtype), p["noise_strength"],
                           p["bias"], st, layout)

    def _torgb(self, r, x):
        p = self.torgb[r]
        return (equalized_conv(p["w"], x, padding=0, gain=1.0)
                + p["b"][None, :, None, None])

    def _torgb_nhcw(self, r, v):
        p = self.torgb[r]
        w = p["w"] * he_constant(p["w"].shape[1], 1.0)
        return spatial.conv1x1({"w": w, "b": p["b"]}, v, wscale=False,
                               act=None)

    def _tail_start(self, depth: int):
        """The first block (1 .. depth) of the NHCW tail, or None: the start
        of the longest run of stages ending at ``depth`` that the envelope
        admits (as ``Generator._pallas_tail_start``)."""
        if depth < 1:
            return None
        start = None
        for k in range(depth, 0, -1):
            if not spatial.stage_in_envelope(4 * 2 ** k, self.nf(k),
                                             self.nf(k + 1)):
                break
            start = k
        return start

    def _block(self, k, x, ws, noises):
        """Block k (4 * 2**k px), NCHW: up-conv, blur, epilogue; conv,
        epilogue."""
        x = equalized_conv_up2x(self.convs[2 * k - 1]["w"], x)
        x = self._epilogue(2 * k, style.blur(x), ws, noises)
        x = equalized_conv(self.convs[2 * k]["w"], x)
        return self._epilogue(2 * k + 1, x, ws, noises)

    def _block_nhcw(self, k, v, ws, noises):
        """Block k on the NHCW tail."""
        def hwio(i):
            return spatial._hwio(self.convs[i], True)
        v = conv3x3(spatial.upsample_nearest_2x(v), hwio(2 * k - 1))
        v = self._epilogue(2 * k, style.blur(v, "nhcw"), ws, noises, "nhcw")
        v = conv3x3(v, hwio(2 * k))
        return self._epilogue(2 * k + 1, v, ws, noises, "nhcw")

    def forward(self, z: torch.Tensor, depth: int, alpha, fade: bool = True,
                *, draws: dict | None = None,
                truncation_psi: float | None = None) -> torch.Tensor:
        """Images at ``4 * 2**depth`` px, NHWC float32, from latents z
        (N, latent_size); ``draws`` makes it a training forward (module
        docstring)."""
        if not (0 <= depth <= self.max_depth):
            raise ValueError(f"depth {depth} out of range "
                             f"[0, {self.max_depth}]")
        alpha = f32_scalar(alpha, z.device)
        n = z.shape[0]
        ws = self._styles(z, depth, draws, truncation_psi)
        if draws is not None:
            noises = draws["noise"]
        else:
            noises = [torch.randn((n, 1, 4 * 2 ** (i // 2), 4 * 2 ** (i // 2)),
                                  device=z.device)
                      for i in range(2 * (depth + 1))]
        x = self._epilogue(0, self.const.expand(n, -1, -1, -1), ws, noises)
        x = self._epilogue(1, equalized_conv(self.convs[0]["w"], x), ws,
                           noises)
        if depth == 0:
            return self._torgb(0, x).permute(0, 2, 3, 1)
        tail = self._tail_start(depth)
        for k in range(1, depth if tail is None else tail):
            x = self._block(k, x, ws, noises)
        if tail is None:
            out = self._torgb(depth, self._block(depth, x, ws, noises))
            if fade:
                prev = upsample_nearest_2x(self._torgb(depth - 1, x))
                out = prev * (1.0 - alpha) + out * alpha
            return out.permute(0, 2, 3, 1)
        v = x.permute(0, 2, 1, 3).contiguous()  # -> NHCW
        for k in range(tail, depth):
            v = self._block_nhcw(k, v, ws, noises)
        out = self._torgb_nhcw(depth, self._block_nhcw(depth, v, ws, noises))
        if fade:
            prev = spatial.upsample_nearest_2x(self._torgb_nhcw(depth - 1, v))
            out = prev * (1.0 - alpha) + out * alpha
        return out.permute(0, 1, 3, 2)  # NHCW -> NHWC
