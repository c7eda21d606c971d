"""The plain reference of StyleGAN (Karras, Laine, Aila, arXiv:1812.04948):
NVlabs/stylegan ``training/networks_stylegan.py`` (``G_style``,
``G_mapping``, ``G_synthesis``, ``D_basic``) and ``training/loss.py``
(``G_wgan``, ``D_wgan_gp``), written out in plain PyTorch, NCHW, with no
kernel, no graph and no batching trick, beside ``pggan.py`` (whose Adam,
TF32 rounding and data path it shares).

It decides ``correct`` for the StyleGAN cells and holds the port's
StyleGAN in the CPU tests. It imports nothing of the program. Every layer
is ``F.conv2d`` / ``F.linear`` and elementwise operations, in float64 (the
check), float32 with TF32 off, or the TF32 control.

Departures, each the same function as the published code:
- the up-conv is the 2x nearest upsample then the 3x3 conv: the published
  "fused" up-conv (128 px and up) is a stride-2 transposed conv whose 4x4
  kernel is the 3x3 one summed over its four 2x2 shifts, the same linear
  map;
- the down-conv is the 3x3 conv then the 2x2 average pool: the published
  fused form (128 px and up) is a stride-2 conv whose 4x4 kernel is the
  3x3 one summed over its four shifts and divided by 4, the same map;
- the blur is ``[1, 2, 1]`` sums of shifted copies along W, then along
  H, over 16, with a zero border of one: the published blur is the
  depthwise conv of ``[1, 2, 1]^T [1, 2, 1] / 16`` with padding 1, the
  same map written separably (a depthwise ``F.conv2d`` would, in the
  gradient penalty's double backward, run one convolution a channel);
- Dense0 of D's 4 px block is a 4x4 valid conv over the 4x4 features,
  the dense layer over the flattened NCHW features;
- the fade is the port's (``pggan.py``): G blends the previous stage's
  toRGB, upsampled, by alpha; D the fromRGB of the pooled image;
- mixing and the cutoff are tensor operations (no host value), as
  ``tf.where`` takes them, so that the step can be counted on the meta
  device.

Weights are a flat dict ``name -> tensor`` named after the port's
parameters: ``G.mapping.<i>.{w,b}``, ``G.const``,
``G.layers.<i>.{noise_strength,bias,style_w,style_b}``, ``G.convs.<i>.w``,
``G.torgb.<r>.{w,b}``, ``D.blocks.<j>.{fromrgb,c1,c2}.{w,b}``,
``D.linear.{w,b}``; and the buffer ``G.w_avg``, which no gradient or Adam
touches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import pggan
from portbench.reference.pggan import Adam, full_precision, prep_rows  # noqa: F401

LRELU = 0.2
EPS = 1e-8
W_AVG = "G.w_avg"


def nf(cfg: dict, stage: int) -> int:
    """networks_stylegan.py nf(): min(fmap_base / 2^stage, fmap_max)."""
    return pggan.nf(cfg, stage)


def num_layers(cfg: dict) -> int:
    return 2 * (pggan.stages(cfg) - 1)


def layers(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, G then D, and of the
    buffer ``G.w_avg``. ``init`` is ``("normal", std)`` or ``("uniform",
    bound)``. Weights are unit normal (the mapping's 1 / lrmul); every
    bias, noise strength, style bias and the constant is drawn nonzero (the
    published code starts them at 0, or 1 for the constant), so that no
    path is silent in the check."""
    c, r = cfg["num_channels"], pggan.stages(cfg)
    lat, wd, lrmul = cfg["latent_size"], cfg["w_dim"], cfg["mapping_lrmul"]
    out = []
    dims = [lat] + [wd] * cfg["mapping_layers"]
    for i in range(cfg["mapping_layers"]):
        out.append((f"G.mapping.{i}.w", (dims[i + 1], dims[i]),
                    ("normal", 1.0 / lrmul)))
        out.append((f"G.mapping.{i}.b", (dims[i + 1],), ("uniform", 10.0)))
    out.append(("G.const", (1, nf(cfg, 1), 4, 4), ("normal", 1.0)))
    chans = [nf(cfg, i // 2 + 1) for i in range(num_layers(cfg))]
    for i, ch in enumerate(chans):
        out.append((f"G.layers.{i}.noise_strength", (ch,), ("uniform", 0.5)))
        out.append((f"G.layers.{i}.bias", (ch,), ("uniform", 0.5)))
        out.append((f"G.layers.{i}.style_w", (2 * ch, wd), ("normal", 1.0)))
        out.append((f"G.layers.{i}.style_b", (2 * ch,), ("uniform", 0.5)))
    for i in range(1, len(chans)):
        out.append((f"G.convs.{i - 1}.w", (chans[i], chans[i - 1], 3, 3),
                    ("normal", 1.0)))
    for k in range(r - 1):
        out.append((f"G.torgb.{k}.w", (c, nf(cfg, k + 1), 1, 1),
                    ("normal", 1.0)))
        out.append((f"G.torgb.{k}.b", (c,), ("uniform", 0.5)))
    for j, i in enumerate(range(r - 1, 0, -1)):
        last = i == 1

        def conv(name, k, cin, cout):
            out.append((name + ".w", (cout, cin, k, k), ("normal", 1.0)))
            out.append((name + ".b", (cout,),
                        ("uniform", 1.0 / math.sqrt(k * k * cin))))

        conv(f"D.blocks.{j}.fromrgb", 1, c, nf(cfg, i))
        conv(f"D.blocks.{j}.c1", 3, nf(cfg, i) + int(last), nf(cfg, i))
        conv(f"D.blocks.{j}.c2", 4 if last else 3, nf(cfg, i), nf(cfg, i - 1))
    out.append(("D.linear.w", (1, nf(cfg, 0)), ("normal", 1.0)))
    out.append(("D.linear.b", (1,), ("uniform", 1.0 / math.sqrt(nf(cfg, 0)))))
    return out


def trainable(p: dict, model: str) -> list:
    """The names of a model's (``"G"`` / ``"D"``) trainable parameters."""
    return [k for k in p if k.startswith(model + ".") and k != W_AVG]


class Net:
    """The reference's arithmetic for one precision (``pggan.Net``'s):
    ``"float64"``, ``"float32"`` (TF32 off) or ``"tf32"``."""

    def __init__(self, cfg: dict, precision: str = "float64"):
        self.base = pggan.Net(cfg, precision)
        self.cfg, self.precision = cfg, precision
        self.dtype, self.r = self.base.dtype, self.base.r

    def _operands(self, x, w):
        if self.precision == "tf32" and x.device.type != "cuda":
            return pggan._tf32(x), pggan._tf32(w)
        return x, w

    def conv(self, x, w, pad, gain=math.sqrt(2.0)):
        """Equalized conv, no bias."""
        w = w * (gain / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3]))
        x, w = self._operands(x, w)
        return F.conv2d(x, w, padding=pad)

    def dense(self, x, w, b, gain, lrmul=1.0):
        w = w * (gain / math.sqrt(w.shape[1]) * lrmul)
        x, w = self._operands(x, w)
        return F.linear(x, w, b * lrmul)

    @staticmethod
    def act(x):
        return F.leaky_relu(x, LRELU)

    @staticmethod
    def up(x):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    @staticmethod
    def blur(x):
        def along(t, dim):
            pad = (1, 1) if dim == 3 else (0, 0, 1, 1)
            p, n = F.pad(t, pad), t.shape[dim]
            return (p.narrow(dim, 0, n) + 2.0 * p.narrow(dim, 1, n)
                    + p.narrow(dim, 2, n))

        return along(along(x, 3), 2) / 16.0

    # -- G --------------------------------------------------------------------
    def mapping(self, p, z):
        cfg = self.cfg
        x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + EPS)
        for i in range(cfg["mapping_layers"]):
            x = self.act(self.dense(x, p[f"G.mapping.{i}.w"],
                                    p[f"G.mapping.{i}.b"], math.sqrt(2.0),
                                    cfg["mapping_lrmul"]))
        return x

    def styles(self, p, z, depth, extra, psi):
        """Each used layer's w (layers, N, w_dim). ``extra`` (a training
        forward's draws) updates ``p["G.w_avg"]`` in place, then mixes;
        without it, truncation by ``psi`` on the first
        ``truncation_cutoff`` layers."""
        cfg = self.cfg
        count = 2 * (depth + 1)
        w = self.mapping(p, z)
        index = torch.arange(count, device=z.device).view(-1, 1, 1)
        if extra is not None:
            with torch.no_grad():
                mean = w.detach().mean(dim=0)
                p[W_AVG].copy_(mean + cfg["w_avg_beta"] * (p[W_AVG] - mean))
            w2 = self.mapping(p, extra["z2"])
            cut = torch.where(extra["coin"] < cfg["style_mixing_prob"],
                              extra["cut"], torch.full_like(extra["cut"],
                                                            count))
            return torch.where(index < cut.to(w.dtype), w[None], w2[None])
        ws = w[None].expand(count, -1, -1)
        coefs = torch.where(index < cfg["truncation_cutoff"],
                            torch.full((), psi, dtype=w.dtype,
                                       device=w.device),
                            torch.ones((), dtype=w.dtype, device=w.device))
        return p[W_AVG] + coefs * (ws - p[W_AVG])

    def epilogue(self, p, i, x, w, noise):
        """layer_epilogue: noise, bias, act, instance norm, style mod."""
        name, c = f"G.layers.{i}", x.shape[1]
        x = x + p[name + ".noise_strength"].view(1, -1, 1, 1) * noise
        x = self.act(x + p[name + ".bias"].view(1, -1, 1, 1))
        x = x - x.mean(dim=(2, 3), keepdim=True)
        x = x * torch.rsqrt(x.square().mean(dim=(2, 3), keepdim=True) + EPS)
        st = self.dense(w, p[name + ".style_w"], p[name + ".style_b"], 1.0)
        return x * (st[:, :c, None, None] + 1.0) + st[:, c:, None, None]

    def torgb(self, p, k, x):
        return (self.conv(x, p[f"G.torgb.{k}.w"], 0, gain=1.0)
                + p[f"G.torgb.{k}.b"].view(1, -1, 1, 1))

    def G(self, p, z, depth, alpha, fade, extra=None, noise=None, psi=0.7):
        """NHWC images at 4 * 2**depth px. A training forward takes
        ``extra`` (``draws``' z2, coin, cut and noise); a serving one the
        noise images ``noise`` and the truncation ``psi``."""
        ws = self.styles(p, z, depth, extra, psi)
        noise = extra["noise"] if extra is not None else noise
        n = z.shape[0]
        x = p["G.const"].expand(n, -1, -1, -1)
        x = self.epilogue(p, 0, x, ws[0], noise[0])
        x = self.epilogue(p, 1, self.conv(x, p["G.convs.0.w"], 1), ws[1],
                          noise[1])
        prev = x
        for k in range(1, depth + 1):
            prev = x
            x = self.blur(self.conv(self.up(x), p[f"G.convs.{2 * k - 1}.w"],
                                    1))
            x = self.epilogue(p, 2 * k, x, ws[2 * k], noise[2 * k])
            x = self.conv(x, p[f"G.convs.{2 * k}.w"], 1)
            x = self.epilogue(p, 2 * k + 1, x, ws[2 * k + 1],
                              noise[2 * k + 1])
        out = self.torgb(p, depth, x)
        if fade and depth > 0:
            out = self.up(self.torgb(p, depth - 1, prev)) * (1.0 - alpha) \
                + out * alpha
        return out.permute(0, 2, 3, 1)

    # -- D --------------------------------------------------------------------
    def stddev(self, x):
        """minibatch_stddev_layer, group 4, one feature: sample i in group
        i % (N / 4)."""
        g = min(self.cfg["mbstd_group_size"], x.shape[0])
        n, c, h, w = x.shape
        y = x.reshape(g, n // g, c, h, w)
        y = y - y.mean(dim=0, keepdim=True)
        y = torch.sqrt(y.square().mean(dim=0) + EPS).mean(dim=(1, 2, 3))
        tile = y.repeat(g).view(n, 1, 1, 1).expand(n, 1, h, w)
        return torch.cat([x, tile], dim=1)

    def D(self, p, x, depth, alpha, fade):
        """D_basic; scores (N, 1) of NHWC images."""
        n = self.r - 1
        x = x.permute(0, 3, 1, 2)

        def bias_act(y, name):
            return self.act(y + p[name + ".b"].view(1, -1, 1, 1))

        def fromrgb(h, j):
            name = f"D.blocks.{j}.fromrgb"
            return bias_act(self.conv(h, p[name + ".w"], 0), name)

        def block(h, j):
            name = f"D.blocks.{j}"
            if j == n - 1:  # 4x4: mbstd, conv, Dense0
                h = bias_act(self.conv(self.stddev(h), p[name + ".c1.w"], 1),
                             name + ".c1")
                return bias_act(self.conv(h, p[name + ".c2.w"], 0),
                                name + ".c2")
            h = bias_act(self.conv(h, p[name + ".c1.w"], 1), name + ".c1")
            h = self.base.pool(self.conv(self.blur(h), p[name + ".c2.w"], 1))
            return bias_act(h, name + ".c2")

        h = block(fromrgb(x, n - (depth + 1)), n - (depth + 1))
        if depth > 0 and fade:
            prev = fromrgb(self.base.pool(x), n - depth)
            h = h * alpha + (1.0 - alpha) * prev
        for i in range(depth, 0, -1):
            h = block(h, n - i)
        return self.dense(h.reshape(h.shape[0], -1), p["D.linear.w"],
                          p["D.linear.b"], 1.0)


# -- the WGAN-GP step ---------------------------------------------------------

def g_draws(gen: torch.Generator, batch: int, cfg: dict, depth: int, dtype):
    """A training forward of G's draws, in the step's order after its z:
    z2, the coin, the cutoff's uniform, then one noise image a layer from
    layer 0 up; float32 from ``gen``, cast to ``dtype``. ``cut``, the
    cutoff, is ``1 + floor(u (layers - 1))`` taken in float32."""
    dev = gen.device
    count = 2 * (depth + 1)
    z2 = torch.randn((batch, cfg["latent_size"]), generator=gen, device=dev)
    coin = torch.rand((), generator=gen, device=dev)
    u = torch.rand((), generator=gen, device=dev)
    noise = [torch.randn((batch, 1, 4 * 2 ** (i // 2), 4 * 2 ** (i // 2)),
                         generator=gen, device=dev) for i in range(count)]
    cut = 1.0 + torch.floor(u * (count - 1))
    return {"z2": z2.to(dtype), "coin": coin, "cut": cut,
            "noise": [t.to(dtype) for t in noise]}


def draws(gen: torch.Generator, batch: int, cfg: dict, depth: int, dtype):
    """One step's draws in the program's order: the D half's latents, G's
    draws and the mixing factors; then the G half's latents and G's
    draws."""
    dev = gen.device
    z_d = torch.randn((batch, cfg["latent_size"]), generator=gen, device=dev)
    extra_d = g_draws(gen, batch, cfg, depth, dtype)
    mix = torch.rand((batch,), generator=gen, device=dev)
    z_g = torch.randn((batch, cfg["latent_size"]), generator=gen, device=dev)
    extra_g = g_draws(gen, batch, cfg, depth, dtype)
    return (z_d.to(dtype), extra_d, mix.to(dtype), z_g.to(dtype), extra_g)


def _half(extra: dict, k: int) -> dict:
    return dict(extra, z2=extra["z2"][:k],
                noise=[t[:k] for t in extra["noise"]])


def train_step(net: Net, p: dict, opt_d: Adam, opt_g: Adam, reals, noise,
               depth: int, alpha: float, fade: bool, lr_d: float,
               lr_g: float, hp: dict, half_batch: bool = False) -> dict:
    """One WGAN-GP step (``pggan.train_step``'s order): D's loss with the
    gradient penalty and D's Adam step, then G's loss through the updated D
    and G's Adam step; each of G's two forwards updates ``p["G.w_avg"]``.
    ``half_batch`` (a planted fault) takes the losses over the first half
    of the batch alone. Returns the four losses and each parameter's
    gradient (``grads``)."""
    z_d, extra_d, mix, z_g, extra_g = noise
    if half_batch:
        k = reals.shape[0] // 2
        reals, z_d, mix, z_g = reals[:k], z_d[:k], mix[:k], z_g[:k]
        extra_d, extra_g = _half(extra_d, k), _half(extra_g, k)
    lam, drift, target = hp["iwass_lambda"], hp["iwass_epsilon"], \
        hp["iwass_target"]
    d_keys, g_keys = trainable(p, "D"), trainable(p, "G")
    for k in d_keys + g_keys:
        p[k].requires_grad_(True)

    with torch.no_grad():
        fake = net.G(p, z_d, depth, alpha, fade, extra_d)
    d_real = net.D(p, reals, depth, alpha, fade).reshape(-1)
    d_fake = net.D(p, fake, depth, alpha, fade).reshape(-1)
    d_real_loss = -d_real + d_real.square() * drift
    e = mix.reshape(-1, 1, 1, 1)
    mixed = (reals * (1.0 - e) + fake * e).detach().requires_grad_(True)
    score = net.D(p, mixed, depth, alpha, fade).sum()
    g_in, = torch.autograd.grad(score, mixed, create_graph=True)
    norms = torch.sqrt(g_in.reshape(g_in.shape[0], -1).square().sum(1)
                       + 1e-12)
    gp = (norms - target).square() * (lam / target ** 2)
    d_cost = (d_fake + d_real_loss + gp).mean()
    gd = torch.autograd.grad(d_cost, [p[k] for k in d_keys],
                             allow_unused=True, materialize_grads=True)
    grads = dict(zip(d_keys, gd))
    opt_d.step({k: p[k] for k in d_keys}, grads, lr_d)

    g_cost = (-net.D(p, net.G(p, z_g, depth, alpha, fade, extra_g), depth,
                     alpha, fade)).mean()
    gg = torch.autograd.grad(g_cost, [p[k] for k in g_keys],
                             allow_unused=True, materialize_grads=True)
    grads.update(zip(g_keys, gg))
    opt_g.step({k: p[k] for k in g_keys}, dict(zip(g_keys, gg)), lr_g)
    for k in d_keys + g_keys:
        p[k].requires_grad_(False)
    return {"G_loss": g_cost.detach(), "D_loss": d_cost.detach(),
            "D_real": d_real_loss.mean().detach(),
            "D_fake": d_fake.mean().detach(),
            "grads": {k: v.detach() for k, v in grads.items()}}


def step_flops(cfg: dict, depth: int, batch: int, fade: bool,
               hp: dict) -> int:
    """Model FLOPs of one train step of this reference, counted by
    ``torch.utils.flop_counter`` on the meta device: convolutions and
    matrix products, forward, backward and the gradient penalty's double
    backward."""
    from torch.utils.flop_counter import FlopCounterMode
    net = Net(cfg, "float32")
    p = {name: torch.zeros(shape, device="meta")
         for name, shape, _ in layers(cfg)}
    p[W_AVG] = torch.zeros((cfg["w_dim"],), device="meta")
    res = 4 * 2 ** depth
    reals = torch.zeros((batch, res, res, cfg["num_channels"]), device="meta")

    def extra():
        return {"z2": torch.zeros((batch, cfg["latent_size"]), device="meta"),
                "coin": torch.zeros((), device="meta"),
                "cut": torch.ones((), device="meta"),
                "noise": [torch.zeros((batch, 1, 4 * 2 ** (i // 2),
                                       4 * 2 ** (i // 2)), device="meta")
                          for i in range(2 * (depth + 1))]}

    z = torch.zeros((batch, cfg["latent_size"]), device="meta")
    noise = (z, extra(), torch.zeros((batch,), device="meta"), z, extra())
    d_p = {k: v for k, v in p.items() if k.startswith("D.")}
    g_p = {k: v for k, v in p.items() if k in trainable(p, "G")}
    with FlopCounterMode(display=False) as counter:
        train_step(net, p, Adam(d_p), Adam(g_p), reals, noise, depth, 0.5,
                   fade, 1e-3, 1e-3, hp)
    return int(counter.get_total_flops())
