"""The plain reference: the progressive-growing GAN of deepsound-project's
pggan-pytorch (network.py, wgan_gp_loss.py, train.py) written out in plain
PyTorch, NCHW, with no kernel, no graph and no batching trick.

It is the yardstick that decides ``correct``: the benchmark hands it the
same weights, reals and random draws as the program under test, and it
works out again what the program produced. It imports nothing of the
program. Every layer is ``F.conv2d`` / ``F.linear`` and elementwise
operations; TF32 is off (``precision="tf32"`` is the lower-precision
control, and ``half_batch`` one of the planted faults).

Weights are a flat dict ``name -> tensor`` with OIHW conv weights, named
after the published snapshot tree: ``G.block0.c1.w``, ``G.blocks.<i>.c2.b``,
``D.blocks.<j>.fromrgb.w``, ``D.linear.w``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LRELU = 0.2
EPS = 1e-8


def full_precision() -> None:
    """float32 means float32: TF32 off for cuDNN and for matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def nf(cfg: dict, stage: int) -> int:
    """Feature maps of a stage (network.py:94-95)."""
    return min(int(cfg["fmap_base"] / (2.0 ** (stage * cfg["fmap_decay"]))),
               cfg["fmap_max"])


def stages(cfg: dict) -> int:
    """log2 of the resolution."""
    r = int(math.log2(cfg["resolution"]))
    if 2 ** r != cfg["resolution"]:
        raise ValueError(f"resolution {cfg['resolution']} is no power of 2")
    return r


def layers(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, G then D. ``init`` is
    ``"normal"`` (an equalized-LR weight, N(0, 1)) or the bound ``b`` of a
    uniform U(-b, b) (a bias, and the final linear layer, as torch's
    default init draws them)."""
    c, r, lat = cfg["num_channels"], stages(cfg), cfg["latent_size"]
    out = []

    def conv(name, k, cin, cout):
        out.append((name + ".w", (cout, cin, k, k), "normal"))
        out.append((name + ".b", (cout,), 1.0 / math.sqrt(k * k * cin)))

    conv("G.block0.c1", 4, lat, nf(cfg, 1))
    conv("G.block0.c2", 3, nf(cfg, 1), nf(cfg, 1))
    conv("G.block0.torgb", 1, nf(cfg, 1), c)
    for i in range(2, r):
        conv(f"G.blocks.{i - 2}.c1", 3, nf(cfg, i - 1), nf(cfg, i))
        conv(f"G.blocks.{i - 2}.c2", 3, nf(cfg, i), nf(cfg, i))
        conv(f"G.blocks.{i - 2}.torgb", 1, nf(cfg, i), c)
    for j, i in enumerate(range(r - 1, 0, -1)):
        last = i == 1
        conv(f"D.blocks.{j}.fromrgb", 1, c, nf(cfg, i))
        conv(f"D.blocks.{j}.c1", 3, nf(cfg, i) + int(last), nf(cfg, i))
        conv(f"D.blocks.{j}.c2", 4 if last else 3, nf(cfg, i), nf(cfg, i - 1))
    bound = 1.0 / math.sqrt(nf(cfg, 0))
    out.append(("D.linear.w", (1, nf(cfg, 0)), bound))
    out.append(("D.linear.b", (1,), bound))
    return out


# -- layers -----------------------------------------------------------------

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10-bit mantissa (nearest, ties away), its
    gradient passed straight through: the control's conv operands on a
    device that has no TF32 path."""
    bits = t.detach().float().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return t + (bits.view(torch.float32).to(t.dtype) - t).detach()


class Net:
    """The reference's arithmetic for one precision: ``"float64"``,
    ``"float32"`` (TF32 off) or ``"tf32"`` (the control: cuDNN's TF32 on
    the card, operands rounded to TF32 elsewhere)."""

    def __init__(self, cfg: dict, precision: str = "float64"):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.precision = cfg, precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.r = stages(cfg)

    def conv(self, p, name, x, pad, act=True, pn=False):
        w = p[name + ".w"]
        w = w * math.sqrt(2.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
        if self.precision == "tf32" and x.device.type != "cuda":
            x, w = _tf32(x), _tf32(w)
        y = F.conv2d(x, w, padding=pad) + p[name + ".b"].view(1, -1, 1, 1)
        if act:
            y = F.leaky_relu(y, LRELU)
        if pn:
            y = y * torch.rsqrt(y.square().mean(dim=1, keepdim=True) + EPS)
        return y

    @staticmethod
    def up(x):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    @staticmethod
    def pool(x):
        return F.avg_pool2d(x, 2)

    @staticmethod
    def stddev(x):
        """network.py:174-187: one channel holding the stddev of the whole
        activation tensor."""
        s = torch.sqrt((x - x.mean()).square().mean() + EPS)
        return torch.cat([x, s.expand(x.shape[0], 1, *x.shape[2:])], dim=1)

    def G(self, p, z, depth, alpha, fade):
        """network.py:118-139; NHWC images at 4 * 2**depth px."""
        h = z.reshape(z.shape[0], -1, 1, 1)
        h = h * torch.rsqrt(h.square().mean(dim=1, keepdim=True) + EPS)
        h = self.conv(p, "G.block0.c1", h, 3, pn=True)
        h = self.conv(p, "G.block0.c2", h, 1, pn=True)
        if depth == 0:
            return self.conv(p, "G.block0.torgb", h, 0, act=False) \
                .permute(0, 2, 3, 1)
        for i in range(depth - 1):
            h = self.conv(p, f"G.blocks.{i}.c1", self.up(h), 1, pn=True)
            h = self.conv(p, f"G.blocks.{i}.c2", h, 1, pn=True)
        last = f"G.blocks.{depth - 1}"
        x = self.conv(p, last + ".c1", self.up(h), 1, pn=True)
        x = self.conv(p, last + ".c2", x, 1, pn=True)
        out = self.conv(p, last + ".torgb", x, 0, act=False)
        if fade:
            prev = "G.block0" if depth == 1 else f"G.blocks.{depth - 2}"
            low = self.up(self.conv(p, prev + ".torgb", h, 0, act=False))
            out = low * (1.0 - alpha) + out * alpha
        return out.permute(0, 2, 3, 1)

    def D(self, p, x, depth, alpha, fade):
        """network.py:225-240; scores (N, 1) of NHWC images."""
        n = self.r - 1
        x = x.permute(0, 3, 1, 2)

        def block(h, j, entry):
            name = f"D.blocks.{j}"
            if entry:
                h = self.conv(p, name + ".fromrgb", h, 0)
            if j == n - 1:  # the 4x4 block
                h = self.conv(p, name + ".c1", self.stddev(h), 1)
                return self.conv(p, name + ".c2", h, 0)
            h = self.conv(p, name + ".c1", h, 1)
            return self.pool(self.conv(p, name + ".c2", h, 1))

        h = block(x, n - (depth + 1), True)
        if depth > 0 and fade:
            prev = self.conv(p, f"D.blocks.{n - depth}.fromrgb",
                             self.pool(x), 0)
            h = h * alpha + (1.0 - alpha) * prev
        for i in range(depth, 0, -1):
            h = block(h, n - i, False)
        return F.linear(h.reshape(h.shape[0], -1), p["D.linear.w"],
                        p["D.linear.b"])


# -- the WGAN-GP step ---------------------------------------------------------

class Adam:
    """Adam with the learning rate given at each step, b1 = 0, b2 = 0.99,
    eps 1e-8 (train.py:195), bias-corrected."""

    def __init__(self, params: dict, b1=0.0, b2=0.99, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            den = (self.nu[k] / bc2).sqrt_().add_(self.eps)
            params[k].sub_(lr * (self.mu[k] / bc1) / den)


def draws(gen: torch.Generator, batch: int, latent: int, dtype):
    """One step's random draws in the order the model draws them: the D
    repeat's latents and mixing factors, then G's latents; float32 from
    ``gen``, cast to ``dtype``."""
    dev = gen.device
    z_d = torch.randn((batch, latent), generator=gen, device=dev)
    mix = torch.rand((batch,), generator=gen, device=dev)
    z_g = torch.randn((batch, latent), generator=gen, device=dev)
    return z_d.to(dtype), mix.to(dtype), z_g.to(dtype)


def train_step(net: Net, p: dict, opt_d: Adam, opt_g: Adam, reals, noise,
               depth: int, alpha: float, fade: bool, lr_d: float,
               lr_g: float, hp: dict, half_batch: bool = False) -> dict:
    """One WGAN-GP step (trainer.py:85-115, wgan_gp_loss.py): D's loss with
    the gradient penalty and D's Adam step, then G's loss through the
    updated D and G's Adam step. ``reals`` (B, H, W, C); ``noise`` the
    step's ``draws``. ``half_batch`` (a planted fault) takes the losses
    over the first half of the batch alone. Returns the four losses (0-d
    tensors) and each parameter's gradient (``grads``)."""
    z_d, mix, z_g = noise
    if half_batch:
        k = reals.shape[0] // 2
        reals, z_d, mix, z_g = reals[:k], z_d[:k], mix[:k], z_g[:k]
    lam, drift, target = hp["iwass_lambda"], hp["iwass_epsilon"], \
        hp["iwass_target"]
    d_keys = [k for k in p if k.startswith("D.")]
    g_keys = [k for k in p if k.startswith("G.")]
    for k in p:
        p[k].requires_grad_(True)

    with torch.no_grad():
        fake = net.G(p, z_d, depth, alpha, fade)
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

    g_cost = (-net.D(p, net.G(p, z_g, depth, alpha, fade), depth, alpha,
                     fade)).mean()
    gg = torch.autograd.grad(g_cost, [p[k] for k in g_keys],
                             allow_unused=True, materialize_grads=True)
    grads.update(zip(g_keys, gg))
    opt_g.step({k: p[k] for k in g_keys}, dict(zip(g_keys, gg)), lr_g)
    for k in p:
        p[k].requires_grad_(False)
    return {"G_loss": g_cost.detach(), "D_loss": d_cost.detach(),
            "D_real": d_real_loss.mean().detach(),
            "D_fake": d_fake.mean().detach(),
            "grads": {k: v.detach() for k, v in grads.items()}}


# -- the data path and the serve ------------------------------------------------

def prep_rows(items_u8: np.ndarray, alpha: float, range_in=(0, 255),
              range_out=(-1, 1)) -> np.ndarray:
    """Reals as the reference's dataset gives them (dataset.py:60-67,
    109-113): the fade's blend with the 2x2 box mean, ``v + (t - v) *
    (1 - alpha)``, then the linear remap, in float32 with each constant
    rounded to float32."""
    x = items_u8.astype(np.float32)
    if alpha < 1.0:
        n, h, w, c = x.shape
        t = x.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
        t = t.repeat(2, axis=1).repeat(2, axis=2)
        x = x + (t - x) * np.float32(1.0 - alpha)
    scale = (range_out[1] - range_out[0]) / (range_in[1] - range_in[0])
    return ((x - np.float32(range_in[0])) * np.float32(scale)
            + np.float32(range_out[0])).astype(np.float32)


def latents(seed: int, n: int, latent: int) -> np.ndarray:
    """A request's latents: standard normal from a numpy RandomState."""
    return np.random.RandomState(seed).randn(n, latent).astype(np.float32)


@torch.no_grad()
def sample(net: Net, p: dict, z: torch.Tensor, depth: int, alpha: float,
           block: int = 16) -> torch.Tensor:
    """G's images (N, H, W, C) for latents ``z``, ``block`` at a time."""
    fade = alpha < 1.0
    return torch.cat([net.G(p, z[i:i + block], depth, alpha, fade)
                      for i in range(0, z.shape[0], block)])
