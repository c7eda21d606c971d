"""The port's StyleGAN (``models/style.py``, the Discriminator's StyleGAN
options, ``ops/style.py``) on the CPU against the plain reference
``portbench/reference/stylegan.py`` (NVlabs/stylegan written out in plain
torch), with seeded random weights and every bias, noise strength, style
bias and the constant nonzero. Imports no JAX.

The port runs in float64 here (its plain twins take float64), so the
comparisons against the float64 reference are tight: what is left is the
reassociation of sums (the fused up-conv against upsample then conv, the
epilogue written out, the group statistic), some 1e-13 of the values.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.models import Discriminator
from pggan_tpu_torch.models.style import StyleGenerator
from pggan_tpu_torch.ops import style as style_ops
from pggan_tpu_torch.training.state import init_state
from pggan_tpu_torch.training.steps import TrainStepBuilder, _generator_noise
from portbench.reference import stylegan as ref

# 32 px, latent and mapping 32 wide, 8 mapping layers; batch 8, so that
# the group-4 statistic has two strided groups
CFG = {"resolution": 32, "num_channels": 3, "fmap_base": 128,
       "fmap_decay": 1.0, "fmap_max": 32, "latent_size": 32, "w_dim": 32,
       "mapping_layers": 8, "mapping_lrmul": 0.01, "w_avg_beta": 0.995,
       "style_mixing_prob": 0.9, "truncation_psi": 0.7,
       "truncation_cutoff": 8, "mbstd_group_size": 4}
BATCH = 8
HP = {"iwass_lambda": 10.0, "iwass_epsilon": 0.001, "iwass_target": 1.0}
# float64 against float64: sums reassociated, nothing else
TIGHT = 1e-9
# the published widths' parameter counts (StyleGAN's training log)
PUBLISHED = {"G": 26_219_627, "mapping": 2_101_248, "D": 23_087_249}


def weights(cfg=CFG, seed=0) -> dict:
    """Every parameter of ``ref.layers``, float64, drawn from ``seed``,
    and a nonzero ``G.w_avg``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, (kind, scale) in ref.layers(cfg):
        if kind == "normal":
            out[name] = torch.randn(shape, generator=gen,
                                    dtype=torch.float64) * scale
        else:
            out[name] = (torch.rand(shape, generator=gen, dtype=torch.float64)
                         * 2 - 1) * scale
    out[ref.W_AVG] = torch.randn((cfg["w_dim"],), generator=gen,
                                 dtype=torch.float64) * 0.1
    return out


def models(p: dict, cfg=CFG):
    """The port's G and D with the weights ``p``, float64."""
    shape = (1, cfg["num_channels"], cfg["resolution"], cfg["resolution"])
    G = StyleGenerator(shape, fmap_base=cfg["fmap_base"],
                       fmap_max=cfg["fmap_max"],
                       latent_size=cfg["latent_size"], w_dim=cfg["w_dim"])
    D = Discriminator(shape, fmap_base=cfg["fmap_base"],
                      fmap_max=cfg["fmap_max"], blur=True,
                      mbstd_group_size=cfg["mbstd_group_size"],
                      equalized_dense=True)
    G, D = G.double(), D.double()
    for prefix, model in (("G.", G), ("D.", D)):
        own = model.state_dict()
        theirs = {k[2:]: v for k, v in p.items() if k.startswith(prefix)}
        assert set(own) == set(theirs)
        model.load_state_dict(theirs)
    return G, D


def gap(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def test_parameter_counts_at_published_widths():
    shape = (1, 3, 1024, 1024)
    G = StyleGenerator(shape, device="meta")
    D = Discriminator(shape, fmap_base=8192, blur=True, mbstd_group_size=4,
                      equalized_dense=True, device="meta")
    assert sum(p.numel() for p in G.parameters()) == PUBLISHED["G"]
    assert sum(p.numel() for p in G.mapping.parameters()) == \
        PUBLISHED["mapping"]
    assert sum(p.numel() for p in D.parameters()) == PUBLISHED["D"]
    cfg = dict(CFG, resolution=1024, fmap_base=8192, fmap_max=512,
               latent_size=512, w_dim=512)
    names = {k: math.prod(s) for k, s, _ in ref.layers(cfg)}
    assert sum(v for k, v in names.items() if k.startswith("G.")) == \
        PUBLISHED["G"]
    assert sum(v for k, v in names.items() if k.startswith("D.")) == \
        PUBLISHED["D"]


def _extra(gen, depth):
    return ref.g_draws(gen, BATCH, CFG, depth, torch.float64)


@pytest.mark.parametrize("fade", [True, False])
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_forward_against_reference(depth, fade):
    """G (a training forward with draws, and a truncated serving one) and
    D, at each depth, faded and not."""
    p = weights()
    G, D = models(p)
    net = ref.Net(CFG, "float64")
    gen = torch.Generator().manual_seed(1)
    z = torch.randn((BATCH, CFG["latent_size"]), generator=gen,
                    dtype=torch.float64)
    alpha = 0.375
    # a training forward: the same draws through G.draw's callback order
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    draws = G.draw(_generator_noise(g1), BATCH, depth)
    extra = ref.g_draws(g2, BATCH, CFG, depth, torch.float64)
    p_ref = dict(p, **{ref.W_AVG: p[ref.W_AVG].clone()})
    with torch.no_grad():
        got = G(z, depth, alpha, fade, draws=draws)
        want = net.G(p_ref, z, depth, alpha, fade, extra)
    assert gap(got, want) < TIGHT
    assert gap(G.w_avg, p_ref[ref.W_AVG]) < TIGHT
    # serving: truncation 0.7 on layers 0-7, fresh noise (seeded alike)
    torch.manual_seed(3)
    with torch.no_grad():
        served = G(z, depth, alpha, fade)
    torch.manual_seed(3)
    noise = [torch.randn((BATCH, 1, 4 * 2 ** (i // 2), 4 * 2 ** (i // 2)))
             .double() for i in range(2 * (depth + 1))]
    with torch.no_grad():
        want = net.G(p_ref, z, depth, alpha, fade, noise=noise, psi=0.7)
    assert gap(served, want) < TIGHT
    x = torch.randn((BATCH, 4 * 2 ** depth, 4 * 2 ** depth, 3),
                    generator=gen, dtype=torch.float64)
    assert gap(D(x, depth, alpha, fade), net.D(p, x, depth, alpha, fade)) \
        < TIGHT


def test_mixing_cutoff():
    """With the coin under 0.9 the layers from the cutoff take w2, the
    cutoff 1 + floor(u (layers - 1)); over it no layer does."""
    G, _ = models(weights())
    depth, layers = 2, 6
    z = torch.randn((BATCH, CFG["latent_size"]), dtype=torch.float64)
    z2 = torch.randn((BATCH, CFG["latent_size"]), dtype=torch.float64)
    w1, w2 = G.mapping_fn(z), G.mapping_fn(z2)
    for coin, u, cut in ((0.5, 0.0, 1), (0.5, 0.5, 3), (0.89, 0.999, 5),
                         (0.9, 0.5, layers), (0.95, 0.0, layers)):
        draws = {"z2": z2, "coin": torch.tensor(coin),
                 "cutoff": torch.tensor(u, dtype=torch.float32)}
        ws = G._styles(z, depth, draws, None)
        for i in range(layers):
            assert torch.equal(ws[i], w1 if i < cut else w2), (coin, u, i)
        extra = {"z2": z2, "coin": torch.tensor(coin),
                 "cut": 1.0 + torch.floor(torch.tensor(u) * (layers - 1))}
        want = ref.Net(CFG).styles(dict(weights()), z, depth, extra, 0.7)
        assert gap(ws, want) < TIGHT


def test_train_step_against_reference():
    """One step at depth 2 (fade): D with its gradient penalty and Adam,
    then G and Adam, both of G's forwards updating w_avg, on draws
    replayed from one seed; then a second step, after Adam's first."""
    p = weights()
    G, D = models(p)
    depth, alpha, lr = 2, 0.625, 1e-3
    state = init_state(G, D, seed=5)
    builder = TrainStepBuilder(G, D, cuda_graphs=False, **HP)
    step = builder.step_fn(depth, BATCH, True)
    net = ref.Net(CFG, "float64")
    pr = {k: v.clone() for k, v in p.items()}
    opt_d = ref.Adam({k: v for k, v in pr.items() if k.startswith("D.")})
    opt_g = ref.Adam({k: pr[k] for k in ref.trainable(pr, "G")})
    g_prog, g_ref = (torch.Generator().manual_seed(11) for _ in range(2))
    rng = torch.Generator().manual_seed(2)
    for k in range(2):
        reals = torch.rand((1, BATCH, 16, 16, 3), generator=rng,
                           dtype=torch.float64) * 2 - 1
        got = step(state, reals, alpha, lr, lr,
                   noise=_generator_noise(g_prog))
        noise = ref.draws(g_ref, BATCH, CFG, depth, torch.float64)
        want = ref.train_step(net, pr, opt_d, opt_g, reals[0], noise, depth,
                              alpha, True, lr, lr, HP)
        # a loss taken after an Adam step, whose bias corrections the port
        # takes in float32 (as optax does), moves by ~1e-8 of the update
        for name in ("D_loss", "D_real", "D_fake", "G_loss"):
            bar = TIGHT if k == 0 and name != "G_loss" else 1e-5
            assert gap(got[name], want[name]) < bar, name
    params = {**{"G." + k: v for k, v in G.state_dict().items()},
              **{"D." + k: v for k, v in D.state_dict().items()}}
    # each change over the two steps, against the largest element of its
    # reference: the second step's gradients follow D's float32 bias
    # corrections (~1e-8), and Adam at b1 = 0 divides each element by its
    # own magnitude, so an element near zero moves by up to ~3e-5
    worst = max(gap(params[k] - p[k], v - p[k]) for k, v in pr.items())
    assert worst < 1e-4
    assert gap(G.w_avg, pr[ref.W_AVG]) < TIGHT


def test_adain_twin_gradcheck():
    """The epilogue's backward (the formulas the kernel computes) against
    finite differences of its forward, in float64, in both layouts; a
    second derivative raises."""
    gen = torch.Generator().manual_seed(4)
    n, c, h, w = 2, 3, 5, 4

    def t(*shape):
        return torch.randn(shape, generator=gen,
                           dtype=torch.float64).requires_grad_(True)

    for layout in ("nchw", "nhcw"):
        x = t(n, c, h, w) if layout == "nchw" else t(n, h, c, w)
        noise = torch.randn((n, 1, h, w), generator=gen, dtype=torch.float64)
        args = (t(c), t(c), t(n, 2 * c))

        def fn(x, st, b, sty, layout=layout):
            return style_ops.adain(x, noise, st, b, sty, layout)

        assert torch.autograd.gradcheck(fn, (x, *args))
        nchw = x if layout == "nchw" else x.permute(0, 2, 1, 3)
        got = fn(x, *args)
        want = style_ops.adain_plain(nchw.contiguous(), noise, *args)
        assert gap(got if layout == "nchw" else got.permute(0, 2, 1, 3),
                   want) < TIGHT
        gx, = torch.autograd.grad(fn(x, *args).square().sum(), x,
                                  create_graph=True)
        with pytest.raises(RuntimeError):
            torch.autograd.grad(gx.sum(), x)
    xb = t(n, c, h, w)
    assert torch.autograd.gradgradcheck(style_ops.blur, (xb,))
    assert gap(style_ops.blur(xb), ref.Net.blur(xb)) < TIGHT


def test_snapshot_round_trip_with_w_avg(tmp_path):
    p = weights()
    G, D = models(p)
    G, D = G.float(), D.float()
    for name, model in (("g", G), ("d", D)):
        path = str(tmp_path / f"{name}.dat")
        checkpoint.save_snapshot(path, model, 3, 0.5)
        back, meta = checkpoint.load_model_snapshot(path)
        assert meta["depth"] == 3 and type(back) is type(model)
        assert checkpoint.model_config(back) == checkpoint.model_config(model)
        for (k, a), (_, b) in zip(model.state_dict().items(),
                                  back.state_dict().items()):
            assert torch.equal(a, b), k
    served, _ = checkpoint.load_snapshot(str(tmp_path / "g.dat"))
    assert torch.equal(served.w_avg, G.w_avg)
    state = init_state(G, D, seed=1, g_ema=True)
    sd = checkpoint.training_state_dict(state)
    G2, D2 = models(weights(seed=9))
    twin = init_state(G2.float(), D2.float(), seed=2, g_ema=True)
    checkpoint.restore_training_state(twin, sd)
    assert torch.equal(twin.G.w_avg, G.w_avg)
    assert torch.equal(twin.g_ema.w_avg, state.g_ema.w_avg)


def test_sample_images_truncation():
    """``sample_images`` serves the model's truncation (0.7), a given psi,
    and none at psi 1, each the forward's with the same noise."""
    from pggan_tpu_torch.sampling import sample_images
    p = weights()
    G, _ = models(p)
    G = G.float()
    net = ref.Net(CFG, "float64")
    depth, n = 2, 5
    for psi in (None, 0.5, 1.0):
        torch.manual_seed(8)
        got = sample_images(G, depth, 1.0, n, rng=np.random.RandomState(3),
                            truncation_psi=psi)
        torch.manual_seed(8)
        noise = [torch.randn((n, 1, 4 * 2 ** (i // 2), 4 * 2 ** (i // 2)))
                 .double() for i in range(2 * (depth + 1))]
        z = torch.from_numpy(np.random.RandomState(3).randn(
            n, CFG["latent_size"]).astype(np.float32)).double()
        want = net.G(p, z, depth, 1.0, False, noise=noise,
                     psi=0.7 if psi is None else psi)
        assert gap(torch.from_numpy(got), want) < 1e-5, psi
    with pytest.raises(ValueError, match="truncation_psi"):
        from pggan_tpu_torch.models import Generator
        sample_images(Generator((1, 3, 8, 8), fmap_base=16, fmap_max=8,
                                latent_size=8), 1, 1.0, 2,
                      truncation_psi=0.7)


def test_cli_train_stylegan(tmp_path):
    """``cli.train --architecture stylegan`` for a few steps at the small
    size on the CPU: snapshots of a StyleGenerator with its w_avg, and a
    Discriminator with StyleGAN's options; served by ``cli.generate``."""
    from pggan_tpu_torch.cli import generate
    from pggan_tpu_torch.cli import train as cli
    argv = ["--device", "cpu", "--architecture", "stylegan",
            "--dataset_class", "SyntheticDataset",
            "--SyntheticDataset.resolution", "16",
            "--SyntheticDataset.num_items", "16",
            "--StyleGenerator.fmap_base", "64",
            "--StyleGenerator.fmap_max", "16",
            "--StyleGenerator.latent_size", "16",
            "--StyleGenerator.w_dim", "16",
            "--Discriminator.fmap_base", "64",
            "--Discriminator.fmap_max", "16",
            "--total_kimg", "0.032",
            "--DepthManager.lod_training_nimg", "8",
            "--DepthManager.lod_transition_nimg", "8",
            "--DepthManager.tick_kimg_default", "0.016",
            "--DepthManager.tick_kimg_overrides", "{}",
            "--DepthManager.minibatch_default", "4",
            "--num_data_workers", "1", "--result_dir", str(tmp_path)]
    trainer = cli.cli_main(argv)
    assert trainer.iterations > 0 and trainer.depth >= 1
    G, D = trainer.G, trainer.D
    assert isinstance(G, StyleGenerator) and float(G.w_avg.abs().sum()) > 0
    assert (D.blur, D.mbstd_group_size, D.equalized_dense) == (True, 4, True)
    snap = checkpoint.resolve_generator_path("latest", str(tmp_path))
    back, _ = checkpoint.load_snapshot(snap)
    assert isinstance(back, StyleGenerator)
    out = generate.output_samples(snap, 3, [], "t", device="cpu",
                                  result_dir=str(tmp_path),
                                  truncation_psi=0.5)
    assert out.shape[0] == 3 and np.isfinite(out).all()
