"""The port's bf16 mixed precision on the CPU against pggan_tpu's.

- The bf16 pool and upsample (the plain versions of kernels #5 and #6,
  which their CUDA bf16 instantiations equal bit for bit on the card) equal
  ``pggan_tpu.ops.resample`` on bf16, forward and both transposes, bit for
  bit: the pool adds as JAX's bf16 ``reduce_window`` does on the CPU (in
  row order, each add rounded to bf16). The pool is also held bit for bit
  against that rule written out in numpy (``ml_dtypes.bfloat16``).
- Each ``compute_dtype`` primitive (conv, up2x, pool-in, minibatch
  stddev), G and D (fade and stable, at ``tests/test_mixed_precision.py``'s
  size) against the JAX package's bf16 ones. Bar: the RMS of port bf16 -
  JAX bf16 at most 1/4 of the RMS of JAX bf16 - JAX f32, so the port
  rounds at the same points as JAX (both round each conv's output once
  from an f32 sum, so they agree to the last bits here). JAX's own bars
  against f32 (``test_mixed_precision.py:23-37``) hold for the port too.
- One bf16 train step against JAX's with the same draws (bars in
  ``test_bf16_train_step_matches_jax``); three steps finite with float32
  parameters.
- A bf16 snapshot round-trips both ways between the packages; a tiny bf16
  ``cli.train --device cpu`` run completes; the kernels that stay f32 (the
  conv family #1-#3, its weight gradient #4 and the chain #7) refuse bf16.
"""

import copy
import functools
import glob
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pggan_tpu import checkpoint as jckpt
from pggan_tpu.models import Discriminator as JD
from pggan_tpu.models import Generator as JG
from pggan_tpu.ops import primitives as jprim
from pggan_tpu.ops import resample as jres
from pggan_tpu.training.state import init_state, make_optimizer
from pggan_tpu.training.steps import TrainStepBuilder as JBuilder
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.cli import train as cli
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.ops import _build, conv3x3, conv_chain, primitives
from pggan_tpu_torch.ops import resample as R
from pggan_tpu_torch.training import TrainStepBuilder
from pggan_tpu_torch.training import init_state as port_init_state

SHAPE = (16, 1, 16, 16)  # tests/test_mixed_precision.py
G_KW = dict(latent_size=16, fmap_base=64, fmap_max=32)
D_KW = dict(fmap_base=64, fmap_max=32)
BF16 = jnp.bfloat16


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _hold_quarter(port16, jax16, jax32, what):
    """RMS(port bf16 - JAX bf16) <= RMS(JAX bf16 - JAX f32) / 4."""
    port16, jax16, jax32 = (np.asarray(a, np.float32)
                            for a in (port16, jax16, jax32))
    got, noise = _rms(port16 - jax16), _rms(jax16 - jax32)
    assert noise > 0, f"{what}: bf16 and f32 agree exactly"
    assert got <= noise / 4, f"{what}: {got:.3e} against {noise:.3e} / 4"


def _bf16_values(shape, seed):
    """f32 numpy values that bf16 holds exactly, and the bf16 tensor."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x, torch.from_numpy(x).to(torch.bfloat16)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- the pool and the upsample -------------------------------------------------------

AXES = [((3, 8, 5, 12), 1, 3),   # NHCW, the kernels' own layout
        ((2, 6, 10, 14), 2, 3),  # NCHW, as the bf16 models call them
        ((4, 2, 2), 1, 2)]       # no axis between H and W


@pytest.mark.parametrize("shape,h,w", AXES)
def test_pool_and_upsample_equal_jax_in_bf16(shape, h, w):
    x, xt = _bf16_values(shape, 0)
    xj = jnp.asarray(x, BF16)
    for port, ref in ((R.avg_pool_2x, jres.avg_pool_2x),
                      (R.upsample_2x, jres.upsample_2x)):
        got = port(xt, h, w)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _f32(got), np.asarray(ref(xj, h, w).astype(jnp.float32)))


@pytest.mark.parametrize("shape,h,w", AXES)
def test_pool_and_upsample_transposes_equal_jax_in_bf16(shape, h, w):
    """The gradient of each, with a bf16 cotangent: ``0.25 * up(g)`` for
    the pool, ``4 * pool(g)`` for the upsample, both staying bf16."""
    x, xt = _bf16_values(shape, 1)
    for port, ref in ((R.avg_pool_2x, jres.avg_pool_2x),
                      (R.upsample_2x, jres.upsample_2x)):
        out_shape = jax.eval_shape(lambda v: ref(v, h, w),
                                   jnp.asarray(x, BF16)).shape
        ct, ctt = _bf16_values(out_shape, 2)
        _, vjp = jax.vjp(lambda v: ref(v, h, w), jnp.asarray(x, BF16))
        want, = vjp(jnp.asarray(ct, BF16))
        xg = xt.clone().requires_grad_(True)
        got, = torch.autograd.grad(port(xg, h, w), xg, ctt)
        assert got.dtype == torch.bfloat16 and want.dtype == BF16
        np.testing.assert_array_equal(_f32(got),
                                      np.asarray(want.astype(jnp.float32)))


def _pool_rule_numpy(x, h, w):
    """The bf16 pool's rule written out in numpy: ((x00 + x01) + x10) + x11,
    each add in f32 and rounded to bf16, then times 0.25."""
    def r(v):
        return v.astype(ml_dtypes.bfloat16).astype(np.float32)

    def part(a, b):
        return np.take(np.take(x, np.arange(a, x.shape[h], 2), axis=h),
                       np.arange(b, x.shape[w], 2), axis=w)

    s = r(r(r(part(0, 0) + part(0, 1)) + part(1, 0)) + part(1, 1))
    return r(s * np.float32(0.25))


@pytest.mark.parametrize("shape,h,w", AXES + [((2, 4, 3, 6), 1, 3)])
def test_bf16_pool_equals_its_rule_bit_for_bit(shape, h, w):
    x, xt = _bf16_values(shape, 3)
    x[0, 0] = 1e-38  # near the bottom of bf16's (and f32's) range
    xt = torch.from_numpy(x).to(torch.bfloat16)
    x = _f32(xt)
    np.testing.assert_array_equal(_f32(R.avg_pool_2x(xt, h, w)),
                                  _pool_rule_numpy(x, h, w))


def test_bf16_kernel_launches_count_under_their_own_names(monkeypatch):
    """On a CUDA tensor a bf16 pool or upsample launches the bf16 entry
    point and counts as ``*_bf16`` (the launch itself stubbed here)."""
    calls = []
    monkeypatch.setattr(_build, "use_plain", lambda x: False)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, *a: calls.append((name, fn)))
    x = torch.zeros(2, 4, 3, 8, dtype=torch.bfloat16)
    R.avg_pool_2x(x, 1, 3)
    R.upsample_2x(x, 1, 3)
    R.avg_pool_2x(x.float(), 1, 3)
    assert calls == [("avgpool2x_bf16", "pggan_avgpool2x_bf16"),
                     ("upsample2x_bf16", "pggan_upsample2x_bf16"),
                     ("avgpool2x", "pggan_avgpool2x")]


def _conv_args(dtype):
    x = torch.zeros(1, 8, 4, 8, dtype=dtype)
    w = torch.zeros(3, 3, 4, 4, dtype=dtype)
    b = torch.zeros(4, dtype=dtype)
    return x, w, b


F32_KERNELS = {
    "conv3x3 (#1)": lambda x, w, b: conv3x3.conv3x3(x, w),
    "conv3x3_act (#2)": lambda x, w, b: conv3x3.conv3x3_act(x, w, b,
                                                            slope=0.2),
    "conv3x3_act_pn (#3)": lambda x, w, b: conv3x3.conv3x3_act_pn(
        x, w, b, slope=0.2),
    "conv3x3_dw (#4)": lambda x, w, b: conv3x3.conv3x3_dw(x, x),
    "conv3x3_chain (#7)": lambda x, w, b: conv_chain.conv3x3_chain(
        x, w, b, w, b, slope=0.2, pn_eps=None),
}


@pytest.mark.parametrize("name", sorted(F32_KERNELS))
def test_f32_kernels_refuse_bf16(name):
    with torch.no_grad():
        F32_KERNELS[name](*_conv_args(torch.float32))  # f32 is taken
        with pytest.raises(TypeError, match="bfloat16"):
            F32_KERNELS[name](*_conv_args(torch.bfloat16))


# -- the compute_dtype primitives --------------------------------------------------

def _layer(rng, ksize, c, k):
    return (rng.randn(ksize, ksize, c, k).astype(np.float32),
            (rng.randn(k) * 0.1).astype(np.float32))


def _port_params(w, b):
    return {"w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            "b": torch.from_numpy(b)}


PRIMITIVES = {
    # name: (ksize, c, k, spatial, JAX fn, port fn)
    "conv 3x3": (3, 8, 16, 8, jprim.equalized_conv2d,
                 lambda p, x, **kw: primitives.equalized_conv2d(
                     p, x, padding=1, **kw)),
    "conv 4x4 pad 3 (G's first)": (
        4, 16, 8, 1, lambda p, x, **kw: jprim.equalized_conv2d(
            p, x, padding=3, **kw),
        lambda p, x, **kw: primitives.equalized_conv2d(p, x, padding=3,
                                                       **kw)),
    "conv 1x1 no act": (1, 8, 3, 8,
                        lambda p, x, **kw: jprim.equalized_conv2d(
                            p, x, padding=0, act=None, use_pixelnorm=False,
                            **kw),
                        lambda p, x, **kw: primitives.equalized_conv2d(
                            p, x, padding=0, act=None, use_pixelnorm=False,
                            **kw)),
    "up2x": (3, 8, 16, 4, jprim.equalized_conv2d_up2x,
             primitives.equalized_conv2d_up2x),
    "pool-in": (1, 3, 16, 8, jprim.equalized_conv2d_pool_in,
                primitives.equalized_conv2d_pool_in),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_compute_dtype_primitives_match_jax(name):
    ksize, c, k, s, jfn, pfn = PRIMITIVES[name]
    rng = np.random.RandomState(5)
    w, b = _layer(rng, ksize, c, k)
    x = rng.randn(3, s, s, c).astype(np.float32)  # NHWC
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want16 = jfn(jp, jnp.asarray(x), compute_dtype=BF16)
    want32 = jfn(jp, jnp.asarray(x))
    assert want16.dtype == BF16
    got = pfn(_port_params(w, b), torch.from_numpy(x.transpose(0, 3, 1, 2)),
              compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _hold_quarter(_f32(got).transpose(0, 2, 3, 1),
                  np.asarray(want16.astype(jnp.float32)), want32, name)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_minibatch_stddev_in_f32_with_the_input_dtype(groups, dtype):
    x, xt = _bf16_values((4, 5, 3, 3), 6)  # NCHW
    want = jprim.minibatch_stddev(jnp.asarray(x.transpose(0, 2, 3, 1),
                                              dtype), groups=groups)
    got = primitives.minibatch_stddev(xt.to(getattr(torch, dtype)),
                                      groups=groups)
    assert got.dtype == getattr(torch, dtype)
    # the f32 statistic sums in another order; its bf16 channel rounds the
    # last bits away
    np.testing.assert_allclose(_f32(got).transpose(0, 2, 3, 1),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6 if dtype == "float32" else 0,
                               atol=0)


# -- G and D -----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_models(compute_dtype):
    return (JG(SHAPE, **G_KW, compute_dtype=compute_dtype),
            JD(SHAPE, **D_KW, compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=None)
def _jax_params():
    g, d = _jax_models("float32")
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (to_np(g.init(jax.random.PRNGKey(0))),
            to_np(d.init(jax.random.PRNGKey(1))))


def _port_models(compute_dtype="bfloat16"):
    gp, dp = _jax_params()
    G = Generator(SHAPE, **G_KW, compute_dtype=compute_dtype)
    G.load_state_dict(checkpoint.params_from_jax(gp))
    D = Discriminator(SHAPE, **D_KW, compute_dtype=compute_dtype)
    D.load_state_dict(checkpoint.d_params_from_jax(dp))
    return G, D


Z = np.random.RandomState(2).randn(4, 16).astype(np.float32)


@pytest.mark.parametrize("fade", [True, False])
def test_bf16_generator_matches_jax(fade):
    gp, _ = _jax_params()
    want = {cd: np.asarray(_jax_models(cd)[0].apply(gp, Z, 2, 0.7, fade))
            for cd in ("float32", "bfloat16")}
    G, _ = _port_models()
    assert G._pallas_tail_start(2) is None
    with torch.no_grad():
        got = G(torch.from_numpy(Z), 2, 0.7, fade)
    assert got.dtype == torch.float32  # images surface as f32
    _hold_quarter(got.numpy(), want["bfloat16"], want["float32"],
                  f"G fade={fade}")
    assert np.max(np.abs(want["float32"] - got.numpy())) < 0.15  # JAX's bar


@pytest.mark.parametrize("fade", [True, False])
def test_bf16_discriminator_matches_jax(fade):
    gp, dp = _jax_params()
    imgs = np.asarray(_jax_models("float32")[0].apply(gp, Z, 2, 0.7))
    want = {cd: np.asarray(_jax_models(cd)[1].apply(dp, jnp.asarray(imgs),
                                                    2, 0.7, fade))
            for cd in ("float32", "bfloat16")}
    _, D = _port_models()
    assert D._pallas_span(2) == 0
    with torch.no_grad():
        got = D(torch.from_numpy(imgs), 2, 0.7, fade).numpy()
    assert got.dtype == np.float32
    _hold_quarter(got, want["bfloat16"], want["float32"], f"D fade={fade}")
    s32 = want["float32"]
    assert np.max(np.abs(s32 - got)) < 0.2 * (1 + np.max(np.abs(s32)))


def test_bf16_params_stay_f32():
    for m in _port_models():
        assert all(p.dtype == torch.float32 for p in m.parameters())


def test_compute_dtype_names():
    assert Generator(SHAPE, **G_KW, compute_dtype="bf16")._compute == \
        torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        Discriminator(SHAPE, **D_KW, compute_dtype="float16")


# -- the train step ----------------------------------------------------------------

def _draws(rng, n_steps, batch):
    """The JAX step's draws, in its order (one D repeat)."""
    draws = []
    for _ in range(n_steps):
        rng, kz, kgp = jax.random.split(rng, 3)
        draws.append(("normal", np.array(jax.random.normal(kz, (batch, 16)))))
        draws.append(("uniform", np.array(jax.random.uniform(kgp,
                                                             (batch,)))))
        rng, kz = jax.random.split(rng)
        draws.append(("normal", np.array(jax.random.normal(kz, (batch, 16)))))
    return draws


def _replay(draws):
    it = iter(draws)

    def noise(kind, shape):
        want_kind, value = next(it)
        assert (kind, tuple(shape)) == (want_kind, value.shape)
        return torch.from_numpy(value)
    return noise


def _mu_tree(module, mu, to_jax):
    """Adam's first moments (with b1 = 0, the step's gradients) as the JAX
    params tree."""
    twin = copy.deepcopy(module)
    with torch.no_grad():
        for p, t in zip(twin.parameters(), mu):
            p.copy_(t)
    return to_jax(twin)


def test_bf16_train_step_matches_jax():
    """One bf16 fade step at depth 2, batch 8, from the same parameters
    with the same draws, at lr 0 (G's loss then goes through the same D):
    the four losses within rtol 2e-2 / atol 2e-3 of JAX's, each gradient
    tensor within 0.25 of its norm. Looser than the forwards' bar: JAX's
    step is jitted, and XLA drops some of the bf16 round trips that its
    eager bf16 models make (which the port's forwards equal bit for bit
    above), so JAX's own bf16 step sits between bf16 and f32. Then two more
    port steps at lr 1e-3 (fade, stable): finite, parameters and moments
    float32."""
    g, d = _jax_models("bfloat16")
    gp, dp = _jax_params()
    key = jax.random.PRNGKey(3)
    noise = _replay(_draws(key, 1, 8))  # before the step donates the key
    opt = make_optimizer()
    reals = np.random.RandomState(10).uniform(
        -1, 1, (3, 1, 8, 16, 16, 1)).astype(np.float32)
    state, want = JBuilder(g, d, opt).step_fn(2, 8, True)(
        init_state(gp, dp, opt, key), reals[0], np.float32(0.5),
        np.float32(0), np.float32(0))
    G, D = _port_models()
    pstate = port_init_state(G, D)
    port = TrainStepBuilder(G, D)
    got = port.step_fn(2, 8, True)(pstate, torch.from_numpy(reals[0]), 0.5,
                                   0.0, 0.0, noise=noise)
    for k in ("G_loss", "D_loss", "D_real", "D_fake"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2,
                                   atol=2e-3, err_msg=k)
    for got_tree, want_tree in (
            (_mu_tree(D, pstate.d_opt.mu, checkpoint.d_params_to_jax),
             state.d_opt.mu),
            (_mu_tree(G, pstate.g_opt.mu, checkpoint.params_to_jax),
             state.g_opt.mu)):
        for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                        jax.tree_util.tree_leaves(want_tree)):
            b = np.asarray(b)
            assert np.linalg.norm(a - b) <= 0.25 * np.linalg.norm(b)
    for i, fade in ((1, True), (2, False)):
        metrics = port.step_fn(2, 8, fade)(
            pstate, torch.from_numpy(reals[i]), 0.5 if fade else 1.0, 1e-3,
            1e-3)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    for t in [*G.parameters(), *D.parameters(), *pstate.g_opt.mu,
              *pstate.d_opt.nu]:
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert int(pstate.d_opt.count) == 3


# -- snapshots and the CLI ---------------------------------------------------------

def test_bf16_snapshot_round_trips_between_packages(tmp_path):
    gp, _ = _jax_params()
    g16, _ = _jax_models("bfloat16")
    jpath = str(tmp_path / "jax.dat")
    jckpt.save_snapshot(jpath, g16, gp, 2, 1.0)
    G, meta = checkpoint.load_snapshot(jpath)
    assert G.compute_dtype == "bfloat16" and meta["depth"] == 2
    ppath = str(tmp_path / "port.dat")
    checkpoint.save_snapshot(ppath, G, 2, 1.0)
    model, params, _ = jckpt.load_snapshot(ppath)
    assert model.compute_dtype == "bfloat16"
    with torch.no_grad():
        got = G(torch.from_numpy(Z), 2, 1.0, False).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(model.apply(params, Z, 2, 1.0, fade=False)))


def test_bf16_train_cli_run(tmp_path):
    small = ["--Generator.fmap_base", "64", "--Generator.fmap_max", "16",
             "--Generator.latent_size", "16",
             "--Discriminator.fmap_base", "64",
             "--Discriminator.fmap_max", "16"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = cli.cli_main([
            "--device", "cpu", "--dataset_class", "SyntheticDataset",
            "--SyntheticDataset.resolution", "16",
            "--SyntheticDataset.num_items", "8", *small,
            "--Generator.compute_dtype", "bfloat16",
            "--Discriminator.compute_dtype", "bfloat16",
            "--result_dir", str(tmp_path), "--total_kimg", "0.15",
            "--DepthManager.lod_training_nimg", "32",
            "--DepthManager.lod_transition_nimg", "32",
            "--DepthManager.tick_kimg_default", "0.05",
            "--DepthManager.tick_kimg_overrides", "{}",
            "--DepthManager.minibatch_default", "4",
            "--num_data_workers", "1"])
    finally:
        torch.set_num_threads(threads)
    assert trainer.depth == 2 and trainer.state.G.compute_dtype == "bfloat16"
    path, = glob.glob(os.path.join(str(tmp_path), "*",
                                   "network-snapshot-generator-*.dat"))
    G, meta = checkpoint.load_snapshot(path)
    assert G.compute_dtype == "bfloat16" and meta["depth"] == 2
    with torch.no_grad():
        assert torch.isfinite(G(torch.zeros(2, 16), 2, 1.0)).all()


@pytest.mark.parametrize("symbol,name", [
    ("_ZN12_GLOBAL__N_113avgpool2x_vecIfEEvPK4uint4PT_xii",
     "avgpool2x_vec<float>"),
    ("_ZN12_GLOBAL__N_113avgpool2x_vecI13__nv_bfloat16EEvPK4uint4PT_xii",
     "avgpool2x_vec<__nv_bfloat16>"),
    ("_ZN12_GLOBAL__N_115upsample2x_rowsI5uint25uint4EEvPKT_PT0_iiii",
     "upsample2x_rows<uint2,uint4>"),
    ("_ZN12_GLOBAL__N_114conv3x3_kernelILi16ELi2EEEvv", "conv3x3_kernel<16,2>"),
    ("_ZN12_GLOBAL__N_112chain_kernelILi8ELi8ELb1EEEvv",
     "chain_kernel<8,8,1>"),
    ("_ZN12_GLOBAL__N_117conv3x3_dw_reduceEPKfPfxx", "conv3x3_dw_reduce"),
])
def test_build_report_names_each_instantiation(symbol, name):
    """ptxas's report keys each kernel by its demangled name: the f32 and
    bf16 instantiations of one template stay apart."""
    assert _build._demangle(symbol) == name
