"""The port's WGAN-GP losses, Adam and train step against pggan_tpu's on
the CPU.

Both packages get the same parameters (the JAX init carried across), the
same reals and the same random draws: the port's ``noise`` hook replays the
latents and GP mixing factors that the JAX step draws from its key splits.
The port runs depth 5 (128 px) with its NHCW D head and G tail on the
Functions of ``ops/conv3x3.py`` and ``ops/resample.py`` (their plain CPU
routes, hand-written backward rules included); the JAX reference runs its
plain XLA path (``pallas_tail=False``), which its own tests and
tests/test_torch_port_{generator,discriminator}.py tie to the Pallas path.
A grad-of-grad JAX step through interpret-mode Pallas takes minutes to
trace here; the XLA path seconds. The reference G runs its low-resolution
stages unfused (``fused_scale=False``, the same function): on XLA:CPU its
fused-scale G gradient at depth 5 in the fade graph is about 1% off the
unfused one, with or without Pallas, while the port's float32 gradient
matches the unfused one to 3e-6 and the port's own float64 run to 5e-5.

Bars, float32 throughout:
- losses: rtol 1e-4 (sums in another order, a second derivative inside);
- gradients: rtol 1e-3 and atol 1e-4 times the tensor's largest element
  (the GP's second-order terms cancel, so small elements keep the absolute
  error of the large ones);
- parameters after a step: with b1 = 0 the first Adam update is
  lr * g / (|g| + 1e-8), about lr * sign(g), so an element whose gradient
  is at the level of the float32 noise may move by up to 2 lr in one
  package against the other. Parameters are held only where every step's
  JAX gradient (of the last D repeat) exceeds 1e-2 of its tensor's largest
  element and 1e-6: at atol 1e-7 + 1e-4 lr after one update. After the
  first update about a hundred of the 173k elements (those with
  noise-level gradients) already differ by up to 2 lr, and the later
  gradients are taken at those parameters: G's early layers then move by
  up to 0.36 lr apart over three steps (measured). So each later update
  adds 0.5 lr to the bar; the losses of every step and the first step's
  gradients are what hold the later steps tightly. Everywhere else
  parameters must agree within 2 lr per update.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu import losses as jlosses
from pggan_tpu.models import Discriminator as JD
from pggan_tpu.models import Generator as JG
from pggan_tpu.training.state import apply_updates, init_state, make_optimizer
from pggan_tpu.training.steps import TrainStepBuilder as JBuilder
from pggan_tpu_torch import losses
from pggan_tpu_torch.checkpoint import (
    d_params_from_jax,
    d_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.training import Adam, TrainStepBuilder
from pggan_tpu_torch.training import init_state as port_init_state

SHAPE = (8, 3, 128, 128)
G_KW = dict(fmap_base=512, fmap_max=32, latent_size=16)
D_KW = dict(fmap_base=512, fmap_max=32)
LR = 1e-3
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel is launched."""
    _build.LAUNCHES.clear()
    yield
    assert not _build.LAUNCHES, dict(_build.LAUNCHES)


def _as_tree(module, tensors, to_jax):
    """Tensors in ``module.parameters()`` order as the JAX params tree."""
    twin = copy.deepcopy(module)
    with torch.no_grad():
        for p, t in zip(twin.parameters(), tensors):
            p.copy_(t)
    return to_jax(twin)


def _close_scaled(got, want, rtol, scaled_atol, err_msg=""):
    atol = scaled_atol * max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX reference models on their plain XLA path."""
    return (JG(SHAPE, **G_KW, pallas_tail=False, fused_scale=False),
            JD(SHAPE, **D_KW, pallas_tail=False))


@functools.lru_cache(maxsize=None)
def _jax_init():
    g, d = _jax_models()
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    # the key as numpy: the JAX step donates its state, key included
    return to_np(g.init(keys[0])), to_np(d.init(keys[1])), np.asarray(keys[2])


def _port_models():
    G = Generator(SHAPE, **G_KW)
    G.load_state_dict(params_from_jax(_jax_init()[0]))
    D = Discriminator(SHAPE, **D_KW)
    D.load_state_dict(d_params_from_jax(_jax_init()[1]))
    return G, D


def _reals(depth, batch, repeats=1, seed=0):
    res = 4 * 2 ** depth
    return np.random.RandomState(seed).uniform(
        -1, 1, (repeats, batch, res, res, 3)).astype(np.float32)


# -- losses and gradients --------------------------------------------------------

DEPTH, BATCH, ALPHA = 5, 2, 0.5


@functools.lru_cache(maxsize=None)
def _jax_losses_and_grads():
    g, d = _jax_models()
    gp, dp, _ = _jax_init()
    rng = np.random.RandomState(1)
    z = rng.randn(BATCH, 16).astype(np.float32)
    mix = rng.uniform(size=BATCH).astype(np.float32)
    real = _reals(DEPTH, BATCH)[0]

    def d_apply(p, x):
        return d.apply(p, x, DEPTH, ALPHA, True)

    def d_pair(p, x2):
        return d.apply(p, x2, DEPTH, ALPHA, True, stat_groups=2)

    def g_apply(p, zz):
        return g.apply(p, zz, DEPTH, ALPHA, True)

    def d_loss(p):
        # the loss draws its mixing factors from a key; hand ours in
        # through calc_gradient_penalty's own signature instead
        fake = jax.lax.stop_gradient(g_apply(gp, z))
        both = d_pair(p, jnp.concatenate([real, fake]))
        d_real, d_fake = both[:BATCH], both[BATCH:]
        d_real_loss = -d_real + jnp.square(d_real) * 1e-3
        pen = jlosses.calc_gradient_penalty(d_apply, p, real, fake,
                                            jnp.asarray(mix))
        cost = jnp.mean(d_fake.ravel() + d_real_loss.ravel() + pen)
        return cost, (jnp.mean(d_real_loss), jnp.mean(d_fake))

    (d_cost, aux), d_grads = jax.jit(jax.value_and_grad(
        d_loss, has_aux=True))(dp)
    g_cost, g_grads = jax.jit(jax.value_and_grad(
        lambda p: jlosses.wgan_gp_G_loss(g_apply, d_apply, p, dp, z)))(gp)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(z=z, mix=mix, real=real, d_cost=float(d_cost),
                aux=tuple(map(float, aux)), d_grads=to_np(d_grads),
                g_cost=float(g_cost), g_grads=to_np(g_grads))


def test_d_and_g_losses_and_gradients_match_jax():
    """The D loss with its GP (paired real+fake pass), the G loss, and
    both parameter gradients, at depth 5: D's head and G's tail on."""
    ref = _jax_losses_and_grads()
    G, D = _port_models()
    assert D._pallas_span(DEPTH) == 1 and G._pallas_tail_start(DEPTH) == 4
    z, mix, real = (torch.from_numpy(ref[k]) for k in ("z", "mix", "real"))

    def d_fn(x):
        return D(x, DEPTH, ALPHA, True)

    def d_pair(x2):
        return D(x2, DEPTH, ALPHA, True, stat_groups=2)

    def g_fn(zz):
        return G(zz, DEPTH, ALPHA, True)

    d_cost, aux = losses.wgan_gp_D_loss(d_fn, g_fn, real, z, mix,
                                        d_pair_fn=d_pair)
    np.testing.assert_allclose(d_cost.item(), ref["d_cost"], rtol=LOSS_RTOL)
    np.testing.assert_allclose([a.item() for a in aux], ref["aux"],
                               rtol=LOSS_RTOL)
    d_grads = torch.autograd.grad(d_cost, list(D.parameters()),
                                  allow_unused=True, materialize_grads=True)
    g_cost = losses.wgan_gp_G_loss(g_fn, d_fn, z)
    np.testing.assert_allclose(g_cost.item(), ref["g_cost"], rtol=LOSS_RTOL)
    g_grads = torch.autograd.grad(g_cost, list(G.parameters()),
                                  allow_unused=True, materialize_grads=True)
    for mod, grads, want, to_jax in ((D, d_grads, ref["d_grads"],
                                      d_params_to_jax),
                                     (G, g_grads, ref["g_grads"],
                                      params_to_jax)):
        _hold_grads(_as_tree(mod, grads, to_jax), want)


def _d_loss_grads():
    """D and its loss's parameter gradients at the reference inputs."""
    ref = _jax_losses_and_grads()
    G, D = _port_models()
    z, mix, real = (torch.from_numpy(ref[k]) for k in ("z", "mix", "real"))
    d_cost, _ = losses.wgan_gp_D_loss(
        lambda x: D(x, DEPTH, ALPHA, True), lambda zz: G(zz, DEPTH, ALPHA, True),
        real, z, mix, d_pair_fn=lambda x2: D(x2, DEPTH, ALPHA, True,
                                             stat_groups=2))
    grads = torch.autograd.grad(d_cost, list(D.parameters()),
                                allow_unused=True, materialize_grads=True)
    return D, grads


def test_gp_takes_no_weight_gradient(monkeypatch):
    """Inside the gradient penalty's inner ``autograd.grad`` the conv
    Functions compute no weight gradient (no ``conv3x3_dw`` call), and D's
    gradients are the same as when they did, and match JAX."""
    from pggan_tpu_torch.ops import conv3x3
    dw_fwd, scope = conv3x3._dw_fwd, losses.input_grad_only
    inside = [False]
    counts = {"inside": 0, "outside": 0}

    def spy(x, ct):
        counts["inside" if inside[0] else "outside"] += 1
        return dw_fwd(x, ct)

    def watched(real_scope):
        @contextlib.contextmanager
        def gp_scope():
            inside[0] = True
            try:
                with real_scope():
                    yield
            finally:
                inside[0] = False
        return gp_scope

    monkeypatch.setattr(conv3x3, "_dw_fwd", spy)
    runs = {}
    for name, real_scope in (("repaired", scope),
                             ("as before", contextlib.nullcontext)):
        monkeypatch.setattr(losses, "input_grad_only", watched(real_scope))
        counts.update(inside=0, outside=0)
        runs[name] = (*_d_loss_grads(), dict(counts))
    D, grads, repaired = runs["repaired"]
    _, before_grads, before = runs["as before"]
    assert repaired["inside"] == 0 and repaired["outside"] > 0
    # one weight gradient per D head conv was taken and thrown away before
    assert before["inside"] == 2 * D._pallas_span(DEPTH) > 0
    assert before["outside"] == repaired["outside"]
    for a, b in zip(grads, before_grads):
        assert torch.equal(a, b)
    _hold_grads(_as_tree(D, grads, d_params_to_jax),
                _jax_losses_and_grads()["d_grads"])


def _hold_grads(got_tree, want_tree):
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    for (path, a), b in zip(got, jax.tree_util.tree_leaves(want_tree)):
        _close_scaled(a, b, 1e-3, 1e-4, err_msg=jax.tree_util.keystr(path))


def test_unpaired_d_loss_equals_paired():
    """Without the paired pass (two D calls) the loss is the same."""
    ref = _jax_losses_and_grads()
    G, D = _port_models()
    z, mix, real = (torch.from_numpy(ref[k]) for k in ("z", "mix", "real"))
    cost, _ = losses.wgan_gp_D_loss(lambda x: D(x, DEPTH, ALPHA, True),
                                    lambda zz: G(zz, DEPTH, ALPHA, True),
                                    real, z, mix)
    np.testing.assert_allclose(cost.item(), ref["d_cost"], rtol=LOSS_RTOL)


def test_adam_matches_optax():
    rng = np.random.RandomState(2)
    p0 = rng.randn(5, 7).astype(np.float32)
    opt = make_optimizer()
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    adam = Adam([tp])
    for lr, scale in ((1e-3, 1.0), (2e-3, 1e-7), (5e-4, 10.0)):
        g = (rng.randn(5, 7) * scale).astype(np.float32)
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = apply_updates(jp, upd, lr)
        adam.step([torch.from_numpy(g)], lr)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(adam.nu[0].numpy(),
                                   np.asarray(state.nu), rtol=1e-6)


def _host_adam_step(adam, grads, lr, count):
    """Adam as the port ran it before its step scalars moved to the
    device: bias corrections and lr as host floats."""
    one = np.float32(1.0)
    bc1 = float(one - np.float32(adam.b1) ** np.float32(count))
    bc2 = float(one - np.float32(adam.b2) ** np.float32(count))
    torch._foreach_mul_(adam.mu, adam.b1)
    torch._foreach_add_(adam.mu, grads, alpha=1.0 - adam.b1)
    torch._foreach_mul_(adam.nu, adam.b2)
    torch._foreach_addcmul_(adam.nu, grads, grads, value=1.0 - adam.b2)
    den = torch._foreach_div(adam.nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, adam.eps)
    upd = torch._foreach_div(adam.mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, float(lr))
    torch._foreach_sub_(adam.params, upd)


@pytest.mark.parametrize("b1", [0.0, 0.5])
def test_adam_device_scalars_match_host_floats_and_optax(b1):
    """The count, lr and bias corrections as device tensors: the same bits
    as host floats, with the lr given as a number or as a 0-d tensor, and
    optax's ``scale_by_adam`` within float32 rounding."""
    import optax
    rng = np.random.RandomState(4)
    p0 = rng.randn(6, 5).astype(np.float32)
    opt = optax.scale_by_adam(b1=b1, b2=0.99, eps=1e-8)
    jp, jstate = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    as_number, as_tensor, host = (Adam([torch.from_numpy(p0.copy())], b1=b1)
                                  for _ in range(3))
    for count, (lr, scale) in enumerate(((1e-3, 1.0), (2e-3, 1e-7),
                                         (5e-4, 10.0), (1e-3, 0.1),
                                         (3e-3, 1.0)), 1):
        g = torch.from_numpy((rng.randn(6, 5) * scale).astype(np.float32))
        as_number.step([g], lr)
        as_tensor.step([g], torch.tensor(lr, dtype=torch.float32))
        with torch.no_grad():
            _host_adam_step(host, [g], lr, count)
        upd, jstate = opt.update(jnp.asarray(g.numpy()), jstate, jp)
        jp = apply_updates(jp, upd, lr)
        for adam in (as_number, as_tensor):
            assert int(adam.count) == count
            assert torch.equal(adam.params[0], host.params[0])
            assert torch.equal(adam.nu[0], host.nu[0])
        np.testing.assert_allclose(as_number.params[0].numpy(),
                                   np.asarray(jp), rtol=1e-6, atol=1e-9)


# -- whole steps -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_builder(repeats, ema):
    g, d = _jax_models()
    return JBuilder(g, d, make_optimizer(), d_training_repeats=repeats,
                    g_ema_beta=0.9 if ema else None)


def _jax_draws(rng, n_steps, batch, repeats):
    """The latents and mixing factors the JAX step draws, in its order
    (steps.py:129-131,152-153; losses.py:74)."""
    draws = []
    for _ in range(n_steps):
        for _ in range(repeats):
            rng, kz, kgp = jax.random.split(rng, 3)
            draws.append(("normal", np.array(
                jax.random.normal(kz, (batch, 16), jnp.float32))))
            draws.append(("uniform", np.array(
                jax.random.uniform(kgp, (batch,), jnp.float32))))
        rng, kz = jax.random.split(rng)
        draws.append(("normal", np.array(
            jax.random.normal(kz, (batch, 16), jnp.float32))))
    return draws


def _replay(draws):
    it = iter(draws)

    def noise(kind, shape):
        want_kind, value = next(it)
        assert (kind, tuple(shape)) == (want_kind, value.shape)
        return torch.from_numpy(value)
    return noise


def _good(grads_per_step):
    """Elements whose gradient clears the float32 noise in every step."""
    masks = None
    for grads in grads_per_step:
        m = [np.abs(g) > max(1e-6, 1e-2 * float(np.abs(g).max()))
             for g in jax.tree_util.tree_leaves(grads)]
        masks = m if masks is None else [a & b for a, b in zip(masks, m)]
    return masks


def _hold_params(got_tree, want_tree, start_tree, masks, n_updates, what):
    atol = 1e-7 + LR * (1e-4 + 0.5 * (n_updates - 1))
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    for (path, a), b, s, m in zip(got, jax.tree_util.tree_leaves(want_tree),
                                  jax.tree_util.tree_leaves(start_tree),
                                  masks):
        name = f"{what}{jax.tree_util.keystr(path)}"
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=atol,
                                   err_msg=name)
        assert np.all(np.abs(a - b) <= 2 * LR * n_updates + 1e-7), name
        assert not np.array_equal(a, s) or not m.any(), name


@pytest.mark.parametrize("depth,batch,repeats,ema,fades", [
    (5, 2, 1, False, (True,)),               # one step, head and tail on
    (5, 2, 1, True, (True, True, False)),    # three steps, fade -> stable
    (2, 4, 2, False, (True,)),               # two D repeats per step
])
def test_steps_match_jax(depth, batch, repeats, ema, fades):
    gp0, dp0, rng = _jax_init()
    builder = _jax_builder(repeats, ema)
    state = init_state(gp0, dp0, builder.optimizer, jnp.asarray(rng))
    if ema:
        state = state._replace(g_ema=state.g_params)
    G, D = _port_models()
    port = TrainStepBuilder(G, D, d_training_repeats=repeats,
                            g_ema_beta=0.9 if ema else None)
    pstate = port_init_state(G, D, g_ema=ema)
    draws = _jax_draws(jnp.asarray(rng), len(fades), batch, repeats)
    noise = _replay(draws)
    d_grads, g_grads = [], []
    for i, fade in enumerate(fades):
        alpha = 0.5 if fade else 1.0
        reals = _reals(depth, batch, repeats, seed=10 + i)
        state, want = builder.step_fn(depth, batch, fade)(
            state, reals, np.float32(alpha), np.float32(LR), np.float32(LR))
        d_grads.append(jax.device_get(state.d_opt.mu))  # b1 = 0: mu = g
        g_grads.append(jax.device_get(state.g_opt.mu))
        got = port.step_fn(depth, batch, fade)(
            pstate, torch.from_numpy(reals), alpha, LR, LR, noise=noise)
        for k in ("G_loss", "D_loss", "D_real", "D_fake"):
            assert got[k].shape == ()
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        if i == 0:  # later steps start from parameters that differ
            # this step's gradients, through Adam's first moment
            _hold_grads(_as_tree(D, pstate.d_opt.mu, d_params_to_jax),
                        d_grads[-1])
            _hold_grads(_as_tree(G, pstate.g_opt.mu, params_to_jax),
                        g_grads[-1])
    assert next(iter(draws[len(draws):]), None) is None
    _hold_params(d_params_to_jax(D), jax.device_get(state.d_params), dp0,
                 _good(d_grads), len(fades) * repeats, "D")
    _hold_params(params_to_jax(G), jax.device_get(state.g_params), gp0,
                 _good(g_grads), len(fades), "G")
    if ema:
        _hold_params(params_to_jax(pstate.g_ema),
                     jax.device_get(state.g_ema), gp0, _good(g_grads),
                     len(fades), "G_ema")
    # autograd.grad only: no parameter has a .grad
    assert all(p.grad is None for p in [*G.parameters(), *D.parameters()])


def test_prep_matches_jax():
    builder = _jax_builder(1, False)
    G, D = _port_models()
    port = TrainStepBuilder(G, D)
    u8 = np.random.RandomState(3).randint(0, 256, (1, 2, 8, 8, 3),
                                          dtype=np.uint8)
    for alpha in (1.0, 0.5, 0.0):
        want = np.asarray(builder.prep_fn()(u8, np.float32(alpha)))
        got = port.prep_fn()(torch.from_numpy(u8), alpha).numpy()
        # XLA may contract the remap into a fused multiply-add: 1 ulp
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    assert port.real_batch_shape(5, 3) == builder.real_batch_shape(5, 3)


def test_chain_generator_is_refused():
    G, D = _port_models()
    G.inference_chain = True
    with pytest.raises(ValueError, match="inference_chain"):
        TrainStepBuilder(G, D)


def test_default_noise_draws_from_the_state_generator():
    """Without a hook the step draws from the state's generator: the same
    seed gives the same step."""
    out = []
    for _ in range(2):
        G, D = _port_models()
        port = TrainStepBuilder(G, D)
        state = port_init_state(G, D, seed=5)
        m = port.step_fn(2, 2, True)(state, torch.from_numpy(_reals(2, 2)),
                                     0.5, LR, LR)
        out.append([float(v) for v in m.values()])
    assert out[0] == out[1] and all(np.isfinite(out[0]))
