"""The port's grouped dispatch and dispatch backpressure on the CPU, against
pggan_tpu's (``pggan_tpu/training/trainer.py:183-349``,
``steps.py:202-273``, ``tests/test_group_step.py``).

- The port's ``Trainer`` and the JAX ``Trainer`` at ``steps_per_dispatch``
  4, each with its own plugins and a stub builder that records step and
  group calls, take the same dispatches (keys with their group sizes,
  alpha and lr vectors, reals shapes), make the same plugin calls and log
  the same lines; grouping engages in stable and fade windows.
- ``_plan_group`` decides as the JAX one does, case for case.
- A grouped step on a tiny model equals its K per-step calls bit for bit
  on the eager CPU route, given the same draws; so does a CLI run with
  grouping against one without.
- The vector-alpha prep equals the scalar prep per step; the loss
  monitor's tick means over scalars and vectors equal the JAX monitor's.
- The backpressure with stubbed events: the bytes stay bounded, the
  oldest dispatch is waited on first, completed ones return their buffer
  without a wait, and a budget of 0 never waits.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.training import plugins as jplugins
from pggan_tpu.training.steps import TrainStepBuilder as JBuilder
from pggan_tpu.training.trainer import Trainer as JTrainer
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.cli import train as cli
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.training import TrainStepBuilder, init_state, plugins
from pggan_tpu_torch.training.trainer import Trainer
from test_torch_port_loop import (_argv, _assert_state_equal, _drive,
                                  _StubBuilder)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- (a) the trainer's dispatches against the JAX trainer's ----------------------

class _GroupStubBuilder(_StubBuilder):
    """The loop test's stub builder with a group program that records its
    key, its vectors and its reals' shape, and returns one metric a step."""

    def group_step_fn(self, depth, batch, fade, group):
        def gstep(state, reals, alphas, lrs_d, lrs_g):
            self.calls.append((depth, batch, fade, group,
                               *(tuple(np.asarray(v, np.float64).tolist())
                                 for v in (alphas, lrs_d, lrs_g)),
                               tuple(reals.shape)))
            n = len(self.calls) + np.arange(group) / 8
            metrics = {k: self.as_metric(np.asarray(v, np.float32))
                       for k, v in (("G_loss", n * 0.5),
                                    ("D_loss", n * -0.25),
                                    ("D_real", n / 3.0),
                                    ("D_fake", 1.0 / n))}
            return metrics if state is None else (state, metrics)
        return gstep


def test_grouped_trainer_follows_the_jax_trainer():
    got, want = [], []
    port = _GroupStubBuilder(torch.tensor)
    _drive(Trainer, plugins, port, None, got, steps_per_dispatch=4)
    ref = _GroupStubBuilder(lambda v: v)
    _drive(JTrainer, jplugins, ref, "state", want, steps_per_dispatch=4)
    assert port.calls == ref.calls
    groups = [c for c in port.calls if len(c) == 8]
    assert {c[3] for c in groups} == {4}
    # grouping engaged in a stable and in a fade window, the fade's alphas
    # rising step by step
    assert any(not c[2] for c in groups)
    fades = [c for c in groups if c[2]]
    assert fades and all(np.all(np.diff(c[4]) > 0) for c in fades)
    assert len(groups) < len(port.calls)  # per-step near the boundaries
    assert len(got) == len(want)
    assert sum(r[0] == "log" for r in got) >= 4
    for a, b in zip(got, want):
        assert a[:11] == b[:11]
        if len(a) > 11:
            assert a[11].keys() == b[11].keys()
            for k in a[11]:
                np.testing.assert_equal(a[11][k], b[11][k])


# -- (b) _plan_group case for case ----------------------------------------------

class _Stub:
    mesh = None
    group = None


def _hooks(trainer, **attrs):
    for k, v in attrs.items():
        setattr(trainer, k, v)
    return trainer


_INF = lambda nimg: math.inf  # noqa: E731
_FADE = dict(alpha=0.5, schedule_horizon=_INF,
             alpha_lookahead=lambda nimg: (0, 0.5 + nimg / 1000))

# (attributes set on a bare trainer at steps_per_dispatch 4, minibatch 8:
# per = 8 images; the planned group)
PLAN_CASES = {
    "no horizon hook": ({}, 1),
    "stable forever": ({"schedule_horizon": _INF}, 4),
    "fade without fade hooks": ({"alpha": 0.5, "schedule_horizon": _INF}, 1),
    "fade, last step hits 1": (
        {**_FADE, "fade_horizon": lambda nimg: 3 * 8}, 1),
    "fade, inside": ({**_FADE, "fade_horizon": lambda nimg: 3 * 8 + 1}, 4),
    "fade, depth changes inside": (
        {**_FADE, "fade_horizon": lambda nimg: 100,
         "alpha_lookahead": lambda nimg: (int(nimg >= 16), 0.5)}, 1),
    "fade, law reaches 1": (
        {**_FADE, "fade_horizon": lambda nimg: 100,
         "alpha_lookahead": lambda nimg: (0, 1.0 if nimg >= 24 else 0.5)},
        1),
    "stable, horizon one short": (
        {"schedule_horizon": lambda nimg: 4 * 8 - 1}, 1),
    "stable, horizon exact": ({"schedule_horizon": lambda nimg: 4 * 8}, 4),
    "tick, 3 steps left": (
        {"schedule_horizon": _INF, "tick_duration_nimg": 3 * 8}, 1),
    "tick, 4 steps left": (
        {"schedule_horizon": _INF, "tick_duration_nimg": 4 * 8}, 4),
    "tick, 25 images left": (
        {"schedule_horizon": _INF, "tick_duration_nimg": 3 * 8 + 1}, 4),
    "run end, 2 steps left": (
        {"schedule_horizon": _INF, "total_nimg": 2 * 8}, 1),
    "run end inside the tick": (
        {"schedule_horizon": _INF, "cur_nimg": 40, "tick_start_nimg": 40,
         "total_nimg": 40 + 4 * 8}, 4),
    "repeats double per": (
        {"schedule_horizon": lambda nimg: 4 * 8, "D_training_repeats": 2},
        1),
    "no minibatch yet": ({"schedule_horizon": _INF,
                          "minibatch_size": None}, 1),
    "one step a dispatch": ({"schedule_horizon": _INF,
                             "steps_per_dispatch": 1}, 1),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_group_decides_as_jax(case):
    attrs, want = PLAN_CASES[case]
    planned = []
    for cls in (Trainer, JTrainer):
        t = cls(None, None, _Stub(), None, None, iter(()), None,
                steps_per_dispatch=4)
        t.minibatch_size = 8
        planned.append(_hooks(t, **attrs)._plan_group())
    (group, alphas), (jgroup, jalphas) = planned
    assert group == jgroup == want
    if group > 1 and attrs.get("alpha", 1.0) < 1.0:
        assert alphas.dtype == jalphas.dtype == np.float32
        np.testing.assert_array_equal(alphas, jalphas)
        assert alphas.shape == (4,)
    else:
        assert alphas is None and jalphas is None


# -- (c) a grouped step on a tiny model equals its K per-step calls --------------

SHAPE = (1, 1, 16, 16)
SMALL = dict(fmap_base=64, fmap_max=16)


def _models(seed=5):
    G = Generator(SHAPE, latent_size=16, **SMALL,
                  generator=torch.Generator().manual_seed(seed))
    D = Discriminator(SHAPE, **SMALL,
                      generator=torch.Generator().manual_seed(seed + 1))
    return G, D


def _draws(seed):
    rng = np.random.RandomState(seed)

    def noise(kind, shape):
        v = rng.randn(*shape) if kind == "normal" else rng.uniform(size=shape)
        return torch.from_numpy(v.astype(np.float32))
    return noise


@pytest.mark.parametrize("fade", [True, False])
def test_group_step_equals_its_steps_bit_for_bit(fade):
    depth, batch, group = 1, 2, 3
    alphas = (np.asarray([0.1, 0.4, 0.7], np.float32) if fade
              else np.ones(3, np.float32))
    lrs_d = np.asarray([1e-3, 8e-4, 6e-4], np.float32)
    lrs_g = np.asarray([5e-4, 9e-4, 2e-3], np.float32)
    runs = []
    for grouped in (False, True):
        G, D = _models()
        state = init_state(G, D, seed=0)
        builder = TrainStepBuilder(G, D)
        reals = torch.from_numpy(np.random.RandomState(3).randn(
            group, *builder.real_batch_shape(depth, batch)).astype(
                np.float32))
        noise = _draws(9)
        if grouped:
            m = builder.group_step_fn(depth, batch, fade, group)(
                state, reals, alphas, lrs_d, lrs_g, noise=noise)
        else:
            step = builder.step_fn(depth, batch, fade)
            per = [step(state, reals[k], alphas[k], lrs_d[k], lrs_g[k],
                        noise=noise) for k in range(group)]
            m = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        runs.append((m, checkpoint.training_state_dict(state)))
    (m1, sd1), (m2, sd2) = runs
    for k in m1:
        assert m2[k].shape == (group,)
        assert torch.equal(m1[k], m2[k]), k
    _assert_state_equal(sd1, sd2)
    assert sd1["g_opt"]["count"] == group


def test_group_step_checks_its_reals():
    G, D = _models()
    builder = TrainStepBuilder(G, D)
    reals = torch.zeros((2, *builder.real_batch_shape(0, 2)))
    with pytest.raises(ValueError, match=r"expected \(3, \.\.\.\)"):
        builder.group_step_fn(0, 2, False, 3)(
            init_state(G, D), reals, np.ones(2), np.ones(2), np.ones(2))


def test_cli_grouped_run_equals_per_step_run(tmp_path):
    """Through ``cli.train``: steps_per_dispatch 4 and 1 give the same
    state bit for bit, with grouped stable and fade windows (at 8, the
    default, this schedule's fades are too near a tick to group)."""
    runs = {}
    for spd in (4, 1):
        runs[spd] = cli.cli_main(_argv(
            tmp_path / str(spd), 0.2, "--Trainer.steps_per_dispatch",
            str(spd), items=1, raw=True))
    grouped = [k for k in runs[4].builder._steps if len(k) == 4]
    assert {k[2] for k in grouped} == {True, False}
    assert not [k for k in runs[1].builder._steps if len(k) == 4]
    assert (runs[4].cur_nimg, runs[4].iterations) == (runs[1].cur_nimg,
                                                      runs[1].iterations)
    _assert_state_equal(checkpoint.training_state_dict(runs[4].state),
                        checkpoint.training_state_dict(runs[1].state))


# -- (d) the prep with one alpha a step ------------------------------------------

def test_prep_vector_alpha_equals_scalar_prep():
    G, D = _models()
    prep = TrainStepBuilder(G, D).prep_fn((0, 255), (-1, 1))
    u8 = np.random.RandomState(0).randint(0, 256, (3, 1, 4, 8, 8, 1),
                                          dtype=np.uint8)
    alphas = np.asarray([0.0, 0.4, 1.0], np.float32)
    grouped = prep(torch.from_numpy(u8), alphas)
    for k, a in enumerate(alphas):
        assert torch.equal(grouped[k], prep(torch.from_numpy(u8[k]), a)), k
    want = JBuilder(None, None, None).prep_fn((0, 255), (-1, 1))(
        jnp.asarray(u8), jnp.asarray(alphas))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -- (e) the loss monitor over scalars and vectors ---------------------------------

def test_loss_monitor_mixes_scalars_and_vectors_as_jax():
    rng = np.random.RandomState(4)
    entries = [np.asarray(rng.randn(*shape), np.float32)
               for shape in ((), (8,), (), (), (8,), (3,), ())]
    means = []
    for cls, mod, as_value in ((Trainer, plugins, torch.from_numpy),
                               (JTrainer, jplugins, np.asarray)):
        t = cls(torch.nn.Linear(1, 1), None, _Stub(), None, None, iter(()),
                None)
        mon = mod.EfficientLossMonitor(0, "G_loss")
        t.register_plugin(mon)
        for i, v in enumerate(entries, 1):
            mon.iteration(i, as_value(v.copy()))
        mon.epoch(1)
        means.append(t.stats["G_loss"]["epoch_mean"])
    np.testing.assert_allclose(means[0], means[1], rtol=1e-12)
    assert means[0] == np.concatenate(
        [np.atleast_1d(v).astype(np.float64) for v in entries]).mean()


def test_comet_plugin_is_the_metrics_exporter():
    assert plugins.CometPlugin is plugins.MetricsExporter


# -- (f) the backpressure ------------------------------------------------------------

class _Event:
    """A dispatch's event: completed when ``done``; ``synchronize`` logs the
    wait and completes it."""

    def __init__(self, log, tag):
        self.log, self.tag, self.done = log, tag, False

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append(self.tag)
        self.done = True


class _Buffer:
    def __init__(self, nbytes):
        self.nbytes = nbytes

    def numel(self):
        return self.nbytes


def _bare(budget_mb):
    return Trainer(None, None, _Stub(), None, None, iter(()), None,
                   inflight_budget_mb=budget_mb)


def test_backpressure_bounds_bytes_and_waits_for_the_oldest():
    """Mirrors tests/test_group_step.py's throttle test: below the budget
    no wait; past it the oldest dispatches are waited on, in order, until
    the bytes fit again; one dispatch always stays in flight; a completed
    dispatch returns its buffer to the pool without a wait."""
    t = _bare(1)
    t._pool = {1024: [], 900 * 1024: []}
    waited = []

    def dispatch(tag, nbytes):
        t._throttle_inflight(_Event(waited, tag), _Buffer(nbytes), nbytes)
        assert t._inflight_bytes == sum(n for *_, n in t._inflight)

    for k in range(8):
        dispatch(f"small{k}", 1024)
    assert waited == [] and len(t._inflight) == 8
    dispatch("big0", 900 * 1024)
    assert waited == []  # 900K + 8K <= 1 MiB
    dispatch("big1", 900 * 1024)
    assert waited == [f"small{k}" for k in range(8)] + ["big0"]
    assert [e.tag for e, *_ in t._inflight] == ["big1"]
    assert len(t._pool[1024]) == 8 and len(t._pool[900 * 1024]) == 1
    dispatch("huge", 10 * 1024 * 1024)
    assert waited[-1] == "big1" and len(t._inflight) == 1
    assert t.inflight_peak_bytes == 10 * 1024 * 1024 + 900 * 1024
    # a completed dispatch is found and dropped without a wait
    t._inflight[0][0].done = True
    dispatch("next", 1024)
    assert waited[-1] == "big1"
    assert [e.tag for e, *_ in t._inflight] == ["next"]
    assert t._inflight_bytes == 1024
    assert t.inflight_peak_bytes == 10 * 1024 * 1024 + 900 * 1024


def test_backpressure_budget_zero_never_waits():
    t = _bare(0)
    waited = []
    for k in range(4):
        t._throttle_inflight(_Event(waited, k), _Buffer(1), 100 * 1024 * 1024)
    assert waited == [] and len(t._inflight) == 4
    assert t._inflight_bytes == 4 * 100 * 1024 * 1024
    t._inflight[1][0].done = True  # not the oldest: stays until it is
    t._throttle_inflight(_Event(waited, 4), _Buffer(1), 1)
    assert waited == [] and len(t._inflight) == 5
    for e, *_ in t._inflight:
        e.done = True
    t._throttle_inflight(_Event(waited, 5), _Buffer(1), 1)
    assert waited == [] and [e.tag for e, *_ in t._inflight] == [5]
    assert t._inflight_bytes == 1
