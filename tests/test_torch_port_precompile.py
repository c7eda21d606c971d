"""``DepthManager(precompile_ahead=True)`` on the CPU: the port's
``TrainStepBuilder.precompile`` / ``precompile_ahead`` and the trainer's
wait at a precompiled key, against the JAX package's background compile
(``pggan_tpu/training/plugins.py:135-159``, ``steps.py:275-298``).

- ``precompile`` and then a real step: finite metrics (the counterpart of
  ``tests/test_plugins.py::test_precompile_warms_cache``).
- The builder's ``pggan-precompile`` thread leaves in the builder the keys
  that the JAX ``DepthManager``'s ``pggan-precompile-d*`` threads put into
  its compile cache for the same configuration, plus the group keys where
  ``steps_per_dispatch > 1``.
- The warm-up runs on a scratch copy: the real state, its generator
  included, stays bit-equal.
- A ``Trainer`` run, and a ``cli.train`` run, with the option on equal
  the same runs with it off, bit for bit: every state tensor, the
  generator state and the metrics.
- A precompile that fails raises at its key's first dispatch, and the CLI
  then exits with that error once the precompile thread has ended.
- Under a process group the warm-up makes no collective call: the copy's
  D has no group, and the step takes the rank's batch alone.
- The raw steps of one builder run one at a time (the gradient penalty's
  process-wide flag).
- Two gloo ranks (``torch_port_ranks.py``'s ``precompile`` case): on
  equals off, and no collective is called from the precompile thread.

On the card the warm-up runs on a side stream and the graph is captured
ahead; ``tests/test_torch_port_graphs.py`` holds that there. Tiny models
(8-16 px, fmap 16), single-threaded.
"""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.cli import train as cli
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.training import TrainStepBuilder, init_state, plugins
from pggan_tpu_torch.training.state import scratch_copy
from pggan_tpu_torch.training.trainer import Trainer
from test_torch_port_chain_tiles import CUDA0, _no_guard, _StubLibrary
from test_torch_port_loop import _argv, _assert_state_equal
from test_torch_port_parallel import _run_ranks
from test_torch_port_parallel import _argv as _rank_argv

SHAPE = (4, 1, 16, 16)
KW = dict(fmap_base=64, fmap_max=16)
# the JAX test's DepthManager (tests/test_plugins.py:318-323)
JAX_DM = dict(max_depth=1, minibatch_default=4, minibatch_overrides={},
              tick_kimg_default=1, tick_kimg_overrides={},
              lod_training_nimg=100, lod_transition_nimg=100)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(shape=SHAPE, latent=16):
    G = Generator(shape, latent_size=latent, **KW,
                  generator=torch.Generator().manual_seed(0))
    D = Discriminator(shape, **KW, generator=torch.Generator().manual_seed(1))
    return G, D


def _join_jax_precompiles():
    """Join the JAX DepthManager's threads (one a stage, ``-d{depth}``)."""
    for t in threading.enumerate():
        if t.name.startswith("pggan-precompile-d"):
            t.join(timeout=300)
            assert not t.is_alive()


def _spy_precompile(builder):
    """Record each of ``builder``'s precompiles: its key and thread."""
    done, real = [], builder.precompile

    def spy(depth, batch_size, fade, state, group=None, scratch=None):
        real(depth, batch_size, fade, state, group, scratch)
        done.append(((depth, batch_size, fade, group),
                     threading.current_thread().name))
    builder.precompile = spy
    return done


def _state_dict(state):
    return checkpoint.training_state_dict(state)


def test_precompile_then_a_real_step():
    G, D = _models()
    state, builder = init_state(G, D, seed=0), TrainStepBuilder(G, D)
    builder.precompile(1, 4, True, state)
    step = builder.step_fn(1, 4, True)
    reals = np.random.RandomState(0).randn(1, 4, 8, 8, 1).astype(np.float32)
    metrics = step(state, torch.from_numpy(reals), np.float32(0.5),
                   np.float32(1e-3), np.float32(1e-3))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert int(state.g_opt.count) == 1


@pytest.fixture(scope="module")
def jax_precompiled_keys():
    """The keys the JAX DepthManager's precompile thread leaves in the
    JAX builder's compile cache (tests/test_plugins.py:312-333)."""
    import jax

    from pggan_tpu.data import DataIterator, SyntheticDataset
    from pggan_tpu.models import Discriminator as JD
    from pggan_tpu.models import Generator as JG
    from pggan_tpu.training import TrainStepBuilder as JB
    from pggan_tpu.training import Trainer as JT
    from pggan_tpu.training import make_optimizer
    from pggan_tpu.training import plugins as jplugins
    from pggan_tpu.training.state import init_state as jinit
    from pggan_tpu.utils.misc import random_latents
    ds = SyntheticDataset(resolution=16, num_channels=1, num_items=8)
    g = JG((8, 1, 8, 8), latent_size=8, fmap_base=32, fmap_max=16)
    d = JD((8, 1, 8, 8), fmap_base=32, fmap_max=16)
    opt = make_optimizer()
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    state = jinit(g.init(keys[0]), d.init(keys[1]), opt, keys[2])
    tr = JT(g, d, JB(g, d, opt), state, None, None,
            lambda: random_latents(4, 8))
    tr.dataset = ds
    tr.register_plugin(jplugins.DepthManager(
        lambda bs: DataIterator(ds, bs, num_workers=1, seed=0),
        lambda bs: (lambda: random_latents(bs, 8)), **JAX_DM,
        precompile_ahead=True))
    _join_jax_precompiles()
    tr.dataiter.close()
    return set(tr.builder._step_cache)


@pytest.mark.parametrize("spd", [1, 4])
def test_depth_manager_precompiles_the_jax_targets(jax_precompiled_keys,
                                                   spd):
    from pggan_tpu_torch.data import DataIterator, SyntheticDataset
    from pggan_tpu_torch.utils.misc import random_latents
    ds = SyntheticDataset(resolution=16, num_channels=1, num_items=8)
    G, D = _models((8, 1, 8, 8), latent=8)
    builder = TrainStepBuilder(G, D)
    done = _spy_precompile(builder)
    tr = Trainer(G, D, builder, init_state(G, D), ds, None,
                 lambda: random_latents(4, 8), steps_per_dispatch=spd)
    dm = plugins.DepthManager(
        lambda bs: DataIterator(ds, bs, num_workers=1, seed=0),
        lambda bs: (lambda: random_latents(bs, 8)), **JAX_DM,
        precompile_ahead=True)
    tr.register_plugin(dm)
    assert builder._worker is not None  # started at registration
    builder.join_precompiles()
    tr.dataiter.close()
    assert jax_precompiled_keys == {(0, 4, False), (1, 4, True)}
    groups = {k + (spd,) for k in jax_precompiled_keys} if spd > 1 else set()
    assert set(builder._steps) == jax_precompiled_keys | groups
    # in order, on the one precompile thread
    assert [k for k, _ in done] == [
        (d, b, f, g) for d, b, f in sorted(jax_precompiled_keys)
        for g in ((None, spd) if spd > 1 else (None,))]
    assert len({name for _, name in done}) == 1
    assert done[0][1].startswith("pggan-precompile")
    for key in builder._steps:  # finished, none failed
        builder.await_precompile(key)
    assert not builder._precompiles


def test_scratch_copy_shares_nothing_and_leaves_the_state():
    G, D = _models()
    state = init_state(G, D, seed=5, g_ema=True)
    builder = TrainStepBuilder(G, D, g_ema_beta=0.9)
    step = builder.step_fn(1, 4, True)
    reals = torch.from_numpy(np.random.RandomState(1).randn(
        1, 4, 8, 8, 1).astype(np.float32))
    step(state, reals, 0.5, 1e-3, 1e-3)  # moments, a count, a moved EMA
    before = _state_dict(state)
    scratch = scratch_copy(state)
    ptrs = {t.data_ptr() for t in state.tensors()}
    assert not ptrs & {t.data_ptr() for t in scratch.tensors()}
    assert scratch.generator is not state.generator
    assert torch.equal(scratch.generator.get_state(),
                       state.generator.get_state())
    assert float(scratch.g_opt._lr) == float(state.g_opt._lr)
    _assert_state_equal(_state_dict(scratch), before)
    step(scratch, reals, 0.5, 1e-3, 1e-3)
    _assert_state_equal(_state_dict(state), before)
    # the warm-ups of a step and of a group leave the state bit-equal
    for key in ((1, 4, False, None), (2, 4, True, None), (2, 4, True, 3)):
        builder.precompile(*key[:3], state, group=key[3])
    _assert_state_equal(_state_dict(state), before)
    assert {(1, 4, False), (2, 4, True), (2, 4, True, 3)} <= set(
        builder._steps)


def test_scratch_copy_drops_the_group():
    """The copy's D takes its minibatch statistic over the rank's batch
    alone; the state's D keeps its process group."""
    G, D = _models()
    state = init_state(G, D)
    real = object()
    D.group = real
    scratch = scratch_copy(state)
    assert scratch.D.group is None and D.group is real


def _stage_data(trainer):
    """Batches at the trainer's depth, the same in every run: stage by
    stage, from seeds."""
    def make(bs):
        rng = np.random.RandomState(100 + trainer.depth)
        res = 4 * 2 ** trainer.depth
        batches = [rng.uniform(-1, 1, (bs, res, res, 1)).astype(np.float32)
                   for _ in range(3)]
        return iter(batches[i % 3] for i in range(10 ** 6))
    return make


class _Metrics(plugins.Plugin):
    """Every dispatch's metrics, copied."""

    def __init__(self):
        super().__init__([(1, "iteration")])
        self.rows = []

    def iteration(self, idx, *losses):
        self.rows.append((idx, torch.stack(
            [torch.as_tensor(v).reshape(-1) for v in losses]).clone()))


def _progressive(spd, precompile, fail_depth=None, monkeypatch=None):
    """Depth 0 -> 2 on the 16 px model: two stage changes (stages of 32
    images at batch 4), ``spd`` steps a dispatch; the state, the metrics
    and the builder."""
    G, D = _models()
    state, builder = init_state(G, D, seed=7), TrainStepBuilder(G, D)
    if fail_depth is not None:
        real_raw = builder._raw_step

        def raw(depth, batch, fade, local=False):
            step = real_raw(depth, batch, fade, local)
            if depth != fail_depth:
                return step

            def failing(*args, **kwargs):
                if threading.current_thread().name.startswith(
                        "pggan-precompile"):
                    raise ValueError("stub step failed")
                return step(*args, **kwargs)
            return failing
        monkeypatch.setattr(builder, "_raw_step", raw)
    trainer = Trainer(G, D, builder, state, None, None, lambda: None,
                      tick_nimg_default=10 ** 6, steps_per_dispatch=spd)
    metrics = _Metrics()
    for p in (plugins.DepthManager(
                  _stage_data(trainer), None, 2, minibatch_default=4,
                  minibatch_overrides={}, tick_kimg_default=1000,
                  lod_training_nimg=32, lod_transition_nimg=32,
                  precompile_ahead=precompile),
              plugins.LRScheduler(2e-3, 1e-3, rampup_kimg=0.05), metrics):
        trainer.register_plugin(p)
    return trainer, metrics, builder


@pytest.mark.parametrize("spd", [1, 4])
def test_trainer_with_precompile_equals_without(spd):
    """Bit for bit, with the interpreter switching threads often, so that
    the precompile thread interleaves with the training thread."""
    runs = {}
    interval = sys.getswitchinterval()
    for precompile in (False, True):
        trainer, metrics, builder = _progressive(spd, precompile)
        sys.setswitchinterval(1e-5)
        try:
            trainer.run(total_kimg=0.16)  # depth 0 to 2's stable stage
        finally:
            sys.setswitchinterval(interval)
        builder.join_precompiles()
        assert trainer.depth == 2 and trainer.iterations == 40
        runs[precompile] = (_state_dict(trainer.state), metrics.rows,
                            set(builder._steps), builder)
    (off, off_rows, off_keys, _), (on, on_rows, on_keys, b) = (
        runs[False], runs[True])
    _assert_state_equal(on, off)
    assert [i for i, _ in on_rows] == [i for i, _ in off_rows]
    for (_, a), (_, c) in zip(on_rows, off_rows):
        assert torch.equal(a, c)
    # the precompiles made ready every step the run dispatched, and the
    # targets it did not dispatch (the single steps of stages that groups
    # cover whole), each done without a failure
    assert off_keys <= on_keys
    assert {k[:3] for k in on_keys} == {
        (0, 4, False), (1, 4, True), (1, 4, False), (2, 4, True),
        (2, 4, False)}
    assert on_keys == ({k[:3] for k in on_keys} | (
        {k[:3] + (spd,) for k in on_keys} if spd > 1 else set()))
    assert set(b._precompiles) == on_keys - off_keys
    assert all(f.done() and f.exception() is None
               for f in b._precompiles.values())


def test_raw_steps_run_one_at_a_time(monkeypatch):
    """The warm-ups on the precompile thread and the training thread's
    steps never run a raw step at once: the gradient penalty's
    ``input_grad_only()`` flag is process-wide, and two threads inside it
    would leave it set (every later weight gradient of the conv Functions
    zero). The flag is clear after the run."""
    from pggan_tpu_torch import losses
    from pggan_tpu_torch.ops import conv3x3
    inside, most = [0], [0]
    real = losses.input_grad_only

    @contextlib.contextmanager
    def watched():
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        try:
            time.sleep(0.002)  # room for another thread, were it let in
            with real():
                yield
        finally:
            inside[0] -= 1
    monkeypatch.setattr(losses, "input_grad_only", watched)
    trainer, _, builder = _progressive(1, True)
    trainer.run(total_kimg=0.16)
    builder.join_precompiles()
    assert trainer.iterations == 40 and most[0] == 1
    assert conv3x3._INPUT_GRAD_ONLY is False


def test_failed_precompile_raises_at_its_keys_first_dispatch(monkeypatch):
    trainer, metrics, builder = _progressive(1, True, fail_depth=1,
                                             monkeypatch=monkeypatch)
    with pytest.raises(RuntimeError,
                       match=r"precompile of step \(1, 4, True\) failed") \
            as info:
        trainer.run(total_kimg=0.16)
    assert isinstance(info.value.__cause__, ValueError)
    assert str(info.value.__cause__) == "stub step failed"
    # depth 0's 8 steps ran; the first dispatch at depth 1 raised
    assert trainer.depth == 1 and trainer.iterations == 8
    assert len(metrics.rows) == 8
    builder.join_precompiles(cancel=True)


def test_first_dispatch_waits_for_a_running_precompile(monkeypatch):
    G, D = _models()
    state, builder = init_state(G, D), TrainStepBuilder(G, D)
    gate, order = threading.Event(), []

    def slow(depth, batch, fade, state, group=None, scratch=None):
        gate.wait(timeout=60)
        order.append(("precompiled", (depth, batch, fade, group)))
    monkeypatch.setattr(builder, "precompile", slow)
    builder.precompile_ahead([(1, 4, True, None)], state)
    builder.precompile_ahead([(1, 4, False, None), (1, 4, True, None)], state)
    assert set(builder._precompiles) == {(1, 4, True), (1, 4, False)}
    threading.Timer(0.2, gate.set).start()
    t0 = time.perf_counter()
    builder.await_precompile((1, 4, False))  # queued second
    assert time.perf_counter() - t0 >= 0.15
    builder.join_precompiles()
    assert builder._worker is None
    # one after the other; a key already queued is not targeted twice
    assert order == [("precompiled", (1, 4, True, None)),
                     ("precompiled", (1, 4, False, None))]
    builder.await_precompile((1, 4, True))
    builder.await_precompile((5, 4, True))  # never targeted: no wait
    assert not builder._precompiles


def test_join_precompiles_cancel_drops_the_queued(monkeypatch):
    """``join_precompiles(cancel=True)`` waits for the running precompile
    and drops the queued ones, whose keys then take the route of a key
    never precompiled; a later ``precompile_ahead`` starts a new thread."""
    G, D = _models()
    state, builder = init_state(G, D), TrainStepBuilder(G, D)
    started, gate, order = threading.Event(), threading.Event(), []

    def slow(depth, batch, fade, state, group=None, scratch=None):
        started.set()
        gate.wait(timeout=60)
        order.append((depth, batch, fade))
    monkeypatch.setattr(builder, "precompile", slow)
    builder.precompile_ahead([(1, 4, True, None), (1, 4, False, None)], state)
    assert started.wait(timeout=60)
    threading.Timer(0.2, gate.set).start()
    builder.join_precompiles(cancel=True)
    assert order == [(1, 4, True)] and builder._worker is None
    assert set(builder._precompiles) == {(1, 4, True)}
    builder.await_precompile((1, 4, False))  # dropped: no wait, no error
    builder.precompile_ahead([(1, 4, False, None)], state)
    builder.join_precompiles()
    assert order == [(1, 4, True), (1, 4, False)]


def test_warm_up_under_a_group_makes_no_collective(monkeypatch):
    """Under a process group the warm-up runs the rank's batch alone: no
    gradient all-reduce, no metric mean, and a D without a group, with the
    reals' shapes of the rank's step (the pair pass off, as under the
    group)."""
    from pggan_tpu_torch.training import steps

    def collective(*args, **kwargs):
        raise AssertionError("a collective in the warm-up")
    monkeypatch.setattr(steps, "all_reduce_grads", collective)
    monkeypatch.setattr(steps, "global_mean", collective)
    G, D = _models()
    state = init_state(G, D, seed=2)
    before = _state_dict(state)
    builder = TrainStepBuilder(G, D)
    group = type("Group", (), {"world_size": 2, "rank": 0})()
    builder.group = D.group = group
    calls = []
    forward = type(D).forward

    def spy(self, x, *args, **kwargs):
        calls.append((self.group, kwargs.get("stat_groups"), x.shape[0]))
        return forward(self, x, *args, **kwargs)
    monkeypatch.setattr(type(D), "forward", spy)
    builder.precompile(1, 4, True, state)
    assert calls and all(g is None and sg is None and n == 4
                         for g, sg, n in calls)
    D.group = None
    _assert_state_equal(_state_dict(state), before)


def test_precompile_launches_count_apart(monkeypatch):
    """A launch on a stream registered in STREAM_COUNTS counts in that
    stream's counter, one under a capture in CAPTURED, any other in
    LAUNCHES (a stubbed launch)."""
    stub = _StubLibrary()
    monkeypatch.setattr(_build, "_lib", stub)
    monkeypatch.setattr(_build, "_ENTRY", {})
    for name in ("LAUNCHES", "CAPTURED"):
        monkeypatch.setattr(_build, name, _build.collections.Counter())
    warm = _build.collections.Counter()
    monkeypatch.setattr(_build, "STREAM_COUNTS", {9: warm})
    _no_guard(monkeypatch)
    for stream, capturing in ((9, False), (9, False), (9, True), (7, False)):
        monkeypatch.setattr(_build, "_current_stream", lambda d, s=stream: s)
        monkeypatch.setattr(_build, "_capturing", lambda c=capturing: c)
        _build.launch("avgpool2x", "pggan_avgpool2x", CUDA0, 1, 2, 1, 2, 3, 4)
    assert dict(warm) == {"avgpool2x": 2}
    assert dict(_build.CAPTURED) == {"avgpool2x": 1}
    assert dict(_build.LAUNCHES) == {"avgpool2x": 1}


def test_cli_precompile_ahead_equals_off(tmp_path, monkeypatch):
    flag = ["--DepthManager.precompile_ahead", "True"]
    done = []
    real = TrainStepBuilder.precompile

    def spy(self, depth, batch_size, fade, state, group=None, scratch=None):
        real(self, depth, batch_size, fade, state, group, scratch)
        done.append(((depth, batch_size, fade) + (
            () if group is None else (group,)),
            threading.current_thread().name))
    monkeypatch.setattr(TrainStepBuilder, "precompile", spy)
    off = cli.cli_main(_argv(tmp_path / "off", 0.2, items=1, raw=True))
    assert not done
    on = cli.cli_main(_argv(tmp_path / "on", 0.2, *flag, items=1, raw=True))
    # the run's precompiles ran on the precompile thread, which ended with
    # the run, and made ready the keys it dispatched
    assert on.builder._worker is None
    assert all(name.startswith("pggan-precompile") for _, name in done)
    assert set(off.builder._steps) <= {k for k, _ in done}
    assert all(f.exception() is None for f in on.builder._precompiles.values())
    assert (on.cur_nimg, on.iterations) == (off.cur_nimg, off.iterations)
    _assert_state_equal(_state_dict(on.state), _state_dict(off.state))
    for kind in ("generator", "discriminator"):
        (on_model, on_meta), (off_model, off_meta) = (
            checkpoint.load_model_snapshot(str(path)) for name in ("on", "off")
            for path in (tmp_path / name).glob(
                f"*/network-snapshot-{kind}-*.dat"))
        assert on_meta == off_meta
        for a, b in zip(on_model.state_dict().values(),
                        off_model.state_dict().values()):
            assert torch.equal(a, b)


def test_cli_failed_precompile_exits_with_its_error(tmp_path, monkeypatch):
    """A precompile that fails in a ``cli.train`` run raises at its key's
    first dispatch; the run's precompile thread has ended by the time the
    error leaves ``cli_main``, its queued precompiles dropped."""
    real = TrainStepBuilder.precompile
    builders = []

    def failing(self, depth, batch_size, fade, state, group=None,
                scratch=None):
        builders.append(self)
        if depth == 1:
            raise ValueError("stub precompile failed")
        real(self, depth, batch_size, fade, state, group, scratch)
    monkeypatch.setattr(TrainStepBuilder, "precompile", failing)
    with pytest.raises(RuntimeError, match=r"precompile of step \(1, ") \
            as info:
        cli.cli_main(_argv(tmp_path, 0.2, "--DepthManager.precompile_ahead",
                           "True", items=1, raw=True))
    assert str(info.value.__cause__) == "stub precompile failed"
    assert builders and builders[0]._worker is None
    assert not any(t.name.startswith("pggan-precompile") and t.is_alive()
                   for t in threading.enumerate())


def test_two_gloo_ranks_with_precompile_equal_without(tmp_path):
    outs = _run_ranks("precompile", tmp_path, {"runs": [
        ("off", _rank_argv(tmp_path / "off", 0.2)),
        ("on", _rank_argv(tmp_path / "on", 0.2,
                          "--DepthManager.precompile_ahead", "True"))]})
    for o in outs:
        assert o["on"]["collectives_off_the_training_thread"] == 0
        assert o["on"]["collectives"] == o["off"]["collectives"] > 0
        assert o["on"]["iterations"] == o["off"]["iterations"] > 0
        np.testing.assert_equal(o["on"]["state"], o["off"]["state"])
        assert o["on"]["precompiled"] >= {(0, 2, False), (1, 2, True)}
