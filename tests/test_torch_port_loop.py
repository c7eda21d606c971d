"""The port's training loop on the CPU against pggan_tpu's: the schedule,
the trainer with its plugin stack, the train CLI, its checkpoints and
resume.

- ``schedule.py``'s functions equal the JAX ones over a grid of nimg.
- The port's ``Trainer`` and the JAX ``Trainer`` (per-step dispatch), each
  with its own real plugin stack and the same stub step builder, call the
  step and the plugins in the same sequence with the same values.
- A tiny progressive run through ``python -m pggan_tpu_torch.cli.train``
  writes snapshots that the JAX ``load_snapshot`` reads, ``metrics.jsonl``
  and ``log.txt``; a resume restores the saved state bit for bit and
  carries the schedule on; a run to T/2 resumed to T equals a run to T
  bit for bit (one dataset item and the fade done on the device, so both
  runs see the same data: checkpoints hold no sampler position, and the
  loader's threads order batches freely).
- A JAX training state converted to the port's takes the same next step
  as the JAX one, with the same latents passed in (bars of
  tests/test_torch_port_train_step.py).

Runs are tiny (16 px, fmap 16, batch 4) and single-threaded: torch's
thread pool costs more than it gives at these sizes.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu import checkpoint as jckpt
from pggan_tpu.training import schedule as jschedule
from pggan_tpu.training import plugins as jplugins
from pggan_tpu.training.trainer import Trainer as JTrainer
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.cli import train as cli
from pggan_tpu_torch.training import TrainStepBuilder
from pggan_tpu_torch.training import init_state as port_init_state
from pggan_tpu_torch.training import plugins, schedule
from pggan_tpu_torch.training.trainer import Trainer

SMALL = ["--Generator.fmap_base", "64", "--Generator.fmap_max", "16",
         "--Generator.latent_size", "16", "--Discriminator.fmap_base", "64",
         "--Discriminator.fmap_max", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the schedule ----------------------------------------------------------------

NIMGS = [0, 1, 99, 100, 150, 199, 200, 333, 1000, 1599, 1600, 1700, 10**6]


@pytest.mark.parametrize("fn", ["depth_alpha_schedule", "stable_nimg_horizon",
                                "fade_nimg_horizon"])
@pytest.mark.parametrize("lod", [(100, 100), (100, 60), (60, 100)])
def test_schedule_laws_equal_jax(fn, lod):
    for nimg in NIMGS:
        for max_depth in (0, 3, 8):
            args = (nimg, max_depth, *lod)
            assert getattr(schedule, fn)(*args) == \
                getattr(jschedule, fn)(*args), args


def test_schedule_tables_equal_jax():
    for name in ("MINIBATCH_DEFAULT", "MINIBATCH_OVERRIDES",
                 "TICK_KIMG_DEFAULT", "TICK_KIMG_OVERRIDES",
                 "LOD_TRAINING_NIMG", "LOD_TRANSITION_NIMG"):
        assert getattr(schedule, name) == getattr(jschedule, name), name
    for depth in range(10):
        assert schedule.minibatch_for_depth(depth) == \
            jschedule.minibatch_for_depth(depth)
        assert schedule.tick_kimg_for_depth(depth, 7, {2: 3}) == \
            jschedule.tick_kimg_for_depth(depth, 7, {2: 3})
        for alpha in (0.0, 0.25, 1.0):
            assert schedule.lod_value(depth, alpha, 10, 2) == \
                jschedule.lod_value(depth, alpha, 10, 2)
    for nimg in NIMGS:
        for ramp in (0.0, 0.5, 40.0):
            assert schedule.lr_rampup(nimg, ramp) == \
                jschedule.lr_rampup(nimg, ramp)


# -- the trainer and its plugins against the JAX trainer ----------------------

class _StubBuilder:
    """A step builder without models: each step records its key and inputs
    and returns losses computed from its call count."""

    mesh = None
    group = None

    def __init__(self, as_metric):
        self.calls = []
        self.as_metric = as_metric

    def step_fn(self, depth, batch, fade):
        def step(state, reals, alpha, lr_d, lr_g):
            self.calls.append((depth, batch, fade, float(alpha), float(lr_d),
                               float(lr_g), tuple(reals.shape)))
            n = len(self.calls)
            metrics = {k: self.as_metric(np.float32(v)) for k, v in
                       (("G_loss", n * 0.5), ("D_loss", n * -0.25),
                        ("D_real", n / 3.0), ("D_fake", 1.0 / n))}
            return metrics if state is None else (state, metrics)
        return step


class _Experiment:
    """A CometML-like sink for ``MetricsExporter``."""

    def __init__(self, out):
        self.out = out

    def log_metric(self, name, value):
        self.out.append((name, value))

    def log_epoch_end(self, epoch):
        self.out.append(("epoch_end", epoch))


LOG_FIELDS = ["tick_stat", "kimg_stat", "depth", "alpha", "lod",
              "minibatch_size", "G_loss", "D_loss", "D_real", "D_fake"]


def _drive(trainer_cls, plugin_mod, builder, state, record,
           steps_per_dispatch=1):
    """A stub run: depth 0-2, tiny stages, the real plugins (those that need
    no model; the wall-clock monitor's values left out), every plugin call
    recorded with the trainer's clock, and the log lines and exported
    metrics."""
    def make_iter(bs):
        while True:
            yield np.zeros((bs, 4, 4, 1), np.float32)

    logger = type("ListLogger", (plugin_mod.Logger,), {
        "log": lambda self, msg: record.append(("log", msg))})(LOG_FIELDS)

    trainer = trainer_cls(torch.nn.Linear(1, 1), None, builder, state, None,
                          None, lambda: None, tick_nimg_default=30,
                          steps_per_dispatch=steps_per_dispatch)
    plugs = [plugin_mod.DepthManager(make_iter, None, 2, minibatch_default=4,
                                     minibatch_overrides={1: 3, 2: 2},
                                     tick_kimg_default=0.025,
                                     tick_kimg_overrides={2: 0.015},
                                     lod_training_nimg=20,
                                     lod_transition_nimg=20, max_lod=4,
                                     depth_offset=2),
             *[plugin_mod.EfficientLossMonitor(i, n) for i, n in
               enumerate(("G_loss", "D_loss", "D_real", "D_fake"))],
             plugin_mod.AbsoluteTimeMonitor(),
             plugin_mod.LRScheduler(2e-3, 1e-3, rampup_kimg=0.05), logger,
             plugin_mod.MetricsExporter(
                 ["G_loss.epoch_mean", "D_fake.epoch_mean", "kimg_stat",
                  "depth", "alpha"], experiment=_Experiment(record))]
    for p in plugs:
        trainer.register_plugin(p)
        for queue in ("iteration", "epoch", "end"):
            method = getattr(p, queue, None)
            if method is None:
                continue

            def logged(t, *args, _m=method, _q=queue, _p=p):
                _m(t, *args)
                record.append((type(_p).__name__, _q, t, trainer.iterations,
                               trainer.depth, trainer.alpha,
                               trainer.minibatch_size, trainer.lr_d,
                               trainer.lr_g, trainer.cur_nimg,
                               trainer.cur_tick,
                               {k: v["epoch_mean"] for k, v in
                                trainer.stats.items()
                                if isinstance(v, dict) and "epoch_mean" in v}))
            setattr(p, queue, logged)
    trainer.run(total_kimg=0.13)
    return trainer


def test_trainer_and_plugins_follow_the_jax_trainer():
    """Same step keys and inputs, same plugin calls in the same order at
    the same clock, same loss tick means."""
    got, want = [], []
    port = _StubBuilder(torch.tensor)
    _drive(Trainer, plugins, port, None, got)
    ref = _StubBuilder(lambda v: v)
    _drive(JTrainer, jplugins, ref, "state", want)
    assert port.calls == ref.calls
    assert {c[:3] for c in port.calls} == {
        (0, 4, False), (1, 3, True), (1, 3, False), (2, 2, True),
        (2, 2, False)}
    assert len(got) == len(want)
    assert sum(r[0] == "log" for r in got) >= 4  # one line a tick
    for a, b in zip(got, want):
        assert a[:11] == b[:11]
        if len(a) > 11:
            assert a[11].keys() == b[11].keys()
            for k in a[11]:
                np.testing.assert_equal(a[11][k], b[11][k])


def test_loss_monitor_means_with_reused_output_tensors():
    """A graphed step returns the same tensors every step and overwrites
    them at the next replay: the tick mean still covers every step."""
    trainer = Trainer(torch.nn.Linear(1, 1), None, None, None, None, None,
                      None)
    mon = plugins.EfficientLossMonitor(1, "D_loss")
    trainer.register_plugin(mon)
    out = torch.zeros(())
    values = [0.5, -1.25, 3.0, 7.75]
    for i, v in enumerate(values, 1):
        out.fill_(v)  # the "replay"
        mon.iteration(i, None, out)
    out.fill_(100.0)
    mon.epoch(1)
    assert trainer.stats["D_loss"]["epoch_mean"] == np.mean(values)



# -- the train CLI ---------------------------------------------------------------

def _argv(root, total_kimg, *extra, items=8, raw=False):
    return ["--device", "cpu", "--dataset_class", "SyntheticDataset",
            "--SyntheticDataset.resolution", "16",
            "--SyntheticDataset.num_channels", "1",
            "--SyntheticDataset.num_items", str(items), *SMALL,
            "--result_dir", str(root), "--total_kimg", str(total_kimg),
            "--DepthManager.lod_training_nimg", "32",
            "--DepthManager.lod_transition_nimg", "32",
            "--DepthManager.tick_kimg_default", "0.05",
            "--DepthManager.tick_kimg_overrides", "{}",
            "--DepthManager.minibatch_default", "4",
            "--num_data_workers", "1", "--lr_rampup_kimg", "0.1",
            "--device_input_prep", str(raw), *extra]


def _files(run, pattern):
    return sorted(glob.glob(os.path.join(run, pattern)))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A tiny progressive run, depth 0 to 2 on 16 px data, with images."""
    root = tmp_path_factory.mktemp("cli")
    trainer = cli.cli_main(_argv(
        root, 0.2, "--postprocessors", "['ImageSaver']",
        "--ImageSaver.resolution", "16",
        "--SaverPlugin.network_snapshot_ticks", "2",
        "--image_snapshot_ticks", "2"))
    return root, _files(root, "001-*")[0], trainer


def test_cli_run_writes_what_jax_reads(cli_run):
    root, run, trainer = cli_run
    assert trainer.depth == 2 and trainer.cur_nimg >= 200
    assert trainer.cur_tick >= 4
    log = open(os.path.join(run, "log.txt")).read()
    ticks = [line for line in log.splitlines() if line.startswith("tick ")]
    assert len(ticks) == trainer.cur_tick
    rows = [json.loads(line) for line in open(os.path.join(run,
                                                           "metrics.jsonl"))]
    assert len(rows) == trainer.cur_tick and rows[-1]["depth"] == 2
    assert all(np.isfinite(rows[-1][f"{k}.epoch_mean"]) for k in cli.LOSSES)
    assert _files(run, "fakes_*.png")
    for name, model in (("generator", trainer.state.G),
                        ("discriminator", trainer.state.D)):
        path, = _files(run, f"network-snapshot-{name}-*.dat")
        jmodel, params, meta = jckpt.load_snapshot(path)
        assert meta["depth"] == 2 and meta["alpha"] == 1.0
        assert jckpt.model_config(jmodel) == checkpoint.model_config(model)
        to_jax = (checkpoint.params_to_jax if name == "generator"
                  else checkpoint.d_params_to_jax)
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(to_jax(model))):
            np.testing.assert_array_equal(a, b)


def test_cli_resume_restores_the_state_bit_for_bit(cli_run, tmp_path):
    root, run, trainer = cli_run
    path, = _files(run, "training-state-*.dat")
    sd, nimg, iterations, base_time = checkpoint.load_training_state(path)
    assert (nimg, iterations) == (trainer.cur_nimg, trainer.iterations)
    assert base_time > 0
    params = cli.get_structured_params(vars(cli.build_parser().parse_args(
        _argv(root, 0.3, "--resume_network", "latest"))))
    resumed, logger, total = cli.build(params)
    try:
        _assert_state_equal(checkpoint.training_state_dict(resumed.state), sd)
        assert (resumed.cur_nimg, resumed.iterations) == (nimg, iterations)
        assert (resumed.depth, resumed.alpha) == schedule.depth_alpha_schedule(
            nimg, 2, 32, 32)
        assert resumed.stats["minibatch_size"] == 4
        resumed.run(total)
        assert resumed.cur_nimg >= 300 and resumed.iterations > iterations
    finally:
        resumed.dataiter.close()
        logger.close()


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_state_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """T/2 and a resume to T equals one run to T, bit for bit: parameters,
    both Adams, the generator state and the clock."""
    whole = cli.cli_main(_argv(tmp_path / "a", 0.2, items=1, raw=True))
    cli.cli_main(_argv(tmp_path / "b", 0.1, items=1, raw=True))
    cont = cli.cli_main(_argv(tmp_path / "b", 0.2, "--resume_network",
                              "latest", items=1, raw=True))
    assert (cont.cur_nimg, cont.iterations) == (whole.cur_nimg,
                                                whole.iterations)
    _assert_state_equal(checkpoint.training_state_dict(cont.state),
                        checkpoint.training_state_dict(whole.state))


def test_unknown_dataset_class_names_the_ports(tmp_path):
    argv = _argv(tmp_path, 0.1)
    argv[argv.index("SyntheticDataset")] = "NoSuchDataset"
    with pytest.raises(SystemExit, match="Unknown dataset_class "
                       "'NoSuchDataset'; available: DefaultImageFolderDataset, "
                       "DepthDataset, FolderDataset, H5Dataset, OldH5Dataset, "
                       "SoundImageDataset, SyntheticDataset, _H5Window"):
        cli.cli_main(argv)


def test_train_cli_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tmp_path, 0.1)
    del argv[:2]  # no --device: the default, cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.cli_main(argv)


def test_train_cli_defaults_match_jax_cli():
    from pggan_tpu.cli import train as jcli
    mine = dict(cli.default_params)
    assert mine.pop("device") == "cuda"
    assert mine == dict(jcli.default_params)


# -- a JAX training state, converted ------------------------------------------

def test_jax_training_state_converts_and_steps_alike():
    """One JAX step makes a state with moments and a count; converted, the
    port's next step equals the JAX package's next step."""
    import test_torch_port_train_step as ts
    from pggan_tpu.training.state import init_state as jinit
    gp0, dp0, rng = ts._jax_init()
    builder = ts._jax_builder(1, True)
    state = jinit(gp0, dp0, builder.optimizer, jnp.asarray(rng))
    state = state._replace(g_ema=state.g_params)
    depth, batch = 2, 2
    draws = ts._jax_draws(jnp.asarray(rng), 2, batch, 1)
    for i in range(2):
        reals = ts._reals(depth, batch, seed=20 + i)
        if i == 1:  # convert the state after one JAX step
            sd = checkpoint.training_state_from_jax(
                jax.tree_util.tree_map(np.array, state))
            assert sd["g_opt"]["count"] == 1 and sd["generator"] is None
            G, D = ts._port_models()
            pstate = port_init_state(G, D, g_ema=True)
            checkpoint.restore_training_state(pstate, sd)
            port = TrainStepBuilder(G, D, g_ema_beta=0.9)
            got = port.step_fn(depth, batch, True)(
                pstate, torch.from_numpy(reals), 0.5, ts.LR, ts.LR,
                noise=ts._replay(draws[3:]))
        state, want = builder.step_fn(depth, batch, True)(
            state, reals, np.float32(0.5), np.float32(ts.LR),
            np.float32(ts.LR))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=ts.LOSS_RTOL, atol=1e-6, err_msg=k)
    assert int(pstate.g_opt.count) == int(state.g_opt.count) == 2
    for got_tree, want_tree in (
            (checkpoint.params_to_jax(G), state.g_params),
            (checkpoint.d_params_to_jax(D), state.d_params),
            (checkpoint.params_to_jax(pstate.g_ema), state.g_ema)):
        for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                        jax.tree_util.tree_leaves(want_tree)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=2 * ts.LR + 1e-7)


def test_trace_profiler_writes_a_trace(tmp_path):
    trainer = Trainer(torch.nn.Linear(1, 1), None, None, None, None, None,
                      None)
    prof = plugins.TraceProfiler(str(tmp_path / "prof"), start_iteration=2,
                                 num_iterations=2)
    trainer.register_plugin(prof)
    for i in range(1, 6):
        torch.ones(8).sum()
        trainer.call_plugins("iteration", i)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_generate_samples_and_pickles_match_jax(tmp_path):
    from pggan_tpu.models import Generator as JG
    from pggan_tpu.utils import misc as jmisc
    from pggan_tpu_torch.models import Generator
    from pggan_tpu_torch.utils import misc
    g = JG((4, 1, 16, 16), fmap_base=64, fmap_max=16, latent_size=16)
    params = jax.tree_util.tree_map(np.asarray, g.init(jax.random.PRNGKey(3)))
    G = Generator(**jckpt.model_config(g))
    G.load_state_dict(checkpoint.params_from_jax(params))
    z = np.random.RandomState(1).randn(3, 16).astype(np.float32)
    want = jmisc.generate_samples(g, params, z, 2, 0.5)
    got = misc.generate_samples(G, z, 2, 0.5)
    assert got.shape == want.shape == (3, 1, 16, 16)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=3e-4)
    misc.save_pkl(tmp_path / "x.pkl", {"a": 1})
    assert jmisc.load_pkl(tmp_path / "x.pkl") == misc.load_pkl(
        tmp_path / "x.pkl") == {"a": 1}
    assert misc.params_to_str({"a": [1]}) == jmisc.params_to_str({"a": [1]})
    for _ in range(2):
        assert os.path.basename(misc.create_result_subdir(
            str(tmp_path / "r"), "e")) == os.path.basename(
            jmisc.create_result_subdir(str(tmp_path / "j"), "e"))
