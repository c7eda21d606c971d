"""The port's data parallelism (``pggan_tpu_torch/parallel/mesh.py`` and the
modules that use it) against the JAX package on the CPU.

Several ranks run as gloo processes over a ``FileStore`` in ``tmp_path``
(``torch_port_ranks.py``, which imports no JAX), each on its shard of the
inputs that this process makes with numpy and runs through the JAX package
on the global batch. Bars:
- the batch policy, the loader's shards: equal to JAX's;
- the global minibatch stddev over 2 ranks: value, gradient and gradient
  of the gradient within rtol 1e-5 of JAX's on the global batch;
- the 2-rank train step against the JAX step on the global batch (JAX's
  unfused G on its plain XLA path, as tests/test_torch_port_train_step.py
  explains), the JAX draws split by rank: losses rtol 1e-4; updated
  parameters rtol 1e-3, atol 1e-5 (JAX's own sharded-vs-single bar,
  tests/test_train_step.py); both ranks' states bit-equal;
- the train CLI over 2 ranks: rank 0 alone writes, the clock counts the
  global batch, and T/2 + a resume to T equals one run to T bit for bit;
  it refuses ``--num_devices`` other than the world size and
  ``--data_parallel False`` over several ranks; a gloo group on the card
  refuses CUDA graphs;
- ``sample_images(devices=[cpu, cpu])`` against JAX's ``sample_images``
  over its 8 devices within the network bar (rtol 2e-3, atol 3e-4);
- kernels launch on their tensors' device (no card: a stubbed launch).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_port_train_step as ts
from pggan_tpu import checkpoint as jckpt
from pggan_tpu import sampling as jsampling
from pggan_tpu.data import datasets as jdatasets
from pggan_tpu.data import loader as jloader
from pggan_tpu.models import Generator as JGenerator
from pggan_tpu.ops.primitives import minibatch_stddev as jstddev
from pggan_tpu.parallel import mesh as jmesh
from pggan_tpu_torch import checkpoint, sampling
from pggan_tpu_torch.data import datasets, loader
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops import _build, conv3x3, conv_chain, resample
from pggan_tpu_torch.parallel import mesh
from test_torch_port_chain_tiles import _StubLibrary

RANKS = Path(__file__).with_name("torch_port_ranks.py")
REPO = RANKS.parent.parent
WORLD = 2


def _run_ranks(case, tmp_path, inp, timeout=240):
    """Run ``case`` on WORLD gloo ranks; each rank's results, in order. A
    rank that fails ends the others."""
    work = tmp_path / case
    work.mkdir()
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    logs = [open(work / f"log{r}.txt", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), case, str(work), str(r), str(WORLD)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {r} of {case}: rc {p.returncode}\n"
                                   + (work / f"log{r}.txt").read_text()[-4000:])
    outs = []
    for r in range(WORLD):
        with open(work / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _assert_equal(a, b, skip=()):
    assert a.keys() == b.keys()
    for k in a:
        if k in skip:
            continue
        if isinstance(a[k], dict):
            _assert_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- kernels launch on their tensors' device ------------------------------------

def test_launch_asks_for_the_stream_of_the_tensors_device(monkeypatch):
    """With device 0 current and the kernel's tensors on device 1, the
    launch makes device 1 current, runs on device 1's stream, and gives
    device 0 back."""
    current, log = [0], []

    @contextlib.contextmanager
    def guard(device):
        log.append(("guard", device))
        prev, current[0] = current[0], device
        try:
            yield
        finally:
            current[0] = prev

    def stream(device):
        log.append(("stream", device, current[0]))
        return 100 + device

    stub = _StubLibrary()
    monkeypatch.setattr(_build, "_lib", stub)
    monkeypatch.setattr(_build, "_ENTRY", {})
    monkeypatch.setattr(_build, "_device_guard", guard)
    monkeypatch.setattr(_build, "_current_stream", stream)
    monkeypatch.setattr(_build, "_capturing", lambda: current[0] == 1)
    monkeypatch.setattr(_build, "LAUNCHES", _build.collections.Counter())
    monkeypatch.setattr(_build, "CAPTURED", _build.collections.Counter())
    _build.launch("avgpool2x", "pggan_avgpool2x", torch.device("cuda", 1),
                  1, 2, 1, 2, 3, 4)
    assert log == [("guard", 1), ("stream", 1, 1)]
    call, = [e for e in stub.log if e[0] == "call"]
    assert call[2] == (1, 2, 1, 2, 3, 4, 101)
    assert current[0] == 0
    # the capture status is read on the tensors' device too
    assert dict(_build.CAPTURED) == {"avgpool2x": 1} and not _build.LAUNCHES


def _x(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)
                       ).to(dtype)


WRAPPERS = {
    "conv3x3": lambda: conv3x3._conv_fwd(_x(2, 4, 8, 16), _x(3, 3, 8, 16)),
    "conv3x3_act": lambda: conv3x3._act_fwd(
        _x(2, 4, 8, 16), _x(3, 3, 8, 16), _x(16), 0.2),
    "conv3x3_act_pn": lambda: conv3x3._act_pn_fwd(
        _x(2, 4, 8, 16), _x(3, 3, 8, 16), _x(16), 0.2, 1e-8),
    "conv3x3_dw": lambda: conv3x3._dw_fwd(_x(2, 4, 8, 16), _x(2, 4, 6, 16)),
    "conv3x3_chain": lambda: conv_chain.conv3x3_chain(
        _x(2, 4, 8, 16), _x(3, 3, 8, 16), _x(16), _x(3, 3, 16, 8), _x(8),
        slope=0.2, pn_eps=None),
    "upsample2x": lambda: resample._upsample(_x(2, 4, 8, 16), 1, 3),
    "avgpool2x": lambda: resample._pool(_x(2, 4, 8, 16), 1, 3),
    "upsample2x_bf16": lambda: resample._upsample(
        _x(2, 4, 8, 16, dtype=torch.bfloat16), 1, 3),
    "avgpool2x_bf16": lambda: resample._pool(
        _x(2, 4, 8, 16, dtype=torch.bfloat16), 1, 3),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_each_wrapper_launches_on_its_tensors_device(monkeypatch, name):
    """Every kernel wrapper hands its input's device to the launch."""
    seen = []
    monkeypatch.setattr(_build, "use_plain", lambda x: False)
    monkeypatch.setattr(_build, "launch",
                        lambda count, fn, device, *args: seen.append(
                            (count, device)))
    WRAPPERS[name]()
    assert seen == [(name, torch.device("cpu"))]


# -- the batch policy and the loader's shards -------------------------------------

OVERRIDES = {6: 14, 7: 6, 8: 3}  # the 1024 px config's (plugins.py:19-20)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8])
def test_batch_policy_equals_jax(world):
    jax_mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    for default, overrides in ((16, OVERRIDES), (3, {}), (8, {2: 5})):
        assert mesh.fit_minibatch_to_mesh(default, overrides, world) == \
            jmesh.fit_minibatch_to_mesh(default, overrides, jax_mesh)
    for batch in range(1, 20):
        errors = []
        for check in (lambda: mesh.check_batch_divisible(batch, world),
                      lambda: jmesh.check_batch_divisible(batch, jax_mesh)):
            try:
                check()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        assert errors[0] == errors[1], batch


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_loader_shards_equal_jax(num_shards):
    """Each rank's shard: the JAX loader's index space, the same batches
    from the same seed, and together the shards cover every item once."""
    port = datasets.SyntheticDataset(resolution=8, num_channels=1,
                                     num_items=7, seed=3)
    ref = jdatasets.SyntheticDataset(resolution=8, num_channels=1,
                                     num_items=7, seed=3)
    port.model_depth = ref.model_depth = 1
    spaces = []
    for shard in range(num_shards):
        its = [mod.DataIterator(ds, 2, num_workers=1, seed=5 + shard,
                                raw=True, shard_index=shard,
                                num_shards=num_shards)
               for mod, ds in ((loader, port), (jloader, ref))]
        try:
            np.testing.assert_array_equal(its[0].sampler.indices,
                                          its[1]._indices)
            spaces.append(its[0].sampler.indices)
            for _ in range(5):
                np.testing.assert_array_equal(next(its[0]), next(its[1]))
        finally:
            for it in its:
                it.close()
    np.testing.assert_array_equal(np.sort(np.concatenate(spaces)),
                                  np.arange(7))


def test_shard_batch_takes_this_ranks_slice():
    x = np.arange(24).reshape(2, 6, 2)
    for rank in range(3):
        got = mesh.shard_batch(x, mesh.Group(rank, 3, torch.device("cpu")),
                               batch_dim=1)
        np.testing.assert_array_equal(got, x[:, 2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="divisible by the data axis size 4"):
        mesh.shard_batch(x, mesh.Group(0, 4, torch.device("cpu")), 1)


# -- the global minibatch stddev ----------------------------------------------------

def test_global_stddev_equals_jax_to_the_second_derivative(tmp_path):
    rng = np.random.RandomState(0)
    x, c, v = (rng.randn(4, 3, 4, 4).astype(np.float32) for _ in range(3))
    c = np.concatenate([c, rng.randn(4, 1, 4, 4).astype(np.float32)], 1)

    def nhwc(a):
        return np.ascontiguousarray(a.transpose(0, 2, 3, 1))

    def loss(xx):
        return (jstddev(xx) * nhwc(c)).sum()

    want_out = np.asarray(jstddev(nhwc(x))).transpose(0, 3, 1, 2)
    want_g = np.asarray(jax.grad(loss)(nhwc(x))).transpose(0, 3, 1, 2)
    want_h = np.asarray(jax.grad(
        lambda xx: (jax.grad(loss)(xx) * nhwc(v)).sum())(nhwc(x))
    ).transpose(0, 3, 1, 2)
    outs = _run_ranks("stddev", tmp_path, {"x": x, "c": c, "v": v})
    for name, want in (("out", want_out), ("g", want_g), ("h", want_h)):
        got = np.concatenate([o[name] for o in outs])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    # the statistic is the global batch's, on both ranks
    assert outs[0]["out"][0, 3, 0, 0] == outs[1]["out"][0, 3, 0, 0]


# -- the train step over 2 ranks ---------------------------------------------------

DEPTH, BATCH = 2, 4  # the global batch


@pytest.mark.parametrize("repeats,fades", [(1, (True, False)), (2, (True,))])
def test_two_rank_step_equals_the_jax_global_batch_step(tmp_path, repeats,
                                                        fades):
    gp0, dp0, key = ts._jax_init()
    builder = ts._jax_builder(repeats, False)
    state = ts.init_state(gp0, dp0, builder.optimizer, jax.numpy.asarray(key))
    draws = ts._jax_draws(jax.numpy.asarray(key), len(fades), BATCH, repeats)
    reals = [ts._reals(DEPTH, BATCH, repeats, seed=10 + i)
             for i in range(len(fades))]
    want = []
    for fade, r in zip(fades, reals):
        state, m = builder.step_fn(DEPTH, BATCH, fade)(
            state, r, np.float32(0.5 if fade else 1.0), np.float32(ts.LR),
            np.float32(ts.LR))
        want.append({k: float(v) for k, v in m.items()})
    G, D = ts._port_models()
    outs = _run_ranks("step", tmp_path, {
        "shape": ts.SHAPE, "g_kw": ts.G_KW, "d_kw": ts.D_KW,
        "g_sd": {k: v.numpy() for k, v in G.state_dict().items()},
        "d_sd": {k: v.numpy() for k, v in D.state_dict().items()},
        "repeats": repeats, "depth": DEPTH, "fades": fades, "reals": reals,
        "draws": draws, "lr": ts.LR})
    # every rank took the same updates; each drew from its own generator
    _assert_equal(outs[0]["state"], outs[1]["state"], skip=("generator",))
    assert not np.array_equal(outs[0]["state"]["generator"],
                              outs[1]["state"]["generator"])
    for o in outs:
        assert o["no_grad"]
        for i, (got, ref) in enumerate(zip(o["metrics"], want)):
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=ts.LOSS_RTOL,
                                           atol=1e-6, err_msg=f"step {i} {k}")
    sd = outs[0]["state"]
    for what, params, ref, to_jax, module in (
            ("G", sd["G"], state.g_params, checkpoint.params_to_jax, G),
            ("D", sd["D"], state.d_params, checkpoint.d_params_to_jax, D)):
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in params.items()})
        got = jax.tree_util.tree_leaves_with_path(to_jax(module))
        for (path, a), b in zip(got, jax.tree_util.tree_leaves(
                jax.device_get(ref))):
            np.testing.assert_allclose(
                a, b, rtol=1e-3, atol=1e-5,
                err_msg=f"{what}{jax.tree_util.keystr(path)}")


# -- the train CLI over 2 ranks ----------------------------------------------------

def _argv(root, total_kimg, *extra):
    """The tiny run of tests/test_torch_port_loop.py, global batch 4 (2 a
    rank), 2 items (one a rank's shard, so the data is the same whatever
    the sampler's state)."""
    return ["--device", "cpu", "--dataset_class", "SyntheticDataset",
            "--SyntheticDataset.resolution", "16",
            "--SyntheticDataset.num_channels", "1",
            "--SyntheticDataset.num_items", "2",
            "--Generator.fmap_base", "64", "--Generator.fmap_max", "16",
            "--Generator.latent_size", "16", "--Discriminator.fmap_base",
            "64", "--Discriminator.fmap_max", "16",
            "--result_dir", str(root), "--total_kimg", str(total_kimg),
            "--DepthManager.lod_training_nimg", "32",
            "--DepthManager.lod_transition_nimg", "32",
            "--DepthManager.tick_kimg_default", "0.05",
            "--DepthManager.tick_kimg_overrides", "{}",
            "--DepthManager.minibatch_default", "4",
            "--num_data_workers", "1", "--lr_rampup_kimg", "0.1",
            "--device_input_prep", "True", "--num_devices", str(WORLD),
            *extra]


def test_train_cli_over_two_ranks(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    outs = _run_ranks("cli", tmp_path, {"runs": [
        ("whole", _argv(a, 0.2, "--postprocessors", "['ImageSaver']",
                        "--ImageSaver.resolution", "16")),
        ("half", _argv(b, 0.1)),
        ("resumed", _argv(b, 0.2, "--resume_network", "latest"))]})
    for rank, o in enumerate(outs):
        whole, resumed = o["whole"], o["resumed"]
        # the clock counts the global batch: 4 images an iteration
        assert whole["cur_nimg"] == 4 * whole["iterations"] >= 200
        assert (whole["minibatch_size"], whole["dataiter_batch"]) == (4, 2)
        # T/2 and a resume to T is one run to T, on every rank
        assert (resumed["cur_nimg"], resumed["iterations"]) == (
            whole["cur_nimg"], whole["iterations"])
        _assert_equal(resumed["state"], whole["state"])
    _assert_equal(outs[0]["whole"]["state"], outs[1]["whole"]["state"],
                  skip=("generator",))
    # rank 0 alone wrote: one run directory a run
    runs_a, runs_b = (sorted(glob.glob(str(d / "0*"))) for d in (a, b))
    assert len(runs_a) == 1 and len(runs_b) == 2
    run = runs_a[0]
    log = open(os.path.join(run, "log.txt")).read()
    assert "Data-parallel over 2 rank(s) (gloo)" in log
    rows = [json.loads(line) for line in open(os.path.join(run,
                                                           "metrics.jsonl"))]
    assert rows[-1]["kimg_stat"] == outs[0]["whole"]["cur_nimg"] / 1000
    assert glob.glob(os.path.join(run, "fakes_*.png"))
    state_path, = glob.glob(os.path.join(run, "training-state-*.dat"))
    sd, nimg, _, _ = checkpoint.load_training_state(state_path)
    assert nimg == outs[0]["whole"]["cur_nimg"]
    for rank, o in enumerate(outs):
        np.testing.assert_array_equal(sd["rank_generators"][rank],
                                      o["whole"]["state"]["generator"])


@pytest.mark.parametrize("flags,env,match", [
    (["--num_devices", "2"], {}, "--num_devices 2, but 1 rank"),
    (["--data_parallel", "False"], {"WORLD_SIZE": "2"},
     "--data_parallel False, but launched over several ranks"),
])
def test_train_cli_refuses_a_launch_it_cannot_train(tmp_path, monkeypatch,
                                                    flags, env, match):
    from pggan_tpu_torch.cli import train as cli
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = _argv(tmp_path, 0.1)
    del argv[argv.index("--num_devices"):][:2]
    with pytest.raises(SystemExit, match=match):
        cli.cli_main(argv + flags)


def test_gloo_on_the_card_refuses_cuda_graphs():
    """Gloo's collectives cannot be captured: a gloo group on the card
    takes the eager route, and asking for graphs raises."""
    from pggan_tpu_torch.models import Discriminator
    from pggan_tpu_torch.training import TrainStepBuilder

    class GlooOnTheCard(mesh.Group):
        backend = "gloo"

    G, D = Generator(ts.SHAPE, **ts.G_KW), Discriminator(ts.SHAPE, **ts.D_KW)
    group = GlooOnTheCard(0, 2, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cannot be captured"):
        TrainStepBuilder(G, D, group=group)
    assert TrainStepBuilder(G, D, cuda_graphs=False, group=group).group \
        is group and D.group is group


# -- sampling over several devices -------------------------------------------------

SAMPLE_SHAPE = (8, 3, 128, 128)
SAMPLE_KW = dict(fmap_base=512, fmap_max=32, latent_size=16)


@pytest.mark.parametrize("num,minibatch,alpha,chain", [
    (1, 0, 1.0, True),    # fewer samples than devices
    (5, 2, 0.5, True),    # a remainder chunk, fade
    (5, 2, 1.0, False),
    (7, 3, 1.0, True),    # chunks that do not split evenly
])
def test_sampling_over_two_devices_equals_jax_over_eight(num, minibatch,
                                                         alpha, chain):
    g = JGenerator(SAMPLE_SHAPE, **SAMPLE_KW, pallas_tail=False)
    params = jax.tree_util.tree_map(np.asarray,
                                    g.init(jax.random.PRNGKey(2)))
    assert jax.device_count() == 8
    want = jsampling.sample_images(g, params, 5, alpha, num,
                                   minibatch=minibatch,
                                   rng=np.random.RandomState(4))
    G = Generator(**{**jckpt.model_config(g), "pallas_tail": True,
                     "inference_chain": chain})
    G.load_state_dict(checkpoint.params_from_jax(params))
    assert G._pallas_tail_start(5) == 4
    got = sampling.sample_images(G, 5, alpha, num, minibatch=minibatch,
                                 rng=np.random.RandomState(4),
                                 devices=["cpu", "cpu"])
    assert got.shape == want.shape == (num, 128, 128, 3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=3e-4)
    one = sampling.sample_images(G, 5, alpha, num, minibatch=minibatch,
                                 rng=np.random.RandomState(4))
    np.testing.assert_allclose(got, one, rtol=2e-3, atol=3e-4)
