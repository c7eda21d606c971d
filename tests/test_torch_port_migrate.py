"""The two migration paths into the port without JAX, on the CPU.

- A training state that the JAX package's ``save_training_state`` wrote is
  read by the port's ``load_training_state`` in a process where importing
  ``jax``, ``optax`` or ``pggan_tpu`` raises; restored into port models,
  its tensors equal ``training_state_from_jax`` of the JAX-unpickled state
  bit for bit. A pickle that names any other global is refused.
- ``cli.train --resume_network`` on a JAX run continues its image clock,
  iteration count and Adam counts.
- ``python -m pggan_tpu_torch.cli.convert`` on reference-structured torch
  modules (``tests/test_convert_torch_snapshot.py``'s) writes what the JAX
  converter writes: parameters bit for bit, config, depth and alpha; the
  JAX ``load_snapshot`` reads it; the port's model from it matches the
  torch module's forward within that test's tolerance.
"""

import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pggan_tpu import checkpoint as jckpt
from pggan_tpu.models import Discriminator as JD
from pggan_tpu.models import Generator as JG
from pggan_tpu.training.state import init_state as jinit
from pggan_tpu.training.state import make_optimizer
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.cli import convert
from pggan_tpu_torch.cli import train as cli
from pggan_tpu_torch.models import Discriminator, Generator
from test_torch_port_loop import _argv
from tests.test_convert_torch_snapshot import (
    FMAPS,
    SHAPE,
    _load_converter,
    _reference_randomize,
)
from tests.test_torch_parity_network import TDiscriminator, TGenerator, to_nhwc

REPO = Path(__file__).resolve().parents[1]
CFG = dict(fmap_base=64, fmap_max=16)  # test_torch_port_loop's SMALL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run(run_dir, nimg=96, iterations=24):
    """A JAX run's files at ``nimg``: its generator and discriminator
    snapshots and its training state, with Adam moments and counts that a
    run would have (drawn from a seed) and a G EMA."""
    G = JG((1, 1, 16, 16), latent_size=16, **CFG)
    D = JD((1, 1, 16, 16), **CFG)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    state = jinit(G.init(keys[0]), D.init(keys[1]), make_optimizer(),
                  keys[2])
    rng = np.random.RandomState(7)

    def draw(tree, scale, power=1):
        return jax.tree_util.tree_map(
            lambda x: (rng.randn(*np.shape(x)) * scale).astype(
                np.float32) ** power, tree)
    count = np.asarray(iterations, np.int32)
    state = state._replace(
        g_opt=state.g_opt._replace(count=count, mu=draw(state.g_params, .1),
                                   nu=draw(state.g_params, .01, 2)),
        d_opt=state.d_opt._replace(count=count, mu=draw(state.d_params, .1),
                                   nu=draw(state.d_params, .01, 2)),
        g_ema=draw(state.g_params, 1.0))
    os.makedirs(run_dir, exist_ok=True)
    kimg = f"{nimg // 1000:06}"
    for name, model, params in (("generator", G, state.g_params),
                                ("discriminator", D, state.d_params)):
        jckpt.save_snapshot(
            os.path.join(run_dir, f"network-snapshot-{name}-{kimg}.dat"),
            model, params, 2, 0.0)
    path = os.path.join(run_dir, f"training-state-{kimg}.dat")
    jckpt.save_training_state(path, state, nimg, iterations, 3.5)
    return path


def _without_generator(sd):
    return {k: v for k, v in sd.items() if k not in ("generator",
                                                       "rank_generators")}


def _assert_tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


# a process in which jax, optax and pggan_tpu cannot be imported: it loads
# the JAX state, restores it into port models and pickles both dicts
_NO_JAX = """
import importlib.abc, pickle, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'pggan_tpu'):
            raise ImportError('no ' + name + ' here')
sys.meta_path.insert(0, Refuse())
import torch
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.training import init_state
src, out = sys.argv[1:]
sd, nimg, iterations, base_time = checkpoint.load_training_state(src)
G = Generator((1, 1, 16, 16), latent_size=16, fmap_base=64, fmap_max=16)
D = Discriminator((1, 1, 16, 16), fmap_base=64, fmap_max=16)
state = init_state(G, D, g_ema=True)
checkpoint.restore_training_state(state, sd)
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'pggan_tpu')]
assert not bad, bad
with open(out, 'wb') as f:
    pickle.dump((sd, checkpoint.training_state_dict(state), nimg, iterations,
                 base_time), f)
print('resumed without jax')
"""


def test_jax_state_loads_without_jax_bit_for_bit(tmp_path):
    path = _jax_run(str(tmp_path / "run"))
    out = tmp_path / "port.pkl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX, path, str(out)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "without jax" in res.stdout, res.stderr
    with open(out, "rb") as f:
        loaded, restored, nimg, iterations, base_time = pickle.load(f)
    with open(path, "rb") as f:
        jstate = pickle.load(f)["state"]  # with JAX and pggan_tpu here
    want = checkpoint.training_state_from_jax(jstate)
    assert (nimg, iterations, base_time) == (96, 24, 3.5)
    _assert_tree_equal(loaded, want)
    _assert_tree_equal(_without_generator(restored),
                       _without_generator(want))
    assert restored["g_opt"]["count"] == restored["d_opt"]["count"] == 24


class _Shell:
    """Pickles as a call of ``os.system``."""

    def __reduce__(self):
        return os.system, ("true",)


@pytest.mark.parametrize("foreign, name", [
    (datetime.timedelta(seconds=1), "datetime.timedelta"),
    (_Shell(), ".system"),
])
def test_a_foreign_global_is_refused(tmp_path, foreign, name):
    path = tmp_path / "training-state-000000.dat"
    with open(path, "wb") as f:
        pickle.dump({"framework": "pggan_tpu", "state": foreign,
                     "cur_nimg": 0, "iterations": 0}, f)
    with pytest.raises(pickle.UnpicklingError,
                       match=f"may not name .*{name}"):
        checkpoint.load_training_state(str(path))


def test_train_cli_resumes_a_jax_run(tmp_path):
    path = _jax_run(str(tmp_path / "000-jax"))
    with open(path, "rb") as f:
        want = checkpoint.training_state_from_jax(pickle.load(f)["state"])
    params = cli.get_structured_params(vars(cli.build_parser().parse_args(
        _argv(tmp_path, 0.146, "--resume_network", "latest",
              "--g_ema_beta", "0.9"))))
    trainer, logger, total = cli.build(params)
    try:
        assert (trainer.cur_nimg, trainer.iterations) == (96, 24)
        assert (trainer.depth, trainer.alpha) == (2, 0.0)
        _assert_tree_equal(
            _without_generator(checkpoint.training_state_dict(trainer.state)),
            _without_generator(want))
        trainer.run(total)
    finally:
        trainer.dataiter.close()
        logger.close()
    steps = trainer.iterations - 24
    assert trainer.cur_nimg == 96 + 4 * steps == 148  # one tick: 50 images
    assert trainer.cur_tick == 1
    assert int(trainer.state.g_opt.count) == int(trainer.state.d_opt.count) \
        == 24 + steps


# -- the reference snapshot converter ------------------------------------------

def _reference_module(kind):
    """A reference-structured module at SHAPE with the reference's init."""
    if kind == "generator":
        module = TGenerator(SHAPE, latent_size=16, **FMAPS)
        _reference_randomize(module, 0)
        module.latent_size = 16
        module.depth, module.alpha = 2, 0.4
        return module
    module = TDiscriminator(SHAPE, **FMAPS)
    _reference_randomize(module, 7)
    module.depth, module.alpha = 3, 1.0
    return module


@pytest.mark.parametrize("kind", ["generator", "discriminator"])
def test_convert_cli_writes_what_the_jax_converter_writes(tmp_path, kind):
    module = _reference_module(kind)
    src = str(tmp_path / f"network-snapshot-{kind}-000123.dat")
    torch.save(module, src)
    want_path, got_path = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    assert _load_converter().convert(src, want_path) == kind
    convert.main(["--torch_snapshot", src, "--out", got_path])
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    for k in ("model_class", "config", "depth", "alpha"):
        assert got[k] == want[k], k
    a, b = (jax.tree_util.tree_leaves(t) for t in (got["params"],
                                                   want["params"]))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    jmodel, params, meta = jckpt.load_snapshot(got_path)
    assert jckpt.model_config(jmodel) == want["config"]
    assert (meta["depth"], meta["alpha"]) == (want["depth"], want["alpha"])

    model = checkpoint.load_model_snapshot(got_path)[0]
    assert isinstance(model, Generator if kind == "generator"
                      else Discriminator)
    rng = np.random.RandomState(1 if kind == "generator" else 2)
    for depth in range(model.max_depth + 1):
        res = 4 * 2 ** depth
        x = (rng.randn(2, 16) if kind == "generator"
             else rng.randn(3, res, res, 3)).astype(np.float32)
        tx = torch.from_numpy(x if kind == "generator" else np.transpose(
            x, (0, 3, 1, 2)).copy())
        for alpha in (0.0, 0.4, 1.0):
            module.depth, module.alpha = depth, alpha
            with torch.no_grad():
                ref = module(tx).numpy()
                out = model(torch.from_numpy(x), depth, alpha).numpy()
            if kind == "generator":
                ref = to_nhwc(ref)
            np.testing.assert_allclose(
                out, ref, rtol=2e-3, atol=2e-4,
                err_msg=f"converted {kind} depth={depth} alpha={alpha}")
