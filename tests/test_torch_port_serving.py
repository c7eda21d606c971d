"""The port's serving path on the CPU: the tail at 256 px against JAX,
snapshots across packages, chunked sampling, the generate CLI, and the
port's independence from JAX. Network tolerance as in
tests/test_torch_parity_network.py: rtol 2e-3, atol 3e-4.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pggan_tpu import checkpoint as jckpt
from pggan_tpu import sampling as jsampling
from pggan_tpu.models import Generator as JGenerator
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.cli import generate as cli
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.sampling import sample_images

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(fmap_base=512, fmap_max=32, latent_size=16)
SHAPE = (8, 3, 128, 128)
NET_TOL = dict(rtol=2e-3, atol=3e-4)


def _jax_model_and_params(shape=SHAPE, **kw):
    g = JGenerator(shape, **kw)
    return g, jax.tree_util.tree_map(np.asarray,
                                     g.init(jax.random.PRNGKey(1)))


def _port_from_jax(g, params, **kw) -> Generator:
    G = Generator(**{**jckpt.model_config(g), **kw})
    G.load_state_dict(checkpoint.params_from_jax(params))
    return G


def _port_snapshot(tmp_path, depth=5, alpha=1.0, name="000100", **kw):
    G = Generator(SHAPE, **SMALL, **kw,
                  generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / f"network-snapshot-generator-{name}.dat")
    checkpoint.save_snapshot(path, G, depth, alpha)
    return G, path


def test_tail_matches_jax_at_256px_with_the_upsample_kernel():
    """Depth 6 at 256 px: the stage-5 upsample input is (N, 128, 16, 128),
    so the JAX side runs its Pallas upsample2x_nhcw (interpret mode), and
    the chain and conv kernels; the port runs their plain versions, chain
    on and off, against one JAX reference (fade, the longest graph)."""
    from pggan_tpu.ops import pallas_resample
    g, params = _jax_model_and_params((2, 3, 256, 256), fmap_base=1024,
                                      fmap_max=32, latent_size=16)
    assert g._pallas_tail_start(6) == 4
    assert pallas_resample.up_supported((2, 128, 16, 128))
    z = np.random.RandomState(5).randn(2, 16).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, zz: g.apply(p, zz, 6, 0.7, True))(
        params, z))
    G = _port_from_jax(g, params)
    for chain in (True, False):
        G.inference_chain = chain
        with torch.no_grad():
            got = G(torch.from_numpy(z), 6, 0.7, True).numpy()
        assert got.shape == (2, 256, 256, 3)
        np.testing.assert_allclose(got, want, **NET_TOL,
                                   err_msg=f"chain={chain}")


# -- (d) snapshots load across packages -------------------------------------

def test_jax_snapshot_loads_in_port(tmp_path):
    g, params = _jax_model_and_params(**SMALL, fused_scale=False)
    path = str(tmp_path / "network-snapshot-generator-000012.dat")
    jckpt.save_snapshot(path, g, params, 3, 0.5)
    G, meta = checkpoint.load_snapshot(path, device="cpu")
    assert meta == {"depth": 3, "alpha": 0.5, "model_class": "Generator"}
    assert checkpoint.model_config(G) == jckpt.model_config(g)
    got = sample_images(G, 3, 0.5, 4, rng=np.random.RandomState(0))
    z = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    want = np.asarray(g.apply(params, z, 3, 0.5))
    np.testing.assert_allclose(got, want, **NET_TOL)


def test_port_snapshot_loads_in_jax(tmp_path):
    G, path = _port_snapshot(tmp_path, depth=4, alpha=0.25)
    g, params, meta = jckpt.load_snapshot(path)
    assert meta == {"depth": 4, "alpha": 0.25, "model_class": "Generator"}
    assert jckpt.model_config(g) == checkpoint.model_config(G)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(checkpoint.params_to_jax(G))):
        np.testing.assert_array_equal(a, b)
    z = np.random.RandomState(1).randn(2, 16).astype(np.float32)
    want = np.asarray(g.apply(params, z, 4, 0.25))
    with torch.no_grad():
        got = G(torch.from_numpy(z), 4, 0.25).numpy()
    np.testing.assert_allclose(got, want, **NET_TOL)


def test_snapshot_rejects_other_model_classes(tmp_path):
    import pickle
    path = tmp_path / "network-snapshot-discriminator-000001.dat"
    path.write_bytes(pickle.dumps({"model_class": "Discriminator"}))
    with pytest.raises(ValueError, match="Generator snapshots only"):
        checkpoint.load_snapshot(str(path))


def test_resolve_latest_prefers_ema_twin(tmp_path):
    run = tmp_path / "001-exp"
    run.mkdir()
    for kimg in (5, 40):
        (run / f"network-snapshot-generator-{kimg:06}.dat").write_bytes(b"")
    (run / "network-snapshot-generator-ema-000040.dat").write_bytes(b"")
    want = str(run / "network-snapshot-generator-ema-000040.dat")
    assert checkpoint.resolve_generator_path("latest", str(tmp_path)) == want
    assert checkpoint.resolve_generator_path(
        "latest", str(tmp_path), prefer_ema=False).endswith("-000040.dat")
    assert checkpoint.resolve_generator_path("x.dat") == "x.dat"
    assert checkpoint.snapshot_kimg(want) == 40
    with pytest.raises(SystemExit):
        checkpoint.resolve_generator_path("latest", str(tmp_path / "none"))


# -- (e) sample_images -----------------------------------------------------

@pytest.mark.parametrize("depth,alpha", [(5, 1.0), (5, 0.5), (2, 0.8)])
def test_chunked_sampling_equals_one_shot(tmp_path, depth, alpha):
    """Padded fixed-size chunks serve the same images as one forward, up
    to the CPU conv's batch-size-dependent sum order (the JAX package's
    tests/test_sampling.py bar)."""
    G, _ = _port_snapshot(tmp_path, inference_chain=True)
    one = sample_images(G, depth, alpha, 5, rng=np.random.RandomState(7))
    chunked = sample_images(G, depth, alpha, 5, minibatch=2,
                            rng=np.random.RandomState(7))
    assert one.shape == chunked.shape == (5,) + (4 * 2 ** depth,) * 2 + (3,)
    np.testing.assert_allclose(chunked, one, rtol=2e-3, atol=1e-4)


def test_sampling_matches_jax_sample_images():
    """Same latent draws, same chunking: the JAX package's sample_images
    (sharded over the test platform's 8 CPU devices) and the port's agree."""
    g, params = _jax_model_and_params(**SMALL)
    want = jsampling.sample_images(g, params, 2, 0.6, 5, minibatch=3,
                                   rng=np.random.RandomState(4))
    got = sample_images(_port_from_jax(g, params), 2, 0.6, 5, minibatch=3,
                        rng=np.random.RandomState(4))
    np.testing.assert_allclose(got, want, **NET_TOL)


def test_sample_images_rejects_empty_requests():
    G = Generator(SHAPE, **SMALL)
    with pytest.raises(ValueError):
        sample_images(G, 1, 1.0, 0)


# -- (f) the generate CLI ------------------------------------------------------

def test_generate_cli_writes_images(tmp_path):
    _, path = _port_snapshot(tmp_path, depth=5, alpha=0.5)
    samples = tmp_path / "samples"
    _build.LAUNCHES.clear()
    out = cli.cli_main([
        "--generator_path", path, "--device", "cpu", "--num_samples", "3",
        "--minibatch", "2", "--description", "demo",
        "--postprocessors", "['ImageSaver']",
        "--ImageSaver.samples_path", str(samples)])
    assert out.shape == (3, 3, 128, 128) and np.isfinite(out).all()
    assert (samples / "fakes_demo.png").stat().st_size > 0
    assert not _build.LAUNCHES  # CPU serving takes the plain versions


def test_generate_cli_serves_latest_and_chain_flag(tmp_path):
    run = tmp_path / "002-exp"
    run.mkdir()
    _port_snapshot(run, depth=5, alpha=1.0, name="000200")
    common = ["--generator_path", "latest", "--result_dir", str(tmp_path),
              "--device", "cpu", "--num_samples", "2", "--random_seed", "3"]
    a = cli.cli_main(common)
    b = cli.cli_main(common + ["--inference_chain", "False"])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_generate_cli_default_device_needs_cuda(tmp_path, monkeypatch):
    """--device defaults to cuda and never falls back to the CPU."""
    _, path = _port_snapshot(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.default_params["device"] == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.cli_main(["--generator_path", path])


def test_generate_cli_defaults_match_jax_cli():
    from pggan_tpu.cli import generate as jcli
    mine = dict(cli.default_params)
    assert mine.pop("device") == "cuda"
    assert mine == jcli.default_params


# -- (g) the port runs without JAX -------------------------------------------

def test_port_imports_neither_jax_nor_pggan_tpu():
    code = (
        "import pkgutil, sys, importlib, pggan_tpu_torch\n"
        "import pggan_tpu_torch.cli.generate\n"
        "for m in pkgutil.walk_packages(pggan_tpu_torch.__path__, "
        "'pggan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = {'pggan_tpu_torch.' + m for m in ('cli.eval', 'metrics.swd', "
        "'metrics.msssim', 'ops.stft', 'data.native', 'data.audio_io', "
        "'export', 'cli.export', 'utils.profiling', 'parallel', "
        "'parallel.mesh', 'cli.convert')}\n"
        "assert new <= set(sys.modules), new - set(sys.modules)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pggan_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_port_sources_have_no_jax_imports():
    import re
    pat = re.compile(r"^\s*(import|from) (jax|pggan_tpu)\b", re.M)
    files = list((REPO / "pggan_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result here (no CUDA
    card), and likewise in a directory that holds nothing else of the
    repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
