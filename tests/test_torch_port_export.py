"""The port's generator export (``pggan_tpu_torch/export.py`` and
``cli/export.py``) on the CPU, mirroring the seven cases of
``tests/test_export.py``: a snapshot freezes into a ``torch.export``
artifact whose loaded program matches the direct forward of the same
tail-off G bit for bit on the same device. Beside them: the artifact runs
in a process that imports neither package, and the export agrees with the
JAX package's ``G.apply`` on the same weights within float32 tolerance.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pggan_tpu.models import Generator as JG
from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.export import (
    export_generator,
    exportable,
    load_exported,
    program_platform,
    save_exported,
)
from pggan_tpu_torch.models import Generator
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops import resample as R

SHAPE = (1, 3, 32, 32)
KW = dict(latent_size=16, fmap_base=64, fmap_max=32)


@pytest.fixture(scope="module")
def tiny_g():
    return Generator(SHAPE, **KW, generator=torch.Generator().manual_seed(0))


def _z(n, seed=3):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(n, 16).astype(np.float32))


def _direct(G, z, depth, alpha):
    with torch.no_grad():
        return exportable(G)(z, depth, alpha, alpha < 1.0)


def _targets(program) -> set:
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function"}


def test_roundtrip_matches_direct_forward(tiny_g, tmp_path):
    depth, alpha, batch = 2, 0.5, 4
    program = export_generator(tiny_g, depth, alpha, batch)
    artifact, sidecar = save_exported(program, str(tmp_path / "gen"),
                                      {"depth": depth})
    assert artifact.endswith(".pt2") and os.path.exists(artifact)
    z = _z(batch)
    got = load_exported(artifact).module()(z)
    assert got.shape == (batch, 16, 16, 3)  # depth 2 -> 16 px, NHWC
    # same device, same operators: bit for bit
    assert torch.equal(got, _direct(tiny_g, z, depth, alpha))
    info = json.load(open(sidecar))
    assert info["depth"] == depth and info["platforms"] == ["cpu"]
    assert info["artifact_bytes"] == os.path.getsize(artifact)
    assert "float32[4,16]" in info["in_avals"][0]
    assert info["out_avals"] == ["float32[4,16,16,3]"]


def test_batch_is_frozen(tiny_g):
    program = export_generator(tiny_g, 1, 1.0, 4)
    with pytest.raises(Exception, match="shape|size|dim|expected"):
        program.module()(torch.zeros(5, 16))


def test_cli_end_to_end(tiny_g, tmp_path):
    snap = tmp_path / "network-snapshot-generator-000001.dat"
    checkpoint.save_snapshot(str(snap), tiny_g, depth=2, alpha=1.0)
    from pggan_tpu_torch.cli.export import cli_main
    out = tmp_path / "exported" / "gen"
    cli_main(["--generator_path", str(snap), "--out", str(out),
              "--batch", "3", "--verify", "True", "--device", "cpu"])
    assert os.path.exists(str(out) + ".pt2")
    meta = json.load(open(str(out) + ".json"))
    assert meta["resolution"] == 16 and meta["batch"] == 3
    assert meta["source_snapshot"] == str(snap)
    assert meta["compute_dtype"] == "float32"


def test_polymorphic_batch_serves_any_size(tiny_g, tmp_path):
    """batch <= 0 exports the symbolic dimension 'b': one artifact, any
    serving batch, values identical to the direct forward."""
    program = export_generator(tiny_g, 2, 1.0, -1)
    artifact, sidecar = save_exported(program, str(tmp_path / "poly"),
                                      {"batch": "polymorphic"})
    info = json.load(open(sidecar))
    assert "b,16" in info["in_avals"][0] and info["batch"] == "polymorphic"
    run = load_exported(artifact).module()
    for n in (4, 7):
        z = _z(n, n)
        assert torch.equal(run(z), _direct(tiny_g, z, 2, 1.0))


def test_kernel_free_graph(monkeypatch):
    """The artifact holds PyTorch operators only: the export turns the
    tail off and runs the NCHW upsample on its plain version, so no kernel
    wrapper is reached while tracing; an ordinary forward of the same G on
    the card route still launches the upsample kernel (the launch stubbed
    here: no card). Values match the in-process G with its tail."""
    G = Generator((1, 3, 128, 128), latent_size=16, fmap_base=512,
                  fmap_max=32, fused_scale=False,
                  generator=torch.Generator().manual_seed(1))
    assert G._pallas_tail_start(5) is not None  # tail active at 128 px
    calls = []
    upsample = R._upsample
    monkeypatch.setattr(R, "_upsample",
                        lambda *a: calls.append("upsample") or upsample(*a))
    program = export_generator(G, 5, 0.5, 2)
    assert calls == []
    assert all(t.startswith("aten.") for t in _targets(program)), \
        _targets(program)
    z = _z(2)
    with torch.no_grad():
        want = G(z, 5, 0.5)  # the tail, on the kernels' plain versions
    np.testing.assert_allclose(program.module()(z).numpy(), want.numpy(),
                               atol=1e-4, rtol=1e-4)
    assert calls  # the in-process forward reached the wrapper
    launched = []
    monkeypatch.setattr(_build, "use_plain", lambda x: False)
    monkeypatch.setattr(_build, "launch", lambda name, *a: launched.append(
        name))
    with torch.no_grad():
        exportable(G)(z, 5, 0.5)
    assert launched.count("upsample2x") == 5  # four stages and the fade


def test_stable_alpha_exports_fade_free_graph(tiny_g):
    """alpha == 1 exports the fade-free graph (no prev-toRGB upsample and
    blend), with values equal to the fade graph's at alpha 1."""
    stable = export_generator(tiny_g, 2, 1.0, 2)
    fade = export_generator(tiny_g, 2, 0.5, 2)
    assert "aten.repeat_interleave.self_int" not in _targets(stable)
    assert "aten.repeat_interleave.self_int" in _targets(fade)
    z = _z(2, 1)
    with torch.no_grad():
        want = exportable(tiny_g)(z, 2, 1.0, fade=True)
    np.testing.assert_allclose(stable.module()(z).numpy(), want.numpy(),
                               atol=1e-6)


def test_platforms(tiny_g, tmp_path, monkeypatch):
    """One platform per artifact: the device's, or one asked for; two
    raise, and 'cuda' raises on a host with no card (the move puts the
    weights on the card)."""
    program = export_generator(tiny_g, 1, 1.0, 2, platforms=("cpu",))
    artifact, _ = save_exported(program, str(tmp_path / "cpu_gen"), {})
    assert program_platform(load_exported(artifact)) == "cpu"
    with pytest.raises(ValueError, match="one device"):
        export_generator(tiny_g, 1, 1.0, 2, platforms=("cpu", "cuda"))
    with pytest.raises(ValueError, match="one of"):
        export_generator(tiny_g, 1, 1.0, 2, platforms=("tpu",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        export_generator(tiny_g, 1, 1.0, 2, platforms=("cuda",))


def test_artifact_runs_without_either_package(tiny_g, tmp_path):
    """The deployment claim: a process that imports torch alone loads and
    runs the artifact, and imports neither package."""
    artifact, _ = save_exported(export_generator(tiny_g, 2, 0.5, 3),
                                str(tmp_path / "gen"), {})
    z = _z(3)
    np.save(tmp_path / "z.npy", z.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        f"p = torch.export.load({artifact!r})\n"
        f"z = torch.from_numpy(np.load({str(tmp_path / 'z.npy')!r}))\n"
        "out = p.module()(z)\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.detach().numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pggan_tpu', 'pggan_tpu_torch', 'jax')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH="")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path), timeout=120)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  _direct(tiny_g, z, 2, 0.5).numpy())


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_export_matches_jax_apply(alpha):
    g = JG(SHAPE, **KW)
    params = jax.tree_util.tree_map(np.asarray, g.init(jax.random.PRNGKey(0)))
    G = Generator(SHAPE, **KW)
    G.load_state_dict(checkpoint.params_from_jax(params))
    z = _z(4)
    want = np.asarray(jax.jit(lambda zz: g.apply(
        params, zz, 3, np.float32(alpha), fade=alpha < 1.0))(z.numpy()))
    got = export_generator(G, 3, alpha, 4).module()(z).numpy()
    # tests/test_torch_port_generator.py's NET_TOL: f32 convs summing in
    # another order over four stages
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=3e-4)
