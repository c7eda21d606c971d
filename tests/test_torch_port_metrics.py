"""The port's SWD and MS-SSIM on the CPU against pggan_tpu's, on the same
seeded images, with JAX's random draws passed in where the metric draws:
the pyramid ops, the patch gather, the descriptor normalization and the
sliced Wasserstein distance (rtol 1e-5), the whole SWD per level
(relative 1e-4), its design properties (exactly zero on identical sets,
the same score at any minibatch), MS-SSIM and its pairwise mean (1e-5),
and ``cli.eval --device cpu`` end to end, in history mode, and resuming an
interrupted history.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.cli import eval as jeval
from pggan_tpu_torch.checkpoint import save_snapshot
from pggan_tpu_torch.cli import eval as cli
from pggan_tpu_torch.models import Generator

jswd = importlib.import_module("pggan_tpu.metrics.swd")
jms = importlib.import_module("pggan_tpu.metrics.msssim")
swd = importlib.import_module("pggan_tpu_torch.metrics.swd")
ms = importlib.import_module("pggan_tpu_torch.metrics.msssim")

RTOL = 1e-5


def _images(n=4, size=32, c=3, seed=0, noise=None):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, size, size, c)).astype(np.float32)
    if noise is None:
        return a
    return a, np.clip(a + noise * rng.randn(*a.shape), -1, 1).astype(
        np.float32)


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def jax_draws(key, shape, nhoods, size=7, repeats=4, dirs=128, min_res=16):
    """pggan_tpu's draws for ``swd(..., key)`` (metrics/swd.py:253-262,
    :113-194), in the port's ``swd_draws`` layout."""
    n, h, w, c = shape
    k_patch, k_dirs = jax.random.split(key)
    positions, directions = [], []
    for lv in range(jswd._n_levels(min(h, w), min_res)):
        ys, xs = [], []
        for j in range(n):
            k = jax.random.fold_in(jax.random.fold_in(k_patch, j), lv)
            ky, kx = jax.random.split(k)
            ys.append(jax.random.randint(ky, (nhoods,), 0,
                                         (h >> lv) - size + 1))
            xs.append(jax.random.randint(kx, (nhoods,), 0,
                                         (w >> lv) - size + 1))
        positions.append(tuple(torch.from_numpy(np.array(np.stack(v)))
                               .long() for v in (ys, xs)))
        ds = []
        for k in jax.random.split(jax.random.fold_in(k_dirs, lv), repeats):
            d = jax.random.normal(k, (size * size * c, dirs), jnp.float32)
            ds.append(d / (jnp.linalg.norm(d, axis=0, keepdims=True)
                           + 1e-12))
        directions.append(torch.from_numpy(np.array(np.stack(ds))))
    return {"positions": positions, "dirs": directions, "nhood_size": size}


# -- pyramid, patches, normalization, sliced W1 ---------------------------------

@pytest.mark.parametrize("c", [1, 3])
def test_pyramid_ops_match_jax(c):
    x = _images(n=2, size=32, c=c, seed=1)
    t = torch.from_numpy(x)
    _close(swd._blur5(t, 4.0), jswd._blur5(jnp.asarray(x), 4.0))
    _close(swd.pyr_down(t), jswd.pyr_down(jnp.asarray(x)))
    _close(swd.pyr_up(t), jswd.pyr_up(jnp.asarray(x)))
    got = swd.laplacian_levels(t, 3)
    want = jswd.laplacian_levels(jnp.asarray(x), 3)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w)


def test_patches_and_normalization_match_jax():
    x = _images(n=3, size=16, seed=2)
    keys = jax.vmap(lambda j: jax.random.fold_in(jax.random.PRNGKey(4), j))(
        jnp.arange(3, dtype=jnp.uint32))
    want = np.asarray(jswd._extract_patches(jnp.asarray(x), keys, 5, 7))
    ys, xs = [], []
    for k in keys:
        ky, kx = jax.random.split(k)
        ys.append(jax.random.randint(ky, (5,), 0, 10))
        xs.append(jax.random.randint(kx, (5,), 0, 10))
    got = swd._extract_patches(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(np.array(np.stack(ys))).long(),
        torch.from_numpy(np.array(np.stack(xs))).long(), 7)
    np.testing.assert_array_equal(got.numpy(), want)
    _close(swd._normalize_descriptors(got * 3 + 1, 7, 3),
           jswd._normalize_descriptors(jnp.asarray(want) * 3 + 1, 7, 3))


def test_sliced_wasserstein_matches_jax():
    rng = np.random.RandomState(3)
    a, b = (rng.randn(64, 12).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)
    dirs = np.stack([np.asarray(d / (jnp.linalg.norm(d, axis=0,
                                                     keepdims=True) + 1e-12))
                     for d in (jax.random.normal(k, (12, 8), jnp.float32)
                               for k in jax.random.split(key, 3))])
    got = swd.sliced_wasserstein(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(dirs))
    _close(got, jswd.sliced_wasserstein(jnp.asarray(a), jnp.asarray(b), key,
                                        3, 8))
    assert float(swd.sliced_wasserstein(torch.from_numpy(a),
                                        torch.from_numpy(a),
                                        torch.from_numpy(dirs))) == 0.0
    with pytest.raises(ValueError, match="descriptor clouds"):
        swd.sliced_wasserstein(torch.zeros(3, 4), torch.zeros(2, 4),
                               torch.from_numpy(dirs))


# -- the whole SWD ---------------------------------------------------------------

@pytest.mark.parametrize("size,c,minibatch", [(32, 3, 2), (64, 1, 4)])
def test_swd_matches_jax_with_its_draws(size, c, minibatch):
    """Per level, relative 1e-4."""
    reals, fakes = _images(n=4, size=size, c=c, seed=4, noise=0.3)
    kw = dict(nhoods_per_image=16, dir_repeats=2, dirs_per_repeat=16)
    key = jax.random.PRNGKey(7)
    want = jswd.swd(reals, fakes, key, minibatch=minibatch, **kw)
    draws = jax_draws(key, reals.shape, 16, repeats=2, dirs=16)
    got = swd.swd_from_draws(reals, fakes, draws, minibatch=minibatch,
                             device="cpu")
    assert list(got) == list(want) == [*swd.swd_levels(size), "avg"]
    for lv in want:
        assert abs(got[lv] - want[lv]) <= 1e-4 * abs(want[lv]), lv


def test_swd_design_properties():
    """Exactly zero on identical sets; the same score at any minibatch;
    the same draws from the same seed."""
    reals, fakes = _images(n=4, size=32, seed=5, noise=0.5)
    kw = dict(nhoods_per_image=8, dir_repeats=2, dirs_per_repeat=8,
              device="cpu")
    zero = swd.swd(reals, reals, **kw)
    assert all(v == 0.0 for v in zero.values())
    scores = [swd.swd(reals, fakes, torch.Generator().manual_seed(1),
                      minibatch=mb, **kw) for mb in (1, 3, 4)]
    assert scores[0] == scores[1] == scores[2]
    assert all(v > 0 for v in scores[0].values())
    a = swd.swd_draws(reals.shape, torch.Generator().manual_seed(2))
    b = swd.swd_draws(reals.shape, torch.Generator().manual_seed(2))
    for (ya, xa), (yb, xb) in zip(a["positions"], b["positions"]):
        assert torch.equal(ya, yb) and torch.equal(xa, xb)
        assert int(ya.max()) <= 32 - 7 and int(ya.min()) >= 0


def test_swd_guards_match_jax():
    for kw in (dict(min_res=5), dict(min_res=64)):
        with pytest.raises(ValueError) as port_err:
            swd.swd_draws((2, 32, 32, 3), **kw)
        with pytest.raises(ValueError) as jax_err:
            jswd.swd(np.zeros((2, 32, 32, 3)), np.zeros((2, 32, 32, 3)),
                     **kw)
        assert str(port_err.value) == str(jax_err.value)
    for res in (16, 64, 1024):
        assert swd.swd_levels(res) == jswd.swd_levels(res)


# -- MS-SSIM ---------------------------------------------------------------------

@pytest.mark.parametrize("size", [11, 24, 48, 200])
def test_msssim_matches_jax(size):
    a, b = _images(n=2, size=size, seed=6, noise=0.2)
    _close(ms.msssim(a, b, device="cpu"), jms.msssim(a, b))
    assert ms.n_scales(size) == jms.n_scales(size)


def test_pairwise_msssim_is_its_pairs_mean():
    """The pairing is the generator's permutation; the score is the mean of
    JAX's msssim over those pairs (1e-5)."""
    imgs = _images(n=7, size=24, seed=7)
    perm = torch.randperm(6, generator=torch.Generator().manual_seed(3))
    perm = perm.numpy()
    want = float(np.mean(jms.msssim(imgs[perm[:3]], imgs[perm[3:]])))
    for mb in (1, 2, 32):
        got = ms.pairwise_msssim(imgs, torch.Generator().manual_seed(3),
                                 minibatch=mb, device="cpu")
        assert abs(got - want) <= RTOL
    with pytest.raises(ValueError, match="11-tap window"):
        ms.msssim(imgs[:1, :8, :8], imgs[:1, :8, :8], device="cpu")


# -- cli.eval ------------------------------------------------------------------

def _snapshot(path, depth, alpha=1.0, seed=0):
    G = Generator((1, 3, 32, 32), fmap_base=32, fmap_max=8, latent_size=8,
                  generator=torch.Generator().manual_seed(seed))
    save_snapshot(str(path), G, depth, alpha)
    return str(path)


EVAL_ARGS = ["--device", "cpu", "--dataset_class", "SyntheticDataset",
             "--SyntheticDataset.resolution", "32",
             "--SyntheticDataset.num_items", "16", "--num_samples", "4",
             "--minibatch", "2", "--nhoods_per_image", "8", "--nhood_size",
             "5", "--min_res", "8", "--dirs_per_repeat", "8"]


def test_eval_cli_end_to_end(tmp_path, capsys):
    snap = _snapshot(tmp_path / "network-snapshot-generator-000001.dat", 3)
    out = tmp_path / "eval.json"
    results, baseline = cli.cli_main(
        ["--generator_path", snap, "--output_json", str(out), *EVAL_ARGS])
    assert list(results) == list(baseline) == [32, 16, 8, "avg"]
    payload = json.loads(out.read_text())
    assert payload["depth"] == 3 and payload["num_samples"] == 4
    assert payload["swd_32"] == results[32] > 0
    assert 0 < payload["msssim_fakes"] <= 1
    assert 0 <= payload["msssim_reals"] <= 1  # noise images: about 0
    assert "real-vs-real floor" in capsys.readouterr().out
    mine = dict(cli.default_params)
    assert mine.pop("device") == "cuda"
    assert mine == jeval.default_params


def test_eval_cli_history_mode_resumes(tmp_path, monkeypatch):
    """Every snapshot of a run, the ema twin preferred, the 4 px snapshot
    skipped below min_res, one stage's floors computed once; a second pass
    scores nothing already scored."""
    run = tmp_path / "run"
    run.mkdir()
    _snapshot(run / "network-snapshot-generator-000000.dat", 0)
    _snapshot(run / "network-snapshot-generator-000001.dat", 3)
    _snapshot(run / "network-snapshot-generator-ema-000001.dat", 3, seed=1)
    _snapshot(run / "network-snapshot-generator-000002.dat", 3, seed=2)
    scored, floors = [], []
    real_score, real_floors = cli._score_snapshot, cli._reals_and_floors
    monkeypatch.setattr(cli, "_score_snapshot", lambda p, *a: (
        scored.append(os.path.basename(p)), real_score(p, *a))[1])
    monkeypatch.setattr(cli, "_reals_and_floors", lambda d, dep, al, p, c: (
        floors.append(dep) if (int(dep), round(float(al), 6)) not in c
        else None, real_floors(d, dep, al, p, c))[1])
    rows = cli.cli_main(["--run_dir", str(run), *EVAL_ARGS])
    assert [os.path.basename(r["generator_path"]) for r in rows] == [
        "network-snapshot-generator-ema-000001.dat",
        "network-snapshot-generator-000002.dat"]
    assert scored[0] == "network-snapshot-generator-000000.dat"
    assert floors == [0, 3]  # depth 3's floors once for two snapshots
    lines = (run / "eval_history.jsonl").read_text().splitlines()
    assert len(lines) == 2
    scored.clear()
    again = cli.cli_main(["--run_dir", str(run), *EVAL_ARGS])
    assert scored == ["network-snapshot-generator-000000.dat"]
    assert again == rows


def test_eval_cli_flag_errors(tmp_path):
    snap = _snapshot(tmp_path / "g.dat", 3)
    for extra, msg in ((["--minibatch", "3"], "multiple of minibatch"),
                       (["--min_res", "4"], "must be >= --nhood_size")):
        with pytest.raises(SystemExit, match=msg):
            cli.cli_main(["--generator_path", snap, *EVAL_ARGS, *extra])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.cli_main(["--generator_path", snap, *EVAL_ARGS[2:]])
