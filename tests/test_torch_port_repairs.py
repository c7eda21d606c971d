"""Three repairs to the port, on the CPU: the serve's pinned, overlapped
copy to the host (same bytes as the route before it, chunks drained in
order), the port as an installable package (its kernel sources are package
data; the library is built in a user cache where the package directory is
read-only), and the graphed step's host logic off the card (eager, no
capture).
"""

import fnmatch
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from pggan_tpu_torch import sampling
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.utils.misc import random_latents

REPO = Path(__file__).resolve().parent.parent
SHAPE = (8, 3, 32, 32)
SMALL = dict(fmap_base=128, fmap_max=16, latent_size=16)


def _previous_route(G, depth, alpha, num_samples, minibatch, rng):
    """``sample_images`` as it was: each chunk's ``.cpu().numpy()``, then
    one concatenation."""
    chunk = minibatch or num_samples
    outs, done = [], 0
    with torch.inference_mode():
        while done < num_samples:
            take = min(chunk, num_samples - done)
            z = random_latents(take, G.latent_size, rng)
            if take < chunk:
                z = np.concatenate(
                    [z, np.zeros((chunk - take, G.latent_size), z.dtype)])
            imgs = G(torch.from_numpy(z), depth, alpha, fade=alpha < 1.0)
            outs.append(imgs[:take].cpu().numpy())
            done += take
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


@pytest.mark.parametrize("num,minibatch,alpha", [(5, 2, 1.0), (4, 0, 0.5),
                                                 (6, 3, 0.25)])
def test_sample_images_bytes_equal_the_previous_route(num, minibatch, alpha):
    G = Generator(SHAPE, **SMALL, generator=torch.Generator().manual_seed(2))
    got = sampling.sample_images(G, 3, alpha, num, minibatch=minibatch,
                                 rng=np.random.RandomState(9))
    want = _previous_route(G, 3, alpha, num, minibatch,
                           np.random.RandomState(9))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.ascontiguousarray(got).tobytes() == \
        np.ascontiguousarray(want).tobytes()


def test_pinned_gather_overlaps_and_keeps_the_bytes(monkeypatch):
    """The card's gather, with host stand-ins for pinned memory and events:
    chunk i + 1 is issued before chunk i's copy is waited for, the two
    buffers alternate, and the rows land where they belong."""
    log = []

    class Event:
        count = 0

        def __init__(self):
            self.n = Event.count
            Event.count += 1

        def record(self, stream=None):
            log.append(("copy", self.n))

        def synchronize(self):
            log.append(("wait", self.n))

    empty = torch.empty
    buffers = []

    def host_empty(*shape, pin_memory=False, **kw):
        assert pin_memory
        buffers.append(empty(*shape, **kw))
        return buffers[-1]

    monkeypatch.setattr(sampling.torch.cuda, "Event", Event)
    monkeypatch.setattr(sampling, "_stream", lambda device: None)
    monkeypatch.setattr(sampling.torch, "empty", host_empty)
    chunks = [torch.randn(3, 2, 2, 1, generator=torch.Generator()
                          .manual_seed(i)) for i in range(4)]

    def issued():
        for i, c in enumerate(chunks):
            log.append(("forward", i))
            yield c, (2 if i == 3 else 3)
    out = sampling._pinned_gather(issued(), 11)
    np.testing.assert_array_equal(
        out, torch.cat([c[:3] for c in chunks[:3]] + [chunks[3][:2]]))
    assert len(buffers) == 2
    assert log == [("forward", 0), ("copy", 0),
                   ("forward", 1), ("copy", 1), ("wait", 0),
                   ("forward", 2), ("copy", 2), ("wait", 1),
                   ("forward", 3), ("copy", 3), ("wait", 2), ("wait", 3)]


def test_package_data_ships_every_kernel_source():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["pggan_tpu_torch"]
    include = cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    assert any(fnmatch.fnmatch("pggan_tpu_torch", g) for g in include)
    for name in _build.SOURCES + _build.HEADERS:
        assert (REPO / "pggan_tpu_torch" / "csrc" / name).exists(), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name


def test_build_dir_falls_back_to_a_user_cache(monkeypatch, tmp_path):
    assert _build.build_dir() == _build.CSRC / "build"  # a checkout
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setenv("PGGAN_TORCH_CACHE", str(tmp_path / "cache"))
    assert _build.build_dir() == tmp_path / "cache"
    monkeypatch.delenv("PGGAN_TORCH_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert _build.build_dir() == tmp_path / ".cache" / "pggan_tpu_torch"


def test_graphed_step_runs_eagerly_on_the_cpu():
    """The graphed route's host logic off the card: a CPU state takes the
    eager step, noise hook included, and nothing is captured."""
    from pggan_tpu_torch.models.discriminator import Discriminator
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G = Generator(SHAPE, **SMALL)
    D = Discriminator(SHAPE, fmap_base=128, fmap_max=16)
    builder = TrainStepBuilder(G, D)
    step = builder.step_fn(1, 2, True)
    state = init_state(G, D)
    reals = torch.zeros(builder.real_batch_shape(1, 2))
    draws = iter([torch.zeros(2, 16), torch.full((2,), 0.5),
                  torch.zeros(2, 16)])
    for _ in range(3):
        out = step(state, reals, 0.5, 1e-3, 1e-3)
    step(state, reals, 0.5, 1e-3, 1e-3, noise=lambda k, s: next(draws))
    assert not builder.graphs() and step.graph is None
    assert int(state.d_opt.count) == 4
    assert all(torch.isfinite(v) for v in out.values())
    assert builder.step_fn(1, 2, True) is step
    assert TrainStepBuilder(G, D, cuda_graphs=False).step_fn(1, 2, True) \
        is not step
