"""The graphed train step on the card: the CUDA graph's replays against the
eager step, and the state a replay must read afresh (the generator's
draws, Adam's count, alpha and the learning rates). Every test here needs
an NVIDIA GPU and skips without one; this file imports no JAX, so that it
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_graphs.py

Small configuration (128 px, fmap 32), so that depth 5 runs D's NHCW head
and G's NHCW tail on the kernels. Bars: losses rtol 1e-4; the update each
parameter tensor took in one step, |replay - eager| / |eager| at most 1e-3
in the 2-norm (chip_smoke.py's UPDATE_TOL, which says why: the compared
step takes an alpha and learning rates other than the capture's, so a
missing update, a baked-in lr or a stale bias correction is far outside),
with cuDNN held to its deterministic algorithms in both steps (its default
ones for the convs' gradients may sum with atomics, so two eager steps
need not agree).
"""

import copy

import pytest
import torch

from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.training import TrainStepBuilder, init_state

pytestmark = pytest.mark.cuda

SHAPE = (1, 3, 128, 128)
DEPTH, BATCH, LR = 5, 2, 1e-3
UPDATE_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def deterministic_cudnn():
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


def _models(device):
    G = Generator(SHAPE, fmap_base=512, fmap_max=32, latent_size=16,
                  generator=torch.Generator().manual_seed(0))
    D = Discriminator(SHAPE, fmap_base=512, fmap_max=32,
                      generator=torch.Generator().manual_seed(1))
    return G.to(device), D.to(device)


def _reals(builder, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    shape = builder.real_batch_shape(DEPTH, BATCH)
    return torch.rand(shape, generator=g, device=device) * 2 - 1


def _copy_state(src, dst):
    """dst's tensors and generator set to src's, by way of a checkpoint."""
    checkpoint.restore_training_state(dst, checkpoint.training_state_dict(src))


@pytest.mark.parametrize("fade", [True, False])
def test_replay_matches_the_eager_step(cuda, deterministic_cudnn, fade):
    """Warm-up, capture, then one replay against the eager step from the
    same state, generator and inputs, at an alpha and learning rates other
    than the capture's: the same losses, the same update of every
    parameter tensor, and the capture recorded the eager step's kernel
    calls."""
    G, D = _models(cuda)
    state, builder = init_state(G, D, seed=3), TrainStepBuilder(G, D)
    step = builder.step_fn(DEPTH, BATCH, fade)
    alpha = 0.3 if fade else 1.0
    launches = dict(_build.LAUNCHES)
    step(state, _reals(builder, cuda, 0), alpha, LR, LR)  # eager
    eager_calls = {k: n - launches.get(k, 0) for k, n in
                   _build.LAUNCHES.items() if n != launches.get(k, 0)}
    step(state, _reals(builder, cuda, 1), alpha, LR, LR)  # capture, replay
    assert len(builder.graphed_keys()) == 1 and step.capture_s > 0
    assert dict(step.captured) == eager_calls and eager_calls
    G2, D2 = copy.deepcopy(G), copy.deepcopy(D)
    twin = init_state(G2, D2, seed=99)
    _copy_state(state, twin)
    eager = TrainStepBuilder(G2, D2, cuda_graphs=False).step_fn(
        DEPTH, BATCH, fade)
    reals = _reals(builder, cuda, 7)
    alpha, lrs = (0.7 if fade else 1.0), (0.6 * LR, 0.3 * LR)
    before = [p.detach().clone() for p in [*G.parameters(), *D.parameters()]]
    launches = dict(_build.LAUNCHES)
    got = step(state, reals, alpha, *lrs)
    assert dict(_build.LAUNCHES) == launches  # a replay launches no wrapper
    want = eager(twin, reals, alpha, *lrs)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    moved = 0
    for p0, p, q in zip(before, [*G.parameters(), *D.parameters()],
                        [*G2.parameters(), *D2.parameters()]):
        dp, dq = p.detach() - p0, q.detach() - p0
        if not dq.any():
            assert not dp.any()
            continue
        moved += 1
        assert float((dp - dq).norm()) <= UPDATE_TOL * float(dq.norm())
    assert moved > 0
    assert int(state.g_opt.count) == int(twin.g_opt.count) == 3
    assert torch.equal(state.generator.get_state(),
                       twin.generator.get_state())


def test_replays_draw_new_noise(cuda):
    """lr 0 keeps the parameters, so two replays on the same reals differ
    only by their draws from the registered generator."""
    G, D = _models(cuda)
    state, builder = init_state(G, D, seed=3), TrainStepBuilder(G, D)
    step = builder.step_fn(DEPTH, BATCH, True)
    reals = _reals(builder, cuda, 0)
    losses = []
    for _ in range(4):
        out = step(state, reals, 0.5, 0.0, 0.0)
        losses.append({k: float(v) for k, v in out.items()})
    assert len(builder.graphed_keys()) == 1
    assert losses[2] != losses[3]  # two replays
    assert len({tuple(v.values()) for v in losses}) == 4


def test_replay_reads_alpha_and_lr(cuda):
    """alpha and the learning rates are static device tensors: a replay
    with other values is the eager step with those values."""
    G, D = _models(cuda)
    state, builder = init_state(G, D, seed=3), TrainStepBuilder(G, D)
    step = builder.step_fn(DEPTH, BATCH, True)
    for i in range(2):
        step(state, _reals(builder, cuda, i), 0.5, LR, LR)
    G2, D2 = copy.deepcopy(G), copy.deepcopy(D)
    twin = init_state(G2, D2)
    _copy_state(state, twin)
    eager = TrainStepBuilder(G2, D2, cuda_graphs=False).step_fn(
        DEPTH, BATCH, True)
    reals = _reals(builder, cuda, 5)
    got = {k: v.clone() for k, v in step(state, reals, 0.9, 0.0, 0.0).items()}
    want = eager(twin, reals, 0.9, 0.0, 0.0)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    for p, q in zip(G.parameters(), G2.parameters()):
        assert torch.equal(p, q)  # lr 0: nothing moved in either


def test_graph_is_bound_to_its_state(cuda):
    G, D = _models(cuda)
    state, builder = init_state(G, D), TrainStepBuilder(G, D)
    step = builder.step_fn(DEPTH, BATCH, False)
    step(state, _reals(builder, cuda, 0), 1.0, LR, LR)
    with pytest.raises(ValueError, match="bound to the state"):
        step(init_state(G, D), _reals(builder, cuda, 0), 1.0, LR, LR)
    with pytest.raises(ValueError, match="noise"):
        step(state, _reals(builder, cuda, 0), 1.0, LR, LR,
             noise=lambda kind, shape: None)
