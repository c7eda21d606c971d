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
    assert len(builder.graphs()) == 1 and step.capture_s > 0
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
    assert len(builder.graphs()) == 1
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


@pytest.mark.parametrize("fade", [True, False])
def test_group_replay_equals_its_single_replays(cuda, deterministic_cudnn,
                                                fade):
    """A group of 3 steps as one graph against 3 replays of the single
    step's graph from the same state and generator, with per-step alphas
    and learning rates: the same metrics and updates, bit for bit, and no
    kernel wrapper called by either replay. The group's capture recorded 3
    times the single step's kernel calls."""
    group = 3
    (G, D), (G2, D2) = _models(cuda), _models(cuda)
    states = [init_state(G, D, seed=3), init_state(G2, D2, seed=3)]
    single, grouped = TrainStepBuilder(G, D), TrainStepBuilder(G2, D2)
    step = single.step_fn(DEPTH, BATCH, fade)
    gstep = grouped.group_step_fn(DEPTH, BATCH, fade, group)
    reals = [_reals(single, cuda, k) for k in range(group)]
    ones = torch.ones(group).numpy()
    for _ in range(2):  # eager, then the capture and its first replay
        step(states[0], reals[0], 0.5 if fade else 1.0, LR, LR)
        gstep(states[1], torch.stack(reals), (0.5 if fade else 1.0) * ones,
              LR * ones, LR * ones)
    assert {k: group * n for k, n in step.captured.items()} == \
        dict(gstep.captured)
    assert list(grouped.graphs()) == [(DEPTH, BATCH, fade, group)]
    _copy_state(states[0], states[1])
    alphas = ([0.2, 0.35, 0.5] if fade else [1.0] * group)
    lrs = ([LR, 0.8 * LR, 0.6 * LR], [0.3 * LR, 0.5 * LR, 0.7 * LR])
    before = [p.detach().clone() for p in [*G.parameters(), *D.parameters()]]
    launches = dict(_build.LAUNCHES)
    want = []
    for k in range(group):
        m = step(states[0], reals[k], alphas[k], lrs[0][k], lrs[1][k])
        want.append(torch.stack([m[n] for n in sorted(m)]))
    got = gstep(states[1], torch.stack(reals), torch.tensor(alphas).numpy(),
                torch.tensor(lrs[0]).numpy(), torch.tensor(lrs[1]).numpy())
    assert dict(_build.LAUNCHES) == launches
    assert torch.equal(torch.stack([got[n] for n in sorted(got)], 1),
                       torch.stack(want))
    for p0, p, q in zip(before, [*G2.parameters(), *D2.parameters()],
                        [*G.parameters(), *D.parameters()]):
        assert torch.equal(p, q)
    assert any(not torch.equal(p0, p) for p0, p in zip(before,
                                                       G.parameters()))
    assert torch.equal(states[0].generator.get_state(),
                       states[1].generator.get_state())
    assert int(states[0].g_opt.count) == 2 + group
    assert int(states[1].g_opt.count) == 2 + group


def _state_equal(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


@pytest.mark.parametrize("fade", [True, False])
def test_precompiled_key_replays_from_its_first_call(cuda, deterministic_cudnn,
                                                     fade):
    """``precompile`` warms the key up on a scratch copy (on the warm-up
    stream: its launches count in the builder's ``precompile_launches``)
    and captures it, leaving the
    state as it was; the key's first call is then a replay, which equals
    the eager step from the same state to this file's bars and records
    the eager step's kernel calls."""
    G, D = _models(cuda)
    state, builder = init_state(G, D, seed=3), TrainStepBuilder(G, D)
    G0, D0 = copy.deepcopy(G), copy.deepcopy(D)
    twin = init_state(G0, D0, seed=99)
    _copy_state(state, twin)
    builder.precompile(DEPTH, BATCH, fade, state)
    step = builder._steps[(DEPTH, BATCH, fade)]
    assert step.ahead and step.graph is not None and step.replays == 0
    assert step.warm_s > 0 and step.capture_s > 0
    assert sum(builder.precompile_launches.values()) > 0
    assert _state_equal(state, twin)  # the precompile wrote nothing
    eager = TrainStepBuilder(G0, D0, cuda_graphs=False).step_fn(DEPTH, BATCH,
                                                                fade)
    reals = _reals(builder, cuda, 7)
    alpha, lrs = (0.7 if fade else 1.0), (0.6 * LR, 0.3 * LR)
    before = [p.detach().clone() for p in [*G.parameters(), *D.parameters()]]
    launches = dict(_build.LAUNCHES)
    got = step(state, reals, alpha, *lrs)
    assert dict(_build.LAUNCHES) == launches  # a replay launches no wrapper
    assert step.replays == 1 and step.eager_s is None
    want = eager(twin, reals, alpha, *lrs)
    eager_calls = {k: n - launches.get(k, 0) for k, n in
                   _build.LAUNCHES.items() if n != launches.get(k, 0)}
    assert dict(step.captured) == eager_calls and eager_calls
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    moved = 0
    for p0, p, q in zip(before, [*G.parameters(), *D.parameters()],
                        [*G0.parameters(), *D0.parameters()]):
        dp, dq = p.detach() - p0, q.detach() - p0
        if not dq.any():
            assert not dp.any()
            continue
        moved += 1
        assert float((dp - dq).norm()) <= UPDATE_TOL * float(dq.norm())
    assert moved > 0
    assert int(state.g_opt.count) == int(twin.g_opt.count) == 1
    assert torch.equal(state.generator.get_state(),
                       twin.generator.get_state())


def test_capture_in_a_thread_beside_replays(cuda, deterministic_cudnn):
    """A precompile in a background thread captures the stable step while
    the main thread replays the fade step's graph, queries and waits on
    events and allocates pinned memory. Against the same replays on a twin
    without the thread: the same metrics and states bit for bit, generator
    state included; then the precompiled stable key's first call (a
    replay) equals the twin's eager first call at that key bit for bit."""
    import threading
    pairs = [_models(cuda), _models(cuda)]
    states = [init_state(G, D, seed=3) for G, D in pairs]
    builders = [TrainStepBuilder(G, D) for G, D in pairs]
    reals = [_reals(builders[0], cuda, k) for k in range(4)]
    fades = [b.step_fn(DEPTH, BATCH, True) for b in builders]
    for k in range(2):  # eager, then the capture and its first replay
        for step, state in zip(fades, states):
            step(state, reals[k], 0.5, LR, LR)
    stable = builders[1].step_fn(DEPTH, BATCH, False)
    capturing, during = threading.Event(), [0]
    capture = stable._capture

    def flagged(args):
        capturing.set()
        try:
            capture(args)
        finally:
            capturing.clear()
    stable._capture = flagged
    thread = threading.Thread(target=builders[1].precompile,
                              args=(DEPTH, BATCH, False, states[1]))
    thread.start()
    got, n = [], 0
    while thread.is_alive() or n < 8:
        m = fades[1](states[1], reals[n % 4], 0.5, LR, LR)
        during[0] += capturing.is_set()
        event = torch.cuda.Event()
        event.record()
        event.query()
        torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
        if n % 3 == 0:
            event.synchronize()
        got.append(torch.stack([m[name] for name in sorted(m)]).clone())
        n += 1
    thread.join()
    assert stable.graph is not None and stable.ahead
    assert during[0] > 0, "no replay ran during the capture"
    want = []
    for k in range(n):
        m = fades[0](states[0], reals[k % 4], 0.5, LR, LR)
        want.append(torch.stack([m[name] for name in sorted(m)]).clone())
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert _state_equal(states[0], states[1])
    launches = dict(_build.LAUNCHES)
    first = stable(states[1], reals[0], 1.0, LR, LR)
    assert dict(_build.LAUNCHES) == launches and stable.eager_s is None
    ref = builders[0].step_fn(DEPTH, BATCH, False)(states[0], reals[0], 1.0,
                                                   LR, LR)
    assert builders[0]._steps[(DEPTH, BATCH, False)].eager_s is not None
    for k in ref:
        assert torch.equal(first[k], ref[k]), k
    assert _state_equal(states[0], states[1])
