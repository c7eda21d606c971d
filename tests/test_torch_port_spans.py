"""The port's host spans (``pggan_tpu_torch/utils/profiling.py``'s
``span``) on the CPU: with no profiler a span records nothing and calls no
profiler function; under a profiler it records its parent on its own
thread and puts a host event ``pggan/<name>`` in the profile, one that is
no user annotation (on the card such an annotation is echoed by a device
event). Then the spans where the work happens: a trainer's dispatch
(fetch, stage, issue, plugins, the throttle's waits, the tick), a chunked
request (its issue per chunk and its drain, with stand-ins for the card's
event and pinned buffers) and the loader's batches, which go to ``SPANS``
alone.
"""

import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pggan_tpu_torch import sampling
from pggan_tpu_torch.data.loader import DataIterator
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.training import TrainStepBuilder, init_state
from pggan_tpu_torch.training.trainer import Trainer
from pggan_tpu_torch.utils import profiling

SHAPE = (8, 3, 32, 32)
SMALL = dict(fmap_base=128, fmap_max=16)


@pytest.fixture(autouse=True)
def _no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _profiled(fn):
    """``fn()`` under a CPU profiler: ``(result, the profile's pggan/
    events)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("pggan/")]


def _by_name(name):
    return [s for s in profiling.SPANS if s.name == name]


def _root(s):
    index = {t.index: t for t in profiling.SPANS}
    while s.parent is not None:
        s = index[s.parent]
    return s


# -- the recorder ---------------------------------------------------------------

def test_without_a_profiler_a_span_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range opened for {name}")
    monkeypatch.setattr(profiling, "_HOST_RANGE", refuse)
    with profiling.span("a"):
        with profiling.span("b"):
            pass
    assert profiling.span("a") is profiling.span("b")  # nothing made
    assert not profiling.SPANS and profiling.span_totals() == {}


def test_nested_spans_record_their_parent_and_a_host_event():
    def work():
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    torch.ones(4).add_(1)
            with profiling.span("inner"):
                pass
        with profiling.span("outer"):
            pass
    _, events = _profiled(work)
    outer = _by_name("outer")
    inner, (leaf,) = _by_name("inner"), _by_name("leaf")
    assert len(outer) == 2 and len(inner) == 2
    assert {s.parent for s in outer} == {None}
    assert {s.parent for s in inner} == {outer[0].index}
    assert leaf.parent == inner[0].index and _root(leaf) == outer[0]
    for s in profiling.SPANS:
        assert s.thread == threading.get_ident() and s.end_ns >= s.start_ns
    assert sorted(e.name for e in events) == sorted(
        "pggan/" + s.name for s in profiling.SPANS)
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
    totals = profiling.span_totals()
    assert {k: v[0] for k, v in totals.items()} == {
        "outer": 2, "inner": 2, "leaf": 1}
    assert math.isclose(totals["inner"][1], sum(
        (s.end_ns - s.start_ns) / 1e9 for s in inner))


def test_a_thread_nests_its_own_spans_and_the_record_is_bounded():
    def worker():
        with profiling.span("thread.root", profile=False):
            with profiling.span("thread.child", profile=False):
                pass

    def work():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    _, events = _profiled(work)
    (main,), (root,), (child,) = (_by_name(n) for n in (
        "main", "thread.root", "thread.child"))
    assert root.parent is None and child.parent == root.index
    assert root.thread != main.thread
    assert [e.name for e in events] == ["pggan/main"]
    assert profiling.SPANS.maxlen == profiling.SPANS_MAX


# -- the trainer ------------------------------------------------------------------

def _trainer(spd):
    G = Generator(SHAPE, latent_size=16, **SMALL,
                  generator=torch.Generator().manual_seed(5))
    D = Discriminator(SHAPE, **SMALL,
                      generator=torch.Generator().manual_seed(6))
    builder = TrainStepBuilder(G, D)
    rng = np.random.RandomState(0)
    reals = (rng.randint(0, 256, (2, 8, 8, 3), np.uint8) for _ in range(8))
    t = Trainer(G, D, builder, init_state(G, D, seed=0), None, reals, None,
                steps_per_dispatch=spd)
    t.depth, t.alpha, t.minibatch_size = 1, 1.0, 2
    t.schedule_horizon = lambda nimg: math.inf
    return t


@pytest.mark.parametrize("spd", [2, 1])
def test_a_dispatch_records_its_fetch_stage_and_issue(spd):
    t = _trainer(spd)
    _, events = _profiled(t.train)
    (dispatch,) = _by_name("trainer.dispatch")
    assert dispatch.parent is None and t.iterations == spd
    children = {}
    for s in profiling.SPANS:
        if s.parent == dispatch.index:
            children[s.name] = children.get(s.name, 0) + 1
    # the issue twice: the reals' prep on the device, then the step
    assert children == {"trainer.fetch": 1, "trainer.stage": 1,
                        "trainer.issue": 2, "trainer.await_precompile": 1,
                        "trainer.plugins": 1}
    assert len(events) == len(profiling.SPANS)
    t._rollover_tick()
    assert not _by_name("trainer.tick")  # no profiler: nothing recorded
    _profiled(t._rollover_tick)
    assert [s.parent for s in _by_name("trainer.tick")] == [None]


def test_the_throttle_spans_only_its_waits():
    class Event:
        def __init__(self):
            self.done = False

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    class Buffer:
        def numel(self):
            return 1

    t = Trainer(None, None, None, None, None, iter(()), None,
                inflight_budget_mb=1)
    mb = 1024 * 1024

    def dispatches():
        for _ in range(3):  # the 2nd and 3rd each pass the budget once
            t._throttle_inflight(Event(), Buffer(), mb)
    _profiled(dispatches)
    assert len(_by_name("trainer.throttle")) == 2


# -- sampling -------------------------------------------------------------------

def test_a_chunked_request_records_an_issue_a_chunk():
    G = Generator(SHAPE, latent_size=16, **SMALL,
                  generator=torch.Generator().manual_seed(2))
    imgs, _ = _profiled(lambda: sampling.sample_images(
        G, 2, 1.0, 7, minibatch=3, rng=np.random.RandomState(1)))
    assert imgs.shape == (7, 16, 16, 3)
    (request,) = _by_name("sample.request")
    issues = _by_name("sample.issue")
    assert request.parent is None and len(issues) == 3  # 3 + 3 + 1 padded
    assert {s.parent for s in issues} == {request.index}


def test_the_drain_spans_its_wait_and_its_copy(monkeypatch):
    """``_pinned_gather`` with host stand-ins for the card's events and
    pinned buffers: each chunk's drain is one wait and one copy."""
    class Event:
        def record(self, stream=None):
            pass

        def synchronize(self):
            pass

    empty = torch.empty
    monkeypatch.setattr(sampling.torch.cuda, "Event", Event)
    monkeypatch.setattr(sampling, "_stream", lambda device: None)
    monkeypatch.setattr(sampling.torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    chunks = [(torch.full((3, 2, 2, 1), float(i)), 3) for i in range(4)]

    def request():
        with profiling.span("sample.request"):
            return sampling._pinned_gather(iter(chunks), 12)
    out, events = _profiled(request)
    np.testing.assert_array_equal(out[:, 0, 0, 0], np.repeat(np.arange(4), 3))
    (root,) = _by_name("sample.request")
    for name in ("sample.drain_wait", "sample.drain_copy"):
        spans = _by_name(name)
        assert len(spans) == 4 and {s.parent for s in spans} == {root.index}
    assert len(events) == 9


# -- the loader -----------------------------------------------------------------

class _Items:
    """A dataset of 8 uint8 items, served as raw batches."""
    alpha, range_in, range_out = 1.0, (0, 255), (-1, 1)

    def __len__(self):
        return 8

    def raw_batch(self, idxs):
        return np.asarray(idxs, np.uint8).reshape(-1, 1, 1, 1)


def test_the_loaders_batches_go_to_spans_alone():
    it = DataIterator(_Items(), 2, num_workers=2, seed=0, raw=True)

    def take():
        return [next(it) for _ in range(6)]
    try:
        batches, events = _profiled(take)
    finally:
        it.close()
        for t in it._threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in it._threads)
    assert all(b.shape == (2, 1, 1, 1) for b in batches)
    spans = _by_name("loader.batch")
    assert spans and all(s.parent is None for s in spans)
    assert threading.get_ident() not in {s.thread for s in spans}
    assert not events  # the profile has none of them
