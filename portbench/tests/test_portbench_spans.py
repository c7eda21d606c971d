"""The metrics that read the program's spans, on a fabricated traced cell:
each reads its span's seconds over the cell's steps or chunks, in
milliseconds, and reads nothing from an untraced run or from a program
that records no spans.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import run as harness
from pggan_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# metric: (span, the cell's count it is divided by)
READS = {
    "fetch_wait_ms_per_step.train": ("trainer.fetch", "steps"),
    "loader_ms_per_step.train": ("loader.batch", "steps"),
    "stage_ms_per_step.train": ("trainer.stage", "steps"),
    "issue_ms_per_chunk.serve": ("sample.issue", "chunks"),
    "drain_wait_ms_per_chunk.serve": ("sample.drain_wait", "chunks"),
    "drain_copy_ms_per_chunk.serve": ("sample.drain_copy", "chunks"),
}


class _Cell:
    def __init__(self, layer):
        self.layer = layer


def _reader(metric):
    return harness.load_module(ROOT / f"portbench/metrics/{metric}.py",
                               "m_" + metric.replace(".", "_"))


@pytest.fixture
def spans():
    """Two spans of each name on two threads: 3 ms and 5 ms."""
    profiling.clear_spans()
    for i, (name, _) in enumerate(READS.values()):
        for thread, ms in ((1, 3), (2, 5)):
            profiling.SPANS.append(profiling.Span(
                name, thread, 10 ** 9 * i, 10 ** 9 * i + ms * 10 ** 6, None,
                2 * i + thread))
    yield
    profiling.clear_spans()


@pytest.mark.parametrize("metric", sorted(READS))
def test_a_reader_reads_its_span_per_step_or_chunk(metric, spans,
                                                   monkeypatch):
    _, per = READS[metric]
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["source"] == "program_counter" and entry["unit"] == "ms"
    kind = "train." if per == "steps" else "serve."
    assert all(w.startswith(kind) for w in entry["workloads"])
    reader = _reader(metric)
    traced = {"trace": object(), per: 4}
    assert reader.read(_Cell(traced)) == pytest.approx(8 / 4)
    assert reader.read(_Cell({per: 4})) is None  # no traced window
    with monkeypatch.context() as m:
        m.delattr(profiling, "span_totals")  # a program without spans
        assert reader.read(_Cell(traced)) is None
    profiling.clear_spans()
    assert reader.read(_Cell(traced)) is None  # the span never ran
