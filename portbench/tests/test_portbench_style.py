"""The StyleGAN cell's harness pieces on the CPU, at a small configuration:
a run of ``traffic/train_style.py`` comes out ``correct`` under the cell's
limits and not with the reference's half-batch fault in the program's
place; the epilogue's bytes (``style_work.py``) and the two metrics that
read the StyleGAN kernels.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import collections
import json
import types
from pathlib import Path

from portbench import check, style_work
from portbench import run as harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "train.style1024.d8-fade"
TINY_CFG = dict(json.loads(
    (ROOT / "portbench/configs/stylegan-celebahq1024.json").read_text()),
    name="tiny", resolution=32, fmap_base=128, fmap_max=32, latent_size=32,
    w_dim=32, minibatch_overrides={}, lod_training_kimg=100,
    lod_transition_kimg=100)
TINY_TRAIN = dict(kind="train_style", depth=3, batch=4, resume_nimg=500000,
                  fade_nimg=100000, steps_per_dispatch=4, checked_steps=3,
                  items=16, data_workers=1, trace_dispatches=2,
                  tick_kimg=20)


def limits() -> dict:
    return json.loads((ROOT / f"portbench/workloads/{CELL}.json")
                      .read_text())["limits"]


def test_tiny_style_cell_is_correct_and_the_fault_is_not():
    spec = dict(name="tiny", cfg=TINY_CFG, traffic_params=TINY_TRAIN,
                limits=limits(), chips=1)
    cell = harness.Cell(spec, 2 ** 31 + 77, 0.2, False, "cpu", study=True)
    harness.execute(cell)
    assert cell.metrics["train_img_s"] > 0
    assert all(check.finite(v) <= lim for _, v, lim in cell.checks), \
        cell.checks
    fault = cell.study_readings["fault_half_batch"]
    assert any(fault[name] > limits()[name] for name in fault
               if name in limits())


def test_epilogue_bytes_and_readers():
    n, c, h, w = 4, 16, 1024, 1024
    fwd = (0,) * 8 + (n, c, h, w, 1, 1, 1, 17, 0.2, 1e-8)
    bwd = (0,) * 11 + (n, c, h, w, 1, 1, 1, 17, 0.2)
    plane = n * c * h * w
    assert style_work.call_bytes("pggan_style_adain", fwd) >= 4 * 2 * plane
    assert style_work.call_bytes("pggan_style_adain_bwd", bwd) >= \
        4 * 3 * plane
    assert style_work.call_bytes("pggan_style_adain", bwd) is None
    assert style_work.call_bytes("pggan_conv3x3", fwd) is None
    launches = style_work.StyleLaunches()
    launches.bytes = [style_work.call_bytes("pggan_style_adain", fwd)]
    trace = types.SimpleNamespace(by_name=collections.Counter({
        "void style_adain_stats<true>": 0.002,
        "void style_adain_apply<true>": 0.002, "style_blur4": 0.001,
        "wide_conv_fwd": 0.5}))
    cell = types.SimpleNamespace(layer=dict(
        trace=trace, steps=8, dispatches=1.0, style_launches=launches))
    ms = harness.load_module(
        ROOT / "portbench/metrics/style_ms_per_step.train.py", "m_style_ms")
    roof = harness.load_module(
        ROOT / "portbench/metrics/style_epilogue_roofline.train.py",
        "m_style_roof")
    assert abs(ms.read(cell) - 1e3 * 0.005 / 8) < 1e-12
    share = roof.read(cell)
    assert 0 < share <= 100
    cell.layer.pop("style_launches")
    assert roof.read(cell) is None
