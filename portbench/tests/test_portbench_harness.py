"""The harness on the CPU, at a small configuration: the files it is driven
by, what a run loads, that a cell, a configuration and a metric are added
by new files alone, and that ``correct`` comes out false when the timed
path is broken underneath (the check's faults) or the reference runs in
TF32 in the program's place (the control).

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from portbench import check
from portbench import run as harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

TINY_CFG = dict(json.loads(
    (ROOT / "portbench/configs/pggan-rgb1024.json").read_text()),
    name="tiny", resolution=32, fmap_base=64, fmap_max=16, latent_size=16,
    minibatch_default=4, minibatch_overrides={})
TINY_TRAIN = dict(kind="train", depth=2, batch=4, resume_nimg=300000,
                  fade_nimg=100000, steps_per_dispatch=4, checked_steps=3,
                  items=16, data_workers=1, trace_dispatches=2, tick_kimg=20)
TINY_SERVE = dict(kind="serve", depth=3, alpha=1.0, minibatch=4,
                  request_images=6, warmup_requests=1, sampled_requests=2,
                  trace_requests=2)


def cell_limits(name: str) -> dict:
    return json.loads((ROOT / f"portbench/workloads/{name}.json")
                      .read_text())["limits"]


def tiny(traffic: dict, limits: dict, seed=2 ** 31 + 7, study=False):
    spec = dict(name="tiny", cfg=TINY_CFG, traffic_params=traffic,
                limits=limits, chips=1)
    cell = harness.Cell(spec, seed, 0.5, False, "cpu", study=study)
    harness.execute(cell)
    return cell


def correct(cell) -> bool:
    return all(check.finite(value) <= limit for _, value, limit in cell.checks)


# -- the files ----------------------------------------------------------------

def test_benchmark_file_and_cell_files_agree():
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert spec[key] == w[key], (w["name"], key)
        assert spec["traffic_params"]["kind"] in ("train", "serve")
        assert set(spec["limits"]) == {
            "train": {"rows_gap", "loss_gap", "g_loss_gap", "grad_gap",
                      "change_gap", "group_change_gap"},
            "serve": {"image_gap"}}[spec["traffic_params"]["kind"]]
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files_declare_their_entry(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = harness.load_module(ROOT / f"portbench/metrics/{metric}.py",
                                 "m_" + metric.replace(".", "_"))
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])


def test_without_a_card_the_run_fails_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_benchmark_alone_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            import sys
            from portbench import run
            sys.exit(run.execute(run.Cell(run.cell_spec(sys.argv[1]), 1, 1,
                                          False, "cpu")))
        """), BENCH["workloads"][0]["name"]],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "pggan_tpu_torch" in proc.stderr


# -- what a run loads ----------------------------------------------------------

def test_a_run_loads_no_jax():
    code = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, "portbench/tests")
        import test_portbench_harness as t
        cell = t.tiny(t.TINY_TRAIN, t.cell_limits("train.rgb1024.d8-fade"))
        cell = t.tiny(t.TINY_SERVE, t.cell_limits("serve.spec512.d7"))
        from portbench import run
        print(json.dumps(run.loaded_forbidden()))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "pggan_tpu_torch", "pggan_tpu", "jax", "jaxlib", "flax"), \
                    (path.name, name)
    code = textwrap.dedent("""
        import sys
        from portbench.reference import pggan
        from portbench import yardstick
        cfg = dict(resolution=16, num_channels=1, fmap_base=32,
                   fmap_decay=1.0, fmap_max=8, latent_size=8)
        yardstick.step_flops(cfg, 2, 2, True, dict(
            iwass_lambda=10.0, iwass_epsilon=1e-3, iwass_target=1.0))
        print(sorted({m.split(".")[0] for m in sys.modules} & {
            "pggan_tpu_torch", "pggan_tpu", "jax", "jaxlib", "flax"}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


# -- data-driven additions ----------------------------------------------------

def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries in a copy are found and run, and no file that was
    there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    pb = tmp_path / "portbench"
    (pb / "configs/tiny.json").write_text(json.dumps(TINY_CFG))
    (pb / "traffic/train.tiny.json").write_text(json.dumps(TINY_TRAIN))
    (pb / "workloads/train.tiny.d2.json").write_text(json.dumps(dict(
        config="tiny", traffic="train.tiny", chips=1, why="a test",
        limits=cell_limits("train.rgb1024.d8-fade"))))
    (pb / "metrics/images_seen.train.py").write_text(textwrap.dedent('''
        LAYER = "trainer"
        UNIT = "images"
        SOURCE = "program_counter"
        MOVES = "train_img_s"


        def read(cell):
            return cell.layer["steps"] * cell.traffic["batch"]
    '''))
    bench["workloads"].append(dict(name="train.tiny.d2", config="tiny",
                                   traffic="train.tiny", chips=1,
                                   why="a test"))
    bench["end_to_end"][0]["workloads"].append("train.tiny.d2")
    bench["per_layer"].append(dict(
        name="images_seen.train", unit="images", better="higher",
        source="program_counter", layer="trainer", moves="train_img_s",
        workloads=["train.tiny.d2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(tmp_path)!r})
        sys.path.insert(1, {str(ROOT)!r})
        from portbench import run
        assert run.HERE.parent == __import__("pathlib").Path({str(tmp_path)!r})
        cell = run.Cell(run.cell_spec("train.tiny.d2"), 5, 0.5, False, "cpu")
        run.execute(cell)
        e2e, layer = run.metrics_for(run.benchmark(), "train.tiny.d2",
                                     cell.end_to_end)
        reader = run.load_module(run.HERE / "metrics/images_seen.train.py",
                                 "m")
        print(json.dumps(dict(e2e=[m["name"] for m in e2e],
                              layer=[m["name"] for m in layer],
                              seen=reader.read(cell),
                              ok=all(v <= l for _, v, l in cell.checks))))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["e2e"] == ["train_img_s", "setup_s"]
    assert "images_seen.train" in out["layer"]
    assert out["seen"] >= 16 and out["ok"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


# -- correct: a sound run, the control and the faults ---------------------------

def test_a_sound_run_is_correct():
    train = tiny(TINY_TRAIN, cell_limits("train.rgb1024.d8-fade"))
    serve = tiny(TINY_SERVE, cell_limits("serve.spec512.d7"))
    assert correct(train) and correct(serve), (train.checks, serve.checks)
    assert train.result["attempted"] % TINY_TRAIN["steps_per_dispatch"] == 0


def test_the_control_and_the_half_batch_fail():
    """The study's readings at a small size: the control (TF32 operands)
    and the half-batch fault fail the train cell's limits."""
    cell = tiny(TINY_TRAIN, cell_limits("train.rgb1024.d8-fade"), study=True)
    limits = cell.limits
    for side in ("control_tf32", "fault_half_batch", "fault_unchanged"):
        readings = cell.study_readings[side]
        assert any(readings[n] > limits[n] for n in limits
                   if n in readings), (side, readings)
    serve = tiny(TINY_SERVE, cell_limits("serve.spec512.d7"), study=True)
    assert serve.study_readings["control_tf32"]["image_gap"] > \
        serve.limits["image_gap"]


def test_a_state_left_unchanged_is_not_correct(monkeypatch):
    from pggan_tpu_torch.training import state
    monkeypatch.setattr(state.Adam, "step", lambda self, grads, lr: None)
    cell = tiny(TINY_TRAIN, cell_limits("train.rgb1024.d8-fade"))
    assert not correct(cell)
    assert dict((n, v) for n, v, _ in cell.checks)["change_gap"] == 1.0


def _group_fault(monkeypatch, fault):
    """Break the group dispatch alone: the single steps stay sound."""
    from pggan_tpu_torch.training import steps
    group_step_fn = steps.TrainStepBuilder.group_step_fn

    def broken(self, *args, **kwargs):
        gstep = group_step_fn(self, *args, **kwargs)

        def run(state, reals, alphas, lrs_d, lrs_g, **kw):
            params = [p for m in (state.G, state.D) for p in m.parameters()]
            kept = [p.detach().clone() for p in params]
            if fault == "lr_vector":
                lrs_d, lrs_g = lrs_d * 2, lrs_g * 2
            metrics = gstep(state, reals, alphas, lrs_d, lrs_g, **kw)
            if fault == "unchanged":
                with torch.no_grad():
                    for p, k in zip(params, kept):
                        p.copy_(k)
            return metrics
        return run

    monkeypatch.setattr(steps.TrainStepBuilder, "group_step_fn", broken)


@pytest.mark.parametrize("fault", ["unchanged", "lr_vector"])
def test_a_fault_in_the_group_alone_is_not_correct(monkeypatch, fault):
    """The window replays the group graph alone: a group that leaves the
    state unchanged, or steps at twice its learning rates, fails although
    the single steps before it are sound."""
    _group_fault(monkeypatch, fault)
    cell = tiny(TINY_TRAIN, cell_limits("train.rgb1024.d8-fade"))
    checks = {n: (v, lim) for n, v, lim in cell.checks}
    assert not correct(cell), checks
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert checks[name][0] <= checks[name][1], (name, checks)
    assert checks["group_change_gap"][0] > checks["group_change_gap"][1], \
        checks


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from pggan_tpu_torch.training import steps
    d_loss, g_loss = steps.wgan_gp_D_loss, steps.wgan_gp_G_loss

    def half_d(d_fn, g_fn, real, latents, mix, *args, **kwargs):
        k = real.shape[0] // 2
        return d_loss(d_fn, g_fn, real[:k], latents[:k], mix[:k], *args,
                      **kwargs)

    def half_g(g_fn, d_fn, latents):
        return g_loss(g_fn, d_fn, latents[:latents.shape[0] // 2])

    monkeypatch.setattr(steps, "wgan_gp_D_loss", half_d)
    monkeypatch.setattr(steps, "wgan_gp_G_loss", half_g)
    cell = tiny(TINY_TRAIN, cell_limits("train.rgb1024.d8-fade"))
    assert not correct(cell)


def test_an_altered_answer_is_not_correct(monkeypatch):
    from pggan_tpu_torch.models import generator
    forward = generator.Generator.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return out + 1e-3 * out.abs().amax()

    monkeypatch.setattr(generator.Generator, "forward", altered)
    assert not correct(tiny(TINY_SERVE, cell_limits("serve.spec512.d7")))
    assert not correct(tiny(TINY_TRAIN,
                            cell_limits("train.rgb1024.d8-fade")))


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell, on the card: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "20261018", "--seconds",
         "2"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]


def test_check_report_prints_each_limit(capsys):
    assert not check.report([("a", 1.0, 2.0), ("b", 3.0, 2.0)])
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "check a: 1.0 (limit 2.0)"
    assert err[1].endswith("FAILED")
