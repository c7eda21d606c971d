"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``portbench/workloads/<cell>.json``
(its configuration, traffic, chips and why), the configuration in
``portbench/configs/<config>.json``, the traffic mix in
``portbench/traffic/<traffic>.json``, whose ``kind`` names the module
``portbench/traffic/<kind>.py`` that drives it, and each per-layer metric
of ``BENCHMARK.json`` in ``portbench/metrics/<metric>.py``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window.

The run exits nonzero, and prints no result, without a CUDA card (or with
fewer than the cell asks for), where a module of JAX or of the JAX package
is loaded once the window has closed, and where anything fails. Caches of
the program stay in fixed folders inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pggan_tpu")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(HERE / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / ".cache" / "triton"))
os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(name: str) -> dict:
    """The cell's own file, its configuration and its traffic."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    return dict(cell, name=name,
                cfg=load_json(HERE / "configs" / f"{cell['config']}.json"),
                traffic_params=load_json(HERE / "traffic"
                                         / f"{cell['traffic']}.json"))


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metrics_for(bench: dict, cell: str, end_to_end: tuple) -> tuple:
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    this cell reports."""
    e2e = [m for m in bench["end_to_end"] if m["name"] in end_to_end
           and cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in reported
             and cell in m.get("workloads", [cell])]
    return e2e, layer


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """One run of a cell: its inputs, and what the traffic module fills
    in."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device, study: bool = False):
        import torch
        self.name, self.cfg = spec["name"], spec["cfg"]
        self.traffic = spec["traffic_params"]
        self.limits = spec["limits"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.study, self.study_readings = study, None
        self.t0 = T0
        self.result = {}
        self.metrics = {}
        self.layer = {}
        self.counters = {}
        self.checks = []
        self.setup_s = None
        self.memory_peak_bytes = None

    def log(self, msg: str) -> None:
        """A progress line on standard error, with the seconds since
        start."""
        print(f"[{time.perf_counter() - self.t0:8.2f} s] {msg}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close_window(self) -> None:
        """The window has closed: the peak memory, and no JAX."""
        import torch
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        found = loaded_forbidden()
        if found:
            raise SystemExit(f"modules of JAX or of the JAX package are "
                             f"loaded: {', '.join(found)}")


def execute(cell: Cell) -> None:
    """Build the library (counted in set-up, and apart as ``build_s``),
    then drive the cell's traffic."""
    from pggan_tpu_torch.ops import _build
    from portbench.reference import pggan
    pggan.full_precision()
    t = time.perf_counter()
    if cell.device.type == "cuda":
        _build.library()
    cell.build_s = time.perf_counter() - t
    cell.log(f"kernel library ready in {cell.build_s:.2f} s")
    kind = load_module(HERE / "traffic" / f"{cell.traffic['kind']}.py",
                       f"portbench_traffic_{cell.traffic['kind']}")
    cell.end_to_end = kind.END_TO_END
    kind.run(cell)
    cell.metrics["setup_s"] = cell.setup_s


def result(cell: Cell, bench: dict) -> dict:
    """The result line."""
    import torch
    from portbench import check
    e2e, layer = metrics_for(bench, cell.name, cell.end_to_end)
    metrics = {}
    if cell.trace:
        for m in layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(
                                     ".", "_"))
            value = reader.read(cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": cell.metrics[m["name"]],
                                  "unit": m["unit"]}
    ok = check.report(cell.checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
              "count": 1, "memory_peak_bytes": cell.memory_peak_bytes}
    out = {"correct": ok, "attempted": cell.result["attempted"],
           "failed": cell.result["failed"], "metrics": metrics,
           "device": device, "build_s": cell.build_s}
    if cell.trace:
        trace = cell.layer["trace"]
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = trace.breakdown()
    out["checks"] = check.as_json(cell.checks)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    bench = benchmark()
    cell = Cell(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    execute(cell)
    line = result(cell, bench)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    from portbench import check
    print(check.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
