"""The study behind each limit of ``correct``: a cell's runs on many seeds
in one process, each number read four ways against the check's reference
(float64): the program, the reference itself in float32, the control (the
reference with TF32 on, in the program's place) and, for training, the
planted half-batch fault. One JSON line a run.

    python3 -m portbench.study --workload <cell> --seeds 1,2,3 [--repeat 3]
        [--seconds 1] [--out FILE]

``--repeat`` runs the first seed that many times more (cuDNN's default
algorithms differ from run to run). Each run has a process of its own.
It needs a card: the cells are full size.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from portbench import check
from portbench import run as harness


def study(spec: dict, seed: int, seconds: float) -> str:
    """One run of a cell with the study's readings, as a JSON line."""
    cell = harness.Cell(spec, seed, seconds, False, "cuda", study=True)
    cell.t0 = time.perf_counter()
    harness.execute(cell)
    return check.dumps({"workload": spec["name"], "seed": seed,
                        "checks": check.as_json(cell.checks),
                        "readings": cell.study_readings,
                        "metrics": cell.metrics,
                        "memory_peak_bytes": cell.memory_peak_bytes,
                        "seconds": time.perf_counter() - cell.t0})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--repeat", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += [seeds[0]] * args.repeat
    if len(seeds) > 1:  # one process a run: nothing carries over
        for seed in seeds:
            subprocess.run([sys.executable, "-m", "portbench.study",
                            "--workload", args.workload, "--seeds",
                            str(seed), "--seconds", str(args.seconds)]
                           + (["--out", args.out] if args.out else []),
                           check=True)
        return 0
    line = study(harness.cell_spec(args.workload), seeds[0], args.seconds)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as out:
            out.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
