"""Device time by kernel from a ``torch.profiler`` window: the counterpart
of ``pggan_tpu/utils/profiling.py`` (which reads XLA's HLO self-time).

A host clock around a step measures the host as much as the card; the
device time of each kernel, and the busy share (the union of the kernels'
intervals over the host window), do not depend on what else the host was
doing. ``capture`` profiles ``run_fn()`` (synchronised at its end);
``kernel_rows`` sums its device activity by kernel name: count and device
time, with the group of ``KERNEL_GROUPS`` each name falls in;
``self_time_ms_per_step`` and ``summarize`` read those rows as the JAX
module reads its HLO rows; ``device_profile`` is the summary
``chip_smoke.py`` records for a window: wall and busy time, busy share,
kernels and host launches, time by group and by name.

On the card the rows are the CUDA kernels and copies. ``device="cpu"``
reads a CPU-only window instead (the host's operators, nested ones
included): for tests and rehearsals, never a device number.
"""

from __future__ import annotations

import collections
import math
import time

import torch

# device kernels by source, for the profile (first match wins)
KERNEL_GROUPS = (
    # NCCL's kernels; at one rank an averaging all-reduce is its
    # oneRankReduce kernel, and an in-place sum runs nothing
    ("NCCL collectives", ("nccl", "oneRankReduce")),
    ("chain kernel", ("chain_kernel",)),
    ("conv3x3 kernel", ("conv3x3_wgmma",)),
    ("conv3x3_dw kernel", ("conv3x3_dw",)),
    ("upsample kernel", ("upsample2x",)),
    ("pool kernel", ("avgpool2x",)),
    ("cuDNN / GEMM", ("cudnn", "gemm", "sm90_", "sm80_", "cutlass", "xmma",
                      "convolve", "fft", "winograd", "dgrad", "wgrad")),
    ("Adam (foreach)", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "cat")),
    ("device-to-host copy", ("Memcpy DtoH",)),
)
# host calls that put work on the card's queue
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")

_DEVICE_TYPE = {"cuda": torch.autograd.DeviceType.CUDA,
                "cpu": torch.autograd.DeviceType.CPU}


def group_of(name: str, groups=KERNEL_GROUPS) -> str:
    """The group of a kernel name: the first whose keys it contains."""
    return next((g for g, keys in groups if any(k in name for k in keys)),
                "other")


def capture(run_fn, device: str = "cuda"):
    """``(prof, wall_ms)``: ``torch.profiler`` over ``run_fn()``, the host
    window ending once the device has finished."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_fn()
        if device == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _events(prof, device: str):
    kind = _DEVICE_TYPE[device]
    return [e for e in prof.events() if e.device_type == kind]


def busy_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_rows(prof, device: str = "cuda", groups=KERNEL_GROUPS) -> list:
    """One row per kernel name of the window: ``name``, ``group``,
    ``count`` and ``device_time_us`` (on the CPU: the operators' self
    time), largest first."""
    count, us = collections.Counter(), collections.Counter()
    for e in _events(prof, device):
        count[e.name] += 1
        us[e.name] += (e.time_range.elapsed_us() if device == "cuda"
                       else e.self_cpu_time_total)
    return [{"name": n, "group": group_of(n, groups), "count": count[n],
             "device_time_us": t} for n, t in us.most_common()]


def capture_kernel_stats(run_fn, device: str = "cuda") -> list:
    """``kernel_rows`` of a profile of ``run_fn()``."""
    return kernel_rows(capture(run_fn, device)[0], device)


def self_time_ms_per_step(run_fn, n_steps: int, device: str = "cuda") -> float:
    """Total device time per step (ms) of ``run_fn()``, which runs
    ``n_steps`` steps."""
    rows = capture_kernel_stats(run_fn, device)
    return sum(r["device_time_us"] for r in rows) / (n_steps * 1e3)


def summarize(rows: list, n_steps: int, top: int = 25, log=print) -> None:
    """Print the rows' total, their time by group and the top kernels, per
    step."""
    total = sum(r["device_time_us"] for r in rows)
    by_group = collections.Counter()
    for r in rows:
        by_group[r["group"]] += r["device_time_us"]
    log(f"total device time: {total / 1e3:.3f} ms over {n_steps} steps -> "
        f"{total / (n_steps * 1e3):.3f} ms/step")
    log("--- by group:")
    for g, t in by_group.most_common():
        log(f"{t / max(total, 1e-30) * 100:5.1f}%  {t / (n_steps * 1e3):8.3f} "
            f"ms/step  {g}")
    log("--- top kernels by device time:")
    for r in rows[:top]:
        log(f"{r['device_time_us'] / max(total, 1e-30) * 100:5.1f}%  "
            f"{r['device_time_us'] / (n_steps * 1e3):8.3f} ms/step  "
            f"x{r['count'] / n_steps:g}  {r['name'][:100]}")


def device_profile(prof, wall_ms: float, per: int, tag: str, unit: str,
                   device: str = "cuda", log=print) -> dict:
    """A window's device activity (kernels and copies) summed by name and
    by ``KERNEL_GROUPS``, per ``per`` repetitions of a ``unit``; the busy
    share is the union of their intervals over the host window
    ``wall_ms``; host launches count the calls that queue work on the
    card."""
    events = _events(prof, device)
    rows = kernel_rows(prof, device)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    host = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name in HOST_LAUNCHES)
    groups, counts = collections.Counter(), collections.Counter()
    for r in rows:
        groups[r["group"]] += r["device_time_us"] / 1e3 / per
        counts[r["group"]] += r["count"]
    log(f"  {tag}: {wall_ms / per:.1f} ms a {unit}, device busy "
        f"{busy / 1e3 / per:.1f} ms ({busy / 1e3 / wall_ms:.1%}), "
        f"{len(events) / per:.0f} kernels and copies on the card, "
        f"{host / per:.0f} launches from the host")
    for g, ms in groups.most_common():
        log(f"    {g:24s} {ms:8.3f} ms")
    by_name = {r["name"]: r["device_time_us"] / 1e3 / per for r in rows}
    return {f"wall_ms_per_{unit}": wall_ms / per,
            f"device_busy_ms_per_{unit}": busy / 1e3 / per,
            "device_busy_share": busy / 1e3 / wall_ms,
            f"launches_per_{unit}": len(events) / per,
            f"host_launches_per_{unit}": host / per,
            f"ms_per_{unit}_by_group": dict(groups.most_common()),
            f"kernels_per_{unit}_by_group": {g: n / per
                                             for g, n in counts.items()},
            f"top_kernels_ms_per_{unit}": dict(list(by_name.items())[:12]),
            f"ms_per_{unit}_by_name": by_name}
