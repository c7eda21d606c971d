"""What the traced run reads: a ``torch.profiler`` window on the card,
reduced to device time by kernel name and group, the busy union, the host
calls that queued work, and the idle gaps with what the host was doing in
them; and the sizes of the kernel calls the program launched.

The arithmetic is a frozen copy of the bring-up's profiling module (the
busy share as the union of kernel and copy intervals, the kernel groups,
the host launch calls), kept here so that no change to the program moves
it.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time

import numpy as np
import torch

from portbench import yardstick

# device kernels by source (first match wins)
KERNEL_GROUPS = (
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


def group_of(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


def busy_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Trace:
    """One traced window, reduced."""

    def __init__(self, prof, window_s: float):
        dev = torch.autograd.DeviceType.CUDA
        events = list(prof.events())
        device = [e for e in events if e.device_type == dev]
        host = [e for e in events if e.device_type != dev]
        self.window_s = window_s
        self.spans = sorted((e.time_range.start, e.time_range.end)
                            for e in device)
        self.busy_s = busy_us(self.spans) / 1e6
        self.by_name = collections.Counter()
        self.count = collections.Counter()
        for e in device:
            self.by_name[e.name] += e.time_range.elapsed_us() / 1e6
            self.count[e.name] += 1
        self.by_group = collections.Counter()
        for name, s in self.by_name.items():
            self.by_group[group_of(name)] += s
        self.host_launches = sum(1 for e in host if e.name in HOST_LAUNCHES)
        self.idle = self._idle(host)

    def _idle(self, host, labelled: int = 200) -> collections.Counter:
        """Seconds of the gaps between device activity: the ``labelled``
        longest by the innermost host call that spans each one's middle,
        the rest together."""
        gaps, end = [], None
        for a, b in self.spans:
            if end is not None and a > end:
                gaps.append((a - end, (a + end) / 2))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        calls = [e for e in host if e.time_range.end > e.time_range.start]
        starts = np.array([e.time_range.start for e in calls], np.float64)
        ends = np.array([e.time_range.end for e in calls], np.float64)
        names = [e.name for e in calls]
        out = collections.Counter()
        for length, mid in gaps[:labelled]:
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            label = ("host (no call traced)" if not len(inside) else
                     names[inside[np.argmin(ends[inside] - starts[inside])]])
            out[label] += length / 1e6
        rest = sum(g for g, _ in gaps[labelled:])
        if rest:
            out["shorter gaps"] += rest / 1e6
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time (names cut at
        their argument list), and the ten largest idle shares by what
        the host was doing."""
        return {"device_ops": [[n.replace("(anonymous namespace)::", "")
                                .split("(")[0][:160], s]
                               for n, s in self.by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in self.idle.most_common(10)]}


@contextlib.contextmanager
def traced():
    """Profile the body on the card; yields a dict that gets ``trace``."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out["trace"] = Trace(prof, window)


class LaunchLog:
    """The sizes of the program's kernel launches, read at its launch
    function (``ops._build.launch``) while ``recording``: with ``graph``
    only the launches a CUDA graph capture records (which every replay
    then runs), else every launch."""

    def __init__(self):
        self.calls = []  # (kernel mode, entry point, sizes)

    @contextlib.contextmanager
    def recording(self, graph: bool):
        from pggan_tpu_torch.ops import _build
        orig = _build.launch

        def logged(name, fn, device, *args):
            if not graph or torch.cuda.is_current_stream_capturing():
                dims = yardstick.call_dims(fn, args)
                if dims is not None:
                    self.calls.append((name, fn, dims))
            return orig(name, fn, device, *args)

        _build.launch = logged
        try:
            yield self
        finally:
            _build.launch = orig

    def bound_s(self, fns: tuple) -> float | None:
        """The least seconds the recorded calls to ``fns`` allow, or None
        where there were none."""
        calls = [c for c in self.calls if c[1] in fns]
        if not calls:
            return None
        return sum(yardstick.bound_s(*yardstick.work(*c)) for c in calls)
