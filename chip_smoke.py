#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version at the shapes of the
depth-8 (1024 px) paper-configuration serve (the fused conv pair also
against the two unfused calls it replaces) and the bf16 pool and upsample
at every shape of a bf16 train step, serves a random-init
paper-configuration snapshot through ``pggan_tpu_torch.cli.generate``,
checks what comes out against the same model run on the CPU, holds the
serve's pinned copy to the host against the pageable one, and profiles one
served chunk, then trains the paper configuration for a few WGAN-GP steps
at depth 8, eagerly and as CUDA graph replays (the replay held against the
eager step), holds every kernel against its plain version at every shape
one train step gives it, holds a depth-6 train step against the same step
on the CPU, profiles warm depth-8 train steps (device time by kernel,
device busy share, launches from the host; ``utils/profiling.py``), runs a
progressive training run from depth 0 to 8 through
``pggan_tpu_torch.cli.train``, stopped short and resumed from its
checkpoint, then trains a one-channel 512 px sound model on seeded WAVs
(their STFT images made on the card and held against the host path) with
the SoundSaver's Griffin-Lim on the card, serves it through the generate
CLI's SoundSaver (Griffin-Lim held against the CPU), builds an image
folder's disk pyramid through the host library and scores the depth-8
snapshot with ``pggan_tpu_torch.cli.eval`` (SWD and MS-SSIM held against
the CPU). Then bf16 mixed precision: a bf16 serve in turns with the f32
ones, the bf16 depth-8 step eager and replayed (profiled), a depth-6 bf16
step against the CPU's bf16 route, a bf16 progressive run through the
train CLI; the export CLI on the f32 and bf16 depth-8 snapshots, one
artifact run by a process that imports neither package. Last, data
parallelism on the one card (phases A-D): the graphed depth-8 step under
a one-rank NCCL process group (its replay against a group-less step, the
NCCL kernels in the replay's profile), two gloo ranks sharing the card
against one process's global-batch step, the train CLI under ``torchrun
--nproc_per_node 1`` with a resume, and ``sample_images`` over two
replicas of G on the card against the one-device serve. Then grouped
dispatch (phase E): a group of 8 depth-8 steps, one CUDA graph replay,
against 8 single-step replays from one state, and the step time through
the ``Trainer`` at depths 0, 2, 4 and 8 with 1 and 8 steps a dispatch,
each key's warm-up and capture, and the pinned bytes held in flight
against the budget. ``DepthManager(precompile_ahead=True)`` (phase F,
last, in a process that has trained at its shapes as a real run has):
progressive stretches through the ``Trainer`` with the option off and on
from one state, every key replayed from its first dispatch, with the
background warm-up and capture seconds, the foreground stall at each key,
the steps beside a precompile and the peak memory. Where on and off part,
the stretch runs again with the precompiles on the training thread, and
both ways with cuDNN off, to show where they part (``PRECOMPILE_BAR``).

    python3 chip_smoke.py

Phases B and C start this script again as their ranks
(``--gloo-rank``, ``--cli-rank``).

Run it from the root of the repository. It exits nonzero without a CUDA
card, and its last line is ``{"ok": true, "device": {...}}`` only when
every phase passed. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH = 16  # the serve's --minibatch
TRAIN_DEPTH = 8  # 1024 px
TRAIN_BATCH = 3  # the paper's minibatch at depth 8 (schedule.py:15)
CHECK_DEPTH = 6  # 256 px: the card-vs-CPU step
LR = 1e-3
CONV_TOL = dict(rtol=1e-4, atol=1e-5)  # same math, f32 sums in another order
# The conv family and the weight gradient are held against their plain
# versions evaluated in float64 on the same inputs. Against float64, the
# f32 plain version (cuDNN) is off by up to 2.1e-5 at pixelnorm's 1024 px
# serve shape, where the kernel is off by 1.5e-5 (this script's phase 3 on
# an H100), so comparing the kernel with the f32 plain version would
# measure mostly the plain version's own rounding; the f32 plain version's
# error is printed beside.
# the weight gradient sums over up to 6.3 M pixels: rtol 1e-4 and an
# absolute bar of 1e-5 times the largest element (a small element keeps
# the absolute error of the large sums)
DW_TOL = dict(rtol=1e-4, scaled_atol=1e-5)
NET_TOL = dict(rtol=2e-3, atol=3e-4)   # tests/test_torch_parity_network.py
# the depth-6 train step on the card against the CPU: losses at rtol 1e-4
# (f32 sums in another order, a second derivative inside the GP); each
# gradient tensor at rtol 1e-3 and an absolute bar of 1e-2 times its
# largest element. The bar comes from a float64 run of the same step on
# the CPU: against it the CPU's own float32 gradients are off by up to
# 3.7e-3 of the largest element (D's 16 px conv, through the GP's
# second-order terms over 512 channels) and the card's by up to 2.4e-3;
# card against CPU measured 3.4e-3 (on an H100).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = dict(rtol=1e-3, scaled_atol=1e-2)

# a replayed depth-8 step against the eager step from the same state and
# draws: the update each tensor took, |replay - eager| / |eager| in the
# 2-norm, at most 1e-3. Both run with cuDNN's deterministic algorithms
# (its default ones for the low-resolution convs' gradients may sum with
# atomics, so two eager steps from one state differ from run to run, by as
# much as the bar: phase 5 logs by how much), so the two routes run the
# same kernels and the gradients could differ by f32 summation order at
# most; Adam's division by
# sqrt(nu) passes that noise on in full for the few elements whose
# gradient is a cancellation, so the bar is on each tensor's norm, not
# its largest element. A wrong update is far outside: none at all is 1;
# the compared step takes an alpha and learning rates other than the
# capture's, so a baked-in lr is at least 0.4; a bias correction one step
# stale is 1.6e-2 at the step count there (28, b2 0.99).
UPDATE_TOL = 1e-3
# phase F: precompile_ahead on against off over a progressive stretch.
# Bit for bit, or else all of: (1) the generator states equal and the
# whole update over the stretch within UPDATE_TOL of its norm; (2) at the
# first step whose metrics differ they differ by rounding, within
# STEP_LOSS_RTOL; (3) the same run with the precompiles on the training
# thread equals off bit for bit (the thread is the only cause); (4) with
# cuDNN off (and single steps), on equals off bit for bit (the cause is
# in cuDNN: PyTorch keeps cuDNN's plan picks per thread, so the
# precompile thread's graphs may run other deterministic plans than the
# training thread's cache holds).
PRECOMPILE_BAR = ("bit for bit, or: generator equal and the update within "
                  "UPDATE_TOL of its norm, the first differing step within "
                  "STEP_LOSS_RTOL, on the training thread bit for bit, "
                  "cuDNN off bit for bit")
REPLAY_ALPHA, REPLAY_LR = 0.3, (0.6e-3, 0.3e-3)

# Phase W, the wide-channel NCHW conv pair (ops/wide_conv.py): one eager
# fade step of each benchmark train cell (configuration shape, depth,
# batch) and one serve forward (depth 7, chunk 16) give every call the
# route sends to the kernels; each distinct call is held against its twin
# in float64 (relative to the reference's largest element; cuDNN's float32
# error at the same call, TF32 off, printed beside) and timed back to back
# beside cuDNN's call for the same function. Then a replayed d4 step
# against the eager step from one state, bit for bit (cuDNN held to its
# deterministic algorithms on both).
WIDE_CELLS = (("rgb1024 d4", (1, 3, 1024, 1024), 4, 16),
              ("rgb1024 d8", (1, 3, 1024, 1024), 8, 3),
              ("spec512 d7", (1, 1, 512, 512), 7, 6))
WIDE_SERVE = ("spec512 serve d7", (1, 1, 512, 512), 7, 16)
WIDE_TOL = 1e-5

# NHCW shapes of the depth-8 tail, stages 5-7 (256, 512, 1024 px):
# (upsample input), and (C, K1, K2) of each stage's conv pair
STAGES = [((BATCH, 128, 64, 128), (64, 32, 32)),
          ((BATCH, 256, 32, 256), (32, 16, 16)),
          ((BATCH, 512, 16, 512), (16, 8, 8))]

# every weight-gradient shape (res, x's C, the cotangent's K) of a depth-8
# train step's NHCW stages at batch TRAIN_BATCH: G's tail at 256-1024 px,
# D's head at 1024-128 px (phase 3 times #4 at each against
# convolution_backward)
STEP_DW = [(256, 64, 32), (256, 32, 32), (512, 32, 16), (512, 16, 16),
           (1024, 16, 8), (1024, 8, 8), (1024, 8, 16), (512, 16, 32),
           (256, 32, 64), (128, 64, 64), (128, 64, 128)]

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "upsample2x": ("pggan_tpu_torch/csrc/upsample2x.cu",
                   "pggan_tpu/ops/pallas_resample.py:134"),
    "conv3x3": ("pggan_tpu_torch/csrc/conv3x3.cu",
                "pggan_tpu/ops/pallas_conv.py:253"),
    "conv3x3_act": ("pggan_tpu_torch/csrc/conv3x3.cu",
                    "pggan_tpu/ops/pallas_conv.py:295"),
    "conv3x3_act_pn": ("pggan_tpu_torch/csrc/conv3x3.cu",
                       "pggan_tpu/ops/pallas_conv.py:295"),
    "conv3x3_chain": ("pggan_tpu_torch/csrc/conv_chain.cu",
                      "pggan_tpu/ops/pallas_chain.py:204"),
    "conv3x3_chain_pn": ("pggan_tpu_torch/csrc/conv_chain.cu",
                         "pggan_tpu/ops/pallas_chain.py:204"),
    "conv3x3_dw": ("pggan_tpu_torch/csrc/conv3x3_dw.cu",
                   "pggan_tpu/ops/pallas_conv.py:398"),
    "avgpool2x": ("pggan_tpu_torch/csrc/avgpool2x.cu",
                  "pggan_tpu/ops/pallas_resample.py:110"),
    # the bf16 instantiations of #5 and #6 (the TPU kernels are f32 only):
    # the bf16 models' NCHW pools, G's fade upsample and their transposes
    "avgpool2x_bf16": ("pggan_tpu_torch/csrc/avgpool2x.cu",
                       "pggan_tpu/ops/pallas_resample.py:110"),
    "upsample2x_bf16": ("pggan_tpu_torch/csrc/upsample2x.cu",
                        "pggan_tpu/ops/pallas_resample.py:134"),
}
# The card's published peaks for the bounds (NVIDIA H100 SXM data sheet,
# dense, at its 700 W limit): memory 3.35 TB/s; f32 products on the tensor
# cores as three TF32 products (495 / 3 TFLOP/s), the kernels' arithmetic;
# f32 FMAs outside them 67 TFLOP/s, printed beside it.
HBM_BYTES_PER_S = 3.35e12
TF32X3_FLOP_PER_S = 495e12 / 3
FMA_FLOP_PER_S = 67e12
SERVE_ONLY = ("conv3x3_chain", "conv3x3_chain_pn")
# the wide-channel conv kernel's launches in a depth-8 paper G forward: the
# NCHW stages' c2 at 16, 32, 64 and 128 px (ops/wide_conv.py's rule)
WIDE_PER_FORWARD = 4
SERVE_KERNELS = ("upsample2x", "conv3x3", "conv3x3_act", "conv3x3_act_pn",
                 *SERVE_ONLY)
BF16_KERNELS = ("avgpool2x_bf16", "upsample2x_bf16")
TRAIN_KERNELS = tuple(k for k in KERNELS
                      if k not in SERVE_ONLY + BF16_KERNELS)


def log(msg: str) -> None:
    print(msg, flush=True)


def element_bytes(name: str) -> int:
    """The bytes of one element a kernel mode moves: 2 for the bf16
    instantiations (``*_bf16``), else 4 (f32)."""
    return 2 if name.endswith("_bf16") else 4


def work(name: str, sig) -> tuple:
    """(FLOPs, bytes) of one call of kernel ``name`` with call signature
    ``sig`` (its arguments, tensors as shapes, as ``CallLog`` records
    them): a multiply-add counts two FLOPs, and each input element is read
    once and each output written once, at the mode's element size."""
    shapes = [a for a in sig if isinstance(a, tuple)]
    read = sum(math.prod(s) for s in shapes)
    eb = element_bytes(name)
    name = name.removesuffix("_bf16")
    if name in ("conv3x3", "conv3x3_act", "conv3x3_act_pn"):
        (n, h, c, w), k = shapes[0], shapes[1][3]
        out = n * h * k * w + (n * h * w if name == "conv3x3_act_pn" else 0)
        return 2 * n * h * w * 9 * c * k, 4 * (read + out)
    if name == "conv3x3_dw":
        (n, h, c, w), k = shapes[0], shapes[1][2]
        return 2 * n * h * w * 9 * c * k, 4 * (read + 9 * c * k)
    if name in SERVE_ONLY:
        (n, h, c, w), k1, k2 = shapes[0], shapes[1][3], shapes[3][3]
        return (2 * n * h * w * 9 * (c * k1 + k1 * k2),
                4 * (read + n * h * k2 * w))
    if name == "avgpool2x":
        return 0, eb * (read + read // 4)
    if name == "upsample2x":
        return 0, eb * (read + 4 * read)
    raise KeyError(name)


def achieved_gb_per_s(name: str, sig, ms: float) -> float:
    """The bytes ``work`` counts for one call, over its measured ms, in
    GB/s (to set beside the card's 3.35 TB/s)."""
    return work(name, sig)[1] / ms / 1e6


def bounds(flops: float, nbytes: float) -> tuple:
    """The least time (ms) the card could take for this work: the larger of
    bytes over the memory rate and FLOPs over the three-product TF32 rate;
    which of the two it is; and the f32 FMA bound (ms) beside it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / TF32X3_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            flops / FMA_FLOP_PER_S * 1e3)


def library_call(torch, name, args):
    """One PyTorch call that computes the same function as kernel ``name``
    on ``args``, on NCHW-contiguous copies (TF32 off): the yardstick beside
    the kernel, which the port never calls. None where there is no such
    call (the fused epilogues and the chain)."""
    F = torch.nn.functional
    nchw = lambda t: t.permute(0, 2, 1, 3).contiguous()  # noqa: E731
    name = name.removesuffix("_bf16")  # the same call on bf16 tensors
    if name == "conv3x3":
        x, w = nchw(args[0]), args[1].permute(3, 2, 0, 1).contiguous()
        return lambda: F.conv2d(x, w, padding=1)
    if name == "conv3x3_dw":
        x, ct = nchw(args[0]), nchw(args[1])
        w = torch.empty((ct.shape[1], x.shape[1], 3, 3), device=x.device)
        return lambda: torch.ops.aten.convolution_backward(
            ct, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])
    if name in ("avgpool2x", "upsample2x"):
        t, h_axis, _w_axis = args
        h, w = t.shape[h_axis], t.shape[-1]
        x = t.movedim(h_axis, -2).reshape(1, -1, h, w).contiguous()
        if name == "avgpool2x":
            return lambda: F.avg_pool2d(x, 2)
        return lambda: F.interpolate(x, scale_factor=2, mode="nearest")
    return None


def burst_ms(torch, fn, calls: int = 100) -> float:
    """Device time a call of ``calls`` back-to-back calls between two CUDA
    events: the host's launch time hides behind the queued work, where
    ``time_ms``'s single bracketed call includes it."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


class KernelChecks:
    """Phase 3: each kernel mode against its plain version on the card."""

    def __init__(self, torch):
        self.torch = torch
        self.gen = torch.Generator(device="cuda").manual_seed(SEED)
        # per kernel mode: max |kernel - plain|; and sums["serve"] /
        # sums["train"] of kernel, plain and library ms, and of the bounds,
        # over the shapes one depth-8 serve forward runs (ragged checks are
        # not timed) / over the calls of one depth-8 train step
        # (train_shapes)
        self.err = {k: 0.0 for k in KERNELS}
        # upsample2x's train shapes: (one bracketed call, a call of a
        # back-to-back burst) ms, to show the host's share of a call
        self.host = {}
        self.sums = {per: {k: collections.Counter() for k in KERNELS}
                     for per in ("serve", "train")}
        # phase 6's conv and weight-gradient calls, one row a shape: the
        # kernel against the library call, bracketed and back to back
        self.shape_rows = []
        # phase 3's weight gradient at each STEP_DW shape, the same
        self.dw_rows = []
        self.last = {}

    def rand(self, *shape, scale=1.0):
        return self.torch.randn(*shape, device="cuda",
                                generator=self.gen) * scale

    @staticmethod
    def f64(fn, *args):
        """``fn`` (a plain version) on float64 copies of ``args``."""
        return lambda: fn(*(a.double() if hasattr(a, "double") else a
                            for a in args))

    def check(self, name, label, kernel, plain, exact=False, timed=True,
              tol=None, count=None, args=None, reference=None):
        """Kernel against plain: exactly, or within ``tol`` (CONV_TOL by
        default; ``scaled_atol`` scales the absolute bar to the plain
        output's largest element); against ``reference`` (the plain
        version in float64) instead where it is given. Timed calls add to
        the serve sums, or, with ``count``, ``count`` times to the
        train-step sums; with the call's ``args`` the library call and the
        bounds are added too."""
        torch = self.torch
        base = CONV_TOL if tol is None else tol
        as_tuple = lambda v: v if isinstance(v, tuple) else (v,)  # noqa: E731
        got, want = as_tuple(kernel()), as_tuple(plain())
        ref = as_tuple(reference()) if reference is not None else want
        torch.cuda.synchronize()
        plain_err = 0.0
        for g, w, r in zip(got, want, ref):
            if g.shape != r.shape:
                raise AssertionError(f"{name} {label}: shape {tuple(g.shape)}"
                                     f" != {tuple(r.shape)}")
            if not g.numel():
                continue
            g = g.to(r.dtype)
            err = float((g - r).abs().max())
            self.err[name] = max(self.err[name], err)
            if reference is not None:
                plain_err = max(plain_err,
                                float((w.to(r.dtype) - r).abs().max()))
            tol = base
            if "scaled_atol" in base:
                tol = dict(rtol=base["rtol"], atol=base["scaled_atol"]
                           * max(float(r.abs().max()), 1e-30))
            ok = (torch.equal(g, r) if exact
                  else torch.allclose(g, r, **tol))
            if not ok:
                raise AssertionError(f"{name} {label}: max abs err {err} "
                                     f"outside {'exact' if exact else tol}")
        line = f"  {name:17s} {label:34s} max_abs_err {self.err[name]:.3e}"
        if reference is not None:
            line += f" (vs f64; f32 plain {plain_err:.3e})"
        if not timed:
            log(line)
            return None
        reps = 10 if count is None else 5
        t = {"ms": time_ms(torch, kernel, reps=reps),
             "plain_ms": time_ms(torch, plain, reps=reps)}
        line += (f"  x{count or 1}  kernel {t['ms']:.3f} ms  plain "
                 f"{t['plain_ms']:.3f} ms")
        if args is not None:
            lib = library_call(torch, name, args)
            if lib is not None:
                t["library_ms"] = time_ms(torch, lib, reps=reps)
            sig = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                        for a in args)
            flops, nbytes = work(name, sig)
            t["bound_ms"], by, t["fma_bound_ms"] = bounds(flops, nbytes)
            t[f"{by}_bound_ms"] = t["bound_ms"]
            line += ("  library " + (f"{t['library_ms']:.3f} ms"
                                     if lib is not None else "none")
                     + f"  bound {t['bound_ms']:.3f} ms ({by}; "
                     f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)  "
                     f"f32 FMA bound {t['fma_bound_ms']:.3f} ms")
        sums = self.sums["serve" if count is None else "train"][name]
        for key, v in t.items():
            sums[key] += (count or 1) * v
        log(line)
        self.last = t
        return t["ms"], t["plain_ms"]

    def conv_modes(self, x, w, b, label, timed=True):
        """The three conv modes against the plain version in float64;
        returns each mode's ms (timed calls)."""
        from pggan_tpu_torch.ops import conv3x3 as C
        plain = plain_versions()
        times = {}
        kernels = {"conv3x3": C.conv3x3,
                   "conv3x3_act": lambda x, w, b, s: C.conv3x3_act(
                       x, w, b, slope=s),
                   "conv3x3_act_pn": lambda x, w, b, s, e: C.conv3x3_act_pn(
                       x, w, b, slope=s, eps=e)}
        for name, args in (("conv3x3", (x, w)),
                           ("conv3x3_act", (x, w, b, 0.2)),
                           ("conv3x3_act_pn", (x, w, b, 0.2, 1e-8))):
            t = self.check(name, label,
                           lambda k=kernels[name], a=args: k(*a),
                           lambda p=plain[name], a=args: p(*a), timed=timed,
                           args=args, reference=self.f64(plain[name], *args))
            if t is not None:
                times[name] = t[0]
        return times

    def chain_modes(self, x, w1, b1, w2, b2, label, timed=True):
        """Both chain modes against the plain version in float64 (the f32
        plain version's error printed beside); returns each mode's ms, and
        adds its back-to-back time (a burst of 20) to the serve sums."""
        from pggan_tpu_torch.ops import conv_chain as CH
        times = {}
        for name, pn in (("conv3x3_chain_pn", 1e-8), ("conv3x3_chain", None)):
            def plain(*a, pn=pn):
                return CH.conv3x3_chain_plain(*a, slope=0.2, pn_eps=pn)

            def kernel(pn=pn):
                return CH.conv3x3_chain(*args, slope=0.2, pn_eps=pn)
            args = (x, w1, b1, w2, b2)
            t = self.check(name, label, kernel, lambda p=plain: p(*args),
                           timed=timed, args=args,
                           reference=self.f64(plain, *args))
            if t is not None:
                times[name] = t[0]
                self.sums["serve"][name]["burst_ms"] += burst_ms(
                    self.torch, kernel, 20)
        return times

    def layer(self, c, k):
        """He-scaled 3x3 weight (HWIO) and a small bias, as G's layers."""
        return (self.rand(3, 3, c, k, scale=(2.0 / (9 * c)) ** 0.5),
                self.rand(k, scale=0.1))

    def run(self):
        from pggan_tpu_torch.ops import resample as R
        torch = self.torch
        with torch.no_grad():
            for up_shape, (c, k1, k2) in STAGES:
                x = self.rand(*up_shape)
                t_up, _ = self.check("upsample2x", f"x {up_shape}",
                                     lambda: R.upsample_2x(x, 1, 3),
                                     lambda: R.upsample2x_plain(x, 1, 3),
                                     exact=True, args=(x, 1, 3))
                # device time from back-to-back calls: one bracketed call
                # (t_up) also holds the host's launch time
                sig = (up_shape, 1, 3)
                t_dev = burst_ms(torch, lambda: R.upsample_2x(x, 1, 3), 20)
                log(f"    upsample2x {up_shape}: {t_dev:.3f} ms a call back "
                    f"to back (one call {t_up:.3f}): "
                    f"{achieved_gb_per_s('upsample2x', sig, t_dev):.0f} GB/s,"
                    f" {bounds(*work('upsample2x', sig))[0] / t_dev:.1%} of "
                    f"its bytes bound (3.35 TB/s)")
                n, h, _c, w = up_shape
                xs = self.rand(n, 2 * h, c, 2 * w)
                w1, b1 = self.layer(c, k1)
                w2, b2 = self.layer(k1, k2)
                first = self.conv_modes(xs, w1, b1, f"{c}->{k1} at {2 * h} px")
                z = self.rand(n, 2 * h, k1, 2 * w)
                second = self.conv_modes(z, w2, b2,
                                         f"{k1}->{k2} at {2 * h} px")
                chain = self.chain_modes(xs, w1, b1, w2, b2,
                                         f"{c}->{k1}->{k2} at {2 * h} px")
                # the chain against the two calls it replaces
                for name, conv in (("conv3x3_chain_pn", "conv3x3_act_pn"),
                                   ("conv3x3_chain", "conv3x3_act")):
                    pair = first[conv] + second[conv]
                    self.sums["serve"][name]["unchained_ms"] += pair
                    log(f"    {name} at {2 * h} px: {chain[name]:.3f} ms "
                        f"against two {conv} {pair:.3f} ms: "
                        f"{chain[name] / pair:.2f}x")
                del x, xs, z
            for name in SERVE_ONLY:
                t = self.sums["serve"][name]
                log(f"  {name} per depth-8 serve forward: bracketed "
                    f"{t['ms']:.3f} ms, back to back {t['burst_ms']:.3f} ms, "
                    f"bound {t['bound_ms']:.3f} ms: "
                    f"{t['bound_ms'] / t['burst_ms']:.1%} of its bound back "
                    f"to back")
            self.dw_step_shapes()
            # ragged: H and W not multiples of any tile, to hold the masks
            x = self.rand(3, 37, 5, 45)
            self.check("upsample2x", "ragged x (3, 37, 5, 45)",
                       lambda: R.upsample_2x(x, 1, 3),
                       lambda: R.upsample2x_plain(x, 1, 3), exact=True,
                       timed=False)
            # W not a multiple of 4 (padded for TMA), H of no tile
            x = self.rand(2, 37, 24, 45)
            w, b = self.layer(24, 40)
            self.conv_modes(x, w, b, "ragged 24->40 (2, 37, ., 45)",
                            timed=False)
            # C and K of no tier, K not a multiple of 4
            w, b = self.layer(5, 7)
            self.conv_modes(self.rand(2, 37, 5, 44), w, b,
                            "ragged 5->7 (2, 37, ., 44)", timed=False)
            w1, b1 = self.layer(24, 16)
            w2, b2 = self.layer(16, 8)
            self.chain_modes(x, w1, b1, w2, b2,
                             "ragged 24->16->8 (2, 37, ., 45)", timed=False)
            self.train_kernels_ragged()
        torch.cuda.empty_cache()

    def dw_step_shapes(self):
        """The weight gradient at each STEP_DW shape: against float64
        (DW_TOL) and bit for bit across two calls, then timed back to back
        (a burst of 20) and bracketed beside convolution_backward; at K >=
        64 also with k tiles of 32 beside the plan's 64, held and timed the
        same way."""
        from pggan_tpu_torch.ops import conv3x3 as C
        torch = self.torch
        for res, c, k in STEP_DW:
            x = self.rand(TRAIN_BATCH, res, c, res)
            ct = self.rand(TRAIN_BATCH, res, k, res)
            sig = ((TRAIN_BATCH, res, c, res), (TRAIN_BATCH, res, k, res))
            label = f"step x {sig[0]} K {k}"
            kt = C.dw_plan(*sig[0], k)[0]
            tiers = (kt, 32) if k >= 64 else (kt,)
            row = {"sig": [list(a) for a in sig], "kt": kt}
            for tier in tiers:
                def kernel(t=tier):
                    return C._dw_fwd(x, ct, kt=t)
                if not torch.equal(kernel(), kernel()):
                    raise AssertionError(f"conv3x3_dw {label} KT {tier}: "
                                         f"two calls differ")
                self.check("conv3x3_dw", f"{label} KT {tier}", kernel,
                           lambda: C.conv3x3_dw_plain(x, ct), tol=DW_TOL,
                           timed=False,
                           reference=self.f64(C.conv3x3_dw_plain, x, ct))
                row[f"kt{tier}"] = {"ms": time_ms(torch, kernel),
                                    "burst_ms": burst_ms(torch, kernel, 20)}
            lib = library_call(torch, "conv3x3_dw", (x, ct))
            row["library_ms"] = time_ms(torch, lib)
            row["library_burst_ms"] = burst_ms(torch, lib, 20)
            row["bound_ms"] = bounds(*work("conv3x3_dw", sig))[0]
            mine = row[f"kt{kt}"]
            ratio = mine["burst_ms"] / row["library_burst_ms"]
            other = (f"; KT 32 {row['kt32']['burst_ms']:.4f} back to back"
                     if k >= 64 else "")
            log(f"    conv3x3_dw {label} (KT {kt}): kernel "
                f"{mine['burst_ms']:.4f} ms back to back, {mine['ms']:.4f} "
                f"bracketed{other}; convolution_backward "
                f"{row['library_burst_ms']:.4f} / {row['library_ms']:.4f}: "
                f"kernel / library {ratio:.2f}x back to back; bound "
                f"{row['bound_ms']:.4f} ms")
            self.dw_rows.append(row)
            del x, ct

    def train_kernels_ragged(self):
        """The training kernels at shapes no tile divides, and the conv
        at the D head's K = 128 (two launches of 64 channels)."""
        from pggan_tpu_torch.ops import conv3x3 as C
        from pggan_tpu_torch.ops import resample as R
        x, ct = self.rand(2, 37, 5, 45), self.rand(2, 37, 7, 45)
        self.check("conv3x3_dw", "ragged x (2, 37, 5, 45) K 7",
                   lambda: C.conv3x3_dw(x, ct),
                   lambda: C.conv3x3_dw_plain(x, ct), tol=DW_TOL,
                   timed=False,
                   reference=self.f64(C.conv3x3_dw_plain, x, ct))
        # W a multiple of 4 but of no tile (H ragged too), C and K of no
        # tier
        x, ct = self.rand(2, 37, 5, 44), self.rand(2, 37, 7, 44)
        self.check("conv3x3_dw", "ragged x (2, 37, 5, 44) K 7",
                   lambda: C.conv3x3_dw(x, ct),
                   lambda: C.conv3x3_dw_plain(x, ct), tol=DW_TOL,
                   timed=False,
                   reference=self.f64(C.conv3x3_dw_plain, x, ct))
        x = self.rand(3, 38, 5, 46)
        self.check("avgpool2x", "ragged x (3, 38, 5, 46)",
                   lambda: R.avg_pool_2x(x, 1, 3),
                   lambda: R.avgpool2x_plain(x, 1, 3), exact=True,
                   timed=False)
        x = self.rand(TRAIN_BATCH, 128, 64, 128)
        w, b = self.layer(64, 128)
        self.check("conv3x3_act", "K 128: 64->128 at 128 px",
                   lambda: C.conv3x3_act(x, w, b, slope=0.2),
                   lambda: C.conv3x3_act_plain(x, w, b, slope=0.2),
                   timed=False, reference=self.f64(
                       plain_versions()["conv3x3_act"], x, w, b, 0.2))
        self.check("conv3x3", "K 128: 64->128 at 128 px",
                   lambda: C.conv3x3(x, w), lambda: C.conv3x3_plain(x, w),
                   timed=False, reference=self.f64(C.conv3x3_plain, x, w))

    def train_shapes(self, calls, names=TRAIN_KERNELS, per="fade step"):
        """Every kernel call of one depth-8 train step (``CallLog``), each
        distinct shape held against its plain version once and timed: one
        bracketed call (host launch path included) and a call of a
        back-to-back burst (device time); the times count as often as the
        step made the call. The weight gradient's two calls at each shape
        must agree bit for bit; the resamples must equal their plain
        versions (f32 and bf16). ``names`` are the kernels summarised."""
        torch = self.torch
        plain = plain_versions()
        with torch.no_grad():
            for (name, sig), count in sorted(calls.items()):
                if name not in names:
                    continue
                dtype = (torch.bfloat16 if name.endswith("_bf16")
                         else torch.float32)
                args = []
                for a in sig:
                    if isinstance(a, tuple):  # a tensor's shape
                        scale = ((2.0 / (9 * a[2])) ** 0.5 if len(a) == 4
                                 and a[:2] == (3, 3) else 1.0)
                        args.append(self.rand(*a, scale=scale).to(dtype))
                    else:
                        args.append(a)
                label = " ".join(str(a) for a in sig)
                if name == "conv3x3_dw":
                    first = CallLog.ORIGINAL[name](*args)
                    if not torch.equal(first, CallLog.ORIGINAL[name](*args)):
                        raise AssertionError(f"conv3x3_dw {label}: two calls"
                                             f" differ")
                    del first
                t_k, _t_p = self.check(
                    name, label[:34],
                    lambda: CallLog.ORIGINAL[name](*args),
                    lambda: plain[name](*args),
                    exact=name.removesuffix("_bf16") in ("avgpool2x",
                                                         "upsample2x"),
                    tol=DW_TOL if name == "conv3x3_dw" else None,
                    count=count, args=args,
                    reference=(self.f64(plain[name], *args)
                               if name in F64_REFERENCE else None))
                burst = burst_ms(
                    torch, lambda a=args: CallLog.ORIGINAL[name](*a), 20)
                self.sums["train"][name]["burst_ms"] += count * burst
                if name == "upsample2x":
                    self.host[sig] = (t_k, burst)
                if name in F64_REFERENCE:
                    self.shape_row(name, sig, count, t_k, burst, args)
                del args
        torch.cuda.empty_cache()
        for sig, (one, burst) in sorted(
                self.host.items(), key=lambda kv: math.prod(kv[0][0]))[:3]:
            log(f"  upsample2x {sig[0]}: one bracketed call {one * 1e3:.1f} "
                f"us, in a burst {burst * 1e3:.1f} us a call")
        self.host.clear()
        for name in names:
            t = self.sums["train"][name]
            if not t["burst_ms"]:
                raise AssertionError(f"{name}: no call of the step checked")
            log(f"  {name:15s} per {per}: bracketed {t['ms']:.3f} ms, "
                f"back to back {t['burst_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.3f} ms: {t['bound_ms'] / t['burst_ms']:.1%}"
                f" of its bound back to back")

    def shape_row(self, name, sig, count, ms, burst, args):
        """One conv or weight-gradient call of the step: the kernel against
        its library call (where one computes the same function), each one
        bracketed call and a call of a back-to-back burst of 20."""
        lib = library_call(self.torch, name, args)
        row = {"name": name, "sig": [list(a) if isinstance(a, tuple) else a
                                     for a in sig],
               "count": count, "ms": ms, "burst_ms": burst,
               "library_ms": self.last.get("library_ms"),
               "library_burst_ms": (burst_ms(self.torch, lib, 20)
                                    if lib is not None else None),
               "bound_ms": self.last["bound_ms"]}
        self.shape_rows.append(row)
        if lib is not None:
            log(f"    {name} {sig}: kernel {ms:.4f} ms bracketed, "
                f"{burst:.4f} back to back; library "
                f"{row['library_ms']:.4f} / {row['library_burst_ms']:.4f}: "
                f"kernel / library {burst / row['library_burst_ms']:.2f}x "
                f"back to back")


F64_REFERENCE = ("conv3x3", "conv3x3_act", "conv3x3_act_pn", "conv3x3_dw")


def plain_versions():
    """Each train-path kernel's plain version, with the kernel wrapper's
    positional arguments (as ``CallLog`` records them)."""
    from pggan_tpu_torch.ops import conv3x3 as C
    from pggan_tpu_torch.ops import resample as R
    return {"conv3x3": C.conv3x3_plain,
            "conv3x3_act": lambda x, w, b, s: C.conv3x3_act_plain(
                x, w, b, slope=s),
            "conv3x3_act_pn": lambda x, w, b, s, e:
                C.conv3x3_act_pn_plain(x, w, b, slope=s, eps=e),
            "conv3x3_dw": C.conv3x3_dw_plain,
            "avgpool2x": R.avgpool2x_plain,
            "upsample2x": R.upsample2x_plain,
            "avgpool2x_bf16": R.avgpool2x_plain,  # the twins take bf16
            "upsample2x_bf16": R.upsample2x_plain}


class CallLog:
    """Records the kernel wrappers' calls (kernel mode and input shapes) on
    the train path, and which weight-gradient calls fall inside the
    gradient penalty's inner ``autograd.grad``: there should be none, as
    in the JAX package (``ops/conv3x3.py:input_grad_only``). A resample
    call on bf16 tensors records as its bf16 mode (``*_bf16``)."""

    ORIGINAL: dict = {}

    def __init__(self):
        from pggan_tpu_torch.ops import conv3x3 as C
        from pggan_tpu_torch.ops import resample as R
        self.sites = {"conv3x3": (C, "_conv_fwd"),
                      "conv3x3_act": (C, "_act_fwd"),
                      "conv3x3_act_pn": (C, "_act_pn_fwd"),
                      "conv3x3_dw": (C, "_dw_fwd"),
                      "avgpool2x": (R, "_pool"),
                      "upsample2x": (R, "_upsample")}
        for name, (mod, attr) in self.sites.items():
            CallLog.ORIGINAL.setdefault(name, getattr(mod, attr))
        for name in BF16_KERNELS:
            CallLog.ORIGINAL.setdefault(
                name, CallLog.ORIGINAL[name.removesuffix("_bf16")])
        self.calls = collections.Counter()
        self.gp_dw = collections.Counter()
        self._in_gp = False

    @contextlib.contextmanager
    def recording(self):
        import torch
        from pggan_tpu_torch import losses

        def wrap(name):
            orig = CallLog.ORIGINAL[name]

            def logged(*args):
                sig = tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                            else a for a in args)
                bf16 = any(isinstance(a, torch.Tensor)
                           and a.dtype == torch.bfloat16 for a in args)
                self.calls[(name + "_bf16" if bf16 else name, sig)] += 1
                if self._in_gp and name == "conv3x3_dw":
                    self.gp_dw[(name, sig)] += 1
                return orig(*args)
            return logged

        gp = losses.calc_gradient_penalty

        def gp_logged(*args, **kwargs):
            self._in_gp = True
            try:
                return gp(*args, **kwargs)
            finally:
                self._in_gp = False

        for name, (mod, attr) in self.sites.items():
            setattr(mod, attr, wrap(name))
        losses.calc_gradient_penalty = gp_logged
        try:
            yield self
        finally:
            for name, (mod, attr) in self.sites.items():
                setattr(mod, attr, CallLog.ORIGINAL[name])
            losses.calc_gradient_penalty = gp


def serve(torch, snapshot, argv, expect, tag):
    """One run of the generate CLI on the card; returns its images (NCHW
    numpy) and launch counts, and checks the counts against ``expect``."""
    from pggan_tpu_torch.cli.generate import cli_main
    from pggan_tpu_torch.ops import _build
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = cli_main(["--generator_path", snapshot, *argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    log(f"  {tag}: {out.shape[0]} images in {secs:.3f} s (whole CLI run, "
        f"snapshot load included); launches {counts}")
    if counts != expect:
        raise AssertionError(f"{tag}: launches {counts}, expected {expect}")
    return out, counts


def against_cpu(torch, snapshot, out, n, chain, tag):
    """The first ``n`` served images against the same snapshot and latents
    run on the CPU through the plain versions."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot
    from pggan_tpu_torch.sampling import sample_images
    G, meta = load_snapshot(snapshot, device="cpu")
    G.inference_chain = chain
    ref = sample_images(G, meta["depth"], meta["alpha"], n,
                        rng=np.random.RandomState(SEED)).transpose(0, 3, 1, 2)
    err = float(np.abs(out[:n] - ref).max())
    np.testing.assert_allclose(out[:n], ref, **NET_TOL,
                               err_msg=f"{tag} vs CPU plain")
    log(f"  {tag}: {n} images match the CPU plain run, max abs err {err:.3e}")


def serve_phase(torch, card):
    """Phase 4: the serving path through the CLI, at full paper width."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import save_snapshot
    from pggan_tpu_torch.models.generator import Generator
    from pggan_tpu_torch.sampling import sample_images
    # the ported kernels' counts, and the wide conv's
    total = collections.Counter({k: 0 for k in KERNELS})
    paper = dict(dataset_shape=(1, 3, 1024, 1024))  # fmap_base 4096 etc.
    fwd = -(-40 // BATCH)  # forwards of a 40-image request
    wide = WIDE_PER_FORWARD
    runs = [
        # (tag, config, alpha, extra flags, n images, expected launches,
        #  images checked against the CPU)
        ("paper, stable, chain", {}, 1.0, [], 40,
         {"conv3x3_chain_pn": 3 * fwd, "upsample2x": 3 * fwd,
          "wide_conv": wide * fwd}, 2),
        ("paper, fade 0.5, chain", {}, 0.5, [], 40,
         {"conv3x3_chain_pn": 3 * fwd, "upsample2x": 4 * fwd,
          "wide_conv": wide * fwd}, 2),
        ("paper, stable, chain off", {}, 1.0,
         ["--inference_chain", "False"], 40,
         {"conv3x3_act_pn": 6 * fwd, "upsample2x": 3 * fwd,
          "wide_conv": wide * fwd}, 2),
        ("pixelnorm off, chain", {"pixelnorm": False}, 1.0, [], BATCH,
         {"conv3x3_chain": 3, "upsample2x": 3, "wide_conv": wide}, 1),
        ("pixelnorm off, chain off", {"pixelnorm": False}, 1.0,
         ["--inference_chain", "False"], BATCH,
         {"conv3x3_act": 6, "upsample2x": 3, "wide_conv": wide}, 1),
        ("relu", {"leakyrelu": False}, 1.0, [], BATCH,
         {"conv3x3": 6, "upsample2x": 3, "wide_conv": wide}, 1),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, cfg, alpha, flags, n, expect, n_cpu) in enumerate(runs):
            G = Generator(**paper, **cfg,
                          generator=torch.Generator().manual_seed(SEED + i))
            snap = os.path.join(tmp, f"network-snapshot-generator-{i:06}.dat")
            save_snapshot(snap, G, depth=8, alpha=alpha)
            del G
            out, counts = serve(torch, snap,
                                ["--minibatch", str(BATCH), "--num_samples",
                                 str(n), "--random_seed", str(SEED), *flags],
                                expect, tag)
            for k, v in counts.items():
                total[k] += v
            if out.shape != (n, 3, 1024, 1024) or not np.isfinite(out).all():
                raise AssertionError(f"{tag}: output {out.shape}, finite "
                                     f"{bool(np.isfinite(out).all())}")
            against_cpu(torch, snap, out, n_cpu,
                        "--inference_chain" not in flags, tag)
            if i == 0:
                rate = steady_rate(torch, snap, sample_images)
                log(f"  serve rate, depth 8 (1024 px), batch {BATCH}, f32: "
                    f"{rate['pinned']:.2f} img/s pinned, "
                    f"{rate['pageable']:.2f} pageable, on {card}")
                profile = serve_profile(torch, snap, sample_images)
            del out
    return total, rate, profile


def pageable_route(torch, G, depth, alpha, num_samples, minibatch, rng):
    """``sample_images`` as it was before its pinned copy: each chunk's
    forward, then a blocking ``.cpu().numpy()`` into pageable memory."""
    import numpy as np
    from pggan_tpu_torch.utils.misc import random_latents
    outs, done = [], 0
    with torch.inference_mode():
        while done < num_samples:
            take = min(minibatch, num_samples - done)
            z = random_latents(take, G.latent_size, rng)
            if take < minibatch:
                z = np.concatenate(
                    [z, np.zeros((minibatch - take, G.latent_size), z.dtype)])
            imgs = G(torch.from_numpy(z).cuda(), depth, alpha,
                     fade=alpha < 1.0)
            outs.append(imgs[:take].cpu().numpy())
            done += take
    return np.concatenate(outs)


def steady_rate(torch, snap, sample_images):
    """Images per second of warm ``sample_images`` calls (the pinned,
    overlapped copy) and of the pageable route before it, 3 chunks of
    BATCH each, timed on the host clock around a synchronised call, in
    turns (pageable, pinned, pinned, pageable, ...). The two routes' images
    of a request whose last chunk is padded must be the same bytes, with
    cuDNN held to deterministic algorithms."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot
    G, meta = load_snapshot(snap, device="cuda")
    G.inference_chain = True
    depth, alpha = meta["depth"], float(np.float32(meta["alpha"]))
    routes = {
        "pinned": lambda n: sample_images(G, depth, alpha, n, minibatch=BATCH,
                                          rng=np.random.RandomState(SEED)),
        "pageable": lambda n: pageable_route(torch, G, depth, alpha, n, BATCH,
                                             np.random.RandomState(SEED))}
    # G's low-resolution transposed convs run cuDNN's data-gradient
    # algorithms, which may sum with atomics: two forwards need not agree
    # bit for bit unless cuDNN is held to its deterministic algorithms
    n = 3 * BATCH - 8
    again = routes["pageable"](n).tobytes() == routes["pageable"](n).tobytes()
    torch.backends.cudnn.deterministic = True
    try:
        images = {k: fn(n) for k, fn in routes.items()}
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = images["pinned"], images["pageable"]
    if a.tobytes() != b.tobytes():
        rows = [i for i in range(n) if a[i].tobytes() != b[i].tobytes()]
        raise AssertionError(f"pinned and pageable serves differ in images "
                             f"{rows}, by up to {np.abs(a - b).max()}")
    log(f"  two pageable serves the same bytes with cuDNN's default "
        f"algorithms: {again}; pinned and pageable serves with its "
        f"deterministic ones: the same bytes")
    del images
    n = 3 * BATCH
    rates = {k: [] for k in routes}
    for order in (("pageable", "pinned"), ("pinned", "pageable")) * 2:
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[k](n)
            torch.cuda.synchronize()
            rates[k].append(n / (time.perf_counter() - t0))
    log(f"  serves of {n} images: "
        + ", ".join(f"{k} {', '.join(f'{r:.2f}' for r in v)} img/s"
                    for k, v in rates.items()))
    return {k: sorted(v)[len(v) // 2] for k, v in rates.items()}


def serve_profile(torch, snap, sample_images):
    """``torch.profiler`` over one warm ``sample_images`` chunk of BATCH
    (the serve default, chain on): device time by kernel group, the D2H
    copy included, against the host window."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot
    from pggan_tpu_torch.utils.profiling import capture, device_profile
    G, meta = load_snapshot(snap, device="cuda")
    G.inference_chain = True
    run = lambda: sample_images(  # noqa: E731
        G, meta["depth"], meta["alpha"], BATCH, minibatch=BATCH,
        rng=np.random.RandomState(SEED))
    run()
    prof, wall_ms = capture(run)
    return device_profile(prof, wall_ms, 1,
                          f"serve profile, one chunk of {BATCH}", "chunk",
                          log=log)


def paper_models(torch, device, compute_dtype="float32"):
    """The paper configuration (``Generator((1, 3, 1024, 1024))`` and
    ``Discriminator`` with all defaults but ``compute_dtype``), random
    weights from SEED (the same in both dtypes), G's per-conv Functions on
    (no chain: the train path)."""
    from pggan_tpu_torch.models import Discriminator, Generator
    shape = (1, 3, 1024, 1024)
    G = Generator(shape, compute_dtype=compute_dtype,
                  generator=torch.Generator().manual_seed(SEED))
    D = Discriminator(shape, compute_dtype=compute_dtype,
                      generator=torch.Generator().manual_seed(SEED + 1))
    return G.to(device), D.to(device)


def uint8_reals(torch, builder, depth, seed):
    import numpy as np
    shape = builder.real_batch_shape(depth, TRAIN_BATCH)
    u8 = np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(u8)


def train_phase(torch, device="cuda"):
    """3 fade steps (alpha 0.5) and 2 stable steps at TRAIN_DEPTH through
    ``prep_fn`` and the eager ``step_fn``; the second fade step's kernel
    calls are logged for phase 6."""
    import numpy as np
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, device)
    state = init_state(G, D, seed=SEED)
    builder = TrainStepBuilder(G, D, cuda_graphs=False)
    prep = builder.prep_fn()
    start = {n: p.detach().clone() for n, p in
             [*(("G." + k, v) for k, v in G.named_parameters()),
              *(("D." + k, v) for k, v in D.named_parameters())]}
    call_log = CallLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    times = {True: [], False: []}
    for i, fade in enumerate((True, True, True, False, False)):
        alpha = 0.5 if fade else 1.0
        u8 = uint8_reals(torch, builder, TRAIN_DEPTH, SEED + i).to(device)
        step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
        record = call_log.recording() if i == 1 else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record:
            metrics = step(state, prep(u8, alpha), alpha, LR, LR)
        torch.cuda.synchronize()
        times[fade].append((time.perf_counter() - t0) * 1e3)
        values = {k: float(v) for k, v in metrics.items()}
        log(f"  step {i} ({'fade' if fade else 'stable'}): "
            f"{times[fade][-1]:.1f} ms  {values}")
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"step {i}: metrics not finite: {values}")
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches over the 5 steps: {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    for name in TRAIN_KERNELS:
        if counts.get(name, 0) == 0:
            raise AssertionError(f"{name} was never launched by the train "
                                 f"steps")
    for name in SERVE_ONLY:
        if counts.get(name, 0):
            raise AssertionError(f"the forward-only {name} ran in training")
    # every parameter that the step's graph reaches moved; the others
    # (the toRGB / fromRGB layers of other depths) have no gradient
    moments = dict(zip(start, [*state.g_opt.nu, *state.d_opt.nu]))
    current = dict(zip(start, [*G.parameters(), *D.parameters()]))
    unused = []
    for name, p0 in start.items():
        used = bool(moments[name].any())
        moved = not torch.equal(current[name], p0)
        if used != moved:
            raise AssertionError(f"{name}: has a gradient {used}, moved "
                                 f"{moved}")
        if not used:
            unused.append(name)
        if not used and not any(t in name for t in ("torgb", "fromrgb")):
            raise AssertionError(f"{name} got no gradient at depth "
                                 f"{TRAIN_DEPTH}")
    log(f"  every parameter on the depth-{TRAIN_DEPTH} graph moved; "
        f"{len(unused)} "
        f"toRGB/fromRGB tensors of other depths have no gradient")
    dw_per_step = sum(n for (name, _sig), n in call_log.calls.items()
                      if name == "conv3x3_dw")
    gp_dw = sum(call_log.gp_dw.values())
    log(f"  conv3x3_dw launches in a fade step: {dw_per_step}, of them "
        f"inside the GP's inner autograd.grad: {gp_dw}")
    if gp_dw:
        raise AssertionError("the GP took D weight gradients nothing uses")
    train = {"depth": TRAIN_DEPTH, "batch": TRAIN_BATCH, "d_repeats": 1,
             "ms_per_step_fade_logged": times[True][1],
             "step_ms_all": {"fade": times[True], "stable": times[False]},
             "dw_launches_per_fade_step": dw_per_step,
             "max_memory_allocated": peak}
    del G, D, state, builder, start, current, moments
    torch.cuda.empty_cache()
    return train, counts, call_log


def graph_phase(torch, steps: int = 6):
    """The depth-8 step of each graph, eager and as CUDA graph replays:
    ``steps`` calls each (the graphed route's first call eager, its second
    the capture and first replay), wall ms of a synchronised call, median
    of the last ``steps - 2``; then two eager steps from copies of one
    state against each other (cuDNN's default algorithms: the noise), and
    a replay against the eager step from copies of one state, generator
    and inputs, with cuDNN held to its deterministic algorithms."""
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    median = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    G, D = paper_models(torch, "cuda")
    state = init_state(G, D, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    builders = {route: TrainStepBuilder(G, D, cuda_graphs=route == "graphed")
                for route in ("eager", "graphed")}
    prep = builders["eager"].prep_fn()
    u8 = uint8_reals(torch, builders["eager"], TRAIN_DEPTH, SEED).cuda()
    for route, builder in builders.items():
        for fade in (True, False):
            alpha = 0.5 if fade else 1.0
            step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
            times = []
            for _ in range(steps):
                reals = prep(u8, alpha)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, reals, alpha, LR, LR)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            values = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in values.values()):
                raise AssertionError(f"{route} step: metrics {values}")
            graph = "fade" if fade else "stable"
            out[f"{route}_ms_{graph}"] = median(times[2:])
            out[f"{route}_ms_all_{graph}"] = times
            line = (f"  {route} {graph}: {median(times[2:]):.1f} ms a warm "
                    f"step (calls: {', '.join(f'{t:.1f}' for t in times)})")
            if route == "graphed":
                out[f"capture_s_{graph}"] = step.capture_s
                line += f"; capture {step.capture_s:.3f} s"
            log(line)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del builders
    # cuDNN's default algorithms for the low-resolution convs' gradients
    # may sum with atomics, so two eager steps from one state need not
    # agree: measured here, then one replay against the eager step with
    # cuDNN held to its deterministic algorithms in both (a graph captured
    # for it), at an alpha and learning rates other than the capture's
    reals = prep(uint8_reals(torch, TrainStepBuilder(G, D), TRAIN_DEPTH,
                             SEED + 20).cuda(), REPLAY_ALPHA)
    noise = twin_updates(torch, state, reals, G, D)
    out["eager_vs_eager_default_cudnn"] = noise
    log("  two eager steps from the same state with cuDNN's default "
        "algorithms: updates " + (
            "bit for bit" if noise["params_bitwise"] else
            f"apart by up to {noise['update_err_over_norm']:.2e} of a "
            f"tensor's norm (largest element error / largest element "
            f"{noise['update_err_over_max']:.2e})"))
    torch.backends.cudnn.deterministic = True
    try:
        graphed = TrainStepBuilder(G, D).step_fn(TRAIN_DEPTH, TRAIN_BATCH,
                                                 True)
        for _ in range(2):  # eager, then the capture and its first replay
            graphed(state, prep(u8, 0.5), 0.5, LR, LR)
        replay = twin_updates(torch, state, reals, G, D, graphed)
    finally:
        torch.backends.cudnn.deterministic = False
    if replay["loss_rel_err"] > STEP_LOSS_RTOL:
        raise AssertionError(f"replay against eager: losses "
                             f"{replay['loss_rel_err']:.2e} apart, bar "
                             f"{STEP_LOSS_RTOL}")
    if replay["update_err_over_norm"] > UPDATE_TOL:
        raise AssertionError(f"replayed step's updates: largest |replay - "
                             f"eager| / |eager| "
                             f"{replay['update_err_over_norm']:.2e} over "
                             f"{replay['tensors_moved']} tensors, bar "
                             f"{UPDATE_TOL}")
    log(f"  replay against the eager step from the same state (alpha "
        f"{REPLAY_ALPHA}, lr {REPLAY_LR}, the capture's 0.5, {LR}; cuDNN's "
        f"deterministic algorithms): losses within rtol {STEP_LOSS_RTOL}; "
        f"updates of {replay['tensors_moved']} tensors "
        + ("bit for bit" if replay["params_bitwise"] else
           f"within {UPDATE_TOL} (largest |replay - eager| / |eager| "
           f"{replay['update_err_over_norm']:.2e}; largest element error / "
           f"largest element of the eager update "
           f"{replay['update_err_over_max']:.2e})"))
    out["replay_vs_eager"] = replay
    del G, D, state, graphed
    torch.cuda.empty_cache()
    return out


def twin_updates(torch, state, reals, G, D, graphed=None):
    """One depth-8 fade step at REPLAY_ALPHA and REPLAY_LR taken from
    ``state`` by ``graphed`` (or, without it, by an eager step of G and D)
    and by an eager step of a twin restored from the same state: the
    losses' largest relative difference, and the parameter updates
    compared by ``update_errors``. The generators must end in one state.
    ``state`` takes the step."""
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G2, D2 = paper_models(torch, "cuda")
    twin = init_state(G2, D2, seed=SEED + 5)
    checkpoint.restore_training_state(
        twin, checkpoint.training_state_dict(state))
    eager = TrainStepBuilder(G2, D2, cuda_graphs=False).step_fn(
        TRAIN_DEPTH, TRAIN_BATCH, True)
    first = graphed or TrainStepBuilder(G, D, cuda_graphs=False).step_fn(
        TRAIN_DEPTH, TRAIN_BATCH, True)
    before = [p.detach().clone() for p in [*G.parameters(), *D.parameters()]]
    got = {k: float(v) for k, v in
           first(state, reals, REPLAY_ALPHA, *REPLAY_LR).items()}
    want = {k: float(v) for k, v in
            eager(twin, reals, REPLAY_ALPHA, *REPLAY_LR).items()}
    if not torch.equal(state.generator.get_state(),
                       twin.generator.get_state()):
        raise AssertionError("the two steps left other generator states")
    loss_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                   for k in want)
    out = {"loss_rel_err": loss_err,
           **update_errors(torch, before, [*G.parameters(), *D.parameters()],
                           [*G2.parameters(), *D2.parameters()])}
    del G2, D2, twin
    return out


def update_errors(torch, before, got, want) -> dict:
    """A step's parameter updates (``got`` - ``before``) against another's
    (``want`` - ``before``), tensor by tensor: the largest |difference| /
    |want's update| in the 2-norm (and the tensor's index and size) and at
    the largest element, the same over all tensors as one vector, and
    whether the parameters agree bit for bit. Every tensor the second step
    moved must have moved in the first, and no other."""
    ratios, worst = [], 0.0
    bitwise = True
    diff2 = ref2 = 0.0
    where = None
    for p0, p, q in zip(before, got, want):
        dp, dq = p.detach() - p0, q.detach() - p0
        bitwise &= torch.equal(p, q)
        ref = float(dq.norm())
        if ref == 0.0:
            if dp.any():
                raise AssertionError("a step moved a tensor that the eager "
                                     "step left")
            continue
        ratios.append(float((dp - dq).norm()) / ref)
        if ratios[-1] == max(ratios):
            where = (len(ratios) - 1, dq.numel())
        worst = max(worst, float((dp - dq).abs().max() / dq.abs().max()))
        diff2 += float((dp - dq).norm()) ** 2
        ref2 += ref ** 2
    if not ratios:
        raise AssertionError("the eager step moved no parameter")
    return {"params_bitwise": bitwise, "tensors_moved": len(ratios),
            "update_err_over_norm": max(ratios),
            "worst_tensor_index_and_size": where,
            "update_err_over_max": worst,
            "update_err_over_total_norm": math.sqrt(diff2 / ref2)}


def step_against_cpu(torch, device="cuda"):
    """One depth-6 fade step of the paper configuration on the card and on
    the CPU plain route, with the same parameters, reals and draws. lr 0,
    so G's loss is taken through the same D on both; the gradients are
    Adam's first moment after the step (b1 = 0)."""
    import numpy as np
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    depth, alpha = CHECK_DEPTH, 0.5
    G, D = paper_models(torch, "meta")
    if D._pallas_span(depth) < 2 or G._pallas_tail_start(depth) is None:
        raise AssertionError(f"depth {depth} must run two D head stages "
                             f"(the paper's K = 128 one) and the G tail")
    rng = np.random.RandomState(SEED)
    lat = (TRAIN_BATCH, G.latent_size)
    draws = [("normal", rng.randn(*lat).astype(np.float32)),
             ("uniform", rng.uniform(size=TRAIN_BATCH).astype(np.float32)),
             ("normal", rng.randn(*lat).astype(np.float32))]
    out = {}
    for dev in ("cpu", device):
        G, D = paper_models(torch, dev)
        state = init_state(G, D, seed=SEED)
        builder = TrainStepBuilder(G, D, cuda_graphs=False)
        it = iter(draws)

        def noise(kind, shape, it=it, dev=dev):
            k, v = next(it)
            assert (k, tuple(shape)) == (kind, v.shape)
            return torch.from_numpy(v).to(dev)
        u8 = uint8_reals(torch, builder, depth, SEED + 10).to(dev)
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        metrics = builder.step_fn(depth, TRAIN_BATCH, True)(
            state, builder.prep_fn()(u8, alpha), alpha, 0.0, 0.0,
            noise=noise)
        values = {k: float(v) for k, v in metrics.items()}
        log(f"  {dev}: {time.perf_counter() - t0:.1f} s, {values}, "
            f"launches {dict(_build.LAUNCHES)}")
        grads = {**{"G." + n: m for (n, _p), m in
                    zip(G.named_parameters(), state.g_opt.mu)},
                 **{"D." + n: m for (n, _p), m in
                    zip(D.named_parameters(), state.d_opt.mu)}}
        out[dev] = (values, {k: v.cpu() for k, v in grads.items()},
                    dict(_build.LAUNCHES))
        del G, D, state, builder
    (v_cpu, g_cpu, _), (v_gpu, g_gpu, launched) = out["cpu"], out[device]
    for name in ("conv3x3", "conv3x3_act", "conv3x3_act_pn", "conv3x3_dw",
                 "avgpool2x", "upsample2x"):
        if not launched.get(name):
            raise AssertionError(f"depth-6 step: {name} not launched")
    loss_err = max(abs(v_gpu[k] - v_cpu[k]) / max(abs(v_cpu[k]), 1e-30)
                   for k in v_cpu)
    if loss_err > STEP_LOSS_RTOL:
        raise AssertionError(f"depth-6 losses: card {v_gpu}, cpu {v_cpu}")
    errs, failed = [], []
    for name, want in g_cpu.items():
        got = g_gpu[name]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        errs.append((err / max(scale, 1e-30), name))
        if not torch.allclose(got, want, rtol=STEP_GRAD_TOL["rtol"],
                              atol=STEP_GRAD_TOL["scaled_atol"] * scale):
            failed.append(name)
    errs.sort(reverse=True)
    worst = errs[0][0]
    log("  largest gradient errors / largest element: " + ", ".join(
        f"{n} {e:.2e}" for e, n in errs[:6]))
    if failed:
        raise AssertionError(f"depth-{depth} gradients outside "
                             f"{STEP_GRAD_TOL}: {failed}")
    log(f"  losses within rtol {STEP_LOSS_RTOL} (largest {loss_err:.2e}); "
        f"{len(g_cpu)} gradient tensors within {STEP_GRAD_TOL} (largest "
        f"error / largest element {worst:.2e})")
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_err_over_max": worst}


# The progressive run (phase 9): the paper configuration on 1024 px
# SyntheticDataset items, every stage cut to CLI_LOD images stable and
# CLI_LOD fading, the first run stopped at CLI_STOP kimg (in depth 7's
# stable phase) and resumed to CLI_TOTAL kimg: depth 8 fades for 16 steps
# of 3 images (two groups of 8) and then runs 19 stable steps (a group, 3
# single steps up to a tick, a group). With the default
# steps_per_dispatch 8, depths 7 and 8 dispatch groups; a graph is captured
# at a key's second call, so depth 7's one group a window runs eagerly.
# The bf16 run (phase 15) stops at BF16_CLI_TOTAL: a bf16 step takes over
# a second.
CLI_LOD = 48
CLI_STOP = 0.7
CLI_TOTAL = (16 * CLI_LOD + 19 * 3) / 1000
BF16_CLI_TOTAL = (16 * CLI_LOD + 8 * 3) / 1000


def cli_argv(root, total_kimg, *extra):
    return ["--dataset_class", "SyntheticDataset",
            "--SyntheticDataset.resolution", "1024",
            "--SyntheticDataset.num_items", "24",
            "--postprocessors", "['ImageSaver']",
            "--DepthManager.lod_training_nimg", str(CLI_LOD),
            "--DepthManager.lod_transition_nimg", str(CLI_LOD),
            "--DepthManager.tick_kimg_default", str(2 * CLI_LOD / 1000),
            "--DepthManager.tick_kimg_overrides", "{}",
            "--SaverPlugin.network_snapshot_ticks", "2",
            "--image_snapshot_ticks", "3", "--lr_rampup_kimg", "0.4",
            "--device_input_prep", "True", "--num_data_workers", "4",
            "--random_seed", str(SEED), "--result_dir", str(root),
            "--total_kimg", str(total_kimg), *extra]


def planned_dispatches(start_nimg, stop_kimg, steps_per_dispatch=8,
                       lod=CLI_LOD, max_depth=TRAIN_DEPTH):
    """The dispatches of a ``cli_argv`` run from ``start_nimg`` (a resume
    there, or 0) until the trainer stops at ``stop_kimg``: the port's
    ``Trainer`` and ``DepthManager`` with the run's schedule and the
    paper's per-depth batches, driven with a stub builder that counts the
    calls of each key, (depth, batch, fade) for a step and (depth, batch,
    fade, group) for a group. Returns the counts and the image count it
    stops at."""
    import numpy as np
    import torch
    from pggan_tpu_torch.training.plugins import DepthManager
    from pggan_tpu_torch.training.trainer import Trainer

    class Counting:
        group = None

        def __init__(self):
            self.calls = collections.Counter()

        def _fn(self, key):
            zeros = torch.zeros(key[3:])

            def call(*_args):
                self.calls[key] += 1
                return dict.fromkeys(("G_loss", "D_loss", "D_real",
                                      "D_fake"), zeros)
            return call

        def step_fn(self, depth, batch, fade):
            return self._fn((depth, batch, fade))

        def group_step_fn(self, depth, batch, fade, group):
            return self._fn((depth, batch, fade, group))

    def batches(size):
        while True:
            yield np.zeros((size, 1, 1, 1), np.float32)

    builder = Counting()
    trainer = Trainer(torch.nn.Linear(1, 1), None, builder, None, None,
                      None, None, resume_nimg=start_nimg,
                      steps_per_dispatch=steps_per_dispatch)
    trainer.register_plugin(DepthManager(
        batches, None, max_depth, tick_kimg_default=2 * lod / 1000,
        tick_kimg_overrides={}, lod_training_nimg=lod,
        lod_transition_nimg=lod))
    trainer.run(stop_kimg)
    return builder.calls, trainer.cur_nimg


def replayed_kernels(builder) -> collections.Counter:
    """The kernels that a builder's graph replays ran: each captured
    graph's kernel calls times its replays."""
    replayed = collections.Counter()
    for step in builder.graphs().values():
        for name, n in step.captured.items():
            replayed[name] += n * step.replays
    return replayed


def cli_phase(torch, keep_dir):
    """A progressive run of the paper configuration through
    ``python -m pggan_tpu_torch.cli.train`` from depth 0, stopped at
    CLI_STOP kimg, then resumed in this process with ``--resume_network
    latest`` to CLI_TOTAL kimg: its restored state held bit for bit against
    the checkpoint, every kernel of the step launched, every stage's fade
    and stable phase trained, the dispatches those of ``planned_dispatches``
    (steps and groups), every key called twice or more captured, grouped
    graphs among them, finite losses. Returns the numbers, the resumed
    run's launch counts (its eager calls) and the kernels its replays ran
    (each graph's captured kernels times its replays). Its last generator
    snapshot is copied into ``keep_dir``."""
    import glob
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.cli import train as cli
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training.plugins import AbsoluteTimeMonitor
    want_keys = {(0, 16, False)} | {
        (d, {6: 14, 7: 6, 8: 3}.get(d, 16), fade)
        for d in range(1, TRAIN_DEPTH + 1) for fade in (True, False)}
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "pggan_tpu_torch.cli.train",
             *cli_argv(root, CLI_STOP)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        out["first_run_s"] = time.perf_counter() - t0
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith(("tick ", "CUDA graphs", "[SaverPlugin]"))]
        for ln in lines:
            log(f"    {ln}")
        if res.returncode != 0:
            log(res.stderr[-4000:])
            raise AssertionError(f"the train CLI exited {res.returncode}")
        first_keys, out["first_run_peak_bytes"] = captured_keys(res.stdout)
        run1, = glob.glob(os.path.join(root, "001-*"))
        state_path, = glob.glob(os.path.join(run1, "training-state-*.dat"))
        sd, nimg, iterations, base_time = checkpoint.load_training_state(
            state_path)
        steps1, stop1 = planned_dispatches(0, CLI_STOP)
        steps2, stop2 = planned_dispatches(nimg, CLI_TOTAL)
        if nimg != stop1 or first_keys != {k for k, n in steps1.items()
                                           if n >= 2}:
            raise AssertionError(f"first run: stopped at {nimg} (plan "
                                 f"{stop1}), graphs {sorted(first_keys)}, "
                                 f"plan {dict(steps1)}")
        ticks = sum(ln.startswith("tick ") for ln in lines)
        saves = sum(ln.startswith("[SaverPlugin]") for ln in lines)

        # the resume, in this process: the state held against the file
        params = cli.get_structured_params(vars(cli.build_parser().parse_args(
            cli_argv(root, CLI_TOTAL, "--resume_network", "latest"))))
        trainer, logger, total = cli.build(params)
        try:
            got = checkpoint.training_state_dict(trainer.state)
            same = compare_state(got, sd)
            monitor, = [p for *_k, p in trainer.plugin_queues["epoch"]
                        if isinstance(p, AbsoluteTimeMonitor)]
            if not same or (trainer.cur_nimg, trainer.iterations,
                            monitor.base_time) != (nimg, iterations,
                                                   base_time):
                raise AssertionError("the resumed state differs from the "
                                     "checkpoint")
            log(f"  resumed at {nimg} images, {iterations} iterations, "
                f"clock {base_time:.3f} s: parameters, both Adams (moments "
                f"and count), the generator state and the clock equal the "
                f"checkpoint bit for bit")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            trainer.run(total)
            torch.cuda.synchronize()
            out["resumed_run_s"] = time.perf_counter() - t0
            # the wrapper's launches: each key's eager first call (a
            # capture records its kernels in CAPTURED instead); the
            # replays run the captured kernels without a wrapper call
            launches = dict(_build.LAUNCHES)
            out["resumed_run_peak_bytes"] = torch.cuda.max_memory_allocated()
            builder = trainer.builder
            second_keys = set(builder.graphs())
            replayed = replayed_kernels(builder)
            calls = {k: int(s.warm) + s.replays
                     for k, s in builder._steps.items()}
            out["launches_eager"] = launches
            out["kernels_run_in_replays"] = dict(replayed)
            if calls != dict(steps2) or trainer.cur_nimg != stop2:
                raise AssertionError(f"resumed run: calls {calls} at "
                                     f"{trainer.cur_nimg} images, plan "
                                     f"{dict(steps2)} at {stop2}")
            if second_keys != {k for k, n in steps2.items() if n >= 2}:
                raise AssertionError(f"resumed run: graphs "
                                     f"{sorted(second_keys)}")
            if {k[:3] for k in (*steps1, *steps2)} != want_keys:
                raise AssertionError("the run missed a stage: "
                                     f"{sorted(want_keys - set(steps1))}")
            groups = {k: n for k, n in (*steps1.items(), *steps2.items())
                      if len(k) == 4}
            grouped_graphs = sorted(k for k in first_keys | second_keys
                                    if len(k) == 4)
            depth8 = {k: calls[k] for k in second_keys
                      if k[0] == TRAIN_DEPTH}
            if not grouped_graphs or {k[2] for k in depth8 if len(k) == 4} \
                    != {True, False}:
                raise AssertionError(f"grouped graphs {grouped_graphs}, "
                                     f"depth-8 graphs {depth8}")
            # launches of replayed trainer iterations (past the run's end)
            out["python_launches_per_replayed_iteration"] = replay_launches(
                torch, trainer, _build)
        finally:
            if hasattr(trainer.dataiter, "close"):
                trainer.dataiter.close()
            logger.close()
        run2, = [d for d in glob.glob(os.path.join(root, "00*-*"))
                 if d != run1]
        # the resumed run's last snapshot (depth 8) for phase 11
        out["snapshot"] = shutil.copy(max(glob.glob(os.path.join(
            run2, "network-snapshot-generator-*.dat")), key=os.path.getmtime),
            keep_dir)
        rows = [json.loads(ln) for d in (run1, run2)
                for ln in open(os.path.join(d, "metrics.jsonl"))]
        last = rows[-1]
        if not all(math.isfinite(last[f"{k}.epoch_mean"]) for k in cli.LOSSES):
            raise AssertionError(f"last tick's losses {last}")
        # the resumed run trains at depths 7 and 8 only: its samples are
        # OutputGenerator's output there
        samples = glob.glob(os.path.join(run2, "fakes_*.png"))
        if ticks < 4 or saves < 2 or not samples:
            raise AssertionError(f"first run: {ticks} ticks, {saves} "
                                 f"checkpoints; resumed run: samples "
                                 f"{samples}")
    per_depth = collections.defaultdict(list)
    for r in rows:
        per_depth[int(r["depth"])].append(r["sec.kimg"])
    out.update({
        "graphs_captured": len(first_keys) + len(second_keys),
        "grouped_dispatches": {str(k): n for k, n in groups.items()},
        "grouped_graphs_captured": [str(k) for k in grouped_graphs],
        "ticks": len(rows), "depth8_calls": {str(k): v
                                             for k, v in depth8.items()},
        "sec_per_kimg_by_depth": {d: v for d, v in sorted(per_depth.items())},
        "first_run_ticks": ticks, "first_run_checkpoints": saves})
    log(f"  sec/kimg per tick by the depth it ended at: "
        + "; ".join(f"{d}: {', '.join(f'{x:.1f}' for x in v)}"
                    for d, v in sorted(per_depth.items())))
    log(f"  grouped dispatches (depth, batch, fade, group): calls "
        f"{groups}; grouped graphs captured {grouped_graphs}")
    log(f"  graphs captured: {out['graphs_captured']} ({len(first_keys)} + "
        f"{len(second_keys)}); depth-8 calls {depth8}; peak device memory "
        f"{out['first_run_peak_bytes'] / 2**30:.2f} / "
        f"{out['resumed_run_peak_bytes'] / 2**30:.2f} GiB (first / resumed "
        f"run); launches from Python per replayed trainer iteration "
        f"{out['python_launches_per_replayed_iteration']:.1f}")
    return out, launches, replayed


def captured_keys(stdout: str):
    """The keys of the graphs that ``cli.train`` reports it captured, and
    the peak device memory it reports."""
    import ast
    import re
    m = re.search(r"group\]\) (\[.*\]); peak device memory (\d+) B",
                  stdout)
    return set(ast.literal_eval(m.group(1))), int(m.group(2))


def compare_state(a, b) -> bool:
    """Two training state dicts hold the same keys and the same bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(compare_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):  # each rank's generator state
        return len(a) == len(b) and all(map(compare_state, a, b))
    if a is None or b is None:
        return a is b
    if isinstance(a, int):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def replay_launches(torch, trainer, _build, iterations: int = 3) -> float:
    """Host calls that queue work on the card (kernel launches, copies,
    graph launches) per trainer iteration whose step is a replay, from the
    profiler's host events; no kernel wrapper may run in them."""
    from torch.profiler import ProfilerActivity, profile
    from pggan_tpu_torch.utils.profiling import HOST_LAUNCHES
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iterations):
            trainer.train()
        torch.cuda.synchronize()
    if dict(_build.LAUNCHES) != before:
        raise AssertionError("a replayed iteration called a kernel wrapper")
    host = collections.Counter(e.name for e in prof.events()
                               if e.device_type
                               == torch.autograd.DeviceType.CPU
                               and e.name in HOST_LAUNCHES)
    log(f"  a replayed trainer iteration's host launches: "
        f"{ {k: v / iterations for k, v in host.items()} }")
    return sum(host.values()) / iterations


# The sound path (phase 10): 16 seeded WAVs at 16 kHz, each long enough for
# a 512 x 512 abslog image at n_fft 1024, hop 128 (the defaults of
# SoundImageDataset and SoundSaver, README's first example), trained at
# the paper widths from depth 0 to depth 7 (512 px) on the phase-9
# schedule, to SOUND_TOTAL kimg: 4 stable depth-7 steps of 6 images.
SOUND_FILES = 16
SOUND_RATE = 16000
N_FFT, HOP = 1024, 128
SOUND_DEPTH = 7
SOUND_TOTAL = ((2 * SOUND_DEPTH + 1) * CLI_LOD + 4 * 6) / 1000
# the STFT images, card against the per-file host path: JAX's own bar
# (tests/test_data.py:160-172; cuFFT and pocketfft round apart, and an
# image is truncated to uint8)
IMG_MAX_LEVELS, IMG_MIN_EQUAL = 1, 0.98
# Griffin-Lim on the card against the CPU from the same start: the
# signals after GL_SHORT iterations within GL_SHORT_RTOL in the 2-norm;
# after the SoundSaver's 100, the spectral convergence within 1 % of the
# CPU's (the iteration does not contract, so the signals drift apart
# while the fit to the magnitude stays as good)
GL_SHORT, GL_SHORT_RTOL, GL_SC_RTOL = 8, 1e-3, 1e-2
# the eval (phase 11): SWD per level card against the CPU with the same
# draws and the same images; the reals' pairwise MS-SSIM likewise
SWD_RTOL, MSSSIM_ATOL = 1e-3, 1e-4
EVAL_SAMPLES, EVAL_MINIBATCH = 32, 16
EVAL_RES = 1024  # the PNGs' side: the paper configuration's


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def write_wavs(root) -> str:
    """SOUND_FILES mono 16-bit WAVs of seeded chirps plus noise."""
    import numpy as np
    from pggan_tpu_torch.data.audio_io import write_wav
    from pggan_tpu_torch.ops.stft import sound_image_signal_length
    d = os.path.join(root, "wavs")
    os.makedirs(d)
    rng = np.random.RandomState(SEED)
    n = sound_image_signal_length(N_FFT, HOP) + 1000
    t = np.arange(n) / SOUND_RATE
    for i in range(SOUND_FILES):
        f0, f1 = rng.uniform(100, 4000, 2)
        sig = np.sin(2 * np.pi * (f0 + (f1 - f0) * t / t[-1] / 2) * t)
        sig += 0.05 * rng.randn(n)
        write_wav(os.path.join(d, f"{i:03}.wav"), sig, SOUND_RATE)
    return d


def spy_griffin_lim(calls):
    """Record the device, batch and iterations of each SoundSaver
    Griffin-Lim call (the sound path must run it on the card)."""
    from pggan_tpu_torch import postprocess
    real = postprocess.griffin_lim_batch

    def spy(mags, n_iter, *args, **kw):
        calls.append((mags.device.type, tuple(mags.shape), n_iter))
        return real(mags, n_iter, *args, **kw)
    postprocess.griffin_lim_batch = spy
    return lambda: setattr(postprocess, "griffin_lim_batch", real)


def check_wavs(paths, tag) -> int:
    import numpy as np
    from pggan_tpu_torch.data.audio_io import read_wav
    if not paths:
        raise AssertionError(f"{tag}: no WAV written")
    for p in paths:
        sig, _ = read_wav(p)
        if not np.all(np.isfinite(sig)) or np.abs(sig).max() < 0.5:
            raise AssertionError(f"{tag}: {p} is silent or not finite")
    return len(paths)


def spectral_convergence(torch, x, mag):
    from pggan_tpu_torch.ops.stft import stft
    S = stft(x, N_FFT, HOP)[..., :mag.shape[-1]].abs()
    return (torch.linalg.vector_norm(S - mag, dim=(1, 2))
            / torch.linalg.vector_norm(mag, dim=(1, 2)))


def sound_phase(torch, root, device="cuda"):
    """Phase 10: the sound dataset's STFT images on the card against the
    host path, a progressive run on them through the train CLI with the
    ImageSaver and the SoundSaver (Griffin-Lim on the card), then the
    generate CLI's SoundSaver on its snapshot, and Griffin-Lim on the
    card against the CPU from the same start. Returns the numbers and
    the launches of the two paths. ``device`` lets a scratch script
    rehearse it on the CPU."""
    import glob
    import numpy as np
    from pggan_tpu_torch.cli import generate as gen_cli
    from pggan_tpu_torch.cli import train as cli
    from pggan_tpu_torch.data.datasets import SoundImageDataset
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.ops.stft import griffin_lim_batch
    from pggan_tpu_torch.postprocess import SoundSaver
    out = {}
    wav_dir = write_wavs(root)

    # the batched STFT images: card, the CPU's torch route, the host path
    ds = SoundImageDataset(wav_dir, n_fft=N_FFT, hop_length=HOP,
                           preload=True, device=device)
    card = ds.data[ds.max_dataset_depth]
    host = np.stack([ds.load_file(i) for i in range(SOUND_FILES)])
    diff = np.abs(card.astype(np.int16) - host.astype(np.int16))
    equal = float((diff == 0).mean())
    if card.shape != (SOUND_FILES, N_FFT // 2, N_FFT // 2, 1) or \
            diff.max() > IMG_MAX_LEVELS or equal < IMG_MIN_EQUAL:
        raise AssertionError(f"STFT images {card.shape}: card vs host "
                             f"{diff.max()} levels apart, {equal:.4f} equal")
    rates = {}
    for route in (device, "cpu"):
        ds.device = route
        ds._load_files_chunk(0, SOUND_FILES)  # warm
        t0 = time.perf_counter()
        ds._load_files_chunk(0, SOUND_FILES)
        rates[route] = SOUND_FILES / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for i in range(SOUND_FILES):
        ds.load_file(i)
    rates["host_numpy"] = SOUND_FILES / (time.perf_counter() - t0)
    out["stft_images"] = {"max_levels_apart": int(diff.max()),
                          "share_equal": equal, "files_per_s": rates}
    log(f"  STFT images {card.shape[1:3]}: card vs host path {diff.max()} "
        f"level(s) apart at most, {equal:.4%} equal; files/s (read, "
        f"resample, STFT, remap) {device} {rates[device]:.1f}, CPU torch "
        f"{rates['cpu']:.1f}, host numpy {rates['host_numpy']:.1f}")

    # the progressive run, in this process so its launches count
    gl_calls = []
    restore = spy_griffin_lim(gl_calls)
    argv = ["--dataset_class", "SoundImageDataset",
            "--SoundImageDataset.dir_path", wav_dir,
            "--SoundImageDataset.preload", "True",
            "--SoundImageDataset.n_fft", str(N_FFT),
            "--SoundImageDataset.hop_length", str(HOP),
            "--postprocessors", "['ImageSaver','SoundSaver']",
            "--SoundSaver.hop_length", str(HOP),
            "--DepthManager.lod_training_nimg", str(CLI_LOD),
            "--DepthManager.lod_transition_nimg", str(CLI_LOD),
            "--DepthManager.tick_kimg_default", str(2 * CLI_LOD / 1000),
            "--DepthManager.tick_kimg_overrides", "{}",
            "--image_snapshot_ticks", "3", "--lr_rampup_kimg", "0.4",
            "--device_input_prep", "True", "--num_data_workers", "4",
            "--random_seed", str(SEED), "--result_dir",
            os.path.join(root, "runs"), "--total_kimg", str(SOUND_TOTAL),
            "--device", device]
    try:
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        trainer = cli.main(cli.get_structured_params(
            vars(cli.build_parser().parse_args(argv))))
        sync(torch, device)
        out["train_s"] = time.perf_counter() - t0
    finally:
        restore()
    launches = dict(_build.LAUNCHES)
    replayed = replayed_kernels(trainer.builder)
    run, = glob.glob(os.path.join(root, "runs", "001-*"))
    rows = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    if trainer.depth != SOUND_DEPTH or not all(
            math.isfinite(rows[-1][f"{k}.epoch_mean"]) for k in cli.LOSSES):
        raise AssertionError(f"sound run ended at depth {trainer.depth}, "
                             f"last tick {rows[-1]}")
    wavs = glob.glob(os.path.join(run, "fakes_sound_*.wav"))
    if glob.glob(os.path.join(run, "error_*.txt")) or not glob.glob(
            os.path.join(run, "fakes_*.png")):
        raise AssertionError("the run's samples: an error file, or no PNG")
    if not gl_calls or any(dev != device or n != 100
                           for dev, _s, n in gl_calls):
        raise AssertionError(f"SoundSaver's Griffin-Lim calls {gl_calls}")
    out.update(wavs=check_wavs(wavs, "train run"), ticks=len(rows),
               griffin_lim_calls=len(gl_calls),
               graphs_captured=len(trainer.builder.graphs()))
    log(f"  sound run: {len(rows)} ticks to depth {trainer.depth} in "
        f"{out['train_s']:.1f} s, {out['graphs_captured']} graphs, "
        f"{out['wavs']} WAVs from {len(gl_calls)} Griffin-Lim calls on the "
        f"card (100 iterations each, last batch {gl_calls[-1][1]}); "
        f"launches {launches}; kernels run in its replays {dict(replayed)}")
    del trainer

    # the generate CLI's SoundSaver on the run's last snapshot
    snap = max(glob.glob(os.path.join(
        run, "network-snapshot-generator-*.dat")))
    samples = os.path.join(root, "generated")
    gl_calls.clear()
    restore = spy_griffin_lim(gl_calls)
    try:
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        imgs = gen_cli.cli_main([
            "--generator_path", snap, "--num_samples", "4",
            "--postprocessors", "['SoundSaver']", "--SoundSaver.hop_length",
            str(HOP), "--SoundSaver.samples_path", samples, "--device",
            device])
        out["generate_s"] = time.perf_counter() - t0
    finally:
        restore()
    gen_launches = dict(_build.LAUNCHES)
    if (device == "cuda" and not gen_launches.get("conv3x3_chain_pn")) \
            or gl_calls != [(device, (4, N_FFT // 2 + 1, N_FFT // 2), 100)]:
        raise AssertionError(f"generate: launches {gen_launches}, "
                             f"Griffin-Lim {gl_calls}")
    out["generated_wavs"] = check_wavs(
        glob.glob(os.path.join(samples, "*.wav")), "generate")
    log(f"  generate: {imgs.shape} images, {out['generated_wavs']} WAVs in "
        f"{out['generate_s']:.2f} s; launches {gen_launches}")

    # Griffin-Lim, card against the CPU from the SoundSaver's start
    saver = SoundSaver(samples_path=samples, create_subdirs=False,
                       device=device)
    mags = np.stack([np.pad(im[0], ((0, 1), (0, 0))) for im in imgs])
    mags = torch.from_numpy((mags + 1.0) * 127.5)  # drange -> 0..255
    x0 = saver.initial_guess((mags.shape[2] - 1) * HOP)
    gl = {}
    for route in (device, "cpu"):
        m, x = mags.to(route), x0.to(route)
        short = griffin_lim_batch(m, GL_SHORT, HOP, x0=x)
        griffin_lim_batch(m, 100, HOP, x0=x)  # warm
        sync(torch, route)
        t0 = time.perf_counter()
        full = griffin_lim_batch(m, 100, HOP, x0=x)
        sc = spectral_convergence(torch, full, m).cpu()
        gl[route] = (short.cpu(), sc,
                     (time.perf_counter() - t0) * 1e3 / len(mags))
    rel = float(torch.linalg.vector_norm(gl[device][0] - gl["cpu"][0])
                / torch.linalg.vector_norm(gl["cpu"][0]))
    sc_gap = float(((gl[device][1] - gl["cpu"][1]).abs()
                    / gl["cpu"][1]).max())
    out["griffin_lim"] = {
        f"rel_l2_after_{GL_SHORT}": rel,
        "spectral_convergence_card": gl[device][1].tolist(),
        "spectral_convergence_cpu": gl["cpu"][1].tolist(),
        "ms_per_100_iterations_per_sample": {r: gl[r][2] for r in gl}}
    log(f"  Griffin-Lim card vs CPU from one start: {rel:.2e} relative "
        f"after {GL_SHORT} iterations; spectral convergence after 100 card "
        f"{gl[device][1].tolist()} / CPU {gl['cpu'][1].tolist()} "
        f"({sc_gap:.2e} apart); ms per 100 iterations a sample card "
        f"{gl[device][2]:.2f}, CPU {gl['cpu'][2]:.1f}")
    if rel > GL_SHORT_RTOL or sc_gap > GL_SC_RTOL:
        raise AssertionError("Griffin-Lim card vs CPU out of bounds")
    return out, launches, replayed, gen_launches


def write_pngs(root) -> str:
    """2 * EVAL_SAMPLES seeded RGB PNGs of EVAL_RES px, smooth random
    patterns (a 16 x 16 grid scaled up), so they compress even at zlib's
    fastest level (the default level took 38 s for the 64 at 1024 px)."""
    import numpy as np
    from PIL import Image
    d = os.path.join(root, "pngs")
    os.makedirs(d)
    rng = np.random.RandomState(SEED + 1)
    for i in range(2 * EVAL_SAMPLES):
        grid = rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(grid).resize((EVAL_RES, EVAL_RES),
                                     Image.BICUBIC).save(
            os.path.join(d, f"{i:03}.png"), compress_level=1)
    return d


def eval_phase(torch, root, snapshot, device="cuda"):
    """Phase 11: the image-folder dataset's disk pyramid built through the
    host library and reopened from its cache, then the eval CLI on the
    phase-9 depth-8 snapshot against it (SWD at 7 levels, 1024 -> 16 px,
    real baseline, MS-SSIM), with the SWD and MS-SSIM of the same images
    and draws held card against CPU. Returns the numbers and the eval's
    launches."""
    import importlib
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot
    from pggan_tpu_torch.data import native
    from pggan_tpu_torch.data.datasets import (DefaultImageFolderDataset,
                                               box_downsample)
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.sampling import sample_images
    eval_cli = importlib.import_module("pggan_tpu_torch.cli.eval")
    swd_module = importlib.import_module("pggan_tpu_torch.metrics.swd")
    swd, swd_levels = swd_module.swd, swd_module.swd_levels
    out = {}
    t0 = time.perf_counter()
    png_dir = write_pngs(root)
    out["write_pngs_s"] = time.perf_counter() - t0
    cache = os.path.join(root, "pyramid")
    kw = dict(dir_path=png_dir, preload="disk", imread_mode="RGB",
              cache_dir=cache)
    t0 = time.perf_counter()
    ds = DefaultImageFolderDataset(**kw)
    out["pyramid_build_s"] = time.perf_counter() - t0
    stamps = {f: os.stat(os.path.join(cache, f)).st_mtime_ns
              for f in os.listdir(cache)}
    t0 = time.perf_counter()
    again = DefaultImageFolderDataset(**kw)
    out["pyramid_reopen_s"] = time.perf_counter() - t0
    top = ds.max_dataset_depth
    if stamps != {f: os.stat(os.path.join(cache, f)).st_mtime_ns
                  for f in os.listdir(cache)} or not isinstance(
                      again.data[top], np.memmap):
        raise AssertionError("the reopened dataset did not reuse the cache")
    levels = (top - 1, (top + 2) // 2, 2)
    for depth in levels:  # the host library against numpy, level by level
        want = np.uint8(np.clip(np.round(np.stack(
            [box_downsample(x, 2) for x in ds.data[depth + 1][:4]])), 0, 255))
        if not np.array_equal(np.asarray(ds.data[depth][:4]), want):
            raise AssertionError(f"pyramid level {depth} differs from numpy")
    log(f"  {len(ds)} PNGs written in {out['write_pngs_s']:.1f} s; disk "
        f"pyramid (levels 2-{top}, host library {native.library()._name}) "
        f"built in {out['pyramid_build_s']:.2f} s, reopened from its cache "
        f"in {out['pyramid_reopen_s']:.3f} s; levels {levels} equal "
        f"numpy's")

    out_json = os.path.join(root, "eval.json")
    argv = ["--generator_path", snapshot,
            "--dataset_class", "DefaultImageFolderDataset",
            *[a for k, v in kw.items()
              for a in (f"--DefaultImageFolderDataset.{k}", str(v))],
            "--num_samples", str(EVAL_SAMPLES),
            "--minibatch", str(EVAL_MINIBATCH), "--output_json", out_json,
            "--device", device]
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    results, baseline = eval_cli.cli_main(argv)
    out["eval_s"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    payload = json.load(open(out_json))
    if list(results)[:-1] != swd_levels(EVAL_RES) or not all(
            math.isfinite(v) for v in [*results.values(),
                                       *baseline.values()]):
        raise AssertionError(f"eval results {results}, baseline {baseline}")

    # the same reals, fakes and draws through the card and the CPU
    params = eval_cli.get_structured_params(
        vars(eval_cli.build_parser().parse_args(argv)))
    G, meta = load_snapshot(snapshot, device=device)
    reals = eval_cli.real_sample(ds, meta["depth"], meta["alpha"], params)
    reals, reals_b = reals[:EVAL_SAMPLES], reals[EVAL_SAMPLES:]
    fakes = sample_images(G, meta["depth"], meta["alpha"], EVAL_SAMPLES,
                          minibatch=EVAL_MINIBATCH,
                          rng=np.random.RandomState(SEED + 2))
    del G
    scores, secs = {}, {}
    for route in (device, "cpu"):
        params["device"] = route
        kw_swd = eval_cli._swd_kwargs(params)
        t0 = time.perf_counter()
        scores[route] = {
            "fakes": swd(reals, fakes, eval_cli._generator(SEED), **kw_swd),
            "baseline": swd(reals, reals_b, eval_cli._generator(SEED),
                            **kw_swd),
            "msssim_reals": eval_cli.pairwise_msssim(
                reals, eval_cli._generator(SEED + 1),
                minibatch=EVAL_MINIBATCH, device=route)}
        secs[route] = time.perf_counter() - t0
    worst = max(abs(scores[device][k][lv] - scores["cpu"][k][lv])
                / abs(scores["cpu"][k][lv])
                for k in ("fakes", "baseline") for lv in results)
    ms_gap = abs(scores[device]["msssim_reals"]
                 - scores["cpu"]["msssim_reals"])
    cli_gap = max(abs(payload[f"swd_baseline_{lv}"]
                      - scores[device]["baseline"][lv])
                  / abs(scores["cpu"]["baseline"][lv])
                  for lv in results)
    out.update(swd=results, swd_baseline=baseline,
               msssim_fakes=payload["msssim_fakes"],
               msssim_reals=payload["msssim_reals"],
               swd_card_vs_cpu_rel=worst, msssim_card_vs_cpu=ms_gap,
               swd_cpu=scores["cpu"]["fakes"],
               seconds_two_swd_and_msssim=secs)
    log(f"  eval CLI ({out['eval_s']:.1f} s, launches {launches}): SWD x1e3 "
        f"{ {k: round(v, 2) for k, v in results.items()} }, real floor "
        f"{ {k: round(v, 2) for k, v in baseline.items()} }, MS-SSIM fakes "
        f"{payload['msssim_fakes']:.4f} / reals {payload['msssim_reals']:.4f}")
    log(f"  card vs CPU, same images and draws: SWD per level within "
        f"{worst:.2e} relative, MS-SSIM {ms_gap:.2e}; two SWDs of "
        f"{EVAL_SAMPLES} vs {EVAL_SAMPLES} at {EVAL_RES} px and one MS-SSIM "
        f"pairing: card {secs[device]:.2f} s, CPU {secs['cpu']:.1f} s")
    if worst > SWD_RTOL or ms_gap > MSSSIM_ATOL or cli_gap > SWD_RTOL:
        raise AssertionError(f"SWD card vs CPU {worst}, MS-SSIM {ms_gap}, "
                             f"CLI vs rerun {cli_gap}")
    return out, launches


def h5_phase(torch, root, device="cuda"):
    """A few training steps on a seeded windowed H5Dataset, where h5py is
    installed; None where it is not."""
    try:
        import h5py
    except ImportError:
        log("  h5py is not installed here: H5Dataset not run on the card "
            "(host-only code; the CPU tests hold it)")
        return None
    import numpy as np
    from pggan_tpu_torch.cli import train as cli
    path = os.path.join(root, "data.h5")
    rng = np.random.RandomState(SEED + 3)
    with h5py.File(path, "w") as f:
        for r in (4, 8, 16, 32):
            f[f"data{r}x{r}"] = rng.randint(0, 256, (32, 3, r, r),
                                            dtype=np.uint8)
    argv = ["--dataset_class", "H5Dataset", "--H5Dataset.h5_path", path,
            "--H5Dataset.preload", "False",
            "--DepthManager.lod_training_nimg", "32",
            "--DepthManager.lod_transition_nimg", "32",
            "--DepthManager.tick_kimg_default", "0.064",
            "--DepthManager.tick_kimg_overrides", "{}",
            "--num_data_workers", "2", "--random_seed", str(SEED),
            "--result_dir", os.path.join(root, "h5runs"),
            "--total_kimg", "0.128", "--device", device]
    t0 = time.perf_counter()
    trainer = cli.main(cli.get_structured_params(
        vars(cli.build_parser().parse_args(argv))))
    sync(torch, device)
    secs = time.perf_counter() - t0
    if trainer.cur_nimg < 128:
        raise AssertionError(f"H5 run stopped at {trainer.cur_nimg} images")
    log(f"  H5Dataset (windowed reads, h5py {h5py.__version__}): "
        f"{trainer.cur_nimg} images to depth {trainer.depth} in {secs:.1f} s")
    return {"images": trainer.cur_nimg, "seconds": secs}


# the groups of the kernels in csrc/ that an f32 train step runs
# (utils/profiling.py's KERNEL_GROUPS)
OUR_GROUPS = ("conv3x3 kernel", "conv3x3_dw kernel", "upsample kernel",
              "pool kernel")
BF16_GROUPS = ("upsample kernel", "pool kernel")


def profile_phase(torch, steps: int = 2, compute_dtype="float32",
                  then=None):
    """``torch.profiler`` (``utils/profiling.py``) over ``steps`` warm
    depth-8 train steps of each graph (fade, stable), eager and replayed as
    CUDA graphs: device time summed by kernel name and group, device busy
    share (the union of kernel intervals over the host window of the
    synchronised steps), and the launches the host issued. A replay must
    run the kernels of the eager step: per step, as many of each
    hand-written kernel group on the card, and the graph's captured wrapper
    calls equal to the eager step's launches. ``then(G, D, state,
    builder)`` runs on the graphed route's builder before the models go."""
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    from pggan_tpu_torch.utils.profiling import capture, device_profile
    G, D = paper_models(torch, "cuda", compute_dtype)
    state = init_state(G, D, seed=SEED)
    out, wrapper_calls = {}, {}
    groups = OUR_GROUPS if compute_dtype == "float32" else BF16_GROUPS
    for route in ("eager", "graphed"):
        builder = TrainStepBuilder(G, D, cuda_graphs=route == "graphed")
        prep = builder.prep_fn()
        u8 = uint8_reals(torch, builder, TRAIN_DEPTH, SEED).cuda()
        for fade in (True, False):
            alpha = 0.5 if fade else 1.0
            step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
            for _ in range(2):  # warm-up; the graphed route's capture
                step(state, prep(u8, alpha), alpha, LR, LR)
            reals = prep(u8, alpha)
            launches = dict(_build.LAUNCHES)

            def run(step=step, reals=reals, alpha=alpha):
                for _ in range(steps):
                    step(state, reals, alpha, LR, LR)
            prof, wall_ms = capture(run)
            graph = f"{route}_{'fade' if fade else 'stable'}"
            out[graph] = device_profile(prof, wall_ms, steps, graph, "step",
                                        log=log)
            wrapper_calls[graph] = (
                {k: (n - launches.get(k, 0)) / steps
                 for k, n in _build.LAUNCHES.items()
                 if n != launches.get(k, 0)}
                if route == "eager" else dict(step.captured))
    for graph in ("fade", "stable"):
        eager, replay = out[f"eager_{graph}"], out[f"graphed_{graph}"]
        ours = {g: eager["kernels_per_step_by_group"].get(g, 0)
                for g in groups}
        theirs = {g: replay["kernels_per_step_by_group"].get(g, 0)
                  for g in groups}
        calls = (wrapper_calls[f"eager_{graph}"],
                 wrapper_calls[f"graphed_{graph}"])
        log(f"  {graph}: hand-written kernels on the card a step, eager "
            f"{ours}, replayed {theirs}; wrapper calls a step, eager "
            f"{calls[0]}, captured {calls[1]}")
        if ours != theirs or not all(ours.values()) or calls[0] != calls[1]:
            raise AssertionError(f"{graph}: the replay ran other kernels "
                                 f"than the eager step")
    if then is not None:
        then(G, D, state, builder)
    del G, D, state, builder
    torch.cuda.empty_cache()
    return out


def kernel_of(name: str):
    """The kernel mode (a key of KERNELS) of a device kernel's name in a
    profile, or None for a kernel not in csrc/."""
    import re
    m = re.search(r"conv3x3_wgmma<\s*\d+\s*,\s*(\d)\s*>", name)
    if m:
        return ("conv3x3", "conv3x3_act", "conv3x3_act_pn")[int(m.group(1))]
    if "conv3x3_dw" in name:  # both passes
        return "conv3x3_dw"
    for base in ("avgpool2x", "upsample2x"):
        m = re.search(base + r"\w*<([^>]*)>", name)
        if m:
            bf16 = "bfloat16" in m.group(1) or "uint2" in m.group(1)
            return base + ("_bf16" if bf16 else "")
    return None


def device_ms_by_kernel(profile_out: dict) -> dict:
    """Device ms per step of each kernel mode in a ``device_profile``."""
    ms = collections.Counter()
    for name, t in profile_out["ms_per_step_by_name"].items():
        k = kernel_of(name)
        if k is not None:
            ms[k] += t
    return dict(ms)


# -- bf16 (phases 3, 12-15) and the export (phase 16) --------------------------

def bf16_step_calls(torch):
    """The kernel calls (``CallLog``) of one eager bf16 depth-8 fade step of
    the paper configuration at batch 3: the bf16 pool and upsample only
    (the conv kernels are f32 and the bf16 models never reach them)."""
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, "cuda", "bfloat16")
    state = init_state(G, D, seed=SEED)
    builder = TrainStepBuilder(G, D, cuda_graphs=False)
    u8 = uint8_reals(torch, builder, TRAIN_DEPTH, SEED).cuda()
    call_log = CallLog()
    with call_log.recording():
        metrics = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, True)(
            state, builder.prep_fn()(u8, 0.5), 0.5, LR, LR)
    values = {k: float(v) for k, v in metrics.items()}
    names = {name for name, _sig in call_log.calls}
    log(f"  one bf16 depth-{TRAIN_DEPTH} fade step: {values}; kernel calls "
        f"{sum(call_log.calls.values())} at {len(call_log.calls)} shapes "
        f"({sorted(names)})")
    if names != set(BF16_KERNELS) or not all(
            math.isfinite(v) for v in values.values()):
        raise AssertionError(f"bf16 step: kernels {names}, metrics {values}")
    del G, D, state, builder
    torch.cuda.empty_cache()
    return call_log.calls


def rms(torch, a, b) -> float:
    """RMS of a - b, in float64."""
    return float((a.double() - b.double()).square().mean().sqrt())


def bf16_gap(torch, card16, cpu16, card32, what) -> dict:
    """RMS(card bf16 - CPU bf16) and RMS(card bf16 - card f32), logged with
    their ratio. Past a few layers the two bf16 routes are as far apart as
    bf16 is from f32: a rounding that one route's f32 sum puts on the other
    side of a bf16 step changes the next layer's inputs by an ulp, which
    moves more roundings, layer after layer (phase 14 logs the same ratio
    for a card route that rounds exactly as the CPU's does). So the bar of
    a quarter holds per conv call (``PrimitiveLog``), not end to end."""
    got, gap = rms(torch, card16, cpu16), rms(torch, card16, card32)
    log(f"    {what}: RMS card bf16 - CPU bf16 {got:.3e}, card bf16 - card "
        f"f32 {gap:.3e} ({got / max(gap, 1e-30):.3f} of it)")
    return {"rms_vs_cpu_bf16": got, "rms_vs_card_f32": gap,
            "ratio": got / max(gap, 1e-30)}


class PrimitiveLog:
    """Records every conv primitive call of the models' forwards (function,
    parameters, input, options and output, on the CPU), to replay each on
    the card with the same input: one conv's rounding at a time."""

    SITES = {"generator": ("equalized_conv2d", "equalized_conv2d_up2x"),
             "discriminator": ("equalized_conv2d",
                               "equalized_conv2d_pool_in")}

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self):
        import importlib
        from pggan_tpu_torch.ops import primitives
        mods = {m: importlib.import_module(f"pggan_tpu_torch.models.{m}")
                for m in self.SITES}

        def wrap(name):
            fn = getattr(primitives, name)

            def logged(params, x, **kw):
                y = fn(params, x, **kw)
                self.calls.append((name, {k: v.detach().clone()
                                          for k, v in params.items()},
                                   x.detach().clone(), kw, y.detach()))
                return y
            return logged
        try:
            for m, names in self.SITES.items():
                for name in names:
                    setattr(mods[m], name, wrap(name))
            yield self
        finally:
            for m, names in self.SITES.items():
                for name in names:
                    setattr(mods[m], name, getattr(primitives, name))

    def replay(self, torch, device) -> dict:
        """Each call on ``device`` in bf16 and in f32 from the recorded
        input: the largest RMS(device bf16 - CPU bf16) / RMS(device bf16 -
        device f32) over the calls, which must stay under a quarter."""
        from pggan_tpu_torch.ops import primitives
        worst, ratios = None, []
        with torch.no_grad():
            for name, params, x, kw, want in self.calls:
                fn = getattr(primitives, name)
                p = {k: v.to(device) for k, v in params.items()}
                got = fn(p, x.to(device), **kw).cpu()
                f32 = fn(p, x.to(device).float(),
                         **{**kw, "compute_dtype": None}).cpu()
                r = rms(torch, got, want) / max(rms(torch, got, f32), 1e-30)
                ratios.append(r)
                if worst is None or r > worst[0]:
                    worst = (r, name, tuple(x.shape))
        log(f"    {len(self.calls)} conv calls of the forwards, each on the "
            f"card from the CPU's input: RMS card bf16 - CPU bf16 at most "
            f"{worst[0]:.3f} of card bf16 - card f32 ({worst[1]} "
            f"{worst[2]}; bar 0.25), median "
            f"{sorted(ratios)[len(ratios) // 2]:.3f}")
        if worst[0] > 0.25:
            raise AssertionError(f"{worst[1]} {worst[2]}: card bf16 against "
                                 f"CPU bf16 {worst[0]:.3f} of the bf16 gap")
        return {"calls": len(self.calls), "worst_ratio": worst[0],
                "median_ratio": sorted(ratios)[len(ratios) // 2]}


@contextlib.contextmanager
def rounding_once_on_the_card(torch):
    """The card's bf16 convs as the CPU's bf16 route computes them: f32
    sums of the bf16 operands (TF32 products of bf16 values are exact),
    rounded once; to show how far apart two routes get that round the same
    way."""
    from pggan_tpu_torch.ops import primitives
    orig = primitives._conv_in

    def once(cd, conv, x, w, **kw):
        if cd is None:
            return orig(cd, conv, x, w, **kw)
        x, w = x.to(cd), w.to(cd)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return conv(x.float(), w.float(), **kw).to(cd)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    primitives._conv_in = once
    try:
        yield
    finally:
        primitives._conv_in = orig


def bf16_serve_phase(torch, card):
    """Phase 12: a bf16 snapshot of phase 4's random paper-config weights
    through the generate CLI at depth 8, batch 16 (a fade snapshot: G's fade
    upsample runs the bf16 kernel), its images against the CPU's bf16 route
    and the card's f32 serve; then img/s of warm ``sample_images`` calls,
    bf16 in turns with f32 chain on and chain off (phase 4's stable
    snapshot), and the device profile of one bf16 chunk."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot, save_snapshot
    from pggan_tpu_torch.models.generator import Generator
    from pggan_tpu_torch.sampling import sample_images
    from pggan_tpu_torch.utils.profiling import capture, device_profile
    paper = dict(dataset_shape=(1, 3, 1024, 1024))
    out = {}
    fwd = -(-40 // BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        snaps = {}
        for i, alpha, cd in ((0, 1.0, "float32"), (0, 1.0, "bfloat16"),
                             (1, 0.5, "float32"), (1, 0.5, "bfloat16")):
            G = Generator(**paper, compute_dtype=cd,
                          generator=torch.Generator().manual_seed(SEED + i))
            snaps[(i, cd)] = os.path.join(
                tmp, f"network-snapshot-generator-{cd}-{i:06}.dat")
            save_snapshot(snaps[(i, cd)], G, depth=8, alpha=alpha)
            del G
        imgs, counts = serve(
            torch, snaps[(1, "bfloat16")],
            ["--minibatch", str(BATCH), "--num_samples", "40",
             "--random_seed", str(SEED)],
            {"upsample2x_bf16": fwd}, "bf16 paper, fade 0.5")
        out["cli_launches"] = counts
        if imgs.shape != (40, 3, 1024, 1024) or imgs.dtype != np.float32 \
                or not np.isfinite(imgs).all():
            raise AssertionError(f"bf16 serve: {imgs.shape} {imgs.dtype}")
        n = 2
        refs = {}
        for dev, cd in (("cpu", "bfloat16"), ("cuda", "float32")):
            G, meta = load_snapshot(snaps[(1, cd)], device=dev)
            refs[(dev, cd)] = torch.from_numpy(sample_images(
                G, meta["depth"], meta["alpha"], n,
                rng=np.random.RandomState(SEED)).transpose(0, 3, 1, 2))
            del G
        out["images"] = bf16_gap(
            torch, torch.from_numpy(imgs[:n]), refs[("cpu", "bfloat16")],
            refs[("cuda", "float32")], f"{n} served images (1024 px)")
        scale = float(refs[("cuda", "float32")].double().square().mean()
                      .sqrt())
        if max(out["images"]["rms_vs_cpu_bf16"],
               out["images"]["rms_vs_card_f32"]) > BF16_IMAGE_RMS * scale:
            raise AssertionError(f"bf16 serve: images {out['images']}, "
                                 f"RMS of the f32 images {scale:.3e}")
        del imgs, refs

        # img/s in turns: bf16, f32 chain on, f32 chain off (stable)
        models = {}
        for route, cd, chain in (("bf16", "bfloat16", False),
                                 ("f32_chain_on", "float32", True),
                                 ("f32_chain_off", "float32", False)):
            G, meta = load_snapshot(snaps[(0, cd)], device="cuda")
            G.inference_chain = chain
            models[route] = G
        n = 3 * BATCH

        def serve_n(route):
            return sample_images(models[route], 8, 1.0, n, minibatch=BATCH,
                                 rng=np.random.RandomState(SEED))
        for route in models:
            serve_n(route)  # warm
        rates = {k: [] for k in models}
        order = list(models)
        for turn in range(4):
            for route in order[turn % 3:] + order[:turn % 3]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve_n(route)
                torch.cuda.synchronize()
                rates[route].append(n / (time.perf_counter() - t0))
        out["img_per_s_all"] = rates
        out["img_per_s"] = {k: sorted(v)[len(v) // 2] for k, v in
                            rates.items()}
        log(f"  serves of {n} images, depth 8, batch {BATCH}, in turns: "
            + ", ".join(f"{k} {', '.join(f'{r:.2f}' for r in v)} img/s"
                        for k, v in rates.items()) + f" (on {card})")
        prof, wall_ms = capture(lambda: sample_images(
            models["bf16"], 8, 1.0, BATCH, minibatch=BATCH,
            rng=np.random.RandomState(SEED)))
        out["profile"] = device_profile(
            prof, wall_ms, 1, f"bf16 serve profile, one chunk of {BATCH}",
            "chunk", log=log)
        del models
    torch.cuda.empty_cache()
    return out


def bf16_train_phase(torch):
    """Phase 13: the bf16 paper configuration's depth-8 step (batch 3),
    profiled (``profile_phase``, one warm step of each graph, eager and
    replayed: wall ms of the synchronised step under the profiler, busy
    share, host launches, the replay running the eager step's kernels, the
    top kernels; a bf16 step takes over a second, so these are its times),
    the peak memory, then 20 replays of the fade graph: finite metrics,
    parameters float32 and finite. Returns the numbers, the eager calls'
    launches and the kernels the replays ran."""
    from pggan_tpu_torch.ops import _build
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()

    def replays(G, D, state, builder):
        out["launches_eager"] = dict(_build.LAUNCHES)
        step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, True)
        reals = builder.prep_fn()(uint8_reals(torch, builder, TRAIN_DEPTH,
                                              SEED).cuda(), 0.5)
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, reals, 0.5, LR, LR)
            values = {k: float(v) for k, v in metrics.items()}
            times.append((time.perf_counter() - t0) * 1e3)
            if not all(math.isfinite(v) for v in values.values()):
                raise AssertionError(f"bf16 replay: metrics {values}")
        replayed = replayed_kernels(builder)
        params = [*G.parameters(), *D.parameters()]
        if not all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                   for p in params):
            raise AssertionError("bf16 training left a parameter not f32 or "
                                 "not finite")
        out.update(replay_ms_fade=sorted(times)[len(times) // 2],
                   replay_ms_all_fade=times, replays_fade=step.replays,
                   kernels_run_in_replays=dict(replayed),
                   peak_bytes=torch.cuda.max_memory_allocated())
        log(f"  20 more replays of the fade graph: {out['replay_ms_fade']:.1f}"
            f" ms a replay (median), finite ({values}); {len(params)} "
            f"parameters float32 and finite; peak memory "
            f"{out['peak_bytes'] / 2**30:.2f} GiB; launches (eager calls) "
            f"{out['launches_eager']}; kernels run in replays "
            f"{dict(replayed)}")

    out["profile"] = profile_phase(torch, steps=1, compute_dtype="bfloat16",
                                   then=replays)
    for name in BF16_KERNELS:
        if not out["launches_eager"].get(name) or \
                not out["kernels_run_in_replays"].get(name):
            raise AssertionError(f"{name}: not launched by the bf16 eager "
                                 f"steps or not run in their replays")
    top = out["profile"]["graphed_fade"]["top_kernels_ms_per_step"]
    log("  the replayed bf16 fade step's top kernels: " + "; ".join(
        f"{ms:.2f} ms {name[:90]}" for name, ms in list(top.items())[:6]))
    return out, out["launches_eager"], out["kernels_run_in_replays"]


# The bf16 bars on the card against the CPU's bf16 route (PERF.md).
# Served images: card bf16 within this RMS of the f32 images' RMS, from
# the CPU's bf16 images and from the card's f32 ones (bf16 rounding
# everywhere puts them 1.7e-2 apart at an RMS near 1).
BF16_IMAGE_RMS = 0.05
# The depth-6 step, end to end: the JAX package's own bf16 bars
# (tests/test_mixed_precision.py:23-37), card bf16 against CPU bf16:
# images within 0.15, each loss within 0.2 (1 + |loss|).
BF16_IMAGE_MAX, BF16_LOSS_TOL = 0.15, 0.2
# The updated parameters, card bf16 against CPU bf16, set by measurement:
# over all parameters, |difference| / |update| in the 2-norm. Adam's first
# update is about lr * sign(g), so an element whose gradient the two
# routes take to other signs moves 2 lr apart. Measured 0.220 (card bf16
# against card f32: 0.258; this script on an H100 80GB HBM3 at 700 W).
BF16_UPDATE_TOL = 0.5


def bf16_step_against_cpu(torch, device="cuda"):
    """Phase 14: one depth-6 bf16 fade step of the paper configuration on
    the card and on the CPU's bf16 route (and an f32 step on the card),
    with the same parameters, reals, latents and GP mixing factors, lr LR.
    Every conv call of the forwards of G (the step's first latents) and D
    (G's images) replayed on the card from the CPU's input: RMS(card bf16
    - CPU bf16) at most 1/4 of RMS(card bf16 - card f32) (``PrimitiveLog``).
    The step's four losses: the same bar over their vector. The images end
    to end, whose ratio is logged (and that of a card route that rounds as
    the CPU's, ``rounding_once_on_the_card``): the JAX package's own bf16
    bar. The updated parameters within BF16_UPDATE_TOL."""
    import numpy as np
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    depth, alpha = CHECK_DEPTH, 0.5
    rng = np.random.RandomState(SEED)
    lat = (TRAIN_BATCH, paper_models(torch, "meta")[0].latent_size)
    draws = [("normal", rng.randn(*lat).astype(np.float32)),
             ("uniform", rng.uniform(size=TRAIN_BATCH).astype(np.float32)),
             ("normal", rng.randn(*lat).astype(np.float32))]
    z = torch.from_numpy(draws[0][1])
    runs, prims = {}, PrimitiveLog()
    for i, (dev, cd) in enumerate((("cpu", "bfloat16"), (device, "bfloat16"),
                                   (device, "float32"))):
        G, D = paper_models(torch, dev, cd)
        state = init_state(G, D, seed=SEED)
        builder = TrainStepBuilder(G, D, cuda_graphs=False)
        it = iter(draws)

        def noise(kind, shape, it=it, dev=dev):
            k, v = next(it)
            assert (k, tuple(shape)) == (kind, v.shape)
            return torch.from_numpy(v).to(dev)
        record = prims.recording() if i == 0 else contextlib.nullcontext()
        with torch.no_grad(), record:
            images = G(z.to(dev), depth, alpha)
            D(images, depth, alpha)
            images = images.cpu()
        if i == 1:
            with torch.no_grad(), rounding_once_on_the_card(torch):
                once = G(z.to(dev), depth, alpha).cpu()
        before = [p.detach().cpu().clone()
                  for p in [*G.parameters(), *D.parameters()]]
        u8 = uint8_reals(torch, builder, depth, SEED + 10).to(dev)
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        metrics = builder.step_fn(depth, TRAIN_BATCH, True)(
            state, builder.prep_fn()(u8, alpha), alpha, LR, LR, noise=noise)
        values = {k: float(v) for k, v in metrics.items()}
        log(f"  {dev} {cd}: {time.perf_counter() - t0:.1f} s, {values}, "
            f"launches {dict(_build.LAUNCHES)}")
        after = [p.detach().cpu().clone()
                 for p in [*G.parameters(), *D.parameters()]]
        runs[(dev, cd)] = (images, values, before, after,
                           dict(_build.LAUNCHES))
        del G, D, state, builder
    cpu16, card16, card32 = (runs[k] for k in (
        ("cpu", "bfloat16"), (device, "bfloat16"), (device, "float32")))
    for name in BF16_KERNELS:
        if device == "cuda" and not card16[4].get(name):
            raise AssertionError(f"depth-6 bf16 step: {name} not launched")
    out = {"conv_calls": prims.replay(torch, device)}
    out["images"] = bf16_gap(torch, card16[0], cpu16[0], card32[0],
                             f"depth-{depth} images")
    out["images_rounding_once_on_the_card"] = bf16_gap(
        torch, once, cpu16[0], card32[0],
        f"depth-{depth} images, the card rounding as the CPU's route")
    keys = sorted(card16[1])
    vec = [torch.tensor([r[1][k] for k in keys]) for r in (card16, cpu16,
                                                           card32)]
    out["losses"] = bf16_gap(torch, *vec, f"losses {keys}")
    if out["losses"]["ratio"] > 0.25:  # the losses average the chaos out
        raise AssertionError(f"depth-{depth} bf16 losses, card against CPU:"
                             f" {out['losses']}")
    img_err = float((card16[0] - cpu16[0]).abs().max())
    loss_err = {k: abs(card16[1][k] - cpu16[1][k]) for k in keys}
    if img_err > BF16_IMAGE_MAX or any(
            loss_err[k] > BF16_LOSS_TOL * (1 + abs(cpu16[1][k]))
            for k in keys):
        raise AssertionError(f"depth-{depth} bf16, card against CPU: images "
                             f"{img_err:.3e} apart, losses {loss_err}")
    out.update(images_max_abs_err=img_err, losses_abs_err=loss_err)

    def overall(before, got, want):
        num = sum(float(((g - b) - (w - b)).square().sum())
                  for b, g, w in zip(before, got, want))
        den = sum(float((w - b).square().sum())
                  for b, w in zip(before, want))
        return (num / max(den, 1e-30)) ** 0.5
    vs_cpu = update_errors(torch, card16[2], card16[3], cpu16[3])
    vs_f32 = update_errors(torch, card16[2], card16[3], card32[3])
    vs_cpu["overall"] = overall(card16[2], card16[3], cpu16[3])
    vs_f32["overall"] = overall(card16[2], card16[3], card32[3])
    out["updates_vs_cpu_bf16"], out["updates_vs_card_f32"] = vs_cpu, vs_f32
    log(f"    images: card bf16 against CPU bf16 at most {img_err:.3e} apart "
        f"(bar {BF16_IMAGE_MAX}); losses {loss_err} (bar {BF16_LOSS_TOL} "
        f"(1 + |loss|))")
    log(f"    updated parameters, card bf16 against CPU bf16: |difference| /"
        f" |update| over all {vs_cpu['overall']:.3e} (bar "
        f"{BF16_UPDATE_TOL}), largest of a tensor "
        f"{vs_cpu['update_err_over_norm']:.3e} over "
        f"{vs_cpu['tensors_moved']} tensors; against card f32 "
        f"{vs_f32['overall']:.3e}, largest {vs_f32['update_err_over_norm']:.3e}")
    if vs_cpu["overall"] > BF16_UPDATE_TOL:
        raise AssertionError(f"depth-{depth} bf16 updates, card against CPU:"
                             f" {vs_cpu['overall']:.3e}")
    torch.cuda.empty_cache()
    return out


def bf16_cli_phase(torch, keep_dir, device="cuda"):
    """Phase 15: a bf16 progressive run of the paper configuration through
    ``cli.train`` (in this process, so its launches count) from depth 0 to
    8 on phase 9's shortened schedule to BF16_CLI_TOTAL kimg, no resume: the
    bf16 pool and upsample launch in eager first calls and run in replays,
    no f32 kernel runs, the last snapshot's config says bfloat16 and loads
    through ``load_snapshot``; sec/kimg per tick. The snapshot is copied
    into ``keep_dir``. ``device`` lets a scratch script rehearse it on the
    CPU."""
    import glob
    from pggan_tpu_torch.checkpoint import load_snapshot
    from pggan_tpu_torch.cli import train as cli
    from pggan_tpu_torch.ops import _build
    out = {}
    with tempfile.TemporaryDirectory() as root:
        argv = cli_argv(root, BF16_CLI_TOTAL, "--Generator.compute_dtype",
                        "bfloat16", "--Discriminator.compute_dtype",
                        "bfloat16", "--device", device)
        _build.LAUNCHES.clear()
        sync(torch, device)
        t0 = time.perf_counter()
        trainer = cli.main(cli.get_structured_params(
            vars(cli.build_parser().parse_args(argv))))
        sync(torch, device)
        out["run_s"] = time.perf_counter() - t0
        # cli.main resets the peak when the run starts
        out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                             if device == "cuda" else None)
        launches = dict(_build.LAUNCHES)
        replayed = replayed_kernels(trainer.builder)
        out["graphs_captured"] = len(trainer.builder.graphs())
        depth = trainer.depth
        del trainer
        run, = glob.glob(os.path.join(root, "001-*"))
        rows = [json.loads(ln) for ln in open(os.path.join(run,
                                                           "metrics.jsonl"))]
        snap = max(glob.glob(os.path.join(
            run, "network-snapshot-generator-*.dat")), key=os.path.getmtime)
        G, meta = load_snapshot(snap, device=device)
        if depth != TRAIN_DEPTH or G.compute_dtype != "bfloat16" or \
                meta["depth"] != TRAIN_DEPTH or not all(
                    math.isfinite(rows[-1][f"{k}.epoch_mean"])
                    for k in cli.LOSSES):
            raise AssertionError(f"bf16 run: depth {depth}, snapshot "
                                 f"{G.compute_dtype} at {meta}, last tick "
                                 f"{rows[-1]}")
        out["snapshot"] = shutil.copy(snap, os.path.join(
            keep_dir, "network-snapshot-generator-bf16.dat"))
        del G
    per_depth = collections.defaultdict(list)
    for r in rows:
        per_depth[int(r["depth"])].append(r["sec.kimg"])
    out.update(ticks=len(rows), launches_eager=launches,
               kernels_run_in_replays=dict(replayed),
               sec_per_kimg_by_depth=dict(sorted(per_depth.items())))
    log(f"  bf16 run: {len(rows)} ticks to depth {depth} in "
        f"{out['run_s']:.1f} s, {out['graphs_captured']} graphs, peak "
        f"{(out['peak_bytes'] or 0) / 2**30:.2f} GiB; snapshot config "
        f"bfloat16; "
        f"launches {launches}; kernels run in replays {dict(replayed)}")
    log("  sec/kimg per tick by the depth it ended at: " + "; ".join(
        f"{d}: {', '.join(f'{x:.1f}' for x in v)}"
        for d, v in sorted(per_depth.items())))
    for name in BF16_KERNELS:
        if device == "cuda" and (not launches.get(name)
                                 or not replayed.get(name)):
            raise AssertionError(f"{name}: not launched by the bf16 run or "
                                 f"not run in its replays")
    f32 = [k for k in launches if k not in BF16_KERNELS]
    if f32:
        raise AssertionError(f"the bf16 run launched f32 kernels {f32}")
    torch.cuda.empty_cache()
    return out, launches, dict(replayed)


def export_phase(torch, f32_snapshot, bf16_snapshot, root):
    """Phase 16: ``cli.export`` of phase 9's depth-8 f32 snapshot at batch
    16 and with a polymorphic batch, and of phase 15's bf16 snapshot, each
    verified against the direct forward on the card; one artifact loaded
    and run on the card by a process that imports neither package; the
    export launches no kernel while an ordinary forward of the same G
    does; a program traced on the CPU and moved to the card against the
    one traced there; one batch-16 call of the exported program timed
    beside the direct forward and ``sample_images`` chain off."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot, save_snapshot
    from pggan_tpu_torch.cli.export import cli_main
    from pggan_tpu_torch.export import (export_generator, exportable,
                                        load_exported)
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.sampling import sample_images
    out = {}
    arts = {}
    for tag, snap, batch in (("f32_batch16", f32_snapshot, 16),
                             ("f32_polymorphic", f32_snapshot, -1),
                             ("bf16_batch16", bf16_snapshot, 16)):
        path = os.path.join(root, tag)
        t0 = time.perf_counter()
        arts[tag] = cli_main(["--generator_path", snap, "--out", path,
                              "--batch", str(batch), "--verify", "True"])
        info = json.load(open(path + ".json"))
        out[tag] = {"seconds": time.perf_counter() - t0,
                    "artifact_bytes": info["artifact_bytes"],
                    "in_avals": info["in_avals"],
                    "out_avals": info["out_avals"],
                    "platforms": info["platforms"]}
        log(f"  {tag}: exported and verified in {out[tag]['seconds']:.1f} s,"
            f" {info['artifact_bytes'] / 2**20:.1f} MiB, "
            f"{info['in_avals']} -> {info['out_avals']} on "
            f"{info['platforms']}")

    # the artifact in a process that imports neither package
    z = np.random.RandomState(SEED).randn(16, 512).astype(np.float32)
    np.save(os.path.join(root, "z.npy"), z)
    # the program carries no TF32 setting: the consumer turns cuDNN's TF32
    # off, as the port's entry points do, for f32 convs; both runs hold
    # cuDNN to its deterministic algorithms (G's transposed convs may sum
    # with atomics otherwise)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "torch.backends.cudnn.deterministic = True\n"
        f"p = torch.export.load({arts['f32_batch16']!r})\n"
        "z = torch.from_numpy(np.load('z.npy')).cuda()\n"
        "out = p.module()(z)\n"
        "np.save('out.npy', out.cpu().numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pggan_tpu', 'pggan_tpu_torch', 'jax')]\n"
        "assert not bad, bad\n"
        "print(torch.cuda.get_device_name(0))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"the bare process failed: {res.stderr[-3000:]}")
    program = load_exported(arts["f32_batch16"]).module()
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            here = program(torch.from_numpy(z).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = False
    bare = np.load(os.path.join(root, "out.npy"))
    out["bare_process_max_abs_diff"] = float(np.abs(bare - here).max())
    log(f"  a process importing torch alone ran the batch-16 artifact on "
        f"{res.stdout.strip()}: max |difference| to this process's run "
        f"{out['bare_process_max_abs_diff']:.3e}")
    if out["bare_process_max_abs_diff"] > 1e-5:
        raise AssertionError("the bare process's images differ")

    # export launches nothing; an ordinary forward of the same G does
    G, meta = load_snapshot(f32_snapshot, device="cuda")
    fade_snap = os.path.join(root, "fade.dat")
    save_snapshot(fade_snap, G, meta["depth"], 0.5)
    G, _ = load_snapshot(fade_snap, device="cuda")
    _build.LAUNCHES.clear()
    on_card = export_generator(G, 8, 0.5, 4)
    export_launches = dict(_build.LAUNCHES)
    zt = torch.from_numpy(z[:4]).cuda()
    # the forwards compared below run cuDNN's deterministic algorithms,
    # which sum in a fixed order, so that only the programs can differ
    torch.backends.cudnn.deterministic = True
    with torch.no_grad():
        direct = exportable(G)(zt, 8, 0.5)
    forward_launches = dict(_build.LAUNCHES)
    log(f"  launches while exporting a fade (alpha 0.5) G: "
        f"{export_launches}; after one ordinary forward of it: "
        f"{forward_launches}")
    if export_launches or forward_launches != {
            "upsample2x": 1, "wide_conv": WIDE_PER_FORWARD}:
        raise AssertionError("the export reached a kernel, or the forward "
                             "did not")
    G_cpu, _ = load_snapshot(fade_snap, device="cpu")
    moved = export_generator(G_cpu, 8, 0.5, 4, platforms=("cuda",))
    try:
        with torch.no_grad():
            a = on_card.module()(zt)
            b = moved.module()(zt)
    finally:
        torch.backends.cudnn.deterministic = False
    out["moved_vs_traced_on_card"] = float((a - b).abs().max())
    out["traced_vs_direct"] = float((a - direct).abs().max())
    log(f"  traced on the CPU and moved to the card, against traced on the "
        f"card: max |difference| {out['moved_vs_traced_on_card']:.3e} "
        f"(traced against the direct forward {out['traced_vs_direct']:.3e})")
    if out["moved_vs_traced_on_card"] > 1e-5:
        raise AssertionError("the moved program computes otherwise")
    del G, G_cpu, on_card, moved, a, b, direct

    # one batch-16 call, the exported program beside the direct forward
    G, meta = load_snapshot(f32_snapshot, device="cuda")
    G.inference_chain = False
    zt = torch.from_numpy(z).cuda()
    calls = {"exported": lambda: program(zt),
             "direct_chain_off": lambda: G(zt, 8, 1.0, False),
             "sample_images_chain_off": lambda: sample_images(
                 G, 8, 1.0, 16, minibatch=16,
                 rng=np.random.RandomState(SEED))}
    times = {k: [] for k in calls}
    with torch.no_grad():
        for fn in calls.values():
            fn()
        for _ in range(5):
            for k, fn in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
    out["batch16_ms"] = {k: sorted(v)[2] for k, v in times.items()}
    out["batch16_ms_all"] = times
    log("  one batch-16 call (ms, median of 5, synchronised): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["batch16_ms"].items()))
    del G, program
    torch.cuda.empty_cache()
    return out


# Data parallelism (phases A-D), at the paper configuration: a process
# group of one NCCL rank around the graphed depth-8 step; two gloo ranks
# on the one card around an eager depth-6 step of the 1024 config's
# depth-6 batch (14, 7 a rank, no rounding at world size 2); the train CLI
# under torchrun on a short schedule (depth 0-3) with a resume; sampling
# over two replicas of G on the one card. Two NCCL ranks cannot share one
# card, so a run across cards is not made here.
DP_REPLAYS = 6  # replays timed per graph and route in phase A
GLOO_DEPTH, GLOO_BATCH, GLOO_WORLD = 6, 14, 2
GLOO_WARM = 3  # steps that give phase B's compared step an Adam history
GLOO_KERNELS = ("conv3x3", "conv3x3_act", "conv3x3_act_pn", "conv3x3_dw",
                "avgpool2x", "upsample2x")
DP_STOP, DP_TOTAL = 0.192, 0.336  # depth 2's fade / depth 3's end
DP_CLI_KERNELS = ("avgpool2x", "upsample2x")  # depths 0-3: NCHW only
DP_SAMPLES = 40  # chunks of BATCH: 16, 16 and a remainder of 8


def nccl_phase(torch):
    """Phase A: the paper configuration's depth-8 step at TRAIN_BATCH under
    a one-rank NCCL process group (a ``FileStore`` in a temp dir), graphed:
    per graph (fade, stable) the eager first call, the capture, then
    DP_REPLAYS replays timed in turns with a group-less builder's; one
    replay profiled (the NCCL kernels in the graph); a grouped dispatch of
    GROUP fade steps (``group_step_fn``) under the process group, its
    replay profiled (GROUP times the NCCL kernels); then, with cuDNN's
    deterministic algorithms, a group replay against a group-less eager
    step from the same state (``twin_updates``: the losses and the whole
    update within phase 5's bars)."""
    import torch.distributed as dist
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.parallel import Group
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    from pggan_tpu_torch.utils.profiling import (capture, device_profile,
                                                 group_of, kernel_rows)
    median = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)
    try:
        group = Group.current(torch.device("cuda", 0))
        routes, launches, out = {}, {}, {"backend": group.backend,
                                         "world_size": group.world_size}
        for route in ("group", "plain"):
            G, D = paper_models(torch, "cuda")
            grp = group if route == "group" else None
            state = init_state(G, D, seed=SEED, group=grp)
            builder = TrainStepBuilder(G, D, group=grp)
            routes[route] = (state, builder, G, D)
            prep = builder.prep_fn()
            u8 = uint8_reals(torch, builder, TRAIN_DEPTH, SEED).cuda()
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            for fade in (True, False):  # eager, then capture + a replay
                alpha = 0.5 if fade else 1.0
                step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
                for _ in range(2):
                    metrics = step(state, prep(u8, alpha), alpha, LR, LR)
                if not all(math.isfinite(float(v))
                           for v in metrics.values()):
                    raise AssertionError(f"{route}: metrics {metrics}")
            torch.cuda.synchronize()
            launches[route] = dict(_build.LAUNCHES)
        for fade in (True, False):
            alpha = 0.5 if fade else 1.0
            graph = "fade" if fade else "stable"
            reals = prep(u8, alpha)
            times = {"group": [], "plain": []}
            for i in range(DP_REPLAYS):
                for route in (("plain", "group") if i % 2 == 0
                              else ("group", "plain")):
                    state, builder = routes[route][:2]
                    step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(state, reals, alpha, LR, LR)
                    torch.cuda.synchronize()
                    times[route].append((time.perf_counter() - t0) * 1e3)
            for route, v in times.items():
                out[f"{route}_replay_ms_{graph}"] = median(v)
                out[f"{route}_replay_ms_all_{graph}"] = v
            out[f"group_cost_{graph}"] = (median(times["group"])
                                          / median(times["plain"]) - 1.0)
            log(f"  replayed {graph} step: {median(times['group']):.2f} ms "
                f"under the group, {median(times['plain']):.2f} without "
                f"({out[f'group_cost_{graph}']:+.2%}; in turns, "
                f"{DP_REPLAYS} each)")
        state, builder = routes["group"][:2]
        step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, True)
        reals = prep(u8, 0.5)
        prof, wall_ms = capture(lambda: step(state, reals, 0.5, LR, LR))
        profile = device_profile(prof, wall_ms, 1, "one group replay, fade",
                                 "step", log=log)
        # at one rank NCCL runs an in-place sum (the statistic's, the
        # metrics') as nothing, and the gradients' averages as its
        # oneRankReduce kernel: those must be in the replay
        nccl = {n: ms for n, ms in profile["ms_per_step_by_name"].items()
                if group_of(n) == "NCCL collectives"}
        n_nccl = sum(r["count"] for r in kernel_rows(prof)
                     if r["group"] == "NCCL collectives")
        if n_nccl < 2:
            raise AssertionError(f"{n_nccl} NCCL kernels in the profile of a "
                                 f"replay: the gradients' all-reduces are not "
                                 f"in the graph")
        log(f"  NCCL kernels in the replay: {n_nccl}, {nccl} ms")
        out["nccl_kernels_per_replay"] = n_nccl
        out["profile_replay_fade"] = {
            k: v for k, v in profile.items() if k != "ms_per_step_by_name"}
        out["nccl_kernels_ms"] = nccl
        # a grouped dispatch of GROUP fade steps under the process group:
        # its graph records every step's collectives (thread-local capture)
        gstep = builder.group_step_fn(TRAIN_DEPTH, TRAIN_BATCH, True, GROUP)
        greals = torch.stack([reals] * GROUP)
        ones = torch.ones(GROUP).numpy()
        for _ in range(2):  # eager, then the capture and a replay
            gstep(state, greals, 0.5 * ones, LR * ones, LR * ones)
        prof, _ = capture(lambda: gstep(state, greals, 0.5 * ones,
                                        LR * ones, LR * ones))
        n_group = sum(r["count"] for r in kernel_rows(prof)
                      if r["group"] == "NCCL collectives")
        metrics = gstep(state, greals, 0.5 * ones, LR * ones, LR * ones)
        if n_group != GROUP * n_nccl or not all(
                bool(torch.isfinite(v).all()) for v in metrics.values()):
            raise AssertionError(f"a grouped dispatch of {GROUP} steps ran "
                                 f"{n_group} NCCL kernels ({n_nccl} a step), "
                                 f"metrics {metrics}")
        log(f"  a grouped dispatch of {GROUP} fade steps under the NCCL "
            f"group, replayed: {n_group} NCCL kernels, {n_nccl} a step; "
            f"capture {gstep.capture_s:.3f} s")
        out["nccl_kernels_per_grouped_replay"] = n_group
        replayed = replayed_kernels(builder)
        # the bar: a replay under the group against a group-less eager
        # step from the same state, cuDNN deterministic in both
        G, D = routes["group"][2:]
        rreals = prep(uint8_reals(torch, builder, TRAIN_DEPTH,
                                  SEED + 20).cuda(), REPLAY_ALPHA)
        del routes, builder, step, gstep, greals
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = True
        try:
            graphed = TrainStepBuilder(G, D, group=group).step_fn(
                TRAIN_DEPTH, TRAIN_BATCH, True)
            for _ in range(2):
                graphed(state, prep(u8, 0.5), 0.5, LR, LR)
            replay = twin_updates(torch, state, rreals, G, D, graphed)
        finally:
            torch.backends.cudnn.deterministic = False
        # the whole update is held: the group's statistic is summed and
        # its D scores reals and fakes apart, so unlike phase 5's replay
        # the two steps round differently, and Adam's normalisation takes
        # a tensor's small elements up to its own scale (phase B)
        if replay["loss_rel_err"] > STEP_LOSS_RTOL or \
                replay["update_err_over_total_norm"] > UPDATE_TOL:
            raise AssertionError(f"group replay against the group-less "
                                 f"eager step: {replay}")
        log(f"  a replay under the group against a group-less eager step "
            f"from the same state (cuDNN deterministic): losses within "
            f"{replay['loss_rel_err']:.2e} (bar {STEP_LOSS_RTOL}); the "
            f"update within {replay['update_err_over_total_norm']:.2e} of "
            f"its norm (bar {UPDATE_TOL}), of {replay['tensors_moved']} "
            f"tensors the worst within {replay['update_err_over_norm']:.2e}"
            f" of its own")
        out["group_replay_vs_plain_eager"] = replay
        del graphed, state, G, D
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    for name in TRAIN_KERNELS:
        if not launches["group"].get(name) or not replayed.get(name):
            raise AssertionError(f"{name} was never launched under the NCCL "
                                 f"group, or never replayed")
    out["launches_eager"] = launches["group"]
    out["kernels_run_in_replays"] = dict(replayed)
    return out, launches["group"], replayed


def gloo_inputs(repeats, latent_size):
    """Phase B's global reals (uint8, NHWC) and draws, from SEED."""
    import numpy as np
    rng = np.random.RandomState(SEED + 30 + repeats)
    res = 4 * 2 ** GLOO_DEPTH
    u8 = rng.randint(0, 256, (repeats, GLOO_BATCH, res, res, 3),
                     dtype=np.uint8)
    draws = []
    for _ in range(repeats):
        draws.append(("normal", rng.randn(GLOO_BATCH, latent_size)
                      .astype(np.float32)))
        draws.append(("uniform", rng.uniform(size=GLOO_BATCH)
                      .astype(np.float32)))
    draws.append(("normal", rng.randn(GLOO_BATCH, latent_size)
                  .astype(np.float32)))
    return u8, draws


def replayed_noise(torch, draws, device, group=None):
    """A step's ``noise`` hook replaying ``draws`` (global arrays; this
    rank's slice under ``group``) on ``device``."""
    from pggan_tpu_torch.parallel import shard_batch
    it = iter(draws)

    def noise(kind, shape):
        want, value = next(it)
        if group is not None:
            value = shard_batch(value, group)
        if (want, tuple(value.shape)) != (kind, tuple(shape)):
            raise AssertionError(f"draw {kind} {shape}, have {want} "
                                 f"{value.shape}")
        return torch.from_numpy(value).to(device)
    return noise


def gloo_start(torch, path):
    """Phase B's common start: SEED's paper models after GLOO_WARM eager
    depth-6 steps on their own draws (cuDNN deterministic), saved as a
    training state, so that the compared step's Adam has a history (at the
    first step an update is lr * sign(g), and a gradient at the noise level
    flips it)."""
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, "cuda")
    state = init_state(G, D, seed=SEED + 40)
    builder = TrainStepBuilder(G, D, cuda_graphs=False)
    step = builder.step_fn(GLOO_DEPTH, TRAIN_BATCH, True)
    # cuDNN's deterministic algorithms, as gloo_step runs the compared
    # step: its default ones may sum with atomics, and the start would
    # then differ from run to run
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(GLOO_WARM):
            u8 = uint8_reals(torch, builder, GLOO_DEPTH, SEED + 50 + i)
            step(state, builder.prep_fn()(u8.cuda(), 0.5), 0.5, LR, LR)
    finally:
        torch.backends.cudnn.deterministic = False
    checkpoint.save_training_state(path, state, 0, GLOO_WARM)
    del G, D, state, builder, step
    torch.cuda.empty_cache()


def gloo_step(torch, repeats, start, group=None, timed=2,
              deterministic=True):
    """One eager depth-6 fade step of the paper configuration from the
    training state at ``start`` on phase B's inputs (this rank's shard
    under ``group``), cuDNN deterministic unless ``deterministic`` is
    False; then ``timed`` more steps on the state's own draws. Returns the
    losses, the parameters before and after the first step and its
    gradients (Adam's first moments, b1 = 0: G's and the last D
    repeat's), all on the host, the launches of the first step and the ms
    of the timed ones."""
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.parallel import replicate, shard_batch
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, "cuda")
    state = init_state(G, D, seed=SEED, group=group)
    checkpoint.restore_training_state(
        state, checkpoint.load_training_state(start)[0], group)
    if group is not None:
        replicate(state.tensors())
    builder = TrainStepBuilder(G, D, d_training_repeats=repeats,
                               cuda_graphs=False, group=group)
    u8, draws = gloo_inputs(repeats, G.latent_size)
    reals = builder.prep_fn()(torch.from_numpy(u8).cuda(), 0.5)
    if group is not None:
        reals = shard_batch(reals, group, batch_dim=1).contiguous()
    params = [*G.parameters(), *D.parameters()]
    before = [p.detach().cpu() for p in params]
    step = builder.step_fn(GLOO_DEPTH, reals.shape[1], True)
    torch.backends.cudnn.deterministic = deterministic
    try:
        _build.LAUNCHES.clear()
        metrics = step(state, reals, 0.5, LR, LR,
                       noise=replayed_noise(torch, draws, "cuda", group))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        out = {"losses": {k: float(v) for k, v in metrics.items()},
               "before": before, "after": [p.detach().cpu() for p in params],
               "grads": [m.cpu() for m in [*state.g_opt.mu,
                                           *state.d_opt.mu]],
               "launches": launches, "ms": []}
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, reals, 0.5, LR, LR)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = False
    del G, D, state, builder, step
    torch.cuda.empty_cache()
    return out


def gloo_rank(work: str) -> int:
    """One of phase B's gloo ranks (``chip_smoke.py --gloo-rank WORK``,
    with torchrun's variables in the environment, ``LOCAL_RANK`` 0 for
    both: they share the one card), eager."""
    import torch
    import torch.distributed as dist
    from pggan_tpu_torch.parallel import initialize_distributed
    group = initialize_distributed("cuda", backend="gloo")
    try:
        if (group.backend, group.world_size) != ("gloo", GLOO_WORLD):
            raise AssertionError(f"{group}, {group.backend}")
        start = os.path.join(work, "start.dat")
        out = {r: gloo_step(torch, r, start, group) for r in (1, 2)}
        torch.save(out, os.path.join(work, f"rank{group.rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def gloo_phase(torch):
    """Phase B: two gloo ranks (spawned processes) on the one card, each
    on its 7 of the global batch of 14, eager, ``d_training_repeats`` 1
    and 2, the draws injected; against one process's global-batch eager
    step on the card from the same state (``gloo_start``) and draws:
    losses within STEP_LOSS_RTOL, both ranks' parameters bit-equal, and,
    with one D repeat, the averaged gradients within phase 7's
    STEP_GRAD_TOL. The updates are recorded beside the same one-process
    step's distance from itself under cuDNN's default algorithms (and the
    gradients of two D repeats beside the bar): Adam divides each element's
    gradient by its own scale, and the gradient penalty's second-order
    terms cancel, so an element far below its tensor's largest keeps the
    absolute rounding error of the large ones and its update takes it up
    to its own scale: two valid one-process steps differ by more than a
    bar at 1e-3 of the update norm could hold (both recorded)."""
    out = {"world_size": GLOO_WORLD, "depth": GLOO_DEPTH,
           "global_batch": GLOO_BATCH, "warm_steps": GLOO_WARM}
    with tempfile.TemporaryDirectory() as work:
        start = os.path.join(work, "start.dat")
        gloo_start(torch, start)
        ref = {r: gloo_step(torch, r, start) for r in (1, 2)}
        # the noise of the computation: the same step with cuDNN's default
        # algorithms against its deterministic ones
        floor = {r: update_errors(torch, ref[r]["before"],
                                  gloo_step(torch, r, start, timed=0,
                                            deterministic=False)["after"],
                                  ref[r]["after"]) for r in (1, 2)}
        here = os.path.abspath(__file__)
        logs = [open(os.path.join(work, f"log{r}.txt"), "w")
                for r in range(GLOO_WORLD)]
        t0 = time.perf_counter()
        with socket.socket() as sock:  # a free port for the TCP store
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, here, "--gloo-rank", work],
            cwd=os.path.dirname(here), stdout=logs[r],
            stderr=subprocess.STDOUT,
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(GLOO_WORLD),
                     LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)))
            for r in range(GLOO_WORLD)]
        try:
            while any(p.poll() is None for p in procs):
                if time.perf_counter() - t0 > 600 or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        out["ranks_wall_s"] = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                text = open(os.path.join(work, f"log{r}.txt")).read()
                raise AssertionError(f"gloo rank {r} exited {p.returncode}:"
                                     f"\n{text[-4000:]}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
                 for r in range(GLOO_WORLD)]
    launches = collections.Counter()
    for repeats in (1, 2):
        want = ref[repeats]
        for r, got in enumerate(r_[repeats] for r_ in ranks):
            loss_err = max(abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                           for k, v in want["losses"].items())
            errs = update_errors(torch, want["before"], got["after"],
                                 want["after"])
            grad_err, failed = 0.0, []
            for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
                scale = float(w.abs().max())
                grad_err = max(grad_err, float((g - w).abs().max())
                               / max(scale, 1e-30))
                if not torch.allclose(
                        g, w, rtol=STEP_GRAD_TOL["rtol"],
                        atol=STEP_GRAD_TOL["scaled_atol"] * scale):
                    failed.append(i)
            errs["grad_err_over_max"] = grad_err
            # the gradients are held where each model takes one update:
            # with two D repeats the second's gradient is taken at
            # parameters that the first update's rounding, passed through
            # Adam's normalisation, already moved apart (recorded)
            if loss_err > STEP_LOSS_RTOL or (repeats == 1 and failed):
                raise AssertionError(f"gloo rank {r}, {repeats} D repeat(s):"
                                     f" losses {loss_err:.2e}, gradients "
                                     f"{failed} outside {STEP_GRAD_TOL}")
            for name in GLOO_KERNELS:
                if not got["launches"].get(name):
                    raise AssertionError(f"gloo rank {r}: {name} not "
                                         f"launched")
            launches.update(got["launches"])
            out[f"rank{r}_repeats{repeats}"] = {
                "loss_rel_err": loss_err, **errs, "ms_per_step": got["ms"],
                "launches": got["launches"]}
            log(f"  gloo rank {r}, {repeats} D repeat(s): losses within "
                f"{loss_err:.2e}; gradients within {grad_err:.2e} of a "
                f"tensor's largest element; updates within "
                f"{errs['update_err_over_total_norm']:.2e} of the update's "
                f"norm, {errs['update_err_over_norm']:.2e} of a tensor's "
                f"(tensor {errs['worst_tensor_index_and_size']}), of the "
                f"global-batch step (the same step with cuDNN's default "
                f"algorithms: "
                f"{floor[repeats]['update_err_over_total_norm']:.2e}, "
                f"{floor[repeats]['update_err_over_norm']:.2e}); "
                f"{', '.join(f'{t:.1f}' for t in got['ms'])} ms a step "
                f"(one process, the global batch: "
                f"{', '.join(f'{t:.1f}' for t in want['ms'])} ms)")
        out[f"cudnn_default_vs_deterministic_repeats{repeats}"] = \
            floor[repeats]
        a, b = (r_[repeats]["after"] for r_ in ranks)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{repeats} D repeat(s): the two ranks' "
                                 f"parameters differ")
        out[f"single_process_ms_repeats{repeats}"] = want["ms"]
    log(f"  both ranks' parameters bit-equal after each step; ranks' wall "
        f"{out['ranks_wall_s']:.1f} s (spawn and build included)")
    return out, dict(launches)


def dp_cli_argv(root, total_kimg, *extra):
    """Phase C's run: phase 9's at 8 items."""
    argv = cli_argv(root, total_kimg, *extra)
    argv[argv.index("--SyntheticDataset.num_items") + 1] = "8"
    return argv


def cli_rank(outfile: str, saved: str, argv) -> int:
    """Phase C's resumed run as a torchrun rank (``chip_smoke.py
    --cli-rank OUT SAVED ARGV...``): ``cli.train``'s entry point, its
    state held against the training state SAVED once built (parameters,
    both Adams, this rank's generator and the clock, bit for bit), then
    the kernel wrapper's launches and, per graph, its replays and the
    kernels they ran, into OUT."""
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.cli import train as cli
    from pggan_tpu_torch.ops import _build
    build = cli.build

    def held_build(params):
        trainer, logger, total = build(params)
        sd, nimg, iterations, _ = checkpoint.load_training_state(saved)
        got = checkpoint.training_state_dict(trainer.state)
        want = {k: sd[k] for k in got}
        want["generator"] = sd["rank_generators"][trainer.builder.group.rank]
        if not compare_state(got, want) or (
                trainer.cur_nimg, trainer.iterations) != (nimg, iterations):
            raise AssertionError("the resumed state differs from the saved "
                                 "one")
        return trainer, logger, total
    cli.build = held_build
    _build.LAUNCHES.clear()
    trainer = cli.cli_main(argv)
    launches = dict(_build.LAUNCHES)
    builder = trainer.builder
    replayed = replayed_kernels(builder)
    replays = [[*map(int, key[:2]), bool(key[2]), *map(int, key[3:]),
                step.replays] for key, step in builder.graphs().items()]
    with open(outfile, "w") as f:
        json.dump({"launches": launches, "replayed": dict(replayed),
                   "replays": replays, "cur_nimg": trainer.cur_nimg,
                   "world_size": builder.group.world_size}, f)
    return 0


def torchrun_phase(torch):
    """Phase C: ``cli.train`` under ``torchrun --standalone
    --nproc_per_node 1`` (NCCL) at the paper widths, depth 0 to 3: a run to
    DP_STOP (``-m pggan_tpu_torch.cli.train``), then its resume to
    DP_TOTAL through ``cli_rank`` (the resumed state held against the
    saved one, the launches and replays). Every step after a stage's first
    is a replay; metrics.jsonl counts the global kimg."""
    import glob
    from pggan_tpu_torch import checkpoint
    here = os.path.dirname(os.path.abspath(__file__))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        def launch(tag, entry, total, *extra):
            t0 = time.perf_counter()
            res = subprocess.run([*torchrun, *entry,
                                  *dp_cli_argv(root, total, *extra)],
                                 cwd=here, capture_output=True, text=True,
                                 timeout=600)
            out[f"{tag}_s"] = time.perf_counter() - t0
            if res.returncode != 0:
                log(res.stdout[-3000:] + res.stderr[-4000:])
                raise AssertionError(f"torchrun {tag} exited "
                                     f"{res.returncode}")
            if "Data-parallel over 1 rank(s) (nccl)" not in res.stdout:
                raise AssertionError(f"{tag}: not the data-parallel path")
            log(f"  {tag}: {out[f'{tag}_s']:.1f} s")
            return res.stdout

        def runs():
            return sorted(glob.glob(os.path.join(root, "0*-*")))

        text = launch("first", ["-m", "pggan_tpu_torch.cli.train"], DP_STOP)
        first_keys = captured_keys(text)[0]
        steps1, stop1 = planned_dispatches(0, DP_STOP)
        if first_keys != {k for k, n in steps1.items() if n >= 2}:
            raise AssertionError(f"first run: graphs {sorted(first_keys)}, "
                                 f"steps {dict(steps1)}")
        run1, = runs()
        state1, = glob.glob(os.path.join(run1, "training-state-*.dat"))
        _, nimg, _, _ = checkpoint.load_training_state(state1)
        rows = [json.loads(ln) for ln in open(os.path.join(run1,
                                                           "metrics.jsonl"))]
        if nimg != stop1 or rows[-1]["kimg_stat"] != nimg / 1000:
            raise AssertionError(f"first run: {nimg} images, schedule "
                                 f"{stop1}, last tick's kimg "
                                 f"{rows[-1]['kimg_stat']}")
        report = os.path.join(root, "cli_rank.json")
        launch("resumed", [os.path.abspath(__file__), "--cli-rank", report,
                           state1], DP_TOTAL, "--resume_network", "latest")
        log(f"  resumed at {nimg} images: parameters, both Adams, the "
            f"rank's generator and the clock equal the saved state bit for "
            f"bit")
        with open(report) as f:
            rank = json.load(f)
        steps2, stop2 = planned_dispatches(nimg, DP_TOTAL)
        want = sorted([*key, n - 1] for key, n in steps2.items() if n >= 2)
        if sorted(rank["replays"]) != want or rank["cur_nimg"] != stop2:
            raise AssertionError(f"resumed run: replays {rank['replays']}, "
                                 f"schedule {want}; {rank['cur_nimg']} "
                                 f"images, schedule {stop2}")
        run2, = [d for d in runs() if d != run1]
        rows = [json.loads(ln) for ln in open(os.path.join(run2,
                                                           "metrics.jsonl"))]
        if rows[-1]["kimg_stat"] != stop2 / 1000:
            raise AssertionError(f"resumed run: kimg {rows[-1]}")
    for name in DP_CLI_KERNELS:
        if not rank["launches"].get(name) or not rank["replayed"].get(name):
            raise AssertionError(f"{name} was never launched by the torchrun "
                                 f"run, or never replayed")
    log(f"  every step after a stage's first replayed ({rank['replays']}); "
        f"launches {rank['launches']}, kernels in the replays "
        f"{rank['replayed']}")
    out.update({"first_run_graphs": sorted(map(str, first_keys)),
                "resumed_replays": rank["replays"],
                "launches_eager": rank["launches"],
                "kernels_run_in_replays": rank["replayed"]})
    return out, rank["launches"], rank["replayed"]


def replicas_phase(torch):
    """Phase D: ``sample_images`` over two replicas of G on the one card
    (``devices=["cuda:0", "cuda:0"]``), depth 8, chunks of BATCH, chain on
    and off, against the one-device serve (the served-images bar) with
    exact launch counts; img/s of both from warm calls in turns."""
    import numpy as np
    from pggan_tpu_torch.models.generator import Generator
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.sampling import sample_images
    G = Generator((1, 3, 1024, 1024),
                  generator=torch.Generator().manual_seed(SEED)).cuda()
    two = ["cuda:0", "cuda:0"]
    chunks = -(-DP_SAMPLES // BATCH)
    out, launches = {}, collections.Counter()
    for chain in (True, False):
        G.inference_chain = chain
        conv = "conv3x3_chain_pn" if chain else "conv3x3_act_pn"

        def run(devices, n=DP_SAMPLES):
            imgs = sample_images(G, 8, 1.0, n, minibatch=BATCH,
                                 rng=np.random.RandomState(SEED),
                                 devices=devices)
            torch.cuda.synchronize()
            return imgs
        _build.LAUNCHES.clear()
        got = run(two)
        counts = dict(_build.LAUNCHES)
        fwd = 2 * chunks  # a forward on each replica a chunk
        expect = {conv: (3 if chain else 6) * fwd, "upsample2x": 3 * fwd,
                  "wide_conv": WIDE_PER_FORWARD * fwd}
        if counts != expect:
            raise AssertionError(f"two replicas, chain {chain}: launches "
                                 f"{counts}, expected {expect}")
        launches.update(counts)
        want = run(None)
        if got.shape != (DP_SAMPLES, 1024, 1024, 3):
            raise AssertionError(f"two replicas: {got.shape}")
        err = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, **NET_TOL,
                                   err_msg=f"two replicas, chain {chain}")
        rates = {"one": [], "two": []}
        for devices in (None, two, two, None):
            t0 = time.perf_counter()
            run(devices)
            rates["one" if devices is None else "two"].append(
                DP_SAMPLES / (time.perf_counter() - t0))
        tag = "chain" if chain else "chain_off"
        out[tag] = {"max_abs_err": err, "img_per_s_one": rates["one"],
                    "img_per_s_two_replicas": rates["two"],
                    "launches": counts}
        log(f"  chain {'on' if chain else 'off'}: two replicas against one "
            f"device, max abs err {err:.2e} (bar {NET_TOL}); launches "
            f"{counts}; img/s one device "
            f"{', '.join(f'{r:.1f}' for r in rates['one'])}, two replicas "
            f"{', '.join(f'{r:.1f}' for r in rates['two'])}")
    del G
    torch.cuda.empty_cache()
    return out, dict(launches)


# Grouped dispatch (phase E), at the paper configuration: a group of GROUP
# steps (one graph replay) against GROUP single-step replays from one state
# at depth 8, in a fade window with a ramping lr and in a stable one; then
# the step time through the Trainer at depths 0, 2 and 4 (batch 16) and 8
# (batch 3) with 1 and GROUP steps a dispatch, in turns; each key's
# eager first call and capture; the pinned bytes held in flight
GROUP = 8  # the trainer's default steps_per_dispatch
GROUP_ALPHAS = [0.30 + 0.02 * k for k in range(GROUP)]  # a fade window
GROUP_LRS = ([1e-3 * (0.6 + 0.05 * k) for k in range(GROUP)],
             [1e-3 * (0.3 + 0.05 * k) for k in range(GROUP)])
GROUP_RUNS = ((0, 16), (2, 16), (4, 16), (TRAIN_DEPTH, TRAIN_BATCH))
GROUP_TIMED = 16  # steps timed a turn (two turns a mode), after the warm-up
METRICS = ("G_loss", "D_loss", "D_real", "D_fake")


def stage_cost(torch, call, step) -> dict:
    """A key's first two calls: the eager first call's seconds, the
    capture's (``step().capture_s``: ``step`` gives the key's graphed
    step once it exists) and the second call's whole, and the peak device
    memory over both."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"eager_s": times[0], "capture_s": step().capture_s,
            "second_call_s": times[1],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def group_exactness(torch):
    """One group replay of GROUP steps against GROUP single-step replays
    from one warm state, with cuDNN held to its deterministic algorithms:
    depth 8, batch 3, in a fade window (GROUP_ALPHAS) with a ramping lr
    (GROUP_LRS), then in a stable one. The group gets the single steps'
    reals stacked, so only the dispatch differs. Returns, per window, the
    metrics' and updates' agreement (``update_errors``) and each key's
    stage-change cost (``stage_cost``)."""
    import numpy as np
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    models = [paper_models(torch, "cuda") for _ in range(2)]
    states = [init_state(G, D, seed=SEED) for G, D in models]
    single, grouped = (TrainStepBuilder(G, D) for G, D in models)
    prep = single.prep_fn()
    u8 = [uint8_reals(torch, single, TRAIN_DEPTH, SEED + 30 + k).cuda()
          for k in range(GROUP)]
    params = [[*G.parameters(), *D.parameters()] for G, D in models]
    out = {"stage_change": {}}
    torch.backends.cudnn.deterministic = True
    try:
        for fade in (True, False):  # each key's eager call and capture
            a = np.float32(0.5 if fade else 1.0)
            reals = [prep(x, a) for x in u8]
            step = single.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
            gstep = grouped.group_step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade,
                                          GROUP)
            ones = np.ones(GROUP, np.float32)
            out["stage_change"][str((TRAIN_DEPTH, TRAIN_BATCH, fade))] = \
                stage_cost(torch, lambda: step(states[0], reals[0], a, LR,
                                               LR), lambda: step)
            out["stage_change"][str((TRAIN_DEPTH, TRAIN_BATCH, fade,
                                     GROUP))] = stage_cost(
                torch, lambda: gstep(states[1], torch.stack(reals), a * ones,
                                     LR * ones, LR * ones), lambda: gstep)
        for fade in (True, False):
            alphas = np.asarray(GROUP_ALPHAS if fade else [1.0] * GROUP,
                                np.float32)
            lrs_d, lrs_g = (np.asarray(v, np.float32) for v in GROUP_LRS)
            reals = [prep(x, a) for x, a in zip(u8, alphas)]
            checkpoint.restore_training_state(
                states[1], checkpoint.training_state_dict(states[0]))
            before = [p.detach().clone() for p in params[0]]
            step = single.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
            per = []
            for k in range(GROUP):
                m = step(states[0], reals[k], alphas[k], lrs_d[k], lrs_g[k])
                per.append(torch.stack([m[n] for n in METRICS]))
            per = torch.stack(per)
            m = grouped.group_step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade, GROUP)(
                states[1], torch.stack(reals), alphas, lrs_d, lrs_g)
            got = torch.stack([m[n] for n in METRICS], 1)
            if not torch.equal(states[0].generator.get_state(),
                               states[1].generator.get_state()):
                raise AssertionError("the group left another generator "
                                     "state than its single steps")
            metric_err = float(((got - per).abs()
                                / per.abs().clamp_min(1e-30)).max())
            res = {"metrics_bitwise": bool(torch.equal(got, per)),
                   "metric_rel_err": metric_err,
                   **update_errors(torch, before, params[1], params[0])}
            window = "fade" if fade else "stable"
            out[window] = res
            log(f"  {window} window: a group replay of {GROUP} against "
                f"{GROUP} single replays from one state: metrics "
                + ("bit for bit" if res["metrics_bitwise"] else
                   f"within {metric_err:.2e}") + "; updates of "
                f"{res['tensors_moved']} tensors "
                + ("bit for bit" if res["params_bitwise"] else
                   f"apart by up to {res['update_err_over_norm']:.2e} of a "
                   f"tensor's norm"))
            if metric_err > STEP_LOSS_RTOL or \
                    res["update_err_over_norm"] > UPDATE_TOL:
                raise AssertionError(f"{window} group against its steps: "
                                     f"{res}")
    finally:
        torch.backends.cudnn.deterministic = False
    for key, c in out["stage_change"].items():
        log(f"  stage change {key}: eager first call {c['eager_s']:.3f} s, "
            f"capture {c['capture_s']:.3f} s (second call "
            f"{c['second_call_s']:.3f} s), peak "
            f"{c['peak_bytes'] / 2**30:.2f} GiB")
    out["replayed"] = replayed_kernels(single) + replayed_kernels(grouped)
    del models, states, single, grouped, params, before, u8, reals
    torch.cuda.empty_cache()
    return out


def stable_trainer(torch, state, builder, dataset, depth, batch, spd):
    """A ``Trainer`` on ``state`` and ``builder`` in the terminal stable
    phase of a schedule that ends at ``depth`` (alpha 1 from then on, no
    tick in sight), with the CLI's plugins that steer a step: the
    DepthManager (a uint8 ``DataIterator`` at ``batch``), the lr schedule
    and the loss monitors."""
    from pggan_tpu_torch.data.loader import DataIterator
    from pggan_tpu_torch.training.plugins import (DepthManager,
                                                  EfficientLossMonitor,
                                                  LRScheduler)
    from pggan_tpu_torch.training.trainer import Trainer
    lod = 1000
    trainer = Trainer(state.G, state.D, builder, state, dataset, None, None,
                      resume_nimg=2 * lod * depth, steps_per_dispatch=spd)
    trainer.register_plugin(DepthManager(
        lambda bs: DataIterator(dataset, bs, num_workers=4, seed=SEED,
                                raw=True),
        None, depth, minibatch_default=batch, minibatch_overrides={},
        tick_kimg_default=10 ** 6, lod_training_nimg=lod,
        lod_transition_nimg=lod))
    trainer.register_plugin(LRScheduler(LR, LR, rampup_kimg=0))
    for i, name in enumerate(METRICS):
        trainer.register_plugin(EfficientLossMonitor(i, name))
    return trainer


def run_steps(trainer, n: int) -> int:
    """``trainer.train()`` until ``n`` more steps ran; the steps run."""
    start = trainer.iterations
    while trainer.iterations - start < n:
        trainer.train()
    return trainer.iterations - start


def group_timing(torch):
    """The step time through the ``Trainer`` at each of GROUP_RUNS, with 1
    and GROUP steps a dispatch on one state and one builder, in turns (1,
    GROUP, GROUP, 1) of GROUP_TIMED steps after each mode's warm-up and
    capture: host ms a step (synchronised at both ends; 32 steps a mode),
    kernel wrapper launches a step, and a profiled window of GROUP steps
    (host launches a step, the device's busy share). Each key's
    stage-change cost. At depth 8 the most pinned bytes in flight at the
    default budget and, over 32 steps, at a budget of two grouped
    dispatches."""
    from pggan_tpu_torch.data.datasets import SyntheticDataset
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    from pggan_tpu_torch.utils.profiling import capture, device_profile
    G, D = paper_models(torch, "cuda")
    state = init_state(G, D, seed=SEED)
    builder = TrainStepBuilder(G, D)
    res = G.dataset_shape[-1]
    dataset = SyntheticDataset(resolution=res, num_items=8, seed=SEED)
    out = {}
    for depth, batch in GROUP_RUNS:
        t_depth = time.perf_counter()
        trainers = {spd: stable_trainer(torch, state, builder, dataset,
                                        depth, batch, spd)
                    for spd in (1, GROUP)}
        row = {"batch": batch, "stage_change": {}}
        try:
            for spd, t in trainers.items():
                key = (depth, batch, False) + ((GROUP,) if spd > 1 else ())
                row["stage_change"][str(key)] = stage_cost(
                    torch, t.train, lambda key=key: builder._steps[key])
            times, wrapper = {1: [], GROUP: []}, {1: 0, GROUP: 0}
            turns = {1: [], GROUP: []}
            for spd in (1, GROUP, GROUP, 1):
                t = trainers[spd]
                t.inflight_peak_bytes = 0
                before = sum(_build.LAUNCHES.values())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = run_steps(t, GROUP_TIMED)
                torch.cuda.synchronize()
                times[spd].append((time.perf_counter() - t0) * 1e3 / n)
                turns[spd].append(n)
                wrapper[spd] += sum(_build.LAUNCHES.values()) - before
            if any(wrapper.values()):
                raise AssertionError(f"depth {depth}: replayed dispatches "
                                     f"called kernel wrappers {wrapper}")
            for spd, t in trainers.items():
                prof, wall_ms = capture(lambda t=t: run_steps(t, GROUP))
                p = device_profile(prof, wall_ms, GROUP,
                                   f"depth {depth}, {spd} step(s) a "
                                   f"dispatch, profiled", "step", log=log)
                row[f"spd{spd}"] = {
                    "ms_per_step": sum(map(lambda m, n: m * n, times[spd],
                                           turns[spd])) / sum(turns[spd]),
                    "ms_per_step_turns": times[spd],
                    "kernel_wrapper_launches_per_step":
                        wrapper[spd] / sum(turns[spd]),
                    "host_launches_per_step": p["host_launches_per_step"],
                    "device_busy_share": p["device_busy_share"],
                    "device_busy_ms_per_step": p["device_busy_ms_per_step"],
                    "wall_ms_per_step_profiled": p["wall_ms_per_step"],
                    "inflight_peak_bytes": t.inflight_peak_bytes}
            log(f"  depth {depth}, batch {batch}: ms a step, 1 / {GROUP} "
                f"a dispatch (turns 1, {GROUP}, {GROUP}, 1): "
                f"{', '.join(f'{x:.2f}' for x in times[1])} / "
                f"{', '.join(f'{x:.2f}' for x in times[GROUP])}; host "
                f"launches a step {row['spd1']['host_launches_per_step']:.1f}"
                f" / {row[f'spd{GROUP}']['host_launches_per_step']:.1f}; "
                f"busy {row['spd1']['device_busy_share']:.1%} / "
                f"{row[f'spd{GROUP}']['device_busy_share']:.1%}")
            if depth == TRAIN_DEPTH:
                t = trainers[GROUP]
                per_dispatch = GROUP * batch * res * res * 3
                row["budget_default_mb"] = t.inflight_budget_mb
                row["dispatch_bytes"] = per_dispatch
                t.inflight_budget_mb = -(-2 * per_dispatch // 2**20)
                t.inflight_peak_bytes = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = run_steps(t, 2 * GROUP_TIMED)
                torch.cuda.synchronize()
                row["budget_two_dispatches"] = {
                    "budget_mb": t.inflight_budget_mb,
                    "inflight_peak_bytes": t.inflight_peak_bytes,
                    "ms_per_step": (time.perf_counter() - t0) * 1e3 / n}
                log(f"  pinned bytes in flight at most: "
                    f"{row[f'spd{GROUP}']['inflight_peak_bytes']} at the "
                    f"default budget {row['budget_default_mb']} MiB; "
                    f"{t.inflight_peak_bytes} at {t.inflight_budget_mb} MiB "
                    f"(two dispatches of {per_dispatch} B), "
                    f"{row['budget_two_dispatches']['ms_per_step']:.2f} ms "
                    f"a step")
                if t.inflight_peak_bytes > (t.inflight_budget_mb * 2**20
                                            + per_dispatch):
                    raise AssertionError("the budget did not bound the "
                                         "bytes in flight")
        finally:
            for t in trainers.values():
                t.dataiter.close()
        for key, c in row["stage_change"].items():
            log(f"  stage change {key}: eager first call "
                f"{c['eager_s']:.3f} s, capture {c['capture_s']:.3f} s, "
                f"peak {c['peak_bytes'] / 2**30:.2f} GiB")
        row["depth_s"] = time.perf_counter() - t_depth
        log(f"  depth {depth} took {row['depth_s']:.1f} s")
        out[f"depth{depth}"] = row
    out["replayed"] = replayed_kernels(builder)
    dataset.close()
    del G, D, state, builder, trainers
    torch.cuda.empty_cache()
    return out


def group_phase(torch):
    """Phase E: ``group_exactness`` and ``group_timing``. Returns the
    numbers, the kernel wrappers' launches (each key's eager first call)
    and the kernels the graph replays ran."""
    from pggan_tpu_torch.ops import _build
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = {"exactness_depth8": group_exactness(torch)}
    out["exactness_s"] = time.perf_counter() - t0
    log(f"  exactness took {out['exactness_s']:.1f} s")
    out["timing"] = group_timing(torch)
    replayed = out["exactness_depth8"].pop("replayed") + \
        out["timing"].pop("replayed")
    launches = dict(_build.LAUNCHES)
    out.update(launches_eager=launches, kernels_run_in_replays=dict(replayed),
               phase_s=time.perf_counter() - t0)
    for name in TRAIN_KERNELS:
        if not launches.get(name) or not replayed.get(name):
            raise AssertionError(f"{name} was never launched by phase E, or "
                                 f"never replayed")
    return out, launches, dict(replayed)


# phase F: (name, first depth, last depth, per-depth batches, images a
# stage); every stage is long enough for one group of GROUP and some
# single steps (the batch 14 stage at depth 6 for single steps only)
PRECOMPILE_STRETCHES = (("low", 0, 2, {}, 10 * 16),
                        ("dear", 6, TRAIN_DEPTH, {6: 14, 7: 6, 8: 3}, 66))


class KeyRecorder:
    """The step key of each of a trainer's dispatches, in order (its
    ``_await_precompile``, which every dispatch calls with its key,
    wrapped on the instance)."""

    def __init__(self, trainer):
        self.keys = []
        wait = trainer._await_precompile

        def record(key):
            self.keys.append(key)
            wait(key)
        trainer._await_precompile = record


def progressive_trainer(torch, state, builder, dataset, stretch, precompile,
                        steps_per_dispatch=GROUP):
    """A ``Trainer`` on ``state`` at the start of a stretch of
    PRECOMPILE_STRETCHES, ``steps_per_dispatch`` steps a dispatch where the
    schedule holds,
    with the DepthManager (uint8 batches of one item, so that every run
    sees the same data; ``precompile_ahead`` as given), the lr schedule
    and a plugin that keeps every dispatch's metrics."""
    from pggan_tpu_torch.data.loader import DataIterator
    from pggan_tpu_torch.training.plugins import (DepthManager, LRScheduler,
                                                  Plugin)
    from pggan_tpu_torch.training.trainer import Trainer
    _, first, last, batches, lod = stretch
    start = max(0, 2 * first * lod)  # the first depth's stable stage
    trainer = Trainer(state.G, state.D, builder, state, dataset, None, None,
                      resume_nimg=start, tick_nimg_default=10 ** 9,
                      steps_per_dispatch=steps_per_dispatch)
    rows = []

    class Keep(Plugin):
        def iteration(self, idx, *losses):
            rows.append(torch.stack([torch.as_tensor(v).reshape(-1)
                                     for v in losses]).clone())
    trainer.register_plugin(DepthManager(
        lambda bs: DataIterator(dataset, bs, num_workers=1, seed=SEED,
                                raw=True),
        None, TRAIN_DEPTH, minibatch_default=16, minibatch_overrides=batches,
        tick_kimg_default=10 ** 6, lod_training_nimg=lod,
        lod_transition_nimg=lod, precompile_ahead=precompile))
    trainer.register_plugin(LRScheduler(LR, LR, rampup_kimg=0))
    trainer.register_plugin(Keep([(1, "iteration")]))
    trainer.total_nimg = (2 * last + 1) * lod  # the last depth's stable end
    return trainer, rows


class InlineExecutor:
    """An executor for a builder's precompiles that runs each on the
    calling thread, the training thread, when it is queued."""

    def submit(self, fn, *args, **kwargs):
        import concurrent.futures
        future = concurrent.futures.Future()
        try:
            future.set_result(fn(*args, **kwargs))
        except Exception as e:  # raised at the key's dispatch
            future.set_exception(e)
        return future

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def precompile_run(torch, stretch, start_sd, precompile, inline=False,
                   steps_per_dispatch=GROUP):
    """One run of a stretch from the state ``start_sd`` (None: a fresh
    state from SEED, whose dict the result keeps), the precompiles on the
    builder's thread, or with ``inline`` on the training thread: each
    dispatch's key, steps, host seconds, device ms (CUDA events around it
    on the training stream) and whether a precompile was queued or running
    during it (``steps_per_dispatch`` where the schedule holds); the final
    state, the metrics, the peak device memory, the
    kernel wrappers' launches in the foreground and on the warm-up stream,
    and each key's graphed step."""
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.data.datasets import SyntheticDataset
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, "cuda")
    state = init_state(G, D, seed=SEED)
    if start_sd is None:
        start_sd = checkpoint.training_state_dict(state)
    checkpoint.restore_training_state(state, start_sd)
    params = [*G.parameters(), *D.parameters()]
    before = [p.detach().clone() for p in params]
    builder = TrainStepBuilder(G, D)
    if inline:
        builder._worker = InlineExecutor()
    dataset = SyntheticDataset(resolution=G.dataset_shape[-1], num_items=1,
                               seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    launches = sum(_build.LAUNCHES.values())
    t0 = time.perf_counter()
    trainer, metrics = progressive_trainer(torch, state, builder, dataset,
                                           stretch, precompile,
                                           steps_per_dispatch)
    keys = KeyRecorder(trainer)
    dispatches = []

    def alive():
        return any(not f.done() for f in builder._precompiles.values())
    try:
        while trainer.cur_nimg < trainer.total_nimg:
            was_alive, n = alive(), trainer.iterations
            events = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            events[0].record()
            t1 = time.perf_counter()
            trainer.train()
            host_s = time.perf_counter() - t1
            events[1].record()
            dispatches.append({"key": keys.keys[-1],
                               "steps": trainer.iterations - n,
                               "host_s": host_s, "events": events,
                               "overlap": was_alive or alive()})
        builder.join_precompiles()
        torch.cuda.synchronize()
    finally:
        trainer.dataiter.close()
        dataset.close()
    for d in dispatches:
        a, b = d.pop("events")
        d["device_ms"] = a.elapsed_time(b)
    return {"start_sd": start_sd, "state": state,
            "before": before, "params": params,
            "builder": builder, "metrics": metrics,
            "dispatches": dispatches, "run_s": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated() - resident,
            "foreground_launches": sum(_build.LAUNCHES.values()) - launches,
            "warm_launches": collections.Counter(builder.precompile_launches)}


def precompile_compare(torch, off, on) -> dict:
    """On against off over one stretch: the same dispatches; whether the
    final states (every tensor, the generator) and every dispatch's
    metrics are equal bit for bit; the first step whose metrics differ,
    with the largest relative difference of its metrics (rounding, or
    more) and the largest over the stretch; the parameter updates over the
    stretch (``update_errors``). On the precompiled run no eager step in
    the foreground (no kernel wrapper launched there, no eager first call
    at a key) and every dispatched key replayed from its first
    dispatch."""
    if [d["key"] for d in on["dispatches"]] != \
            [d["key"] for d in off["dispatches"]]:
        raise AssertionError("the runs dispatched other keys")
    a, b = on["state"], off["state"]
    bitwise = all(torch.equal(x, y) for x, y in zip(a.tensors(),
                                                    b.tensors()))
    gen = torch.equal(a.generator.get_state(), b.generator.get_state())
    got, want = (torch.cat(r["metrics"], 1) for r in (on, off))
    metrics_bitwise = bool(torch.equal(got, want))
    differ = (got != want).any(0).nonzero().flatten().tolist()
    first_rel = None
    if differ:
        k = differ[0]
        first_rel = float(((got[:, k] - want[:, k]).abs()
                           / want[:, k].abs().clamp_min(1e-30)).max())
    with torch.no_grad():
        errs = update_errors(torch, off["before"], on["params"],
                             off["params"])
    dispatched = collections.Counter(d["key"] for d in on["dispatches"])
    steps = on["builder"]._steps
    for key, n in dispatched.items():
        step = steps[key]
        if not step.ahead or step.eager_s is not None or step.replays != n:
            raise AssertionError(f"{key}: ahead {step.ahead}, foreground "
                                 f"eager {step.eager_s}, {step.replays} "
                                 f"replays of {n} dispatches")
        if off["builder"]._steps[key].eager_s is None:
            raise AssertionError(f"{key}: no eager first call without the "
                                 f"precompile")
    if on["foreground_launches"]:
        raise AssertionError(f"the precompiled run launched "
                             f"{on['foreground_launches']} kernel wrappers "
                             f"in the foreground")
    return {"state_bitwise": bitwise and gen, "generator_equal": gen,
            "metrics_bitwise": metrics_bitwise, "steps": got.shape[1],
            "first_step_metrics_differ": differ[0] if differ else None,
            "steps_metrics_differ": len(differ),
            "first_differing_step_metric_rel_diff": first_rel,
            "metric_max_abs_diff": float((got - want).abs().max()),
            **errs, "dispatched_keys": len(dispatched)}


def exact(row) -> bool:
    return row["state_bitwise"] and row["metrics_bitwise"]


def card_memory(torch) -> dict:
    free, total = torch.cuda.mem_get_info()
    return {"free_bytes": free, "total_bytes": total,
            "reserved_bytes": torch.cuda.memory_reserved(),
            "allocated_bytes": torch.cuda.memory_allocated()}


def release(torch) -> None:
    """Free the graphs and tensors no longer reachable, their reference
    cycles included, and return the allocator's cache to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def precompile_stretch(torch, stretch) -> tuple:
    """Phase F on one stretch: off, then on, from one state; where they
    part, the stretch again with the precompiles on the training thread,
    and off and on with cuDNN off, held to PRECOMPILE_BAR. Returns the
    row, the warm-ups' launches and the kernels the precompiled graphs'
    replays ran."""
    off = precompile_run(torch, stretch, None, False)
    start_sd = off["start_sd"]
    on = precompile_run(torch, stretch, start_sd, True)
    row = {**precompile_compare(torch, off, on), **precompile_timing(off, on)}
    warm, replayed = on["warm_launches"], replayed_kernels(on["builder"])
    del on
    release(torch)
    if not exact(row):
        inline = precompile_run(torch, stretch, start_sd, True, inline=True)
        row["training_thread"] = precompile_compare(torch, off, inline)
        del inline
    del off
    release(torch)
    if not exact(row):
        # single steps: with cuDNN off a group's graph failed to
        # instantiate on the card (out of memory)
        with torch.backends.cudnn.flags(enabled=False, deterministic=True,
                                        allow_tf32=False):
            runs = [precompile_run(torch, stretch, start_sd, p,
                                   steps_per_dispatch=1)
                    for p in (False, True)]
            row["cudnn_off"] = precompile_compare(torch, *runs)
            row["cudnn_off"]["run_s"] = {"off": runs[0]["run_s"],
                                         "on": runs[1]["run_s"]}
        del runs
        release(torch)
        rel = row["first_differing_step_metric_rel_diff"]
        held = (row["generator_equal"]
                and row["update_err_over_total_norm"] <= UPDATE_TOL
                and rel is not None and rel <= STEP_LOSS_RTOL
                and exact(row["training_thread"]) and exact(row["cudnn_off"]))
        if not held:
            raise AssertionError(f"precompile on against off, not bit for "
                                 f"bit and outside the bar "
                                 f"({PRECOMPILE_BAR}): {row}")
    return row, warm, replayed


def precompile_timing(off, on) -> dict:
    """Per key: the precompile's background warm-up and capture seconds,
    and the foreground host seconds of its first two dispatches, on and
    off; the device ms a step of the dispatches during which a
    precompile thread was alive (the first two at a key left out in both
    runs), on against the same dispatches off; the peak memory."""
    seen, fore = collections.Counter(), {}
    overlap = {"steps": 0, "on_ms": 0.0, "off_ms": 0.0, "dispatches": 0}
    for d_on, d_off in zip(on["dispatches"], off["dispatches"]):
        key = str(d_on["key"])
        seen[key] += 1
        if seen[key] <= 2:
            fore.setdefault(key, {"on_s": [], "off_s": []})
            fore[key]["on_s"].append(d_on["host_s"])
            fore[key]["off_s"].append(d_off["host_s"])
        elif d_on["overlap"]:
            overlap["dispatches"] += 1
            overlap["steps"] += d_on["steps"]
            overlap["on_ms"] += d_on["device_ms"]
            overlap["off_ms"] += d_off["device_ms"]
    if overlap["steps"]:
        overlap["on_ms_per_step"] = overlap["on_ms"] / overlap["steps"]
        overlap["off_ms_per_step"] = overlap["off_ms"] / overlap["steps"]
    background = {str(k): {"warm_s": s.warm_s, "capture_s": s.capture_s}
                  for k, s in sorted(on["builder"]._steps.items())
                  if getattr(s, "ahead", False)}
    return {"background": background, "first_dispatches": fore,
            "overlap": overlap,
            "peak_bytes": {"on": on["peak_bytes"], "off": off["peak_bytes"]},
            "run_s": {"on": on["run_s"], "off": off["run_s"]}}


def precompile_nccl(torch) -> dict:
    """Phase F under phase A's one-rank NCCL group (a ``FileStore``), depth
    8, batch 3, fade, cuDNN deterministic: three calls of the step from
    one state without a precompile (eager, capture + replay, replay) and
    with one (``precompile_ahead``: the warm-up in the background, of the
    rank's batch alone, without a collective; the capture at the first
    call on this thread, then replays). The states, generator and metrics
    are held to each other as in ``precompile_compare``, and no
    collective is called off this thread."""
    import threading

    import torch.distributed as dist
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.parallel import Group
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)
    key = (TRAIN_DEPTH, TRAIN_BATCH, True)
    runs, start_sd, out = {}, None, {}
    try:
        group = Group.current(torch.device("cuda", 0))
        for precompile in (False, True):
            G, D = paper_models(torch, "cuda")
            state = init_state(G, D, seed=SEED, group=group)
            if start_sd is None:
                start_sd = checkpoint.training_state_dict(state)
            checkpoint.restore_training_state(state, start_sd)
            params = [*G.parameters(), *D.parameters()]
            before = [p.detach().clone() for p in params]
            builder = TrainStepBuilder(G, D, group=group)
            prep = builder.prep_fn()
            u8 = [uint8_reals(torch, builder, TRAIN_DEPTH, SEED + k).cuda()
                  for k in range(3)]
            if precompile:
                t0 = time.perf_counter()
                elsewhere, all_reduce = [], dist.all_reduce

                def spy(*args, **kwargs):
                    if threading.current_thread() is not \
                            threading.main_thread():
                        elsewhere.append(threading.current_thread().name)
                    return all_reduce(*args, **kwargs)
                dist.all_reduce = spy
                try:
                    builder.precompile_ahead([key + (None,)], state)
                    builder.await_precompile(key)
                finally:
                    dist.all_reduce = all_reduce
                out["precompile_wait_s"] = time.perf_counter() - t0
                out["collectives_off_the_training_thread"] = len(elsewhere)
                if elsewhere or builder._steps[key].graph is not None:
                    raise AssertionError(f"collectives off the training "
                                         f"thread {elsewhere}, or a capture "
                                         f"ahead under a process group")
            step = builder.step_fn(*key)
            metrics, host = [], []
            launches = sum(_build.LAUNCHES.values())
            for x in u8:
                t0 = time.perf_counter()
                m = step(state, prep(x, 0.5), 0.5, LR, LR)
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)
                metrics.append(torch.stack([m[n] for n in METRICS]).clone())
            runs[precompile] = {"state": state,
                                "before": before, "params": params,
                                "metrics": [torch.stack(metrics, 1)],
                                "builder": builder,
                                "dispatches": [{"key": key}] * 3,
                                "foreground_launches":
                                    sum(_build.LAUNCHES.values()) - launches}
            out["on" if precompile else "off"] = {
                "host_s": host, "eager_s": step.eager_s,
                "warm_s": step.warm_s, "capture_s": step.capture_s,
                "replays": step.replays}
        out.update(precompile_compare(torch, runs[False], runs[True]))
        if not out["generator_equal"] or not exact(out) and \
                out["update_err_over_total_norm"] > UPDATE_TOL:
            raise AssertionError(f"precompile on against off under the "
                                 f"NCCL group: {out}")
        replayed = replayed_kernels(runs[True]["builder"])
    finally:
        runs.clear()
        dist.destroy_process_group()
    log(f"  one-rank NCCL group, {key}: on against off "
        + ("bit for bit" if out["state_bitwise"] and out["metrics_bitwise"]
           else f"within {out['update_err_over_total_norm']:.2e} of the "
           f"update's norm")
        + f"; warm-up without a collective "
        f"{out['on']['warm_s']:.3f} s in the background, capture at the "
        f"first call {out['on']['capture_s']:.3f} s; first calls on "
        f"{', '.join(f'{x:.3f}' for x in out['on']['host_s'])} s, off "
        f"{', '.join(f'{x:.3f}' for x in out['off']['host_s'])} s")
    return out, replayed


def precompile_phase(torch):
    """Phase F: each of PRECOMPILE_STRETCHES through the ``Trainer`` and
    ``DepthManager``, twice from one state with cuDNN's deterministic
    algorithms: ``precompile_ahead`` off, then on (``precompile_stretch``,
    ``precompile_timing``); then the one-rank NCCL check. Returns the
    numbers, the kernel wrappers' launches on the warm-up stream and the
    kernels the precompiled graphs' replays ran."""
    t0 = time.perf_counter()
    out = {"bar": PRECOMPILE_BAR, "memory_at_start": card_memory(torch)}
    # the earlier phases' builders, unreachable but held in reference
    # cycles (a builder and its graphed steps), keep their graph pools
    # until a collection: a real run holds one builder's graphs
    release(torch)
    out["memory_after_collection"] = card_memory(torch)
    for when, m in (("at the start", out["memory_at_start"]),
                    ("after collecting the earlier phases' unreachable "
                     "graphs", out["memory_after_collection"])):
        log(f"  {when}: {m['free_bytes'] / 2**30:.2f} of "
            f"{m['total_bytes'] / 2**30:.2f} GiB free on the card, "
            f"{m['reserved_bytes'] / 2**30:.2f} GiB reserved by this "
            f"process's allocator")
    warm, replayed = collections.Counter(), collections.Counter()
    torch.backends.cudnn.deterministic = True
    try:
        for stretch in PRECOMPILE_STRETCHES:
            name, first, last, batches, lod = stretch
            row, w, r = precompile_stretch(torch, stretch)
            row = {"depths": [first, last], "batches": batches,
                   "images_a_stage": lod, **row}
            warm += w
            replayed += r
            log_stretch(name, row)
            out[name] = row
        out["nccl_one_rank"], nccl_replayed = precompile_nccl(torch)
        replayed += nccl_replayed
    finally:
        torch.backends.cudnn.deterministic = False
    out["phase_s"] = time.perf_counter() - t0
    for kernel in TRAIN_KERNELS:
        if not warm.get(kernel) or not replayed.get(kernel):
            raise AssertionError(f"{kernel} was never launched by a "
                                 f"precompile's warm-up, or never replayed")
    return out, dict(warm), dict(replayed)


def log_stretch(name, row) -> None:
    """Phase F's lines for one stretch."""
    def parted(r):
        return ("bit for bit" if exact(r) else
                f"parted at step {r['first_step_metrics_differ']} of "
                f"{r['steps']} (metrics "
                f"{r['first_differing_step_metric_rel_diff']:.2e} apart "
                f"there, {r['steps_metrics_differ']} steps differ, "
                f"largest {r['metric_max_abs_diff']:.2e}; the update "
                f"{r['update_err_over_total_norm']:.2e} of its norm apart)"
                if r["first_step_metrics_differ"] is not None else
                f"metrics bit for bit, state not (the update "
                f"{r['update_err_over_total_norm']:.2e} of its norm apart)")
    first, last = row["depths"]
    log(f"  {name} stretch, depth {first} to {last}: on against off "
        f"{parted(row)}; {row['dispatched_keys']} keys, each replayed from "
        f"its first dispatch; run {row['run_s']['off']:.1f} / "
        f"{row['run_s']['on']:.1f} s off / on; peak "
        f"{row['peak_bytes']['off'] / 2**30:.2f} / "
        f"{row['peak_bytes']['on'] / 2**30:.2f} GiB")
    if "training_thread" in row:
        log(f"    precompiles on the training thread against off: "
            f"{parted(row['training_thread'])}; cuDNN off, on against off: "
            f"{parted(row['cudnn_off'])} (runs "
            f"{row['cudnn_off']['run_s']['off']:.1f} / "
            f"{row['cudnn_off']['run_s']['on']:.1f} s)")
    for key, f in row["first_dispatches"].items():
        bg = row["background"].get(key, {})
        log(f"    {key}: first dispatches off "
            f"{', '.join(f'{x:.3f}' for x in f['off_s'])} s, on "
            f"{', '.join(f'{x:.3f}' for x in f['on_s'])} s; in the "
            f"background warm-up {bg.get('warm_s') or 0:.3f} s, "
            f"capture {bg.get('capture_s') or 0:.3f} s")
    ov = row["overlap"]
    if ov["steps"]:
        log(f"    {ov['dispatches']} dispatches ({ov['steps']} steps) "
            f"beside a precompile: {ov['on_ms_per_step']:.2f} ms a "
            f"step, the same steps off {ov['off_ms_per_step']:.2f}")


# -- the wide-channel NCHW conv pair (phase W) ---------------------------------

def wide_conv_calls(torch):
    """Every call the route sends to the wide-channel kernels in one eager
    fade step of each ``WIDE_CELLS`` configuration and one ``WIDE_SERVE``
    forward: {label: {(kernel, pass, shapes): count}}, shapes those of the
    Functions' forward, x (N, C, H, W) and w (K, 3, 3, C) or gy (N, K, H,
    W)."""
    from pggan_tpu_torch.models import Discriminator, Generator
    from pggan_tpu_torch.ops import wide_conv as wc
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    calls = collections.defaultdict(collections.Counter)
    fwd, dw = wc._fwd, wc._dw
    at = [None]  # the label being recorded

    def fwd_logged(x, w, tag):
        calls[at[0]]["wide_conv", tag,
                     (tuple(x.shape), tuple(w.shape))] += 1
        return fwd(x, w, tag)

    def dw_logged(x, gy):
        calls[at[0]]["wide_conv_dw", "weight_grad",
                     (tuple(x.shape), tuple(gy.shape))] += 1
        return dw(x, gy)
    wc._fwd, wc._dw = fwd_logged, dw_logged
    try:
        for label, shape, depth, batch in WIDE_CELLS:
            at[0] = label
            G = Generator(shape, generator=torch.Generator().manual_seed(SEED))
            D = Discriminator(shape,
                              generator=torch.Generator().manual_seed(SEED))
            G, D = G.cuda(), D.cuda()
            state = init_state(G, D, seed=SEED)
            builder = TrainStepBuilder(G, D, cuda_graphs=False)
            u8 = torch.randint(0, 256, builder.real_batch_shape(depth, batch),
                               dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(SEED))
            builder.step_fn(depth, batch, True)(
                state, builder.prep_fn()(u8.cuda(), 0.5), 0.5, LR, LR)
            torch.cuda.synchronize()
            log(f"  {label}: {sum(calls[label].values())} wide conv calls")
            del G, D, state, builder
        label, shape, depth, batch = WIDE_SERVE
        at[0] = label
        G = Generator(shape, generator=torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            G.cuda()(torch.randn(batch, G.latent_size, device="cuda"), depth,
                     1.0, False)
        torch.cuda.synchronize()
        del G
    finally:
        wc._fwd, wc._dw = fwd, dw
    torch.cuda.empty_cache()
    return calls


def wide_conv_shapes(torch, calls) -> list:
    """Each distinct call of ``wide_conv_calls`` (merged over its labels):
    the kernel against its twin in float64 and cuDNN's float32 call against
    the same reference (each relative to the reference's largest element),
    two kernel calls bit for bit, and both timed back to back
    (``burst_ms``): the forward against ``F.conv2d``, an input-gradient
    call against ``convolution_backward``'s input gradient, the weight
    gradient against its weight gradient."""
    from pggan_tpu_torch.ops import wide_conv as wc
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (name, tag, (xs, other)), count in sorted(calls.items()):
        x = torch.randn(xs, device="cuda", generator=g)
        if name == "wide_conv":
            w = torch.randn(other, device="cuda", generator=g) / math.sqrt(
                9 * xs[1])
            kernel = lambda x=x, w=w: wc.wide_conv(x, w)  # noqa: E731
            ref = wc.wide_conv_plain(x.double(), w.double())
            w_oihw = w.permute(0, 3, 1, 2).contiguous()
            if tag == "input_grad":  # x is the output gradient here
                # the conv whose input gradient this is: w = flip_io(w0),
                # w0 as OIHW
                w0 = w.flip(1, 2).permute(3, 0, 1, 2).contiguous()
                x0 = torch.empty((xs[0], w0.shape[1], xs[2], xs[3]),
                                 device="cuda")
                lib = lambda x=x, x0=x0, w0=w0: \
                    torch.ops.aten.convolution_backward(  # noqa: E731
                        x, x0, w0, None, [1, 1], [1, 1], [1, 1], False,
                        [0, 0], 1, [True, False, False])[0]
            else:
                lib = lambda x=x, w=w_oihw: F.conv2d(  # noqa: E731
                    x, w, padding=1)
            lib_out = lib()
            flops = wc.conv_flops(xs, other[0])
        else:
            gy = torch.randn(other, device="cuda", generator=g)
            kernel = lambda x=x, gy=gy: wc.wide_conv_dw(x, gy)  # noqa: E731
            ref = wc.wide_conv_dw_plain(x.double(), gy.double())
            k, c = other[1], xs[1]
            w_shape = torch.empty((k, c, 3, 3), device="cuda")
            lib_out = torch.ops.aten.convolution_backward(
                gy, x, w_shape, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                1, [False, True, False])[1].permute(0, 2, 3, 1)
            lib = lambda x=x, gy=gy, w=w_shape: \
                torch.ops.aten.convolution_backward(  # noqa: E731
                    gy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                    1, [False, True, False])
            flops = wc.conv_flops(xs, k)
        got = kernel()
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max()) / scale
        lib_err = float((lib_out.double() - ref).abs().max()) / scale
        repeat = torch.equal(got, kernel())
        del got, ref, lib_out
        ms, lib_ms = burst_ms(torch, kernel, 20), burst_ms(torch, lib, 20)
        row = {"kernel": name, "pass": tag, "x": list(xs),
               "other": list(other), "count": count, "err": err,
               "cudnn_err": lib_err, "repeat_bitwise": repeat, "ms": ms,
               "cudnn_ms": lib_ms,
               "tflop_s": flops / ms / 1e9,
               "bound_share": flops / TF32X3_FLOP_PER_S * 1e3 / ms}
        rows.append(row)
        log(f"    {name} {tag} x {xs} {tuple(other)} x{count}: err "
            f"{err:.1e} (cuDNN {lib_err:.1e}), {ms:.4f} ms "
            f"({row['tflop_s']:.1f} TFLOP/s, {row['bound_share']:.1%} of the "
            f"bound) against cuDNN {lib_ms:.4f} ms: {lib_ms / ms:.2f}x")
        if err > WIDE_TOL or not repeat:
            raise AssertionError(f"{name} {tag} {xs} {other}: err {err:.2e} "
                                 f"(bar {WIDE_TOL}), repeat {repeat}")
        del x
    torch.cuda.empty_cache()
    return rows


def wide_conv_replay(torch) -> dict:
    """A replayed d4 fade step (batch 16) against the eager step of a twin
    restored from the same state, on the same reals and draws, bit for bit,
    with cuDNN's deterministic algorithms on both (the kernels sum in a
    fixed order)."""
    from pggan_tpu_torch import checkpoint
    from pggan_tpu_torch.models import Discriminator, Generator
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    label, shape, depth, batch = WIDE_CELLS[0]

    def models():
        G = Generator(shape, generator=torch.Generator().manual_seed(SEED))
        D = Discriminator(shape, generator=torch.Generator().manual_seed(SEED))
        return G.cuda(), D.cuda()
    torch.backends.cudnn.deterministic = True
    try:
        G, D = models()
        state = init_state(G, D, seed=SEED)
        builder = TrainStepBuilder(G, D)
        graphed = builder.step_fn(depth, batch, True)
        u8 = torch.randint(0, 256, builder.real_batch_shape(depth, batch),
                           dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED))
        reals = builder.prep_fn()(u8.cuda(), REPLAY_ALPHA)
        for _ in range(2):  # the eager first call, then the capture
            graphed(state, reals, 0.5, LR, LR)
        G2, D2 = models()
        twin = init_state(G2, D2, seed=SEED + 5)
        checkpoint.restore_training_state(
            twin, checkpoint.training_state_dict(state))
        eager = TrainStepBuilder(G2, D2, cuda_graphs=False).step_fn(
            depth, batch, True)
        got = {k: float(v) for k, v in
               graphed(state, reals, REPLAY_ALPHA, *REPLAY_LR).items()}
        want = {k: float(v) for k, v in
                eager(twin, reals, REPLAY_ALPHA, *REPLAY_LR).items()}
        torch.cuda.synchronize()
        bitwise = all(torch.equal(p, q) for p, q in zip(
            [*G.parameters(), *D.parameters()],
            [*G2.parameters(), *D2.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"losses_equal": got == want, "params_bitwise": bitwise,
           "losses": got}
    log(f"  {label}: a replayed step against the eager step: losses equal "
        f"{got == want}, parameters bit for bit {bitwise}")
    if not (bitwise and got == want):
        raise AssertionError(f"the replay parted from the eager step: {out}")
    del G, D, G2, D2, state, twin
    torch.cuda.empty_cache()
    return out


def wide_conv_phase(torch) -> dict:
    """Phase W: the wide-channel NCHW conv pair at every call of the
    benchmark's train cells and serve, then a replay against the eager
    step. The sums: per cell and kernel, the kernel's and cuDNN's back to
    back ms over a step's calls, and the bound (operations at the
    three-product TF32 rate)."""
    calls = wide_conv_calls(torch)
    merged = collections.Counter()
    for per in calls.values():
        merged.update(per)
    rows = wide_conv_shapes(torch, calls=merged)
    by_call = {(r["kernel"], r["pass"], (tuple(r["x"]), tuple(r["other"]))):
               r for r in rows}
    sums = {}
    for label, per in calls.items():
        for (name, tag, shapes), count in per.items():
            r = by_call[name, tag, shapes]
            t = sums.setdefault(label, {}).setdefault(
                name, {"calls": 0, "ms": 0.0, "cudnn_ms": 0.0,
                       "bound_ms": 0.0})
            t["calls"] += count
            t["ms"] += count * r["ms"]
            t["cudnn_ms"] += count * r["cudnn_ms"]
            t["bound_ms"] += count * r["bound_share"] * r["ms"]
    for label, per in sums.items():
        for name, t in per.items():
            log(f"  {label} {name}: {t['calls']} calls, {t['ms']:.3f} ms "
                f"back to back ({t['bound_ms'] / t['ms']:.1%} of the "
                f"bound {t['bound_ms']:.3f} ms) against cuDNN "
                f"{t['cudnn_ms']:.3f} ms")
    return {"shapes": rows, "sums": sums, "replay": wide_conv_replay(torch)}


# -- StyleGAN's epilogue and blur (phase S) ------------------------------------
# the train.style1024.d8-fade cell: StyleGAN at the CelebA-HQ widths, a
# depth-8 fade step at batch 4
STYLE_SHAPE, STYLE_DEPTH, STYLE_BATCH = (1, 3, 1024, 1024), 8, 4
# the kernels' float32 against the plain twin's float64, over the largest
# element of each output (the sums of d strength and d bias run over 4M
# elements in float32 partials)
STYLE_TOL = 1e-4


def style_calls(torch) -> list:
    """Each synthesis layer's epilogue call of the cell's step: (layer, N,
    C, res, layout). A step runs each layer's forward twice (the fakes for
    D, G's forward for its loss) and its backward once."""
    from pggan_tpu_torch.models.style import StyleGenerator
    G = StyleGenerator(STYLE_SHAPE, device="meta")
    tail = G._tail_start(STYLE_DEPTH)
    out = []
    for i in range(2 * (STYLE_DEPTH + 1)):
        k = i // 2
        layout = "nhcw" if tail is not None and k >= tail else "nchw"
        out.append((i, STYLE_BATCH, G.layer_channels(i), 4 * 2 ** k, layout))
    return out


def style_kink(torch, x, noise, st, b, sty, layout):
    """The elements whose pre-activation ``x + st noise + b`` lies within
    float32 rounding of 0 (float64 inputs)."""
    from pggan_tpu_torch.ops import style
    _xc, y0, _a = style._parts(x, noise, st, b, layout)
    kink = y0.abs() <= 1e-6 * y0.abs().amax(dim=(2, 3), keepdim=True)
    return kink if layout == "nchw" else kink.permute(0, 2, 1, 3)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn`` as a replayed step runs it: ``fn``
    captured into a CUDA graph, then ``reps`` replays back to back between
    two events (no host launch cost, as in the train step's graph)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def style_phase(torch, device="cuda", timer=None) -> dict:
    """Phase S: the epilogue kernel (``ops/style.py`` ``adain``, forward and
    backward) at every layer's call of the StyleGAN cell against its plain
    twin in float64 (``STYLE_TOL``; an element on the activation's kink
    takes the kernel's slope, ``style_kink``), two calls bit for bit, and
    timed as graph replays (``graph_ms``) beside the plain torch epilogue
    in float32 (its forward, and its autograd backward); the blur at its
    shapes likewise (bit for bit against the twin in float32). Per step:
    two forwards and a backward a layer."""
    from pggan_tpu_torch.ops import style
    timer = timer or graph_ms
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, blur_rows = [], []
    sums = {"kernel_ms": 0.0, "plain_ms": 0.0, "blur_ms": 0.0,
            "blur_plain_ms": 0.0, "bound_ms": 0.0}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    for layer, n, c, res, layout in style_calls(torch):
        shape = (n, c, res, res) if layout == "nchw" else (n, res, c, res)
        x, g = rand(*shape), rand(*shape)
        noise = rand(n, 1, res, res)
        st, b, sty = rand(c) * 0.5, rand(c) * 0.5, rand(n, 2 * c)
        xr = x.clone().requires_grad_(True)
        args = (st.clone().requires_grad_(True), b.clone().requires_grad_(True),
                sty.clone().requires_grad_(True))
        y = style.adain(xr, noise, *args, layout)
        got = torch.autograd.grad(y, (xr, *args), g)
        y = y.detach()
        d = [t.double() for t in (x, noise, st, b, sty)]
        want_y = style.adain_plain(*d, layout)
        want = list(style.adain_backward_plain(*d, g.double(), layout))
        # an element whose pre-activation lies within float32 rounding of
        # 0 may take either slope: its dx is the kernel's, in d strength
        # and d bias too (both sides agree off the kink)
        kink = style_kink(torch, *d, layout)
        dx = torch.where(kink, got[0].double(), want[0])
        nz = noise.double().reshape(n, res, 1, res) if layout == "nhcw" \
            else noise.double()
        dims = (0, 1, 3) if layout == "nhcw" else (0, 2, 3)
        want[:3] = dx, (dx * nz).sum(dim=dims), dx.sum(dim=dims)
        errs = [float((y.double() - want_y).abs().max()
                      / want_y.abs().max())]
        errs += [float((a.double() - w).abs().max() / w.abs().max())
                 for a, w in zip(got, want)]
        y2 = style.adain(xr, noise, *args, layout)
        again = torch.autograd.grad(y2, (xr, *args), g)
        y2 = y2.detach()
        repeat = torch.equal(y, y2) and all(
            torch.equal(a, b2) for a, b2 in zip(got, again))
        del y, y2, got, again, want, want_y, d, dx, kink

        def fwd(x=x, noise=noise, st=st, b=b, sty=sty, layout=layout):
            return style.adain(x, noise, st, b, sty, layout)

        def fwd_bwd(xr=xr, noise=noise, args=args, g=g, layout=layout):
            return torch.autograd.grad(style.adain(xr, noise, *args, layout),
                                       (xr, *args), g)

        def plain(x=x, noise=noise, st=st, b=b, sty=sty, layout=layout):
            return style.adain_plain(x, noise, st, b, sty, layout)

        def plain_bwd(xr=xr, noise=noise, args=args, g=g, layout=layout):
            return torch.autograd.grad(
                style.adain_plain(xr, noise, *args, layout), (xr, *args), g)

        ms = {k: timer(torch, f) for k, f in (
            ("fwd", fwd), ("fwd_bwd", fwd_bwd), ("plain", plain),
            ("plain_bwd", plain_bwd))}
        step_ms = ms["fwd"] + ms["fwd_bwd"]
        plain_ms = ms["plain"] + ms["plain_bwd"]
        elems = n * c * res * res
        # least bytes a step: two forwards (x, noise in, y out) and a
        # backward (x, noise, g in, dx out), in float32
        bound_ms = 4 * (2 * (2 * elems + n * res * res)
                        + 3 * elems + n * res * res) / 3.35e12 * 1e3
        row = {"layer": layer, "n": n, "c": c, "res": res, "layout": layout,
               "errs": errs, "repeat_bitwise": repeat, **ms,
               "step_ms": step_ms, "plain_step_ms": plain_ms,
               "bound_ms": bound_ms, "speedup": plain_ms / step_ms}
        rows.append(row)
        for k, v in (("kernel_ms", step_ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms)):
            sums[k] += v
        log(f"  layer {layer} ({layout}, N {n}, C {c}, {res} px): errs "
            + ", ".join(f"{e:.1e}" for e in errs)
            + f"; a step {step_ms:.4f} ms (bound {bound_ms:.4f}) against "
            f"plain torch {plain_ms:.4f} ms: {plain_ms / step_ms:.2f}x")
        if max(errs) > STYLE_TOL or not repeat:
            raise AssertionError(f"adain layer {layer}: errs {errs}, repeat "
                                 f"{repeat}")
        if layer % 2 == 0 and layer > 0:  # after an up-conv: the blur
            yb = style.blur(x, layout)
            exact = torch.equal(yb, style.blur_plain(x, layout))
            bms = timer(torch, lambda x=x, layout=layout:
                        style.blur(x, layout))
            pms = timer(torch, lambda x=x, layout=layout:
                        style.blur_plain(x, layout))
            blur_rows.append({"layer": layer, "layout": layout,
                              "shape": list(shape), "bitwise": exact,
                              "ms": bms, "plain_ms": pms})
            sums["blur_ms"] += bms
            sums["blur_plain_ms"] += pms
            log(f"    blur {list(shape)}: bit for bit {exact}, {bms:.4f} ms "
                f"against plain {pms:.4f} ms")
            if not exact:
                raise AssertionError(f"blur layer {layer} parts from its "
                                     "twin")
        del x, g, xr, noise
        if device == "cuda":
            torch.cuda.empty_cache()
    log(f"  a step's epilogues: {sums['kernel_ms']:.3f} ms (bound "
        f"{sums['bound_ms']:.3f} ms, {sums['bound_ms'] / sums['kernel_ms']:.1%}"
        f") against plain torch {sums['plain_ms']:.3f} ms; blur forwards "
        f"{sums['blur_ms']:.3f} ms against {sums['blur_plain_ms']:.3f} ms")
    return {"epilogue": rows, "blur": blur_rows, "sums": sums}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip()
    log(card_line)
    card = f"{card_line} (torch {torch.__version__}, CUDA {torch.version.cuda})"

    # phase 2: build the kernels from csrc/
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.sampling import disable_tf32
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s")
    for src, entries in _build.ptxas_report().items():
        log(f"  {src}: " + ", ".join(f"{k} {r} regs" + (f" ({s} B spilled)"
                                                     if s else "")
                                     for k, (r, s) in entries.items()))
    for src in ("conv3x3.cu", "conv3x3_dw.cu", "conv_chain.cu"):
        text = (_build.build_dir() / (src + ".log")).read_text()
        warnings = sorted({ln.strip() for ln in text.splitlines()
                           if "warning" in ln.lower()
                           or "Performance Loss" in ln})
        log(f"  {src}: ptxas warnings: {warnings or 'none'}")
    disable_tf32()

    # phase 3: kernels against their plain versions
    log(f"phase 3: kernels vs plain versions, depth-8 tail shapes, batch "
        f"{BATCH}, on {card}")
    checks = KernelChecks(torch)
    checks.run()
    log(f"  the bf16 pool and upsample at every shape of one bf16 depth-8 "
        f"fade train step (batch {TRAIN_BATCH}), against their bf16 plain "
        f"versions bit for bit")
    checks.train_shapes(bf16_step_calls(torch), BF16_KERNELS,
                        "bf16 fade step")
    log(f"phase 3 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase W: the wide-channel NCHW conv pair
    log(f"phase W: the wide-channel NCHW conv pair at every call of the "
        f"benchmark's train cells and serve, against float64, beside cuDNN, "
        f"on {card}")
    wide = wide_conv_phase(torch)
    log(f"phase W passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase S: StyleGAN's epilogue and blur
    log("phase S: the StyleGAN epilogue and blur at every call of the "
        "StyleGAN cell's step")
    style_result = style_phase(torch)
    log(f"phase S passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 4: the slice, through the CLI
    log("phase 4: serve a random paper-config snapshot (depth 8, 1024 px)")
    serve_launches, rate, serve_prof = serve_phase(torch, card)
    for name in SERVE_KERNELS:
        if serve_launches[name] == 0:
            raise AssertionError(f"{name} was never launched by the serve")
    log(f"phase 4 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 5: train the paper configuration at depth 8, eager and graphed
    log(f"phase 5: train the paper configuration, depth 8 (1024 px), batch "
        f"{TRAIN_BATCH}, on {card}")
    train, train_launches, call_log = train_phase(torch)
    train["graphs"] = graph_phase(torch)
    log(f"phase 5 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 6: every kernel call of one train step against its plain version
    log("phase 6: kernels vs plain versions at every shape of one depth-8 "
        "fade train step (timed sums per step)")
    checks.train_shapes(call_log.calls)
    log(f"phase 6 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 7: a depth-6 step on the card against the CPU plain route
    log(f"phase 7: one depth-{CHECK_DEPTH} train step, card vs CPU")
    train[f"depth{CHECK_DEPTH}_vs_cpu"] = step_against_cpu(torch)
    log(f"phase 7 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 8: where the device time of a depth-8 train step goes
    log(f"phase 8: torch.profiler over warm depth-8 train steps, batch "
        f"{TRAIN_BATCH}, eager and replayed")
    profile = profile_phase(torch)
    device_ms = device_ms_by_kernel(profile["graphed_fade"])
    for name, ms in sorted(device_ms.items()):
        bound = checks.sums["train"].get(name, {}).get("bound_ms")
        log(f"  {name:20s} device {ms:.3f} ms a replayed fade step"
            + (f", bound {bound:.3f} ms: {bound / ms:.1%} of its bound"
               if bound else ""))
    log(f"phase 8 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 9: the progressive run through the train CLI, and its resume
    log(f"phase 9: progressive run of the paper configuration through the "
        f"train CLI, depth 0 to {TRAIN_DEPTH}, stopped at {CLI_STOP} kimg "
        f"and resumed to {CLI_TOTAL} kimg")
    keep = tempfile.TemporaryDirectory()
    train["progressive_run"], run_launches, replayed = cli_phase(
        torch, keep.name)
    log(f"  the resumed run's kernel launches (eager first calls): "
        f"{run_launches}; kernels run in its replays: {dict(replayed)}")
    for name in TRAIN_KERNELS:
        if not run_launches.get(name) or not replayed.get(name):
            raise AssertionError(f"{name} was never launched by the resumed "
                                 f"run, or never replayed")
    log(f"phase 9 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 10: sound files -> STFT images on the card -> the train CLI
    # with the SoundSaver -> the generate CLI's SoundSaver
    log(f"phase 10: {SOUND_FILES} WAVs -> SoundImageDataset (n_fft {N_FFT}, "
        f"hop {HOP}) -> train CLI at the paper widths, 1 channel, depth 0 "
        f"to {SOUND_DEPTH} (512 px), ImageSaver + SoundSaver -> generate CLI "
        f"with the SoundSaver, on {card}")
    with tempfile.TemporaryDirectory() as root:
        sound, sound_launches, sound_replayed, gen_launches = sound_phase(
            torch, root)
    for name in TRAIN_KERNELS:
        if not sound_launches.get(name) or not sound_replayed.get(name):
            raise AssertionError(f"{name} was never launched by the sound "
                                 f"run, or never replayed")
    log(f"phase 10 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 11: an image folder's disk pyramid, then the eval CLI
    log(f"phase 11: {2 * EVAL_SAMPLES} PNGs at 1024 px -> "
        f"DefaultImageFolderDataset(preload='disk') -> eval CLI on phase "
        f"9's depth-8 snapshot, {EVAL_SAMPLES} samples, on {card}")
    f32_snapshot = train["progressive_run"].pop("snapshot")
    with tempfile.TemporaryDirectory() as root:
        evaluation, eval_launches = eval_phase(torch, root, f32_snapshot)
        evaluation["h5"] = h5_phase(torch, root)
    log(f"phase 11 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phases 12-15: bf16 mixed precision on the card
    log(f"phase 12: serve a bf16 snapshot of phase 4's weights (depth 8, "
        f"batch {BATCH}), in turns with f32 chain on and off, on {card}")
    bf16 = {"serve": bf16_serve_phase(torch, card)}
    bf16_serve_launches = bf16["serve"]["cli_launches"]
    log(f"phase 12 passed ({time.perf_counter() - t_start:.0f} s so far)")
    log(f"phase 13: the bf16 paper configuration's depth-8 train step, batch "
        f"{TRAIN_BATCH}, eager and replayed, profiled, on {card}")
    bf16["train"], bf16_train_launches, bf16_train_replayed = \
        bf16_train_phase(torch)
    bf16_device_ms = device_ms_by_kernel(
        bf16["train"]["profile"]["graphed_fade"])
    for name in BF16_KERNELS:
        bound = checks.sums["train"][name]["bound_ms"]
        log(f"  {name:20s} device {bf16_device_ms.get(name, 0.0):.3f} ms a "
            f"replayed bf16 fade step, bound {bound:.3f} ms: "
            f"{bound / max(bf16_device_ms.get(name, 0.0), 1e-30):.1%} of its "
            f"bound")
    device_ms.update({k: bf16_device_ms.get(k, 0.0) for k in BF16_KERNELS})
    f32p, bfp = profile, bf16["train"]["profile"]
    log("  bf16 beside f32 (phase 8, wall ms of a step under the profiler, "
        "device busy share, host launches a step): " + "; ".join(
            f"{g} {f32p[g]['wall_ms_per_step']:.1f} / "
            f"{bfp[g]['wall_ms_per_step']:.1f} ms, "
            f"{f32p[g]['device_busy_share']:.1%} / "
            f"{bfp[g]['device_busy_share']:.1%}, "
            f"{f32p[g]['host_launches_per_step']:.0f} / "
            f"{bfp[g]['host_launches_per_step']:.0f}" for g in f32p)
        + f"; replayed fade {train['graphs']['graphed_ms_fade']:.1f} ms "
        f"(phase 5) / {bf16['train']['replay_ms_fade']:.1f} ms; peak memory "
        f"{train['graphs']['peak_bytes'] / 2**30:.2f} / "
        f"{bf16['train']['peak_bytes'] / 2**30:.2f} GiB")
    log(f"phase 13 passed ({time.perf_counter() - t_start:.0f} s so far)")
    log(f"phase 14: one depth-{CHECK_DEPTH} bf16 train step, card vs the "
        f"CPU's bf16 route (and the card's f32 step)")
    bf16["depth6_vs_cpu"] = bf16_step_against_cpu(torch)
    log(f"phase 14 passed ({time.perf_counter() - t_start:.0f} s so far)")
    log(f"phase 15: bf16 progressive run of the paper configuration through "
        f"the train CLI, depth 0 to {TRAIN_DEPTH}, to {BF16_CLI_TOTAL} kimg")
    bf16["progressive_run"], bf16_run_launches, bf16_run_replayed = \
        bf16_cli_phase(torch, keep.name)
    bf16_snapshot = bf16["progressive_run"].pop("snapshot")
    log(f"phase 15 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 16: the export
    log("phase 16: export phase 9's f32 and phase 15's bf16 depth-8 "
        "snapshots through the export CLI")
    with tempfile.TemporaryDirectory() as root:
        export = export_phase(torch, f32_snapshot, bf16_snapshot, root)
    keep.cleanup()
    log(f"phase 16 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phases A-D: data parallelism on the one card
    log(f"phase A: the depth-{TRAIN_DEPTH} step under a one-rank NCCL "
        f"group, graphed, batch {TRAIN_BATCH}, on {card}")
    dp = {"nccl": None, "gloo": None, "torchrun": None, "replicas": None}
    dp["nccl"], nccl_launches, nccl_replayed = nccl_phase(torch)
    log(f"phase A passed ({time.perf_counter() - t_start:.0f} s so far)")
    log(f"phase B: {GLOO_WORLD} gloo ranks on the one card, eager, depth "
        f"{GLOO_DEPTH}, global batch {GLOO_BATCH}, against one process's "
        f"global-batch step")
    dp["gloo"], gloo_launches = gloo_phase(torch)
    log(f"phase B passed ({time.perf_counter() - t_start:.0f} s so far)")
    log(f"phase C: the train CLI under torchrun --nproc_per_node 1 (NCCL), "
        f"paper widths, depth 0 to 3, to {DP_STOP} kimg, resumed to "
        f"{DP_TOTAL}")
    dp["torchrun"], torchrun_launches, torchrun_replayed = \
        torchrun_phase(torch)
    log(f"phase C passed ({time.perf_counter() - t_start:.0f} s so far)")
    log(f"phase D: sample_images over two replicas of G on the one card, "
        f"depth 8, {DP_SAMPLES} images in chunks of {BATCH}, chain on and "
        f"off")
    dp["replicas"], replica_launches = replicas_phase(torch)
    log(f"phase D passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase E: grouped dispatch
    log(f"phase E: grouped dispatch, {GROUP} steps a graph replay: a group "
        f"against its single steps at depth {TRAIN_DEPTH}, then the step "
        f"time through the Trainer at depths "
        f"{', '.join(str(d) for d, _ in GROUP_RUNS)}, 1 against {GROUP} "
        f"steps a dispatch, on {card}")
    group, group_launches, group_replayed = group_phase(torch)
    log(f"phase E passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase F: DepthManager(precompile_ahead=True), last: the process has
    # trained at its shapes, on this thread, as a real run's has
    log(f"phase F: the Trainer and DepthManager with precompile_ahead off and "
        f"on from one state, cuDNN deterministic, "
        + "; ".join(f"depth {a} to {b} ({lod} images a stage)"
                    for _, a, b, _, lod in PRECOMPILE_STRETCHES)
        + f", {GROUP} steps a dispatch, on {card}")
    precompile, precompile_launches, precompile_replayed = \
        precompile_phase(torch)
    log(f"phase F passed ({time.perf_counter() - t_start:.0f} s so far; "
        f"phase F {precompile['phase_s']:.1f} s)")

    # the result lines. ms, plain_ms, library_ms and the bounds: per
    # depth-8 fade train step (batch 3) for the kernels the step runs, per
    # depth-8 serve forward (batch 16) for the serve-only chain
    # launches: the wrapper's launches on the paths, each counted from
    # zero (phase 4's serves, phase 5's eager steps, phase 9's resumed run,
    # phase 10's sound run and sound serve, phase 11's eval, phases 12-16's
    # bf16 paths, phase A's eager calls under the NCCL group, phase B's
    # compared steps on both gloo ranks, phase C's resumed torchrun run,
    # phase D's two-replica serves, phase E's eager first calls of its
    # steps and groups, phase F's warm-ups on the precompile's stream); by
    # path beside it, with the kernels
    # the runs' graph replays ran
    kernels = []
    print(json.dumps({"conv_shapes": checks.shape_rows,
                      "dw_step_shapes": checks.dw_rows,
                      "card": card_line}))
    for name, (src, rep) in KERNELS.items():
        per_step = name not in SERVE_ONLY
        t = checks.sums["train" if per_step else "serve"][name]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train_step_eager": train_launches.get(name, 0),
                   "progressive_run": run_launches.get(name, 0),
                   "progressive_run_replayed": replayed.get(name, 0),
                   "sound_train": sound_launches.get(name, 0),
                   "sound_train_replayed": sound_replayed.get(name, 0),
                   "generate_sound": gen_launches.get(name, 0),
                   "eval": eval_launches.get(name, 0),
                   "bf16_serve": bf16_serve_launches.get(name, 0),
                   "bf16_train_step_eager": bf16_train_launches.get(name, 0),
                   "bf16_train_step_replayed":
                       bf16_train_replayed.get(name, 0),
                   "bf16_progressive_run": bf16_run_launches.get(name, 0),
                   "bf16_progressive_run_replayed":
                       bf16_run_replayed.get(name, 0),
                   "nccl_step_eager": nccl_launches.get(name, 0),
                   "nccl_step_replayed": nccl_replayed.get(name, 0),
                   "gloo_steps_two_ranks": gloo_launches.get(name, 0),
                   "torchrun_cli": torchrun_launches.get(name, 0),
                   "torchrun_cli_replayed": torchrun_replayed.get(name, 0),
                   "sample_two_replicas": replica_launches.get(name, 0),
                   "grouped": group_launches.get(name, 0),
                   "grouped_replayed": group_replayed.get(name, 0),
                   "precompile": precompile_launches.get(name, 0),
                   "precompile_replayed": precompile_replayed.get(name, 0)}
        log(f"  {name}: launches by path {by_path}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(v for k, v in by_path.items()
                            if not k.endswith("_replayed")),
            "launches_by_path": by_path, "max_abs_err": checks.err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"] if "library_ms" in t else None,
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_bound_ms"]
                         >= t["operations_bound_ms"] else "operations"),
            "fma_bound_ms": t["fma_bound_ms"],
            "burst_ms": t["burst_ms"],
            **({"unchained_ms": t["unchained_ms"]} if name in SERVE_ONLY
               else {"device_ms_replayed": device_ms.get(name),
                     "device_share_of_bound":
                         t["bound_ms"] / device_ms[name]
                         if device_ms.get(name) else None}),
            "per": ("serve_forward_depth8" if not per_step else
                    "train_step_depth8_bf16" if name in BF16_KERNELS else
                    "train_step_depth8")})
    print(json.dumps({"serve": {"img_per_s": rate, "depth": 8,
                                "batch": BATCH, "profile": serve_prof,
                                "card": card_line}}))
    print(json.dumps({"train": {**train, "card": card_line}}))
    print(json.dumps({"profile": {**profile, "card": card_line}}))
    print(json.dumps({"sound": {**sound, "card": card_line}}))
    print(json.dumps({"eval": {**evaluation, "card": card_line}}))
    print(json.dumps({"bf16": {**bf16, "card": card_line}}))
    print(json.dumps({"export": {**export, "card": card_line}}))
    for phase, result in dp.items():
        print(json.dumps({phase: {**result, "card": card_line}}))
    print(json.dumps({"group": {**group, "card": card_line}}))
    print(json.dumps({"precompile": {**precompile, "card": card_line}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"wide_conv": {**wide, "card": card_line}}))
    print(json.dumps({"style": {**style_result, "card": card_line}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def worker(argv) -> int:
    """A process that a phase starts: ``--gloo-rank WORK`` (phase B)
    or ``--cli-rank OUT SAVED ARGV...`` (phase C, under torchrun); or
    ``--wide-conv``, phase W alone; or ``--style``, phase S alone."""
    if argv[0] == "--gloo-rank":
        return gloo_rank(argv[1])
    if argv[0] == "--cli-rank":
        return cli_rank(argv[1], argv[2], argv[3:])
    if argv[0] == "--wide-conv":  # phase W alone
        import torch
        from pggan_tpu_torch.ops import _build
        from pggan_tpu_torch.sampling import disable_tf32
        _build.library()
        disable_tf32()
        print(json.dumps({"wide_conv": wide_conv_phase(torch)}))
        return 0
    if argv[0] == "--style":  # phase S alone
        import torch
        from pggan_tpu_torch.ops import _build
        from pggan_tpu_torch.sampling import disable_tf32
        _build.library()
        disable_tf32()
        print(json.dumps({"style": style_phase(torch)}))
        return 0
    raise SystemExit(f"chip_smoke.py takes no arguments, got {argv}")


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]) if len(sys.argv) > 1 else main())
