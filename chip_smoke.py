#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version at the shapes of the
depth-8 (1024 px) paper-configuration serve (the fused conv pair also
against the two unfused calls it replaces), serves a random-init
paper-configuration snapshot through ``pggan_tpu_torch.cli.generate``,
checks what comes out against the same model run on the CPU, holds the
serve's pinned copy to the host against the pageable one, and profiles one
served chunk, then trains the paper configuration for a few WGAN-GP steps
at depth 8, eagerly and as CUDA graph replays (the replay held against the
eager step), holds every kernel against its plain version at every shape
one train step gives it, holds a depth-6 train step against the same step
on the CPU, profiles warm depth-8 train steps (device time by kernel,
device busy share, launches from the host), runs a progressive training
run from depth 0 to 8 through ``pggan_tpu_torch.cli.train``, stopped
short and resumed from its checkpoint, then trains a one-channel 512 px
sound model on seeded WAVs (their STFT images made on the card and held
against the host path) with the SoundSaver's Griffin-Lim on the card,
serves it through the generate CLI's SoundSaver (Griffin-Lim held against
the CPU), and last builds an image folder's disk pyramid through the
host library and scores the depth-8 snapshot with
``pggan_tpu_torch.cli.eval`` (SWD and MS-SSIM held against the CPU).

    python3 chip_smoke.py

Run it from the root of the repository. It exits nonzero without a CUDA
card, and its last line is ``{"ok": true, "device": {...}}`` only when
every phase passed. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
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
REPLAY_ALPHA, REPLAY_LR = 0.3, (0.6e-3, 0.3e-3)

# NHCW shapes of the depth-8 tail, stages 5-7 (256, 512, 1024 px):
# (upsample input), and (C, K1, K2) of each stage's conv pair
STAGES = [((BATCH, 128, 64, 128), (64, 32, 32)),
          ((BATCH, 256, 32, 256), (32, 16, 16)),
          ((BATCH, 512, 16, 512), (16, 8, 8))]

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
}
# The card's published peaks for the bounds (NVIDIA H100 SXM data sheet,
# dense, at its 700 W limit): memory 3.35 TB/s; f32 products on the tensor
# cores as three TF32 products (495 / 3 TFLOP/s), the kernels' arithmetic;
# f32 FMAs outside them 67 TFLOP/s, printed beside it.
HBM_BYTES_PER_S = 3.35e12
TF32X3_FLOP_PER_S = 495e12 / 3
FMA_FLOP_PER_S = 67e12
SERVE_ONLY = ("conv3x3_chain", "conv3x3_chain_pn")
SERVE_KERNELS = ("upsample2x", "conv3x3", "conv3x3_act", "conv3x3_act_pn",
                 *SERVE_ONLY)
TRAIN_KERNELS = tuple(k for k in KERNELS if k not in SERVE_ONLY)


def log(msg: str) -> None:
    print(msg, flush=True)


def work(name: str, sig) -> tuple:
    """(FLOPs, bytes) of one call of kernel ``name`` with call signature
    ``sig`` (its arguments, tensors as shapes, as ``CallLog`` records
    them): a multiply-add counts two FLOPs, and each f32 input is read
    once and each output written once."""
    shapes = [a for a in sig if isinstance(a, tuple)]
    read = sum(math.prod(s) for s in shapes)
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
        return 0, 4 * (read + read // 4)
    if name == "upsample2x":
        return 0, 4 * (read + 4 * read)
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
        plain version's error printed beside); returns each mode's ms."""
        from pggan_tpu_torch.ops import conv_chain as CH
        times = {}
        for name, pn in (("conv3x3_chain_pn", 1e-8), ("conv3x3_chain", None)):
            def plain(*a, pn=pn):
                return CH.conv3x3_chain_plain(*a, slope=0.2, pn_eps=pn)
            args = (x, w1, b1, w2, b2)
            t = self.check(name, label,
                           lambda pn=pn: CH.conv3x3_chain(
                               *args, slope=0.2, pn_eps=pn),
                           lambda p=plain: p(*args), timed=timed, args=args,
                           reference=self.f64(plain, *args))
            if t is not None:
                times[name] = t[0]
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
            # ragged: H and W not multiples of any tile, to hold the masks
            x = self.rand(3, 37, 5, 45)
            self.check("upsample2x", "ragged x (3, 37, 5, 45)",
                       lambda: R.upsample_2x(x, 1, 3),
                       lambda: R.upsample2x_plain(x, 1, 3), exact=True,
                       timed=False)
            x = self.rand(2, 37, 24, 45)
            w, b = self.layer(24, 40)
            self.conv_modes(x, w, b, "ragged 24->40 (2, 37, ., 45)",
                            timed=False)
            w1, b1 = self.layer(24, 16)
            w2, b2 = self.layer(16, 8)
            self.chain_modes(x, w1, b1, w2, b2,
                             "ragged 24->16->8 (2, 37, ., 45)", timed=False)
            self.train_kernels_ragged()
        torch.cuda.empty_cache()

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

    def train_shapes(self, calls):
        """Every kernel call of one depth-8 train step (``CallLog``), each
        distinct shape held against its plain version once and timed: one
        bracketed call (host launch path included) and a call of a
        back-to-back burst (device time); the times count as often as the
        step made the call. The weight gradient's two calls at each shape
        must agree bit for bit."""
        torch = self.torch
        plain = plain_versions()
        with torch.no_grad():
            for (name, sig), count in sorted(calls.items()):
                args = []
                for a in sig:
                    if isinstance(a, tuple):  # a tensor's shape
                        scale = ((2.0 / (9 * a[2])) ** 0.5 if len(a) == 4
                                 and a[:2] == (3, 3) else 1.0)
                        args.append(self.rand(*a, scale=scale))
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
                    exact=name in ("avgpool2x", "upsample2x"),
                    tol=DW_TOL if name == "conv3x3_dw" else None,
                    count=count, args=args,
                    reference=(self.f64(plain[name], *args)
                               if name in F64_REFERENCE else None))
                burst = burst_ms(
                    torch, lambda a=args: CallLog.ORIGINAL[name](*a), 20)
                self.sums["train"][name]["burst_ms"] += count * burst
                if name == "upsample2x":
                    self.host[sig] = (t_k, burst)
                del args
        torch.cuda.empty_cache()
        for sig, (one, burst) in sorted(
                self.host.items(), key=lambda kv: math.prod(kv[0][0]))[:3]:
            log(f"  upsample2x {sig[0]}: one bracketed call {one * 1e3:.1f} "
                f"us, in a burst {burst * 1e3:.1f} us a call")
        for name in TRAIN_KERNELS:
            t = self.sums["train"][name]
            log(f"  {name:15s} per fade step: bracketed {t['ms']:.3f} ms, "
                f"back to back {t['burst_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.3f} ms: {t['bound_ms'] / t['burst_ms']:.1%}"
                f" of its bound back to back")


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
            "upsample2x": R.upsample2x_plain}


class CallLog:
    """Records the kernel wrappers' calls (kernel mode and input shapes) on
    the train path, and which weight-gradient calls fall inside the
    gradient penalty's inner ``autograd.grad``: there should be none, as
    in the JAX package (``ops/conv3x3.py:input_grad_only``)."""

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
                self.calls[(name, sig)] += 1
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
    total = {k: 0 for k in KERNELS}
    paper = dict(dataset_shape=(1, 3, 1024, 1024))  # fmap_base 4096 etc.
    fwd = -(-40 // BATCH)  # forwards of a 40-image request
    runs = [
        # (tag, config, alpha, extra flags, n images, expected launches,
        #  images checked against the CPU)
        ("paper, stable, chain", {}, 1.0, [], 40,
         {"conv3x3_chain_pn": 3 * fwd, "upsample2x": 3 * fwd}, 2),
        ("paper, fade 0.5, chain", {}, 0.5, [], 40,
         {"conv3x3_chain_pn": 3 * fwd, "upsample2x": 4 * fwd}, 2),
        ("paper, stable, chain off", {}, 1.0,
         ["--inference_chain", "False"], 40,
         {"conv3x3_act_pn": 6 * fwd, "upsample2x": 3 * fwd}, 2),
        ("pixelnorm off, chain", {"pixelnorm": False}, 1.0, [], BATCH,
         {"conv3x3_chain": 3, "upsample2x": 3}, 1),
        ("pixelnorm off, chain off", {"pixelnorm": False}, 1.0,
         ["--inference_chain", "False"], BATCH,
         {"conv3x3_act": 6, "upsample2x": 3}, 1),
        ("relu", {"leakyrelu": False}, 1.0, [], BATCH,
         {"conv3x3": 6, "upsample2x": 3}, 1),
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
    from torch.profiler import ProfilerActivity, profile
    from pggan_tpu_torch.checkpoint import load_snapshot
    G, meta = load_snapshot(snap, device="cuda")
    G.inference_chain = True
    run = lambda: sample_images(  # noqa: E731
        G, meta["depth"], meta["alpha"], BATCH, minibatch=BATCH,
        rng=np.random.RandomState(SEED))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_profile(torch, prof, wall_ms, 1,
                          f"serve profile, one chunk of {BATCH}", "chunk")


def paper_models(torch, device):
    """The paper configuration (``Generator((1, 3, 1024, 1024))`` and
    ``Discriminator`` with all defaults), random weights from SEED, G's
    per-conv Functions on (no chain: the train path)."""
    from pggan_tpu_torch.models import Discriminator, Generator
    shape = (1, 3, 1024, 1024)
    G = Generator(shape, generator=torch.Generator().manual_seed(SEED))
    D = Discriminator(shape, generator=torch.Generator().manual_seed(SEED + 1))
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
    |want's update| in the 2-norm and at the largest element, and whether
    the parameters agree bit for bit. Every tensor the second step moved
    must have moved in the first, and no other."""
    ratios, worst = [], 0.0
    bitwise = True
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
        worst = max(worst, float((dp - dq).abs().max() / dq.abs().max()))
    if not ratios:
        raise AssertionError("the eager step moved no parameter")
    return {"params_bitwise": bitwise, "tensors_moved": len(ratios),
            "update_err_over_norm": max(ratios),
            "update_err_over_max": worst}


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
# of 3 images and then runs 8 stable steps.
CLI_LOD = 48
CLI_STOP = 0.7
CLI_TOTAL = (16 * CLI_LOD + 8 * 3) / 1000


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


def schedule_steps(start_nimg, stop_kimg):
    """Steps of each (depth, batch, fade) key from ``start_nimg`` until the
    trainer stops at ``stop_kimg``, by the port's schedule with the
    paper's per-depth batches; and the image count it stops at."""
    from pggan_tpu_torch.training.schedule import (depth_alpha_schedule,
                                                   minibatch_for_depth)
    steps, nimg = collections.Counter(), start_nimg
    while nimg < stop_kimg * 1000:
        depth, alpha = depth_alpha_schedule(nimg, TRAIN_DEPTH, CLI_LOD,
                                            CLI_LOD)
        batch = minibatch_for_depth(depth)
        steps[(depth, batch, alpha < 1.0)] += 1
        nimg += batch
    return steps, nimg


def cli_phase(torch, keep_dir):
    """A progressive run of the paper configuration through
    ``python -m pggan_tpu_torch.cli.train`` from depth 0, stopped at
    CLI_STOP kimg, then resumed in this process with ``--resume_network
    latest`` to CLI_TOTAL kimg: its restored state held bit for bit against
    the checkpoint, every kernel of the step launched, every stage's fade
    and stable graph captured, finite losses. Returns the numbers, the
    resumed run's launch counts (its eager calls) and the kernels its
    replays ran (each graph's captured kernels times its replays). Its
    last generator snapshot is copied into ``keep_dir``."""
    import ast
    import glob
    import re
    import numpy as np
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
        m = re.search(r"fade\) (\[.*\]); peak device memory (\d+) B",
                      res.stdout)
        first_keys, out["first_run_peak_bytes"] = (
            set(ast.literal_eval(m.group(1))), int(m.group(2)))
        run1, = glob.glob(os.path.join(root, "001-*"))
        state_path, = glob.glob(os.path.join(run1, "training-state-*.dat"))
        sd, nimg, iterations, base_time = checkpoint.load_training_state(
            state_path)
        steps1, stop1 = schedule_steps(0, CLI_STOP)
        steps2, _ = schedule_steps(nimg, CLI_TOTAL)
        if nimg != stop1 or first_keys != {k for k, n in steps1.items()
                                           if n >= 2}:
            raise AssertionError(f"first run: stopped at {nimg} (schedule "
                                 f"{stop1}), graphs {sorted(first_keys)}")
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
            second_keys = set(builder.graphed_keys())
            replayed = collections.Counter()
            for key in second_keys:
                step = builder.step_fn(*key)
                for name, n in step.captured.items():
                    replayed[name] += n * step.replays
            out["launches_eager"] = launches
            out["kernels_run_in_replays"] = dict(replayed)
            if second_keys != {k for k, n in steps2.items() if n >= 2}:
                raise AssertionError(f"resumed run: graphs "
                                     f"{sorted(second_keys)}")
            if first_keys | second_keys != want_keys:
                raise AssertionError("the run missed a stage's graph: "
                                     f"{sorted(want_keys - first_keys)}")
            depth8 = {k: builder.step_fn(*k).replays + 1
                      for k in second_keys if k[0] == TRAIN_DEPTH}
            if len(depth8) != 2 or min(depth8.values()) < 4:
                raise AssertionError(f"depth-8 steps {depth8}")
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
        "ticks": len(rows), "depth8_steps": {str(k): v
                                             for k, v in depth8.items()},
        "sec_per_kimg_by_depth": {d: v for d, v in sorted(per_depth.items())},
        "first_run_ticks": ticks, "first_run_checkpoints": saves})
    log(f"  sec/kimg per tick by the depth it ended at: "
        + "; ".join(f"{d}: {', '.join(f'{x:.1f}' for x in v)}"
                    for d, v in sorted(per_depth.items())))
    log(f"  graphs captured: {out['graphs_captured']} ({len(first_keys)} + "
        f"{len(second_keys)}); depth-8 steps {depth8}; peak device memory "
        f"{out['first_run_peak_bytes'] / 2**30:.2f} / "
        f"{out['resumed_run_peak_bytes'] / 2**30:.2f} GiB (first / resumed "
        f"run); launches from Python per replayed trainer iteration "
        f"{out['python_launches_per_replayed_iteration']:.1f}")
    return out, launches, replayed


def compare_state(a, b) -> bool:
    """Two training state dicts hold the same keys and the same bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(compare_state(a[k], b[k])
                                            for k in a)
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
    replayed = collections.Counter()
    for key in trainer.builder.graphed_keys():
        step = trainer.builder.step_fn(*key)
        for name, n in step.captured.items():
            replayed[name] += n * step.replays
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
               graphs_captured=len(trainer.builder.graphed_keys()))
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


# device kernels by source, for the profile (first match wins)
KERNEL_GROUPS = (
    ("chain kernel", ("chain_kernel", "chain_split")),
    ("conv3x3 kernel", ("conv3x3_kernel", "conv3x3_split")),
    ("conv3x3_dw kernel", ("conv3x3_dw",)),
    ("upsample / pool kernels", ("upsample2x", "avgpool2x")),
    ("cuDNN / GEMM", ("cudnn", "gemm", "sm90_", "sm80_", "cutlass", "xmma",
                      "convolve", "fft", "winograd", "dgrad", "wgrad")),
    ("Adam (foreach)", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "cat")),
    ("device-to-host copy", ("Memcpy DtoH",)),
)
# the groups of the kernels in csrc/ that a train step runs
OUR_GROUPS = ("conv3x3 kernel", "conv3x3_dw kernel", "upsample / pool kernels")


def profile_phase(torch, steps: int = 2):
    """``torch.profiler`` over ``steps`` warm depth-8 train steps of each
    graph (fade, stable), eager and replayed as CUDA graphs: device time
    summed by kernel name and group, device busy share (the union of
    kernel intervals over the host window of the synchronised steps), and
    the launches the host issued. A replay must run the kernels of the
    eager step: per step, as many of each hand-written kernel group on the
    card, and the graph's captured wrapper calls equal to the eager step's
    launches."""
    from torch.profiler import ProfilerActivity, profile
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, "cuda")
    state = init_state(G, D, seed=SEED)
    out, wrapper_calls = {}, {}
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
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    step(state, reals, alpha, LR, LR)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            graph = f"{route}_{'fade' if fade else 'stable'}"
            out[graph] = device_profile(torch, prof, wall_ms, steps, graph,
                                        "step")
            wrapper_calls[graph] = (
                {k: (n - launches.get(k, 0)) / steps
                 for k, n in _build.LAUNCHES.items()
                 if n != launches.get(k, 0)}
                if route == "eager" else dict(step.captured))
    for graph in ("fade", "stable"):
        eager, replay = out[f"eager_{graph}"], out[f"graphed_{graph}"]
        ours = {g: eager["kernels_per_step_by_group"].get(g, 0)
                for g in OUR_GROUPS}
        theirs = {g: replay["kernels_per_step_by_group"].get(g, 0)
                  for g in OUR_GROUPS}
        calls = (wrapper_calls[f"eager_{graph}"],
                 wrapper_calls[f"graphed_{graph}"])
        log(f"  {graph}: hand-written kernels on the card a step, eager "
            f"{ours}, replayed {theirs}; wrapper calls a step, eager "
            f"{calls[0]}, captured {calls[1]}")
        if ours != theirs or not all(ours.values()) or calls[0] != calls[1]:
            raise AssertionError(f"{graph}: the replay ran other kernels "
                                 f"than the eager step")
    return out


# host calls that put work on the card's queue
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(torch, prof, wall_ms, per, tag, unit) -> dict:
    """Sums a profiler window's device activity (kernels and copies) by
    name and by ``KERNEL_GROUPS``, per ``per`` repetitions; the busy share
    is the union of their intervals over the host window ``wall_ms``."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    spans = []
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    host = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name in HOST_LAUNCHES)
    groups, counts = collections.Counter(), collections.Counter()
    group_of = {}
    for name, ms in by_name.items():
        group_of[name] = next((g for g, keys in KERNEL_GROUPS
                               if any(k in name for k in keys)), "other")
        groups[group_of[name]] += ms / per
    for e in kernels:
        counts[group_of[e.name]] += 1
    log(f"  {tag}: {wall_ms / per:.1f} ms a {unit}, device busy "
        f"{busy_us / 1e3 / per:.1f} ms ({busy_us / 1e3 / wall_ms:.1%}), "
        f"{len(kernels) / per:.0f} kernels and copies on the card, "
        f"{host / per:.0f} launches from the host")
    for g, ms in groups.most_common():
        log(f"    {g:24s} {ms:8.3f} ms")
    return {f"wall_ms_per_{unit}": wall_ms / per,
            f"device_busy_ms_per_{unit}": busy_us / 1e3 / per,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            f"launches_per_{unit}": len(kernels) / per,
            f"host_launches_per_{unit}": host / per,
            f"ms_per_{unit}_by_group": dict(groups.most_common()),
            f"kernels_per_{unit}_by_group": {g: n / per
                                             for g, n in counts.items()},
            f"top_kernels_ms_per_{unit}": {
                n: ms / per for n, ms in by_name.most_common(12)}}


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
    disable_tf32()

    # phase 3: kernels against their plain versions
    log(f"phase 3: kernels vs plain versions, depth-8 tail shapes, batch "
        f"{BATCH}, on {card}")
    checks = KernelChecks(torch)
    checks.run()
    log(f"phase 3 passed ({time.perf_counter() - t_start:.0f} s so far)")

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
    with tempfile.TemporaryDirectory() as root:
        evaluation, eval_launches = eval_phase(
            torch, root, train["progressive_run"].pop("snapshot"))
        evaluation["h5"] = h5_phase(torch, root)
    keep.cleanup()
    log(f"phase 11 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # the result lines. ms, plain_ms, library_ms and the bounds: per
    # depth-8 fade train step (batch 3) for the kernels the step runs, per
    # depth-8 serve forward (batch 16) for the serve-only chain
    # launches: the wrapper's launches on the paths, each counted from
    # zero (phase 4's serves, phase 5's eager steps, phase 9's resumed run,
    # phase 10's sound run and sound serve, phase 11's eval); by path
    # beside it, with the kernels the runs' graph replays ran
    kernels = []
    for name, (src, rep) in KERNELS.items():
        per_step = name in TRAIN_KERNELS
        t = checks.sums["train" if per_step else "serve"][name]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train_step_eager": train_launches.get(name, 0),
                   "progressive_run": run_launches.get(name, 0),
                   "progressive_run_replayed": replayed.get(name, 0),
                   "sound_train": sound_launches.get(name, 0),
                   "sound_train_replayed": sound_replayed.get(name, 0),
                   "generate_sound": gen_launches.get(name, 0),
                   "eval": eval_launches.get(name, 0)}
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
            **({"unchained_ms": t["unchained_ms"]} if name in SERVE_ONLY
               else {"burst_ms": t["burst_ms"]}),
            "per": "train_step_depth8" if per_step else "serve_forward_depth8"})
    print(json.dumps({"serve": {"img_per_s": rate, "depth": 8,
                                "batch": BATCH, "profile": serve_prof,
                                "card": card_line}}))
    print(json.dumps({"train": {**train, "card": card_line}}))
    print(json.dumps({"profile": {**profile, "card": card_line}}))
    print(json.dumps({"sound": {**sound, "card": card_line}}))
    print(json.dumps({"eval": {**evaluation, "card": card_line}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
