#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version at the shapes of the
depth-8 (1024 px) paper-configuration serve (the fused conv pair also
against the two unfused calls it replaces), serves a random-init
paper-configuration snapshot through ``pggan_tpu_torch.cli.generate``,
checks what comes out against the same model run on the CPU and profiles
one served chunk, then trains the paper configuration for a few WGAN-GP
steps at depth 8, holds every kernel against its plain version at every
shape one train step gives it, holds a depth-6 train step against the same
step on the CPU, and profiles warm depth-8 train steps (device time by
kernel, device busy share).

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

    def train_shapes(self, calls, gp_dw):
        """Every kernel call of one depth-8 train step (``CallLog``), each
        distinct shape held against its plain version once and timed;
        the times count as often as the step made the call. The weight
        gradient's two calls at each shape must agree bit for bit. Returns
        the kernel ms of the unused weight gradients inside the GP."""
        torch = self.torch
        plain = plain_versions()
        gp_ms = 0.0
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
                gp_ms += gp_dw.get((name, sig), 0) * t_k
                if name == "upsample2x":
                    burst = burst_ms(
                        torch, lambda a=args: CallLog.ORIGINAL[name](*a))
                    self.host[sig] = (t_k, burst)
                del args
        torch.cuda.empty_cache()
        for sig, (one, burst) in sorted(
                self.host.items(), key=lambda kv: math.prod(kv[0][0]))[:3]:
            log(f"  upsample2x {sig[0]}: one bracketed call {one * 1e3:.1f} "
                f"us, in a burst of 100 {burst * 1e3:.1f} us a call")
        return gp_ms


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
    gradient penalty's inner ``autograd.grad``: those compute D's weight
    gradients that nothing uses (``ctx.needs_input_grad`` is fixed at
    forward time), the cost this port pays over the JAX package there."""

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
                    f"{rate:.2f} img/s on {card}")
                profile = serve_profile(torch, snap, sample_images)
            del out
    return total, rate, profile


def steady_rate(torch, snap, sample_images):
    """Images per second of warm ``sample_images`` calls: 3 padded chunks
    of BATCH, timed on the host clock around a synchronised call."""
    import numpy as np
    from pggan_tpu_torch.checkpoint import load_snapshot
    G, meta = load_snapshot(snap, device="cuda")
    G.inference_chain = True
    n = 3 * BATCH
    sample_images(G, meta["depth"], meta["alpha"], BATCH, minibatch=BATCH)
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_images(G, meta["depth"], meta["alpha"], n, minibatch=BATCH,
                      rng=np.random.RandomState(SEED))
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return sorted(rates)[1]


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
    ``prep_fn`` and ``step_fn``; the second fade step's kernel calls are
    logged for phase 6."""
    import numpy as np
    from pggan_tpu_torch.ops import _build
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, device)
    state = init_state(G, D, seed=SEED)
    builder = TrainStepBuilder(G, D)
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
    median = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    train = {"depth": TRAIN_DEPTH, "batch": TRAIN_BATCH, "d_repeats": 1,
             "ms_per_step_fade": median(times[True][1:]),
             "ms_per_step_stable": median(times[False][1:]),
             "step_ms_all": {"fade": times[True], "stable": times[False]},
             "max_memory_allocated": peak}
    del G, D, state, builder, start, current, moments
    torch.cuda.empty_cache()
    return train, counts, call_log


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
        builder = TrainStepBuilder(G, D)
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


def profile_phase(torch, steps: int = 2):
    """``torch.profiler`` over ``steps`` warm depth-8 train steps of each
    graph (fade, stable): device time summed by kernel name and group,
    device busy share (the union of kernel intervals over the host window
    of the synchronised steps), and launches."""
    from torch.profiler import ProfilerActivity, profile
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G, D = paper_models(torch, "cuda")
    state, builder = init_state(G, D, seed=SEED), TrainStepBuilder(G, D)
    prep = builder.prep_fn()
    u8 = uint8_reals(torch, builder, TRAIN_DEPTH, SEED).cuda()
    out = {}
    for fade in (True, False):
        alpha = 0.5 if fade else 1.0
        step = builder.step_fn(TRAIN_DEPTH, TRAIN_BATCH, fade)
        for _ in range(2):  # warm-up
            step(state, prep(u8, alpha), alpha, LR, LR)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, prep(u8, alpha), alpha, LR, LR)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        graph = "fade" if fade else "stable"
        out[graph] = device_profile(torch, prof, wall_ms, steps, graph,
                                    "step")
    return out


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
    groups = collections.Counter()
    for name, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] += ms / per
    log(f"  {tag}: {wall_ms / per:.1f} ms a {unit}, device busy "
        f"{busy_us / 1e3 / per:.1f} ms ({busy_us / 1e3 / wall_ms:.1%}), "
        f"{len(kernels) / per:.0f} launches and copies")
    for g, ms in groups.most_common():
        log(f"    {g:24s} {ms:8.3f} ms")
    return {f"wall_ms_per_{unit}": wall_ms / per,
            f"device_busy_ms_per_{unit}": busy_us / 1e3 / per,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            f"launches_per_{unit}": len(kernels) / per,
            f"ms_per_{unit}_by_group": dict(groups.most_common()),
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
    launches, rate, serve_prof = serve_phase(torch, card)
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched by the serve")
    log(f"phase 4 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 5: train the paper configuration at depth 8
    log(f"phase 5: train the paper configuration, depth 8 (1024 px), batch "
        f"{TRAIN_BATCH}, on {card}")
    train, train_launches, call_log = train_phase(torch)
    for name, n in train_launches.items():
        launches[name] += n
    log(f"phase 5 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 6: every kernel call of one train step against its plain version
    log("phase 6: kernels vs plain versions at every shape of one depth-8 "
        "fade train step (timed sums per step)")
    gp_dw_ms = checks.train_shapes(call_log.calls, call_log.gp_dw)
    train["gp_unused_dw"] = {"launches": sum(call_log.gp_dw.values()),
                             "ms": gp_dw_ms}
    log(f"  unused D weight gradients inside the GP: "
        f"{sum(call_log.gp_dw.values())} calls, {gp_dw_ms:.3f} ms a step")
    log(f"phase 6 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 7: a depth-6 step on the card against the CPU plain route
    log(f"phase 7: one depth-{CHECK_DEPTH} train step, card vs CPU")
    train[f"depth{CHECK_DEPTH}_vs_cpu"] = step_against_cpu(torch)
    log(f"phase 7 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 8: where the device time of a depth-8 train step goes
    log(f"phase 8: torch.profiler over warm depth-8 train steps, batch "
        f"{TRAIN_BATCH}")
    profile = profile_phase(torch)
    log(f"phase 8 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # the result lines. ms, plain_ms, library_ms and the bounds: per
    # depth-8 fade train step (batch 3) for the kernels the step runs, per
    # depth-8 serve forward (batch 16) for the serve-only chain
    kernels = []
    for name, (src, rep) in KERNELS.items():
        per_step = name in TRAIN_KERNELS
        t = checks.sums["train" if per_step else "serve"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": checks.err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"] if "library_ms" in t else None,
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_bound_ms"]
                         >= t["operations_bound_ms"] else "operations"),
            "fma_bound_ms": t["fma_bound_ms"],
            **({"unchained_ms": t["unchained_ms"]} if name in SERVE_ONLY
               else {}),
            "per": "train_step_depth8" if per_step else "serve_forward_depth8"})
    print(json.dumps({"serve": {"img_per_s": rate, "depth": 8,
                                "batch": BATCH, "profile": serve_prof,
                                "card": card_line}}))
    print(json.dumps({"train": {**train, "card": card_line}}))
    print(json.dumps({"profile": {**profile, "card": card_line}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
