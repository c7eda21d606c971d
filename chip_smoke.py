#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version at the shapes of the
depth-8 (1024 px) paper-configuration serve, serves a random-init
paper-configuration snapshot through ``pggan_tpu_torch.cli.generate`` and
checks what comes out against the same model run on the CPU, then trains
the paper configuration for a few WGAN-GP steps at depth 8, holds every
kernel against its plain version at every shape one train step gives it,
and holds a depth-6 train step against the same step on the CPU.

    python3 chip_smoke.py

Run it from the root of the repository. It exits nonzero without a CUDA
card, and its last line is ``{"ok": true, "device": {...}}`` only when
every phase passed. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
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
SERVE_ONLY = ("conv3x3_chain", "conv3x3_chain_pn")
SERVE_KERNELS = ("upsample2x", "conv3x3", "conv3x3_act", "conv3x3_act_pn",
                 *SERVE_ONLY)
TRAIN_KERNELS = tuple(k for k in KERNELS if k not in SERVE_ONLY)


def log(msg: str) -> None:
    print(msg, flush=True)


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
        # per kernel mode: max |kernel - plain|, and ms summed over the
        # shapes one depth-8 serve forward runs (ragged checks are not
        # timed); train_ms / train_plain_ms: summed over the calls of one
        # depth-8 train step (train_shapes)
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}
        self.train_ms = {k: 0.0 for k in KERNELS}
        self.train_plain_ms = {k: 0.0 for k in KERNELS}

    def rand(self, *shape, scale=1.0):
        return self.torch.randn(*shape, device="cuda",
                                generator=self.gen) * scale

    def check(self, name, label, kernel, plain, exact=False, timed=True,
              tol=None, count=None):
        """Kernel against plain: exactly, or within ``tol`` (CONV_TOL by
        default; ``scaled_atol`` scales the absolute bar to the plain
        output's largest element). Timed calls add to the serve sums, or,
        with ``count``, ``count`` times to the train-step sums."""
        torch = self.torch
        base = CONV_TOL if tol is None else tol
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(f"{name} {label}: shape {tuple(g.shape)}"
                                     f" != {tuple(w.shape)}")
            err = float((g - w).abs().max()) if g.numel() else 0.0
            self.err[name] = max(self.err[name], err)
            tol = base
            if "scaled_atol" in base:
                scale = float(w.abs().max()) if w.numel() else 0.0
                tol = dict(rtol=base["rtol"],
                           atol=base["scaled_atol"] * max(scale, 1e-30))
            ok = (torch.equal(g, w) if exact
                  else torch.allclose(g, w, **tol))
            if not ok:
                raise AssertionError(f"{name} {label}: max abs err {err} "
                                     f"outside {'exact' if exact else tol}")
        line = f"  {name:17s} {label:34s} max_abs_err {self.err[name]:.3e}"
        if timed:
            reps = 10 if count is None else 5
            t_k = time_ms(torch, kernel, reps=reps)
            t_p = time_ms(torch, plain, reps=reps)
            if count is None:
                self.ms[name] += t_k
                self.plain_ms[name] += t_p
            else:
                self.train_ms[name] += count * t_k
                self.train_plain_ms[name] += count * t_p
                line += f"  x{count}"
            line += f"  kernel {t_k:.3f} ms  plain {t_p:.3f} ms"
            log(line)
            return t_k, t_p
        log(line)
        return None

    def conv_modes(self, x, w, b, label, timed=True):
        from pggan_tpu_torch.ops import conv3x3 as C
        self.check("conv3x3", label, lambda: C.conv3x3(x, w),
                   lambda: C.conv3x3_plain(x, w), timed=timed)
        self.check("conv3x3_act", label,
                   lambda: C.conv3x3_act(x, w, b, slope=0.2),
                   lambda: C.conv3x3_act_plain(x, w, b, slope=0.2),
                   timed=timed)
        self.check("conv3x3_act_pn", label,
                   lambda: C.conv3x3_act_pn(x, w, b, slope=0.2, eps=1e-8),
                   lambda: C.conv3x3_act_pn_plain(x, w, b, slope=0.2,
                                                  eps=1e-8), timed=timed)

    def chain_modes(self, x, w1, b1, w2, b2, label, timed=True):
        from pggan_tpu_torch.ops import conv_chain as CH
        for name, pn in (("conv3x3_chain_pn", 1e-8), ("conv3x3_chain", None)):
            self.check(name, label,
                       lambda: CH.conv3x3_chain(x, w1, b1, w2, b2, slope=0.2,
                                                pn_eps=pn),
                       lambda: CH.conv3x3_chain_plain(x, w1, b1, w2, b2,
                                                      slope=0.2, pn_eps=pn),
                       timed=timed)

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
                self.check("upsample2x", f"x {up_shape}",
                           lambda: R.upsample_2x(x, 1, 3),
                           lambda: R.upsample2x_plain(x, 1, 3), exact=True)
                n, h, _c, w = up_shape
                xs = self.rand(n, 2 * h, c, 2 * w)
                w1, b1 = self.layer(c, k1)
                w2, b2 = self.layer(k1, k2)
                self.conv_modes(xs, w1, b1, f"{c}->{k1} at {2 * h} px")
                z = self.rand(n, 2 * h, k1, 2 * w)
                self.conv_modes(z, w2, b2, f"{k1}->{k2} at {2 * h} px")
                self.chain_modes(xs, w1, b1, w2, b2,
                                 f"{c}->{k1}->{k2} at {2 * h} px")
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
                   timed=False)
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
                   timed=False)
        self.check("conv3x3", "K 128: 64->128 at 128 px",
                   lambda: C.conv3x3(x, w), lambda: C.conv3x3_plain(x, w),
                   timed=False)

    def train_shapes(self, calls, gp_dw):
        """Every kernel call of one depth-8 train step (``CallLog``), each
        distinct shape held against its plain version once and timed;
        the times count as often as the step made the call. Returns the
        kernel ms of the unused weight gradients inside the GP."""
        from pggan_tpu_torch.ops import conv3x3 as C
        from pggan_tpu_torch.ops import resample as R
        torch = self.torch
        plain = {"conv3x3": C.conv3x3_plain,
                 "conv3x3_act": lambda x, w, b, s: C.conv3x3_act_plain(
                     x, w, b, slope=s),
                 "conv3x3_act_pn": lambda x, w, b, s, e:
                     C.conv3x3_act_pn_plain(x, w, b, slope=s, eps=e),
                 "conv3x3_dw": C.conv3x3_dw_plain,
                 "avgpool2x": R.avgpool2x_plain,
                 "upsample2x": R.upsample2x_plain}
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
                t_k, _t_p = self.check(
                    name, label[:34],
                    lambda: CallLog.ORIGINAL[name](*args),
                    lambda: plain[name](*args),
                    exact=name in ("avgpool2x", "upsample2x"),
                    tol=DW_TOL if name == "conv3x3_dw" else None,
                    count=count)
                gp_ms += gp_dw.get((name, sig), 0) * t_k
                del args
        torch.cuda.empty_cache()
        return gp_ms


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
            del out
    return total, rate


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

    # phase 3: kernels against their plain versions
    disable_tf32()
    log(f"phase 3: kernels vs plain versions, depth-8 tail shapes, batch "
        f"{BATCH}, on {card}")
    checks = KernelChecks(torch)
    checks.run()
    log(f"phase 3 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 4: the slice, through the CLI
    log("phase 4: serve a random paper-config snapshot (depth 8, 1024 px)")
    launches, rate = serve_phase(torch, card)
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

    # the result lines. ms / plain_ms: per depth-8 fade train step (batch
    # 3) for the kernels the step runs, per depth-8 serve forward (batch
    # 16) for the serve-only chain
    kernels = []
    for name, (src, rep) in KERNELS.items():
        per_step = name in TRAIN_KERNELS
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": checks.err[name],
            "ms": (checks.train_ms if per_step else checks.ms)[name],
            "plain_ms": (checks.train_plain_ms if per_step
                         else checks.plain_ms)[name],
            "per": "train_step_depth8" if per_step else "serve_forward_depth8"})
    print(json.dumps({"serve": {"img_per_s": rate, "depth": 8,
                                "batch": BATCH, "card": card_line}}))
    print(json.dumps({"train": {**train, "card": card_line}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
