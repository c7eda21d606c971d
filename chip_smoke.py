#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version at the shapes of the
depth-8 (1024 px) paper-configuration serve, then serves a random-init
paper-configuration snapshot through ``pggan_tpu_torch.cli.generate`` and
checks what comes out against the same model run on the CPU.

    python3 chip_smoke.py

Run it from the root of the repository. It exits nonzero without a CUDA
card, and its last line is ``{"ok": true, "device": {...}}`` only when
every phase passed. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH = 16  # the serve's --minibatch
CONV_TOL = dict(rtol=1e-4, atol=1e-5)  # same math, f32 sums in another order
NET_TOL = dict(rtol=2e-3, atol=3e-4)   # tests/test_torch_parity_network.py

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
}


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
        # shapes one depth-8 forward runs (ragged checks are not timed)
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}

    def rand(self, *shape, scale=1.0):
        return self.torch.randn(*shape, device="cuda",
                                generator=self.gen) * scale

    def check(self, name, label, kernel, plain, exact=False, timed=True):
        torch = self.torch
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
            ok = (torch.equal(g, w) if exact
                  else torch.allclose(g, w, **CONV_TOL))
            if not ok:
                raise AssertionError(f"{name} {label}: max abs err {err} "
                                     f"outside {'exact' if exact else CONV_TOL}")
        line = f"  {name:17s} {label:34s} max_abs_err {self.err[name]:.3e}"
        if timed:
            t_k, t_p = time_ms(torch, kernel), time_ms(torch, plain)
            self.ms[name] += t_k
            self.plain_ms[name] += t_p
            line += f"  kernel {t_k:.3f} ms  plain {t_p:.3f} ms"
        log(line)

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
        torch.cuda.empty_cache()


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
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched by the serve")
    log(f"phase 4 passed ({time.perf_counter() - t_start:.0f} s so far)")

    # phase 5: the kernels line; ms = per depth-8 forward at batch 16
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": checks.err[name], "ms": checks.ms[name],
                "plain_ms": checks.plain_ms[name]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"serve": {"img_per_s": rate, "depth": 8,
                                "batch": BATCH, "card": card_line}}))
    print(json.dumps({"kernels": kernels}))
    # phase 6
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
