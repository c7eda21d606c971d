"""Serve traffic: one client in a closed loop, each request
``sampling.sample_images`` of ``request_images`` images into host memory,
served in padded chunks of ``minibatch`` on the serving generator (the
fused conv-pair chain on, as the generate CLI serves).

Set-up builds G on the seed's weights and serves ``warmup_requests``
requests, which warm every shape the window uses. The window then sends
requests until ``seconds`` have passed; a request's latency runs from the
call to its last image in host memory. A sample of the requests, drawn
from the seed as the window goes (a reservoir), is kept and checked
against the reference once the window has closed.

Parameters (the traffic file): ``depth``, ``alpha``, ``minibatch``,
``request_images``, ``warmup_requests``, ``sampled_requests``,
``trace_requests``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, inputs, tracing, yardstick
from portbench.reference import pggan

END_TO_END = ("serve_img_s", "serve_request_ms_p95", "setup_s")
WARMUP = 1 << 30


def request_seed(base: int, i: int) -> int:
    """The latents' seed of request ``i``."""
    return int(np.random.SeedSequence([base, i]).generate_state(1)[0])


def run(cell) -> None:
    """One run of a serve cell; fills ``cell.result``."""
    from pggan_tpu_torch.models import Generator
    from pggan_tpu_torch.sampling import sample_images
    from portbench.traffic.train import model_args

    cfg, tr, device = cell.cfg, cell.traffic, cell.device
    s = inputs.seeds(cell.seed)
    shape = (1, cfg["num_channels"], cfg["resolution"], cfg["resolution"])
    with torch.device(device):  # init draws on the device, then replaced
        G = Generator(shape, inference_chain=True,
                      generator=torch.Generator(device=device),
                      **model_args(cfg, "G"))
    inputs.load_into(G, "G.", {k: v for k, v in inputs.weights(
        cfg, s["weights"], device).items() if k.startswith("G.")})
    n = tr["request_images"]

    def serve(i: int) -> np.ndarray:
        return sample_images(G, tr["depth"], tr["alpha"], n,
                             minibatch=tr["minibatch"],
                             rng=np.random.RandomState(
                                 request_seed(s["requests"], i)))

    for i in range(tr["warmup_requests"]):  # seeds the window never uses
        serve(WARMUP + i)
    cell.sync()
    cell.log("generator built and warmed")
    launches = tracing.LaunchLog()
    rng = np.random.RandomState(s["sample"])
    kept, latencies = {}, []
    t0 = time.perf_counter()
    cell.setup_s = t0 - cell.t0

    def window(count=None):
        i = 0
        while (i < count) if count is not None else (
                not latencies or time.perf_counter() - t0 < cell.seconds):
            a = time.perf_counter()
            out = serve(i)
            latencies.append(time.perf_counter() - a)
            # reservoir sampling: every request equally likely to be kept
            if len(kept) < tr["sampled_requests"]:
                kept[i] = out
            else:
                j = rng.randint(0, i + 1)
                if j < tr["sampled_requests"]:
                    kept.pop(sorted(kept)[j])
                    kept[i] = out
            i += 1
        return time.perf_counter() - t0

    if cell.trace:
        with launches.recording(graph=False), tracing.traced() as traced:
            window(tr["trace_requests"])
        elapsed = traced["trace"].window_s
    else:
        elapsed = window()
    cell.close_window()
    requests = len(latencies)
    cell.log(f"window closed: {requests} requests in {elapsed:.3f} s")
    cell.result.update(attempted=requests, failed=0)
    cell.metrics["serve_img_s"] = requests * n / elapsed
    cell.metrics["serve_request_ms_p95"] = 1e3 * float(
        np.percentile(latencies, 95))
    chunks = requests * -(-n // tr["minibatch"])
    cell.layer = dict(chunks=chunks, images=requests * n, launches=launches,
                      flops=yardstick.image_flops(cfg, tr["depth"],
                                                  tr["alpha"]) * requests * n,
                      window_s=elapsed)
    if cell.trace:
        cell.layer["trace"] = traced["trace"]
    del G
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cell.checks = compare(cell, kept, s)
    cell.log("reference compared")


def reference_images(cfg, tr, s, device, precision, requests) -> dict:
    """The reference's images for each of ``requests``."""
    net = pggan.Net(cfg, precision)
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        p = {k: v.to(net.dtype) for k, v in
             inputs.weights(cfg, s["weights"], device).items()
             if k.startswith("G.")}
        out = {}
        for i in requests:
            z = torch.from_numpy(pggan.latents(
                request_seed(s["requests"], i), tr["request_images"],
                cfg["latent_size"])).to(device, net.dtype)
            out[i] = pggan.sample(net, p, z, tr["depth"], tr["alpha"],
                                  tr["minibatch"]).cpu()
        return out
    finally:
        pggan.full_precision()


def image_gap(prog: dict, ref: dict) -> float:
    """The largest gap of a pixel over the sampled requests, as a share
    of the reference images' RMS."""
    worst = 0.0
    for i, r in ref.items():
        r = r.double()
        scale = float(r.square().mean().sqrt())
        gap = float((torch.from_numpy(prog[i]).double() - r).abs().max())
        worst = max(worst, gap / scale if scale > 0 else check.FAIL)
    return worst


def compare(cell, kept: dict, s: dict) -> list:
    ref = reference_images(cell.cfg, cell.traffic, s, cell.device,
                           check.REFERENCE, sorted(kept))
    checks = [("image_gap", image_gap(kept, ref), cell.limits["image_gap"])]
    if cell.study:
        cell.study_readings = {"program": {"image_gap": checks[0][1]}}
        for name, precision in (("float32", "float32"),
                                ("control_tf32", "tf32")):
            side = {i: v.numpy() for i, v in reference_images(
                cell.cfg, cell.traffic, s, cell.device, precision,
                sorted(kept)).items()}
            cell.study_readings[name] = {"image_gap": image_gap(side, ref)}
    return checks
