"""The yardstick: the card's peaks, the operations and bytes of a kernel
call counted from its shapes, the least time they allow, and the model
FLOPs of a train step and of a served image.

A kernel's work is counted as the bring-up's roofline counted it: a
multiply-add is two FLOPs, every input element is read once and every
output element written once, in float32. Its bound is the larger of its
bytes over the memory rate and its FLOPs over the dense TF32 rate, the
fastest any route that keeps float32 inputs can go on this card. The model
FLOPs are those of the plain reference's own step, counted by
``torch.utils.flop_counter`` on the meta device (no memory, no compute):
convolutions and matrix products, forward, backward and the gradient
penalty's double backward.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_TF32_FLOP_S = 495e12
PEAK_HBM_BYTES_S = 3.35e12

# Where a kernel call's sizes sit among the arguments of its C entry point
# (after the device, before the stream the launch appends), and how many
# arguments the entry point takes: a call of another arity is not counted.
ENTRY_DIMS = {
    # x, w, b, y, r, N, H, C, W, K, KT, epi, slope, eps
    "pggan_conv3x3": (14, {"n": 5, "h": 6, "c": 7, "w": 8, "k": 9}),
    # x, ct, ws, dw, N, H, C, W, K, KT, CC, rows, chunks, col_tiles
    "pggan_conv3x3_dw": (14, {"n": 4, "h": 5, "c": 6, "w": 7, "k": 8}),
    # x, w1, b1, w2, b2, y, N, H, C, W, Wp, K1, K2, KT, L, pn, slope, eps
    "pggan_conv3x3_chain": (18, {"n": 6, "h": 7, "c": 8, "w": 9, "k1": 11,
                                 "k2": 12}),
}


def call_dims(fn: str, args: tuple) -> dict | None:
    """The sizes of one launch of C entry point ``fn``, or None."""
    entry = ENTRY_DIMS.get(fn)
    if entry is None or len(args) != entry[0]:
        return None
    dims = {k: args[i] for k, i in entry[1].items()}
    if not all(isinstance(v, int) and v > 0 for v in dims.values()):
        return None
    return dims


def work(name: str, fn: str, dims: dict) -> tuple:
    """(FLOPs, bytes) of one call of kernel mode ``name`` (the name the
    program counts it under) through entry point ``fn``."""
    if fn == "pggan_conv3x3":
        n, h, c, w, k = (dims[x] for x in "nhcwk")
        bias = name != "conv3x3"
        read = n * h * c * w + 9 * c * k + (k if bias else 0)
        out = n * h * k * w + (n * h * w if name == "conv3x3_act_pn" else 0)
        return 2 * n * h * w * 9 * c * k, 4 * (read + out)
    if fn == "pggan_conv3x3_dw":
        n, h, c, w, k = (dims[x] for x in "nhcwk")
        return 2 * n * h * w * 9 * c * k, 4 * (n * h * (c + k) * w + 9 * c * k)
    if fn == "pggan_conv3x3_chain":
        n, h, c, w = (dims[x] for x in "nhcw")
        k1, k2 = dims["k1"], dims["k2"]
        read = n * h * c * w + 9 * c * k1 + k1 + 9 * k1 * k2 + k2
        return (2 * n * h * w * 9 * (c * k1 + k1 * k2),
                4 * (read + n * h * k2 * w))
    raise KeyError(fn)


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for this work."""
    return max(flops / PEAK_TF32_FLOP_S, nbytes / PEAK_HBM_BYTES_S)


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta_params(cfg: dict) -> dict:
    from portbench.reference import pggan
    return {name: torch.zeros(shape, device="meta")
            for name, shape, _ in pggan.layers(cfg)}


def step_flops(cfg: dict, depth: int, batch: int, fade: bool,
               hp: dict) -> int:
    """Model FLOPs of one train step of the plain reference."""
    from portbench.reference import pggan
    net, p = pggan.Net(cfg, "float32"), _meta_params(cfg)
    res = 4 * 2 ** depth
    reals = torch.zeros((batch, res, res, cfg["num_channels"]), device="meta")
    lat = (batch, cfg["latent_size"])
    noise = (torch.zeros(lat, device="meta"),
             torch.zeros((batch,), device="meta"),
             torch.zeros(lat, device="meta"))
    return _count(lambda: pggan.train_step(
        net, p, pggan.Adam(p), pggan.Adam(p), reals, noise, depth, 0.5, fade,
        1e-3, 1e-3, hp))


def image_flops(cfg: dict, depth: int, alpha: float) -> int:
    """Model FLOPs of G's forward for one image."""
    from portbench.reference import pggan
    net = pggan.Net(cfg, "float32")
    p = _meta_params(cfg)
    z = torch.zeros((1, cfg["latent_size"]), device="meta")
    return _count(lambda: net.G(p, z, depth, alpha, alpha < 1.0))
