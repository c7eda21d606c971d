"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the reals' items, the seeds of the random draws and of the
requests.

Every draw comes from a seed derived from ``--seed`` by ``numpy``'s
``SeedSequence`` (any whole number, however large), one for each use, so
that the same seed gives the same inputs and two uses never share a
stream. Weights are drawn on the device in two calls (every equalized-LR
weight from one normal draw, every bias and the linear layer from one
uniform draw) and cut into the parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import pggan

USES = ("weights", "state", "items", "loader", "requests", "sample")


def seeds(seed: int) -> dict:
    """A 31-bit seed for each of ``USES``, derived from ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(USES))
    return {u: int(w) & 0x7FFFFFFF for u, w in zip(USES, words)}


def weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter of ``pggan.layers(cfg)``, float32 on ``device``."""
    spec = pggan.layers(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, init in spec if init == "normal")
    n_unif = sum(math.prod(s) for _, s, init in spec if init != "normal")
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for name, shape, init in spec:
        size = math.prod(shape)
        if init == "normal":
            out[name] = normal[i:i + size].view(shape)
            i += size
        else:
            out[name] = unif[j:j + size].view(shape) * init
            j += size
    return out


def load_into(module: torch.nn.Module, prefix: str, params: dict) -> None:
    """Copy ``params[prefix + name]`` into each parameter of ``module``;
    the two sets of names and shapes must agree."""
    own = dict(module.named_parameters())
    theirs = {k[len(prefix):]: v for k, v in params.items()
              if k.startswith(prefix)}
    if set(own) != set(theirs):
        raise ValueError(f"{prefix}: parameters {sorted(set(own) ^ set(theirs))}"
                         " on one side only")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != tuple(theirs[name].shape):
                raise ValueError(f"{prefix}{name}: {tuple(p.shape)} against "
                                 f"{tuple(theirs[name].shape)}")
            p.copy_(theirs[name])


def items(cfg: dict, res: int, n: int, seed: int) -> np.ndarray:
    """``n`` uint8 NHWC images at ``res`` px: the synthetic reals."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, res, res, cfg["num_channels"]),
                        dtype=np.uint8)
