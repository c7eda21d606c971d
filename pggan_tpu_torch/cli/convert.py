"""Convert a reference (deepsound-project/pggan-pytorch) snapshot into the
shared snapshot format, with the port alone: the counterpart of
``scripts/convert_torch_snapshot.py``.

The reference checkpoints entire live ``nn.Module`` objects with
``torch.save`` (reference plugins.py:158-166, resumed at train.py:60-64);
those pickles are bound to the reference's code tree. This tool unpickles
the module (with the reference source directory on ``sys.path``, so that
``network.Generator`` and the rest resolve), takes its weights into the
port's ``Generator`` or ``Discriminator`` and writes them with
``checkpoint.save_snapshot``: a snapshot that both packages' train
(``--resume_network``), generate and eval CLIs load.

    python -m pggan_tpu_torch.cli.convert \\
        --torch_snapshot results/000-exp/network-snapshot-generator-001200.dat \\
        --reference_dir /path/to/pggan-pytorch \\
        --out network-snapshot-generator-001200.dat

Exactness: the reference's equalized-LR constant is the *empirical* RMS of
the kaiming init (``c = sqrt(mean(w**2))``, reference network.py:19); the
snapshot format uses the closed-form He constant. Each layer's saved ``c``
is folded into its weight (``w * c / he``), so the converted network's
forward is the torch module's. Layouts: the module's conv weights are OIHW,
the snapshot's HWIO; ``nn.Linear`` is (out, in), the snapshot's dense
weight (in, out). fmap_base and fmap_max are inferred from the channel
schedule (exact for fmap_decay 1.0, the reference default; otherwise a
warning is printed: the parameters stay exact, the config is approximate).

Conversion is a file transform: it runs on the host, with no device.
``torch.load`` unpickles the module: convert only files you trust.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from pggan_tpu_torch.checkpoint import (
    d_params_from_jax,
    params_from_jax,
    save_snapshot,
)
from pggan_tpu_torch.models import Discriminator, Generator


def _he(fan_in: int) -> float:
    return math.sqrt(2.0) / math.sqrt(fan_in)


def _conv_params(pgconv) -> dict:
    """A reference PGConv2d as ``{'w': HWIO, 'b': (out,)}``, its empirical
    wscale constant folded in (see the module docstring)."""
    w = pgconv.conv.weight.detach().cpu().numpy()  # (out, in, kh, kw)
    b = pgconv.conv.bias.detach().cpu().numpy()
    c = float(pgconv.c)
    kh, kw, ch_in = w.shape[2], w.shape[3], w.shape[1]
    scale = c / _he(kh * kw * ch_in)
    return {"w": np.ascontiguousarray(
        w.transpose(2, 3, 1, 0) * np.float32(scale)),
        "b": np.ascontiguousarray(b)}


def _is_lrelu(pgconv) -> bool:
    return type(getattr(pgconv, "act", None)).__name__ == "LeakyReLU"


def _infer_fmaps(ch_by_stage: dict) -> tuple[int, int, bool]:
    """``(fmap_base, fmap_max, exact)`` backed out of the channels of each
    stage, with the reference default fmap_decay 1.0 (``nf(s) =
    min(fmap_base / 2**s, fmap_max)``, reference network.py:94-95)."""
    fmap_max = max(ch_by_stage.values())
    below = [c * 2 ** s for s, c in ch_by_stage.items() if c < fmap_max]
    fmap_base = max(below) if below else fmap_max
    exact = all(min(int(fmap_base / 2.0 ** s), fmap_max) == c
                for s, c in ch_by_stage.items())
    return fmap_base, fmap_max, exact


def _warn_inexact(exact: bool) -> None:
    if not exact:
        print("WARNING: channel schedule does not match fmap_decay=1.0; "
              "converted params are exact but the snapshot's fmap_base/"
              "fmap_max metadata is approximate", file=sys.stderr)


def convert_generator(module) -> Generator:
    """A reference Generator (network.py:75-139) as the port's."""
    blocks = list(module.blocks)
    R = len(blocks) + 2
    num_channels = module.block0.toRGB.conv.out_channels
    ch = {1: module.block0.c2.conv.out_channels}
    for j, b in enumerate(blocks):
        ch[j + 2] = b.c2.conv.out_channels
    fmap_base, fmap_max, exact = _infer_fmaps(ch)
    _warn_inexact(exact)
    G = Generator(
        (1, num_channels, 2 ** R, 2 ** R),
        fmap_base=fmap_base, fmap_max=fmap_max,
        latent_size=int(module.latent_size),
        normalize_latents=bool(getattr(module, "normalize_latents", True)),
        wscale=True,  # the constant is folded into the weights either way
        pixelnorm=bool(module.block0.c1.pixelnorm),
        leakyrelu=_is_lrelu(module.block0.c1))
    tree = {
        "block0": {"c1": _conv_params(module.block0.c1),
                   "c2": _conv_params(module.block0.c2),
                   "torgb": _conv_params(module.block0.toRGB)},
        "blocks": tuple(
            {"c1": _conv_params(b.c1), "c2": _conv_params(b.c2),
             "torgb": _conv_params(b.toRGB)} for b in blocks),
    }
    G.load_state_dict(params_from_jax(tree))
    return G


def convert_discriminator(module) -> Discriminator:
    """A reference Discriminator (network.py:190-240) as the port's."""
    blocks = list(module.blocks)
    R = len(blocks) + 1
    num_channels = blocks[0].fromRGB.conv.in_channels
    # the blocks run stage R-1 .. 2 (DBlock), then the 4x4 DLastBlock
    ch = {0: blocks[-1].c2.conv.out_channels,
          1: blocks[-1].c1.conv.out_channels}
    for j, b in enumerate(blocks[:-1]):
        ch[R - 1 - j] = b.c1.conv.in_channels
    fmap_base, fmap_max, exact = _infer_fmaps(ch)
    _warn_inexact(exact)
    D = Discriminator(
        (1, num_channels, 2 ** R, 2 ** R),
        fmap_base=fmap_base, fmap_max=fmap_max, wscale=True,
        pixelnorm=bool(blocks[0].c1.pixelnorm),
        leakyrelu=_is_lrelu(blocks[0].c1))
    tree = {
        "blocks": tuple(
            {"fromrgb": _conv_params(b.fromRGB), "c1": _conv_params(b.c1),
             "c2": _conv_params(b.c2)} for b in blocks),
        "linear": {
            "w": np.ascontiguousarray(
                module.linear.weight.detach().cpu().numpy().T),
            "b": np.ascontiguousarray(
                module.linear.bias.detach().cpu().numpy())},
    }
    D.load_state_dict(d_params_from_jax(tree))
    return D


def convert(torch_snapshot: str, out: str,
            reference_dir: str | None = None) -> str:
    """Load the reference's pickle and write the snapshot; returns the kind
    of model found, ``generator`` or ``discriminator``."""
    if reference_dir:
        sys.path.insert(0, reference_dir)
    try:
        module = torch.load(torch_snapshot, map_location="cpu",
                            weights_only=False)
    finally:
        if reference_dir:
            sys.path.remove(reference_dir)
    kind = type(module).__name__.lower()
    if "generator" in kind:
        model, kind = convert_generator(module), "generator"
    elif "discriminator" in kind:
        model, kind = convert_discriminator(module), "discriminator"
    else:
        raise SystemExit(f"unrecognized module class {type(module).__name__};"
                         f" expected the reference Generator/Discriminator")
    depth = int(getattr(module, "depth", 0))
    alpha = float(getattr(module, "alpha", 1.0))
    save_snapshot(out, model, depth, alpha)
    print(f"Converted {kind} (depth {depth}, alpha {alpha}) -> {out}")
    return kind


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_snapshot", required=True,
                   help="reference network-snapshot-*.dat (torch pickle)")
    p.add_argument("--out", required=True, help="output snapshot path")
    p.add_argument("--reference_dir", default="",
                   help="directory containing the reference's network.py "
                        "(needed to unpickle its module classes)")
    args = p.parse_args(argv)
    convert(args.torch_snapshot, args.out, args.reference_dir or None)


if __name__ == "__main__":
    main()
