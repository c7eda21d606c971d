"""Generator snapshots, in the JAX package's file format.

A snapshot is the pickle that ``pggan_tpu/checkpoint.py:save_snapshot``
writes: the model class, its constructor config, the parameters as a
numpy tree with HWIO conv weights (``{"block0": {...}, "blocks": (...)}``),
and the depth and alpha it was saved at. One snapshot file therefore loads
in both packages; ``params_from_jax`` and ``params_to_jax`` convert the tree
to the port's OIHW tensors and back, exactly; ``d_params_from_jax`` and
``d_params_to_jax`` do the same for the Discriminator. File names follow the
reference layout ``network-snapshot-{generator|discriminator}-{kimg:06}.dat``.
The training-state half of the JAX module comes with the training port.
"""

from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np
import torch

from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import CONFIG_FIELDS, Generator

_LAYERS = ("c1", "c2", "torgb")
_D_LAYERS = ("fromrgb", "c1", "c2")


def _atomic_dump(payload, path: str) -> None:
    """Write-then-rename, so a crash mid-pickle never leaves a truncated
    snapshot at the final name."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def _block_from_jax(prefix, p, layers) -> dict:
    """One block's layers as ``state_dict`` entries: HWIO -> OIHW."""
    out = {}
    for layer in layers:
        w = np.asarray(p[layer]["w"])
        out[f"{prefix}.{layer}.w"] = torch.from_numpy(
            np.array(w.transpose(3, 2, 0, 1), order="C"))
        out[f"{prefix}.{layer}.b"] = torch.from_numpy(np.array(p[layer]["b"]))
    return out


def _block_to_jax(b, layers) -> dict:
    """One block's layers as the JAX tree's numpy leaves: OIHW -> HWIO."""
    return {layer: {
        "w": np.ascontiguousarray(
            b[layer]["w"].detach().cpu().numpy().transpose(2, 3, 1, 0)),
        "b": b[layer]["b"].detach().cpu().numpy().copy()}
        for layer in layers}


def params_from_jax(tree) -> dict:
    """The JAX params tree (numpy, HWIO conv weights) as a ``state_dict``
    for the port's ``Generator``: OIHW float32 CPU tensors."""
    sd = _block_from_jax("block0", tree["block0"], _LAYERS)
    for i, p in enumerate(tree["blocks"]):
        sd.update(_block_from_jax(f"blocks.{i}", p, _LAYERS))
    return sd


def params_to_jax(G: Generator) -> dict:
    """The port's parameters as the JAX params tree: numpy, HWIO."""
    return {"block0": _block_to_jax(G.block0, _LAYERS),
            "blocks": tuple(_block_to_jax(b, _LAYERS) for b in G.blocks)}


def d_params_from_jax(tree) -> dict:
    """The JAX Discriminator's params tree as a ``state_dict`` for the
    port's ``Discriminator``: OIHW conv weights, and the dense weight
    transposed from (in, out) to (out, in)."""
    sd = {}
    for i, p in enumerate(tree["blocks"]):
        sd.update(_block_from_jax(f"blocks.{i}", p, _D_LAYERS))
    lin = tree["linear"]
    sd["linear.w"] = torch.from_numpy(np.array(np.asarray(lin["w"]).T,
                                               order="C"))
    sd["linear.b"] = torch.from_numpy(np.array(lin["b"]))
    return sd


def d_params_to_jax(D: Discriminator) -> dict:
    """The port's Discriminator parameters as the JAX params tree."""
    return {"blocks": tuple(_block_to_jax(b, _D_LAYERS) for b in D.blocks),
            "linear": {
                "w": np.ascontiguousarray(
                    D.linear["w"].detach().cpu().numpy().T),
                "b": D.linear["b"].detach().cpu().numpy().copy()}}


def model_config(model: Generator) -> dict:
    """Constructor kwargs for rebuilding a Generator, with ``latent_size``
    resolved (the JAX package's ``model_config``)."""
    return {f: getattr(model, f) for f in CONFIG_FIELDS}


def save_snapshot(path: str, model: Generator, depth: int,
                  alpha: float) -> None:
    payload = {
        "framework": "pggan_tpu_torch",
        "format_version": 1,
        "model_class": type(model).__name__,
        "config": model_config(model),
        "params": params_to_jax(model),
        "depth": int(depth),
        "alpha": float(alpha),
    }
    _atomic_dump(payload, path)


def load_snapshot(path: str, device=None):
    """Returns ``(model, meta)``: the Generator rebuilt from its saved
    config, with the saved parameters, on ``device``. Only generator
    snapshots load in this slice of the port. Unpickles the file: load only
    snapshots you or your training runs wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload["model_class"] != "Generator":
        raise ValueError(f"{path}: a {payload['model_class']} snapshot; the "
                         "port loads Generator snapshots only")
    model = Generator(**payload["config"])
    model.load_state_dict(params_from_jax(payload["params"]))
    model.to(device)
    meta = {k: payload[k] for k in ("depth", "alpha", "model_class")}
    return model, meta


def snapshot_kimg(path: str) -> int:
    """kimg encoded in a snapshot filename; -1 when absent."""
    m = re.search(r"-(\d+)\.dat$", path)
    return int(m.group(1)) if m else -1


def ema_twin(path: str) -> str | None:
    """Path of the ``generator-ema`` twin of a plain generator snapshot if
    one exists on disk, else None."""
    ema = path.replace("network-snapshot-generator-",
                       "network-snapshot-generator-ema-")
    return ema if ema != path and os.path.exists(ema) else None


def resolve_generator_path(path: str, result_dir: str = "results",
                           prefer_ema: bool = True) -> str:
    """Resolve ``--generator_path latest``: the newest run directory under
    ``result_dir`` (by snapshot mtime), then the highest kimg inside it,
    then its ``generator-ema`` twin when one exists and ``prefer_ema``.
    Other paths pass through unchanged."""
    if path != "latest":
        return path
    cands = [p for p in glob.glob(
        os.path.join(result_dir, "**", "network-snapshot-generator-*.dat"),
        recursive=True) if "-generator-ema-" not in p]
    if not cands:
        raise SystemExit(f"--generator_path latest: no generator snapshots "
                         f"under {result_dir}")
    by_dir = {}
    for p in cands:
        by_dir.setdefault(os.path.dirname(p), []).append(p)
    run_dir = max(by_dir, key=lambda d: max(map(os.path.getmtime, by_dir[d])))
    best = max(by_dir[run_dir], key=snapshot_kimg)
    if prefer_ema:
        ema = ema_twin(best)
        if ema:
            return ema
    return best
