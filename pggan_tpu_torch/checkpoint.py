"""Model snapshots in the JAX package's file format, and training states
in the port's own.

A snapshot is the pickle that ``pggan_tpu/checkpoint.py:save_snapshot``
writes: the model class, its constructor config, the parameters as a
numpy tree with HWIO conv weights (``{"block0": {...}, "blocks": (...)}``),
and the depth and alpha it was saved at. One snapshot file therefore loads
in both packages; ``params_from_jax`` and ``params_to_jax`` convert the tree
to the port's OIHW tensors and back, exactly; ``d_params_from_jax`` and
``d_params_to_jax`` do the same for the Discriminator. File names follow the
reference layout ``network-snapshot-{generator|discriminator}-{kimg:06}.dat``.

A StyleGAN generator (``models/style.py``) has no JAX counterpart: its
snapshot (``model_class`` "StyleGenerator") holds its parameters and its
buffer ``w_avg`` as a flat dict of numpy arrays keyed by name, OIHW, and
a Discriminator with StyleGAN's options holds them in its config
(``discriminator.STYLE_FIELDS``, only where they differ from PGGAN's).

A training state (``training-state-{kimg:06}.dat``) holds what an exact
resume needs beyond the snapshots (``pggan_tpu/checkpoint.py:125-146``):
G's and D's parameters, both Adam states (``mu``, ``nu``, ``count``), the
G EMA, the state's ``torch.Generator`` state, and the trainer's clock. It is
the port's own pickle of plain dicts of numpy arrays keyed by parameter
name, with no torch class inside: ``framework: "pggan_tpu_torch"``. A G
with buffers (StyleGAN's ``w_avg``) adds them as ``G_buffers`` (and the
EMA's as ``g_ema_buffers``). A
data-parallel run's state also holds every rank's generator state
(``rank_generators``), so that each rank resumes its own latent stream;
rank 0 writes it, every rank reads it.
``training_state_from_jax`` converts a JAX package's training state to it.

``load_training_state`` reads both packages' training states without JAX:
a restricted unpickler admits numpy's arrays and maps the JAX state's two
container classes, ``pggan_tpu.training.state.TrainState`` and optax's
``ScaleByAdamState``, to local stand-ins; any other global is refused. A
JAX state is converted on load, so ``cli.train --resume_network`` resumes
a JAX run.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, NamedTuple

import numpy as np
import torch

from pggan_tpu_torch.models import discriminator, generator, style
from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.models.style import StyleGenerator

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


def flat_to_numpy(model) -> dict:
    """A model's parameters and buffers as numpy arrays keyed by name."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def flat_from_numpy(tree) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# model class -> (its module's constructor fields, params to and from the
# snapshot's tree: the JAX package's, or a flat one)
_MODELS = {
    "Generator": (Generator, generator.CONFIG_FIELDS, params_to_jax,
                  params_from_jax),
    "Discriminator": (Discriminator, discriminator.CONFIG_FIELDS,
                      d_params_to_jax, d_params_from_jax),
    "StyleGenerator": (StyleGenerator, style.CONFIG_FIELDS, flat_to_numpy,
                       flat_from_numpy),
}
SERVED = ("Generator", "StyleGenerator")


def model_config(model) -> dict:
    """Constructor kwargs for rebuilding a model, with ``latent_size``
    resolved (the JAX package's ``model_config``); a Discriminator's
    StyleGAN options where they differ from PGGAN's."""
    config = {f: getattr(model, f)
              for f in _MODELS[type(model).__name__][1]}
    if isinstance(model, Discriminator):
        config.update({f: getattr(model, f) for f, v in
                       discriminator.STYLE_FIELDS.items()
                       if getattr(model, f) != v})
    return config


def save_snapshot(path: str, model, depth: int, alpha: float) -> None:
    """A Generator or Discriminator snapshot, in the JAX package's format."""
    payload = {
        "framework": "pggan_tpu_torch",
        "format_version": 1,
        "model_class": type(model).__name__,
        "config": model_config(model),
        "params": _MODELS[type(model).__name__][2](model),
        "depth": int(depth),
        "alpha": float(alpha),
    }
    _atomic_dump(payload, path)


def load_model_snapshot(path: str, device=None):
    """Returns ``(model, meta)``: the Generator or Discriminator rebuilt from
    its saved config, with the saved parameters, on ``device``. Unpickles
    the file: load only snapshots you or your training runs wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    cls, _fields, _to_jax, from_jax = _MODELS[payload["model_class"]]
    model = cls(**payload["config"])
    model.load_state_dict(from_jax(payload["params"]))
    model.to(device)
    meta = {k: payload[k] for k in ("depth", "alpha", "model_class")}
    return model, meta


def load_snapshot(path: str, device=None):
    """``load_model_snapshot`` for a Generator snapshot, the serving path's
    model; other snapshots raise."""
    with open(path, "rb") as f:
        model_class = pickle.load(f)["model_class"]
    if model_class not in SERVED:
        raise ValueError(f"{path}: a {model_class} snapshot; serving loads "
                         "Generator snapshots only (PGGAN's or StyleGAN's)")
    return load_model_snapshot(path, device)


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


# -- training states ------------------------------------------------------------

def _numpy(module) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.named_parameters()}


def _buffers(module) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.named_buffers()}


def _adam(opt, module) -> dict:
    names = [k for k, _ in module.named_parameters()]
    return {"mu": {k: t.cpu().numpy().copy() for k, t in zip(names, opt.mu)},
            "nu": {k: t.cpu().numpy().copy() for k, t in zip(names, opt.nu)},
            "count": int(opt.count)}


def training_state_dict(state, rank_generators=None) -> dict:
    """A ``TrainState`` as plain dicts of numpy arrays keyed by parameter
    name (the payload's ``state``). ``rank_generators``: every rank's
    generator state (``parallel.gather_generator_states``) in a
    data-parallel run."""
    sd = {
        "G": _numpy(state.G), "D": _numpy(state.D),
        "g_opt": _adam(state.g_opt, state.G),
        "d_opt": _adam(state.d_opt, state.D),
        "g_ema": None if state.g_ema is None else _numpy(state.g_ema),
        "generator": state.generator.get_state().numpy().copy(),
    }
    if rank_generators is not None:
        sd["rank_generators"] = [g.numpy().copy() for g in rank_generators]
    if _buffers(state.G):
        sd["G_buffers"] = _buffers(state.G)
        if state.g_ema is not None:
            sd["g_ema_buffers"] = _buffers(state.g_ema)
    return sd


@torch.no_grad()
def restore_training_state(state, sd: dict, group=None) -> None:
    """Copy a ``training_state_dict`` into ``state``'s tensors in place,
    bit for bit. A G EMA in ``sd`` goes into ``state.g_ema`` when the state
    keeps one. ``sd["generator"]`` None leaves the generator as it is.
    Under ``group`` (a ``parallel.Group``) each rank takes its own
    generator state from a state saved by as many ranks; otherwise rank 0
    takes ``sd["generator"]`` and the other ranks keep their seeded
    generators."""
    def load(module, arrays):
        for k, p in module.named_parameters():
            p.copy_(torch.from_numpy(arrays[k]))

    def load_opt(opt, module, d):
        for name, mu, nu in zip([k for k, _ in module.named_parameters()],
                                opt.mu, opt.nu):
            mu.copy_(torch.from_numpy(d["mu"][name]))
            nu.copy_(torch.from_numpy(d["nu"][name]))
        opt.count.fill_(int(d["count"]))

    def load_buffers(module, arrays):
        for k, b in module.named_buffers():
            b.copy_(torch.from_numpy(arrays[k]))

    load(state.G, sd["G"])
    load(state.D, sd["D"])
    if sd.get("G_buffers") is not None:
        load_buffers(state.G, sd["G_buffers"])
    if state.g_ema is not None and sd.get("g_ema_buffers") is not None:
        load_buffers(state.g_ema, sd["g_ema_buffers"])
    load_opt(state.g_opt, state.G, sd["g_opt"])
    load_opt(state.d_opt, state.D, sd["d_opt"])
    if state.g_ema is not None and sd.get("g_ema") is not None:
        load(state.g_ema, sd["g_ema"])
    rank = 0 if group is None else group.rank
    ranks = sd.get("rank_generators")
    if group is not None and ranks is not None \
            and len(ranks) == group.world_size:
        state.generator.set_state(torch.from_numpy(ranks[rank]))
    elif rank == 0 and sd.get("generator") is not None:
        state.generator.set_state(torch.from_numpy(sd["generator"]))


def save_training_state(path: str, state, cur_nimg: int, iterations: int,
                        base_time: float = 0.0,
                        rank_generators=None) -> None:
    payload = {
        "framework": "pggan_tpu_torch",
        "format_version": 1,
        "state": training_state_dict(state, rank_generators),
        "cur_nimg": int(cur_nimg),
        "iterations": int(iterations),
        "base_time": float(base_time),
    }
    _atomic_dump(payload, path)


class JaxTrainState(NamedTuple):
    """Stand-in for ``pggan_tpu.training.state.TrainState`` (its fields and
    default; a state pickled before ``g_ema`` existed has five values)."""
    g_params: Any
    d_params: Any
    g_opt: Any
    d_opt: Any
    rng: Any
    g_ema: Any = None


class JaxAdamState(NamedTuple):
    """Stand-in for optax's ``ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


# the globals a training state may name: numpy's array reconstruction
# (its module as numpy 2 and numpy 1 spell it; the function is the one an
# array pickles with here) and the JAX state's containers, as the JAX
# package's ``save_training_state`` pickles them
_reconstruct = np.zeros(0).__reduce__()[0]
_STATE_GLOBALS = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("pggan_tpu.training.state", "TrainState"): JaxTrainState,
    ("optax._src.transform", "ScaleByAdamState"): JaxAdamState,
}


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return _STATE_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"a training state may not name {module}.{name}") from None


def load_training_state(path: str):
    """Returns ``(state dict, cur_nimg, iterations, base_time)``, as the JAX
    package's ``load_training_state`` does; ``base_time`` is the run's
    cumulative wall-clock seconds at the save, for ``AbsoluteTimeMonitor``.
    Reads the port's states and the JAX package's (converted by
    ``training_state_from_jax``) through a restricted unpickler that
    refuses any global but numpy's arrays and the JAX state's containers;
    neither JAX nor optax is needed."""
    with open(path, "rb") as f:
        payload = _StateUnpickler(f).load()
    framework = payload.get("framework")
    if framework == "pggan_tpu":
        state = training_state_from_jax(payload["state"])
    elif framework == "pggan_tpu_torch":
        state = payload["state"]
    else:
        raise ValueError(f"{path}: not a training state of pggan_tpu_torch "
                         f"or pggan_tpu (framework {framework!r})")
    return (state, payload["cur_nimg"], payload["iterations"],
            float(payload.get("base_time", 0.0)))


def training_state_from_jax(jstate) -> dict:
    """A JAX package's ``TrainState`` (its leaves as numpy arrays: the
    params trees, optax ``ScaleByAdamState(count, mu, nu)`` for each
    optimizer, the PRNG key, the optional G EMA) as the port's training
    state dict. The moments convert like the parameters they belong to. The
    JAX threefry key has no Philox counterpart: ``generator`` is None, so
    ``restore_training_state`` keeps the port's seeded generator, and the
    two packages draw different latents from there on."""
    def as_np(tree):
        return {k: v.numpy() for k, v in tree.items()}

    def opt(o, from_jax):
        return {"mu": as_np(from_jax(o.mu)), "nu": as_np(from_jax(o.nu)),
                "count": int(np.asarray(o.count))}

    return {
        "G": as_np(params_from_jax(jstate.g_params)),
        "D": as_np(d_params_from_jax(jstate.d_params)),
        "g_opt": opt(jstate.g_opt, params_from_jax),
        "d_opt": opt(jstate.d_opt, d_params_from_jax),
        "g_ema": (None if getattr(jstate, "g_ema", None) is None
                  else as_np(params_from_jax(jstate.g_ema))),
        "generator": None,
    }
