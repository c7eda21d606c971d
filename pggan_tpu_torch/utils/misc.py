"""Shared helpers (reference utils.py): dynamic-range remap, nearest
upsampling for exports, latent sampling, sample generation, pickles,
result directories and the config dump. The same code as
``pggan_tpu/utils/misc.py``, so both packages draw identical latents from
one ``np.random.RandomState``; its ``enable_persistent_compilation_cache``
is JAX's, and the kernels' nvcc build cache (``ops/_build.py``) plays its
part here."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def adjust_dynamic_range(data, range_in, range_out):
    """Linear remap from ``range_in`` to ``range_out`` (reference
    utils.py:24-30); identity when the ranges already match."""
    if tuple(range_in) != tuple(range_out):
        (min_in, max_in) = range_in
        (min_out, max_out) = range_out
        scale = (max_out - min_out) / (max_in - min_in)
        data = (data - min_in) * scale + min_out
    return data


def numpy_upsample_nearest(x: np.ndarray, n_last_dims: int, size=None,
                           scale_factor=None) -> np.ndarray:
    """Nearest-neighbour upsample of the trailing ``n_last_dims`` dims by
    integer factors (reference utils.py:33-53). ``size`` must be an integer
    multiple of the current shape."""
    shape = x.shape[-n_last_dims:]
    if size is not None:
        if isinstance(size, int):
            size = (size,) * n_last_dims
        for cur, tgt in zip(shape, size):
            if tgt % cur != 0:
                raise ValueError(f"incompatible sizes: {x.shape} -> {size}")
        scale_factor = tuple(t // c for c, t in zip(shape, size))
    if scale_factor is None:
        raise ValueError("either size or scale_factor must be specified")
    if isinstance(scale_factor, int):
        scale_factor = (scale_factor,) * n_last_dims
    for i, s in enumerate(scale_factor):
        if s > 1:
            x = x.repeat(s, axis=x.ndim - n_last_dims + i)
    return x


def random_latents(num_latents: int, latent_size: int,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """Standard-normal latents (reference utils.py:56-57)."""
    gen = rng if rng is not None else np.random
    return gen.randn(num_latents, latent_size).astype(np.float32)


def generate_samples(model, gen_input, depth, alpha) -> np.ndarray:
    """Run the generator and return NCHW numpy (the reference's
    ``generate_samples`` contract, utils.py:8-11: forward -> cpu numpy).
    The model holds its parameters, so there is no ``params`` argument."""
    device = next(model.parameters()).device
    z = torch.from_numpy(np.asarray(gen_input, np.float32)).to(device)
    with torch.no_grad():
        out = model(z, depth, alpha)
    return out.cpu().numpy().transpose(0, 3, 1, 2)


def save_pkl(fname, obj):
    with open(fname, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(fname):
    """Unpickles ``fname``: load only files you or your runs wrote."""
    with open(fname, "rb") as f:
        return pickle.load(f)


def create_result_subdir(results_dir: str, experiment_name: str,
                         dir_pattern: str = "{new_num:03}-{exp_name}") -> str:
    """Auto-numbered ``NNN-expname`` result directory (reference
    utils.py:60-71)."""
    os.makedirs(results_dir, exist_ok=True)
    nums = []
    for name in os.listdir(results_dir):
        prefix = name.split("-")[0]
        if prefix.isdigit():
            nums.append(int(prefix))
    path = os.path.join(results_dir, dir_pattern.format(
        new_num=max(nums, default=0) + 1, exp_name=experiment_name))
    os.makedirs(path, exist_ok=False)
    return path


def params_to_str(params: dict) -> str:
    """Readable dump of the full config (reference utils.py:122-126)."""
    lines = ["{"]
    for k, v in params.items():
        lines.append(f"\t'{k}': {v!r},")
    lines.append("}")
    return "\n".join(lines)
