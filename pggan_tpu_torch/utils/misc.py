"""Shared helpers (reference utils.py) that the serving path needs:
dynamic-range remap, nearest upsampling for exports, latent sampling. The
same code as ``pggan_tpu/utils/misc.py``, so both packages draw identical
latents from one ``np.random.RandomState``."""

from __future__ import annotations

import numpy as np


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
