"""Chunked generator sampling on one device: the serving path
(counterpart of ``pggan_tpu/sampling.py``, without its mesh branch).

The request is consumed in fixed-size chunks, the last one padded with
zero latents to the same shape and sliced after the forward, so every
chunk runs the same shapes. A stable snapshot (alpha == 1) serves the
fade-free graph. Latents are drawn chunk by chunk from a numpy
``RandomState``, in the same order as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pggan_tpu_torch.utils.misc import random_latents


def disable_tf32() -> None:
    """Serve in full float32: cuDNN's convolutions default to TF32 on the
    card, which keeps about three decimal digits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sample_images(G, depth, alpha, num_samples, *, minibatch=0, rng=None):
    """Draw ``num_samples`` images from ``G`` as float32 NHWC numpy, on the
    device that holds G's parameters.

    ``minibatch=0`` generates everything in one forward; ``minibatch=k``
    serves fixed padded chunks of k. ``rng`` is a ``np.random.RandomState``
    (a fresh seed-0 one if None).
    """
    disable_tf32()
    if rng is None:
        rng = np.random.RandomState(0)
    if int(num_samples) <= 0:
        raise ValueError(f"num_samples must be positive, got {num_samples}")
    alpha = float(np.float32(alpha))
    fade = alpha < 1.0
    chunk = int(minibatch) if minibatch else int(num_samples)
    if chunk <= 0:
        raise ValueError(f"minibatch/num_samples must be positive, "
                         f"got chunk={chunk}")
    device = next(G.parameters()).device

    outs = []
    done = 0
    with torch.inference_mode():
        while done < num_samples:
            take = min(chunk, num_samples - done)
            z = random_latents(take, G.latent_size, rng)
            if take < chunk:  # fixed shapes: pad, run, slice
                z = np.concatenate(
                    [z, np.zeros((chunk - take, G.latent_size), z.dtype)])
            imgs = G(torch.from_numpy(z).to(device), depth, alpha, fade=fade)
            outs.append(imgs[:take].cpu().numpy())
            done += take
    return np.concatenate(outs) if len(outs) > 1 else outs[0]
