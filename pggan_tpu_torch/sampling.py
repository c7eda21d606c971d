"""Chunked generator sampling on one device: the serving path
(counterpart of ``pggan_tpu/sampling.py``, without its mesh branch).

The request is consumed in fixed-size chunks, the last one padded with
zero latents to the same shape and sliced after the forward, so every
chunk runs the same shapes. A stable snapshot (alpha == 1) serves the
fade-free graph. Latents are drawn chunk by chunk from a numpy
``RandomState``, in the same order as the JAX package.

On the card each chunk's images go to the host by an asynchronous copy
into one of two pinned buffers, and the host waits for that copy only
after it has issued the next chunk's forward, so the copy and the host's
work overlap the card's; a copy from the device into pageable memory
would hold the host until it ended. On the CPU there is no copy to pin and
the chunks are taken as they come.
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

    def forwards():
        """(images on the device, how many of them to keep) per chunk."""
        done = 0
        while done < num_samples:
            take = min(chunk, num_samples - done)
            z = random_latents(take, G.latent_size, rng)
            if take < chunk:  # fixed shapes: pad, run, slice
                z = np.concatenate(
                    [z, np.zeros((chunk - take, G.latent_size), z.dtype)])
            # non_blocking: a blocking upload would wait for the card
            z = torch.from_numpy(z).to(device, non_blocking=True)
            yield G(z, depth, alpha, fade=fade), take
            done += take

    with torch.inference_mode():
        if device.type != "cuda":
            outs = [imgs[:take].cpu().numpy() for imgs, take in forwards()]
            return np.concatenate(outs) if len(outs) > 1 else outs[0]
        return _pinned_gather(forwards(), num_samples)


def _pinned_gather(chunks, num_samples: int) -> np.ndarray:
    """Copy each chunk's images into the host array through two pinned
    buffers. Chunk i's copy is issued behind its forward; then the host
    waits for chunk i - 1's copy and moves it into the result. So chunk
    i + 1's forward is issued before the host waits for chunk i's copy, and
    a buffer is written again only after its last copy was moved out."""
    out = pinned = prev = None
    row = 0
    for i, (imgs, take) in enumerate(chunks):
        if out is None:
            out = np.empty((num_samples, *imgs.shape[1:]), np.float32)
            pinned = [torch.empty(imgs.shape, dtype=imgs.dtype,
                                  pin_memory=True) for _ in range(2)]
        buf = pinned[i % 2]
        buf[:take].copy_(imgs[:take], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        if prev is not None:
            _drain(out, *prev)
        prev = (event, buf, take, row)
        row += take
    _drain(out, *prev)
    return out


def _drain(out, event, buf, take, row) -> None:
    """Wait for one chunk's copy and move it into rows ``row:row+take``."""
    event.synchronize()
    out[row:row + take] = buf[:take].numpy()
