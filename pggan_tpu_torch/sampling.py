"""Chunked generator sampling over one or several devices: the serving
path (counterpart of ``pggan_tpu/sampling.py``).

The request is consumed in fixed-size chunks, the last one padded with
zero latents to the same shape and sliced after the forward, so every
chunk runs the same shapes. A stable snapshot (alpha == 1) serves the
fade-free graph. Latents are drawn chunk by chunk from a numpy
``RandomState``, in the same order as the JAX package.

Over several devices (the JAX package's mesh branch,
``pggan_tpu/sampling.py:58-75``: one process over all local devices) G is
replicated onto each device, the chunk is padded up to a multiple of the
device count, and each device runs its equal slice of every chunk: the
forwards of a chunk are issued on all devices before the host waits for
any of them. G couples no samples, so the split changes no image beyond
the float reassociation of another batch size.

On the card each chunk's images go to the host by an asynchronous copy
into one of two pinned buffers, and the host waits for that copy only
after it has issued the next chunk's forward, so the copy and the host's
work overlap the card's; a copy from the device into pageable memory
would hold the host until it ended. On the CPU there is no copy to pin and
the chunks are taken as they come.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pggan_tpu_torch.utils.misc import random_latents
from pggan_tpu_torch.utils.profiling import span


def disable_tf32() -> None:
    """Serve in full float32: cuDNN's convolutions default to TF32 on the
    card, which keeps about three decimal digits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _device(d) -> torch.device:
    """``d`` as a device with its index (the current card for ``cuda``)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def sample_images(G, depth, alpha, num_samples, *, minibatch=0, rng=None,
                  devices=None, truncation_psi=None):
    """Draw ``num_samples`` images from ``G`` as float32 NHWC numpy.

    ``minibatch=0`` generates everything in one forward; ``minibatch=k``
    serves fixed padded chunks of k, each padded up to a multiple of the
    device count. ``rng`` is a ``np.random.RandomState`` (a fresh seed-0
    one if None). ``devices``: where the chunks' slices run, in order, one
    replica of G each (a device may repeat: two replicas on one card); by
    default every visible card when G is on one, else G's device.
    ``truncation_psi``: a StyleGAN G's truncation (None: the model's own,
    ``StyleGenerator.truncation_psi``; 1: none); a PGGAN G takes none. A
    StyleGAN G draws its noise images from the device's default
    generator.
    """
    with span("sample.request"):
        return _sample(G, depth, alpha, num_samples, minibatch, rng, devices,
                       truncation_psi)


def _sample(G, depth, alpha, num_samples, minibatch, rng, devices,
            truncation_psi=None):
    kw = {}
    if truncation_psi is not None:
        if not hasattr(G, "truncation_psi"):
            raise ValueError("truncation_psi is StyleGAN's; this G has none")
        kw["truncation_psi"] = float(truncation_psi)
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
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
    devices = [_device(d) for d in devices]
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"devices of one type, got {devices}")
    per = -(-chunk // len(devices))  # each device's slice of a chunk
    # one replica a device entry; the first entry on G's device is G
    home = devices.index(device) if device in devices else -1
    replicas = [G if i == home else copy.deepcopy(G).to(d)
                for i, d in enumerate(devices)]

    def forwards():
        """(images on a device, how many of them to keep) per slice of a
        chunk, in order; a slice of padding alone is run and dropped."""
        done = 0
        while done < num_samples:
            take = min(chunk, num_samples - done)
            with span("sample.issue"):
                z = random_latents(take, G.latent_size, rng)
                if take < per * len(devices):  # fixed shapes: pad, run, slice
                    z = np.concatenate([z, np.zeros(
                        (per * len(devices) - take, G.latent_size), z.dtype)])
                outs = []
                for i, d in enumerate(devices):
                    # non_blocking: a blocking upload would wait for the card
                    zi = torch.from_numpy(z[i * per:(i + 1) * per]).to(
                        d, non_blocking=True)
                    outs.append(replicas[i](zi, depth, alpha, fade=fade,
                                            **kw))
            for i, imgs in enumerate(outs):
                keep = min(per, take - i * per)
                if keep > 0:
                    yield imgs, keep
            done += take

    with torch.inference_mode():
        if devices[0].type != "cuda":
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
        event.record(_stream(imgs.device))
        if prev is not None:
            _drain(out, *prev)
        prev = (event, buf, take, row)
        row += take
    _drain(out, *prev)
    return out


def _stream(device):
    """The stream that a copy out of ``device`` is queued on."""
    return torch.cuda.current_stream(device)


def _drain(out, event, buf, take, row) -> None:
    """Wait for one chunk's copy and move it into rows ``row:row+take``
    (the rows' first touch: ``out`` is fresh)."""
    with span("sample.drain_wait"):
        event.synchronize()
    with span("sample.drain_copy"):
        out[row:row + take] = buf[:take].numpy()
