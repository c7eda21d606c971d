"""Sliced Wasserstein Distance (SWD) over Laplacian-pyramid patch
descriptors, the evaluation metric of the progressive-growing paper
(Karras et al. 2018, appendix A): the counterpart of
``pggan_tpu/metrics/swd.py``.

Each image set is decomposed into a Laplacian pyramid whose levels span
``min_res`` up to full resolution; ``nhoods_per_image`` random 7x7xC
patches are drawn per image per level; each set's descriptors are
normalized per colour channel; and the sliced Wasserstein approximation
(project both clouds on random unit directions, sort, mean |difference|)
is averaged over ``dir_repeats`` draws of ``dirs_per_repeat`` directions.
Values are reported x1e3.

The random draws are apart from the score. ``swd_draws`` draws the patch
positions and the directions from a ``torch.Generator`` on the host, for
all images at once; ``swd_from_draws`` scores two sets on a device with
given draws (a JAX package's draws, in the tests). The draws keep the
JAX package's design: reals and fakes share their patch positions
(common random numbers, so ``swd(a, a) == 0`` exactly), and an image's
positions do not depend on ``minibatch``, the chunk size the images
stream through the device in, so neither does the score. The pyramid is
depthwise ``F.conv2d`` (``groups=C``), the projection one matmul per
repeat (TF32 off), the per-direction sort ``torch.sort``: the JAX package
runs them as plain XLA, in no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pggan_tpu_torch.sampling import disable_tf32

# 5-tap binomial (Gaussian-approximating) filter of the classic Burt-Adelson
# pyramid; outer product gives the 5x5 kernel. Normalized to unit DC gain.
_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _blur5_nchw(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Separable 5-tap binomial blur, reflect padding, NCHW, per channel:
    two depthwise convs (rows, then columns). ``gain`` scales the 2-D
    response once, on the row pass only (in both 1-D kernels it would be
    squared)."""
    c = x.shape[1]
    k = torch.from_numpy(_BINOMIAL5).to(x.device)
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, (k * gain).reshape(1, 1, 5, 1).expand(c, 1, 5, 1),
                 groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, 5).expand(c, 1, 1, 5), groups=c)


def _pyr_down_nchw(x: torch.Tensor) -> torch.Tensor:
    return _blur5_nchw(x)[:, :, ::2, ::2]


def _pyr_up_nchw(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    up = x.new_zeros(n, c, 2 * h, 2 * w)
    up[:, :, ::2, ::2] = x
    return _blur5_nchw(up, gain=4.0)


def _laplacian_nchw(x: torch.Tensor, n_levels: int) -> list[torch.Tensor]:
    levels = []
    for _ in range(n_levels - 1):
        down = _pyr_down_nchw(x)
        levels.append(x - _pyr_up_nchw(down))
        x = down
    levels.append(x)
    return levels


def _blur5(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """``_blur5_nchw`` of an NHWC batch."""
    return _blur5_nchw(x.permute(0, 3, 1, 2), gain).permute(0, 2, 3, 1)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """Gaussian-pyramid reduce of an NHWC batch: blur, then 2x2
    subsample."""
    return _pyr_down_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """Gaussian-pyramid expand of an NHWC batch: zero-insert 2x, then blur
    with 4x gain (the zero insertion leaves 1/4 of the samples non-zero,
    so the gain restores unit DC response)."""
    return _pyr_up_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def laplacian_levels(x: torch.Tensor, n_levels: int) -> list[torch.Tensor]:
    """Laplacian pyramid of an NHWC batch, finest first: band-pass
    residuals ``G_k - pyr_up(G_{k+1})``, then the coarsest Gaussian
    itself."""
    return [lv.permute(0, 2, 3, 1)
            for lv in _laplacian_nchw(x.permute(0, 3, 1, 2), n_levels)]


def _extract_patches(level: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     size: int) -> torch.Tensor:
    """Patches of an NCHW level at top-left corners ``ys``, ``xs`` (N,
    nhoods) -> (N * nhoods, size * size * C), each in (row, column,
    channel) order as the JAX package's ``dynamic_slice`` gives them."""
    n = level.shape[0]
    offs = torch.arange(size, device=level.device)
    rows = (ys.to(level.device)[:, :, None] + offs)[:, :, :, None]
    cols = (xs.to(level.device)[:, :, None] + offs)[:, :, None, :]
    idx = torch.arange(n, device=level.device)[:, None, None, None]
    patches = level.permute(0, 2, 3, 1)[idx, rows, cols]  # (N, P, s, s, C)
    return patches.reshape(n * ys.shape[1], -1)


def _normalize_descriptors(desc: torch.Tensor, size: int,
                           channels: int) -> torch.Tensor:
    """Per-colour-channel standardization over all patches and positions
    of THIS set (paper protocol); the std is the population one, as
    ``jnp.std``'s."""
    d = desc.reshape(desc.shape[0], size * size, channels)
    mean = d.mean(dim=(0, 1), keepdim=True)
    std = d.std(dim=(0, 1), keepdim=True, correction=0) + 1e-8
    return ((d - mean) / std).reshape(desc.shape)


def sliced_wasserstein(a: torch.Tensor, b: torch.Tensor,
                       dirs: torch.Tensor) -> torch.Tensor:
    """Sliced Wasserstein-1 between two equally sized descriptor clouds
    (N, D), over unit directions ``dirs`` (R, D, P): the mean over
    repeats and directions of the 1-D W1 distance, |sorted projection
    difference|. Exactly zero when ``a == b``."""
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"descriptor clouds {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    dirs = dirs.to(a.device)
    dists = [torch.mean(torch.abs(torch.sort(a @ d, dim=0).values
                                  - torch.sort(b @ d, dim=0).values))
             for d in dirs]
    return torch.stack(dists).mean()


def random_directions(generator: torch.Generator, dim: int,
                      dir_repeats: int = 4,
                      dirs_per_repeat: int = 128) -> torch.Tensor:
    """(R, D, P) standard normal directions scaled to unit length."""
    dirs = torch.randn(dir_repeats, dim, dirs_per_repeat,
                       generator=generator)
    return dirs / (torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
                   + 1e-12)


def _n_levels(resolution: int, min_res: int) -> int:
    """Number of pyramid levels spanning min_res..resolution (>=1)."""
    n = 1
    while resolution // 2 ** (n - 1) > min_res:
        n += 1
    return n


def swd_levels(resolution: int, min_res: int = 16) -> list[int]:
    """The per-level resolutions swd() reports, finest first."""
    return [resolution // 2 ** i
            for i in range(_n_levels(resolution, min_res))]


def _check(shape, nhood_size: int, min_res: int) -> None:
    n, h, w, c = shape
    if min_res < nhood_size:
        raise ValueError(
            f"min_res ({min_res}) must be >= nhood_size ({nhood_size}): the "
            f"coarsest pyramid level must fit at least one patch")
    if min(h, w) < min_res:
        raise ValueError(
            f"images are {h}x{w} but the SWD protocol needs at least "
            f"min_res x min_res ({min_res}x{min_res}); evaluate a snapshot "
            f"of resolution >= {min_res}, or lower min_res (>= nhood_size "
            f"{nhood_size})")


def swd_draws(shape, generator: torch.Generator | None = None, *,
              nhoods_per_image: int = 128, nhood_size: int = 7,
              dir_repeats: int = 4, dirs_per_repeat: int = 128,
              min_res: int = 16) -> dict:
    """The random draws of one SWD over image sets of NHWC ``shape``, made
    on the host from ``generator`` (seed 0 when None): per level, the top
    left corners ``(ys, xs)``, each (N, nhoods) and uniform over the
    corners that fit a patch, and the (R, D, P) directions."""
    _check(shape, nhood_size, min_res)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n, h, w, c = shape
    positions, dirs = [], []
    for lv in range(_n_levels(min(h, w), min_res)):
        lh, lw = -(-h // 2 ** lv), -(-w // 2 ** lv)  # a level's sides
        positions.append(tuple(
            torch.randint(0, side - nhood_size + 1, (n, nhoods_per_image),
                          generator=generator) for side in (lh, lw)))
        dirs.append(random_directions(generator, nhood_size ** 2 * c,
                                      dir_repeats, dirs_per_repeat))
    return {"positions": positions, "dirs": dirs, "nhood_size": nhood_size}


def _descriptors(images, draws: dict, minibatch: int, device) -> list:
    """Normalized descriptors per level of an (N, H, W, C) set, streamed to
    ``device`` in chunks of ``minibatch`` images."""
    positions, size = draws["positions"], draws["nhood_size"]
    n, c = images.shape[0], images.shape[-1]
    per_level = [[] for _ in positions]
    for i in range(0, n, minibatch):
        chunk = torch.as_tensor(images[i:i + minibatch]).to(
            device, torch.float32).permute(0, 3, 1, 2)
        for lv, level in enumerate(_laplacian_nchw(chunk, len(positions))):
            ys, xs = positions[lv]
            per_level[lv].append(_extract_patches(
                level, ys[i:i + minibatch], xs[i:i + minibatch], size))
    return [_normalize_descriptors(torch.cat(ps), size, c)
            for ps in per_level]


def swd_from_draws(reals, fakes, draws: dict, *, minibatch: int = 64,
                   device="cuda") -> dict:
    """SWD between two NHWC image sets (numpy or tensors) of one shape with
    the given draws, computed on ``device``. Returns ``{resolution:
    distance_x1e3, ..., "avg": mean_x1e3}``, finest level first."""
    if tuple(reals.shape) != tuple(fakes.shape) or len(reals.shape) != 4:
        raise ValueError(f"image sets {tuple(reals.shape)} and "
                         f"{tuple(fakes.shape)}")
    disable_tf32()
    device = torch.device(device)
    n, h, w, _ = reals.shape
    minibatch = min(minibatch, n)
    with torch.no_grad():
        dr = _descriptors(reals, draws, minibatch, device)
        df = _descriptors(fakes, draws, minibatch, device)
        results = {}
        for lv, d in enumerate(draws["dirs"]):
            dist = sliced_wasserstein(dr[lv], df[lv], d)
            results[min(h, w) // 2 ** lv] = float(dist) * 1e3
    results["avg"] = float(np.mean(list(results.values())))
    return results


def swd(reals, fakes, generator: torch.Generator | None = None, *,
        nhoods_per_image: int = 128, nhood_size: int = 7,
        dir_repeats: int = 4, dirs_per_repeat: int = 128, min_res: int = 16,
        minibatch: int = 64, device="cuda") -> dict:
    """The full SWD protocol between two NHWC image sets of one shape, in
    the training range [-1, 1]: ``swd_draws`` from ``generator``, then
    ``swd_from_draws`` on ``device`` (the card unless ``device="cpu"``),
    the images streamed through it ``minibatch`` at a time. ``{resolution:
    distance_x1e3, ..., "avg": mean_x1e3}``, finest level first."""
    draws = swd_draws(tuple(reals.shape), generator,
                      nhoods_per_image=nhoods_per_image,
                      nhood_size=nhood_size, dir_repeats=dir_repeats,
                      dirs_per_repeat=dirs_per_repeat, min_res=min_res)
    return swd_from_draws(reals, fakes, draws, minibatch=minibatch,
                          device=device)
