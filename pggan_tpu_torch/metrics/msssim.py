"""Multi-scale SSIM (Wang et al. 2003), the progressive-growing paper's
second evaluation metric: the counterpart of ``pggan_tpu/metrics/msssim.py``.
Karras et al. 2018 section 5 use the mean MS-SSIM among random pairs of
generated images as a mode-collapse indicator: a collapsing generator
emits near-duplicates, which drives pairwise similarity up.

The 11x11 Gaussian window runs as two depthwise ``F.conv2d`` (VALID
padding, per the original paper), the scales are a pyramid of 2x2 average
pools, and a batch of image pairs is scored at once. Inputs follow the
training range [-1, 1] and are remapped to [0, 1] (L = 1, K1 = 0.01,
K2 = 0.03, the standard constants).

The canonical 5 scales need min(H, W) >= 176 (the 11-tap window must fit
after four 2x downsamples). For smaller images the scale count is reduced
to what fits and the per-scale exponents are renormalized to keep the score
in [0, 1], the same rule for both sets compared.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pggan_tpu_torch.sampling import disable_tf32

# per-scale exponents from the MS-SSIM paper (sum to 1)
_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], np.float64)
_WINDOW = 11
_SIGMA = 1.5


def _gaussian1d(size: int = _WINDOW, sigma: float = _SIGMA) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _blur_valid(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian, VALID padding, NCHW."""
    c, n = x.shape[1], k1d.shape[0]
    x = F.conv2d(x, k1d.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, k1d.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x[:, :, :h - h % 2, :w - w % 2].reshape(
        n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _ssim_parts(a, b, k1d, c1, c2):
    """Per-image (luminance, contrast-structure) means over all windows and
    channels, each statistic one blurred tensor (moment identities)."""
    mu_a = _blur_valid(a, k1d)
    mu_b = _blur_valid(b, k1d)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _blur_valid(a * a, k1d) - mu_aa
    var_b = _blur_valid(b * b, k1d) - mu_bb
    cov = _blur_valid(a * b, k1d) - mu_ab
    lum = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    return lum.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def n_scales(resolution: int, max_scales: int = 5) -> int:
    """How many pyramid scales fit: the 11-tap window must fit at the
    coarsest scale (min side // 2**(n-1) >= 11)."""
    n = 1
    while (n < max_scales
           and resolution // 2 ** n >= _WINDOW):
        n += 1
    return n


def _msssim_scored(a: torch.Tensor, b: torch.Tensor,
                   scales: int) -> torch.Tensor:
    k1d = torch.from_numpy(_gaussian1d()).to(a.device)
    # [-1, 1] -> [0, 1]; L = 1
    a = (a + 1.0) * 0.5
    b = (b + 1.0) * 0.5
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    weights = _WEIGHTS[:scales] / _WEIGHTS[:scales].sum()
    score = torch.ones(a.shape[0], device=a.device)
    for j in range(scales):
        lum, cs = _ssim_parts(a, b, k1d, c1, c2)
        # negative cs values (possible on odd inputs) are clamped so the
        # fractional exponents stay real, as standard implementations do
        term = cs if j < scales - 1 else lum * cs
        score = score * torch.clamp_min(term, 0.0) ** float(weights[j])
        if j < scales - 1:
            a, b = _avg_pool_2x(a), _avg_pool_2x(b)
    return score


def msssim(a, b, max_scales: int = 5, device="cuda") -> np.ndarray:
    """Per-pair MS-SSIM of two NHWC image batches in [-1, 1] (numpy or
    tensors), computed on ``device``: an (N,) float32 array in [0, 1]
    (1 = identical)."""
    if tuple(a.shape) != tuple(b.shape) or len(a.shape) != 4:
        raise ValueError(f"image batches {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    res = min(a.shape[1], a.shape[2])
    if res < _WINDOW:
        raise ValueError(
            f"images are {a.shape[1]}x{a.shape[2]} but MS-SSIM's "
            f"{_WINDOW}-tap window needs at least {_WINDOW}x{_WINDOW}")
    disable_tf32()

    def nchw(x):
        return torch.as_tensor(x).to(device, torch.float32).permute(0, 3, 1, 2)

    with torch.no_grad():
        score = _msssim_scored(nchw(a), nchw(b), n_scales(res, max_scales))
    return score.cpu().numpy()


def pairwise_msssim(images, generator: torch.Generator | None = None,
                    max_scales: int = 5, minibatch: int = 32,
                    device="cuda") -> float:
    """Mean MS-SSIM over a random disjoint pairing of one image set, the
    paper's mode-collapse statistic (higher = samples more alike; a healthy
    generator scores close to the real data's own pairing).

    The images are shuffled once by ``torch.randperm`` from ``generator``
    (seed 0 when None), split into halves, and pair ``i`` = (half1[i],
    half2[i]) is scored, ``minibatch`` pairs at a time, on ``device``.
    """
    n = images.shape[0] // 2 * 2
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    perm = torch.randperm(n, generator=generator).numpy()
    a, b = images[perm[:n // 2]], images[perm[n // 2:n]]
    scores = [msssim(a[i:i + minibatch], b[i:i + minibatch], max_scales,
                     device) for i in range(0, n // 2, minibatch)]
    return float(np.mean(np.concatenate(scores)))
