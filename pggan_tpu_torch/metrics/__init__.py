from pggan_tpu_torch.metrics.msssim import msssim, n_scales, pairwise_msssim
from pggan_tpu_torch.metrics.swd import (
    laplacian_levels,
    pyr_down,
    pyr_up,
    sliced_wasserstein,
    swd,
    swd_draws,
    swd_from_draws,
    swd_levels,
)

__all__ = [
    "laplacian_levels",
    "msssim",
    "n_scales",
    "pairwise_msssim",
    "pyr_down",
    "pyr_up",
    "sliced_wasserstein",
    "swd",
    "swd_draws",
    "swd_from_draws",
    "swd_levels",
]
