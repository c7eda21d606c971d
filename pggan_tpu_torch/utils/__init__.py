from pggan_tpu_torch.utils.misc import (
    adjust_dynamic_range,
    numpy_upsample_nearest,
    random_latents,
)

__all__ = ["adjust_dynamic_range", "numpy_upsample_nearest", "random_latents"]
