from pggan_tpu_torch.ops.primitives import (
    conv_init,
    equalized_conv2d,
    equalized_conv2d_up2x,
    he_constant,
    leaky_relu,
    nf,
    pixelnorm,
    upsample_nearest_2x,
)

__all__ = [
    "conv_init",
    "equalized_conv2d",
    "equalized_conv2d_up2x",
    "he_constant",
    "leaky_relu",
    "nf",
    "pixelnorm",
    "upsample_nearest_2x",
]
