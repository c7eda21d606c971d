"""Sample postprocessors: NCHW numpy samples -> artifacts. The image half
of ``pggan_tpu/postprocess.py`` (numpy and PIL); the SoundSaver needs the
STFT and Griffin-Lim port and comes later."""

from __future__ import annotations

import os

import numpy as np

from pggan_tpu_torch.utils.misc import adjust_dynamic_range, numpy_upsample_nearest


class Postprocessor:
    def __init__(self, samples_path="."):
        self.samples_path = samples_path


class ImageSaver(Postprocessor):
    """Tile samples into a square grid and save a PNG
    (reference output_postprocess.py:21-71)."""

    output_file_format = "fakes_{}.png"

    def __init__(self, samples_path=".", drange=(-1, 1), resolution=512,
                 create_subdirs=True):
        super().__init__(samples_path)
        if create_subdirs:
            os.makedirs(self.samples_path, exist_ok=True)
        self.resolution = resolution
        self.drange = tuple(drange)

    def create_image_grid(self, images: np.ndarray) -> np.ndarray:
        """Row-major square-ish tiling: pad the batch with zero tiles to a
        full rows x cols rectangle, then one reshape/transpose."""
        count, channels, img_h, img_w = images.shape
        cols = max(int(np.ceil(np.sqrt(count))), 1)
        rows = -(-count // cols)
        missing = rows * cols - count
        if missing:
            images = np.concatenate(
                [images, np.zeros((missing,) + images.shape[1:],
                                  images.dtype)])
        tiles = images.reshape(rows, cols, channels, img_h, img_w)
        return tiles.transpose(2, 0, 3, 1, 4).reshape(
            channels, rows * img_h, cols * img_w)

    def convert_to_pil_image(self, image: np.ndarray):
        import PIL.Image
        arr = np.asarray(image)
        if arr.ndim == 3:  # (C, H, W): single channel -> 2-D, else HWC
            arr = arr[0] if arr.shape[0] == 1 else np.moveaxis(arr, 0, -1)
        arr = adjust_dynamic_range(arr, self.drange, (0, 255))
        arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
        return PIL.Image.fromarray(arr, "L" if arr.ndim == 2 else "RGB")

    def __call__(self, output: np.ndarray, description):
        # upsample small outputs to the display resolution; at or above it,
        # save at native size
        if self.resolution is not None and self.resolution > output.shape[-1] \
                and self.resolution % output.shape[-1] == 0:
            output = numpy_upsample_nearest(output, 2, size=self.resolution)
        im = self.convert_to_pil_image(self.create_image_grid(output))
        desc = (f"{description:06}" if isinstance(description, int)
                else str(description))
        im.save(os.path.join(self.samples_path,
                             self.output_file_format.format(desc)))
