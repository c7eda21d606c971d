"""Depth-aware multi-resolution datasets: the counterpart of
``pggan_tpu/data/datasets.py`` (reference dataset.py), for the datasets
that live in memory. The folder, H5 and sound datasets come later.

A *depth* dataset serves items at the resolution of the model's current
growth stage (``model_depth + model_dataset_depth_offset``), with an
alpha-fade blend against the next-coarser level during stage transitions and
a dynamic-range remap to the model's (-1, 1) domain (reference
dataset.py:31-70). Items and batches are HWC (channels last, as the models
take their reals); ``shape`` keeps the reference's (N, C, H, W) descriptor,
from which the models read their channels and resolution. The loader's
threads read ``alpha`` live, so a fade's blend follows the schedule.
"""

from __future__ import annotations

import math

import numpy as np

from pggan_tpu_torch.utils.misc import adjust_dynamic_range


def box_downsample(img_hwc: np.ndarray, factor: int) -> np.ndarray:
    """Exact block-mean downsample of an HWC image by an integer factor."""
    if factor == 1:
        return img_hwc
    h, w, c = img_hwc.shape
    if h % factor or w % factor:
        raise ValueError(f"{h}x{w} image does not divide by {factor}")
    x = img_hwc.astype(np.float32).reshape(
        h // factor, factor, w // factor, factor, c)
    return x.mean(axis=(1, 3))


def _alpha_fade_blend(img_hwc: np.ndarray, alpha: float) -> np.ndarray:
    """Blend with the 2x2-box-downsampled-then-reupsampled self (reference
    dataset.py:109-113/238-242): simulates the coarser stage during fade-in."""
    t = box_downsample(img_hwc, 2)
    t = t.repeat(2, axis=0).repeat(2, axis=1)
    return img_hwc + (t - img_hwc) * (1.0 - alpha)


def prep_batch_f32(batch_u8: np.ndarray, alpha: float,
                   range_in=(0, 255), range_out=(-1, 1)) -> np.ndarray:
    """Fade + dynamic-range remap of a uint8 NHWC batch -> float32: the
    numpy fallback of ``pggan_tpu/data/native.py:prep_batch_f32``
    (reference dataset.py:60-67, ``__getitem__``)."""
    min_in, max_in = range_in
    min_out, max_out = range_out
    scale = (max_out - min_out) / (max_in - min_in)
    x = batch_u8.astype(np.float32)
    if alpha < 1.0:
        x = np.stack([_alpha_fade_blend(v, alpha) for v in x])
    return ((x - min_in) * scale + min_out).astype(np.float32)


class DepthDataset:
    """Abstract depth-aware dataset (reference dataset.py:31-70)."""

    def __init__(self,
                 model_dataset_depth_offset=2,  # model depth 0 <-> 4x4 data
                 model_initial_depth=0,
                 alpha=1.0,
                 range_in=(0, 255),
                 range_out=(-1, 1)):
        self.model_depth = model_initial_depth
        self.alpha = alpha
        self.model_dataset_depth_offset = model_dataset_depth_offset
        self.range_in = tuple(range_in)
        self.range_out = tuple(range_out)

    @property
    def data(self):
        """List indexed by dataset depth; entry d is an (N, h, w, C) array at
        resolution 2**d (or None for unmaterialized levels)."""
        raise NotImplementedError

    @property
    def shape(self):
        """(N, C, H, W) full-resolution descriptor (reference convention)."""
        n, h, w, c = self.data[-1].shape
        return (n, c, h, w)

    def alpha_fade(self, datapoint):
        return _alpha_fade_blend(datapoint, self.alpha)

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, item) -> np.ndarray:
        datapoint = self.data[self.model_depth
                              + self.model_dataset_depth_offset][item]
        datapoint = datapoint.astype(np.float32)
        if self.alpha < 1.0:
            datapoint = self.alpha_fade(datapoint)
        datapoint = adjust_dynamic_range(datapoint, self.range_in,
                                         self.range_out)
        return datapoint.astype(np.float32)

    def raw_batch(self, items) -> np.ndarray | None:
        """uint8 HWC batch at the current depth, for the fade + remap on
        the device (or ``prep_batch_f32`` on the host); None when the level
        is not held as uint8 in memory."""
        level = self.data[self.model_depth + self.model_dataset_depth_offset]
        if level is None or level.dtype != np.uint8:
            return None
        return level[items]

    def close(self):
        pass


class SyntheticDataset(DepthDataset):
    """In-memory random dataset for tests and benchmarks (not in the
    reference; ``pggan_tpu/data/datasets.py:729-753``)."""

    def __init__(self, resolution=32, num_channels=3, num_items=64, seed=0,
                 model_dataset_depth_offset=2, model_initial_depth=0,
                 alpha=1.0, range_in=(0, 255), range_out=(-1, 1)):
        super().__init__(model_dataset_depth_offset, model_initial_depth,
                         alpha, range_in, range_out)
        max_depth = int(math.log2(resolution))
        rng = np.random.RandomState(seed)
        full = rng.randint(0, 256, (num_items, resolution, resolution,
                                    num_channels)).astype(np.uint8)
        self._data = [None] * (max_depth + 1)
        self._data[max_depth] = full
        for d in range(max_depth - 1, -1, -1):
            self._data[d] = np.uint8(np.clip(np.round(np.stack(
                [box_downsample(x, 2) for x in self._data[d + 1]])), 0, 255))

    @property
    def data(self):
        return self._data

    def __len__(self):
        return self._data[-1].shape[0]
