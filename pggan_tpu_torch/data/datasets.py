"""Depth-aware multi-resolution datasets: the counterpart of
``pggan_tpu/data/datasets.py`` (reference dataset.py): the in-memory
synthetic set, Karras-format HDF5 files, and directories of images or of
audio files (spectrogram images).

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

import json
import math
import os
import time

import numpy as np
import torch

from pggan_tpu_torch.data import native
from pggan_tpu_torch.data.audio_io import read_wav
from pggan_tpu_torch.ops.stft import (
    sound_image_signal_length,
    sound_images,
    stft_np,
)
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
    (reference dataset.py:60-67, ``__getitem__``): the plain version of
    ``native.prep_batch_f32``."""
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


def _gather_rows(arr, items) -> np.ndarray:
    """Fancy-gather rows from an array-like that may only support sorted
    unique selections (h5py datasets): read the sorted unique rows once,
    then scatter back to the requested (possibly duplicated, unsorted)
    order. For plain numpy/memmap arrays it's a single fancy index."""
    items = np.asarray(items)
    if isinstance(arr, np.ndarray):  # includes np.memmap
        return np.asarray(arr[items])
    uniq, inverse = np.unique(items, return_inverse=True)
    return np.asarray(arr[uniq])[inverse]


class _H5Window:
    """Read-through NHWC uint8 view over one on-disk NCHW ``data{r}x{r}``
    array: every access reads only the requested rows from the file (h5py
    chunk cache + OS page cache behind it), so corpora larger than host RAM
    stream instead of loading up front."""

    def __init__(self, dset, max_images=None):
        self._dset = dset
        n = dset.shape[0] if max_images is None \
            else min(int(max_images), dset.shape[0])
        self._n = n
        c, h, w = dset.shape[1:]
        self.shape = (n, h, w, c)  # reported NHWC like in-RAM levels
        self.dtype = dset.dtype

    def __len__(self):
        return self._n

    def __getitem__(self, item):
        # bound-check against the max_images cap here: self._dset is the
        # whole on-disk array, which would serve the images the cap leaves
        # out (and resolve negatives against the wrong length)
        if isinstance(item, (int, np.integer)):
            i = int(item)
            if i < 0:
                i += self._n
            if not 0 <= i < self._n:
                raise IndexError(f"index {item} out of range for "
                                 f"{self._n} images")
            return np.asarray(self._dset[i]).transpose(1, 2, 0)
        items = np.asarray(item)
        items = np.where(items < 0, items + self._n, items)
        if items.size and (items.min() < 0 or items.max() >= self._n):
            raise IndexError(f"indices out of range for {self._n} images")
        rows = _gather_rows(self._dset, items)
        return rows.transpose(0, 2, 3, 1)


class H5Dataset(DepthDataset):
    """Karras-format HDF5 dataset (reference ``OldH5Dataset``,
    dataset.py:73-116): one ``data{r}x{r}`` array per resolution. On-disk
    arrays are NCHW uint8; served as NHWC.

    ``preload=True`` loads every level into RAM, as the reference does;
    ``preload=False`` keeps the file open and serves windowed per-batch
    reads through :class:`_H5Window`, so a corpus larger than host memory
    trains. Both modes serve identical items."""

    def __init__(self,
                 h5_path="datasets/cifar10-32.h5",
                 model_dataset_depth_offset=2,
                 max_images=None,
                 model_initial_depth=0,
                 alpha=1.0,
                 range_in=(0, 255),
                 range_out=(-1, 1),
                 preload=True):
        super().__init__(model_dataset_depth_offset, model_initial_depth,
                         alpha, range_in, range_out)
        self.h5_path = h5_path
        self.max_images = max_images
        self.preload = preload
        self._h5 = None
        self._open()

    def _open(self):
        import h5py
        if self.preload:
            with h5py.File(self.h5_path, "r") as f:
                levels = {}
                for r in sorted({v.shape[-1] for v in f.values()}):
                    arr = np.asarray(f[f"data{r}x{r}"])
                    if self.max_images is not None:
                        arr = arr[:self.max_images]
                    levels[int(math.log2(r))] = arr.transpose(0, 2, 3, 1)
        else:
            self._h5 = h5py.File(self.h5_path, "r")
            levels = {
                int(math.log2(r)): _H5Window(self._h5[f"data{r}x{r}"],
                                             self.max_images)
                for r in sorted({v.shape[-1] for v in self._h5.values()})}
        max_level = max(levels)
        self._data = [levels.get(d) for d in range(max_level + 1)]

    @property
    def data(self):
        return self._data

    def __len__(self):
        return self._data[-1].shape[0]

    def raw_batch(self, items):
        level = self._data[self.model_depth
                           + self.model_dataset_depth_offset]
        if level is None or level.dtype != np.uint8:
            return None
        return level[np.asarray(items)] if isinstance(level, _H5Window) \
            else level[items]

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    # pickling (the ``--save_dataset`` cache): drop the live handle
    def __getstate__(self):
        state = dict(self.__dict__)
        if not self.preload:
            state["_h5"] = None
            state["_data"] = None
        return state

    def __setstate__(self, state):
        # pickles of the JAX package from before its streaming mode lack
        # these keys; that class always preloaded and kept no handle
        state.setdefault("preload", True)
        state.setdefault("max_images", None)
        state.setdefault("_h5", None)
        self.__dict__.update(state)
        if not self.preload:
            self._open()


class OldH5Dataset(H5Dataset):
    """The reference's class name (dataset.py:73), so ``--dataset_class
    OldH5Dataset --OldH5Dataset.h5_path ...`` command lines work; the
    implementation is :class:`H5Dataset`."""


class FolderDataset(DepthDataset):
    """Abstract directory-of-files dataset with an optional preloaded
    multi-resolution pyramid (reference dataset.py:119-206).

    ``preload`` modes:

    - ``False``: lazy; each ``__getitem__`` loads the file again and
      derives the requested depth.
    - ``True``: the reference's whole pyramid in RAM (dataset.py:141-162).
    - ``"disk"``: a one-time on-disk uint8 pyramid cache (one memmapped
      ``.npy`` per depth level under ``cache_dir``), built streaming with
      one chunk in memory and reopened read-only: batches read only their
      rows through the OS page cache. The cache checks itself against the
      file list, the sizes and the feature parameters; a second
      construction reuses it.

    Subclasses implement ``load_file`` (-> HWC uint8/float array at the max
    depth), ``create_datapoint_from_depth`` and ``infer_max_dataset_depth``.
    """

    _CACHE_VERSION = 1

    def __init__(self,
                 dir_path,
                 max_dataset_depth=None,
                 create_unused_depths=False,
                 preload=False,
                 model_dataset_depth_offset=2,
                 model_initial_depth=0,
                 alpha=1.0,
                 range_in=(0, 255),
                 range_out=(-1, 1),
                 cache_dir=""):
        super().__init__(model_dataset_depth_offset, model_initial_depth,
                         alpha, range_in, range_out)
        self.dir_path = dir_path
        # files only: the default disk cache is a directory inside
        # dir_path (the JAX package lists it too, and a second
        # construction then fails to open it as the first file)
        self.files = sorted(os.path.join(dir_path, x)
                            for x in os.listdir(dir_path)
                            if os.path.isfile(os.path.join(dir_path, x)))
        if not self.files:
            raise ValueError(f"no files found in {dir_path}")
        self.max_dataset_depth = max_dataset_depth
        if self.max_dataset_depth is None:
            self.max_dataset_depth = self.infer_max_dataset_depth(
                self.load_file(0))
        self.preload = preload
        self.cache_dir = cache_dir or os.path.join(
            dir_path, ".pggan_pyramid_cache")
        self.min_dataset_depth = (0 if preload and create_unused_depths
                                  else self.model_dataset_depth_offset)
        self._data = [None] * (self.max_dataset_depth + 1)
        if self.preload == "disk":
            self._open_or_build_disk_pyramid()
        elif self.preload:
            self._preload_pyramid()

    @staticmethod
    def _check_shape(datapoint, first_shape):
        if datapoint.shape != first_shape:
            raise ValueError(f"all files must share one shape "
                             f"(dataset.py:160): {datapoint.shape} and "
                             f"{first_shape}")

    def _preload_pyramid(self):
        """Materialize every depth level top-down: load full-res once
        (``_load_files_chunk`` over all files), then derive each coarser
        level from the one above (reference dataset.py:141-162)."""
        for depth in range(self.max_dataset_depth,
                           self.min_dataset_depth - 1, -1):
            if depth == self.max_dataset_depth:
                items = self._load_files_chunk(0, len(self.files))
            else:
                items = [self.get_datapoint_version(
                    self._data[depth + 1][i], depth + 1, depth)
                    for i in range(len(self.files))]
            for dp in items[1:]:
                self._check_shape(dp, items[0].shape)
            self._data[depth] = np.stack(items, axis=0)

    def _load_files_chunk(self, lo, hi):
        """Full-resolution datapoints for ``files[lo:hi]``; the per-file host
        loader here. Both preload paths (RAM and the streaming disk build)
        load through this hook, so a subclass that batches it (the sound
        dataset's STFT on the device) serves both."""
        return [self.load_file(i) for i in range(lo, hi)]

    # --- disk pyramid mode (preload="disk") --------------------------------
    def _cache_fingerprint(self) -> dict:
        """What the disk cache's validity depends on: the corpus (names +
        sizes) and every parameter that changes pixel content."""
        feature_keys = ("imread_mode", "scale_factor", "n_fft", "hop_length",
                        "frequency", "img_mode")
        return {
            "version": self._CACHE_VERSION,
            "class": type(self).__name__,
            "files": [[os.path.basename(f), os.path.getsize(f)]
                      for f in self.files],
            "max_dataset_depth": int(self.max_dataset_depth),
            "min_dataset_depth": int(self.min_dataset_depth),
            "range_in": list(self.range_in),
            "features": {k: getattr(self, k) for k in feature_keys
                         if hasattr(self, k)},
        }

    def _open_or_build_disk_pyramid(self, build_timeout: float = 3600.0):
        meta_path = os.path.join(self.cache_dir, "meta.json")
        fp = json.loads(json.dumps(self._cache_fingerprint()))
        if self._try_open_levels(meta_path, fp):
            return
        # Cold build. Several processes can get here at once (every process
        # of a run constructs the dataset over a shared corpus directory);
        # without exclusion they would interleave writes into the same
        # level_XX.npy memmaps and the first meta.json would mark the
        # corrupt result valid. One process wins the O_EXCL lock and builds;
        # the rest wait for meta.json (written last) to appear.
        os.makedirs(self.cache_dir, exist_ok=True)
        lock_path = os.path.join(self.cache_dir, ".build_lock")
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self._wait_for_build(meta_path, fp, lock_path, build_timeout)
            return
        try:
            os.write(fd, str(os.getpid()).encode())
            self._build_disk_pyramid()
            # meta written LAST: its presence marks a complete build
            tmp = meta_path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(fp, f)
            os.replace(tmp, meta_path)
        finally:
            os.close(fd)
            os.unlink(lock_path)

    def _try_open_levels(self, meta_path: str, fp: dict) -> bool:
        """mmap every level if a complete cache with a matching fingerprint
        exists; False on a cold/mismatched cache."""
        if not os.path.exists(meta_path):
            return False
        with open(meta_path) as f:
            if json.load(f) != fp:
                return False
        for d in range(self.min_dataset_depth, self.max_dataset_depth + 1):
            self._data[d] = np.load(self._level_path(d), mmap_mode="r")
        return True

    def _wait_for_build(self, meta_path: str, fp: dict, lock_path: str,
                        timeout: float):
        """Another process holds the build lock: poll until its meta.json
        lands, then open the finished cache."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                if meta != fp:
                    raise RuntimeError(
                        f"disk pyramid cache at {self.cache_dir} was built "
                        f"by a concurrent process with a DIFFERENT "
                        f"fingerprint (corpus or feature params differ); "
                        f"use a distinct cache_dir per configuration")
                if self._try_open_levels(meta_path, fp):
                    return
            if not os.path.exists(lock_path):
                # builder died without finishing: take over the build
                self._open_or_build_disk_pyramid(
                    build_timeout=deadline - time.monotonic())
                return
            time.sleep(1.0)
        raise RuntimeError(
            f"timed out ({timeout:.0f}s) waiting for another process to "
            f"finish building the disk pyramid cache at {self.cache_dir}; "
            f"if no builder is running, delete the stale "
            f"{os.path.basename(lock_path)} file")

    def _level_path(self, depth: int) -> str:
        return os.path.join(self.cache_dir, f"level_{depth:02}.npy")

    def _build_disk_pyramid(self, chunk: int = 64):
        """Stream the pyramid to disk: full resolution chunk by chunk, then
        each coarser level derived chunk-wise from the memmapped level above
        -- peak memory is one chunk, never the corpus."""
        from numpy.lib.format import open_memmap
        os.makedirs(self.cache_dir, exist_ok=True)
        n = len(self.files)
        for depth in range(self.max_dataset_depth,
                           self.min_dataset_depth - 1, -1):
            if depth == self.max_dataset_depth:
                arr = None
                for lo in range(0, n, chunk):
                    for j, dp in enumerate(
                            self._load_files_chunk(lo, min(lo + chunk, n))):
                        if arr is None:
                            if dp.dtype != np.uint8:
                                raise TypeError(
                                    "disk pyramid mode requires uint8 "
                                    f"datapoints (got {dp.dtype})")
                            first_shape = dp.shape
                            arr = open_memmap(
                                self._level_path(depth), mode="w+",
                                dtype=np.uint8, shape=(n,) + first_shape)
                        self._check_shape(dp, first_shape)
                        arr[lo + j] = dp
            else:
                src = self._data[depth + 1]
                item = self.create_datapoint_from_depth(
                    np.asarray(src[0]), depth + 1, depth)
                arr = open_memmap(self._level_path(depth), mode="w+",
                                  dtype=np.uint8, shape=(n,) + item.shape)
                for lo in range(0, n, chunk):
                    block = np.asarray(src[lo:lo + chunk])
                    for j in range(block.shape[0]):
                        arr[lo + j] = self.create_datapoint_from_depth(
                            block[j], depth + 1, depth)
            arr.flush()
            del arr  # close the writable map before reopening read-only
            self._data[depth] = np.load(self._level_path(depth),
                                        mmap_mode="r")

    def __getstate__(self):
        state = dict(self.__dict__)
        if self.preload == "disk":  # memmaps must not pickle by value
            state["_data"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.preload == "disk":
            self._data = [None] * (self.max_dataset_depth + 1)
            self._open_or_build_disk_pyramid()

    @property
    def data(self):
        if self.preload:
            return self._data
        raise AttributeError("data only accessible when preload is on "
                             "(dataset.py:169-173)")

    @property
    def shape(self):
        if self.preload:
            return super().shape
        h, w, c = self.load_file(0).shape
        return (len(self), c, h, w)

    def __len__(self):
        return len(self.files)

    def raw_batch(self, items):
        """None without a preloaded pyramid: the loader stacks items."""
        return super().raw_batch(items) if self.preload else None

    def get_datapoint_version(self, datapoint, datapoint_depth, target_depth):
        if datapoint_depth == target_depth:
            return datapoint
        return self.create_datapoint_from_depth(datapoint, datapoint_depth,
                                                target_depth)

    def create_datapoint_from_depth(self, datapoint, datapoint_depth,
                                    target_depth):
        raise NotImplementedError

    def load_file(self, item):
        raise NotImplementedError

    def infer_max_dataset_depth(self, datapoint):
        raise NotImplementedError

    def __getitem__(self, item):
        if self.preload:
            return super().__getitem__(item)
        datapoint = self.load_file(item)
        datapoint = self.get_datapoint_version(
            datapoint, self.max_dataset_depth,
            self.model_depth + self.model_dataset_depth_offset)
        datapoint = datapoint.astype(np.float32)
        if self.alpha < 1.0:
            datapoint = self.alpha_fade(datapoint)
        datapoint = adjust_dynamic_range(datapoint, self.range_in,
                                         self.range_out)
        return datapoint.astype(np.float32)


class DefaultImageFolderDataset(FolderDataset):
    """Directory of images (reference dataset.py:209-255), decoded by PIL.
    A uint8 level in the default 0..255 range is downsampled by the host
    library (``native.box_downsample_u8``), any other through numpy: the
    same numbers either way."""

    def __init__(self,
                 dir_path="datasets/images",
                 max_dataset_depth=None,
                 create_unused_depths=False,
                 preload=False,
                 model_dataset_depth_offset=2,
                 model_initial_depth=0,
                 alpha=1.0,
                 range_in=(0, 255),
                 range_out=(-1, 1),
                 imread_mode="L",
                 scale_factor=2,
                 cache_dir=""):
        self.imread_mode = imread_mode
        self.scale_factor = scale_factor
        super().__init__(dir_path, max_dataset_depth, create_unused_depths,
                         preload, model_dataset_depth_offset,
                         model_initial_depth, alpha, range_in, range_out,
                         cache_dir=cache_dir)

    def load_file(self, item) -> np.ndarray:
        from PIL import Image
        with Image.open(self.files[item]) as im:
            arr = np.asarray(im.convert(self.imread_mode))
        return arr[:, :, np.newaxis] if arr.ndim == 2 else arr

    def create_datapoint_from_depth(self, datapoint, datapoint_depth,
                                    target_depth):
        factor = self.scale_factor ** (datapoint_depth - target_depth)
        if datapoint.dtype == np.uint8 and self.range_in == (0, 255):
            return native.box_downsample_u8(datapoint, factor)
        down = box_downsample(datapoint, factor)
        return np.uint8(np.clip(np.round(down), self.range_in[0],
                                self.range_in[1]))

    def infer_max_dataset_depth(self, datapoint):
        return int(math.log(datapoint.shape[1], self.scale_factor))


class SoundImageDataset(DefaultImageFolderDataset):
    """Audio files as images (reference dataset.py:258-306): each file is
    loaded, mixed to mono, and turned into a single-channel image by one of
    three modes:

    - ``raw``: first 4**k samples reshaped to a 2**k x 2**k square
      (dataset.py:289-291); depth downsampling is strided subsampling
      (dataset.py:302-306).
    - ``abslog``: STFT magnitude, ``log(1+|S|)``, cropped to an
      n_fft/2 x n_fft/2 square (dataset.py:293-296).
    - ``reallog``: signed log of the real part, ``log(1+|Re S|)*sign(Re S)``
      (dataset.py:298; the reference's ``np.sign(s)`` on a complex array
      acts on the real sign).

    Each image is normalized per file to ``range_in`` uint8
    (dataset.py:299). ``frequency`` is the working sample rate: files at
    another rate are resampled to it on load; ``None``/``0`` keeps each
    file's own rate.

    Both preload modes (RAM and the ``"disk"`` cache build) extract the
    abslog/reallog images of a chunk of files in one batch on ``device``
    (``ops/stft.sound_images``): the card unless ``device="cpu"``. The
    per-file host path (``load_file``, numpy) serves the lazy mode, raw
    mode, and files shorter than the device path's window
    (``sound_image_signal_length``): that is the rule, not a fallback; an
    error on the device raises.
    """

    # files a device batch holds: RAM preload hands the whole corpus to
    # _load_files_chunk, and a 1024-point STFT of one file takes 2 MB there
    STFT_BATCH = 64

    def __init__(self,
                 dir_path="datasets/piano",
                 max_dataset_depth=None,
                 create_unused_depths=False,
                 preload=False,
                 model_dataset_depth_offset=2,
                 model_initial_depth=0,
                 alpha=1.0,
                 range_in=(0, 255),
                 range_out=(-1, 1),
                 scale_factor=2,
                 n_fft=1024,
                 hop_length=128,
                 frequency=16000,
                 img_mode="abslog",
                 cache_dir="",
                 device="cuda"):
        if n_fft != 2 ** int(np.log2(n_fft)):
            raise ValueError(f"n_fft must be a power of 2, got {n_fft}")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.frequency = frequency
        self.img_mode = img_mode
        self.device = device
        super().__init__(dir_path, max_dataset_depth, create_unused_depths,
                         preload, model_dataset_depth_offset,
                         model_initial_depth, alpha, range_in, range_out,
                         scale_factor=scale_factor, cache_dir=cache_dir)

    def _load_files_chunk(self, lo, hi):
        """The chunk's spectrogram images, STFT_BATCH files a batch on
        ``device`` (``sound_images``: STFT, log, per-file remap). Only the
        first n_fft//2 frames survive the square crop, so each signal is
        cut to the samples that window needs; raw mode, or a chunk with a
        file shorter than that, takes the per-file host path."""
        if self.img_mode == "raw":
            return super()._load_files_chunk(lo, hi)
        need = sound_image_signal_length(self.n_fft, self.hop_length)
        sigs = []
        for f in self.files[lo:hi]:
            sig, _ = read_wav(f, mono=True, target_rate=self.frequency)
            if sig.shape[0] < need:  # the host path reports short files
                return super()._load_files_chunk(lo, hi)
            sigs.append(sig[:need])
        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SoundImageDataset(device={self.device!r}): "
                               "CUDA is not available (pass device='cpu')")
        imgs = []
        for i in range(0, len(sigs), self.STFT_BATCH):
            batch = torch.from_numpy(np.stack(sigs[i:i + self.STFT_BATCH]))
            imgs.extend(sound_images(batch.to(device), self.n_fft,
                                     self.hop_length, self.img_mode,
                                     tuple(self.range_in)).cpu().numpy())
        return [img[:, :, np.newaxis] for img in imgs]

    def load_file(self, item) -> np.ndarray:
        sig, _ = read_wav(self.files[item], mono=True,
                          target_rate=self.frequency)
        if self.img_mode == "raw":
            size = int(np.log2(np.sqrt(sig.shape[0])))
            img = sig[:(2 ** size) ** 2].reshape(2 ** size, 2 ** size)
        else:
            S = stft_np(sig, self.n_fft, self.hop_length)
            if S.shape[1] < self.n_fft // 2:
                # the reference crashes later with a cryptic shape error in
                # the pyramid downsample (its phase-strided slices disagree
                # on a non-square image); fail early and say why
                need = (self.n_fft // 2 - 1) * self.hop_length
                raise ValueError(
                    f"{self.files[item]}: {sig.shape[0]} samples yield only "
                    f"{S.shape[1]} STFT frames — a square "
                    f"{self.n_fft // 2}x{self.n_fft // 2} {self.img_mode} "
                    f"image needs >= {need} samples "
                    f"(n_fft={self.n_fft}, hop={self.hop_length})")
            S = S[:self.n_fft // 2, :self.n_fft // 2]
            if self.img_mode == "abslog":
                img = np.log1p(np.abs(S))
            elif self.img_mode == "reallog":
                img = np.log1p(np.abs(S.real)) * np.sign(S.real)
            else:
                raise ValueError(f"unknown img_mode: {self.img_mode!r}")
        img = np.uint8(adjust_dynamic_range(
            img, (img.min(), img.max()), self.range_in))
        return img[:, :, np.newaxis]

    def create_datapoint_from_depth(self, datapoint, datapoint_depth,
                                    target_depth):
        if self.img_mode != "raw":
            return super().create_datapoint_from_depth(
                datapoint, datapoint_depth, target_depth)
        stride = 2 ** (datapoint_depth - target_depth)
        return datapoint[::stride, ::stride, :]


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
