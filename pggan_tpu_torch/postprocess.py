"""Sample postprocessors: NCHW numpy samples -> artifacts, PNG grids and
WAVs (the counterpart of ``pggan_tpu/postprocess.py``, reference
output_postprocess.py). The SoundSaver's Griffin-Lim runs batched over a
tick's samples on its ``device`` (``ops/stft.griffin_lim_batch``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pggan_tpu_torch.data.audio_io import write_wav
from pggan_tpu_torch.ops.stft import griffin_lim_batch, istft_np
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


class SoundSaver(Postprocessor):
    """Spectrogram/raw image -> WAV (reference output_postprocess.py:74-153).

    - ``abslog``: invert the magnitude by Griffin-Lim on ``device``, all of
      a call's samples in one batch, each from the same seeded start.
    - ``reallog``: invert the signed-log real-part STFT directly (host).
    - ``raw``: flatten pixels into the waveform.

    Frequency bins are padded to 2**i + 1 (real spectrograms have
    2**i + 1 bins, output_postprocess.py:109-111), each signal is
    peak-normalized, nearest-upsampled to make up for a reduced resolution,
    and written per sample as ``fakes_sound_{kimg}_{i}.wav``. A failed write
    is trapped to ``error_*.txt`` like the reference
    (output_postprocess.py:142-144). ``device`` is the JAX package's
    ``use_device``: the card unless ``device="cpu"``.
    """

    output_file_format = "fakes_sound_{}_{}.wav"

    def __init__(self, samples_path=".", drange=(-1, 1), resolution=512,
                 mode="abslog", sample_rate=16000, hop_length=128,
                 create_subdirs=True, verbose=False, griffin_lim_iter=100,
                 device="cuda"):
        super().__init__(samples_path)
        if create_subdirs:
            os.makedirs(self.samples_path, exist_ok=True)
        self.drange = tuple(drange)
        self.mode = mode
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.verbose = verbose
        self.resolution = resolution
        self.griffin_lim_iter = griffin_lim_iter
        self.device = device

    def initial_guess(self, length: int) -> torch.Tensor:
        """Griffin-Lim's starting signal: a standard normal draw from a
        generator seeded 0 on the device, the same at every call (the JAX
        package draws from ``PRNGKey(0)``)."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        return torch.randn(length, generator=gen, device=self.device)

    def reconstruct_from_magnitude(self, mags: np.ndarray) -> np.ndarray:
        """(B, F, T) magnitudes -> (B, L) signals by Griffin-Lim."""
        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SoundSaver(device={self.device!r}): CUDA is "
                               "not available (pass device='cpu')")
        mags = torch.from_numpy(np.asarray(mags, np.float32)).to(device)
        x0 = self.initial_guess((mags.shape[2] - 1) * self.hop_length)
        return griffin_lim_batch(mags, self.griffin_lim_iter, self.hop_length,
                                 x0=x0, verbose=self.verbose).cpu().numpy()

    def _pad_top_bin(self, image: np.ndarray) -> np.ndarray:
        """Real spectrograms have 2**i + 1 frequency bins; the square model
        output dropped the top one -- restore it as zeros (reference
        output_postprocess.py:109-111)."""
        return np.pad(np.asarray(image, np.float32), ((0, 1), (0, 0)))

    def _signal_reallog(self, image: np.ndarray) -> np.ndarray:
        # invert the signed-log real-part encoding: sgn(x) * (e^|x| - 1)
        signed = adjust_dynamic_range(self._pad_top_bin(image),
                                      self.drange, (-1, 1))
        real_part = np.sign(signed) * np.expm1(np.abs(signed))
        return istft_np(real_part.astype(np.complex64), self.hop_length)

    def signals(self, images) -> list:
        """Peak-normalized signals for a call's (H, W) images."""
        if self.mode == "abslog":
            mags = np.stack([
                adjust_dynamic_range(self._pad_top_bin(im), self.drange,
                                     (0, 255)) for im in images])
            sigs = list(self.reconstruct_from_magnitude(mags))
        elif self.mode == "reallog":
            sigs = [self._signal_reallog(im) for im in images]
        elif self.mode == "raw":
            sigs = [np.asarray(im, np.float32).ravel() for im in images]
        else:
            raise ValueError(
                f"unrecognized mode: {self.mode}. "
                "Available modes are: reallog, abslog, raw.")
        out = []
        for s in sigs:
            peak = np.abs(s).max()
            out.append(s / peak if peak > 0 else s)
        return out

    def output_wav(self, signal: np.ndarray, samples_description, ith: int):
        desc = (f"{samples_description:06}"
                if isinstance(samples_description, int)
                else str(samples_description))
        path = os.path.join(self.samples_path,
                            self.output_file_format.format(desc, f"{ith:02}"))
        try:
            write_wav(path, signal, self.sample_rate, norm=True)
        except Exception as e:  # the reference's error file, and go on
            err = os.path.join(self.samples_path,
                               f"error_{samples_description}_{ith}.txt")
            with open(err, "w") as f:
                f.write(f"Exception trying to save sound: {e}")

    def __call__(self, output: np.ndarray, samples_description):
        times_smaller = max(self.resolution // output.shape[-1], 1)
        if self.mode == "raw":
            times_smaller *= times_smaller
        for i, signal in enumerate(self.signals([img[0] for img in output])):
            signal = numpy_upsample_nearest(signal, 1,
                                            scale_factor=times_smaller)
            self.output_wav(signal, samples_description, i)
