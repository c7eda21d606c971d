"""STFT, inverse STFT and Griffin-Lim: the counterpart of
``pggan_tpu/ops/stft.py``.

Two routes, as in the JAX package. The numpy host functions (``stft_np``,
``istft_np``, ``griffin_lim_np``) are copies of the JAX package's: the
per-file host path of the sound dataset and the plain versions the device
functions are held against. The device functions take tensors on any
device and run batched there: ``stft`` is ``torch.stft``, ``istft`` the
JAX package's overlap-add written as ``F.fold`` (``torch.istft`` enforces
the NOLA condition and trims by ``length`` its own way), ``sound_images``
the batched spectrogram-image extraction of the sound dataset, and
``griffin_lim_batch`` the SoundSaver's phase retrieval, whose iterations
queue on the device with no host round trip.

Conventions match librosa's defaults: periodic Hann window, centred frames
with reflect padding, ``1 + n_fft//2`` frequency bins. The JAX package runs
these as plain XLA, in no Pallas kernel; here they are ``torch.fft`` and
``F.fold``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann (librosa/scipy ``fftbins=True`` convention)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# numpy host versions (the per-file path and the plain versions)
# ---------------------------------------------------------------------------

def stft_np(y: np.ndarray, n_fft: int = 2048, hop_length: int | None = None,
            center: bool = True) -> np.ndarray:
    """Short-time Fourier transform -> complex (1 + n_fft//2, n_frames)."""
    if hop_length is None:
        hop_length = n_fft // 4
    y = np.asarray(y, np.float32)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    if n_frames < 1:
        raise ValueError(f"signal too short for n_fft={n_fft}")
    strides = (y.strides[0] * hop_length, y.strides[0])
    frames = np.lib.stride_tricks.as_strided(
        y, shape=(n_frames, n_fft), strides=strides)
    spec = np.fft.rfft(frames * hann_window(n_fft)[None, :], axis=1)
    return spec.T.astype(np.complex64)


def istft_np(S: np.ndarray, hop_length: int | None = None,
             center: bool = True) -> np.ndarray:
    """Inverse STFT with windowed overlap-add and NOLA normalization."""
    n_fft = (S.shape[0] - 1) * 2
    if hop_length is None:
        hop_length = n_fft // 4
    win = hann_window(n_fft)
    frames = np.fft.irfft(S.T, n=n_fft, axis=1).astype(np.float32) * win[None, :]
    n_frames = frames.shape[0]
    length = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(length, np.float32)
    wsum = np.zeros(length, np.float32)
    for t in range(n_frames):
        x[t * hop_length:t * hop_length + n_fft] += frames[t]
        wsum[t * hop_length:t * hop_length + n_fft] += win * win
    x = x / np.maximum(wsum, 1e-8)
    if center:
        x = x[n_fft // 2: length - n_fft // 2]
    return x


def griffin_lim_np(mag: np.ndarray, n_iter: int = 100,
                   hop_length: int | None = None,
                   seed: int = 0, verbose: bool = False) -> np.ndarray:
    """Host Griffin-Lim, mirroring the reference loop
    (output_postprocess.py:92-105): start from noise, iterate
    stft -> keep phase -> istft. ``verbose`` prints the per-iteration
    inter-iterate distance like the reference (output_postprocess.py:99-104)."""
    n_fft = (mag.shape[0] - 1) * 2
    if hop_length is None:
        hop_length = n_fft // 4
    rng = np.random.RandomState(seed)
    x = rng.randn((mag.shape[1] - 1) * hop_length).astype(np.float32)
    for _ in range(n_iter):
        S = stft_np(x, n_fft, hop_length)
        S = S[:, :mag.shape[1]]
        phase = S / (np.abs(S) + 1e-8)
        pad = mag.shape[1] - S.shape[1]
        if pad > 0:
            phase = np.pad(phase, ((0, 0), (0, pad)), constant_values=1.0)
        prev_x = x
        x = istft_np(mag * phase, hop_length)
        if verbose:
            n = min(len(x), len(prev_x))
            mse = np.sqrt(np.square(x[:n] - prev_x[:n]).sum())
            print(f"MSE between sub- and ultimate iteration: {mse}")
    return x


# ---------------------------------------------------------------------------
# device versions on tensors
# ---------------------------------------------------------------------------

def _window(n_fft: int, device) -> torch.Tensor:
    """The numpy window on ``device``, so both routes use the same bits."""
    return torch.from_numpy(hann_window(n_fft)).to(device)


def stft(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Centred STFT of (..., L) float32 signals -> (..., 1 + n_fft//2,
    n_frames) complex64 (``stft_jax``)."""
    lead = y.shape[:-1]
    S = torch.stft(y.reshape(-1, y.shape[-1]), n_fft, hop_length,
                   window=_window(n_fft, y.device), center=True,
                   pad_mode="reflect", onesided=True, return_complex=True)
    return S.reshape(*lead, *S.shape[-2:])


def istft(S: torch.Tensor, hop_length: int,
          length: int | None = None) -> torch.Tensor:
    """Inverse of the centred STFT, (..., F, T) -> (..., L) float32
    (``istft_jax``): irFFT, window, overlap-add, then division by the
    summed squared window clamped at 1e-8, trimmed like the JAX
    function."""
    n_fft = (S.shape[-2] - 1) * 2
    lead, n_frames = S.shape[:-2], S.shape[-1]
    win = _window(n_fft, S.device)
    frames = torch.fft.irfft(S.reshape(-1, *S.shape[-2:]).transpose(1, 2),
                             n=n_fft, dim=-1) * win
    total = n_fft + hop_length * (n_frames - 1)

    def overlap_add(cols):  # (B, n_frames, n_fft) -> (B, total)
        return F.fold(cols.transpose(1, 2), (1, total), (1, n_fft),
                      stride=(1, hop_length)).reshape(cols.shape[0], total)

    x = overlap_add(frames)
    wsum = overlap_add((win * win).expand(1, n_frames, n_fft))
    x = (x / torch.clamp_min(wsum, 1e-8))[:, n_fft // 2: total - n_fft // 2]
    if length is not None:
        x = x[:, :length]
    return x.reshape(*lead, x.shape[-1])


def sound_image_signal_length(n_fft: int, hop_length: int) -> int:
    """Samples needed so the cropped n_fft//2-frame window sees only real
    samples (no end-reflection bleed): frames 0..n_fft//2-1 of a centered
    STFT cover ``(n_fft//2 - 1) * hop + n_fft//2`` pre-padding samples."""
    return (n_fft // 2 - 1) * hop_length + n_fft // 2


def sound_images(signals: torch.Tensor, n_fft: int, hop_length: int,
                 img_mode: str, range_in=(0, 255)) -> torch.Tensor:
    """Batched spectrogram images (``sound_images_jax``): (F, L) float32
    signals -> (F, n_fft//2, n_fft//2) uint8, on the signals' device: STFT,
    square crop, log transform, per-file min-max remap to ``range_in``,
    clipped to 0..255 and then truncated as the host path's ``np.uint8``
    does. The host path divides by ``hi - lo``; here the span is clamped
    at 1e-20, as in JAX."""
    if img_mode not in ("abslog", "reallog"):
        raise ValueError(f"unknown img_mode: {img_mode!r}")
    lo_out, hi_out = range_in
    half = n_fft // 2
    S = stft(signals.float(), n_fft, hop_length)[:, :half, :half]
    if img_mode == "abslog":
        img = torch.log1p(S.abs())
    else:  # signed log of the real part (reference dataset.py:298)
        img = torch.log1p(S.real.abs()) * torch.sign(S.real)
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = (hi_out - lo_out) / torch.clamp_min(hi - lo, 1e-20)
    imgs = (img - lo) * scale + lo_out
    return imgs.clamp(0, 255).to(torch.uint8)  # float -> uint8 truncates


def griffin_lim_batch(mags: torch.Tensor, n_iter: int = 100,
                      hop_length: int | None = None,
                      x0: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      verbose: bool = False) -> torch.Tensor:
    """Griffin-Lim for a (B, F, T) magnitude batch on its device -> (B, L)
    signals, L = (T - 1) * hop (``_griffin_lim_batch_jitted``). Every
    sample starts from the same guess ``x0`` (L,), drawn from a standard
    normal with ``generator`` (a generator on the magnitudes' device) when
    not given, so a batch equals its samples run one by one. The loop queues
    its ``n_iter`` iterations on the device and waits for none of them;
    ``verbose`` prints each iteration's distance to the last (the
    reference's print, output_postprocess.py:99-104), which waits for each."""
    n_fft = (mags.shape[1] - 1) * 2
    if hop_length is None:
        hop_length = n_fft // 4
    n_frames = mags.shape[2]
    length = (n_frames - 1) * hop_length
    if x0 is None:
        x0 = torch.randn(length, generator=generator, device=mags.device)
    if x0.shape != (length,):
        raise ValueError(f"x0 of shape {tuple(x0.shape)}, need ({length},)")
    x = x0.to(mags.device, torch.float32).expand(mags.shape[0], length)
    for _ in range(n_iter):
        S = stft(x, n_fft, hop_length)[..., :n_frames]
        phase = S / (S.abs() + 1e-8)
        prev, x = x, istft(mags * phase, hop_length, length=length)
        if verbose:
            dist = torch.linalg.vector_norm(x - prev, dim=1)
            print(f"distance between sub- and ultimate iteration: "
                  f"{dist.tolist()}")
    return x


def griffin_lim(mag: torch.Tensor, n_iter: int = 100,
                hop_length: int | None = None,
                x0: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Griffin-Lim of one (F, T) magnitude -> (L,) (``_griffin_lim_jitted``
    / ``griffin_lim_jax``)."""
    return griffin_lim_batch(mag[None], n_iter, hop_length, x0, generator)[0]
