"""Minimal WAV I/O on scipy, with no audio library: a copy of
``pggan_tpu/data/audio_io.py`` (numpy and scipy only).

The reference chains librosa/soundfile imports with fallbacks
(dataset.py:16-28) and writes through ``librosa.output.write_wav``
(output_postprocess.py:136-141). Reading and writing go through
scipy.io.wavfile instead, normalizing to float32 mono like the reference's
load path (dataset.py:286-288); resampling is scipy's polyphase filter.
"""

from __future__ import annotations

import numpy as np

from scipy.io import wavfile as _wavfile


def resample(sig: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample a 1-D float signal from ``sr_in`` to ``sr_out`` Hz
    (``scipy.signal.resample_poly`` over the reduced up/down ratio — the
    standard anti-aliased integer-ratio path librosa itself delegates to)."""
    if sr_in == sr_out:
        return sig
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(int(sr_in), int(sr_out))
    return resample_poly(sig, int(sr_out) // g, int(sr_in) // g).astype(
        np.float32)


def read_wav(path: str, mono: bool = True,
             target_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 signal in [-1, 1], sample_rate).

    ``target_rate`` resamples to that rate (polyphase, anti-aliased) and
    returns it as the rate — the behaviour the reference *intends* with
    ``librosa.load(path, sr=self.frequency)`` (dataset.py:19,286) but
    silently loses when soundfile shadows librosa (dataset.py:23-28): a
    44.1 kHz corpus fed to a 16 kHz pipeline would train at the wrong time
    scale."""
    sr, data = _wavfile.read(path)
    if data.dtype == np.int16:
        sig = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        sig = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        sig = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 wavs
        sig = data.astype(np.float32)
    if mono and sig.ndim == 2:
        sig = sig.mean(axis=1)  # stereo -> mono (reference dataset.py:287-288)
    if target_rate is not None and int(target_rate) > 0:
        sig = resample(sig, int(sr), int(target_rate))
        sr = int(target_rate)
    return sig, int(sr)


def write_wav(path: str, signal: np.ndarray, sample_rate: int,
              norm: bool = True) -> None:
    """Write float signal as 16-bit PCM; ``norm`` peak-normalizes first
    (librosa ``write_wav(..., norm=True)`` behaviour the reference relies on,
    output_postprocess.py:136-141)."""
    sig = np.asarray(signal, np.float32)
    if norm:
        peak = np.abs(sig).max()
        if peak > 0:
            sig = sig / peak
    pcm = np.clip(sig, -1.0, 1.0)
    _wavfile.write(path, int(sample_rate), (pcm * 32767.0).astype(np.int16))
