"""The port's audio path on the CPU against pggan_tpu's, on the same seeded
numpy inputs: WAV I/O and resampling bit for bit; the STFT, inverse STFT,
the batched spectrogram images and Griffin-Lim against the JAX device
functions (JAX's Griffin-Lim start passed in); the SoundSaver's WAVs in
its three modes; and a tiny ``cli.train --device cpu`` run on a sound
dataset that writes WAVs. Each test states its tolerance.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pggan_tpu import postprocess as jpost
from pggan_tpu.data import audio_io as jaudio
from pggan_tpu.ops import stft as jstft
from pggan_tpu_torch import postprocess
from pggan_tpu_torch.data import audio_io
from pggan_tpu_torch.ops import stft

N_FFT, HOP = 64, 16


def _signals(n, length, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 16000.0
    return np.stack([np.sin(2 * np.pi * (300 + 400 * i + 900 * t) * t)
                     + 0.1 * rng.randn(length)
                     for i in range(n)]).astype(np.float32)


# -- WAV I/O -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.float32])
@pytest.mark.parametrize("stereo", [False, True])
def test_read_wav_equals_jax(tmp_path, dtype, stereo):
    rng = np.random.RandomState(1)
    shape = (900, 2) if stereo else (900,)
    if dtype == np.float32:
        data = rng.uniform(-1, 1, shape).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.randint(info.min, info.max, shape).astype(dtype)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 8000, data)
    for target in (None, 8000, 16000, 11025):
        got, sr = audio_io.read_wav(path, target_rate=target)
        want, jsr = jaudio.read_wav(path, target_rate=target)
        assert sr == jsr and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_write_wav_and_resample_equal_jax(tmp_path):
    sig = _signals(1, 1000)[0] * 3.0
    for norm in (True, False):
        audio_io.write_wav(str(tmp_path / "p.wav"), sig, 16000, norm=norm)
        jaudio.write_wav(str(tmp_path / "j.wav"), sig, 16000, norm=norm)
        assert (tmp_path / "p.wav").read_bytes() == \
            (tmp_path / "j.wav").read_bytes()
    for rates in ((16000, 16000), (16000, 8000), (44100, 16000)):
        np.testing.assert_array_equal(audio_io.resample(sig, *rates),
                                      jaudio.resample(sig, *rates))


# -- STFT ------------------------------------------------------------------------

def test_host_functions_equal_jax():
    """The numpy host path is a copy: bit for bit."""
    y = _signals(1, 3000)[0]
    np.testing.assert_array_equal(stft.hann_window(N_FFT),
                                  jstft.hann_window(N_FFT))
    S = stft.stft_np(y, N_FFT, HOP)
    np.testing.assert_array_equal(S, jstft.stft_np(y, N_FFT, HOP))
    np.testing.assert_array_equal(stft.istft_np(S, HOP),
                                  jstft.istft_np(S, HOP))
    mag = np.abs(S[:, :20])
    np.testing.assert_array_equal(stft.griffin_lim_np(mag, 3, HOP),
                                  jstft.griffin_lim_np(mag, 3, HOP))


@pytest.mark.parametrize("hop", [16, 32])
def test_stft_and_istft_match_jax(hop):
    """rtol 1e-5, atol 1e-5 x the largest element (pocketfft in float32
    against XLA's FFT)."""
    ys = _signals(3, 2500)
    S = stft.stft(torch.from_numpy(ys), N_FFT, hop).numpy()
    want = np.stack([np.asarray(jstft.stft_jax(jnp.asarray(y), N_FFT, hop))
                     for y in ys])
    assert S.shape == want.shape and S.dtype == np.complex64
    np.testing.assert_allclose(S, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for length in (None, 2000):
        x = stft.istft(torch.from_numpy(want), hop, length=length).numpy()
        wx = np.stack([np.asarray(jstft.istft_jax(jnp.asarray(s), hop,
                                                  length=length))
                       for s in want])
        assert x.shape == wx.shape
        np.testing.assert_allclose(x, wx, rtol=1e-5,
                                   atol=1e-5 * np.abs(wx).max())


@pytest.mark.parametrize("mode", ["abslog", "reallog"])
@pytest.mark.parametrize("range_in", [(0, 255), (16, 235)])
def test_sound_images_match_jax(mode, range_in):
    """JAX's own bar for two FFTs' images (tests/test_data.py:160-172):
    at most 1 level apart, at least 98% of pixels equal."""
    need = stft.sound_image_signal_length(N_FFT, HOP)
    sigs = _signals(4, need, seed=2)
    got = stft.sound_images(torch.from_numpy(sigs), N_FFT, HOP, mode,
                            range_in).numpy()
    want = np.asarray(jstft.sound_images_jax(sigs, N_FFT, HOP, mode,
                                             range_in))
    assert got.shape == want.shape == (4, N_FFT // 2, N_FFT // 2)
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98


def test_sound_images_clip_then_truncate():
    """A constant signal has a zero span: the clamp keeps it finite, and
    the clip to 0..255 comes before the truncation to uint8."""
    flat = torch.zeros(1, stft.sound_image_signal_length(N_FFT, HOP))
    img = stft.sound_images(flat, N_FFT, HOP, "abslog")
    assert img.dtype == torch.uint8 and int(img.max()) == 0
    with pytest.raises(ValueError, match="img_mode"):
        stft.sound_images(flat, N_FFT, HOP, "raw")
    assert stft.sound_image_signal_length(1024, 128) == \
        jstft.sound_image_signal_length(1024, 128) == 65920


def _jax_x0(n_frames, hop, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      ((n_frames - 1) * hop,), jnp.float32))


def test_griffin_lim_matches_jax_from_its_start():
    """Five iterations from JAX's x0: relative L2 at most 1e-4."""
    mag = np.abs(jstft.stft_np(_signals(1, 1500, seed=3)[0], N_FFT, HOP))
    x0 = _jax_x0(mag.shape[1], HOP)
    want = np.asarray(jstft._griffin_lim_jitted(
        jnp.asarray(mag), jnp.asarray(x0), 5, HOP, N_FFT))
    got = stft.griffin_lim(torch.from_numpy(mag), 5, HOP,
                           x0=torch.from_numpy(x0)).numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_griffin_lim_batch_equals_serial_and_draws_x0():
    mags = torch.from_numpy(np.abs(np.stack([
        jstft.stft_np(s, N_FFT, HOP) for s in _signals(3, 1200, seed=4)])))
    x0 = torch.randn((mags.shape[2] - 1) * HOP,
                     generator=torch.Generator().manual_seed(5))
    batch = stft.griffin_lim_batch(mags, 4, HOP, x0=x0)
    for i in range(3):
        torch.testing.assert_close(
            batch[i], stft.griffin_lim(mags[i], 4, HOP, x0=x0),
            rtol=0, atol=0)
    drawn = stft.griffin_lim_batch(
        mags, 4, HOP, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(drawn, batch, rtol=0, atol=0)
    with pytest.raises(ValueError, match="x0"):
        stft.griffin_lim_batch(mags, 1, HOP, x0=x0[:-1])


def test_griffin_lim_verbose_prints_each_iteration(capsys):
    mags = torch.rand(2, N_FFT // 2 + 1, 6)
    stft.griffin_lim_batch(mags, 3, HOP, x0=torch.zeros(5 * HOP),
                           verbose=True)
    assert capsys.readouterr().out.count("distance between") == 3


# -- SoundSaver ------------------------------------------------------------------

def _images(n=3, size=32, seed=6):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, 1, size, size)).astype(np.float32)


def _wavs(path):
    return [wavfile.read(p)[1] for p in sorted(glob.glob(
        os.path.join(path, "*.wav")))]


@pytest.mark.parametrize("mode", ["raw", "reallog"])
def test_sound_saver_wavs_equal_jax(tmp_path, mode):
    """raw and reallog run on the host in both packages: equal files."""
    kw = dict(mode=mode, hop_length=HOP, resolution=64)
    postprocess.SoundSaver(str(tmp_path / "p"), device="cpu", **kw)(
        _images(), 7)
    jpost.SoundSaver(str(tmp_path / "j"), **kw)(_images(), 7)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        f"fakes_sound_000007_{i:02}.wav" for i in range(3)]
    for a, b in zip(_wavs(tmp_path / "p"), _wavs(tmp_path / "j")):
        np.testing.assert_array_equal(a, b)


def test_sound_saver_abslog_matches_jax_from_its_start(tmp_path,
                                                       monkeypatch):
    """abslog through the start seam: JAX's x0 in, then the 16-bit WAVs of
    five iterations within 1e-4 of full scale of JAX's (batched route on
    both sides)."""
    imgs = _images(n=2)
    n_frames = imgs.shape[-1]
    monkeypatch.setattr(postprocess.SoundSaver, "initial_guess",
                        lambda self, n: torch.from_numpy(
                            _jax_x0(n_frames, HOP)))
    kw = dict(mode="abslog", hop_length=HOP, resolution=64,
              griffin_lim_iter=5)
    postprocess.SoundSaver(str(tmp_path / "p"), device="cpu", **kw)(imgs, 0)
    jpost.SoundSaver(str(tmp_path / "j"), **kw)(imgs, 0)
    got, want = _wavs(tmp_path / "p"), _wavs(tmp_path / "j")
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2 * (n_frames - 1) * HOP,)
        assert np.abs(a.astype(np.int32) - b).max() <= 1e-4 * 32767


def test_sound_saver_seeded_start_and_error_file(tmp_path, monkeypatch):
    saver = postprocess.SoundSaver(str(tmp_path), device="cpu",
                                   hop_length=HOP, griffin_lim_iter=2)
    torch.testing.assert_close(saver.initial_guess(40),
                               saver.initial_guess(40), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unrecognized mode"):
        postprocess.SoundSaver(str(tmp_path), mode="x",
                               device="cpu").signals([np.zeros((4, 4))])

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(postprocess, "write_wav", broken)
    saver(_images(n=1), 3)
    err = tmp_path / "error_3_0.txt"
    assert "disk full" in err.read_text()


def test_sound_saver_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    saver = postprocess.SoundSaver(str(tmp_path), hop_length=HOP)
    assert saver.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        saver(_images(n=1), 0)


# -- the train CLI on a sound dataset ----------------------------------------------

def test_train_cli_on_sound_files_writes_wavs(tmp_path):
    """A few steps of ``cli.train --device cpu`` on a SoundImageDataset
    (preloaded: the batched STFT on the CPU) with the ImageSaver and the
    SoundSaver: WAVs and a PNG land in the run directory."""
    from pggan_tpu_torch.cli import train as cli
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i, s in enumerate(_signals(3, stft.sound_image_signal_length(
            N_FFT, HOP), seed=8)):
        audio_io.write_wav(str(wav_dir / f"{i}.wav"), s, 16000)
    cli.cli_main([
        "--device", "cpu", "--dataset_class", "SoundImageDataset",
        "--SoundImageDataset.dir_path", str(wav_dir),
        "--SoundImageDataset.preload", "True",
        "--SoundImageDataset.n_fft", str(N_FFT),
        "--SoundImageDataset.hop_length", str(HOP),
        "--postprocessors", "['ImageSaver','SoundSaver']",
        "--SoundSaver.hop_length", str(HOP),
        "--SoundSaver.griffin_lim_iter", "3",
        "--OutputGenerator.samples_count", "2",
        "--Generator.fmap_base", "32", "--Generator.fmap_max", "8",
        "--Generator.latent_size", "8", "--Discriminator.fmap_base", "32",
        "--Discriminator.fmap_max", "8", "--total_kimg", "0.012",
        "--DepthManager.minibatch_default", "4",
        "--DepthManager.tick_kimg_overrides", "{}",
        "--DepthManager.tick_kimg_default", "0.008",
        "--num_data_workers", "1", "--result_dir", str(tmp_path / "r")])
    run, = glob.glob(str(tmp_path / "r" / "001-*"))
    wavs = glob.glob(os.path.join(run, "fakes_sound_*.wav"))
    assert len(wavs) >= 2 and glob.glob(os.path.join(run, "fakes_*.png"))
    assert not glob.glob(os.path.join(run, "error_*.txt"))
    sig = wavfile.read(wavs[0])[1]
    assert np.abs(sig).max() > 16000  # peak-normalized, not silent
