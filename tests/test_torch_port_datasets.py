"""The port's file datasets and host library on the CPU against pggan_tpu's,
on the same seeded files: the image-folder, H5 and sound datasets' items
and raw batches at several depths and alphas, in every preload mode (in
memory, lazy, the on-disk pyramid), pickling, the disk cache's reuse,
invalidation, concurrent build and dead-builder takeover, resampling to
``frequency``, the short-file error, the host library against the numpy
versions and ``pggan_tpu/data/native.py``, and a tiny ``cli.train
--device cpu`` run on an image folder. Bit for bit unless a test says
otherwise (the STFT images: JAX's own bar, at most 1 level apart and at
least 98% equal).
"""

import glob
import os
import pickle
import threading

import numpy as np
import pytest

from pggan_tpu.data import datasets as jdatasets
from pggan_tpu.data import loader as jloader
from pggan_tpu.data import native as jnative
from pggan_tpu_torch.data import datasets, loader, native
from pggan_tpu_torch.data.audio_io import write_wav

ALPHAS = [1.0, 0.6, 0.0]


def _write_pngs(d, n=5, size=32, channels=3, seed=1):
    from PIL import Image
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        arr = rng.randint(0, 256, (size, size, channels), dtype=np.uint8)
        Image.fromarray(arr if channels == 3 else arr[..., 0]).save(
            os.path.join(d, f"img_{i:03}.png"))
    return d


def _write_wavs(d, n=3, num_samples=3000, sr=16000, seed=3):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / sr
    for i in range(n):
        sig = np.sin(2 * np.pi * (300 + 200 * i) * t) + 0.1 * rng.randn(
            num_samples)
        write_wav(os.path.join(d, f"s{i}.wav"), sig.astype(np.float32), sr)
    return d


def _write_h5(path, n=10, seed=2):
    import h5py
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for r in (4, 8, 16):
            f.create_dataset(f"data{r}x{r}", data=rng.randint(
                0, 256, (n, 3, r, r), dtype=np.uint8))
    return path


def _same_items(port, ref, depths, alphas=ALPHAS, idxs=(3, 0, 3, 1)):
    """Items (fade + remap) and raw batches equal at every depth/alpha."""
    assert port.shape == ref.shape and len(port) == len(ref)
    for depth in depths:
        for alpha in alphas:
            for ds in (port, ref):
                ds.model_depth, ds.alpha = depth, alpha
            for i in sorted(set(idxs)):
                got, want = port[i], ref[i]
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(
                    got, want, err_msg=f"depth {depth} alpha {alpha}")
            raw, jraw = port.raw_batch(list(idxs)), ref.raw_batch(list(idxs))
            assert (raw is None) == (jraw is None)
            if raw is not None:
                np.testing.assert_array_equal(raw, jraw)


# -- the host library ------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_native_box_downsample_equals_numpy_and_jax(factor):
    img = np.random.RandomState(factor).randint(0, 256, (32, 16, 3),
                                                dtype=np.uint8)
    got = native.box_downsample_u8(img, factor)
    want = np.uint8(np.clip(np.round(datasets.box_downsample(img, factor)),
                            0, 255))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.box_downsample_u8(img,
                                                                 factor))


@pytest.mark.parametrize("alpha", [1.0, 0.75, 0.6, 0.3, 0.0])
@pytest.mark.parametrize("ranges", [((0, 255), (-1, 1)), ((16, 235), (-2, 3))])
def test_native_prep_equals_numpy_and_jax(monkeypatch, alpha, ranges):
    """Bit for bit against the numpy version (the port's) and against
    pggan_tpu/data/native.py on its numpy fallback. Its C++ library blends
    as ``a*v + (1-a)*t`` where numpy writes ``v + (t-v)*(1-a)``: equal at
    alpha 1, within 1e-5 (tests/test_native.py's bar) otherwise."""
    u8 = np.random.RandomState(9).randint(0, 256, (3, 8, 16, 3),
                                          dtype=np.uint8)
    got = native.prep_batch_f32(u8, alpha, *ranges)
    np.testing.assert_array_equal(got, datasets.prep_batch_f32(
        u8, alpha, *ranges))
    lib = jnative.prep_batch_f32(u8, alpha, *ranges)
    if alpha == 1.0:
        np.testing.assert_array_equal(got, lib)
    np.testing.assert_allclose(got, lib, rtol=0, atol=1e-5)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    np.testing.assert_array_equal(got, jnative.prep_batch_f32(
        u8, alpha, *ranges))


def test_native_validates_its_inputs():
    with pytest.raises(TypeError, match="uint8"):
        native.prep_batch_f32(np.zeros((1, 4, 4, 1), np.float32), 1.0)
    with pytest.raises(ValueError, match="even"):
        native.prep_batch_f32(np.zeros((1, 3, 4, 1), np.uint8), 0.5)
    with pytest.raises(ValueError, match="divide"):
        native.box_downsample_u8(np.zeros((6, 4, 1), np.uint8), 4)


def test_native_builds_once_across_threads(tmp_path, monkeypatch):
    """Cold builds into a fresh directory from several threads at once:
    one compile, one library, every thread gets it."""
    from pggan_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    compiles, libs = [], []
    real = native._compile
    monkeypatch.setattr(native, "_compile",
                        lambda out: (compiles.append(out), real(out)))
    threads = [threading.Thread(target=lambda: libs.append(native.library()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(compiles) == 1 and len(libs) == 4 and len(set(libs)) == 1
    assert [p.name for p in tmp_path.glob("libpggan_host-*.so")] == [
        compiles[0].name]


def test_native_failed_build_raises(tmp_path, monkeypatch):
    """No numpy fallback: a source that does not compile raises."""
    from pggan_tpu_torch.ops import _build
    bad = tmp_path / "host_prep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        native.prep_batch_f32(np.zeros((1, 2, 2, 1), np.uint8), 1.0)
    assert not list((tmp_path / "build").glob("*.so"))


def test_package_data_ships_the_host_source():
    import fnmatch
    import tomllib
    repo = native.SOURCE.parents[2]
    cfg = tomllib.loads((repo / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["pggan_tpu_torch"]
    assert native.SOURCE.exists()
    assert any(fnmatch.fnmatch(f"csrc/{native.SOURCE.name}", g)
               for g in globs)


# -- image folders -------------------------------------------------------------

@pytest.mark.parametrize("preload", [False, True, "disk"])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_image_folder_equals_jax(tmp_path, preload, mode):
    d = _write_pngs(str(tmp_path / "imgs"))
    kw = dict(preload=preload, imread_mode=mode)
    port = datasets.DefaultImageFolderDataset(
        d, cache_dir=str(tmp_path / "pc"), **kw)
    ref = jdatasets.DefaultImageFolderDataset(
        d, cache_dir=str(tmp_path / "jc"), **kw)
    assert port.max_dataset_depth == ref.max_dataset_depth == 5
    _same_items(port, ref, depths=(0, 2, 3))
    if preload:
        for lv in range(2, 6):
            np.testing.assert_array_equal(np.asarray(port.data[lv]),
                                          np.asarray(ref.data[lv]))
    if preload == "disk":
        lv = port.data[5]
        assert isinstance(lv, np.memmap) and not lv.flags.writeable


def test_image_folder_unused_depths_and_range(tmp_path):
    d = _write_pngs(str(tmp_path / "imgs"), n=3, size=16)
    for kw in (dict(create_unused_depths=True),
               dict(range_in=(16, 240), range_out=(0, 1))):
        port = datasets.DefaultImageFolderDataset(d, preload=True, **kw)
        ref = jdatasets.DefaultImageFolderDataset(d, preload=True, **kw)
        assert [x is None for x in port.data] == \
            [x is None for x in ref.data]
        for a, b in zip(port.data, ref.data):
            if a is not None:
                np.testing.assert_array_equal(a, b)
        _same_items(port, ref, depths=(0, 2), idxs=(2, 0))


def test_image_folder_default_cache_is_reused(tmp_path):
    """The default cache lives inside the corpus directory; a second
    construction lists files only and reuses it (the JAX package lists
    the cache directory as a file and fails here)."""
    d = _write_pngs(str(tmp_path / "imgs"), n=3, size=16)
    first = datasets.DefaultImageFolderDataset(d, preload="disk")
    assert os.path.isdir(os.path.join(d, ".pggan_pyramid_cache"))
    again = datasets.DefaultImageFolderDataset(d, preload="disk")
    assert again.files == first.files and len(again) == 3
    np.testing.assert_array_equal(np.asarray(again.data[4]),
                                  np.asarray(first.data[4]))


def test_disk_cache_reuse_and_invalidation(tmp_path, monkeypatch):
    d = _write_pngs(str(tmp_path / "imgs"), n=4, size=16, channels=1)
    kw = dict(preload="disk", cache_dir=str(tmp_path / "cache"),
              max_dataset_depth=4)
    first = datasets.DefaultImageFolderDataset(d, **kw)
    calls = []
    real = datasets.DefaultImageFolderDataset.load_file
    monkeypatch.setattr(datasets.DefaultImageFolderDataset, "load_file",
                        lambda self, i: (calls.append(i), real(self, i))[1])
    reopened = datasets.DefaultImageFolderDataset(d, **kw)
    assert calls == []  # a valid cache: no file decoded
    np.testing.assert_array_equal(np.asarray(reopened.data[3]),
                                  np.asarray(first.data[3]))
    from PIL import Image
    path = os.path.join(d, "img_000.png")
    size = os.path.getsize(path)
    Image.fromarray(np.full((16, 16), 7, np.uint8)).save(path)
    assert os.path.getsize(path) != size  # the fingerprint sees sizes
    rebuilt = datasets.DefaultImageFolderDataset(d, **kw)
    assert calls  # invalidated: rebuilt from the files
    np.testing.assert_array_equal(np.asarray(rebuilt.data[4][0]),
                                  np.full((16, 16, 1), 7, np.uint8))


def test_disk_cache_concurrent_build(tmp_path):
    """Three constructions on one cold cache at once: one builds under the
    O_EXCL lock, the others wait for its meta.json; all serve the same
    items, and no lock is left behind."""
    d = _write_pngs(str(tmp_path / "imgs"), n=5, size=32, channels=1)
    cache = str(tmp_path / "cache")
    builds, results, errors = [], [], []
    real = datasets.FolderDataset._build_disk_pyramid

    def counting(self, *a, **k):
        builds.append(1)
        return real(self, *a, **k)

    def construct():
        try:
            ds = datasets.DefaultImageFolderDataset(d, preload="disk",
                                                    cache_dir=cache)
            ds.model_depth = 3
            results.append(ds[0])
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    datasets.FolderDataset._build_disk_pyramid = counting
    try:
        threads = [threading.Thread(target=construct) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        datasets.FolderDataset._build_disk_pyramid = real
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(builds) == 1 and len(results) == 3
    ram = jdatasets.DefaultImageFolderDataset(d, preload=True)
    ram.model_depth = 3
    for got in results:
        np.testing.assert_array_equal(got, ram[0])
    assert not os.path.exists(os.path.join(cache, ".build_lock"))


def test_disk_cache_takes_over_a_dead_builder(tmp_path):
    """A stale lock with no meta.json: the waiter takes the build over once
    the lock is gone; with the lock held past the wait's timeout it
    raises."""
    d = _write_pngs(str(tmp_path / "imgs"), n=3, size=16, channels=1)
    cache = tmp_path / "cache"
    cache.mkdir()
    lock = cache / ".build_lock"
    lock.touch()
    timer = threading.Timer(0.5, os.unlink, args=(str(lock),))
    timer.start()
    try:
        ds = datasets.DefaultImageFolderDataset(d, preload="disk",
                                                cache_dir=str(cache))
    finally:
        timer.cancel()
    ds.model_depth = 2
    assert ds[0].shape == (16, 16, 1)
    other = cache.parent / "cache2"
    other.mkdir()
    (other / ".build_lock").touch()
    waiter = datasets.DefaultImageFolderDataset.__new__(
        datasets.DefaultImageFolderDataset)
    waiter.__dict__.update(ds.__dict__, cache_dir=str(other),
                           _data=[None] * 5)
    with pytest.raises(RuntimeError, match="timed out"):
        waiter._open_or_build_disk_pyramid(build_timeout=0.5)


def test_folder_datasets_pickle(tmp_path):
    d = _write_pngs(str(tmp_path / "imgs"), n=3, size=16)
    for preload in (True, "disk", False):
        ds = datasets.DefaultImageFolderDataset(
            d, preload=preload, imread_mode="RGB",
            cache_dir=str(tmp_path / "cache"))
        ds.model_depth, ds.alpha = 2, 0.5
        clone = pickle.loads(pickle.dumps(ds))
        np.testing.assert_array_equal(clone[1], ds[1])
        if preload == "disk":
            assert isinstance(clone.data[4], np.memmap)


# -- H5 ------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["H5Dataset", "OldH5Dataset"])
@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("max_images", [None, 4])
def test_h5_equals_jax(tmp_path, cls, preload, max_images):
    path = _write_h5(str(tmp_path / "toy.h5"))
    port = getattr(datasets, cls)(path, preload=preload,
                                  max_images=max_images)
    ref = getattr(jdatasets, cls)(path, preload=preload,
                                  max_images=max_images)
    try:
        _same_items(port, ref, depths=(0, 1, 2), idxs=(3, 1, 1, 0, 2))
        if not preload:
            assert isinstance(port.data[4], datasets._H5Window)
            with pytest.raises(IndexError):
                port.raw_batch([0, len(port)])
            np.testing.assert_array_equal(port.data[4][-1], ref.data[4][-1])
    finally:
        port.close()
        ref.close()


def test_h5_pickles_and_reads_old_pickles(tmp_path):
    path = _write_h5(str(tmp_path / "toy.h5"))
    win = datasets.H5Dataset(path, preload=False)
    win.model_depth = 1
    clone = pickle.loads(pickle.dumps(win))
    np.testing.assert_array_equal(clone[2], win[2])
    ram = datasets.H5Dataset(path, preload=True)
    state = ram.__getstate__()
    for k in ("preload", "max_images", "_h5"):
        state.pop(k)
    old = datasets.H5Dataset.__new__(datasets.H5Dataset)
    old.__setstate__(state)
    old.model_depth = ram.model_depth = 2
    np.testing.assert_array_equal(old[3], ram[3])
    for ds in (win, clone, ram):
        ds.close()


def test_gather_rows_equals_jax():
    arr = np.arange(60).reshape(10, 6)
    for items in ([3, 1, 1, 9], [0], [7, 7, 7]):
        np.testing.assert_array_equal(datasets._gather_rows(arr, items),
                                      jdatasets._gather_rows(arr, items))

    class SortedOnly:  # h5py's rule: sorted, unique selections
        def __getitem__(self, idx):
            assert list(idx) == sorted(set(idx))
            return arr[idx]
    np.testing.assert_array_equal(
        datasets._gather_rows(SortedOnly(), [5, 2, 5]), arr[[5, 2, 5]])


# -- sound -----------------------------------------------------------------------

@pytest.mark.parametrize("preload", [False, True, "disk"])
@pytest.mark.parametrize("mode", ["raw", "abslog", "reallog"])
def test_sound_dataset_equals_jax(tmp_path, preload, mode):
    """Lazy items and raw mode: the numpy host path on both sides, bit for
    bit. Preloaded abslog/reallog: the port's batched torch STFT against
    JAX's XLA one, at most 1 level apart and at least 98% equal."""
    d = _write_wavs(str(tmp_path / "wavs"))
    kw = dict(preload=preload, img_mode=mode, n_fft=64, hop_length=16)
    port = datasets.SoundImageDataset(d, device="cpu",
                                      cache_dir=str(tmp_path / "pc"), **kw)
    ref = jdatasets.SoundImageDataset(d, cache_dir=str(tmp_path / "jc"),
                                      **kw)
    assert port.shape == ref.shape
    if not preload or mode == "raw":
        _same_items(port, ref, depths=(0, 2), idxs=(2, 0))
        return
    got = np.asarray(port.data[port.max_dataset_depth])
    want = np.asarray(ref.data[ref.max_dataset_depth])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98
    host = np.stack([port.load_file(i) for i in range(len(port))])
    diff = np.abs(got.astype(np.int16) - host.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98


def test_sound_builds_batch_through_one_extraction(tmp_path, monkeypatch):
    """Both preload modes extract through ``sound_images`` in one batch:
    load_file runs once, for the constructor's shape probe; a chunk with a
    file too short for the batched window takes the host path."""
    d = _write_wavs(str(tmp_path / "wavs"), n=3, num_samples=600)
    calls, batches = [], []
    real_load = datasets.SoundImageDataset.load_file
    real_images = datasets.sound_images
    monkeypatch.setattr(datasets.SoundImageDataset, "load_file",
                        lambda self, i: (calls.append(i),
                                         real_load(self, i))[1])
    monkeypatch.setattr(datasets, "sound_images",
                        lambda s, *a: (batches.append(s.shape),
                                       real_images(s, *a))[1])
    kw = dict(n_fft=64, hop_length=16, device="cpu")
    for preload in (True, "disk"):
        calls.clear()
        datasets.SoundImageDataset(d, preload=preload,
                                   cache_dir=str(tmp_path / "c"), **kw)
        assert calls == [0]
    assert batches == [(3, 528), (3, 528)]
    short = _write_wavs(str(tmp_path / "short"), n=2, num_samples=510)
    calls.clear()
    datasets.SoundImageDataset(short, preload=True, **kw)
    assert calls == [0, 0, 1] and len(batches) == 2


def test_sound_device_batches_split_a_large_chunk(tmp_path, monkeypatch):
    """A chunk larger than STFT_BATCH goes to the device in pieces, with
    the same images."""
    d = _write_wavs(str(tmp_path / "wavs"), n=5, num_samples=600)
    kw = dict(n_fft=64, hop_length=16, device="cpu", preload=True)
    whole = datasets.SoundImageDataset(d, **kw)
    batches = []
    real_images = datasets.sound_images
    monkeypatch.setattr(datasets, "sound_images",
                        lambda s, *a: (batches.append(len(s)),
                                       real_images(s, *a))[1])
    monkeypatch.setattr(datasets.SoundImageDataset, "STFT_BATCH", 2)
    split = datasets.SoundImageDataset(d, **kw)
    assert batches == [2, 2, 1]
    np.testing.assert_array_equal(split.data[5], whole.data[5])


def test_sound_short_file_error_and_frequency(tmp_path):
    d = _write_wavs(str(tmp_path / "tiny"), n=1, num_samples=200)
    kw = dict(preload=True, n_fft=64, hop_length=16)
    with pytest.raises(ValueError) as port_err:
        datasets.SoundImageDataset(d, device="cpu", **kw)
    with pytest.raises(ValueError) as jax_err:
        jdatasets.SoundImageDataset(d, **kw)
    assert str(port_err.value) == str(jax_err.value)
    assert "a square 32x32 abslog image needs" in str(port_err.value)
    # 8 kHz files trained at 16 kHz are resampled on load, as in JAX
    d8 = _write_wavs(str(tmp_path / "8k"), n=2, num_samples=1200, sr=8000)
    for freq in (16000, None):
        port = datasets.SoundImageDataset(d8, frequency=freq, img_mode="raw",
                                          preload=False, device="cpu")
        ref = jdatasets.SoundImageDataset(d8, frequency=freq,
                                          img_mode="raw", preload=False)
        assert port.shape == ref.shape
        _same_items(port, ref, depths=(0,), alphas=(1.0,), idxs=(1,))


def test_sound_default_device_needs_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = _write_wavs(str(tmp_path / "wavs"), n=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        datasets.SoundImageDataset(d, preload=True, n_fft=64, hop_length=16)


# -- the loader and the train CLI on files ----------------------------------------

@pytest.mark.parametrize("raw", [False, True])
def test_loader_over_disk_pyramid_equals_jax(tmp_path, monkeypatch, raw):
    """One worker over the memmapped pyramid: the port's batches (host
    library prep) equal JAX's (its numpy prep) in sampler order."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    d = _write_pngs(str(tmp_path / "imgs"), n=5, size=16)
    kw = dict(preload="disk", imread_mode="RGB")
    port = datasets.DefaultImageFolderDataset(
        d, cache_dir=str(tmp_path / "pc"), **kw)
    ref = jdatasets.DefaultImageFolderDataset(
        d, cache_dir=str(tmp_path / "jc"), **kw)
    for ds in (port, ref):
        ds.model_depth, ds.alpha = 1, 0.6
    its = [loader.DataIterator(port, 3, num_workers=1, seed=4, raw=raw),
           jloader.DataIterator(ref, 3, num_workers=1, seed=4, raw=raw)]
    try:
        for _ in range(4):
            got, want = (next(it) for it in its)
            assert got.shape == (3, 8, 8, 3)
            np.testing.assert_array_equal(got, want)
    finally:
        for it in its:
            it.close()


def test_train_cli_on_an_image_folder(tmp_path):
    """A few steps of ``cli.train --device cpu`` on a disk-cached image
    folder, the loader's host prep through the host library."""
    from pggan_tpu_torch.cli import train as cli
    d = _write_pngs(str(tmp_path / "imgs"), n=6, size=16)
    trainer = cli.cli_main([
        "--device", "cpu", "--dataset_class", "DefaultImageFolderDataset",
        "--DefaultImageFolderDataset.dir_path", d,
        "--DefaultImageFolderDataset.preload", "disk",
        "--DefaultImageFolderDataset.imread_mode", "RGB",
        "--postprocessors", "['ImageSaver']",
        "--Generator.fmap_base", "32", "--Generator.fmap_max", "8",
        "--Generator.latent_size", "8", "--Discriminator.fmap_base", "32",
        "--Discriminator.fmap_max", "8", "--total_kimg", "0.012",
        "--DepthManager.minibatch_default", "4",
        "--DepthManager.tick_kimg_overrides", "{}",
        "--DepthManager.tick_kimg_default", "0.008",
        "--num_data_workers", "1", "--result_dir", str(tmp_path / "r")])
    assert trainer.cur_nimg >= 12
    run, = glob.glob(str(tmp_path / "r" / "001-*"))
    assert glob.glob(os.path.join(run, "network-snapshot-generator-*.dat"))
    assert glob.glob(os.path.join(run, "fakes_*.png"))
