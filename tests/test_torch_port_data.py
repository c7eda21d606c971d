"""The port's in-memory datasets and host input pipeline on the CPU against
pggan_tpu's, on the same seeds, bit for bit: the SyntheticDataset pyramid,
the box downsample and the fade blend, items and raw batches at every
depth with and without a fade, the float host prep against the numpy
fallback of ``pggan_tpu/data/native.py``, the samplers' index streams, and
the batches a one-worker ``DataIterator`` yields (one worker fills the
queue in sampler order, so both loaders yield the same sequence).
"""

import numpy as np
import pytest

from pggan_tpu.data import datasets as jdatasets
from pggan_tpu.data import loader as jloader
from pggan_tpu.data import native
from pggan_tpu_torch.data import datasets, loader

ALPHAS = [1.0, 0.75, 0.3, 0.0]


@pytest.fixture
def numpy_native(monkeypatch):
    """pggan_tpu's host prep on its numpy fallback (the C++ library off)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def _pair(**kw):
    return (datasets.SyntheticDataset(**kw),
            jdatasets.SyntheticDataset(**kw))


@pytest.mark.parametrize("kw", [
    dict(resolution=32, num_channels=3, num_items=5, seed=0),
    dict(resolution=16, num_channels=1, num_items=3, seed=7),
    dict(resolution=64, num_channels=3, num_items=2, seed=11),
])
def test_synthetic_pyramid_equals_jax(kw):
    port, ref = _pair(**kw)
    assert len(port) == len(ref) and port.shape == ref.shape
    assert len(port.data) == len(ref.data)
    for level, (a, b) in enumerate(zip(port.data, ref.data)):
        assert a.dtype == b.dtype == np.uint8, level
        np.testing.assert_array_equal(a, b, err_msg=f"level {level}")


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_box_downsample_equals_jax(factor, dtype):
    img = np.random.RandomState(factor).randint(0, 256, (16, 8, 3))
    img = img.astype(dtype)
    got = datasets.box_downsample(img, factor)
    want = jdatasets.box_downsample(img, factor)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_box_downsample_rejects_a_ragged_image():
    with pytest.raises(ValueError, match="does not divide"):
        datasets.box_downsample(np.zeros((6, 4, 1), np.float32), 4)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_alpha_fade_blend_equals_jax(alpha):
    img = np.random.RandomState(3).randint(0, 256, (8, 16, 3))
    for x in (img.astype(np.float32), img.astype(np.uint8)):
        got = datasets._alpha_fade_blend(x, alpha)
        want = jdatasets._alpha_fade_blend(x, alpha)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_items_and_raw_batches_equal_jax(alpha):
    """__getitem__ (fade, remap) and raw_batch at every model depth."""
    port, ref = _pair(resolution=32, num_channels=3, num_items=4, seed=5)
    for depth in range(4):  # 4 to 32 px
        for ds in (port, ref):
            ds.model_depth, ds.alpha = depth, alpha
        for item in range(len(port)):
            got, want = port[item], ref[item]
            assert got.shape == (4 * 2 ** depth,) * 2 + (3,)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"depth {depth}")
        idx = [3, 0, 3, 1]
        np.testing.assert_array_equal(port.raw_batch(idx), ref.raw_batch(idx))


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("ranges", [((0, 255), (-1, 1)), ((0, 255), (0, 1)),
                                    ((16, 235), (-2, 3))])
def test_prep_batch_f32_equals_the_numpy_fallback(numpy_native, alpha,
                                                  ranges):
    u8 = np.random.RandomState(9).randint(0, 256, (3, 8, 8, 3)).astype(
        np.uint8)
    got = datasets.prep_batch_f32(u8, alpha, *ranges)
    want = native.prep_batch_f32(u8, alpha, *ranges)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_prep_batch_f32_matches_the_items(alpha):
    """The fused batch prep is the dataset's own item prep, batched: the
    same numbers, to rounding (the remap is taken in another order)."""
    port, _ = _pair(resolution=16, num_channels=3, num_items=4, seed=2)
    port.model_depth, port.alpha = 2, alpha
    idx = [2, 1, 1, 3]
    got = datasets.prep_batch_f32(port.raw_batch(idx), alpha,
                                  port.range_in, port.range_out)
    want = np.stack([port[i] for i in idx])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 13])
def test_samplers_equal_jax(seed):
    """Several passes of each sampler, in batches that straddle a pass."""
    pairs = [(loader.InfiniteRandomSampler(7, seed),
              jloader.InfiniteRandomSampler(7, seed)),
             (loader._ShardedSampler(np.arange(2, 9), seed),
              jloader._ShardedSampler(np.arange(2, 9), seed))]
    for port, ref in pairs:
        for n in (3, 5, 1, 7, 9):
            assert port.take_batch(n) == ref.take_batch(n)
        assert [next(port) for _ in range(4)] == [next(ref) for _ in range(4)]


class _FloatLevels(datasets.DepthDataset):
    """Float pyramid levels: no raw uint8 batch, so the loader stacks
    items."""

    def __init__(self, module, levels, **kw):
        module.DepthDataset.__init__(self, **kw)
        self._data = levels

    @property
    def data(self):
        return self._data

    def __len__(self):
        return self._data[-1].shape[0]


class _JFloatLevels(jdatasets.DepthDataset):
    data = _FloatLevels.data
    __init__ = _FloatLevels.__init__
    __len__ = _FloatLevels.__len__


@pytest.mark.parametrize("route", ["raw", "host_prep", "items"])
@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_data_iterator_batches_equal_jax(numpy_native, route, alpha):
    if route == "items":
        rng = np.random.RandomState(4)
        levels = [None, None] + [
            rng.uniform(0, 255, (5, r, r, 3)).astype(np.float32)
            for r in (4, 8, 16)]
        port = _FloatLevels(datasets, levels, model_initial_depth=1)
        ref = _JFloatLevels(jdatasets, levels, model_initial_depth=1)
    else:
        port, ref = _pair(resolution=16, num_channels=3, num_items=5, seed=8)
        for ds in (port, ref):
            ds.model_depth = 1
    port.alpha = ref.alpha = alpha
    raw = route == "raw"
    its = [loader.DataIterator(port, 3, num_workers=1, seed=21, raw=raw),
           jloader.DataIterator(ref, 3, num_workers=1, seed=21, raw=raw)]
    try:
        for _ in range(6):  # two passes over the 5 items, and more
            got, want = (next(it) for it in its)
            assert got.dtype == want.dtype
            assert got.dtype == (np.uint8 if raw else np.float32)
            assert got.shape == (3, 8, 8, 3)
            np.testing.assert_array_equal(got, want)
    finally:
        for it in its:
            it.close()


def test_data_iterator_surfaces_a_worker_error():
    class Broken(datasets.SyntheticDataset):
        def raw_batch(self, items):
            raise OSError("unreadable item")

    it = loader.DataIterator(Broken(resolution=8, num_items=2), 2,
                             num_workers=1, seed=0)
    with pytest.raises(OSError, match="unreadable"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
