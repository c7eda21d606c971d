"""Host input pipeline: infinite random sampling and threaded batch
prefetch, the counterpart of ``pggan_tpu/data/loader.py``.

``DataIterator`` yields ready (B, H, W, C) numpy batches from a bounded
prefetch queue filled by worker threads: float32 with the fade and the
dynamic-range remap done on the host by the host library
(``native.prep_batch_f32``), or, with ``raw=True``, the uint8 pixels as
they are, for the trainer to prep on the device
(``TrainStepBuilder.prep_fn``). A dataset gives its raw uint8 batch
(``raw_batch``) from a level in memory, a memmapped disk pyramid or a
windowed H5 read; one without (a lazy folder, float levels) is stacked
item by item. Threads see ``dataset.alpha`` as the
schedule moves it. Under data parallelism each rank's iterator samples
from its own shard of the items, ``shard_index::num_shards`` (the JAX
loader's index space, ``pggan_tpu/data/loader.py:91-95``).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from pggan_tpu_torch.data.native import prep_batch_f32
from pggan_tpu_torch.utils.profiling import span


PREFETCH = 4  # batches the queue holds ahead of the trainer


class _ShardedSampler:
    """Thread-safe infinite random sampler over an explicit index array,
    reshuffling each pass."""

    def __init__(self, indices: np.ndarray, seed: int | None):
        self.indices = np.asarray(indices)
        self.rng = np.random.RandomState(seed)
        self._perm = []
        self._pos = 0
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self) -> int:
        return self.take_batch(1)[0]

    def take_batch(self, n: int) -> list[int]:
        out = []
        with self._lock:
            while len(out) < n:
                if self._pos >= len(self._perm):
                    self._perm = self.rng.permutation(self.indices)
                    self._pos = 0
                out.append(int(self._perm[self._pos]))
                self._pos += 1
        return out


class InfiniteRandomSampler(_ShardedSampler):
    """Yields uniformly random indices in [0, length) forever, reshuffling
    each pass (reference train.py:51-57)."""

    def __init__(self, length: int, seed: int | None = None):
        super().__init__(np.arange(length), seed)
        self.length = length


class DataIterator:
    """Threaded prefetching batch iterator over a DepthDataset.

    Each worker thread assembles complete batches (sampling indices from the
    shared sampler) and pushes them to a bounded queue; ``__next__`` pops a
    ready batch. Batches are always exactly ``batch_size`` (the sampler is
    infinite). ``close`` stops the workers. ``shard_index`` and
    ``num_shards`` restrict the sampler to the items
    ``shard_index::num_shards``: one rank's shard under data parallelism.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed: int | None = None, raw: bool = False,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.raw = raw  # yield uint8 raw batches; prep happens on the device
        self.num_workers = max(1, num_workers)
        n = len(dataset)
        self.sampler = _ShardedSampler(
            np.arange(n) if num_shards <= 1
            else np.arange(shard_index, n, num_shards), seed)
        self._queue: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"pggan-torch-data-{i}")
            for i in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                # in ``SPANS`` alone: the card's idle gaps are the main
                # thread's to name
                with span("loader.batch", profile=False):
                    batch = self._batch(
                        self.sampler.take_batch(self.batch_size))
            except Exception as e:  # surface worker errors to the consumer
                self._put((None, e))
                return
            self._put((batch, None))

    def _batch(self, idxs) -> np.ndarray:
        """The batch of items ``idxs``: the raw batch, prepped unless
        ``raw``, or the items stacked one by one."""
        raw = self.dataset.raw_batch(idxs)
        if raw is not None and self.raw:
            return raw
        if raw is not None:
            return prep_batch_f32(raw, self.dataset.alpha,
                                  self.dataset.range_in,
                                  self.dataset.range_out)
        return np.stack([self.dataset[i] for i in idxs], axis=0)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._stop.is_set():
            raise StopIteration
        batch, err = self._queue.get()
        if err is not None:
            self.close()
            raise err
        return batch

    def close(self):
        self._stop.set()
        # drain so blocked workers can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self._stop.set()
