"""Host-side training engine: the hot loop and the heap-based plugin
scheduler, the counterpart of ``pggan_tpu/training/trainer.py``.

One iteration fetches the next real batch, runs one train step (on the card
a CUDA graph replay, ``steps.py``), advances the image clock and drains the
due plugins. The step's losses stay on the device; the loss monitors copy
them there and fetch them once a tick.

Plugin queue semantics are the reference's (trainer.py:40-69): four queues
``iteration | epoch | s | end``, each a heap ordered by next-due time; a
due plugin's method named after the queue is called and the plugin is
rescheduled at ``time + interval``.

The JAX trainer's grouped dispatch (several steps in one compiled program)
and its dispatch backpressure serve the TPU runtime; here a replayed graph
is already one launch a step, and the host waits on the card at each
step's input copy. ``steps_per_dispatch`` and ``inflight_budget_mb`` are
accepted, so that the train CLI takes the JAX CLI's ``--Trainer.*`` flags,
and have no effect.
"""

from __future__ import annotations

import heapq
import time

import numpy as np
import torch


class Trainer:
    """Progressive-GAN training engine (reference trainer.py:7-19, with a
    ``TrainStepBuilder`` and a ``TrainState`` in place of the reference's
    models, loss and optimizers).

    Mutable attributes that plugins reach into (the reference's contract):
    ``cur_nimg``, ``dataiter``, ``random_latents_generator``,
    ``tick_duration_nimg``, ``stats``, ``depth``, ``alpha``,
    ``minibatch_size``, ``lr_d``, ``lr_g``, ``state``.
    """

    def __init__(self,
                 G,
                 D,
                 builder,
                 state,
                 dataset,
                 dataiter,
                 random_latents_generator,
                 D_training_repeats=1,
                 tick_nimg_default=2 * 1000,
                 resume_nimg=0,
                 resume_iterations=0,
                 steps_per_dispatch=8,
                 inflight_budget_mb=1024):
        self.G = G
        self.D = D
        self.builder = builder
        self.steps_per_dispatch = int(steps_per_dispatch)  # no effect here
        self.inflight_budget_mb = int(inflight_budget_mb)  # no effect here
        self.state = state
        self.dataset = dataset
        self.dataiter = dataiter
        self.random_latents_generator = random_latents_generator
        self.D_training_repeats = D_training_repeats
        self.cur_nimg = resume_nimg
        self.tick_start_nimg = self.cur_nimg
        self.tick_duration_nimg = tick_nimg_default
        self.iterations = resume_iterations
        self.total_nimg = None
        self.cur_tick = 0
        self.depth = 0
        self.alpha = 1.0
        self.minibatch_size = None
        self.lr_d = 0.0
        self.lr_g = 0.0
        self.lr_scale = 1.0
        self.stats = {}
        self._register_stat("kimg_stat", self.cur_nimg / 1000.0,
                            "{val:8.3f}", "kimg")
        self._register_stat("tick_stat", self.cur_tick, "{val:5}", "tick")
        self.plugin_queues = {q: [] for q in ("iteration", "epoch", "s", "end")}
        # the pinned host buffer of the last batch and the event after its
        # upload, so that the buffer is refilled only once that copy is done
        self._staging = None

    def _register_stat(self, key, val, fmt, name):
        self.stats[key] = {"val": val, "log_epoch_fields": [fmt],
                           "log_name": name}

    # -- plugin scheduler -----------------------------------------------------
    # A plugin declares ``trigger_interval`` entries ``(interval, unit)`` with
    # unit one of iteration|epoch|s|end; each unit's queue is a min-heap keyed
    # by the next due time, and when a queue is drained at time T every due
    # plugin's method named after the unit is called and rescheduled at
    # T + interval. The interval travels in the heap entry, so a plugin on
    # several queues keeps each queue's interval.

    def register_plugin(self, plugin):
        plugin.register(self)
        triggers = plugin.trigger_interval
        if not isinstance(triggers, list):
            triggers = [triggers]
        for interval, unit in triggers:
            queue = self.plugin_queues[unit]
            # serial = registration order: a deterministic tie-break that
            # keeps the (unorderable) plugins out of the heap comparison
            heapq.heappush(queue, (interval, len(queue), interval, plugin))

    def call_plugins(self, queue_name, time, *args):
        queue = self.plugin_queues[queue_name]
        while queue and queue[0][0] <= time:
            _, serial, interval, plugin = heapq.heappop(queue)
            getattr(plugin, queue_name)(time, *args)
            heapq.heappush(queue, (time + interval, serial, interval, plugin))

    # -- run loop (reference trainer.py:71-83) --------------------------------
    def run(self, total_kimg=1):
        total_nimg = total_kimg * 1000
        self.total_nimg = total_nimg
        # the 's' queue is drained on wall-clock seconds since run() started,
        # between iterations (the reference declares it but never drains it)
        run_start = time.time()
        while self.cur_nimg < total_nimg:
            self.train()
            if self.plugin_queues["s"]:
                self.call_plugins("s", time.time() - run_start)
            if (self.cur_nimg >= self.tick_start_nimg + self.tick_duration_nimg
                    or self.cur_nimg >= total_nimg):
                self._rollover_tick()
        self.call_plugins("end", 1)

    def _rollover_tick(self):
        self.cur_tick += 1
        self.tick_start_nimg = self.cur_nimg
        self.stats["kimg_stat"]["val"] = self.cur_nimg / 1000.0
        self.stats["tick_stat"]["val"] = self.cur_tick
        self.call_plugins("epoch", self.cur_tick)

    def _device(self) -> torch.device:
        return next(self.G.parameters()).device

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """The batch on the step's device. On the card it goes through one
        pinned host buffer by an asynchronous copy; the buffer is refilled
        only after the card has read the previous batch out of it."""
        device = self._device()
        batch = torch.from_numpy(host)
        if device.type != "cuda":
            return batch.to(device)
        if self._staging is not None:
            buf, event = self._staging
            event.synchronize()
        if self._staging is None or buf.shape != batch.shape \
                or buf.dtype != batch.dtype:
            buf = torch.empty(batch.shape, dtype=batch.dtype,
                              pin_memory=True)
        buf.copy_(batch)
        out = buf.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._staging = (buf, event)
        return out

    def _fetch_reals(self, alpha):
        """The step's reals, (repeats, B, H, W, C) float32 on the device:
        ``D_training_repeats`` batches from the iterator, uploaded, and, for
        uint8 batches, cast, faded by ``alpha`` and remapped on the device
        (``TrainStepBuilder.prep_fn``). Returns ``(reals, batch)``."""
        raw = np.stack([np.asarray(next(self.dataiter))
                        for _ in range(self.D_training_repeats)])
        reals = self._upload(raw)
        if reals.dtype == torch.uint8:
            ds = self.dataset
            prep = self.builder.prep_fn(
                ds.range_in if ds is not None else (0, 255),
                ds.range_out if ds is not None else (-1, 1))
            reals = prep(reals, alpha)
        elif reals.dtype != torch.float32:
            reals = reals.to(torch.float32)
        return reals, raw.shape[1]

    # -- hot loop (reference trainer.py:85-115, one step) ---------------------
    def train(self):
        reals, batch = self._fetch_reals(np.float32(self.alpha))
        self.cur_nimg += batch * self.D_training_repeats

        # The stable phase (alpha == 1) runs the blend-free graph.
        step = self.builder.step_fn(self.depth, batch,
                                    fade=self.alpha < 1.0)
        metrics = step(self.state, reals, np.float32(self.alpha),
                       np.float32(self.lr_d), np.float32(self.lr_g))

        self.iterations += 1
        self.call_plugins("iteration", self.iterations,
                          metrics["G_loss"], metrics["D_loss"],
                          metrics["D_real"], metrics["D_fake"])
