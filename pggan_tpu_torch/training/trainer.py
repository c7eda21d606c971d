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

Grouped dispatch (``steps_per_dispatch``, on by default with 8, as in the
JAX trainer, ``pggan_tpu/training/trainer.py:183-289``): where the
schedule provably holds over the next ``steps_per_dispatch`` steps (a
stable window, or a window wholly inside one fade), they run as one
``TrainStepBuilder.group_step_fn`` call, on the card one graph replay, with
one upload of their batches, per-step alpha and lr vectors, and one drain
of the iteration plugins at the final count with the stacked metrics.
Elsewhere, and with 1, a dispatch is one step.

Dispatch backpressure (``inflight_budget_mb``, ``trainer.py:61-85,
291-309``): every batch goes to the card through a pinned buffer from a
pool, by an asynchronous copy, so the host runs ahead of the card. Each
dispatch keeps its buffer until an event recorded after its step has
completed; once the buffers of unfinished dispatches pass the budget, the
host waits for the oldest. 0 turns the waits off.

Under data parallelism (the builder's ``group``) every rank runs this loop
on its local batches: the step key holds the local batch, while the image
clock counts the global batch, local batch x world size x
``D_training_repeats`` (``pggan_tpu/training/trainer.py:332-334``). The
schedule plugins derive the stage from that clock alone, so every rank
calls the same sequence of (depth, batch, fade) steps, as the step's
collectives need.
"""

from __future__ import annotations

import collections
import heapq
import time

import numpy as np
import torch

from pggan_tpu_torch.utils.profiling import span


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
        # up to this many consecutive steps in one dispatch where the
        # schedule provably holds (``_plan_group``); 1 disables grouping
        self.steps_per_dispatch = int(steps_per_dispatch)
        # the pinned bytes that unfinished dispatches may hold before the
        # host waits for the oldest (``_throttle_inflight``); 0: no waits
        self.inflight_budget_mb = int(inflight_budget_mb)
        self._inflight = collections.deque()  # (event, buffer, nbytes)
        self._inflight_bytes = 0
        self.inflight_peak_bytes = 0  # the most held at once
        self._pool = {}  # free pinned buffers by size
        self._pool_shape = None  # the image shape the pool's buffers carry
        # lookahead hooks that the schedule plugins install at registration
        # (``pggan_tpu/training/trainer.py:86-99``): images until (depth,
        # alpha) next changes, images until the running fade ends, the
        # (depth, alpha) law and the (lr_d, lr_g) law at an image count.
        # Grouping stays off until they are known.
        self.schedule_horizon = None
        self.lr_lookahead = None
        self.fade_horizon = None
        self.alpha_lookahead = None
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
        with span("trainer.tick"):  # the monitors fetch their values here
            self.cur_tick += 1
            self.tick_start_nimg = self.cur_nimg
            self.stats["kimg_stat"]["val"] = self.cur_nimg / 1000.0
            self.stats["tick_stat"]["val"] = self.cur_tick
            self.call_plugins("epoch", self.cur_tick)

    def _device(self) -> torch.device:
        return next(self.G.parameters()).device

    def _world(self) -> int:
        group = self.builder.group
        return 1 if group is None else group.world_size

    # -- grouped dispatch (pggan_tpu/training/trainer.py:182-289) -------------
    def _plan_group(self):
        """``(group, alphas)``: how many steps the next dispatch fuses and,
        for a grouped fade window, its per-step alpha vector (None
        otherwise). group > 1 only where exact: a stable window that
        ``schedule_horizon`` covers whole, or a window wholly inside one
        fade (``fade_horizon``, each step's alpha cross-checked by
        ``alpha_lookahead``); never past a tick or the run's end; always
        exactly ``steps_per_dispatch`` steps, so that a stage has two group
        graphs at most. ``per`` counts the global batch: the minibatch
        (global under data parallelism) times ``D_training_repeats``."""
        spd = self.steps_per_dispatch
        if (spd <= 1 or self.schedule_horizon is None
                or self.minibatch_size is None):
            return 1, None
        per = self.minibatch_size * self.D_training_repeats
        alphas = None
        if self.alpha < 1.0:
            # step k takes the alpha the DepthManager would have set after
            # step k - 1, the law at start + k * per; the last one must
            # still be inside the fade, at the same depth (the law skips
            # stages when lod_transition_nimg > lod_training_nimg)
            if self.fade_horizon is None or self.alpha_lookahead is None:
                return 1, None
            if self.fade_horizon(self.cur_nimg) <= (spd - 1) * per:
                return 1, None
            pairs = [self.alpha_lookahead(self.cur_nimg + k * per)
                     for k in range(spd)]
            if any(d != self.depth or a >= 1.0 for d, a in pairs):
                return 1, None
            alphas = np.asarray([a for _, a in pairs], np.float32)
        elif self.schedule_horizon(self.cur_nimg) < spd * per:
            return 1, None
        remaining = (self.tick_start_nimg + self.tick_duration_nimg
                     - self.cur_nimg)
        if self.total_nimg is not None:
            remaining = min(remaining, self.total_nimg - self.cur_nimg)
        if -(-remaining // per) < spd:  # the steps that fit before it
            return 1, None
        return spd, alphas

    def _train_grouped(self, group, alphas):
        """``group`` iterations in one dispatch: one batch a step, the lr
        ramp through per-step vectors (``lr_lookahead`` at start + k *
        per), the metrics stacked, the iteration plugins drained once at
        the final count. ``alphas``: ``_plan_group``'s vector in a fade
        window, None in a stable one."""
        start_nimg = self.cur_nimg
        if alphas is None:
            alphas = np.full((group,), self.alpha, np.float32)
        reals, batch, staged = self._fetch_reals(group, alphas)
        if batch * self._world() != self.minibatch_size:
            raise RuntimeError(
                f"grouped dispatch planned for minibatch "
                f"{self.minibatch_size} but the data iterator served "
                f"{batch} on each of {self._world()} rank(s); keep them in "
                f"sync or set steps_per_dispatch=1")
        per = batch * self._world() * self.D_training_repeats
        self.cur_nimg += group * per
        if self.lr_lookahead is not None:
            pairs = [self.lr_lookahead(start_nimg + k * per)
                     for k in range(group)]
            lrs_d = np.asarray([p[0] for p in pairs], np.float32)
            lrs_g = np.asarray([p[1] for p in pairs], np.float32)
        else:
            lrs_d = np.full((group,), self.lr_d, np.float32)
            lrs_g = np.full((group,), self.lr_g, np.float32)

        fade = self.alpha < 1.0
        self._await_precompile((self.depth, batch, fade, group))
        gstep = self.builder.group_step_fn(self.depth, batch, fade, group)
        with span("trainer.issue"):
            metrics = gstep(self.state, reals, alphas, lrs_d, lrs_g)
        self._dispatched(staged)
        self.iterations += group
        self._drain_iteration_plugins(metrics)

    def _await_precompile(self, key) -> None:
        """A dispatch at ``key`` whose precompile (``DepthManager(...,
        precompile_ahead=True)``) is still running waits for it, rather
        than start an eager step of its own beside it, and raises its
        failure."""
        wait = getattr(self.builder, "await_precompile", None)
        if wait is not None:
            with span("trainer.await_precompile"):
                wait(key)

    def _drain_iteration_plugins(self, metrics) -> None:
        with span("trainer.plugins"):
            self.call_plugins("iteration", self.iterations,
                              metrics["G_loss"], metrics["D_loss"],
                              metrics["D_real"], metrics["D_fake"])

    # -- the pinned staging pool and the backpressure ------------------------
    def _upload(self, raw: list, lead: tuple):
        """``(tensor, staged)``: the host batches ``raw`` stacked with the
        leading dims ``lead``, on the step's device, and, on the card,
        ``(buffer, nbytes)`` of the pinned buffer they were stacked into and
        copied from asynchronously (None elsewhere). The buffer comes from
        the pool and goes back once the dispatch that reads it has
        completed (``_throttle_inflight``)."""
        device = self._device()
        shape = lead + raw[0].shape
        if device.type != "cuda":
            return torch.from_numpy(np.stack(raw).reshape(shape)), None
        if raw[0].shape != self._pool_shape:  # a new stage's batches
            self._pool, self._pool_shape = {}, raw[0].shape
        nbytes = len(raw) * raw[0].nbytes
        free = self._pool.setdefault(nbytes, [])
        buf = free.pop() if free else torch.empty(
            nbytes, dtype=torch.uint8, pin_memory=True)
        dtype = torch.from_numpy(np.empty(0, raw[0].dtype)).dtype
        view = buf.view(dtype).view(shape)
        np.stack(raw, out=view.numpy().reshape((len(raw),) + raw[0].shape))
        return view.to(device, non_blocking=True), (buf, nbytes)

    def _dispatched(self, staged) -> None:
        """After a dispatch: its buffer joins the in-flight deque with an
        event recorded after its step."""
        if staged is None:
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device()))
        self._throttle_inflight(event, *staged)

    def _throttle_inflight(self, event, buffer, nbytes: int) -> None:
        """The backpressure (``pggan_tpu/training/trainer.py:291-309``):
        return to the pool, without a wait, the buffers of the dispatches
        found completed (the oldest first; one stream completes them in
        order); remember ``(event, buffer, nbytes)`` of this one; then,
        while the bytes of the unfinished dispatches pass the budget and
        more than one is in flight, wait for the oldest. The bytes are the
        pinned buffer's, the batch as shipped."""
        while self._inflight and self._inflight[0][0].query():
            self._release()
        self._inflight.append((event, buffer, int(nbytes)))
        self._inflight_bytes += int(nbytes)
        self.inflight_peak_bytes = max(self.inflight_peak_bytes,
                                       self._inflight_bytes)
        budget = self.inflight_budget_mb * (1024 * 1024)
        while (budget and self._inflight_bytes > budget
               and len(self._inflight) > 1):
            with span("trainer.throttle"):
                self._inflight[0][0].synchronize()
            self._release()

    def _release(self) -> None:
        """The oldest dispatch has completed: its buffer back to the pool
        (unless it carried an earlier stage's batches)."""
        _event, buf, nbytes = self._inflight.popleft()
        self._inflight_bytes -= nbytes
        if buf.numel() in self._pool:
            self._pool[buf.numel()].append(buf)

    def _fetch_reals(self, n_steps, alpha):
        """The reals of ``n_steps`` steps, f32 on the device: ``n_steps *
        D_training_repeats`` batches from the iterator, stacked with leading
        dims ``(n_steps, repeats)`` (``(repeats,)`` for one step), uploaded
        at once, and, for uint8 batches, cast, faded by ``alpha`` (a number,
        or one a step) and remapped on the device
        (``TrainStepBuilder.prep_fn``). The one data path of both dispatch
        modes (``pggan_tpu/training/trainer.py:311-349``). Returns
        ``(reals, local batch, staged)``, ``staged`` as ``_upload`` gives
        it."""
        repeats = self.D_training_repeats
        with span("trainer.fetch"):
            raw = [np.asarray(next(self.dataiter))
                   for _ in range(n_steps * repeats)]
        lead = (n_steps, repeats) if n_steps > 1 else (repeats,)
        with span("trainer.stage"):
            reals, staged = self._upload(raw, lead)
        if reals.dtype == torch.uint8:
            ds = self.dataset
            prep = self.builder.prep_fn(
                ds.range_in if ds is not None else (0, 255),
                ds.range_out if ds is not None else (-1, 1))
            with span("trainer.issue"):
                reals = prep(reals, alpha)
        elif reals.dtype != torch.float32:
            reals = reals.to(torch.float32)
        return reals, raw[0].shape[0], staged

    # -- hot loop (reference trainer.py:85-115) -------------------------------
    def train(self):
        with span("trainer.dispatch"):
            self._train()

    def _train(self):
        group, alphas = self._plan_group()
        if group > 1:
            self._train_grouped(group, alphas)
            return
        reals, batch, staged = self._fetch_reals(1, np.float32(self.alpha))
        self.cur_nimg += batch * self._world() * self.D_training_repeats

        # The stable phase (alpha == 1) runs the blend-free graph.
        fade = self.alpha < 1.0
        self._await_precompile((self.depth, batch, fade))
        step = self.builder.step_fn(self.depth, batch, fade=fade)
        with span("trainer.issue"):
            metrics = step(self.state, reals, np.float32(self.alpha),
                           np.float32(self.lr_d), np.float32(self.lr_g))
        self._dispatched(staged)

        self.iterations += 1
        self._drain_iteration_plugins(metrics)
