"""Plugin suite for the tick/iteration runtime: the counterpart of
``pggan_tpu/training/plugins.py`` (reference plugins.py).

Every concern outside the step (the progressive-growing schedule, the LR
ramp, loss stats, wall-clock stats, checkpoints, sample generation, metrics
export, tracing, logging) is a plugin with trigger intervals on the
``iteration | epoch | s | end`` queues; "tick" is "epoch" for plugins.

- The loss monitors keep device copies of the losses and fetch them once a
  tick (one host sync a tick, where the reference synchronised every
  iteration).
- ``DepthManager`` swaps the stage on a depth change: the step the trainer
  picks (a new CUDA graph per (depth, batch, fade)), the data iterator and
  the batch size. It and ``LRScheduler`` install the trainer's lookahead
  hooks, the laws its grouped dispatch plans with.
- ``SaverPlugin`` writes the snapshots in the JAX format and the port's
  full training state for an exact resume.

Under data parallelism every rank runs the plugins that steer the run
(``DepthManager``, ``LRScheduler``, the loss monitors, which read the
step's all-reduced metrics, and ``AbsoluteTimeMonitor``), and only rank 0
those that write (``OutputGenerator``, ``MetricsExporter``, the loggers,
``TraceProfiler``). ``SaverPlugin`` runs on every rank, since it gathers
each rank's generator state (a collective), and writes on rank 0 alone.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from datetime import timedelta
from glob import glob

import numpy as np
import torch

from pggan_tpu_torch.checkpoint import save_snapshot, save_training_state
from pggan_tpu_torch.parallel import gather_generator_states
from pggan_tpu_torch.training import schedule
from pggan_tpu_torch.training.schedule import lod_value, lr_rampup


class Plugin:
    """Base plugin: ``trigger_interval`` is a list of (interval, queue_name)."""

    def __init__(self, interval=None):
        self.trigger_interval = interval if interval is not None else []
        self.trainer = None

    def register(self, trainer):
        self.trainer = trainer


class DepthManager(Plugin):
    """The progressive-growing scheduler (reference plugins.py:13-81).

    Every iteration, re-derives (depth, alpha) purely from ``cur_nimg``
    (``schedule.depth_alpha_schedule``). On a depth change it sets the
    trainer's stage: depth, the per-depth minibatch (reference defaults
    {6: 14, 7: 6, 8: 3}), a fresh data iterator at the new resolution, the
    latent generator and the tick length. The trainer then takes the step
    of the new (depth, batch, fade), whose first calls warm and capture its
    CUDA graph.

    ``precompile_ahead`` (off by default, as in the JAX package) is the
    JAX package's background compile of the programs a stage will need
    next (``pggan_tpu/training/plugins.py:135-159``): at each depth change,
    from registration on, the builder's precompile thread
    (``pggan-precompile``; JAX starts a thread a stage, here one worker
    keeps its set-up across stages) makes ready the current depth's stable
    step and, below ``max_depth``, the next depth's fade step at its
    minibatch, each as the trainer will dispatch it: the single step, and
    the group of ``trainer.steps_per_dispatch`` steps where that is above
    1 (``TrainStepBuilder.precompile_ahead``: a warm-up on a scratch copy
    of the state, then the graph's capture). Where the JAX package prints
    a failed compile and carries on, here a failure is kept by key and
    raised at that key's first dispatch: a capture that fails raises, and
    nothing falls back.
    """

    def __init__(self,
                 create_dataiter_fun=None,
                 create_rlg=None,
                 max_depth=None,
                 minibatch_default=schedule.MINIBATCH_DEFAULT,
                 minibatch_overrides=schedule.MINIBATCH_OVERRIDES,
                 tick_kimg_default=schedule.TICK_KIMG_DEFAULT,
                 tick_kimg_overrides=schedule.TICK_KIMG_OVERRIDES,
                 lod_training_nimg=schedule.LOD_TRAINING_NIMG,
                 lod_transition_nimg=schedule.LOD_TRANSITION_NIMG,
                 max_lod=None,
                 depth_offset=None,
                 precompile_ahead=False,
                 lr_reference_minibatch=None):
        super().__init__([(1, "iteration")])
        self.precompile_ahead = precompile_ahead
        self.lr_reference_minibatch = lr_reference_minibatch
        self.create_dataiter_fun = create_dataiter_fun
        self.create_rlg = create_rlg
        self.max_depth = max_depth
        self.minibatch_default = minibatch_default
        self.minibatch_overrides = dict(minibatch_overrides or {})
        self.tick_kimg_default = tick_kimg_default
        self.tick_kimg_overrides = dict(tick_kimg_overrides or {})
        self.lod_training_nimg = lod_training_nimg
        self.lod_transition_nimg = lod_transition_nimg
        self.max_lod = max_lod
        self.depth_offset = depth_offset
        self.depth = -1
        self.alpha = -1.0

    def register(self, trainer):
        self.trainer = trainer
        # the trainer's grouped dispatch plans with these pure laws: images
        # until (depth, alpha) next changes, images until the running fade
        # ends, and the (depth, alpha) law itself
        trainer.schedule_horizon = lambda nimg: schedule.stable_nimg_horizon(
            nimg, self.max_depth,
            self.lod_training_nimg, self.lod_transition_nimg)
        trainer.fade_horizon = lambda nimg: schedule.fade_nimg_horizon(
            nimg, self.max_depth,
            self.lod_training_nimg, self.lod_transition_nimg)
        trainer.alpha_lookahead = lambda nimg: schedule.depth_alpha_schedule(
            nimg, self.max_depth,
            self.lod_training_nimg, self.lod_transition_nimg)
        if self.lod_transition_nimg > self.lod_training_nimg:
            # the nimg->(depth, alpha) divmod law (reference plugins.py:57-63)
            # mis-schedules in this regime: depth can skip stages
            print("[DepthManager] WARNING: lod_transition_nimg > "
                  "lod_training_nimg is not supported by the schedule "
                  "arithmetic; stages will be skipped", flush=True)
        trainer.stats["minibatch_size"] = self.minibatch_default
        trainer.stats["alpha"] = {"log_name": "alpha",
                                  "log_epoch_fields": ["{val:.2f}"],
                                  "val": self.alpha}
        if self.max_lod is not None and self.depth_offset is not None:
            trainer.stats["lod"] = {"log_name": "lod",
                                    "log_epoch_fields": ["{val:.2f}"],
                                    "val": self.lod}
        self.iteration()

    @property
    def lod(self):
        return lod_value(self.depth, self.alpha, self.max_lod, self.depth_offset)

    def _precompile_upcoming(self, depth, minibatch_size):
        """Start the precompile of the steps this stage needs next: the
        current depth's stable step and the next depth's fade step, single
        and grouped as the trainer dispatches them."""
        trainer = self.trainer
        builder = getattr(trainer, "builder", None)
        if builder is None or not hasattr(builder, "precompile_ahead"):
            return
        targets = [(depth, minibatch_size, False)]
        if depth < self.max_depth:
            next_mb = self.minibatch_overrides.get(depth + 1,
                                                   self.minibatch_default)
            targets.append((depth + 1, next_mb, True))
        spd = trainer.steps_per_dispatch
        groups = (None,) + ((spd,) if spd > 1 else ())
        world = 1 if builder.group is None else builder.group.world_size
        # the step keys hold the local batch
        builder.precompile_ahead(
            [(d, mb // world, fade, g) for d, mb, fade in targets
             for g in groups], trainer.state)

    def iteration(self, *args):
        trainer = self.trainer
        depth, alpha = schedule.depth_alpha_schedule(
            trainer.cur_nimg, self.max_depth,
            self.lod_training_nimg, self.lod_transition_nimg)
        if depth != self.depth:
            self.depth = depth
            trainer.depth = depth
            if trainer.dataset is not None:
                trainer.dataset.model_depth = depth
                # the new alpha before the stage's loader threads start, so
                # that their first batches carry it
                trainer.dataset.alpha = alpha
            minibatch_size = self.minibatch_overrides.get(
                depth, self.minibatch_default)
            trainer.minibatch_size = minibatch_size
            if self.create_dataiter_fun is not None:
                old_iter = trainer.dataiter
                trainer.dataiter = iter(self.create_dataiter_fun(minibatch_size))
                if hasattr(old_iter, "close"):
                    old_iter.close()  # stop the previous stage's threads
            if self.create_rlg is not None:
                trainer.random_latents_generator = self.create_rlg(minibatch_size)
            tick_kimg = self.tick_kimg_overrides.get(depth, self.tick_kimg_default)
            trainer.tick_duration_nimg = tick_kimg * 1000
            trainer.stats["minibatch_size"] = minibatch_size
            if self.lr_reference_minibatch is not None:
                ref = self.lr_reference_minibatch
                ref_mb = ref["overrides"].get(depth, ref["default"])
                trainer.lr_scale = minibatch_size / ref_mb
            if self.precompile_ahead:
                self._precompile_upcoming(depth, minibatch_size)
        if alpha != self.alpha:
            self.alpha = alpha
            trainer.alpha = alpha
            if trainer.dataset is not None:
                trainer.dataset.alpha = alpha
        trainer.stats["depth"] = depth
        trainer.stats["alpha"]["val"] = alpha
        if self.max_lod is not None and self.depth_offset is not None:
            trainer.stats["lod"]["val"] = self.lod


class LRScheduler(Plugin):
    """nimg-driven LR ramp for both optimizers (reference plugins.py:84-99,
    train.py:151-158): lr = lr_max * exp(-5 p^2) during the first
    ``rampup_kimg`` kimg. The step reads it from a device tensor, so a
    change never recaptures a graph."""

    def __init__(self, lr_max_d=0.001, lr_max_g=0.001, rampup_kimg=40.0):
        super().__init__([(1, "iteration")])
        self.lr_max_d = lr_max_d
        self.lr_max_g = lr_max_g
        self.rampup_kimg = rampup_kimg

    def register(self, trainer):
        self.trainer = trainer
        # the lr this plugin would set at an image count, for the grouped
        # dispatch's per-step vectors (lr_scale changes only with the depth,
        # which a group never crosses)
        trainer.lr_lookahead = self._lr_at
        self.iteration()

    def _lr_at(self, nimg):
        ramp = lr_rampup(nimg, self.rampup_kimg)
        scale = getattr(self.trainer, "lr_scale", 1.0)
        return self.lr_max_d * ramp * scale, self.lr_max_g * ramp * scale

    def iteration(self, *args):
        self.trainer.lr_d, self.trainer.lr_g = self._lr_at(
            self.trainer.cur_nimg)


class EfficientLossMonitor(Plugin):
    """Accumulates one loss stream and exposes its per-tick mean as
    ``stats[name]['epoch_mean']`` (reference plugins.py:102-111).

    Each iteration's loss, a scalar for one step or a (group,) vector for a
    grouped dispatch, is copied on the device (a graph returns the same
    tensors at every replay and overwrites them at the next); at the tick
    the copies are concatenated, so that every step counts once, fetched
    and averaged in float64 (``pggan_tpu/training/plugins.py:259-271``)."""

    def __init__(self, loss_no: int, stat_name: str):
        super().__init__([(1, "iteration"), (1, "epoch")])
        self.loss_no = loss_no
        self.stat_name = stat_name
        self._values = []

    def register(self, trainer):
        self.trainer = trainer
        trainer.stats[self.stat_name] = {
            "log_name": self.stat_name,
            "log_epoch_fields": ["{epoch_mean:.4f}"],
            "epoch_mean": float("nan"),
        }

    def iteration(self, idx, *losses):
        self._values.append(losses[self.loss_no].detach().clone())

    def epoch(self, epoch_idx):
        if self._values:
            vals = torch.cat([v.reshape(-1) for v in self._values])
            vals = vals.cpu().numpy().astype(np.float64)
            self.trainer.stats[self.stat_name]["epoch_mean"] = float(vals.mean())
            self._values = []


class AbsoluteTimeMonitor(Plugin):
    """Wall-clock stats per tick: total time, sec/tick, sec/kimg (reference
    plugins.py:114-139). ``sec.kimg`` is the framework's throughput metric."""

    def __init__(self, base_time=0.0):
        super().__init__([(1, "epoch")])
        self.base_time = base_time
        self.start_time = time.time()
        self.epoch_start = self.start_time
        self.start_nimg = None

    def register(self, trainer):
        self.trainer = trainer
        self.start_nimg = trainer.cur_nimg
        trainer.stats["sec"] = {"log_format": ":.1f"}

    def epoch(self, epoch_index):
        cur_time = time.time()
        tick_time = cur_time - self.epoch_start
        self.epoch_start = cur_time
        nimg_done = max(self.trainer.cur_nimg - self.start_nimg, 1)
        kimg_time = tick_time / nimg_done * 1000
        self.start_nimg = self.trainer.cur_nimg
        self.trainer.stats["time"] = timedelta(
            seconds=cur_time - self.start_time + self.base_time)
        self.trainer.stats["sec"]["tick"] = tick_time
        self.trainer.stats["sec"]["kimg"] = kimg_time


class SaverPlugin(Plugin):
    """Checkpointing (reference plugins.py:142-174), with the full state.

    Writes, every ``network_snapshot_ticks`` ticks and at the end:
    - ``network-snapshot-generator-{kimg:06}.dat`` / ``...-discriminator-...``
      (and ``...-generator-ema-...`` with a G EMA): snapshots in the JAX
      package's format, which both packages' generate CLIs load;
    - ``training-state-{kimg:06}.dat``: the port's full training state
      (both Adam states, the generator state, the clocks) for an exact
      resume.
    Older files are removed unless ``keep_old_checkpoints``.
    Under the builder's process group every rank calls it: each gives its
    generator state, and rank 0 writes the files with all of them.
    """

    last_pattern = "network-snapshot-{}-{}.dat"
    state_pattern = "training-state-{}.dat"

    def __init__(self, checkpoints_path, keep_old_checkpoints=False,
                 network_snapshot_ticks=40):
        super().__init__([(network_snapshot_ticks, "epoch"), (1, "end")])
        self.checkpoints_path = checkpoints_path
        self.keep_old_checkpoints = keep_old_checkpoints

    def epoch(self, epoch_index):
        kimg = "{:06}".format(self.trainer.cur_nimg // 1000)
        trainer = self.trainer
        group = trainer.builder.group
        rank_generators = None
        if group is not None:
            rank_generators = gather_generator_states(
                trainer.state.generator, group)
            if group.rank != 0:
                return
        # the new files first, then delete older ones: a crash mid-save never
        # leaves the directory without a resume point (both writes are
        # write-then-rename)
        written = []
        targets = [("generator", trainer.state.G),
                   ("discriminator", trainer.state.D)]
        if trainer.state.g_ema is not None:
            targets.append(("generator-ema", trainer.state.g_ema))
        for name, model in targets:
            path = os.path.join(self.checkpoints_path,
                                self.last_pattern.format(name, kimg))
            save_snapshot(path, model, trainer.depth, trainer.alpha)
            written.append(path)
        state_path = os.path.join(self.checkpoints_path,
                                  self.state_pattern.format(kimg))
        # the cumulative wall-clock (kept current by AbsoluteTimeMonitor,
        # registered ahead of the saver) continues on resume
        t = trainer.stats.get("time")
        base_time = t.total_seconds() if hasattr(t, "total_seconds") else 0.0
        save_training_state(state_path, trainer.state, trainer.cur_nimg,
                            trainer.iterations, base_time, rank_generators)
        written.append(state_path)
        print(f"[SaverPlugin] {state_path} at {trainer.cur_nimg} images",
              flush=True)
        if not self.keep_old_checkpoints:
            self._clear(self.last_pattern.format("*", "*"), keep=written)
            self._clear(self.state_pattern.format("*"), keep=written)

    def end(self, *args):
        self.epoch(*args)

    def _clear(self, pattern, keep=()):
        keep = {os.path.abspath(p) for p in keep}
        for file_name in glob(os.path.join(self.checkpoints_path, pattern)):
            if os.path.abspath(file_name) not in keep:
                os.remove(file_name)


class OutputGenerator(Plugin):
    """Periodic sample generation (reference plugins.py:177-195): draw
    ``samples_count`` latents, run the generator (its EMA when the state
    keeps one and ``use_ema``) at the current (depth, alpha), and hand the
    NCHW numpy output to every postprocessor with ``cur_nimg // 1000`` as
    the description."""

    def __init__(self, sample_fn, output_postprocessors, samples_count=6,
                 output_snapshot_ticks=3, use_ema=True):
        super().__init__([(output_snapshot_ticks, "epoch"), (1, "end")])
        self.sample_fn = sample_fn
        self.output_postprocessors = output_postprocessors
        self.samples_count = samples_count
        self.use_ema = use_ema

    def epoch(self, epoch_index):
        trainer = self.trainer
        state = trainer.state
        G = (state.g_ema if self.use_ema and state.g_ema is not None
             else state.G)
        z = np.asarray(self.sample_fn(self.samples_count), dtype=np.float32)
        z = torch.from_numpy(z).to(next(G.parameters()).device)
        out = trainer.builder.sample_fn(trainer.depth)(G, z, trainer.alpha)
        out_nchw = out.cpu().numpy().transpose(0, 3, 1, 2)  # NHWC -> NCHW
        for proc in self.output_postprocessors:
            try:
                proc(out_nchw, trainer.cur_nimg // 1000)
            except Exception:
                # a broken exporter must not kill a multi-day run
                print(f"[OutputGenerator] postprocessor {proc} failed:",
                      flush=True)
                traceback.print_exc()

    def end(self, *args):
        self.epoch(*args)


class MetricsExporter(Plugin):
    """Per-tick metrics export (the reference's CometML plugin role,
    plugins.py:198-216): appends one JSON object per tick with the selected
    dotted stat paths to ``metrics.jsonl``, and feeds a CometML-like
    ``experiment`` (``log_metric`` / ``log_epoch_end``) when one is given."""

    def __init__(self, fields, jsonl_path=None, experiment=None):
        super().__init__([(1, "epoch")])
        self.fields = fields
        self.jsonl_path = jsonl_path
        self.experiment = experiment

    def _resolve(self, field):
        parts = field.split(".")
        stat = self.trainer.stats.get(parts[0])
        for p in parts[1:]:
            if not isinstance(stat, dict):
                return None
            stat = stat.get(p)
        if isinstance(stat, dict):
            stat = stat.get("epoch_mean", stat.get("val"))
        return stat

    def epoch(self, epoch_index):
        record = {"tick": epoch_index}
        for field in self.fields:
            val = self._resolve(field)
            if hasattr(val, "total_seconds"):
                val = val.total_seconds()
            record[field] = (float(val) if isinstance(val, (int, float, np.floating))
                             else val)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.experiment is not None:
            for field, val in record.items():
                if field != "tick":
                    self.experiment.log_metric(field, val)
            self.experiment.log_epoch_end(epoch_index)


# the reference's name for the metrics plugin, as the JAX package keeps it
CometPlugin = MetricsExporter


class TraceProfiler(Plugin):
    """A ``torch.profiler`` trace of ``num_iterations`` iterations from
    ``start_iteration`` on (after the graphs' warm-up and capture), written
    to ``profile_dir`` as a Chrome trace (``chrome://tracing``, Perfetto)."""

    def __init__(self, profile_dir, start_iteration=20, num_iterations=5):
        super().__init__([(1, "iteration")])
        self.profile_dir = profile_dir
        self.start_iteration = start_iteration
        self.stop_iteration = start_iteration + num_iterations
        self._prof = None
        self._done = False

    def iteration(self, idx, *args):
        from torch.profiler import ProfilerActivity, profile
        if self._done:
            return
        if self._prof is None and idx >= self.start_iteration:
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and idx >= self.stop_iteration:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof, self._done = None, True
            print(f"[TraceProfiler] trace written to {path}", flush=True)


class Logger(Plugin):
    """Tick-line logger over the stats registry (the torch Logger role the
    reference subclasses at plugins.py:219-231).

    Renders, for each configured field, either the stat dict's
    ``log_epoch_fields`` templates (formatted with the dict itself) or the
    plain value; dotted fields index into nested stat dicts and use the
    parent's ``log_format`` when present.
    """

    def __init__(self, fields, interval=None):
        super().__init__(interval if interval is not None else [(1, "epoch")])
        self.fields = fields

    def _render_field(self, field):
        parts = field.split(".")
        stats = self.trainer.stats
        stat = stats.get(parts[0])
        if stat is None:
            return None
        if len(parts) > 1:
            fmt = stat.get("log_format", "") if isinstance(stat, dict) else ""
            for p in parts[1:]:
                if not isinstance(stat, dict) or p not in stat:
                    return None
                stat = stat[p]
            val = ("{" + fmt + "}").format(stat) if fmt else str(stat)
            return f"{field} {val}"
        if isinstance(stat, dict):
            name = stat.get("log_name", field)
            fields = stat.get("log_epoch_fields")
            if fields:
                try:
                    vals = " ".join(t.format(**stat) for t in fields)
                except (KeyError, ValueError):
                    vals = "?"
                return f"{name} {vals}"
            return f"{name} {stat}"
        return f"{field} {stat}"

    def epoch(self, epoch_idx):
        rendered = [self._render_field(f) for f in self.fields]
        self.log("  ".join(r for r in rendered if r is not None))

    def end(self, *args):
        pass

    def log(self, msg):
        print(msg, flush=True)


class TeeLogger(Logger):
    """Console + ``log.txt`` tee (reference plugins.py:219-231); ``close``
    closes the file."""

    def __init__(self, log_file, fields, interval=None):
        super().__init__(fields, interval)
        self.log_file = open(log_file, "a", 1)

    def log(self, msg):
        print(msg, flush=True)
        self.log_file.write(msg + "\n")

    def close(self):
        self.log_file.close()
