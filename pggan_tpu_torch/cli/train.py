"""Training entry point with the reflective ``--ClassName.param`` CLI: the
counterpart of ``pggan_tpu/cli/train.py`` (reference train.py).

Composes dataset -> models -> step builder -> trainer -> plugin stack and
runs the progressive schedule on one device, or data-parallel on N cards
with one process each:

    python -m pggan_tpu_torch.cli.train --dataset_class SyntheticDataset \\
        --SyntheticDataset.resolution 1024 --postprocessors "['ImageSaver']" \\
        --total_kimg 3000
    torchrun --nproc_per_node N -m pggan_tpu_torch.cli.train ...

The flags are the JAX CLI's plus ``--device`` (default ``cuda``, which
raises without a card; ``--device cpu`` trains on the CPU with the
kernels' plain versions). ``--device`` also sets the ``device`` of a
dataset class or postprocessor that has one (``SoundImageDataset``'s STFT,
``SoundSaver``'s Griffin-Lim) unless ``--Cls.device`` is given. On the
card every train step after a stage's first is a CUDA graph replay
(``training/steps.py``). ``--Trainer.steps_per_dispatch`` (8, as in the
JAX CLI) groups that many steps into one dispatch, on the card one graph
replay, wherever the schedule provably holds over them (1 turns it off);
``--Trainer.inflight_budget_mb`` (1024) bounds the pinned batch bytes of
the dispatches the card has not finished, past which the host waits for
the oldest (0: no waits; ``training/trainer.py``). Checkpoints are the JAX
format's snapshots plus the port's training state; ``--resume_network
latest`` resumes the newest run under ``--result_dir``. A JAX run resumes
too: its training state is read without JAX (``checkpoint.py``), and from
there on the two packages draw other latents.

Under ``torchrun`` (``--data_parallel``, the default) every rank joins the
process group (``parallel.initialize_distributed``: NCCL on the card, gloo
with ``--device cpu``) and trains on ``cuda:LOCAL_RANK``; the per-depth
minibatches are global batches, rounded up to a multiple of the world size
(``fit_minibatch_to_mesh``, logged), with ``--scale_lr_with_batch``
scaling the learning rate by the growth; each rank loads its shard of the
items, seeded ``random_seed + rank``; rank 0 alone writes the result
directory (log, metrics, samples, checkpoints). ``--num_devices``, when
set, must equal the world size. ``--data_parallel False`` refuses a launch
of several ranks.

``--architecture stylegan`` trains StyleGAN (``models/style.py``; its
fields as ``--StyleGenerator.*``, the CelebA-HQ widths by default) against
the Discriminator with StyleGAN's options (``--Discriminator.blur``,
``.mbstd_group_size``, ``.equalized_dense`` and ``.fmap_base`` default to
True, 4, True and 8192 there, unless set); ``pggan`` (the default) trains
PGGAN's ``Generator`` (``--Generator.*``).

``--debug_nans`` turns on autograd's anomaly detection.
``--DepthManager.precompile_ahead True`` (off by default, as in the JAX
CLI) makes the steps a stage needs next ready in a background thread: a
warm-up on a scratch copy of the state, then the graph's capture, so that
the first dispatch at such a key replays (``training/steps.py``).
"""

from __future__ import annotations

import os
import re
from argparse import ArgumentParser
from collections import OrderedDict
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

import pggan_tpu_torch.data.datasets as dataset_module
import pggan_tpu_torch.postprocess as postprocess_module
from pggan_tpu_torch.checkpoint import (
    load_model_snapshot,
    load_training_state,
    restore_training_state,
    snapshot_kimg,
)
from pggan_tpu_torch.cli.generate import resolve_device
from pggan_tpu_torch.data.loader import DataIterator
from pggan_tpu_torch.models import Discriminator, Generator
from pggan_tpu_torch.models.style import StyleGenerator
from pggan_tpu_torch.parallel import (
    check_batch_divisible,
    fit_minibatch_to_mesh,
    initialize_distributed,
    replicate,
)
from pggan_tpu_torch.training import schedule
from pggan_tpu_torch.training.plugins import (
    AbsoluteTimeMonitor,
    DepthManager,
    EfficientLossMonitor,
    LRScheduler,
    MetricsExporter,
    OutputGenerator,
    SaverPlugin,
    TeeLogger,
    TraceProfiler,
)
from pggan_tpu_torch.training.state import init_state
from pggan_tpu_torch.training.steps import TrainStepBuilder
from pggan_tpu_torch.training.trainer import Trainer
from pggan_tpu_torch.utils.config import (
    add_class_args,
    alias_default,
    generic_arg_parse,
    get_all_classes,
    get_structured_params,
    pass_device,
)
from pggan_tpu_torch.utils.misc import (
    create_result_subdir,
    load_pkl,
    params_to_str,
    random_latents,
    save_pkl,
)


class Adam:
    """Flag surface of the optimizer config (``--Adam.betas``,
    ``--Adam.eps``), as in the JAX CLI."""

    def __init__(self, betas=(0.0, 0.99), eps=1e-8):
        self.betas = betas
        self.eps = eps


# Top-level hyperparams (reference train.py:23-48): the JAX CLI's, and
# --device.
default_params = OrderedDict(
    result_dir="results",
    exp_name="specs512",
    minibatch_size=16,
    lr_rampup_kimg=40,
    G_lr_max=0.001,
    D_lr_max=0.001,
    total_kimg=3000,
    tick_kimg_default=20,
    image_snapshot_ticks=3,
    resume_network="",
    resume_time=0,
    num_data_workers=16,
    random_seed=1337,
    progressive_growing=True,
    comet_key="",
    comet_project_name="None",
    iwass_lambda=10.0,
    iwass_epsilon=0.001,
    iwass_target=1.0,
    g_ema_beta=0.0,      # >0 keeps an EMA of G (e.g. 0.999) and snapshots it
                         # as network-snapshot-generator-ema-*.dat
    save_dataset="",
    load_dataset="",
    dataset_class="",
    postprocessors=[],
    checkpoints_dir="",
    data_parallel=True,   # train over the ranks of a torchrun launch
    num_devices=0,        # 0: the launch's world size; else must equal it
    metrics_jsonl=True,   # per-tick metrics.jsonl in the result dir
    debug_nans=False,     # autograd anomaly detection
    profile_dir="",       # a torch.profiler trace of a few steps
    device_input_prep=False,  # ship uint8 batches; fade+remap on the device
    scale_lr_with_batch=False,  # scale the lr with a rounded-up batch
    device="cuda",
)
# the port's flags beyond the JAX CLI's (whose defaults default_params
# keeps)
port_params = OrderedDict(
    architecture="pggan",  # or "stylegan": StyleGenerator + StyleGAN's D
)
# the Discriminator's fields that --architecture stylegan sets, unless given
STYLE_D_DEFAULTS = {"blur": True, "mbstd_group_size": 4,
                    "equalized_dense": True, "fmap_base": 8192}

LOSSES = ["G_loss", "D_loss", "D_real", "D_fake"]


def _resume_kimg(resume_network: str) -> int:
    m = re.search(r"(\d+)\.dat$", resume_network.format("generator"))
    return int(m.group(1)) if m else 0


def find_latest_snapshot(result_root: str) -> str:
    """``--resume_network latest``: the newest generator snapshot with a
    discriminator twin under the results root, as a ``resume_network``
    pattern relative to the root. The run directory with the newest
    snapshot wins, then the highest kimg inside it
    (``pggan_tpu/cli/train.py:144-174``)."""
    import glob
    cands = [p for p in glob.glob(
        os.path.join(result_root, "**", "network-snapshot-generator-*.dat"),
        recursive=True)
        if os.path.exists(p.replace("-generator-", "-discriminator-"))]
    if not cands:
        raise SystemExit(
            f"--resume_network latest: no snapshot pairs under {result_root}")
    by_dir = {}
    for p in cands:
        by_dir.setdefault(os.path.dirname(p), []).append(p)
    run_dir = max(by_dir, key=lambda d: max(map(os.path.getmtime, by_dir[d])))
    rel = os.path.relpath(max(by_dir[run_dir], key=snapshot_kimg),
                          result_root)
    d, b = os.path.split(rel)
    return os.path.join(d, b.replace("network-snapshot-generator-",
                                     "network-snapshot-{}-"))


def make_experiment(params):
    """Optional CometML wiring (reference train.py:67-87); None when no key
    is configured or comet_ml is unavailable."""
    if not params["comet_key"]:
        return None
    try:
        from comet_ml import Experiment
    except ImportError as e:
        print(f"Unable to load comet_ml: {e}")
        return None
    experiment = Experiment(api_key=params["comet_key"],
                            project_name=params["comet_project_name"],
                            log_code=False)
    experiment.log_parameters({k: str(v) for k, v in params.items()
                               if not isinstance(v, dict)})
    return experiment


def _dataset(params):
    if params["load_dataset"]:
        return load_pkl(params["load_dataset"])
    if not params["dataset_class"]:
        raise SystemExit("One of either load_dataset (path to pkl) or "
                         "dataset_class needs to be specified.")
    cls = getattr(dataset_module, params["dataset_class"], None)
    if cls is None:
        names = sorted(c.__name__ for c in get_all_classes(dataset_module))
        raise SystemExit(f"Unknown dataset_class {params['dataset_class']!r}; "
                         f"available: {', '.join(names)}")
    dataset = cls(**pass_device(cls, params.get(params["dataset_class"], {}),
                                params["device"]))
    if params["save_dataset"]:
        save_pkl(params["save_dataset"], dataset)
    return dataset


class _Silent:
    """The logger of a rank other than 0: rank 0 alone writes the log."""

    def log(self, msg):
        pass

    def close(self):
        pass


def _group(params, device):
    """This rank's process group under a ``torchrun`` launch, or None
    (``pggan_tpu/cli/train.py:279-284``)."""
    launched = dist.is_initialized() or int(
        os.environ.get("WORLD_SIZE", 1)) > 1
    if not params["data_parallel"]:
        if launched:
            raise SystemExit("--data_parallel False, but launched over "
                             "several ranks")
        return None
    group = initialize_distributed(device.type)
    n = 1 if group is None else group.world_size
    if params["num_devices"] and params["num_devices"] != n:
        raise SystemExit(
            f"--num_devices {params['num_devices']}, but {n} rank(s): launch "
            f"one process per device (torchrun --nproc_per_node "
            f"{params['num_devices']} -m pggan_tpu_torch.cli.train ...)")
    return group


def _fit_batches(dm_cfg, world, scale_lr, logger) -> None:
    """The data-parallel batch policy (``pggan_tpu/cli/train.py:379-400``):
    each per-depth global minibatch rounded up to a multiple of the world
    size, logged; with ``scale_lr`` the learning rate grows with it."""
    ref_def = dm_cfg.get("minibatch_default", schedule.MINIBATCH_DEFAULT)
    ref_over = dm_cfg.get("minibatch_overrides",
                          schedule.MINIBATCH_OVERRIDES)
    new_def, new_over, changed = fit_minibatch_to_mesh(ref_def, ref_over,
                                                       world)
    dm_cfg["minibatch_default"] = new_def
    dm_cfg["minibatch_overrides"] = new_over
    if changed:
        logger.log(
            f"Pod batch policy: global minibatches rounded up to multiples "
            f"of {world} devices: " + ", ".join(
                ("default" if d == -1 else f"depth {d}") + f" {old}->{new}"
                for d, (old, new) in sorted(changed.items())))
        if scale_lr:
            dm_cfg["lr_reference_minibatch"] = {
                "default": ref_def, "overrides": dict(ref_over or {})}
            logger.log("LR linearly scaled with the grown batches "
                       "(--scale_lr_with_batch)")


def _register_outputs(trainer, params, result_dir, latent_size) -> None:
    """The sample writer and its postprocessors, and the trace profiler:
    rank 0's."""
    postprocessors = []
    for x in params["postprocessors"]:
        proc_cls = getattr(postprocess_module, x, None)
        if proc_cls is None:
            names = sorted(c.__name__
                           for c in get_all_classes(postprocess_module))
            raise SystemExit(f"Unknown postprocessor {x!r}; "
                             f"available: {', '.join(names)}")
        cfg = {k: (os.path.join(result_dir, v) if k == "samples_path" else v)
               for k, v in pass_device(proc_cls, params.get(x, {}),
                                       params["device"]).items()}
        postprocessors.append(proc_cls(**cfg))
    og_cfg = dict(params.get("OutputGenerator", {}))
    alias_default(og_cfg, "output_snapshot_ticks", OutputGenerator,
                   params["image_snapshot_ticks"])
    trainer.register_plugin(OutputGenerator(
        lambda n: random_latents(n, latent_size), postprocessors, **og_cfg))
    if params["profile_dir"]:
        trainer.register_plugin(TraceProfiler(params["profile_dir"]))


def _models(params, shape, seed):
    """A fresh G and D of ``--architecture``."""
    d_cfg = dict(params.get("Discriminator", {}))
    architecture = params.get("architecture", "pggan")
    if architecture == "stylegan":
        for key, value in STYLE_D_DEFAULTS.items():
            alias_default(d_cfg, key, Discriminator, value)
        G = StyleGenerator(shape, **params.get("StyleGenerator", {}),
                           generator=torch.Generator().manual_seed(seed))
    elif architecture == "pggan":
        G = Generator(shape, **params.get("Generator", {}),
                      generator=torch.Generator().manual_seed(seed))
    else:
        raise SystemExit(f"--architecture {architecture!r}: "
                         "pggan or stylegan")
    D = Discriminator(shape, **d_cfg,
                      generator=torch.Generator().manual_seed(seed + 1))
    return G, D


def build(params):
    """Everything ``main`` runs, up to the first step: returns
    ``(trainer, logger, total_kimg)`` with the plugins registered and, on a
    resume, the training state restored."""
    device = resolve_device(params["device"])
    group = _group(params, device)
    if group is not None:
        device = group.device
    rank = 0 if group is None else group.rank
    if params.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    seed = params["random_seed"]
    np.random.seed(seed)
    dataset = _dataset(params)

    stats_to_log = ["tick_stat", "kimg_stat"]
    if params["progressive_growing"]:
        stats_to_log.extend(["depth", "alpha", "lod", "minibatch_size"])
    stats_to_log.extend(["time", "sec.tick", "sec.kimg"] + LOSSES)
    result_dir = None
    logger = _Silent()
    if rank == 0:
        result_dir = create_result_subdir(params["result_dir"],
                                          params["exp_name"])
        logger = TeeLogger(os.path.join(result_dir, "log.txt"),
                           stats_to_log, [(1, "epoch")])
    logger.log(params_to_str(params))
    if group is not None:
        logger.log(f"Data-parallel over {group.world_size} rank(s) "
                   f"({group.backend}), rank 0 on {device}")

    # -- models (reference train.py:120-138) --------------------------------
    resume_sd = None
    resume_nimg = params.get("Trainer", {}).get("resume_nimg", 0)
    resume_iterations, resume_base_time = 0, 0.0
    if params["resume_network"] == "latest":
        params["resume_network"] = find_latest_snapshot(params["result_dir"])
        logger.log(f"resume latest -> {params['resume_network']}")
    if params["resume_network"]:
        logger.log(f"Resuming {params['resume_network']}")
        g_path, d_path = (os.path.join(params["result_dir"],
                                       params["resume_network"].format(m))
                          for m in ("generator", "discriminator"))
        G = load_model_snapshot(g_path, device)[0]
        D = load_model_snapshot(d_path, device)[0]
        if not resume_nimg:
            resume_nimg = _resume_kimg(params["resume_network"]) * 1000
        state_path = os.path.join(
            os.path.dirname(d_path),
            SaverPlugin.state_pattern.format(f"{resume_nimg // 1000:06}"))
        if os.path.exists(state_path):
            resume_sd, resume_nimg, resume_iterations, resume_base_time = \
                load_training_state(state_path)
            logger.log(f"Restored full training state from {state_path}")
    else:
        G, D = _models(params, dataset.shape, seed)
        G, D = G.to(device), D.to(device)
    if params["progressive_growing"] and G.max_depth != D.max_depth:
        raise ValueError(f"G max_depth {G.max_depth} != D {D.max_depth}")
    latent_size = G.latent_size
    logger.log(str(G))
    logger.log(str(D))

    # -- optimizer + state ----------------------------------------------------
    b1, b2 = params.get("Adam", {}).get("betas", (0.0, 0.99))
    eps = params.get("Adam", {}).get("eps", 1e-8)
    # with --g_ema_beta the average starts at the current G (Karras' Gs
    # initialization), unless the resumed state brings its own
    g_ema_beta = float(params["g_ema_beta"])
    state = init_state(G, D, seed=seed + 2, g_ema=g_ema_beta > 0, b1=b1,
                       b2=b2, eps=eps, group=group)
    if resume_sd is not None:
        restore_training_state(state, resume_sd, group)
        if group is not None:  # every rank read it: rank 0's copy rules
            replicate(state.tensors())
        if resume_sd["g_ema"] is not None and state.g_ema is None:
            logger.log("Resumed state has a generator EMA but --g_ema_beta "
                       "is 0; dropping the stale average (pass --g_ema_beta "
                       "to keep smoothing it)")
    logger.log("Total number of parameters in Generator: {}".format(
        sum(p.numel() for p in G.parameters())))
    logger.log("Total number of parameters in Discriminator: {}".format(
        sum(p.numel() for p in D.parameters())))

    trainer_cfg = dict(params.get("Trainer", {}))
    trainer_cfg.pop("resume_nimg", None)
    trainer_cfg.pop("resume_iterations", None)
    d_repeats = trainer_cfg.pop("D_training_repeats", 1)
    builder = TrainStepBuilder(
        G, D, d_training_repeats=d_repeats,
        iwass_lambda=params["iwass_lambda"],
        iwass_epsilon=params["iwass_epsilon"],
        iwass_target=params["iwass_target"],
        g_ema_beta=g_ema_beta if g_ema_beta > 0 else None, group=group)

    # -- input pipeline (reference train.py:140-145) ------------------------
    world = 1 if group is None else group.world_size

    def get_dataiter(minibatch_size):
        # minibatch_size is the global batch; each rank loads its shard
        check_batch_divisible(minibatch_size, world)
        return DataIterator(dataset, minibatch_size // world,
                            num_workers=params["num_data_workers"],
                            seed=seed + rank, raw=params["device_input_prep"],
                            shard_index=rank, num_shards=world)

    def rl(bs):
        return lambda: random_latents(bs, latent_size)

    mb_def = params["minibatch_size"]
    trainer = Trainer(G, D, builder, state, dataset,
                      None if params["progressive_growing"]
                      else iter(get_dataiter(mb_def)),
                      rl(mb_def),
                      D_training_repeats=d_repeats,
                      resume_nimg=resume_nimg,
                      resume_iterations=resume_iterations,
                      **trainer_cfg)

    # -- plugin stack, the JAX CLI's order (train.py:405-464) ---------------
    if params["progressive_growing"]:
        dm_cfg = dict(params.get("DepthManager", {}))
        alias_default(dm_cfg, "tick_kimg_default", DepthManager,
                       params["tick_kimg_default"])
        if dm_cfg.get("max_lod") is None:  # Karras-parity lod logging
            dm_cfg["max_lod"] = G.R
        if dm_cfg.get("depth_offset") is None:
            dm_cfg["depth_offset"] = dataset.model_dataset_depth_offset
        if group is not None:
            _fit_batches(dm_cfg, world, params["scale_lr_with_batch"],
                         logger)
        trainer.register_plugin(DepthManager(
            get_dataiter, rl, min(G.max_depth, D.max_depth), **dm_cfg))
    else:
        trainer.depth = dataset.model_depth
        trainer.alpha = dataset.alpha
        trainer.minibatch_size = mb_def
    for i, loss_name in enumerate(LOSSES):
        trainer.register_plugin(EfficientLossMonitor(i, loss_name))
    # wall-clock before the saver: the checkpoint keeps the cumulative
    # "time" stat of the tick it saves; --resume_time overrides it
    trainer.register_plugin(AbsoluteTimeMonitor(
        params["resume_time"] or resume_base_time))
    # on every rank: it gathers each rank's generator state; rank 0 writes
    trainer.register_plugin(SaverPlugin(params["checkpoints_dir"] or result_dir,
                                        **params.get("SaverPlugin", {})))
    if rank == 0:
        _register_outputs(trainer, params, result_dir, latent_size)
    trainer.register_plugin(LRScheduler(params["D_lr_max"],
                                        params["G_lr_max"],
                                        params["lr_rampup_kimg"]))
    if rank == 0:
        trainer.register_plugin(logger)
        metric_fields = [f"{name}.epoch_mean" for name in LOSSES] + \
            ["sec.kimg", "sec.tick", "kimg_stat"] + \
            (["depth", "alpha"] if params["progressive_growing"] else [])
        experiment = make_experiment(params)
        if params["metrics_jsonl"] or experiment is not None:
            trainer.register_plugin(MetricsExporter(
                metric_fields,
                jsonl_path=(os.path.join(result_dir, "metrics.jsonl")
                            if params["metrics_jsonl"] else None),
                experiment=experiment))
    return trainer, logger, params["total_kimg"]


def main(params):
    """Train, then close the loader and the log. Returns the trainer."""
    trainer, logger, total_kimg = build(params)
    device = next(trainer.G.parameters()).device
    if device.type == "cuda":  # the peak from here: state and steps
        torch.cuda.reset_peak_memory_stats(device)
    try:
        trainer.run(total_kimg)
        if trainer.builder.group is not None:
            dist.barrier()  # the run ends once rank 0 has written its files
        if device.type == "cuda":
            keys = list(trainer.builder.graphs())
            logger.log(f"CUDA graphs captured: {len(keys)}, for (depth, "
                       f"batch, fade[, group]) {keys}; peak device memory "
                       f"{torch.cuda.max_memory_allocated(device)} B")
    finally:
        # a precompile still queued, for a stage the run did not reach or
        # after a failure, is dropped; one running ends before the process
        trainer.builder.join_precompiles(cancel=True)
        if hasattr(trainer.dataiter, "close"):
            trainer.dataiter.close()
        trainer.dataset.close()
        logger.close()
    return trainer


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    needarg_classes = [Trainer, Generator, StyleGenerator, Discriminator,
                       DepthManager, SaverPlugin, OutputGenerator, Adam]
    needarg_classes += get_all_classes(dataset_module)
    needarg_classes += get_all_classes(postprocess_module)
    excludes = {
        "Generator": {"device", "generator"},
        "StyleGenerator": {"device", "generator"},
        "Discriminator": {"device", "generator"},
        "DepthManager": {"create_dataiter_fun", "create_rlg", "max_depth"},
    }
    flat_defaults = {**default_params, **port_params}
    for k, v in flat_defaults.items():
        parser.add_argument(
            f"--{k}", type=partial(generic_arg_parse, hinttype=type(v)))
    add_class_args(parser, needarg_classes, excludes=excludes,
                   default_params=flat_defaults)
    parser.set_defaults(**flat_defaults)
    return parser


def cli_main(argv=None):
    params = get_structured_params(vars(build_parser().parse_args(argv)))
    owned = not dist.is_initialized()  # a group this run creates, it ends
    try:
        return main(params)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli_main()
