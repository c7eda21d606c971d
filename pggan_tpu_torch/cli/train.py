"""Training entry point with the reflective ``--ClassName.param`` CLI: the
counterpart of ``pggan_tpu/cli/train.py`` (reference train.py).

Composes dataset -> models -> step builder -> trainer -> plugin stack and
runs the progressive schedule on one device:

    python -m pggan_tpu_torch.cli.train --dataset_class SyntheticDataset \\
        --SyntheticDataset.resolution 1024 --postprocessors "['ImageSaver']" \\
        --total_kimg 3000

The flags are the JAX CLI's plus ``--device`` (default ``cuda``, which
raises without a card; ``--device cpu`` trains on the CPU with the
kernels' plain versions). ``--device`` also sets the ``device`` of a
dataset class or postprocessor that has one (``SoundImageDataset``'s STFT,
``SoundSaver``'s Griffin-Lim) unless ``--Cls.device`` is given. On the card every train step after a stage's
first is a CUDA graph replay (``training/steps.py``). Checkpoints are the
JAX format's snapshots plus the port's training state; ``--resume_network
latest`` resumes the newest run under ``--result_dir``.

Accepted for the JAX CLI's sake and without effect here:
``--Trainer.steps_per_dispatch``, ``--Trainer.inflight_budget_mb`` (a
replay is one launch a step already), and ``--data_parallel`` /
``--num_devices`` / ``--scale_lr_with_batch`` (one device). ``--debug_nans``
turns on autograd's anomaly detection. ``--DepthManager.precompile_ahead
True`` raises: a graph is captured after a real step of its stage.
"""

from __future__ import annotations

import os
import re
from argparse import ArgumentParser
from collections import OrderedDict
from functools import partial

import numpy as np
import torch

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
    data_parallel=True,   # one device here: no effect
    num_devices=0,        # one device here: no effect
    metrics_jsonl=True,   # per-tick metrics.jsonl in the result dir
    debug_nans=False,     # autograd anomaly detection
    profile_dir="",       # a torch.profiler trace of a few steps
    device_input_prep=False,  # ship uint8 batches; fade+remap on the device
    scale_lr_with_batch=False,  # one device here: no effect
    device="cuda",
)

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


def build(params):
    """Everything ``main`` runs, up to the first step: returns
    ``(trainer, logger, total_kimg)`` with the plugins registered and, on a
    resume, the training state restored."""
    device = resolve_device(params["device"])
    if params.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    seed = params["random_seed"]
    np.random.seed(seed)
    dataset = _dataset(params)
    result_dir = create_result_subdir(params["result_dir"], params["exp_name"])

    stats_to_log = ["tick_stat", "kimg_stat"]
    if params["progressive_growing"]:
        stats_to_log.extend(["depth", "alpha", "lod", "minibatch_size"])
    stats_to_log.extend(["time", "sec.tick", "sec.kimg"] + LOSSES)
    logger = TeeLogger(os.path.join(result_dir, "log.txt"), stats_to_log,
                       [(1, "epoch")])
    logger.log(params_to_str(params))

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
        G = Generator(dataset.shape, **params.get("Generator", {}),
                      generator=torch.Generator().manual_seed(seed))
        D = Discriminator(dataset.shape, **params.get("Discriminator", {}),
                          generator=torch.Generator().manual_seed(seed + 1))
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
                       b2=b2, eps=eps)
    if resume_sd is not None:
        restore_training_state(state, resume_sd)
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
        g_ema_beta=g_ema_beta if g_ema_beta > 0 else None)

    # -- input pipeline (reference train.py:140-145) ------------------------
    def get_dataiter(minibatch_size):
        return DataIterator(dataset, minibatch_size,
                            num_workers=params["num_data_workers"],
                            seed=seed, raw=params["device_input_prep"])

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
    trainer.register_plugin(SaverPlugin(params["checkpoints_dir"] or result_dir,
                                        **params.get("SaverPlugin", {})))
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
    trainer.register_plugin(LRScheduler(params["D_lr_max"],
                                        params["G_lr_max"],
                                        params["lr_rampup_kimg"]))
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
        if device.type == "cuda":
            keys = trainer.builder.graphed_keys()
            logger.log(f"CUDA graphs captured: {len(keys)}, for (depth, "
                       f"batch, fade) {keys}; peak device memory "
                       f"{torch.cuda.max_memory_allocated(device)} B")
    finally:
        if hasattr(trainer.dataiter, "close"):
            trainer.dataiter.close()
        trainer.dataset.close()
        logger.close()
    return trainer


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    needarg_classes = [Trainer, Generator, Discriminator, DepthManager,
                       SaverPlugin, OutputGenerator, Adam]
    needarg_classes += get_all_classes(dataset_module)
    needarg_classes += get_all_classes(postprocess_module)
    excludes = {
        "Generator": {"device", "generator"},
        "Discriminator": {"device", "generator"},
        "DepthManager": {"create_dataiter_fun", "create_rlg", "max_depth"},
    }
    flat_defaults = dict(default_params)
    for k in default_params:
        parser.add_argument(
            f"--{k}",
            type=partial(generic_arg_parse, hinttype=type(default_params[k])))
    add_class_args(parser, needarg_classes, excludes=excludes,
                   default_params=flat_defaults)
    parser.set_defaults(**flat_defaults)
    return parser


def cli_main(argv=None):
    params = get_structured_params(vars(build_parser().parse_args(argv)))
    return main(params)


if __name__ == "__main__":
    cli_main()
