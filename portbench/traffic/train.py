"""Train traffic: the program's ``Trainer`` resumed at the first image of a
stage's fade, fed synthetic reals through its threaded loader with host
prep, dispatching ``steps_per_dispatch`` steps as one CUDA graph replay.

Set-up builds the models, the state, the step builder, the dataset and the
``Trainer`` with the schedule plugins the train CLI registers, and makes
the cell's step keys ready (``TrainStepBuilder.precompile``: a warm-up
step on a scratch copy of the state, then the capture): the single step
and the group. It then drives the state from the seed's weights through
its first steps, each through ``Trainer.train`` and the loader: three
single-step dispatches (the trainer's ``steps_per_dispatch`` at 1), whose
states the reference follows from the start, then one dispatch of the
group graph that the window replays, which the reference follows step by
step from the program's state after the three: the reals of every step,
the losses of its first step and each parameter's change over the group.
The window then dispatches groups until ``seconds`` have passed and
closes when the card has finished what was dispatched.

Why single steps first: the state is seen only between dispatches, and
the steps inside a group part from the reference's by the flips of Adam's
sign-like first updates where a gradient is rounding noise, so that the
gradient after a group differs from a float32 reference's by as much as
from the program's (PERF.md). The first gradient is read after one step
from the seed's weights; the group is read from a state both sides share.

Parameters (the traffic file): ``depth``, ``batch`` (the minibatch the
schedule gives that depth, checked), ``resume_nimg`` (the fade's first
image, past the learning rate's ramp), ``fade_nimg`` (the fade's length
in images), ``steps_per_dispatch``, ``checked_steps`` (the single steps
the reference follows), ``items`` (synthetic reals held),
``data_workers`` (loader threads), ``trace_dispatches`` (the traced
window's length), ``tick_kimg`` (the trainer's tick at the cell's depth,
long enough that none falls due in a run).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import numpy as np
import torch

from portbench import check, inputs, tracing, yardstick
from portbench.reference import pggan

END_TO_END = ("train_img_s", "setup_s")
# Dispatches the window lets the host queue ahead of the card. The
# trainer's own bound is its pinned bytes (1 GiB by default), which at 64
# px holds some 160 dispatches, minutes of work: the host would run that
# far past the window's end. Two keep the card fed (a dispatch is 0.5-1 s
# of work and takes the host tens of milliseconds to issue) and close the
# window within two dispatches of ``seconds``.
AHEAD = 2


class _Recorder:
    """The loader as the trainer sees it, keeping a copy of the first
    ``keep`` batches it hands over."""

    def __init__(self, it, keep: int, store: list):
        self.it, self.keep, self.store = it, keep, store

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        if len(self.store) < self.keep:
            self.store.append(np.array(batch, copy=True))
        return batch

    def close(self):
        self.it.close()


def _program(cfg: dict, tr: dict, s: dict, device, rows: list, log):
    """Build the trainer as the train CLI builds it, on the benchmark's
    weights and reals."""
    from pggan_tpu_torch.data.datasets import DepthDataset
    from pggan_tpu_torch.data.loader import DataIterator
    from pggan_tpu_torch.models import Discriminator, Generator
    from pggan_tpu_torch.training.plugins import (AbsoluteTimeMonitor,
                                                  DepthManager,
                                                  EfficientLossMonitor,
                                                  LRScheduler, Plugin)
    from pggan_tpu_torch.training.state import init_state
    from pggan_tpu_torch.training.steps import TrainStepBuilder
    from pggan_tpu_torch.training.trainer import Trainer
    from pggan_tpu_torch.utils.misc import random_latents

    shape = (1, cfg["num_channels"], cfg["resolution"], cfg["resolution"])
    with torch.device(device):  # init draws on the device, then replaced
        init = torch.Generator(device=device)
        G = Generator(shape, generator=init, **model_args(cfg, "G"))
        D = Discriminator(shape, generator=init, **model_args(cfg, "D"))
    log("models built")
    w = inputs.weights(cfg, s["weights"], device)
    inputs.load_into(G, "G.", w)
    inputs.load_into(D, "D.", w)
    log("weights on the device")
    state = init_state(G, D, seed=s["state"], b1=cfg["adam_betas"][0],
                       b2=cfg["adam_betas"][1], eps=cfg["adam_eps"])
    builder = TrainStepBuilder(G, D, d_training_repeats=1,
                               iwass_lambda=cfg["iwass_lambda"],
                               iwass_epsilon=cfg["iwass_epsilon"],
                               iwass_target=cfg["iwass_target"])
    res = 4 * 2 ** tr["depth"]
    level = tr["depth"] + 2
    held = inputs.items(cfg, res, tr["items"], s["items"])
    log("reals made")

    class Reals(DepthDataset):
        """The benchmark's synthetic reals, held at the stage's level."""

        @property
        def data(self):
            return self._data

        def __len__(self):
            return held.shape[0]

    data = Reals(model_dataset_depth_offset=2)
    data._data = [None] * (level + 1)
    data._data[level] = held

    def get_dataiter(minibatch):
        return _Recorder(DataIterator(data, minibatch,
                                      num_workers=tr["data_workers"],
                                      seed=s["loader"]),
                         tr["checked_steps"] + tr["steps_per_dispatch"],
                         rows)

    def rl(bs):
        return lambda: random_latents(bs, G.latent_size)

    trainer = Trainer(G, D, builder, state, data, None, rl(16),
                      D_training_repeats=1, resume_nimg=tr["resume_nimg"],
                      steps_per_dispatch=tr["steps_per_dispatch"])
    losses = []

    class Losses(Plugin):
        """The losses of the set-up's dispatches, one a step: a scalar a
        single step, a vector a group."""

        def __init__(self):
            super().__init__([(1, "iteration")])

        def iteration(self, it, *metrics):
            if len(losses) <= tr["checked_steps"]:
                losses.append([m.detach().reshape(-1).clone()
                               for m in metrics])

    trainer.register_plugin(DepthManager(
        get_dataiter, rl, min(G.max_depth, D.max_depth),
        minibatch_overrides={int(k): v for k, v in
                             cfg["minibatch_overrides"].items()},
        minibatch_default=cfg["minibatch_default"],
        tick_kimg_default=20, tick_kimg_overrides={
            tr["depth"]: tr["tick_kimg"]}, max_lod=G.R, depth_offset=2))
    for i, name in enumerate(check.LOSSES):
        trainer.register_plugin(EfficientLossMonitor(i, name))
    trainer.register_plugin(AbsoluteTimeMonitor(0))
    trainer.register_plugin(LRScheduler(cfg["lr"], cfg["lr"],
                                        cfg["lr_rampup_kimg"]))
    trainer.register_plugin(Losses())
    if tr["resume_nimg"] < cfg["lr_rampup_kimg"] * 1000:
        raise ValueError("the traffic starts inside the learning-rate ramp")
    if (trainer.depth, trainer.alpha, trainer.minibatch_size) != \
            (tr["depth"], 0.0, tr["batch"]):
        raise RuntimeError(
            f"the trainer stands at depth {trainer.depth}, alpha "
            f"{trainer.alpha}, minibatch {trainer.minibatch_size}; the "
            f"traffic wants depth {tr['depth']}, alpha 0, minibatch "
            f"{tr['batch']}")
    return trainer, w, held, losses


def model_args(cfg: dict, which: str) -> dict:
    """The model constructor's arguments from a configuration."""
    args = dict(fmap_base=cfg["fmap_base"], fmap_decay=cfg["fmap_decay"],
                fmap_max=cfg["fmap_max"], wscale=cfg["use_wscale"],
                leakyrelu=cfg["use_leakyrelu"], compute_dtype=cfg["dtype"])
    if which == "G":
        args.update(latent_size=cfg["latent_size"],
                    normalize_latents=cfg["normalize_latents"],
                    pixelnorm=cfg["use_pixelnorm"])
    return args


def _dispatch(trainer) -> None:
    """One pass of ``Trainer.run``'s loop: a dispatch, then the tick's
    plugins where one falls due."""
    trainer.train()
    if trainer.cur_nimg >= trainer.tick_start_nimg + \
            trainer.tick_duration_nimg:
        trainer._rollover_tick()


def _named(module, prefix: str, tensors=None) -> dict:
    """``prefix + name -> tensor`` of a model's parameters, or of a list
    of tensors in the same order (an Adam state's)."""
    names = [prefix + k for k, _ in module.named_parameters()]
    return dict(zip(names, tensors if tensors is not None
                    else module.parameters()))


def _params(state) -> dict:
    return {**_named(state.G, "G."), **_named(state.D, "D.")}


def _snapshot(state) -> dict:
    """The state a dispatch starts from, on the host: the parameters, and
    each Adam's second moments and step count (b1 = 0: the first moments
    are the last gradient, which no step reads)."""
    nu = {**_named(state.G, "G.", state.g_opt.nu),
          **_named(state.D, "D.", state.d_opt.nu)}
    return {"params": {k: v.detach().to("cpu", copy=True)
                       for k, v in _params(state).items()},
            "nu": {k: v.to("cpu", copy=True) for k, v in nu.items()},
            "count": {"G": int(state.g_opt.count),
                      "D": int(state.d_opt.count)}}


def _change(params: dict, start: dict) -> dict:
    """Each parameter's change from ``start``, as a norm, leaf by leaf."""
    return {k: float(torch.linalg.vector_norm(
        (v.detach() - start[k].to(v.device)).double()))
        for k, v in params.items()}


def _per_step(losses: list) -> list:
    """The losses of each step, from one entry a dispatch."""
    out = []
    for m in losses:
        vectors = [v.tolist() for v in m]
        out += [dict(zip(check.LOSSES, step)) for step in zip(*vectors)]
    return out


def run(cell) -> None:
    """One run of a train cell; fills ``cell.result``."""
    cfg, tr, device = cell.cfg, cell.traffic, cell.device
    s = inputs.seeds(cell.seed)
    spd, batch, depth = tr["steps_per_dispatch"], tr["batch"], tr["depth"]
    n = tr["checked_steps"]
    rows = []
    launches = tracing.LaunchLog()
    trainer, w, held, losses = _program(cfg, tr, s, device, rows, cell.log)
    cell.log("trainer built")
    builder, state = trainer.builder, trainer.state
    single, group = (depth, batch, True), (depth, batch, True, spd)
    builder.precompile(*single, state)
    with (launches.recording(graph=True) if cell.trace
          else contextlib.nullcontext()):
        builder.precompile(*single, state, group=spd)
    cell.log("step keys warmed and captured")
    prog = {}
    trainer.steps_per_dispatch = 1
    for k in range(n):
        _dispatch(trainer)
        if k == 0:  # b1 = 0: Adam's mu after one step is its gradient
            prog["grad"] = check.norms({
                **_named(state.G, "G.", state.g_opt.mu),
                **_named(state.D, "D.", state.d_opt.mu)})
    prog["change"] = _change(_params(state), w)
    del w
    prog["start"] = _snapshot(state)  # where the group starts
    trainer.steps_per_dispatch = spd
    _dispatch(trainer)
    cell.sync()
    cell.log("checked steps dispatched")
    prog["group_change"] = _change(_params(state), prog["start"]["params"])
    steps = _per_step(losses)
    prog["losses"], prog["group_losses"] = steps[:n], steps[n:]
    prog["rows"] = np.stack(rows)
    if (trainer.iterations, len(steps), len(rows)) != (n + spd,) * 3:
        raise RuntimeError(f"set-up ran {trainer.iterations} steps; "
                           f"expected {n} single ones and a group of {spd}")
    keys = set(builder._steps)
    t0 = time.perf_counter()
    cell.setup_s = t0 - cell.t0
    it0 = trainer.iterations
    if cell.trace:
        with tracing.traced() as traced:
            for _ in range(tr["trace_dispatches"]):
                _dispatch(trainer)
        window = traced["trace"].window_s
    else:
        ahead = collections.deque()
        while True:
            _dispatch(trainer)
            if time.perf_counter() - t0 >= cell.seconds:
                break
            if device.type == "cuda":  # the host stays AHEAD dispatches on
                ahead.append(torch.cuda.Event())
                ahead[-1].record()
                if len(ahead) > AHEAD:
                    ahead.popleft().synchronize()
        cell.sync()
        window = time.perf_counter() - t0
    steps = trainer.iterations - it0
    if set(builder._steps) != keys:
        raise RuntimeError(f"the window made step keys "
                           f"{sorted(set(builder._steps) - keys)}: "
                           "something compiled inside it")
    cell.close_window()
    cell.log(f"window closed: {steps} steps in {window:.3f} s")
    graphs = [builder._steps[k] for k in (single, group)]
    cell.counters = {name: sum(getattr(g, name) or 0.0 for g in graphs)
                     for name in ("warm_s", "eager_s", "capture_s")}
    cell.result.update(attempted=steps, failed=0)
    cell.metrics["train_img_s"] = steps * batch / window
    # the group's captured calls, a dispatch's worth, scaled by the steps
    cell.layer = dict(steps=steps, dispatches=steps / spd, launches=launches,
                      flops=yardstick.step_flops(cfg, depth, batch, True,
                                                 hyper(cfg)) * steps,
                      window_s=window)
    if cell.trace:
        cell.layer["trace"] = traced["trace"]
    trainer.dataiter.close()
    del trainer, builder, state, graphs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cell.checks = compare(cell, prog, held, s)
    cell.log("reference compared")


def hyper(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("iwass_lambda", "iwass_epsilon",
                                "iwass_target")}


def _alpha(tr: dict, k: int) -> float:
    """The fade's alpha at step ``k`` (from 0) of the traffic."""
    return float(np.float32(k * tr["batch"] / tr["fade_nimg"]))


def _precision(precision: str) -> None:
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"


def _optimizers(cfg: dict, p: dict):
    b1, b2 = cfg["adam_betas"]
    return [pggan.Adam({k: v for k, v in p.items() if k[0] == m}, b1, b2,
                       cfg["adam_eps"]) for m in "DG"]


def reference(cfg: dict, tr: dict, s: dict, reals: list, device,
              precision: str = check.REFERENCE,
              half_batch: bool = False) -> dict:
    """The reference's own run of the checked single steps from the
    seed's weights, reals and draws: each step's losses, the first step's
    gradient norms and each parameter's change over the steps by leaf."""
    net = pggan.Net(cfg, precision)
    _precision(precision)
    try:
        p0 = {k: v.to(net.dtype) for k, v in
              inputs.weights(cfg, s["weights"], device).items()}
        p = {k: v.clone() for k, v in p0.items()}
        opt_d, opt_g = _optimizers(cfg, p)
        gen = torch.Generator(device=device).manual_seed(s["state"])
        out, grad = [], None
        for k in range(tr["checked_steps"]):
            noise = pggan.draws(gen, tr["batch"], cfg["latent_size"],
                                net.dtype)
            x = torch.from_numpy(reals[k]).to(device, net.dtype)
            step = pggan.train_step(net, p, opt_d, opt_g, x, noise,
                                    tr["depth"], _alpha(tr, k), True,
                                    cfg["lr"], cfg["lr"], hyper(cfg),
                                    half_batch)
            grads = step.pop("grads")
            if grad is None:
                grad = check.norms(grads)
            out.append({n: float(v) for n, v in step.items()})
        return {"losses": out, "grad": grad,
                "change": check.norms({k: p[k] - p0[k] for k in p})}
    finally:
        pggan.full_precision()


def reference_group(cfg: dict, tr: dict, s: dict, reals: list, device,
                    start: dict, precision: str = check.REFERENCE,
                    fault: str | None = None) -> dict:
    """The group's steps from ``start`` (the program's state after the
    single steps, ``_snapshot``): each step's losses, and each parameter's
    change over the group by leaf. ``fault`` plants one of the study's
    faults: ``half_batch`` (half of each batch left out), ``unchanged``
    (every step leaves the parameters as they were), ``first_batch``
    (every step takes the group's first reals)."""
    net = pggan.Net(cfg, precision)
    _precision(precision)
    try:
        p = {k: v.to(device, net.dtype, copy=True)
             for k, v in start["params"].items()}
        p0 = {k: v.clone() for k, v in p.items()}
        opt_d, opt_g = _optimizers(cfg, p)
        for opt, model in ((opt_d, "D"), (opt_g, "G")):
            opt.t = start["count"][model]
            opt.nu = {k: start["nu"][k].to(device, net.dtype, copy=True)
                      for k in opt.nu}
        gen = torch.Generator(device=device).manual_seed(s["state"])
        n = tr["checked_steps"]
        for _ in range(n):  # the single steps' draws
            pggan.draws(gen, tr["batch"], cfg["latent_size"], net.dtype)
        lr = 0.0 if fault == "unchanged" else cfg["lr"]
        out = []
        for j, x in enumerate(reals):
            noise = pggan.draws(gen, tr["batch"], cfg["latent_size"],
                                net.dtype)
            x = reals[0] if fault == "first_batch" else x
            step = pggan.train_step(net, p, opt_d, opt_g,
                                    torch.from_numpy(x).to(device, net.dtype),
                                    noise, tr["depth"], _alpha(tr, n + j),
                                    True, lr, lr, hyper(cfg),
                                    fault == "half_batch")
            step.pop("grads")
            out.append({k: float(v) for k, v in step.items()})
        return {"losses": out,
                "change": check.norms({k: p[k] - p0[k] for k in p})}
    finally:
        pggan.full_precision()


# The group's losses after its first step are not compared: from its
# first update on, the flips of Adam's sign-like updates, where a gradient
# is rounding noise, part the two sides about tenfold a step, the float32
# reference's as much as the program's, as far as the control (PERF.md).
NAMES = ("loss_gap", "g_loss_gap", "grad_gap", "change_gap",
         "group_change_gap")


def _firsts(side: dict) -> list:
    """The first single step's losses and the group's first step's, each
    from a state both sides share."""
    return [side["losses"][0], side["group_losses"][0]]


def _gaps(side: dict, ref: dict, keep: list) -> dict:
    """Each checked number of ``side`` against ``ref``: the losses of the
    first single step and of the group's first step (D's, taken before any
    update, and G's apart, taken after D's update); the first step's
    gradient and the change over the single steps, by the worst leaf; the
    change over the group, by the median leaf (the worst leaf's follows
    the later steps' flips)."""
    return {
        "loss_gap": check.loss_gap(_firsts(side), _firsts(ref),
                                   check.BEFORE_UPDATE),
        "g_loss_gap": check.loss_gap(_firsts(side), _firsts(ref),
                                     ("G_loss",)),
        "grad_gap": check.leaf_gap(side["grad"], ref["grad"]),
        "change_gap": check.leaf_gap(side["change"], ref["change"], keep),
        "group_change_gap": check.median_leaf_gap(
            side["group_change"], ref["group_change"], keep),
    }


def _with_group(side: dict, group: dict) -> dict:
    return dict(side, group_losses=group["losses"],
                group_change=group["change"])


def compare(cell, prog: dict, held: np.ndarray, s: dict) -> list:
    """The checks of a train run: the reals' rows of every checked step
    rebuilt from the items, then the reference's steps against the
    program's."""
    tr, limits = cell.traffic, cell.limits
    n = tr["checked_steps"]
    found = check.identify_rows(
        prog["rows"].reshape((-1,) + prog["rows"].shape[2:]), held,
        tr["fade_nimg"])
    if any(i < 0 for i, _ in found):
        return [(name, check.FAIL, limits[name])
                for name in ("rows_gap",) + NAMES]
    reals = list(np.concatenate([pggan.prep_rows(held[i:i + 1], a)
                                 for i, a in found])
                 .reshape(prog["rows"].shape))
    rows_gap = float(np.abs(np.stack(reals) - prog["rows"]).max())
    ref = _with_group(
        reference(cell.cfg, tr, s, reals[:n], cell.device),
        reference_group(cell.cfg, tr, s, reals[n:], cell.device,
                        prog["start"]))
    keep = check.moved([ref["grad"]])
    gaps = _gaps(prog, ref, keep)
    if cell.study:
        cell.study_readings = study(cell, prog, ref, reals, s, keep)
    return [("rows_gap", rows_gap, limits["rows_gap"])] + [
        (name, gaps[name], limits[name]) for name in NAMES]


def study(cell, prog, ref, reals, s, keep) -> dict:
    """Each number as the program, the float32 reference, the control
    (TF32) and the planted faults read it against the check's reference.
    The single steps of each side run from the seed's weights, its group
    from the program's state after the single steps. A group-only fault
    (``unchanged``, ``first_batch``) keeps the program's single steps."""
    tr, n = cell.traffic, cell.traffic["checked_steps"]

    def readings(side):
        out = _gaps(side, ref, keep)
        out["loss_steps_gap"] = check.loss_gap(side["losses"], ref["losses"])
        med = check.medians(ref["grad"])
        leaf = {k: abs(side["grad"][k] - ref["grad"][k])
                / max(ref["grad"][k], med[k[:2]])
                for k in ref["grad"] if ref["grad"][k] > 0}
        worst = max(leaf, key=leaf.get)
        group = ref["group_losses"]
        scale = {name: np.mean([abs(r[name]) for r in group])
                 for name in check.BEFORE_UPDATE}
        out.update(
            grad_median_gap=float(np.median(list(leaf.values()))),
            grad_worst_leaf=[worst, ref["grad"][worst] / med[worst[:2]]],
            group_change_worst_gap=check.leaf_gap(
                side["group_change"], ref["group_change"], keep),
            group_steps_gap=[max(abs(p[name] - r[name]) / scale[name]
                                 for name in check.BEFORE_UPDATE)
                             for p, r in zip(side["group_losses"], group)])
        return out

    out = {"program": readings(prog),
           "losses": {"program": [prog["losses"], prog["group_losses"]],
                      "reference": [ref["losses"], ref["group_losses"]]}}
    singles = {name: reference(cell.cfg, tr, s, reals[:n], cell.device,
                               precision, half)
               for name, precision, half in (
                   ("float32", "float32", False),
                   ("control_tf32", "tf32", False),
                   ("fault_half_batch", "float32", True))}
    for name, precision, fault in (
            ("float32", "float32", None),
            ("control_tf32", "tf32", None),
            ("fault_half_batch", "float32", "half_batch"),
            ("fault_unchanged", "float32", "unchanged"),
            ("fault_first_batch", "float32", "first_batch")):
        group = reference_group(cell.cfg, tr, s, reals[n:], cell.device,
                                prog["start"], precision, fault)
        out[name] = readings(_with_group(singles.get(name, prog), group))
    return out
