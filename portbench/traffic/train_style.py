"""StyleGAN train traffic: the program's ``Trainer`` on its StyleGAN
generator (``pggan_tpu_torch/models/style.py``) and the Discriminator with
StyleGAN's options, resumed at the first image of a stage's fade, fed
synthetic reals through its threaded loader, dispatching
``steps_per_dispatch`` steps as one CUDA graph replay. Every G forward of
a step mixes styles and draws its noise images inside the graph.

It runs as ``train.py`` runs (that module's set-up, checked steps,
window and fields of ``cell.layer``, which the train metrics read) on
this configuration's models, weights (``portbench/reference/stylegan.py``
``layers``, every bias, noise strength, style bias and the constant
nonzero) and reference. ``cell.layer`` also gets ``style_launches``: the
epilogue kernel's calls the group's capture recorded
(``portbench/style_work.py``). The checks are ``train.py``'s, with the
reference's StyleGAN step, and ``w_avg_gap``: the tracked average of w
after the single steps and after the group, each against the reference's
(the gap's norm over the reference's), the worse of the two.

Parameters (the traffic file): ``train.py``'s.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import math
import time

import numpy as np
import torch

from portbench import check, inputs, style_work, tracing
from portbench.reference import pggan, stylegan
from portbench.traffic import train as base

END_TO_END = base.END_TO_END
W_AVG = stylegan.W_AVG


def weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter of ``stylegan.layers(cfg)``, float32 on ``device``:
    the normal weights from one draw, the uniform ones from another."""
    spec = stylegan.layers(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, (k, _) in spec if k == "normal")
    n_unif = sum(math.prod(s) for _, s, (k, _) in spec if k != "normal")
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for name, shape, (kind, scale) in spec:
        size = math.prod(shape)
        if kind == "normal":
            out[name] = normal[i:i + size].view(shape) * scale
            i += size
        else:
            out[name] = unif[j:j + size].view(shape) * scale
            j += size
    return out


def models(cfg: dict, device):
    """The program's G and D of the configuration."""
    from pggan_tpu_torch.models import Discriminator
    from pggan_tpu_torch.models.style import StyleGenerator
    shape = (1, cfg["num_channels"], cfg["resolution"], cfg["resolution"])
    with torch.device(device):  # init draws on the device, then replaced
        init = torch.Generator(device=device)
        G = StyleGenerator(
            shape, fmap_base=cfg["fmap_base"], fmap_decay=cfg["fmap_decay"],
            fmap_max=cfg["fmap_max"], latent_size=cfg["latent_size"],
            w_dim=cfg["w_dim"], mapping_layers=cfg["mapping_layers"],
            mapping_lrmul=cfg["mapping_lrmul"],
            w_avg_beta=cfg["w_avg_beta"],
            style_mixing_prob=cfg["style_mixing_prob"],
            truncation_psi=cfg["truncation_psi"],
            truncation_cutoff=cfg["truncation_cutoff"], generator=init)
        D = Discriminator(
            shape, fmap_base=cfg["fmap_base"], fmap_decay=cfg["fmap_decay"],
            fmap_max=cfg["fmap_max"], blur=True,
            mbstd_group_size=cfg["mbstd_group_size"], equalized_dense=True,
            generator=init)
    return G, D


def _program(cfg: dict, tr: dict, s: dict, device, rows: list, log):
    """``train._program`` on this configuration's models and weights: the
    trainer as the train CLI builds it, on the benchmark's reals."""
    from pggan_tpu_torch.data.datasets import DepthDataset
    from pggan_tpu_torch.data.loader import DataIterator
    from pggan_tpu_torch.training.plugins import (AbsoluteTimeMonitor,
                                                  DepthManager,
                                                  EfficientLossMonitor,
                                                  LRScheduler, Plugin)
    from pggan_tpu_torch.training.state import init_state
    from pggan_tpu_torch.training.steps import TrainStepBuilder
    from pggan_tpu_torch.training.trainer import Trainer
    from pggan_tpu_torch.utils.misc import random_latents

    G, D = models(cfg, device)
    log("models built")
    w = weights(cfg, s["weights"], device)
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
        return base._Recorder(DataIterator(data, minibatch,
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
        """The losses of the set-up's dispatches, one a step."""

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
        lod_training_nimg=cfg["lod_training_kimg"] * 1000,
        lod_transition_nimg=cfg["lod_transition_kimg"] * 1000,
        tick_kimg_default=20, tick_kimg_overrides={
            tr["depth"]: tr["tick_kimg"]}, max_lod=G.R, depth_offset=2))
    for i, name in enumerate(check.LOSSES):
        trainer.register_plugin(EfficientLossMonitor(i, name))
    trainer.register_plugin(AbsoluteTimeMonitor(0))
    trainer.register_plugin(LRScheduler(cfg["lr"], cfg["lr"],
                                        cfg["lr_rampup_kimg"]))
    trainer.register_plugin(Losses())
    if (trainer.depth, trainer.alpha, trainer.minibatch_size) != \
            (tr["depth"], 0.0, tr["batch"]):
        raise RuntimeError(
            f"the trainer stands at depth {trainer.depth}, alpha "
            f"{trainer.alpha}, minibatch {trainer.minibatch_size}; the "
            f"traffic wants depth {tr['depth']}, alpha 0, minibatch "
            f"{tr['batch']}")
    return trainer, w, held, losses


def _buffer(state) -> torch.Tensor:
    return state.G.w_avg.detach().to("cpu", copy=True)


def run(cell) -> None:
    """One run of the cell; fills ``cell.result`` (``train.run``'s order)."""
    cfg, tr, device = cell.cfg, cell.traffic, cell.device
    s = inputs.seeds(cell.seed)
    spd, batch, depth = tr["steps_per_dispatch"], tr["batch"], tr["depth"]
    n = tr["checked_steps"]
    rows = []
    launches = tracing.LaunchLog()
    styles = style_work.StyleLaunches()
    trainer, w, held, losses = _program(cfg, tr, s, device, rows, cell.log)
    cell.log("trainer built")
    builder, state = trainer.builder, trainer.state
    single, group = (depth, batch, True), (depth, batch, True, spd)
    builder.precompile(*single, state)
    with (launches.recording(graph=True) if cell.trace
          else contextlib.nullcontext()), styles.recording():
        builder.precompile(*single, state, group=spd)
    cell.log("step keys warmed and captured")
    prog = {}
    trainer.steps_per_dispatch = 1
    for k in range(n):
        base._dispatch(trainer)
        if k == 0:
            prog["grad"] = check.norms({
                **base._named(state.G, "G.", state.g_opt.mu),
                **base._named(state.D, "D.", state.d_opt.mu)})
    prog["change"] = base._change(base._params(state), w)
    del w
    prog["w_avg"] = _buffer(state)
    prog["start"] = base._snapshot(state)
    prog["start"]["w_avg"] = prog["w_avg"]
    trainer.steps_per_dispatch = spd
    base._dispatch(trainer)
    cell.sync()
    cell.log("checked steps dispatched")
    prog["group_change"] = base._change(base._params(state),
                                        prog["start"]["params"])
    prog["group_w_avg"] = _buffer(state)
    steps = base._per_step(losses)
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
                base._dispatch(trainer)
        window = traced["trace"].window_s
    else:
        ahead = collections.deque()
        while True:
            base._dispatch(trainer)
            if time.perf_counter() - t0 >= cell.seconds:
                break
            if device.type == "cuda":
                ahead.append(torch.cuda.Event())
                ahead[-1].record()
                if len(ahead) > base.AHEAD:
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
    cell.layer = dict(steps=steps, dispatches=steps / spd, launches=launches,
                      style_launches=styles,
                      flops=stylegan.step_flops(cfg, depth, batch, True,
                                                base.hyper(cfg)) * steps,
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


def _optimizers(cfg: dict, p: dict):
    b1, b2 = cfg["adam_betas"]
    return [pggan.Adam({k: p[k] for k in stylegan.trainable(p, m)}, b1, b2,
                       cfg["adam_eps"]) for m in "DG"]


def reference(cfg: dict, tr: dict, s: dict, reals: list, device,
              precision: str = check.REFERENCE,
              half_batch: bool = False) -> dict:
    """``train.reference`` for StyleGAN: the checked single steps from the
    seed's weights (w_avg from 0, as the program's buffer starts), with
    the tracked average after them."""
    net = stylegan.Net(cfg, precision)
    base._precision(precision)
    try:
        p0 = {k: v.to(net.dtype) for k, v in
              weights(cfg, s["weights"], device).items()}
        p = {k: v.clone() for k, v in p0.items()}
        p[W_AVG] = torch.zeros(cfg["w_dim"], dtype=net.dtype, device=device)
        opt_d, opt_g = _optimizers(cfg, p)
        gen = torch.Generator(device=device).manual_seed(s["state"])
        out, grad = [], None
        for k in range(tr["checked_steps"]):
            noise = stylegan.draws(gen, tr["batch"], cfg, tr["depth"],
                                   net.dtype)
            x = torch.from_numpy(reals[k]).to(device, net.dtype)
            step = stylegan.train_step(net, p, opt_d, opt_g, x, noise,
                                       tr["depth"], base._alpha(tr, k), True,
                                       cfg["lr"], cfg["lr"], base.hyper(cfg),
                                       half_batch)
            grads = step.pop("grads")
            if grad is None:
                grad = check.norms(grads)
            out.append({n: float(v) for n, v in step.items()})
        return {"losses": out, "grad": grad,
                "change": check.norms({k: p[k] - p0[k] for k in p0}),
                "w_avg": p[W_AVG].detach().cpu()}
    finally:
        pggan.full_precision()


def reference_group(cfg: dict, tr: dict, s: dict, reals: list, device,
                    start: dict, precision: str = check.REFERENCE,
                    fault: str | None = None) -> dict:
    """``train.reference_group`` for StyleGAN, from the program's state
    after the single steps, w_avg included."""
    net = stylegan.Net(cfg, precision)
    base._precision(precision)
    try:
        p = {k: v.to(device, net.dtype, copy=True)
             for k, v in start["params"].items()}
        p[W_AVG] = start["w_avg"].to(device, net.dtype, copy=True)
        p0 = {k: v.clone() for k, v in p.items() if k != W_AVG}
        opt_d, opt_g = _optimizers(cfg, p)
        for opt, model in ((opt_d, "D"), (opt_g, "G")):
            opt.t = start["count"][model]
            opt.nu = {k: start["nu"][k].to(device, net.dtype, copy=True)
                      for k in opt.nu}
        gen = torch.Generator(device=device).manual_seed(s["state"])
        n = tr["checked_steps"]
        for _ in range(n):  # the single steps' draws
            stylegan.draws(gen, tr["batch"], cfg, tr["depth"], net.dtype)
        lr = 0.0 if fault == "unchanged" else cfg["lr"]
        out = []
        for j, x in enumerate(reals):
            noise = stylegan.draws(gen, tr["batch"], cfg, tr["depth"],
                                   net.dtype)
            x = reals[0] if fault == "first_batch" else x
            step = stylegan.train_step(
                net, p, opt_d, opt_g,
                torch.from_numpy(x).to(device, net.dtype), noise,
                tr["depth"], base._alpha(tr, n + j), True, lr, lr,
                base.hyper(cfg), fault == "half_batch")
            step.pop("grads")
            out.append({k: float(v) for k, v in step.items()})
        return {"losses": out,
                "change": check.norms({k: p[k] - p0[k] for k in p0}),
                "w_avg": p[W_AVG].detach().cpu()}
    finally:
        pggan.full_precision()


def _w_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    scale = float(torch.linalg.vector_norm(b))
    gap = float(torch.linalg.vector_norm(a - b))
    return gap / scale if scale > 0 else check.FAIL


def _w_avg_gap(side: dict, ref: dict) -> float:
    return max(_w_gap(side["w_avg"], ref["w_avg"]),
               _w_gap(side["group_w_avg"], ref["group_w_avg"]))


def _with_group(side: dict, group: dict) -> dict:
    return dict(base._with_group(side, group), group_w_avg=group["w_avg"])


def compare(cell, prog: dict, held: np.ndarray, s: dict) -> list:
    """``train.compare``'s checks on this configuration's reference, and
    ``w_avg_gap``."""
    tr, limits = cell.traffic, cell.limits
    n = tr["checked_steps"]
    names = ("rows_gap",) + base.NAMES + ("w_avg_gap",)
    found = check.identify_rows(
        prog["rows"].reshape((-1,) + prog["rows"].shape[2:]), held,
        tr["fade_nimg"])
    if any(i < 0 for i, _ in found):
        return [(name, check.FAIL, limits[name]) for name in names]
    reals = list(np.concatenate([pggan.prep_rows(held[i:i + 1], a)
                                 for i, a in found])
                 .reshape(prog["rows"].shape))
    rows_gap = float(np.abs(np.stack(reals) - prog["rows"]).max())
    ref = _with_group(
        reference(cell.cfg, tr, s, reals[:n], cell.device),
        reference_group(cell.cfg, tr, s, reals[n:], cell.device,
                        prog["start"]))
    keep = check.moved([ref["grad"]])
    gaps = base._gaps(prog, ref, keep)
    gaps["w_avg_gap"] = _w_avg_gap(prog, ref)
    if cell.study:
        cell.study_readings = study(cell, prog, ref, reals, s, keep)
    return [("rows_gap", rows_gap, limits["rows_gap"])] + [
        (name, gaps[name], limits[name]) for name in names[1:]]


def study(cell, prog, ref, reals, s, keep) -> dict:
    """``train.study``'s readings on this reference, and ``w_avg_gap``:
    the program, the float32 reference, the control (TF32) and the planted
    faults, each against the float64 reference."""
    tr, n = cell.traffic, cell.traffic["checked_steps"]

    def readings(side):
        out = base._gaps(side, ref, keep)
        out["w_avg_gap"] = _w_avg_gap(side, ref)
        out["loss_steps_gap"] = check.loss_gap(side["losses"], ref["losses"])
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
            ("fault_unchanged", "float32", "unchanged")):
        group = reference_group(cell.cfg, tr, s, reals[n:], cell.device,
                                prog["start"], precision, fault)
        side = singles.get(name, prog)
        out[name] = readings(_with_group(side, group))
    return out
