"""Quality evaluation entry point: Sliced Wasserstein Distance between a
generator snapshot's samples and the training distribution, the
counterpart of ``pggan_tpu/cli/eval.py``:

    python -m pggan_tpu_torch.cli.eval \\
        --generator_path results/001-exp/network-snapshot-generator-003000.dat \\
        --dataset_class DefaultImageFolderDataset \\
        --DefaultImageFolderDataset.dir_path datasets/images \\
        --num_samples 256

Reals are drawn from the dataset at the snapshot's own (depth, alpha), the
distribution the generator was being trained against, so mid-fade
snapshots are scored against mid-fade data. Prints one distance per
pyramid level (finest first, x1e3, lower is better) plus the average, and
optionally writes them as JSON. With ``--real_baseline True`` (default) a
second disjoint sample of reals is scored against the first: the
real-vs-real floor of the estimator at this sample size. ``--msssim``
adds the paper's mode-collapse statistic, the mean MS-SSIM of random
pairs of fakes beside that of reals. ``--run_dir`` scores every snapshot
of a run into ``eval_history.jsonl``, resuming an interrupted curve.

The flags are the JAX CLI's plus ``--device`` (default ``cuda``, which
raises without a card): the serve, the SWD and MS-SSIM run there, and a
dataset class with a ``device`` takes it unless ``--Cls.device`` is given.
"""

from __future__ import annotations

import glob
import json
import os
from argparse import ArgumentParser
from functools import partial

import numpy as np
import torch

import pggan_tpu_torch.data.datasets as dataset_module
from pggan_tpu_torch.checkpoint import (
    ema_twin,
    load_snapshot,
    resolve_generator_path,
    snapshot_kimg,
)
from pggan_tpu_torch.cli.generate import resolve_device
from pggan_tpu_torch.metrics.msssim import pairwise_msssim
from pggan_tpu_torch.metrics.swd import swd
from pggan_tpu_torch.sampling import disable_tf32, sample_images
from pggan_tpu_torch.utils.config import (
    add_class_args,
    generic_arg_parse,
    get_all_classes,
    get_structured_params,
    pass_device,
)
from pggan_tpu_torch.utils.misc import load_pkl

default_params = {
    "generator_path": "",   # a snapshot path, or 'latest' (see result_dir)
    "result_dir": "results",  # search root for --generator_path latest
    "run_dir": "",   # history mode: score EVERY snapshot in this run dir
    #               (ema twins preferred) -> eval_history.jsonl curve
    "load_dataset": "",
    "dataset_class": "",
    "num_samples": 256,
    "minibatch": 32,
    "nhoods_per_image": 128,
    "nhood_size": 7,
    "min_res": 16,
    "dir_repeats": 4,
    "dirs_per_repeat": 128,
    "random_seed": 0,
    "real_baseline": True,
    "msssim": True,
    "output_json": "",
    "device": "cuda",
}


def _build_dataset(params):
    """The train CLI's dataset construction (``--load_dataset`` or
    ``--dataset_class``)."""
    if params["load_dataset"]:
        return load_pkl(params["load_dataset"])
    if params["dataset_class"]:
        cls = getattr(dataset_module, params["dataset_class"], None)
        if cls is None:
            names = sorted(c.__name__ for c in get_all_classes(dataset_module))
            raise SystemExit(f"Unknown dataset_class "
                             f"{params['dataset_class']!r}; available: "
                             f"{', '.join(names)}")
        return cls(**pass_device(cls, params.get(params["dataset_class"], {}),
                                 params["device"]))
    raise SystemExit("One of either load_dataset (path to pkl) or "
                     "dataset_class needs to be specified.")


def _swd_kwargs(params):
    return dict(nhoods_per_image=params["nhoods_per_image"],
                nhood_size=params["nhood_size"],
                min_res=params["min_res"],
                dir_repeats=params["dir_repeats"],
                dirs_per_repeat=params["dirs_per_repeat"],
                minibatch=params["minibatch"],
                device=params["device"])


def _generator(seed: int) -> torch.Generator:
    """The metrics' draws: a host generator, so every device draws alike."""
    return torch.Generator().manual_seed(int(seed))


def _wants_msssim(params, images) -> bool:
    return params["msssim"] and min(images.shape[1], images.shape[2]) >= 11


def real_sample(dataset, depth, alpha, params) -> np.ndarray:
    """``num_samples`` reals at (depth, alpha) as (N, H, W, C) in [-1, 1],
    then as many again for the baseline: disjoint when the dataset is big
    enough (a shared image would bias the real-vs-real floor toward zero),
    with replacement otherwise."""
    num = params["num_samples"]
    dataset.model_depth = depth
    dataset.alpha = alpha
    rng = np.random.RandomState(params["random_seed"])
    draw = num * 2 if params["real_baseline"] else num
    if len(dataset) >= draw:
        idx = rng.permutation(len(dataset))[:draw]
    else:
        idx = rng.randint(0, len(dataset), size=draw)
    print(f"Collecting {draw} real images at depth {depth}...")
    return np.stack([dataset[i] for i in idx])


def _reals_and_floors(dataset, depth, alpha, params, cache=None):
    """Reals sample + estimator floors for one (depth, alpha) stage:
    ``(reals, swd_baseline_or_None, msssim_real_or_None)``.

    Everything here depends only on the stage and the seed, not on the
    snapshot, so history mode passes a cache dict: snapshots that share a
    stage would otherwise compute the same real-vs-real SWD again."""
    key = (int(depth), round(float(alpha), 6))
    if cache is not None and key in cache:
        return cache[key]
    num = params["num_samples"]
    all_reals = real_sample(dataset, depth, alpha, params)
    reals, reals_b = all_reals[:num], all_reals[num:]
    baseline = ms_real = None
    if params["real_baseline"]:
        baseline = swd(reals, reals_b, _generator(params["random_seed"]),
                       **_swd_kwargs(params))
    if _wants_msssim(params, reals):
        ms_real = pairwise_msssim(
            reals, _generator(params["random_seed"] + 1),
            minibatch=params["minibatch"], device=params["device"])
    out = (reals, baseline, ms_real)
    if cache is not None:
        cache[key] = out
    return out


def _score_snapshot(path, dataset, params, stage_cache=None):
    """Score one generator snapshot against ``dataset`` (set to the
    snapshot's own depth/alpha); returns ``(payload, results, baseline)``."""
    num = params["num_samples"]
    mb = params["minibatch"]
    G, meta = load_snapshot(path, device=params["device"])
    depth, alpha = meta["depth"], meta["alpha"]
    print(f"Snapshot: depth {depth}, alpha {alpha}, "
          f"latent {G.latent_size}")

    reals, baseline, ms_real = _reals_and_floors(
        dataset, depth, alpha, params, stage_cache)

    print(f"Generating {num} samples...")
    rng = np.random.RandomState(params["random_seed"] + 2)
    fakes = sample_images(G, depth, alpha, num, minibatch=mb, rng=rng)

    print("Scoring (SWD x1e3, lower is better)...")
    results = swd(reals, fakes, _generator(params["random_seed"]),
                  **_swd_kwargs(params))
    for k, v in results.items():
        label = f"{k}px" if k != "avg" else "avg"
        floor = f"   (real-vs-real floor {baseline[k]:8.2f})" \
            if baseline else ""
        print(f"  swd[{label:>6}] = {v:8.2f}{floor}")

    ms_fake = None
    if _wants_msssim(params, reals):
        # paper section 5: fake pairs much more alike than the reals' own
        # pairing means the generator emits near-duplicates
        ms_fake = pairwise_msssim(fakes, _generator(params["random_seed"] + 1),
                                  minibatch=mb, device=params["device"])
        print(f"  msssim[ fakes] = {ms_fake:8.4f}   "
              f"(real-pair baseline {ms_real:8.4f}; ~baseline = healthy, "
              f"~1.0 = mode collapse)")

    payload = {f"swd_{k}": v for k, v in results.items()}
    if baseline:
        payload.update({f"swd_baseline_{k}": v
                        for k, v in baseline.items()})
    if ms_fake is not None:
        payload.update(msssim_fakes=ms_fake, msssim_reals=ms_real)
    payload.update(generator_path=path, depth=depth, alpha=alpha,
                   num_samples=num,
                   # identity for history-mode resume: snapshots are named
                   # by kimg alike across runs, so the basename alone cannot
                   # tell the same snapshot from another run's
                   snapshot_bytes=os.path.getsize(path))
    return payload, results, baseline


def _run_snapshots(run_dir: str) -> list[str]:
    """Every generator snapshot of a run, kimg-ascending; where a kimg has a
    generator-ema twin, the smoothed snapshot is scored instead."""
    plain = sorted(
        (p for p in glob.glob(os.path.join(
            run_dir, "network-snapshot-generator-*.dat"))
         if "-generator-ema-" not in p), key=snapshot_kimg)
    return [ema_twin(p) or p for p in plain]


def _history(dataset, params):
    """Score every snapshot of ``--run_dir`` into one JSON line each (the
    metric-vs-kimg curve), keeping the rows of an earlier, interrupted pass."""
    snaps = _run_snapshots(params["run_dir"])
    if not snaps:
        raise SystemExit(f"--run_dir {params['run_dir']}: no "
                         f"generator snapshots found")
    num = params["num_samples"]
    out = params["output_json"] or os.path.join(
        params["run_dir"], "eval_history.jsonl")
    # Resume: keep the rows a prior pass wrote and skip their snapshots.
    # Keyed by basename (the same snapshot from another staging directory
    # still counts), guarded by the snapshot's byte size and the row's
    # num_samples: a reused --output_json from another run re-scores.
    rows = []
    done = {}
    if os.path.exists(out):
        with open(out) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        done = {os.path.basename(r["generator_path"]):
                r.get("snapshot_bytes")
                for r in rows if r.get("num_samples") == num}
        if done:
            print(f"Resuming: {len(done)} snapshots already scored in {out}")
    stage_cache = {}
    missing = object()
    for p in snaps:
        base = os.path.basename(p)
        prior = done.get(base, missing)
        if prior is not missing:
            if prior is None or prior == os.path.getsize(p):
                continue  # a row without a size, or the same file
            print(f"  re-scoring {base}: resumed row's snapshot size "
                  f"differs (row from a different run?)")
        print(f"\n=== {base} ===")
        try:
            payload, _, _ = _score_snapshot(p, dataset, params, stage_cache)
        except ValueError as e:
            if "min_res" not in str(e):
                raise
            # a progressive run's first snapshots (4-8 px) sit below the
            # protocol's coarsest level: skip them, not the whole curve
            print(f"  skipped (below SWD min_res): {e}")
            continue
        # a fresh score replaces any stale row of the same name
        rows = [r for r in rows
                if os.path.basename(r["generator_path"]) != base]
        rows.append(payload)
        with open(out + ".tmp", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        os.replace(out + ".tmp", out)
    print(f"\nWrote {len(rows)} rows to {out}")
    return rows


def evaluate(params):
    resolve_device(params["device"])
    disable_tf32()
    num = params["num_samples"]
    mb = params["minibatch"]
    if mb <= 0:
        raise SystemExit(f"--minibatch must be positive, got {mb}")
    if num % mb:
        # the JAX scorer streams fixed minibatch chunks through one
        # compiled program; the port keeps its flag contract
        raise SystemExit(f"num_samples ({num}) must be a multiple of "
                         f"minibatch ({mb}) — the SWD scorer streams "
                         f"fixed-size chunks")
    if params["min_res"] < params["nhood_size"]:
        # checked once here: in history mode the per-snapshot skip must
        # only ever see the resolution-too-small error
        raise SystemExit(
            f"--min_res ({params['min_res']}) must be >= --nhood_size "
            f"({params['nhood_size']}): the coarsest pyramid level must "
            f"fit at least one patch")

    dataset = _build_dataset(params)
    try:
        if params["run_dir"]:
            return _history(dataset, params)
        params["generator_path"] = resolve_generator_path(
            params["generator_path"], params["result_dir"])
        print(f"Loading {params['generator_path']}")
        payload, results, baseline = _score_snapshot(
            params["generator_path"], dataset, params)
        out = params["output_json"]
        if out:
            with open(out + ".tmp", "w") as f:
                json.dump(payload, f, indent=2)
            os.replace(out + ".tmp", out)
            print(f"Wrote {out}")
        return results, baseline
    finally:
        dataset.close()


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    flat_defaults = dict(default_params)
    for k in default_params:
        parser.add_argument(
            f"--{k}",
            type=partial(generic_arg_parse, hinttype=type(default_params[k])))
    add_class_args(parser, get_all_classes(dataset_module),
                   default_params=flat_defaults)
    parser.set_defaults(**flat_defaults)
    return parser


def cli_main(argv=None):
    params = get_structured_params(vars(build_parser().parse_args(argv)))
    return evaluate(params)


if __name__ == "__main__":
    cli_main()
