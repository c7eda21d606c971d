"""The numbers that decide ``correct``, each a gap between what the program
produced and what the plain reference works out again from the same
inputs, and the printing of each beside its limit.

A gap of norms is taken leaf by leaf (the gap between the program's norm
of a parameter tensor and the reference's), as a share of the reference's
norm of that leaf or of the median leaf of its model, whichever is
larger, since some gradients are all but zero; the worst leaf is the
number.
"""

from __future__ import annotations

import json
import math
import statistics
import sys

import numpy as np
import torch

LOSSES = ("G_loss", "D_loss", "D_real", "D_fake")
# the losses a step takes before it updates anything: G's loss is taken
# through D after D's Adam step, whose first, sign-like update flips with
# the rounding of D's gradient
BEFORE_UPDATE = ("D_loss", "D_real", "D_fake")
# a leaf whose gradient the reference puts under this share of the median
# leaf's moves by round-off alone under Adam: it is left out of the change
NOUGHT = 1e-3
FAIL = 1e300  # the reading of a comparison that found nothing to compare
# the precision the reference computes in: the program's float32 rounds
# as widely as the reference's own float32 does (PERF.md)
REFERENCE = "float64"


def norms(tensors: dict) -> dict:
    """The 2-norm of each tensor, in float64, as a host float."""
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def medians(ref: dict) -> dict:
    """The median nonzero norm of each model's leaves (``G.`` / ``D.``)."""
    out = {}
    for model in ("G.", "D."):
        vals = [v for k, v in ref.items() if k.startswith(model) and v > 0]
        out[model] = statistics.median(vals) if vals else 0.0
    return out


def leaf_gaps(prog: dict, ref: dict, keys=None) -> list:
    """|prog - ref| / max(ref, the model's median) of each leaf."""
    med = medians(ref)
    scales = {k: max(ref[k], med[k[:2]]) for k in
              (ref if keys is None else keys)}
    return [abs(prog[k] - ref[k]) / s for k, s in scales.items() if s > 0]


def leaf_gap(prog: dict, ref: dict, keys=None) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref, keys), default=0.0)


def median_leaf_gap(prog: dict, ref: dict, keys=None) -> float:
    """The median leaf's gap: steady from seed to seed where the worst
    leaf's follows the noise of one leaf."""
    gaps = leaf_gaps(prog, ref, keys)
    return statistics.median(gaps) if gaps else FAIL


def moved(ref_grad_norms: list) -> list:
    """Leaves whose reference gradient, at its largest over the steps, is
    at least ``NOUGHT`` of the median leaf's."""
    peak = {k: max(step[k] for step in ref_grad_norms)
            for k in ref_grad_norms[0]}
    med = medians(peak)
    return [k for k, v in peak.items() if v > 0 and v >= NOUGHT * med[k[:2]]]


def loss_gap(prog: list, ref: list, names=LOSSES) -> float:
    """max over the losses ``names`` of the largest gap over the steps, as
    a share of that loss's mean magnitude over the steps."""
    worst = 0.0
    for name in names:
        scale = statistics.fmean(abs(r[name]) for r in ref)
        gap = max(abs(p[name] - r[name]) for p, r in zip(prog, ref))
        worst = max(worst, gap / scale if scale > 0 else FAIL)
    return worst


def identify_rows(rows: np.ndarray, items: np.ndarray, fade_nimg: int,
                  range_in=(0, 255), range_out=(-1, 1)) -> tuple:
    """For each prepared row (N, H, W, C), the item it was made from and
    the fade's alpha it was blended at (a whole number of images over
    ``fade_nimg``), fitted on the first two image rows; (-1, nan) where no
    item fits."""
    scale = (range_out[1] - range_out[0]) / (range_in[1] - range_in[0])
    strip = items[:, :2].astype(np.float64)  # (I, 2, W, C)
    n, _, w, c = strip.shape
    t = strip.reshape(n, 1, 2, w // 2, 2, c).mean(axis=(2, 4))
    t = t.repeat(2, axis=2).repeat(2, axis=1).reshape(n, -1)
    x = strip.reshape(n, -1)
    out = []
    for row in rows:
        v = (row[:2].astype(np.float64).reshape(-1) - range_out[0]) / scale \
            + range_in[0]
        d, e = x - t, v[None] - t
        den = (d * d).sum(1)
        a = np.where(den > 0, (e * d).sum(1) / np.maximum(den, 1e-30), 1.0)
        res = np.abs(e - a[:, None] * d).max(1)
        i = int(np.argmin(res))
        if res[i] > 0.01:
            out.append((-1, float("nan")))
        else:
            out.append((i, round(a[i] * fade_nimg) / fade_nimg))
    return out


def finite(value: float) -> float:
    """A reading as a number: one that is not finite reads as ``FAIL``."""
    return float(value) if math.isfinite(value) else FAIL


def report(checks: list) -> bool:
    """Print each check beside its limit on standard error; True where
    every value is at or under its limit."""
    ok = True
    for name, value, limit in checks:
        value = finite(value)
        good = value <= limit
        ok = ok and good
        print(f"check {name}: {value!r} (limit {limit!r})"
              f"{'' if good else '  FAILED'}", file=sys.stderr)
    return ok


def as_json(checks: list) -> dict:
    return {name: {"value": finite(value), "limit": float(limit)}
            for name, value, limit in checks}


def dumps(obj) -> str:
    return json.dumps(obj, allow_nan=False)
