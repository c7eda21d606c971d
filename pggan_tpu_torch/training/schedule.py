"""Pure nimg-driven schedules: progressive growth, per-depth minibatch/tick,
and the LR ramp. A copy of ``pggan_tpu/training/schedule.py`` (plain
Python), so that both packages run one schedule.

All schedule state is a function of ``cur_nimg`` alone — the reference's one
genuinely good recovery design (plugins.py:57-63, SURVEY.md §5): resume needs
only the image clock.
"""

from __future__ import annotations

import math

# Reference defaults (plugins.py:19-24)
MINIBATCH_DEFAULT = 16
MINIBATCH_OVERRIDES = {6: 14, 7: 6, 8: 3}
TICK_KIMG_DEFAULT = 20
TICK_KIMG_OVERRIDES = {3: 10, 4: 10, 5: 5, 6: 2, 7: 2, 8: 1}
LOD_TRAINING_NIMG = 100 * 1000
LOD_TRANSITION_NIMG = 100 * 1000


def depth_alpha_schedule(cur_nimg: int, max_depth: int,
                         lod_training_nimg: int = LOD_TRAINING_NIMG,
                         lod_transition_nimg: int = LOD_TRANSITION_NIMG):
    """nimg -> (depth, alpha), the progressive-growing control law.

    Each stage is ``lod_training_nimg`` images stable followed by
    ``lod_transition_nimg`` images fading in the next stage (reference
    plugins.py:59-63): alpha ramps 0 -> 1 during the transition of the
    *current* deepest stage and is 1.0 otherwise; depth is clamped to
    ``max_depth`` (after which alpha stays 1.0).
    """
    full_passes, rem = divmod(cur_nimg, lod_training_nimg + lod_transition_nimg)
    train_passes_rem, rem = divmod(rem, lod_training_nimg)
    depth = min(max_depth, full_passes + train_passes_rem)
    if train_passes_rem > 0 and full_passes + train_passes_rem == depth:
        alpha = rem / lod_transition_nimg
    else:
        alpha = 1.0
    return depth, alpha


def stable_nimg_horizon(cur_nimg: int, max_depth: int,
                        lod_training_nimg: int = LOD_TRAINING_NIMG,
                        lod_transition_nimg: int = LOD_TRANSITION_NIMG) -> float:
    """How many images from ``cur_nimg`` the schedule output stays constant.

    Returns N such that ``depth_alpha_schedule(n)`` is identical for every
    ``n`` in ``[cur_nimg, cur_nimg + N)`` — ``math.inf`` once the terminal
    stable phase is reached (depth clamped at ``max_depth``, last fade done).
    0 during a fade (alpha changes every image). The Trainer uses this to
    bound how many steps may share one compiled dispatch
    (``steps_per_dispatch``) without deviating from the per-step control law.
    """
    period = lod_training_nimg + lod_transition_nimg
    full_passes, rem1 = divmod(cur_nimg, period)
    if full_passes >= max_depth:
        # depth clamped at max_depth and its fade is behind us: both the
        # "training" and "transition" windows of every later period yield
        # (max_depth, 1.0) — stable forever
        return math.inf
    if rem1 >= lod_training_nimg:
        return 0  # inside a transition: alpha moves every image
    return lod_training_nimg - rem1


def fade_nimg_horizon(cur_nimg: int, max_depth: int,
                      lod_training_nimg: int = LOD_TRAINING_NIMG,
                      lod_transition_nimg: int = LOD_TRANSITION_NIMG) -> int:
    """Images from ``cur_nimg`` until the current fade's alpha reaches 1.0.

    Inside a transition window (``depth_alpha_schedule`` yielding alpha < 1),
    depth is constant and alpha is strictly below 1 for every nimg in
    ``[cur_nimg, cur_nimg + N)`` where N is the returned horizon — the dual
    of ``stable_nimg_horizon`` that lets the Trainer group fade steps into
    one dispatch with EXACT per-step alphas (steps.py group_step_fn takes
    alpha as a per-step vector). Returns 0 when not inside a fade (stable
    phase, or depth clamped at ``max_depth`` so alpha pins to 1.0).
    """
    period = lod_training_nimg + lod_transition_nimg
    full_passes, rem1 = divmod(cur_nimg, period)
    if full_passes + 1 > max_depth or rem1 < lod_training_nimg:
        return 0
    return period - rem1


def minibatch_for_depth(depth: int, default: int = MINIBATCH_DEFAULT,
                        overrides: dict | None = None) -> int:
    overrides = MINIBATCH_OVERRIDES if overrides is None else overrides
    return overrides.get(depth, default)


def tick_kimg_for_depth(depth: int, default: int = TICK_KIMG_DEFAULT,
                        overrides: dict | None = None) -> int:
    overrides = TICK_KIMG_OVERRIDES if overrides is None else overrides
    return overrides.get(depth, default)


def lr_rampup(cur_nimg: int, rampup_kimg: float = 40.0) -> float:
    """Gaussian LR ramp ``exp(-5 p^2)`` over the first ``rampup_kimg`` kimg
    (reference train.py:151-156)."""
    if rampup_kimg <= 0 or cur_nimg >= rampup_kimg * 1000:
        return 1.0
    p = max(0.0, 1.0 - cur_nimg / (rampup_kimg * 1000))
    return math.exp(-5.0 * p * p)


def lod_value(depth: int, alpha: float, max_lod: float | None,
              depth_offset: int | None) -> float:
    """Karras-parity ``lod`` logging value (reference plugins.py:51-55)."""
    if max_lod is None or depth_offset is None:
        return -1.0
    return max_lod - depth_offset - depth - alpha + 1
