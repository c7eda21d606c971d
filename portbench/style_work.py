"""The bytes of the StyleGAN epilogue kernel's calls, counted from the
sizes of each launch (``csrc/style.cu``'s C entry points), and a recorder
of those launches beside ``tracing.LaunchLog``.

A call's bytes are the least its work allows: every input element read
once and every output element written once, in float32. Forward
(``pggan_style_adain``): x and the noise read, y written, with the
per-channel and per-sample vectors (strength, bias, style, the plane
statistics). Backward (``pggan_style_adain_bwd``): x, the noise and the
incoming gradient read, dx written, with the same vectors and the style
gradient. Its bound is those bytes over the card's memory rate.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import yardstick

# where N, C, H, W sit among an entry point's arguments (after the device,
# before the stream), and how many arguments it takes
ENTRY_DIMS = {
    # x, noise, strength, bias, style, y, stats, part, N, C, H, W, sN, sC,
    # sH, S, slope, eps
    "pggan_style_adain": (18, 8),
    # x, noise, strength, bias, style, stats, g, dx, dstyle, dsb, part, N,
    # C, H, W, sN, sC, sH, S, slope
    "pggan_style_adain_bwd": (20, 11),
}


def call_bytes(fn: str, args: tuple) -> int | None:
    """The least bytes of one launch of entry point ``fn``, or None for
    another entry point or arity."""
    entry = ENTRY_DIMS.get(fn)
    if entry is None or len(args) != entry[0]:
        return None
    n, c, h, w = args[entry[1]:entry[1] + 4]
    if not all(isinstance(v, int) and v > 0 for v in (n, c, h, w)):
        return None
    plane, vectors = n * c * h * w, 2 * c + 2 * n * c + 2 * n * c
    if fn == "pggan_style_adain":
        return 4 * (2 * plane + n * h * w + vectors)
    return 4 * (3 * plane + n * h * w + vectors + 2 * n * c)


class StyleLaunches:
    """The epilogue's launches recorded while a CUDA graph is captured
    (each replay then runs them), as their bytes."""

    def __init__(self):
        self.bytes = []

    @contextlib.contextmanager
    def recording(self):
        from pggan_tpu_torch.ops import _build
        orig = _build.launch

        def logged(name, fn, device, *args):
            if torch.cuda.is_current_stream_capturing():
                b = call_bytes(fn, args)
                if b is not None:
                    self.bytes.append(b)
            return orig(name, fn, device, *args)

        _build.launch = logged
        try:
            yield self
        finally:
            _build.launch = orig

    def bound_s(self) -> float | None:
        """The least seconds the recorded calls allow, or None."""
        if not self.bytes:
            return None
        return sum(self.bytes) / yardstick.PEAK_HBM_BYTES_S
