"""ctypes binding for the host-prep library ``csrc/host_prep.cpp``: the
counterpart of ``pggan_tpu/data/native.py``.

The library is built at first use with ``c++ -O3 -fPIC -fopenmp
-ffp-contract=off -shared`` into the kernels' build directory
(``ops/_build.build_dir()``), under a file lock and by an atomic rename,
so concurrent processes build it once and never load a half-written file.
A failed build raises: there is no numpy fallback and no switch. The numpy
versions, ``datasets.box_downsample`` and ``datasets.prep_batch_f32``, are
the plain versions the library is held against, bit for bit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from pggan_tpu_torch.ops import _build

SOURCE = _build.CSRC / "host_prep.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-ffp-contract=off", "-shared")

_lib = None
_lib_lock = threading.Lock()  # the loader's threads may load it at once


def _compile(out) -> None:
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("c++ not found: pggan_tpu_torch builds its host "
                           "library from csrc/host_prep.cpp at first use")
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_lib = os.path.join(tmp, out.name)
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_lib, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"c++ failed for {SOURCE.name}:\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp_lib, out)


def library() -> ctypes.CDLL:
    """The host library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        build = _build.build_dir()
        build.mkdir(parents=True, exist_ok=True)
        path = build / f"libpggan_host-{h.hexdigest()[:16]}.so"
        with open(build / "host_lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                _compile(path)
        lib = ctypes.CDLL(str(path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.box_downsample_u8.argtypes = [P, I, I, I, I, P]
        lib.box_downsample_u8.restype = None
        lib.prep_batch_f32.argtypes = [P, I, I, I, I, I, F, F, F, F, P]
        lib.prep_batch_f32.restype = None
        _lib = lib
        return lib


def _contiguous_u8(x: np.ndarray, ndim: int) -> np.ndarray:
    if x.dtype != np.uint8 or x.ndim != ndim:
        raise TypeError(f"takes a {ndim}-d uint8 array, got {x.ndim}-d "
                        f"{x.dtype}")
    return np.ascontiguousarray(x)


def box_downsample_u8(img: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downsample of an HWC uint8 image, rounded half to even
    and clipped: ``np.uint8(np.clip(np.round(box_downsample(img, factor)),
    0, 255))``."""
    img = _contiguous_u8(img, 3)
    h, w, c = img.shape
    if h % factor or w % factor:
        raise ValueError(f"{h}x{w} image does not divide by {factor}")
    out = np.empty((h // factor, w // factor, c), np.uint8)
    library().box_downsample_u8(img.ctypes.data, h, w, c, factor,
                                out.ctypes.data)
    return out


def prep_batch_f32(batch_u8: np.ndarray, alpha: float,
                   range_in=(0, 255), range_out=(-1, 1)) -> np.ndarray:
    """Fade + dynamic-range remap of a uint8 NHWC batch -> float32, equal
    to ``datasets.prep_batch_f32`` (reference dataset.py:60-67). Each
    constant is rounded to float32 as numpy rounds a Python scalar it
    multiplies a float32 array by."""
    batch_u8 = _contiguous_u8(batch_u8, 4)
    n, h, w, c = batch_u8.shape
    min_in, max_in = range_in
    min_out, max_out = range_out
    scale = (max_out - min_out) / (max_in - min_in)
    fade = alpha < 1.0
    if fade and (h % 2 or w % 2):
        raise ValueError(f"a fade needs even sides, got {h}x{w}")
    out = np.empty((n, h, w, c), np.float32)
    library().prep_batch_f32(
        batch_u8.ctypes.data, n, h, w, c, int(fade),
        float(np.float32(1.0 - alpha)), float(np.float32(min_in)),
        float(np.float32(scale)), float(np.float32(min_out)),
        out.ctypes.data)
    return out
