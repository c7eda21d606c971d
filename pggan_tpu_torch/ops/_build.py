"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

The sources have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` into one shared library at first use, then loaded with
``ctypes``: seconds to build, where a PyTorch C++ extension that includes
torch's headers takes minutes. Each source compiles in its own ``nvcc``
process, all started together, and the objects are linked once. The
library's name carries a hash of the sources and flags, so an edit never
reuses a stale build. The build directory, ``pggan_tpu_torch/csrc/build``,
is not committed.

Every C entry point returns ``cudaGetLastError()`` after its launch; a
launch the card refuses (too much shared memory, too many threads) never
runs and would not show in ``torch.cuda.synchronize()``, so ``launch``
raises on any nonzero code. ``launch`` also counts each launch by kernel
name in ``LAUNCHES``, which is how a run shows that its main path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("conv3x3.cu", "conv3x3_dw.cu", "conv_chain.cu", "upsample2x.cu",
           "avgpool2x.cu")
HEADERS = ("epilogue.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, y, N, H, C, W, stream
    "pggan_upsample2x": (_P, _P, _I, _I, _I, _I, _P),
    # x, y, N, H, C, W, stream
    "pggan_avgpool2x": (_P, _P, _I, _I, _I, _I, _P),
    # x, w, b, y, r, N, H, C, W, K, KY, KT, epi, slope, eps, stream
    "pggan_conv3x3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _P),
    # x, ct, ws, dw, N, H, C, W, K, KT, rows_per_block, P, stream
    "pggan_conv3x3_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # x, w1, b1, w2, b2, y, N, H, C, W, K1, K2, K1T, K2T, pn, slope, eps,
    # stream
    "pggan_conv3x3_chain": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _P),
}

# launches per kernel name; chip_smoke.py zeroes it around the main path
LAUNCHES: collections.Counter = collections.Counter()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of pggan_tpu_torch "
                       "are built from csrc/ at first use and need the CUDA "
                       "toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    """nvcc each source to an object in parallel, then link one library.
    ptxas's register and shared-memory report goes to ``<source>.log``."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            log = open(BUILD_DIR / (name + ".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, log,
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        failed = []
        for name, _obj, log, proc in procs:
            if proc.wait() != 0:
                failed.append(name)
            log.close()
        if failed:
            texts = [(BUILD_DIR / (n + ".log")).read_text()[-4000:]
                     for n in failed]
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(texts))
        tmp_lib = Path(tmp) / out.name
        subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
                        *(str(o) for _n, o, _l, _p in procs)], check=True)
        os.replace(tmp_lib, out)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (under a file lock, so
    concurrent processes build it once)."""
    global _lib
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libpggan_kernels-{_digest()}.so"
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _compile(path)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.pggan_error_string.argtypes = [ctypes.c_int]
    lib.pggan_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` on the current stream (appended as the last
    argument), raise if the launch failed, and count it under ``name``."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.pggan_error_string(err).decode()})")
    LAUNCHES[name] += 1


def check_kernel_inputs(*tensors: torch.Tensor) -> None:
    """What every kernel takes: contiguous, all on one device, float32 (the
    CUDA route) or float32 / float64 (the CPU route, so that ``gradcheck``
    can hold the backward rules in float64). The wrappers check it on the
    CPU route too, so CPU runs hold callers to the kernels' contract."""
    dev = tensors[0].device
    dtypes = ((torch.float32, torch.float64) if dev.type == "cpu"
              else (torch.float32,))
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"kernel on {dev.type} takes "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"mixed dtypes {t.dtype} and {tensors[0].dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")


def forbid_grad(*tensors: torch.Tensor) -> None:
    """For a forward-only kernel (the conv chain): refuse to build a graph
    through it rather than silently detach."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "forward-only kernel called on tensors that require grad; run "
            "under torch.no_grad()")


def use_plain(x: torch.Tensor) -> bool:
    """A wrapper's route: the plain PyTorch version for a CPU tensor, the
    kernel for a CUDA tensor. Any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")
