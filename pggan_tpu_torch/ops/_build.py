"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

The sources have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` into one shared library at first use, then loaded with
``ctypes``: seconds to build, where a PyTorch C++ extension that includes
torch's headers takes minutes. Each source compiles in its own ``nvcc``
process, all started together, and the objects are linked once. The
library's name carries a hash of the sources and flags, so an edit never
reuses a stale build. The build goes to ``pggan_tpu_torch/csrc/build``
(not committed) where the package directory is writable, and otherwise
(an installed package) to ``$PGGAN_TORCH_CACHE``, or
``~/.cache/pggan_tpu_torch`` when that is unset.

Every C entry point returns ``cudaGetLastError()`` after its launch; a
launch the card refuses (too much shared memory, too many threads) never
runs and would not show in ``torch.cuda.synchronize()``, so ``launch``
raises on any nonzero code. ``launch`` also counts each launch by kernel
name in ``LAUNCHES``, which is how a run shows that its main path went
through the kernels. A call made while the stream is being captured into
a CUDA graph only records the kernel, which then runs at each replay
without a call: it counts in ``CAPTURED`` instead.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("conv3x3.cu", "conv3x3_dw.cu", "conv_chain.cu", "upsample2x.cu",
           "avgpool2x.cu")
HEADERS = ("epilogue.cuh", "split_weights.cuh", "tf32_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, y, N, H, C, W, stream
    "pggan_upsample2x": (_P, _P, _I, _I, _I, _I, _P),
    # x, y, N, H, C, W, stream
    "pggan_avgpool2x": (_P, _P, _I, _I, _I, _I, _P),
    # x, w, b, y, r, ws, N, H, C, W, K, KT, epi, slope, eps, stream
    "pggan_conv3x3": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _P),
    # x, ct, ws, dw, N, H, C, W, K, KT, rows_per_block, row_chunks,
    # col_tiles, stream
    "pggan_conv3x3_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    # x, w1, b1, w2, b2, y, ws, N, H, C, W, K1, K2, K1T, K2T, pn, slope,
    # eps, stream
    "pggan_conv3x3_chain": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _F, _F, _P),
}

# launches per kernel name; chip_smoke.py zeroes it around the main path
LAUNCHES: collections.Counter = collections.Counter()
# kernels recorded into CUDA graphs per kernel name (run at each replay)
CAPTURED: collections.Counter = collections.Counter()
_lib = None
# each C entry point's ctypes function, its argtypes set, on first launch
_ENTRY: dict = {}


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


def build_dir() -> Path:
    """Where the library is built: ``csrc/build`` beside the sources when
    the package directory can be written, else a per-user cache."""
    local = CSRC / "build"
    if os.access(local if local.exists() else CSRC, os.W_OK):
        return local
    return Path(os.environ.get("PGGAN_TORCH_CACHE")
                or Path.home() / ".cache" / "pggan_tpu_torch")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    """nvcc each source to an object in parallel, then link one library
    beside ``out``. ptxas's register and shared-memory report goes to
    ``<source>.log`` there."""
    nvcc = _nvcc()
    build = out.parent
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            log = open(build / (name + ".log"), "w")
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
            texts = [(build / (n + ".log")).read_text()[-4000:]
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
    build = build_dir()
    build.mkdir(parents=True, exist_ok=True)
    path = build / f"libpggan_kernels-{_digest()}.so"
    with open(build / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _compile(path)
    lib = ctypes.CDLL(str(path))
    lib.pggan_error_string.argtypes = [ctypes.c_int]
    lib.pggan_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _demangle(symbol: str) -> str:
    """``_ZN<ns><name>I<args>E...`` -> ``name<args>`` for the kernels here
    (namespaces, integer and bool template arguments)."""
    rest, names = symbol[3:], []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    targs = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    args = re.findall(r"L[ib](\d+)E", targs.group(1)) if targs else []
    return (names[-1] if names else symbol) + (
        f"<{','.join(args)}>" if args else "")


def ptxas_report() -> dict:
    """Registers a thread and bytes spilled for each kernel of the built
    library, from ptxas's report in the build logs: {source: {kernel:
    (registers, spill store bytes)}}."""
    report = {}
    for name in SOURCES:
        text = (build_dir() / (name + ".log")).read_text()
        entries = re.split(r"Compiling entry function '", text)[1:]
        report[name] = {}
        for entry in entries:
            symbol = entry.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            report[name][_demangle(symbol)] = (
                int(regs.group(1)) if regs else None,
                int(spill.group(1)) if spill else 0)
    return report


def _entry(fn: str):
    """C entry point ``fn`` of the library, resolved and typed once."""
    f = getattr(library(), fn)
    f.argtypes = list(_SIGNATURES[fn])
    f.restype = ctypes.c_int
    _ENTRY[fn] = f
    return f


def _current_stream() -> int:
    """The current CUDA stream's handle, from the raw getter: building the
    ``torch.cuda.Stream`` object of ``current_stream()`` costs the host
    more than many of the kernels take on the card."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _capturing() -> bool:
    """Whether the current stream is being captured into a CUDA graph."""
    return torch._C._cuda_isCurrentStreamCapturing()


def launch(name: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` on the current stream (appended as the last
    argument), raise if the launch failed, and count it under ``name``
    (in ``CAPTURED`` while a graph capture records it).
    The ctypes function is looked up and typed on the first call only, so
    a launch costs one dictionary lookup and the foreign call on the host."""
    f = _ENTRY.get(fn) or _entry(fn)
    err = f(*args, _current_stream())
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({library().pggan_error_string(err).decode()})")
    (CAPTURED if _capturing() else LAUNCHES)[name] += 1


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
