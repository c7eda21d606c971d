"""pggan_tpu_torch: the PyTorch and CUDA port of ``pggan_tpu`` for an
NVIDIA H100.

It imports torch and numpy, never JAX or ``pggan_tpu``. The module layout
mirrors ``pggan_tpu`` so that each module's counterpart is easy to find.
Every Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``); each has a
plain PyTorch version beside it that CPU tensors take. This slice ports the
serving path: snapshot -> Generator -> ``python -m
pggan_tpu_torch.cli.generate``.
"""

__version__ = "0.1.0"

from pggan_tpu_torch.checkpoint import load_snapshot, save_snapshot
from pggan_tpu_torch.models.generator import Generator

__all__ = ["Generator", "load_snapshot", "save_snapshot", "__version__"]
