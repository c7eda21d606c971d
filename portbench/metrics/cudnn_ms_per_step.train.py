"""Device milliseconds a train step spends in cuDNN and GEMM kernels: the
low-resolution NCHW stages of G and D, outside the hand-written kernels."""

LAYER = "low-res NCHW stages (ops/primitives.py, models, losses.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not trace.by_group.get("cuDNN / GEMM"):
        return None
    return 1e3 * trace.by_group["cuDNN / GEMM"] / cell.layer["steps"]
