"""Device milliseconds a train step spends in the wide-channel conv
kernels of the NCHW stages: every traced kernel whose name holds
``wide_conv``, over the window's steps."""

LAYER = "low-res NCHW stages (ops/primitives.py, models, losses.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not cell.layer.get("steps"):
        return None
    seconds = sum(s for name, s in trace.by_name.items()
                  if "wide_conv" in name)
    if not seconds:
        return None
    return 1e3 * seconds / cell.layer["steps"]
