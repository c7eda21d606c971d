"""The weight-gradient kernel (#4) against their roofline: the least time
the card could take for the calls each replay runs (their operations and
bytes counted from the sizes of the calls the capture recorded), over the
device time of those kernels in the traced window."""

LAYER = "conv kernels (ops/conv3x3.py, csrc/conv3x3.cu, csrc/conv3x3_dw.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"
GROUP, ENTRY = "conv3x3_dw kernel", ("pggan_conv3x3_dw",)


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not trace.by_group.get(GROUP):
        return None
    bound = cell.layer["launches"].bound_s(ENTRY)
    if bound is None:
        return None
    return 100.0 * bound * cell.layer["dispatches"] / trace.by_group[GROUP]
