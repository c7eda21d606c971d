"""The share of the traced window in which no kernel or copy ran on the
card."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
