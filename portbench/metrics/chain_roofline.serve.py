"""The serve's fused conv-pair chain kernel (#7) against its roofline: the
least time the card could take for the chain calls of the traced window
(operations and bytes from the calls' sizes), over their device time."""

LAYER = "serve chain (ops/conv_chain.py, csrc/conv_chain.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_img_s"
GROUP, ENTRY = "chain kernel", ("pggan_conv3x3_chain",)


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not trace.by_group.get(GROUP):
        return None
    bound = cell.layer["launches"].bound_s(ENTRY)
    if bound is None:
        return None
    return 100.0 * bound / trace.by_group[GROUP]
