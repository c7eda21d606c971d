"""Device milliseconds a train step spends in the StyleGAN kernels: every
traced kernel whose name holds ``style_`` (the AdaIN epilogue's four and
the blur, ``csrc/style.cu``), over the window's steps. A program or a
configuration without them reads nothing."""

LAYER = "StyleGAN epilogue and blur (ops/style.py, csrc/style.cu)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not cell.layer.get("steps"):
        return None
    seconds = sum(s for name, s in trace.by_name.items() if "style_" in name)
    if not seconds:
        return None
    return 1e3 * seconds / cell.layer["steps"]
