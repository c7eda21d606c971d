"""The AdaIN epilogue kernel against its roofline: the least time the card
could take for the epilogue's calls each replay runs (their bytes counted
by ``portbench/style_work.py`` from the sizes of the calls the capture
recorded: each input read once, each output written once), over the
device time of the epilogue's kernels (names holding ``style_adain``) in
the traced window. A run without those calls reads nothing."""

LAYER = "StyleGAN epilogue and blur (ops/style.py, csrc/style.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    launches = cell.layer.get("style_launches")
    if trace is None or launches is None:
        return None
    seconds = sum(s for name, s in trace.by_name.items()
                  if "style_adain" in name)
    bound = launches.bound_s()
    if not seconds or bound is None:
        return None
    return 100.0 * bound * cell.layer["dispatches"] / seconds
