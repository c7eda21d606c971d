"""The whole served forward's share of the card's peak: G's model FLOPs
for the images of the traced window (counted from its shapes), over the
window's seconds times the dense TF32 rate."""

from portbench import yardstick

LAYER = "whole forward"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "serve_img_s"


def read(cell):
    if cell.layer.get("trace") is None or not cell.layer.get("flops"):
        return None
    return 100.0 * cell.layer["flops"] / (cell.layer["window_s"]
                                          * yardstick.PEAK_TF32_FLOP_S)
