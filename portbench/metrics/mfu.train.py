"""The whole train step's share of the card's peak: the model FLOPs of
the steps in the traced window (the plain reference's step counted from
its shapes: convolutions and matrix products, forward, backward and the
gradient penalty's double backward), over the window's seconds times the
dense TF32 rate."""

from portbench import yardstick

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_img_s"


def read(cell):
    if cell.layer.get("trace") is None or not cell.layer.get("flops"):
        return None
    return 100.0 * cell.layer["flops"] / (cell.layer["window_s"]
                                          * yardstick.PEAK_TF32_FLOP_S)
