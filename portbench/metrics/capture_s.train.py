"""Host seconds that make the cell's step key ready in set-up: the
warm-up (or eager first call) and the CUDA graph capture, as the program's
graphed step counts them."""

LAYER = "graphed step (training/steps.py)"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "setup_s"


def read(cell):
    c = cell.counters
    parts = [c.get("warm_s"), c.get("eager_s"), c.get("capture_s")]
    if c.get("capture_s") is None:
        return None
    return sum(p for p in parts if p is not None)
