"""Host calls that queued work on the card, per train step of the traced
window: grouped dispatch and the graph replay make one of a few per
dispatch."""

LAYER = "trainer + grouped dispatch (training/trainer.py)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "train_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not cell.layer.get("steps"):
        return None
    return trace.host_launches / cell.layer["steps"]
