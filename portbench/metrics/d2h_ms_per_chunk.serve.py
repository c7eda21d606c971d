"""Device milliseconds of the copies of a served chunk's images to host
memory."""

LAYER = "sampling (sampling.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "serve_img_s"


def read(cell):
    trace = cell.layer.get("trace")
    if trace is None or not trace.by_group.get("device-to-host copy"):
        return None
    return 1e3 * trace.by_group["device-to-host copy"] / cell.layer["chunks"]
