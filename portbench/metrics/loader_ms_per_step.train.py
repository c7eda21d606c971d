"""Host milliseconds of the loader's work a train step: the
``loader.batch`` spans of its worker threads (a batch's indices, its raw
pixels and its host prep), summed over the threads, in the traced window,
over the window's steps."""

LAYER = "loader and host prep (data/loader.py)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_img_s"
SPAN, PER = "loader.batch", "steps"


def read(cell):
    if cell.layer.get("trace") is None or not cell.layer.get(PER):
        return None
    try:
        from pggan_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program that records no spans
        return None
    found = span_totals().get(SPAN)
    if found is None:
        return None
    return 1e3 * found[1] / cell.layer[PER]
