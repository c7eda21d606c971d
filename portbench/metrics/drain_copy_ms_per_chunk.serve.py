"""Host milliseconds sampling spends moving a served chunk out of its
pinned buffer: the ``sample.drain_copy`` spans (the copy into the
request's fresh result rows, their first touch included) in the traced
window, over its chunks."""

LAYER = "sampling (sampling.py)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "serve_img_s"
SPAN, PER = "sample.drain_copy", "chunks"


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
