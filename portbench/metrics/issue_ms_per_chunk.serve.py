"""Host milliseconds sampling spends issuing a served chunk: the
``sample.issue`` spans (the latents drawn and padded, their upload, G's
forward issued) in the traced window, over its chunks."""

LAYER = "sampling (sampling.py)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "serve_img_s"
SPAN, PER = "sample.issue", "chunks"


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
