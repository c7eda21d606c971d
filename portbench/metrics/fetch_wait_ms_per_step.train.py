"""Host milliseconds a train step waits on the loader: the trainer's
``trainer.fetch`` spans (its ``next`` calls on the data iterator) in the
traced window, over the window's steps."""

LAYER = "loader and host prep (data/loader.py)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_img_s"
SPAN, PER = "trainer.fetch", "steps"


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
