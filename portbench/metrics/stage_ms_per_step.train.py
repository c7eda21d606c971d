"""Host milliseconds a train step spends staging its reals: the
trainer's ``trainer.stage`` spans (a pinned buffer from the pool or a new
one, the batches stacked into it, the copy to the card issued) in the
traced window, over the window's steps."""

LAYER = "pinned staging pool (training/trainer.py)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_img_s"
SPAN, PER = "trainer.stage", "steps"


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
