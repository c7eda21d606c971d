"""The share of the float32 3x3 padding-1 convs' operations of the NCHW
stages (forward, input and weight gradients) that the wide-channel kernel
pair took, against cuDNN: the program's counter ``ops/wide_conv.py``
``FLOPS``, filled where the route is chosen (set-up, checked steps and
captures; a replay runs without a call). A program without the kernel
pair reads nothing."""

LAYER = "low-res NCHW stages (ops/primitives.py, models, losses.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_img_s"


def read(cell):
    if cell.layer.get("trace") is None:
        return None
    try:
        from pggan_tpu_torch.ops.wide_conv import kernel_share
    except ImportError:  # a program without the kernel pair
        return None
    return kernel_share()
