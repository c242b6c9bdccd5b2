"""update_ms.pretrain: device ms per pretrain step inside the program's
``pretrain.update`` spans (the gradients' all-reduce where there are ranks,
AdamW and the loss sum; the model step layer), from each span's pair of CUDA
events, summed over the window's spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "pretrain.update")
