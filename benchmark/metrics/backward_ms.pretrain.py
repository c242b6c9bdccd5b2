"""backward_ms.pretrain: device ms per pretrain step inside the program's
``pretrain.backward`` spans (zero_grad and the loss's backward; the model
step layer), from each span's pair of CUDA events, summed over the window's
spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "pretrain.backward")
