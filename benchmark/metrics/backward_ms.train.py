"""backward_ms.train: device ms per train step inside the program's
``train.backward`` spans (``torch.autograd.grad`` of the loss: the model's
backward; the model step layer), from each span's pair of CUDA events,
summed over the window's spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train.backward")
