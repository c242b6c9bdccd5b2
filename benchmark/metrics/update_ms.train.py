"""update_ms.train: device ms per train step inside the program's
``train.update`` spans (the rest of ``TrainModule.train_step``: grad mean
and norm, accumulation, clipping, AdamW, zero_grad, the metric sums; the
model step layer), from each span's pair of CUDA events, summed over the
window's spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train.update")
