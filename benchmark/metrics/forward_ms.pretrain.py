"""forward_ms.pretrain: device ms per pretrain step inside the program's
``pretrain.forward`` spans (the MAE's forward and loss,
``engine/pretrain.py::make_mae_train_step``; the model step layer), from
each span's pair of CUDA events, summed over the window's spans
(``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "pretrain.forward")
