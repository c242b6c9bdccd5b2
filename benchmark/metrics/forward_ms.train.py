"""forward_ms.train: device ms per train step inside the program's
``train.forward`` spans (``TrainModule.loss_and_grads`` from the batch's
``as_tensor`` through the loss: preprocess, the model's forward, the loss;
the model step layer), from each span's pair of CUDA events, summed over the
window's spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "train.forward")
