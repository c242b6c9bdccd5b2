"""prune_ms.serve: device ms per request inside the program's ``vit.prune``
spans (each pruning block's top-k and gathers in the static-pruned forward,
``models/vit.py::Block``; the pruning layer), from each span's pair of CUDA
events, summed over the window's spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "vit.prune")
