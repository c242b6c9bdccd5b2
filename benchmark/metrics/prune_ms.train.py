"""prune_ms.train: device ms per train step inside the program's
``vit.prune`` spans (each pruning block's top-k, gathers and mask refine in
the forward, ``models/vit.py::Block``; their backward is
``backward_ms.train``'s; the pruning layer), from each span's pair of CUDA
events, summed over the window's spans (``lib/spans.py``)."""

from benchmark.lib.spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "vit.prune")
