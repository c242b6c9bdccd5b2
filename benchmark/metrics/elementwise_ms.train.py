"""elementwise_ms.train: device ms per train step in PyTorch's own kernels
(elementwise, reductions, sorts, gathers, the foreach optimizer): the plain
ops layer, ``gelu_poly`` and the eager LayerNorm above all.  From the trace,
by kernel name."""

from benchmark.lib.readers import kernel_ms_per_unit

PATTERNS = ("at::native::", "at_cuda_detail::")


def read(ctx):
    return kernel_ms_per_unit(ctx, PATTERNS)
