"""qkv_attention_roofline.train: % of roofline of B1, B2 and B3 (``csrc/qkv_attention.cu``, ``csrc/qkv_attention_bwd.cu``): the summed bound of the qkv-attention calls that
the window's units need, from their shapes (``lib/work.py``, the frozen
``qkv_work`` and ``bound_ms``), over the device time of the kernels whose
names match (the kernels layer)."""

from benchmark.lib.readers import roofline

PATTERNS = ("qkv_attention_",)


def read(ctx):
    return roofline(ctx, "qkv_attention", PATTERNS)
