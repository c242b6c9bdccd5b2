"""window_attention_roofline.pretrain: % of roofline of the decoder's
window attention, forward and backward (B6, ``csrc/window_attention_banded.cu``
at the AudioSet grid): the summed bound of the calls that the window's
steps need, from their shapes (``lib/work.py``, the frozen
``window_work`` and ``bound_ms``), over the device time of the kernels
whose names match (the kernels layer)."""

from benchmark.lib.readers import roofline

PATTERNS = ("window_attention_",)


def read(ctx):
    return roofline(ctx, "window_attention", PATTERNS)
