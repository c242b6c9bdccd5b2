"""mfu.serve: the window's model FLOPs (``lib/work.py``, from the shapes of
each request completed; a backward counts twice its forward) over the
window's seconds, as a % of the card's bf16 peak of 989 TFLOP/s (the model
step layer)."""

from benchmark.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
