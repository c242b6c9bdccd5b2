"""idle.train: % of the traced window in which no kernel, copy or set ran
on the device (1 - the union of the device intervals over the window; the
device layer)."""

from benchmark.lib.readers import idle


def read(ctx):
    return idle(ctx)
