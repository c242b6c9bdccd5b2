"""enqueue_ms.train: host ms from the call of ``TrainModule.train_step``
until it returns, without a sync, averaged over the window's units (the
engine layer; the benchmark's own clock around the call)."""

from benchmark.lib.readers import enqueue_ms


def read(ctx):
    return enqueue_ms(ctx)
