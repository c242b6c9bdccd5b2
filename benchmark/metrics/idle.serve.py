"""idle.serve: % of the time the requests were in service (from the call
to the logits on the host, the ``bench.request`` spans) in which no
kernel, copy or set ran on the device (the device layer).  The open
loop's waits for the next arrival are left out: they are the offered
load's, not the program's."""

from benchmark.lib.readers import idle


def read(ctx):
    return idle(ctx, span="bench.request")
