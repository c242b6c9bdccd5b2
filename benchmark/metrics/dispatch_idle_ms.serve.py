"""dispatch_idle_ms.serve: ms per request in which no kernel, copy or set
ran on the device while the program's ``serve.request`` span was open
(``utils/serving.py::load_forward``'s call: checks, bucket padding, the
forwards' launches, slicing), from the trace alone (``lib/spans.py``; the
engine layer). The benchmark's read-back after the call is left out."""

from benchmark.lib.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "serve.request")
