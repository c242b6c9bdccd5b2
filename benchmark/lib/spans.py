"""What the readers of the program's own spans share.

The program (``tpat_tpu_torch/utils/tracing.py``) records its spans and
counts while a ``torch.profiler`` records: each span sits in the window's
trace under its name, and its record (host seconds, device seconds from a
pair of CUDA events, parent, counts) in the tracer's store, which keeps the
last records of the whole process.  A window's records of a name are the
store's last K of it, K the spans of that name the window's trace holds.

Each reader returns None where it finds nothing to read: no trace, no span
of that name in it (a program without the tracer), no device time (no
CUDA), or fewer records than spans.
"""

from __future__ import annotations

from typing import List, Optional


def window_records(ctx, name: str) -> Optional[List]:
    """The tracer's records of the window's spans named ``name``."""
    if ctx.trace is None:
        return None
    k = len(ctx.trace.spans(name))
    if not k:  # a program without these spans has no tracer to ask
        return None
    from tpat_tpu_torch.utils import tracing

    recs = tracing.records(name)
    return recs[-k:] if len(recs) >= k else None


def device_ms_per_unit(ctx, name: str) -> Optional[float]:
    """Device ms per unit inside the spans named ``name``: from each span's
    entry to its exit on the stream it ran on (CUDA events)."""
    recs = window_records(ctx, name)
    if not recs or not ctx.window.units:
        return None
    ds = [r.device_s for r in recs]
    if any(d is None for d in ds):
        return None
    return sum(ds) / ctx.window.units * 1e3


def count_per_clip(ctx, name: str, key: str) -> Optional[float]:
    """The count ``key`` summed over the window's spans named ``name``,
    over the clips the window completed."""
    recs = window_records(ctx, name)
    if not recs or not ctx.window.clips:
        return None
    return sum(r.counts.get(key, 0) for r in recs) / ctx.window.clips


def idle_ms_per_unit(ctx, name: str) -> Optional[float]:
    """Ms per unit, inside the host spans named ``name``, in which no
    kernel, copy or set ran on the device (the trace alone)."""
    if ctx.trace is None or not ctx.trace.kernels or not ctx.window.units:
        return None
    spans = ctx.trace.spans(name)
    if not spans:
        return None
    idle = sum(e - s for s, e in spans) - ctx.trace.busy_within(spans)
    return idle / ctx.window.units * 1e3
