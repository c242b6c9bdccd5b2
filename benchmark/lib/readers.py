"""What the per-layer metrics' readers share.  Each reader in
``benchmark/metrics/`` names its patterns and calls one of these; each
returns None where it finds nothing to read (no trace, no matching
kernel), and the harness then leaves the metric out of the line.

Kernel-name patterns match a substring of the device event's name in the
``torch.profiler`` trace.
"""

from __future__ import annotations

from typing import Optional

from benchmark.lib import frozen, work

DTYPE = "bfloat16"  # the configurations' compute dtype
ITEMSIZE = 2


def enqueue_ms(ctx) -> Optional[float]:
    """Mean host ms from a unit's call until it returns, without a sync."""
    e = ctx.window.enqueue_s
    return sum(e) / len(e) * 1e3 if e else None


def unit_flops(ctx, unit) -> float:
    """Model FLOPs of one unit of work (forward, times 3 with a backward),
    over the rows it was asked for (a padded request's padding is not
    useful work)."""
    if unit["model"] == "vit":
        f = work.vit_forward_flops(ctx.model, unit["step"], unit["rows"])
    else:
        f = work.mae_forward_flops(ctx.model, unit["rows"])
    return 3 * f if unit["backward"] else f


def mfu(ctx) -> Optional[float]:
    """% of the card's bf16 peak: the window's model FLOPs over the seconds
    its units were in service (the window, in a closed loop; the requests'
    own seconds, without their waits, in an open one)."""
    if not ctx.window.work:
        return None
    flops = sum(unit_flops(ctx, u) for u in ctx.window.work)
    seconds = ctx.window.service_s or ctx.window.seconds
    return flops / seconds / frozen.PEAK_FLOPS[DTYPE] * 100


def kernel_ms_per_unit(ctx, patterns) -> Optional[float]:
    """Device ms per unit of the kernels matching ``patterns``."""
    if ctx.trace is None or not ctx.window.units:
        return None
    s = ctx.trace.kernel_seconds(patterns)
    return None if s is None else s / ctx.window.units * 1e3


def idle(ctx, span: Optional[str] = None) -> Optional[float]:
    """% of the traced window in which nothing ran on the device; with
    ``span``, % of the time inside the host spans of that name (the
    requests in service, in an open loop whose waits for arrivals are no
    fault of the program)."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    if span is None:
        return (1 - ctx.trace.busy_s() / ctx.trace.window_s) * 100
    spans = ctx.trace.spans(span)
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    return (1 - ctx.trace.busy_within(spans) / total) * 100


def _qkv_bound_ms(ctx, unit) -> float:
    m = ctx.model
    c = m["embed_dim"]
    total = 0.0
    for call in work.vit_attention_calls(m, unit["step"], unit["batch"],
                                         unit["backward"]):
        w = frozen.qkv_work(call["b"], call["n"], 3 * c, m["num_heads"],
                            ITEMSIZE, mode=call["mode"], extra=1,
                            kv=call["kv"], bwd=call["bwd"])
        total += frozen.work_bound(w, DTYPE, ctx.sm_clock_hz)[0]
    return total


def _window_bound_ms(ctx, unit) -> float:
    m = ctx.model
    dc = m["decoder_embed_dim"]
    total = 0.0
    for call in work.mae_window_calls(m, unit["batch"]):
        w = frozen.window_work_shapes(call["b"], call["n"], 3 * dc,
                                      m["decoder_num_heads"], ITEMSIZE,
                                      call["template_numel"], call["pairs"],
                                      call["bwd"])
        total += frozen.work_bound(w, DTYPE, ctx.sm_clock_hz)[0]
    return total


BOUNDS = {"qkv_attention": _qkv_bound_ms, "window_attention": _window_bound_ms}


def roofline(ctx, kind: str, patterns) -> Optional[float]:
    """% of roofline of a kernel family: the summed bound of the calls the
    window's units need, from their shapes, over the summed device time of
    the kernels matching ``patterns``."""
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(patterns)
    if s is None:
        return None
    bound = sum(BOUNDS[kind](ctx, u) for u in ctx.window.work) / 1e3
    return bound / s * 100
