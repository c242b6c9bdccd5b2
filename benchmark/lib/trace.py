"""Reading a ``torch.profiler`` trace of the measured window.

The driver wraps its window in ``record_function(WINDOW)``; everything here
is clipped to that span.  Device intervals are the CUDA events of the trace
(kernels, copies, sets); ``busy_s`` is the length of their union, so
kernels that overlap count once, and the idle gaps are what lies between
its pieces.  Each gap is put down to the host op that was running at its
middle: the innermost op open on any thread then.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
TOP = 10  # entries in each list of the breakdown
NAME_CHARS = 160  # kernel names are C++ templates; their heads tell them apart


@dataclass
class Trace:
    """The window's device intervals and host ops, in seconds from its
    start."""

    window_s: float
    kernels: List[Tuple[str, float, float]]  # (name, start, end)
    host: Dict[int, List[Tuple[float, float, str]]] = field(
        default_factory=dict)  # thread -> [(start, end, name)] by start

    def kernel_seconds(self, patterns) -> Optional[float]:
        """Summed device seconds of the kernels whose name holds one of
        ``patterns``; None where none ran."""
        ds = [e - s for n, s, e in self.kernels
              if any(p in n for p in patterns)]
        return sum(ds) if ds else None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def spans(self, name: str) -> List[Tuple[float, float]]:
        """The host spans of that name, on any thread, by start."""
        return sorted((s, e) for ops in self.host.values()
                      for s, e, n in ops if n == name)

    def busy_within(self, spans: List[Tuple[float, float]]) -> float:
        """Device-busy seconds inside ``spans`` (which do not overlap)."""
        busy, total, i = self.busy_intervals(), 0.0, 0
        for s, e in spans:
            while i < len(busy) and busy[i][1] <= s:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < e:
                total += min(e, busy[j][1]) - max(s, busy[j][0])
                j += 1
        return total

    def device_ops(self) -> List[list]:
        per: Dict[str, float] = collections.Counter()
        for n, s, e in self.kernels:
            per[n[:NAME_CHARS]] += e - s
        return [[n, t] for n, t in per.most_common(TOP)]

    def idle_gaps(self) -> List[list]:
        """Idle seconds by the host op open at each gap's middle, the
        largest ``TOP``."""
        gaps, t = [], 0.0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        per: Dict[str, float] = collections.Counter()
        for (s, e), name in zip(gaps, self._host_at([(s + e) / 2
                                                     for s, e in gaps])):
            per[name] += e - s
        return [[n, t] for n, t in per.most_common(TOP)]

    def _host_at(self, times: List[float]) -> List[str]:
        """The innermost host op open at each of ``times`` (any thread: the
        one that opened last), '(no host op)' where none is."""
        best: List[Tuple[float, str]] = [(-1.0, "(no host op)")] * len(times)
        order = sorted(range(len(times)), key=times.__getitem__)
        for ops in self.host.values():
            stack: List[Tuple[float, float, str]] = []
            k = 0
            for i in order:
                t = times[i]
                while k < len(ops) and ops[k][0] <= t:
                    while stack and stack[-1][1] <= ops[k][0]:
                        stack.pop()
                    stack.append(ops[k])
                    k += 1
                while stack and stack[-1][1] < t:
                    stack.pop()
                if stack and stack[-1][0] > best[i][0]:
                    best[i] = (stack[-1][0], stack[-1][2])
        return [name for _, name in best]


def from_profiler(prof) -> Trace:
    """The window of a finished ``torch.profiler.profile``, from its raw
    events (the profiler's own parsing of a long window takes minutes).
    Device intervals are the CUDA events that are not user annotations
    (``record_function`` spans are mirrored on the device's timeline)."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and e.device_type().name == "CPU"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' spans")
    t0, t1 = win[0].start_ns(), win[0].end_ns()
    kernels, host = [], collections.defaultdict(list)
    for e in events:
        s, f = e.start_ns(), e.end_ns()
        if f <= t0 or s >= t1:
            continue
        dev = e.device_type().name
        span = ((max(s, t0) - t0) / 1e9, (min(f, t1) - t0) / 1e9)
        if dev == "CUDA" and not e.is_user_annotation():
            kernels.append((e.name(),) + span)
        elif dev == "CPU" and e.name() != WINDOW:
            host[e.start_thread_id()].append(span + (e.name(),))
    for ops in host.values():
        ops.sort(key=lambda o: (o[0], -o[1]))
    return Trace((t1 - t0) / 1e9, kernels, dict(host))


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

