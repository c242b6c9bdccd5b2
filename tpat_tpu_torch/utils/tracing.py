"""The port's tracing: spans and counts at its layer boundaries, and the
``torch.profiler`` exporter of ``cli/finetune.py --profile_dir``.

``span(name)`` and ``count(key, n)`` are on exactly while a
``torch.profiler`` records (the flag the profiler sets,
``torch.autograd.profiler._is_profiler_enabled``). Off, ``span`` returns
the one shared no-op context manager ``OFF`` and ``count`` returns at once:
nothing is allocated, recorded or launched. On, a span

- opens ``torch.profiler.record_function(name)``, so that it sits in the
  profiler's trace beside the device events, on their clock;
- keeps a ``Record``: its host start and end, its parent (the innermost
  span open on the same thread when it opened) and the counts added while
  it was the innermost;
- where CUDA is in use, records a pair of timing ``torch.cuda.Event`` s on
  the current stream at entry and exit (none while the stream captures a
  CUDA graph), resolved only when ``Record.device_s`` is read.

Neither ever synchronises with or reads from the device, so a reader of
``device_s`` synchronises first (the benchmark's window ends in one).
Records go to a bounded in-memory store, the last ``STORE_LEN``;
``records(name)`` returns them in the order the spans closed. The store is
the process's, as the profiler's state is.

Span names: ``train.{step,forward,backward,update,grad_sync}``
(``engine/train.py``), ``pretrain.{step,forward,backward,update,
grad_sync}`` (``engine/pretrain.py``), ``vit.prune`` (``models/vit.py``),
``serve.request`` (``utils/serving.py``); the count ``attention_rows``
(``models/vit.py``: the token rows a block's attention computes).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

STORE_LEN = 100_000
OFF = contextlib.nullcontext()  # what ``span`` returns while tracing is off

_store: Deque["Record"] = collections.deque(maxlen=STORE_LEN)
_local = threading.local()  # .stack: the thread's open spans, innermost last


@dataclasses.dataclass
class Record:
    """One closed span."""

    name: str
    parent: Optional[str]
    host_start: float  # time.perf_counter() at entry
    host_end: float
    counts: Dict[str, int]
    events: Optional[tuple] = None  # (start, end) torch.cuda.Event

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start

    @property
    def device_s(self) -> Optional[float]:
        """Seconds the current stream took from the span's entry to its
        exit; None without CUDA events.  Read after a synchronise."""
        if self.events is None:
            return None
        start, end = self.events
        return start.elapsed_time(end) / 1e3


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "counts", "t0", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        self.counts: Dict[str, int] = {}
        stack.append(self)
        self.start = None
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self.start, end)
        _stack().pop()
        _store.append(Record(self.name, self.parent, self.t0, t1, self.counts,
                             events))
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work: a recorded span while a
    profiler records, else ``OFF``."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(name)


def count(key: str, n: int) -> None:
    """Add the host int ``n`` to ``key`` in the innermost open span's
    record, while a profiler records; dropped where no span is open."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


def records(name: str) -> List[Record]:
    """The store's records of spans named ``name``, in the order they
    closed."""
    return [r for r in _store if r.name == name]


def clear() -> None:
    """Empty the store."""
    _store.clear()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (host and, where there is a card,
    device activity), written as ``log_dir/trace.json`` for
    chrome://tracing or Perfetto; a no-op when log_dir is None.  The trace
    carries the program's spans (``train.*``, ``vit.prune``, the others
    above) beside the ops and kernels."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
