"""Metric logging (``tpat_tpu/utils/logging.py``): the reference's
``SmoothedValue`` and ``MetricLogger``.  The JAX package's profiler trace
has its counterpart in ``utils/tracing.py::profiler_trace``."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable


class SmoothedValue:
    """A window median and average beside the global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        # torch.median returns the LOWER middle element for even sizes
        d = sorted(self.deque)
        return d[(len(d) - 1) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Named meters and an iteration logger with ETA, data time and
    iteration time."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            # the last iteration prints too, so an epoch's last partial
            # window is logged
            if print_freq and (
                i % print_freq == 0 or (total and i == total - 1)
            ):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    self.print_fn(
                        f"{header} [{i}/{total}] eta: {eta_str} {self} "
                        f"time: {iter_time} data: {data_time}"
                    )
                else:
                    self.print_fn(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(
            f"{header} Total time: "
            f"{str(datetime.timedelta(seconds=int(elapsed)))}"
        )
