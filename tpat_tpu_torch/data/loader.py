"""Threaded batching loader (copy of ``tpat_tpu/data/loader.py``).

Decoding and the fbank are numpy work that releases the GIL inside FFT and
BLAS (all of it with the native frontend), so a thread pool overlaps them
without process start-up; batches are prefetched so host work overlaps the
device's.  Batches come out in sampler order as numpy (x, y, names); a
worker's exception is raised in the consumer, and an abandoned iterator
stops its producer.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from tpat_tpu_torch.data.sampler import EpochShardSampler


def _collate(items):
    xs = np.stack([it[0] for it in items])
    ys = np.stack([it[1] for it in items])
    ids = [it[2] for it in items]
    return xs, ys, ids


def _bounded_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Put that re-checks ``stop``: an abandoned consumer (an early break, a
    NaN abort) would otherwise leave the producer parked forever on a full
    queue.  False when stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[EpochShardSampler] = None,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else EpochShardSampler(
            len(dataset), shuffle=shuffle, seed=seed
        )
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, list]]:
        idx = list(self.sampler)
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, b))
                        if not _bounded_put(q, stop, _collate(items)):
                            return
            except BaseException as e:  # propagate, don't hang the consumer
                _bounded_put(q, stop, e)
                return
            _bounded_put(q, stop, None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    # a dataset or worker failure, raised in the caller as
                    # torch's DataLoader raises its workers' exceptions
                    raise item
                yield item
        finally:
            stop.set()


def prefetch_iter(it, prefetch: int = 2):
    """Drain ``it`` on a background thread through a bounded queue, so item
    production overlaps the consumer.  Producer exceptions are raised in the
    consumer; closing the returned generator stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    done = object()

    def producer():
        try:
            for item in it:
                if not _bounded_put(q, stop, (item,)):
                    return
        except BaseException as e:  # propagate, don't hang the consumer
            _bounded_put(q, stop, e)
            return
        _bounded_put(q, stop, done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is done:
                return
            if isinstance(got, BaseException):
                raise got
            yield got[0]
    finally:
        stop.set()
