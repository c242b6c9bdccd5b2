"""Device-resident dataset cache (port of ``tpat_tpu/data/device_cache.py``).

When a dataset's per-item pipeline is deterministic (no host-side
augmentation), its model inputs are materialised once on the host, copied
to the device once, and every epoch's batches are served as index gathers
on the device.  The batches equal the streaming loader's bit for bit: the
same ``__getitem__``, the same sampler order.  The cache changes where the
bytes live, not what the model sees.  Device-side augmentation (the
frontend's SpecAug and noise under ``--device_frontend``) still runs in the
step and is unaffected.

Eligibility (``nondeterminism_reason``): mixup, roll-mag, lr_pad and, on
the host-fbank path, SpecAug or noise make ``__getitem__`` a function of
(seed, epoch), so each of them rules the cache out.  The size is guarded
(``max_bytes``), and a run of more than one process is refused (each
process's sampler shard walks the whole index set across epochs): 'auto'
declines it and says why, 'true' raises.

A registry keyed by the dataset's signature (an LRU of 4) shares one
device copy between loaders of the same items in one process, such as a
train set and an eval set over the same manifest, or repeated CLI runs.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from collections import OrderedDict
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpat_tpu_torch.parallel.distributed import world_size
from tpat_tpu_torch.data.sampler import EpochShardSampler

# dataset signature -> (x, y, ids) on the device; a small LRU, so switching
# corpora in one process cannot pile up stale device copies
_REGISTRY: "OrderedDict[tuple, tuple]" = OrderedDict()
_REGISTRY_MAX = 4
# host -> device copies in slices of at most this many bytes
_CHUNK_BYTES = 32 << 20


def clear_cache() -> None:
    """Drop every cached device copy."""
    _REGISTRY.clear()


def nondeterminism_reason(dataset) -> Optional[str]:
    """Why ``dataset.__getitem__`` is not a pure function of the index, or
    None when it is (and the cache is sound).

    Waveform mode leaves SpecAug and noise to the device frontend, so only
    the host-side draws count there; the host-fbank path bakes them into
    the item and must have them off."""
    if getattr(dataset, "mixup", 0.0):
        return "waveform mixup is enabled (mixup > 0)"
    if getattr(dataset, "roll_mag", False):
        return "roll-mag augmentation is enabled"
    if getattr(dataset, "lr_pad", False):
        return "random left/right padding (lr_pad) is enabled"
    if not getattr(dataset, "return_waveform", False):
        if getattr(dataset, "freqm", 0) or getattr(dataset, "timem", 0):
            return "host-side SpecAug is enabled (freqm/timem > 0)"
        if getattr(dataset, "noise", False):
            return "host-side noise augmentation is enabled"
    return None


def _cache_key(dataset, device: torch.device) -> tuple:
    cfg = getattr(dataset, "cfg", None)
    return (
        str(device),
        type(dataset).__name__,
        # the datasets carry a stable `source`; object identity otherwise
        # (right, only not shared between constructions)
        getattr(dataset, "source", id(dataset)),
        getattr(dataset, "return_waveform", False),
        getattr(dataset, "num_samples", None),
        getattr(dataset, "skip_norm", False),
        len(dataset),
        getattr(cfg, "target_length", None),
        getattr(cfg, "num_mel_bins", None),
        getattr(cfg, "norm_mean", None),
        getattr(cfg, "norm_std", None),
    )


def estimated_bytes(dataset) -> int:
    """Size of the materialised inputs and labels, from item 0."""
    x0, y0, _ = dataset[0]
    return len(dataset) * (np.asarray(x0).nbytes + np.asarray(y0).nbytes)


def _materialize(dataset, num_workers: int):
    """One pass over the dataset on ``num_workers`` threads -> host arrays
    and the item ids."""
    n = len(dataset)
    x0, y0, _ = dataset[0]
    x0, y0 = np.asarray(x0), np.asarray(y0)
    xs = np.empty((n,) + x0.shape, x0.dtype)
    ys = np.empty((n,) + y0.shape, y0.dtype)
    ids: List = [None] * n

    def fill(i):
        x, y, d = dataset[i]
        xs[i], ys[i], ids[i] = x, y, d

    with cf.ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        list(pool.map(fill, range(n)))
    return xs, ys, ids


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One device allocation, filled by copies of at most _CHUNK_BYTES."""
    out = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                      device=device)
    rows = max(1, _CHUNK_BYTES // max(arr[:1].nbytes, 1))
    for i in range(0, arr.shape[0], rows):
        out[i:i + rows].copy_(torch.from_numpy(arr[i:i + rows]))
    return out


class DeviceCachedLoader:
    """In place of ``data.loader.DataLoader`` over a deterministic dataset:
    the same ``(x, y, ids)`` batches in the same sampler order, but ``x``
    and ``y`` are tensors on ``device`` gathered from one resident copy."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[EpochShardSampler] = None,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        seed: int = 0,
        device="cuda",
    ):
        reason = nondeterminism_reason(dataset)
        if reason is not None:
            raise ValueError(f"dataset is not cacheable on device: {reason}")
        if world_size() > 1:
            raise ValueError(
                "the device dataset cache is single-process only (each "
                "process's sampler shard walks the whole index set)"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else EpochShardSampler(
            len(dataset), shuffle=shuffle, seed=seed
        )
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._store = None  # (x, y, ids), filled at the first iteration

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _ensure_store(self):
        if self._store is not None:
            return
        key = _cache_key(self.dataset, self.device)
        if key in _REGISTRY:
            _REGISTRY.move_to_end(key)
            self._store = _REGISTRY[key]
            return
        t0 = time.perf_counter()
        xs, ys, ids = _materialize(self.dataset, self.num_workers)
        t1 = time.perf_counter()
        self._store = (_to_device(xs, self.device),
                       _to_device(ys, self.device), ids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(
            f"[device_cache] cached {len(ids)} items "
            f"({(xs.nbytes + ys.nbytes) / 1e6:.0f} MB) on {self.device}: "
            f"materialize {t1 - t0:.1f}s, copy "
            f"{time.perf_counter() - t1:.1f}s",
            flush=True,
        )
        _REGISTRY[key] = self._store
        while len(_REGISTRY) > _REGISTRY_MAX:
            _REGISTRY.popitem(last=False)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, list]]:
        self._ensure_store()
        x_dev, y_dev, ids = self._store
        idx = list(self.sampler)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        for b in batches:
            bi = torch.as_tensor(b, dtype=torch.long).to(self.device)
            yield (x_dev.index_select(0, bi), y_dev.index_select(0, bi),
                   [ids[i] for i in b])


def maybe_device_cached(
    dataset,
    batch_size: int,
    *,
    sampler: Optional[EpochShardSampler] = None,
    shuffle: bool = False,
    num_workers: int = 4,
    drop_last: bool = False,
    seed: int = 0,
    device="cuda",
    mode: str = "auto",
    max_bytes: int = 2 << 30,
    label: str = "dataset",
) -> Optional[DeviceCachedLoader]:
    """A ``DeviceCachedLoader`` where the dataset is eligible.

    ``mode``: 'false' -> None; 'true' -> a cache, or a ``ValueError`` with
    the reason; 'auto' -> a cache exactly when it is free (one process, a
    deterministic pipeline, at most ``max_bytes``), else None."""
    if mode == "false":
        return None
    if mode not in ("auto", "true"):
        raise ValueError(f"mode must be 'auto', 'true' or 'false', got {mode!r}")

    def decline(reason: str):
        if mode == "true":
            raise ValueError(
                f"--device_dataset true but the {label} cannot be cached: "
                f"{reason}"
            )
        return None

    if world_size() > 1:
        if mode == "auto":
            print(f"[device_cache] {label}: streamed from the host (a "
                  f"multi-process run: each rank's shard changes with the "
                  f"epoch)", flush=True)
        return decline("multi-process run")
    reason = nondeterminism_reason(dataset)
    if reason is not None:
        return decline(reason)
    est = estimated_bytes(dataset)
    if est > max_bytes:
        return decline(
            f"estimated size {est / 1e9:.2f} GB exceeds the "
            f"{max_bytes / 1e9:.2f} GB cache budget"
        )
    print(
        f"[device_cache] {label}: device-resident ({est / 1e6:.0f} MB est., "
        f"{len(dataset)} items)",
        flush=True,
    )
    return DeviceCachedLoader(
        dataset, batch_size, sampler=sampler, shuffle=shuffle,
        num_workers=num_workers, drop_last=drop_last, seed=seed,
        device=device,
    )
