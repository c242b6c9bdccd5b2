"""Epoch-seeded shuffling and sharding (copy of ``tpat_tpu/data/sampler.py``).

Train sharding follows torch's DistributedSampler: a permutation per epoch
seeded by seed + epoch, padded to divisibility, rank-strided.  Eval
sharding is unpadded, so metrics are exact (``EvalShardSampler`` feeds a
loader one rank's eval shard under ``--dist_eval``).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class EpochShardSampler:
    def __init__(
        self,
        dataset_len: int,
        shuffle: bool = True,
        seed: int = 0,
        world: int = 1,
        rank: int = 0,
    ):
        self.n = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.world = world
        self.rank = rank
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> List[int]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.n)
        else:
            idx = np.arange(self.n)
        total = -(-self.n // self.world) * self.world
        if total > self.n:  # pad with wrap-around like DistributedSampler
            idx = np.concatenate([idx, idx[: total - self.n]])
        return idx[self.rank :: self.world].tolist()

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self):
        return -(-self.n // self.world)


def eval_shard(dataset_len: int, world: int = 1, rank: int = 0) -> List[int]:
    """Unpadded eval sharding: indices[rank::world]."""
    return list(range(dataset_len))[rank::world]


class EvalShardSampler:
    """A loader's sampler over one rank's unpadded eval shard."""

    def __init__(self, dataset_len: int, world: int = 1, rank: int = 0):
        self.idx = eval_shard(dataset_len, world, rank)

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self) -> Iterator[int]:
        return iter(self.idx)

    def __len__(self):
        return len(self.idx)


class WeightedShardSampler(EpochShardSampler):
    """Class-balanced sampling with replacement per shard: a deterministic
    multinomial per epoch over per-sample weights, after the usual shuffle
    and shard."""

    def __init__(self, weights, **kw):
        super().__init__(dataset_len=len(weights), **kw)
        self.weights = np.asarray(weights, dtype=np.float64)

    def indices(self) -> List[int]:
        base = np.asarray(super().indices())
        g = np.random.default_rng(self.seed + self.epoch + 7919)
        w = self.weights[base]
        p = w / w.sum()
        picked = g.choice(len(base), size=len(base), replace=True, p=p)
        return base[picked].tolist()
