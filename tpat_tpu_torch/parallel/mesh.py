"""The rows of a global batch that each process holds
(``tpat_tpu/parallel/mesh.py``).

Under the JAX package's SPMD step the global batch is one array whose rows
process r supplies as ``[r*B, (r+1)*B)`` (``shard_batch`` lays the
processes' rows out in rank order), and every random tensor with a batch
axis is drawn over that global batch from one key.  Here each process
drives one device and holds only its B rows, so the draws follow the same
rule: each rank draws at the global shape ``world*B`` from its generator,
seeded alike on every rank, and keeps its own rows (``rand_rows``,
``draw_rows``).  A run over two ranks then equals the one-process run of
the same global batches, drop-path, dropout, 2D masking, SpecAug, noise
and the MAE masking included.  Under a model axis the rule runs over the
data ranks (``distributed.data_rank_world``): the ranks of one model group
hold the same rows and draw the same masks.  The 2-D mesh is
``sharding.make_mesh_2d``.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpat_tpu_torch.parallel.distributed import data_rank_world


def rank_rows(batch: int, rank: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``world * batch`` rows."""
    return slice(rank * batch, (rank + 1) * batch)


def draw_rows(draw: Callable[[int], torch.Tensor], batch: int) -> torch.Tensor:
    """``draw(world * batch)`` (a tensor whose leading axis has that many
    rows), cut to this rank's ``batch`` rows, over the data ranks;
    ``draw(batch)`` at one data rank."""
    rank, world = data_rank_world()
    if world == 1:
        return draw(batch)
    return draw(world * batch)[rank_rows(batch, rank)]


def rand_rows(shape, generator, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` whose leading axis is the batch, drawn by the
    global-batch rule."""
    rest = tuple(shape[1:])
    return draw_rows(
        lambda n: torch.rand((n, *rest), generator=generator, device=device),
        shape[0])


def pad_for_eval(n: int, world: int) -> int:
    """Rows of padding that make ``n`` divide by ``world``; the eval leaves
    them out of its metrics (``DistributedEvalSampler``'s unpadded-exact
    semantics, ``util/sampler.py:73-99``)."""
    return (-n) % world
