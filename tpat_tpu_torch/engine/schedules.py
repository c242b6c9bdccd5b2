"""Training schedules: keep-rate cosine anneal, its buckets and kept counts,
the phase rule, warmup + cosine LR, and the BEiT layer-decay and
weight-decay rules.

A plain-Python copy of ``tpat_tpu/engine/schedules.py:20-219`` (that module
imports ``jax.numpy``, so it cannot be imported here).  The layer and decay
rules take the port's parameter names (``blocks.3.attn.qkv.weight``) where
the JAX ones take flax paths (``blocks_3/attn/qkv/kernel``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpat_tpu_torch.config import compose_kept_counts


def scheduled_keep_rates(
    iters: int,
    epoch: int,
    *,
    shrink_start_epoch: int,
    total_epochs: int,
    iters_per_epoch: int,
    base_keep_rate: float,
    max_keep_rate: float = 1.0,
    num_blocks: int = 12,
    drop_loc: Tuple[int, ...] = (3, 6, 9),
) -> Optional[Tuple[float, ...]]:
    """Per-iteration keep-rate tuple: all 1.0 before ``shrink_start_epoch``,
    a cosine from ``max_keep_rate`` to ``base_keep_rate`` at the drop_loc
    blocks during the shrink, None from ``total_epochs`` (= shrink start +
    shrink epochs) on, where the model's baked rates apply."""
    if epoch < shrink_start_epoch:
        return (1.0,) * num_blocks
    if epoch >= total_epochs:
        return None
    total_iters = iters_per_epoch * (total_epochs - shrink_start_epoch)
    it = iters - iters_per_epoch * shrink_start_epoch
    target = base_keep_rate + (max_keep_rate - base_keep_rate) * (
        math.cos(it / total_iters * math.pi) + 1.0
    ) * 0.5
    rates = [1.0] * num_blocks
    for i in drop_loc:
        rates[i] = target
    return tuple(rates)


def bucket_keep_rates(
    rates: Tuple[float, ...],
    *,
    base_keep_rate: float,
    max_keep_rate: float = 1.0,
    n_buckets: int = 4,
) -> Tuple[float, ...]:
    """Snap each rate UP to one of ``n_buckets`` levels in
    [base_keep_rate, max_keep_rate] (1e-9 float fuzz only), so a bucket
    never prunes more than the schedule."""
    if n_buckets < 2:
        raise ValueError("anneal_buckets must be >= 2")
    levels = [
        base_keep_rate + (max_keep_rate - base_keep_rate) * i / (n_buckets - 1)
        for i in range(n_buckets)
    ]
    out = []
    for r in rates:
        if r >= max_keep_rate:
            out.append(max_keep_rate)
            continue
        out.append(next((lv for lv in levels if lv >= r - 1e-9), max_keep_rate))
    return tuple(out)


def masked_kept_counts(
    rates: Tuple[float, ...], drop_loc: Tuple[int, ...], num_patches: int
) -> Tuple[int, ...]:
    """Per-block kept-token counts of the anneal paths, composed on the host
    in double: the static path's ``math.ceil(keep * kept)`` chain, with the
    rates outside ``drop_loc`` neutralised."""
    effective = tuple(r if i in drop_loc else 1.0 for i, r in enumerate(rates))
    return compose_kept_counts(effective, num_patches)


def schedule_phase(
    epoch: int, *, shrink_start_epoch: int, shrink_epochs: int,
    base_keep_rate: float,
) -> str:
    """'dense' before the shrink (or with no pruning at all), 'anneal'
    during it, 'static' after it."""
    if base_keep_rate >= 1.0 or epoch < shrink_start_epoch:
        return "dense"
    if epoch < shrink_start_epoch + shrink_epochs:
        return "anneal"
    return "static"


def warmup_cosine_lr(
    fractional_epoch: float,
    *,
    lr: float,
    min_lr: float,
    warmup_epochs: float,
    total_epochs: int,
) -> float:
    """Per-iteration linear warmup, then a half-cosine to ``min_lr``."""
    e = fractional_epoch
    if e < warmup_epochs:
        return lr * e / max(warmup_epochs, 1e-8)
    denom = max(total_epochs - warmup_epochs, 1e-8)
    return min_lr + (lr - min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * (e - warmup_epochs) / denom)
    )


def layer_id_for_vit(name: str, num_layers: int) -> int:
    """BEiT layer id of a parameter name: CLS/dist/pos/patch embedding -> 0,
    ``blocks.{i}.*`` -> i + 1, everything else -> num_layers."""
    parts = name.split(".")
    if parts[0] in ("cls_token", "dist_token", "pos_embed", "patch_embed"):
        return 0
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return num_layers


def layer_decay_scale(name: str, depth: int, layer_decay: float) -> float:
    """lr scale = layer_decay ** (num_layers - layer_id), num_layers =
    depth + 1."""
    num_layers = depth + 1
    return layer_decay ** (num_layers - layer_id_for_vit(name, num_layers))


def weight_decay_mask(name: str, param: torch.Tensor) -> bool:
    """Weight decay on >= 2-D parameters outside pos_embed and the extra
    tokens."""
    if name.split(".")[0] in ("pos_embed", "cls_token", "dist_token"):
        return False
    return param.dim() > 1
