"""Shape-static top-k token pruning primitives (port of
``tpat_tpu/ops/pruning.py:35-124``).

The ordering contract is the reference's ``torch.topk(largest=True,
sorted=True)`` as ``jax.lax.top_k`` gives it: descending score, ties to the
lower index.  ``torch.topk`` does not promise that tie order, so
``topk_select`` takes a stable descending sort and slices it.
"""

from __future__ import annotations

import math

import torch


def num_left_tokens(keep_rate: float, num_patches: int) -> int:
    """Static kept-token count: ceil(keep_rate * num_patches)."""
    n = math.ceil(keep_rate * num_patches)
    if n <= 0:
        raise ValueError(
            f"num_left_tokens must be > 0, got {n} "
            f"(keep_rate={keep_rate}, num_patches={num_patches})"
        )
    return n


def topk_select(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the top-k scores per row, descending, ties to the lower
    index.  scores: (B, P).  Returns (B, k) int64."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return idx[..., :k]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` for (B, N, C) tokens and (B, k) indices."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def gather_tokens(
    x: torch.Tensor, idx: torch.Tensor, num_extra_tokens: int
) -> torch.Tensor:
    """Keep the extra tokens, gather patch tokens at ``idx`` (indices into
    ``x[:, num_extra_tokens:]``).  Returns (B, extra + k, C)."""
    patches = take_rows(x[:, num_extra_tokens:], idx)
    return torch.cat([x[:, :num_extra_tokens], patches], dim=1)


def gather_scores(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Re-gather a per-patch score vector through a pruning step."""
    return torch.gather(scores, 1, idx)
