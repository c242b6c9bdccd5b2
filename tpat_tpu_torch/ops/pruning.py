"""Top-k token pruning primitives (port of ``tpat_tpu/ops/pruning.py``):
the shape-static ones of the static path and the masked ones of the
anneal path.

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


# --- masked (anneal) path: ``tpat_tpu/ops/pruning.py:127-205`` -------------

_NEG_INF = -1e30


def masked_refine(
    scores: torch.Tensor, mask: torch.Tensor, num_left
) -> torch.Tensor:
    """Among the kept tokens (``mask``, (B, P) bool), keep the ``num_left``
    highest-scoring ones.  ``num_left`` is an int or a (B,) integer tensor.
    Ranks come from a stable descending sort, so ties go to the lower
    index, as the JAX argsort of the negated scores orders them."""
    masked = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    iota = torch.arange(order.shape[1], device=order.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(1, order, iota)
    if isinstance(num_left, torch.Tensor) and num_left.dim() == 1:
        num_left = num_left[:, None]
    return mask & (ranks < num_left)


def masked_num_left(keep_rate: float, kept_count: torch.Tensor) -> torch.Tensor:
    """ceil(keep_rate * kept_count) in float32, as the JAX function
    computes it in the graph (int64)."""
    rate = torch.tensor(keep_rate, dtype=torch.float32, device=kept_count.device)
    return torch.ceil(rate * kept_count.float()).long()


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` restricted to mask == True, summed in x's dtype and
    divided by the kept count (at least 1) in x's dtype."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    total = (x * m).sum(dim=dim)
    count = m.sum(dim=dim)
    return total / count.clamp_min(1.0)


def masked_softmax(logits: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to key_mask == True columns;
    the row max is detached, as ``jax.lax.stop_gradient`` detaches it."""
    logits = torch.where(key_mask, logits, torch.full_like(logits, _NEG_INF))
    logits = logits - logits.amax(dim=-1, keepdim=True).detach()
    unnorm = torch.exp(logits) * key_mask.to(logits.dtype)
    denom = unnorm.sum(dim=-1, keepdim=True)
    return unnorm / denom.clamp_min(1e-30)


def full_token_mask(batch: int, num_patches: int, device=None) -> torch.Tensor:
    return torch.ones((batch, num_patches), dtype=torch.bool, device=device)
