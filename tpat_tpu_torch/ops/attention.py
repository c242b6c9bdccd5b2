"""Multi-head self-attention that also emits the pruning importance scores
(port of ``tpat_tpu/ops/attention.py::attention_with_scores``, unmasked).

This is the plain reference the fused kernel (``ops/qkv_attention.py``) is
held against, and the ``attention_impl='xla'`` path of the model.

- softmax runs in f32; p is cast to v's dtype before p.v;
- ``patch_mean``: mean over heads and patch-query rows of the patch-to-patch
  block (AudioMAE);
- ``cls``: the CLS query row to patch tokens, averaged over heads (AST).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def attention_with_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_extra_tokens: int,
    importance: str,
    token_mask: Optional[torch.Tensor] = None,
    need_scores: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q, k, v: (B, H, N, D).  Returns (out (B, H, N, D) in v's dtype,
    scores (B, N - extra) f32 or None)."""
    if token_mask is not None:
        raise NotImplementedError(
            "token_mask (the masked anneal path) is not ported yet"
        )
    if need_scores and importance not in ("patch_mean", "cls"):
        raise ValueError(f"unknown importance mode: {importance}")
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    attn = torch.softmax(logits, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)

    scores = None
    if need_scores:
        e = num_extra_tokens
        if importance == "patch_mean":
            scores = attn[:, :, e:, e:].mean(dim=(1, 2))
        else:
            scores = attn[:, :, 0, e:].mean(dim=1)
    return out, scores
