"""Multi-head self-attention that also emits the pruning importance scores
(port of ``tpat_tpu/ops/attention.py::attention_with_scores``).

This is the plain reference the fused kernels (``ops/qkv_attention.py``) are
held against, and the ``attention_impl='xla'`` path of the model.

- softmax runs in f32; p is cast to v's dtype before p.v;
- ``patch_mean``: mean over heads and patch-query rows of the patch-to-patch
  block (AudioMAE);
- ``cls``: the CLS query row to patch tokens, averaged over heads (AST);
- ``token_mask`` ((B, P) bool over patch tokens, the masked anneal path):
  the softmax is restricted to kept keys (the extras are always kept) and
  'patch_mean' averages over kept query rows only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpat_tpu_torch.ops.pruning import masked_softmax


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
    if need_scores and importance not in ("patch_mean", "cls"):
        raise ValueError(f"unknown importance mode: {importance}")
    b, h = q.shape[:2]
    e = num_extra_tokens
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if token_mask is not None:
        extra = torch.ones((b, e), dtype=torch.bool, device=token_mask.device)
        key_mask = torch.cat([extra, token_mask], dim=1)  # (B, N)
        attn = masked_softmax(logits, key_mask[:, None, None, :])
    else:
        attn = torch.softmax(logits, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)

    scores = None
    if need_scores:
        if importance == "patch_mean":
            block = attn[:, :, e:, e:]
            if token_mask is not None:
                qmask = token_mask.to(attn.dtype)  # (B, P)
                num = torch.einsum("bhqk,bq->bk", block, qmask)
                denom = h * qmask.sum(dim=1).clamp_min(1.0)
                scores = num / denom[:, None]
            else:
                scores = block.mean(dim=(1, 2))
        else:
            scores = attn[:, :, 0, e:].mean(dim=1)
    return out, scores
