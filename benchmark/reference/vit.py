"""Plain PyTorch reference of the token-pruning AudioMAE ViT (finetune and
serving), in float32 with TF32 off, written from the published model
(AudioMAE ``models_vit.py``; the token pruning of the ECAI-2025 paper's
recipe) and imported from nothing of the program.

The ViT-B/16 block: pre-norm LayerNorm (eps 1e-6), multi-head attention
with a softmax over q.k^T / sqrt(D), exact erf GELU in the MLP, stochastic
depth on both residual branches in training.  Pruning after the attention
residual of a drop block keeps the ceil(keep * P) patch tokens of highest
importance (the attention the patch tokens receive from the patch queries,
averaged over heads and queries), ties to the lower index, CLS in front.

Step kinds (``benchmark/lib/work.py``'s descriptors):
- 'static': the baked keep rates;
- 'dense' with ``mask_prob``: 2D time/frequency masking of the patch grid
  (rows and columns of smallest noise kept, tokens in that order);
- 'hybrid' at a scheduled ``rate``: each drop block gathers to the width of
  the rate snapped up to the anneal's bucket, and the exact scheduled kept
  count rides inside it as a prefix mask: later attention sees only the
  kept prefix as keys, importance averages over kept queries only, and the
  pooling averages over the kept tokens.

Random draws (stochastic depth, the 2D masking noise) are made from a
generator in the order the model consumes them: the masking noise first,
then each block's attention-branch and MLP-branch keep draws in block
order, blocks at rate 0 drawing nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.work import bucket_rate, ceil_chain, vit_grid

NEG = float("-inf")


def param_specs(model: Dict) -> list:
    """(name, shape, init) of every parameter, by the reference ``.pth``
    names."""
    c, depth = model["embed_dim"], model["depth"]
    hid = int(c * model.get("mlp_ratio", 4.0))
    p = model.get("patch_size", 16)
    gt, gf = vit_grid(model)
    specs = [("patch_embed.proj.weight", (c, 1, p, p), "normal"),
             ("patch_embed.proj.bias", (c,), "normal"),
             ("cls_token", (1, 1, c), "normal"),
             ("pos_embed", (1, 1 + gt * gf, c), ("sincos", (gt, gf)))]
    for i in range(depth):
        b = f"blocks.{i}."
        specs += [(b + "norm1.weight", (c,), "one"),
                  (b + "norm1.bias", (c,), "normal"),
                  (b + "attn.qkv.weight", (3 * c, c), "normal"),
                  (b + "attn.qkv.bias", (3 * c,), "normal"),
                  (b + "attn.proj.weight", (c, c), "normal"),
                  (b + "attn.proj.bias", (c,), "normal"),
                  (b + "norm2.weight", (c,), "one"),
                  (b + "norm2.bias", (c,), "normal"),
                  (b + "mlp.fc1.weight", (hid, c), "normal"),
                  (b + "mlp.fc1.bias", (hid,), "normal"),
                  (b + "mlp.fc2.weight", (c, hid), "normal"),
                  (b + "mlp.fc2.bias", (c,), "normal")]
    specs += [("fc_norm.weight", (c,), "one"), ("fc_norm.bias", (c,), "normal"),
              ("head.weight", (model["num_classes"], c), "normal"),
              ("head.bias", (model["num_classes"],), "normal")]
    return specs


FROZEN = ("pos_embed",)  # the fixed sin-cos table takes no gradient


def layer_norm(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, 1, T, F) -> (B, (T/p)*(F/p), p*p), row-major patches."""
    b, _, t, f = x.shape
    x = x.reshape(b, t // p, p, f // p, p).permute(0, 1, 3, 2, 4)
    return x.reshape(b, (t // p) * (f // p), p * p)


def path_rates(model: Dict) -> List[float]:
    """Stochastic-depth rates, linear from 0 to ``drop_path_rate``."""
    rates = np.linspace(0.0, model.get("drop_path_rate", 0.1), model["depth"])
    return [float(r) for r in rates]


def draws(model: Dict, step: Dict, batch: int, gen: torch.Generator,
          device, train: bool) -> Dict:
    """The step's random draws, in the order the model consumes them."""
    out: Dict = {"noise": None, "path": []}
    if step["kind"] == "dense" and step.get("mask_prob", 0.0) > 0.0:
        gt, gf = vit_grid(model)
        out["noise"] = (torch.rand((batch, gt), generator=gen, device=device),
                        torch.rand((batch, gf), generator=gen, device=device))
    for rate in path_rates(model):
        if not train or rate == 0.0:
            out["path"].append(None)
            continue
        k1 = torch.rand((batch, 1, 1), generator=gen, device=device) < 1 - rate
        k2 = torch.rand((batch, 1, 1), generator=gen, device=device) < 1 - rate
        out["path"].append((k1, k2, rate))
    return out


def take(draw: Dict, rows: slice) -> Dict:
    """The draws of a block of the batch's rows."""
    noise = draw["noise"]
    return {"noise": None if noise is None else tuple(n[rows] for n in noise),
            "path": [None if d is None else (d[0][rows], d[1][rows], d[2])
                     for d in draw["path"]]}


def _branch(x, keep):
    if keep is None:
        return x
    k, rate = keep
    return torch.where(k, x / (1.0 - rate), torch.zeros_like(x))


def _attention(P, pre, x, heads, prec, key_mask=None, query_mask=None):
    """(output (B, N, C), importance (B, P) of the patch tokens)."""
    b, n, c = x.shape
    d = c // heads
    qkv = prec.linear(x, P[pre + "qkv.weight"], P[pre + "qkv.bias"])
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    logits = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG)
    attn = torch.softmax(logits, dim=-1)
    out = prec.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
    block = attn[:, :, 1:, 1:]
    if query_mask is None:
        scores = block.mean(dim=(1, 2))
    else:
        qm = query_mask.float()
        scores = (torch.einsum("bhqk,bq->bk", block, qm)
                  / (heads * qm.sum(1).clamp_min(1.0))[:, None])
    out = prec.linear(out, P[pre + "proj.weight"], P[pre + "proj.bias"])
    return out, scores


def _mlp(P, pre, x, prec):
    h = prec.linear(x, P[pre + "fc1.weight"], P[pre + "fc1.bias"])
    return prec.linear(F.gelu(h), P[pre + "fc2.weight"], P[pre + "fc2.bias"])


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, descending, ties to the
    lower index."""
    return torch.sort(scores.detach(), dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    patches = torch.gather(x[:, 1:], 1,
                           idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :1], patches], dim=1)


def embed(P, model: Dict, x: torch.Tensor, noise, mask_prob: float, prec):
    p = model.get("patch_size", 16)
    c = model["embed_dim"]
    w = P["patch_embed.proj.weight"].reshape(c, -1)
    tokens = prec.linear(patchify(x, p), w, P["patch_embed.proj.bias"])
    pos = P["pos_embed"][0]
    tokens = tokens + pos[1:]
    if noise is not None:
        gt, gf = vit_grid(model)
        b = tokens.shape[0]
        kt, kf = int(gt * (1 - mask_prob)), int(gf * (1 - mask_prob))
        grid = tokens.reshape(b, gt, gf, c)
        ids_t = torch.argsort(noise[0], dim=1, stable=True)[:, :kt]
        grid = torch.gather(grid, 1, ids_t[:, :, None, None].expand(-1, -1, gf, c))
        grid = grid.transpose(1, 2)
        ids_f = torch.argsort(noise[1], dim=1, stable=True)[:, :kf]
        grid = torch.gather(grid, 1, ids_f[:, :, None, None].expand(-1, -1, kt, c))
        tokens = grid.transpose(1, 2).reshape(b, kt * kf, c)
    cls = (P["cls_token"][0] + pos[:1]).expand(tokens.shape[0], -1, -1)
    return torch.cat([cls, tokens], dim=1)


def forward(P: Dict, model: Dict, step: Dict, x: torch.Tensor, draw: Dict,
            prec) -> torch.Tensor:
    """Logits (B, classes) of one step kind on a block of rows."""
    heads, depth = model["num_heads"], model["depth"]
    drop = tuple(model["drop_loc"])
    gt, gf = vit_grid(model)
    npatch = gt * gf
    kind = step["kind"]
    tokens = embed(P, model, x, draw["noise"], step.get("mask_prob", 0.0),
                   prec)
    b = tokens.shape[0]
    if kind == "static":
        rates, kept = step["keep"], ceil_chain(step["keep"], npatch)
    elif kind == "hybrid":
        rates = [step["rate"] if i in drop else 1.0 for i in range(depth)]
        width = ceil_chain([bucket_rate(r, model["base_keep_rate"],
                                        step.get("n_buckets", 4))
                            for r in rates], npatch)
        left = ceil_chain(rates, npatch)
    else:
        rates = [1.0] * depth
    token_mask: Optional[torch.Tensor] = None
    for i in range(depth):
        pre = f"blocks.{i}."
        path = draw["path"][i]
        keep1 = keep2 = None
        if path is not None:
            keep1, keep2 = (path[0], path[2]), (path[1], path[2])
        key_mask = None
        if token_mask is not None:
            key_mask = torch.cat([torch.ones_like(token_mask[:, :1]),
                                  token_mask], dim=1)
        h = layer_norm(tokens, P[pre + "norm1.weight"], P[pre + "norm1.bias"])
        out, scores = _attention(P, pre + "attn.", h, heads, prec, key_mask,
                                 token_mask)
        tokens = tokens + _branch(out, keep1)
        if kind == "static" and rates[i] < 1.0:
            tokens = _gather(tokens, _top(scores, kept[i]))
        elif kind == "hybrid" and i in drop:
            if token_mask is not None:
                scores = scores.masked_fill(~token_mask, NEG)
            tokens = _gather(tokens, _top(scores, width[i]))
            rank = torch.arange(width[i], device=tokens.device)
            token_mask = (rank < left[i])[None, :].expand(b, -1)
        h = layer_norm(tokens, P[pre + "norm2.weight"], P[pre + "norm2.bias"])
        tokens = tokens + _branch(_mlp(P, pre + "mlp.", h, prec), keep2)
    patches = tokens[:, 1:]
    if token_mask is None:
        feat = patches.mean(1)
    else:
        m = token_mask.float()[..., None]
        feat = (patches * m).sum(1) / m.sum(1).clamp_min(1.0)
    feat = layer_norm(feat, P["fc_norm.weight"], P["fc_norm.bias"])
    return prec.linear(feat, P["head.weight"], P["head.bias"])


def soft_ce_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Summed (not averaged) soft-target cross-entropy over the rows."""
    return -(y * F.log_softmax(logits, dim=-1)).sum()
