"""The work a step or a request needs, from its shapes alone.

The step kinds of the benchmark's drivers are described by plain dicts
(``step_geometry``'s input), and everything here follows from them and the
configuration's sizes: the token count each block's attention and MLP see,
the attention calls with their (N, kv_valid, scores) geometry, and the model
FLOPs.  Nothing here asks the program what it ran, so a metric reads the
same work whatever implements it.

FLOPs (``mfu.*``): 2 per multiply-add of every GEMM and of attention's two
products, at each block's token count (attention's products over the valid
keys); the backward counts twice the forward and recomputation is not
counted.  LayerNorm, GELU, softmax, the optimizer and the loss are left
out (a few per cent of the GEMMs).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple


def ceil_chain(rates: Sequence[float], num_patches: int) -> Tuple[int, ...]:
    """Per-block kept patch counts under ``kept = ceil(r * kept)`` for each
    rate below 1, in double (the reference's ``math.ceil`` chain)."""
    out, kept = [], num_patches
    for r in rates:
        if r < 1.0:
            kept = math.ceil(r * kept)
        out.append(kept)
    return tuple(out)


def bucket_rate(rate: float, base: float, n_buckets: int) -> float:
    """The rate snapped UP to one of ``n_buckets`` levels in [base, 1]."""
    if rate >= 1.0:
        return 1.0
    levels = [base + (1.0 - base) * i / (n_buckets - 1)
              for i in range(n_buckets)]
    return next((lv for lv in levels if lv >= rate - 1e-9), 1.0)


def vit_grid(model: Dict) -> Tuple[int, int]:
    p = model.get("patch_size", 16)
    return model["target_length"] // p, model["num_mel_bins"] // p


def static_step(model: Dict) -> Dict:
    """The static step of the configuration's baked keep rates."""
    return {"kind": "static",
            "keep": [model["base_keep_rate"] if k in model["drop_loc"] else 1.0
                     for k in range(model["depth"])]}


def vit_block_geometry(model: Dict, step: Dict) -> List[Dict]:
    """Per block of the ViT: {'n': rows attention sees, 'kv': valid keys,
    'scores': whether it emits importance scores, 'mlp': rows the MLP
    sees}, for a step {'kind': 'static' | 'dense' | 'hybrid', 'keep':
    per-block rates (static), 'mask_prob' (dense), 'rate' (hybrid: the
    scheduled rate at the drop blocks)}."""
    depth = model["depth"]
    drop = tuple(model["drop_loc"])
    e = 1  # AudioMAE's CLS
    gt, gf = vit_grid(model)
    p = gt * gf
    kind = step["kind"]
    blocks = []
    if kind == "dense":
        mp = step.get("mask_prob", 0.0)
        n = e + int(gt * (1 - mp)) * int(gf * (1 - mp)) if mp else e + p
        return [dict(n=n, kv=n, scores=False, mlp=n) for _ in range(depth)]
    if kind == "static":
        rates = step["keep"]
        kept = ceil_chain(rates, p)
        prev = p
        for i in range(depth):
            n = e + prev
            prune = rates[i] < 1.0
            blocks.append(dict(n=n, kv=n, scores=prune,
                               mlp=e + kept[i] if prune else n))
            prev = kept[i]
        return blocks
    if kind == "hybrid":
        rates = [step["rate"] if i in drop else 1.0 for i in range(depth)]
        buckets = [bucket_rate(r, model["base_keep_rate"],
                               step.get("n_buckets", 4)) for r in rates]
        width = ceil_chain(buckets, p)
        left = ceil_chain(rates, p)
        first = min(drop)
        n, kv = e + p, e + p
        for i in range(depth):
            d = i in drop
            blocks.append(dict(n=n, kv=kv if i > first else n, scores=d,
                               mlp=e + width[i] if d else n))
            if d:
                n, kv = e + width[i], e + left[i]
        return blocks
    raise ValueError(f"unknown step kind {kind!r}")


def vit_forward_flops(model: Dict, step: Dict, batch: int) -> float:
    """Model FLOPs of one ViT forward at ``batch``."""
    c = model["embed_dim"]
    hidden = int(c * model.get("mlp_ratio", 4.0))
    p = model.get("patch_size", 16)
    gt, gf = vit_grid(model)
    flops = 2.0 * gt * gf * (p * p * model.get("in_chans", 1)) * c
    for blk in vit_block_geometry(model, step):
        n, kv, m = blk["n"], blk["kv"], blk["mlp"]
        flops += 2.0 * n * c * 3 * c + 4.0 * n * kv * c + 2.0 * n * c * c
        flops += 4.0 * m * c * hidden
    flops += 2.0 * c * model["num_classes"]
    return batch * flops


def mae_geometry(model: Dict) -> Dict:
    """The MAE's token counts: encoder rows (CLS + visible patches),
    decoder rows (the whole grid; the swin decoder drops CLS), window
    tokens."""
    gt, gf = vit_grid(model)
    if model.get("mask_2d"):
        visible = (int(gt * (1 - model["mask_t_prob"]))
                   * int(gf * (1 - model["mask_f_prob"])))
    else:
        visible = int(gt * gf * (1 - model.get("mask_ratio", 0.8)))
    wh, ww = model.get("window_size", (4, 4))
    return dict(grid=(gt, gf), enc=1 + visible, dec=gt * gf, window=wh * ww)


def mae_forward_flops(model: Dict, batch: int) -> float:
    """Model FLOPs of one MAE forward (swin decoder) at ``batch``."""
    g = mae_geometry(model)
    c, dc = model["embed_dim"], model["decoder_embed_dim"]
    p = model.get("patch_size", 16)
    hid, dhid = 4 * c, 4 * dc
    n, nd = g["enc"], g["dec"]
    flops = 2.0 * nd * p * p * c  # the patch conv runs on every patch
    flops += model["depth"] * (2.0 * n * c * 3 * c + 4.0 * n * n * c
                               + 2.0 * n * c * c + 4.0 * n * c * hid)
    flops += 2.0 * n * c * dc
    flops += model["decoder_depth"] * (
        2.0 * nd * dc * 3 * dc + 4.0 * nd * g["window"] * dc
        + 2.0 * nd * dc * dc + 4.0 * nd * dc * dhid)
    flops += 2.0 * nd * dc * p * p
    return batch * flops


def vit_attention_calls(model: Dict, step: Dict, batch: int,
                        backward: bool) -> List[Dict]:
    """The qkv-attention calls of one ViT step: {'b', 'n', 'kv', 'mode',
    'bwd'}; a backward call per forward call where ``backward``."""
    calls = []
    for blk in vit_block_geometry(model, step):
        calls.append(dict(b=batch, n=blk["n"], kv=blk["kv"],
                          mode="patch_mean" if blk["scores"] else None,
                          bwd=False))
    if backward:
        calls += [dict(c, mode=None, bwd=True) for c in calls]
    return calls


def mae_window_calls(model: Dict, batch: int) -> List[Dict]:
    """The decoder's window-attention calls of one MAE train step, forward
    and backward: {'b', 'n', 'pairs', 'template_numel', 'bwd'}.  The banded
    form reads an (H, N, 128) band; the dense form an (H, N, N) template."""
    g = mae_geometry(model)
    n, h = g["dec"], model["decoder_num_heads"]
    cols = 128 if n > 256 else n
    one = dict(b=batch, n=n, pairs=h * n * g["window"],
               template_numel=h * n * cols)
    depth = model["decoder_depth"]
    return ([dict(one, bwd=False) for _ in range(depth)]
            + [dict(one, bwd=True) for _ in range(depth)])
