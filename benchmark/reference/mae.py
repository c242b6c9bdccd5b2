"""Plain PyTorch reference of the AudioMAE pretraining model with the
shifted-window decoder (``mae_vit_base_dec512d8b``, AudioMAE
``models_mae.py`` with timm's ``SwinTransformerV2CrBlock`` decoder), in
float32 with TF32 off, imported from nothing of the program.

- Encoder: patch embed, fixed sin-cos pos embed, 2D masking (whole time
  rows and frequency columns of the patch grid; kept tokens in grid order,
  by the offset argsort), CLS, ViT-B blocks (``vit.py``'s), LayerNorm.
- Decoder: a linear to 512, mask tokens, the de-shuffle, the fixed pos
  embed, CLS dropped, 16 swin-v2-cr blocks over the (T, F) grid in (4, 4)
  windows, shifted by (2, 0) every other block: scaled cosine attention
  (per-head logit scale clamped at log 100), a log-spaced relative-position
  bias from a 2-layer meta-MLP (hidden dropout 0.125 in training), the
  -100 mask across shift regions, res-post-norm residuals; LayerNorm and
  the f32 patch prediction.
- Loss: the per-patch-normalised MSE over masked patches.

Draws: the masking noise (time, then frequency), then each decoder block's
meta-MLP dropout in block order, from one generator per step.  The
attention is computed window by window (roll, partition, attend, reverse),
not as the program's masked whole-grid form.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.work import mae_geometry, vit_grid
from benchmark.reference.vit import _attention, _mlp, layer_norm, patchify

META_DROPOUT = 0.125
META_HIDDEN = 384


def param_specs(model: Dict) -> list:
    c, dc = model["embed_dim"], model["decoder_embed_dim"]
    p = model.get("patch_size", 16)
    gt, gf = vit_grid(model)
    dh = model["decoder_num_heads"]
    specs = [("patch_embed.proj.weight", (c, 1, p, p), "normal"),
             ("patch_embed.proj.bias", (c,), "normal"),
             ("cls_token", (1, 1, c), "normal"),
             ("pos_embed", (1, 1 + gt * gf, c), ("sincos", (gt, gf)))]
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        specs += _block_specs(b, c, 4 * c, qkv_bias=True)
    specs += [("norm.weight", (c,), "one"), ("norm.bias", (c,), "normal"),
              ("decoder_embed.weight", (dc, c), "normal"),
              ("decoder_embed.bias", (dc,), "normal"),
              ("mask_token", (1, 1, dc), "normal"),
              ("decoder_pos_embed", (1, 1 + gt * gf, dc), ("sincos", (gt, gf)))]
    for i in range(model["decoder_depth"]):
        b = f"decoder_blocks.{i}."
        specs += _block_specs(b, dc, 4 * dc, qkv_bias=True)
        specs += [(b + "attn.logit_scale", (dh,), "log10"),
                  (b + "attn.meta_mlp.fc1.weight", (META_HIDDEN, 2), "normal"),
                  (b + "attn.meta_mlp.fc1.bias", (META_HIDDEN,), "normal"),
                  (b + "attn.meta_mlp.fc2.weight", (dh, META_HIDDEN), "normal"),
                  (b + "attn.meta_mlp.fc2.bias", (dh,), "normal")]
    specs += [("decoder_norm.weight", (dc,), "one"),
              ("decoder_norm.bias", (dc,), "normal"),
              ("decoder_pred.weight", (p * p, dc), "normal"),
              ("decoder_pred.bias", (p * p,), "normal")]
    return specs


def _block_specs(b, c, hid, qkv_bias):
    return [(b + "norm1.weight", (c,), "one"), (b + "norm1.bias", (c,), "normal"),
            (b + "attn.qkv.weight", (3 * c, c), "normal"),
            (b + "attn.qkv.bias", (3 * c,), "normal"),
            (b + "attn.proj.weight", (c, c), "normal"),
            (b + "attn.proj.bias", (c,), "normal"),
            (b + "norm2.weight", (c,), "one"), (b + "norm2.bias", (c,), "normal"),
            (b + "mlp.fc1.weight", (hid, c), "normal"),
            (b + "mlp.fc1.bias", (hid,), "normal"),
            (b + "mlp.fc2.weight", (c, hid), "normal"),
            (b + "mlp.fc2.bias", (c,), "normal")]


FROZEN = ("pos_embed", "decoder_pos_embed")


def relative_log(window: Tuple[int, int]) -> np.ndarray:
    """(L*L, 2) log-spaced coordinate differences of the window's (query,
    key) pairs, row-major: sign(d) log(1 + |d|)."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).reshape(-1, 2).astype(np.float32)
    return np.sign(rel) * np.log1p(np.abs(rel))


def shift_mask(grid, window, shift) -> np.ndarray:
    """(windows, L, L): -100 between tokens of different shift regions."""
    (t, f), (wh, ww), (st, sf) = grid, window, shift
    img = np.zeros((t, f), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -st), slice(-st, None)):
        for ws in (slice(0, -ww), slice(-ww, -sf), slice(-sf, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(t // wh, wh, f // ww, ww).transpose(0, 2, 1, 3)
    win = win.reshape(-1, wh * ww)
    return np.where(win[:, None, :] != win[:, :, None], -100.0,
                    0.0).astype(np.float32)


def draws(model: Dict, batch: int, gen: torch.Generator, device,
          train: bool) -> Dict:
    """The step's masking noise and each decoder block's meta-MLP dropout
    keep mask, in the order the model consumes them."""
    gt, gf = vit_grid(model)
    noise = (torch.rand((batch, gt), generator=gen, device=device),
             torch.rand((batch, gf), generator=gen, device=device))
    wh, ww = model.get("window_size", (4, 4))
    meta = []
    for _ in range(model["decoder_depth"]):
        if train:
            u = torch.rand(((wh * ww) ** 2, META_HIDDEN), generator=gen,
                           device=device)
            meta.append(u < 1.0 - META_DROPOUT)
        else:
            meta.append(None)
    return {"noise": noise, "meta": meta}


def mask_2d(model: Dict, noise, batch: int, device):
    """(kept ids (B, V) in grid order, mask (B, L) 1 = masked, restore
    ids (B, L))."""
    gt, gf = vit_grid(model)
    kt = int(gt * (1 - model["mask_t_prob"]))
    kf = int(gf * (1 - model["mask_f_prob"]))

    def axis(n_, size, keep):
        restore = torch.argsort(torch.argsort(n_, dim=1, stable=True), dim=1,
                                stable=True)
        m = torch.ones((batch, size), device=device)
        m[:, :keep] = 0
        return torch.gather(m, 1, restore)

    mt = axis(noise[0], gt, kt)[:, :, None].expand(batch, gt, gf)
    mf = axis(noise[1], gf, kf)[:, None, :].expand(batch, gt, gf)
    mask = (1 - (1 - mt) * (1 - mf)).reshape(batch, gt * gf)
    offset = float(max(999, gt * gf))
    order = torch.arange(gt * gf, dtype=torch.float32, device=device)
    order = torch.argsort(order[None, :] + offset * mask, dim=1, stable=True)
    return order[:, :kt * kf], mask, torch.argsort(order, dim=1, stable=True)


def _rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _swin_block(P, pre, x, model, shift, meta_keep, prec):
    gt, gf = vit_grid(model)
    wh, ww = model.get("window_size", (4, 4))
    heads = model["decoder_num_heads"]
    b, l, d = x.shape
    hd = d // heads
    h = x.reshape(b, gt, gf, d)
    st, sf = shift
    if st or sf:
        h = torch.roll(h, shifts=(-st, -sf), dims=(1, 2))
    h = h.reshape(b, gt // wh, wh, gf // ww, ww, d).permute(0, 1, 3, 2, 4, 5)
    h = h.reshape(-1, wh * ww, d)
    a = pre + "attn."
    qkv = prec.linear(h, P[a + "qkv.weight"], P[a + "qkv.bias"])
    q, k, v = qkv.reshape(h.shape[0], wh * ww, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    scale = torch.exp(torch.clamp(P[a + "logit_scale"], max=math.log(100.0)))
    rel = torch.from_numpy(relative_log((wh, ww))).to(x.device)
    hid = F.relu(F.linear(rel, P[a + "meta_mlp.fc1.weight"],
                          P[a + "meta_mlp.fc1.bias"]))
    if meta_keep is not None:
        hid = torch.where(meta_keep, hid / (1.0 - META_DROPOUT),
                          torch.zeros_like(hid))
    bias = F.linear(hid, P[a + "meta_mlp.fc2.weight"], P[a + "meta_mlp.fc2.bias"])
    bias = bias.transpose(0, 1).reshape(heads, wh * ww, wh * ww)
    logits = prec.matmul(q, k.transpose(-1, -2)) * scale[None, :, None, None]
    logits = logits + bias[None]
    if st or sf:
        m = torch.from_numpy(shift_mask((gt, gf), (wh, ww), shift)).to(x.device)
        nw = m.shape[0]
        logits = (logits.reshape(b, nw, heads, wh * ww, wh * ww)
                  + m[None, :, None]).reshape(-1, heads, wh * ww, wh * ww)
    out = prec.matmul(torch.softmax(logits, dim=-1), v)
    out = out.transpose(1, 2).reshape(-1, wh * ww, d)
    out = prec.linear(out, P[a + "proj.weight"], P[a + "proj.bias"])
    out = out.reshape(b, gt // wh, gf // ww, wh, ww, d).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, gt, gf, d)
    if st or sf:
        out = torch.roll(out, shifts=(st, sf), dims=(1, 2))
    x = x + layer_norm(out.reshape(b, l, d), P[pre + "norm1.weight"],
                       P[pre + "norm1.bias"])
    return x + layer_norm(_mlp(P, pre + "mlp.", x, prec),
                          P[pre + "norm2.weight"], P[pre + "norm2.bias"])


def loss_sum(P: Dict, model: Dict, x: torch.Tensor, draw: Dict, prec
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed masked per-patch MSE of these rows, their masked-patch
    count); the step's loss is the sum over all rows over the count."""
    c, dc = model["embed_dim"], model["decoder_embed_dim"]
    p = model.get("patch_size", 16)
    b = x.shape[0]
    patches = patchify(x, p)
    tokens = prec.linear(patches, P["patch_embed.proj.weight"].reshape(c, -1),
                         P["patch_embed.proj.bias"])
    pos = P["pos_embed"][0]
    tokens = tokens + pos[1:]
    keep, mask, restore = mask_2d(model, draw["noise"], b, x.device)
    tokens = _rows(tokens, keep)
    cls = (P["cls_token"][0] + pos[:1]).expand(b, -1, -1)
    h = torch.cat([cls, tokens], dim=1)
    for i in range(model["depth"]):
        pre = f"blocks.{i}."
        a, _ = _attention(P, pre + "attn.",
                          layer_norm(h, P[pre + "norm1.weight"],
                                     P[pre + "norm1.bias"]),
                          model["num_heads"], prec)
        h = h + a
        h = h + _mlp(P, pre + "mlp.", layer_norm(h, P[pre + "norm2.weight"],
                                                 P[pre + "norm2.bias"]), prec)
    h = layer_norm(h, P["norm.weight"], P["norm.bias"])
    h = prec.linear(h, P["decoder_embed.weight"], P["decoder_embed.bias"])
    g = mae_geometry(model)
    n_mask = g["dec"] - (h.shape[1] - 1)
    h = torch.cat([h[:, 1:], P["mask_token"].expand(b, n_mask, dc)], dim=1)
    h = _rows(h, restore) + P["decoder_pos_embed"][0, 1:]
    for i in range(model["decoder_depth"]):
        h = _swin_block(P, f"decoder_blocks.{i}.", h, model,
                        (0, 0) if i % 2 == 0 else (2, 0), draw["meta"][i], prec)
    h = layer_norm(h, P["decoder_norm.weight"], P["decoder_norm.bias"])
    pred = prec.linear(h, P["decoder_pred.weight"], P["decoder_pred.bias"])
    target = patchify(x, p)
    if model.get("norm_pix_loss"):
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, correction=1)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(-1)
    return (per_patch * mask).sum(), mask.sum()
