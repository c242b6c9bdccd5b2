"""Token-pruning audio ViT, static eval path (port of
``tpat_tpu/models/vit.py``: ``PatchEmbed``, ``Mlp``, ``FusedLayerNorm``,
``PrunedAttention``, ``Block._call_impl`` and ``AudioViT.__call__``).

After the attention residual of a pruning block the ``ceil(keep_rate * P)``
highest-importance patch tokens are kept (extra tokens stay at the front,
kept tokens in descending importance) and the MLP runs on the reduced
sequence, so every width is static for a given keep-rate tuple.

Module names equal the reference ``.pth`` keys (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``fc_norm``, ``head``), so a reference state dict loads
with ``strict=True``.

Precision follows the JAX package: parameters are f32 and are cast to the
compute dtype at use (flax's ``Dense(dtype=...)``), LayerNorm statistics run
in f32 with the output cast to the compute dtype, the residual stream is in
the compute dtype, and the head runs in f32.

Ported: the AudioMAE flavour (1 extra token, gap_fcnorm pooling).  Not yet
ported, and refused with an error: the AST flavour (cls_dist pooling),
``custom_rank``, 2D time/frequency masking, dropout and drop-path,
``remat``, and the masked and hybrid anneal forwards.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.models.pos_embed import sincos_2d
from tpat_tpu_torch.ops import pruning
from tpat_tpu_torch.ops.fast_gelu import gelu_poly
from tpat_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ViTConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


class Linear(nn.Linear):
    """``nn.Linear`` whose f32 parameters are cast to ``compute_dtype`` at
    use, as flax's ``Dense(dtype=...)`` casts its kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and f32 parameters; the output is cast
    to ``out_dtype`` (``vit.py:157-162``)."""

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xc = xf - xf.mean(dim=-1, keepdim=True)
        var = (xc * xc).mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.out_dtype)


class PatchEmbed(nn.Module):
    """Patchify conv (VALID), row-major token flatten: (B, C, T, F) ->
    (B, grid_t * grid_f, D) in the compute dtype."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(
            cfg.in_chans, cfg.embed_dim, cfg.patch_size, stride=cfg.stride
        )
        self.compute_dtype = compute_dtype(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.conv2d(
            x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt),
            stride=self.proj.stride,
        )
        return x.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2.  Exact erf GELU, or the polynomial GELU when the
    activation is bf16 under ``gelu_impl='auto'`` (``vit.py:97-129``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = Linear(cfg.embed_dim, hidden, compute_dtype=dt)
        self.fc2 = Linear(hidden, cfg.embed_dim, compute_dtype=dt)
        self.use_poly = cfg.gelu_impl == "poly" or (
            cfg.gelu_impl == "auto" and dt == torch.bfloat16
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = gelu_poly(x) if self.use_poly else F.gelu(x)
        return self.fc2(x)


class PrunedAttention(nn.Module):
    """QKV self-attention emitting the pruning importance scores
    (``vit.py:165-254``).  ``attention_impl='xla'`` takes the plain
    ``fused_qkv_attention_plain``; any other value takes
    ``fused_qkv_attention`` (``ops/qkv_attention.py``), which launches the
    kernel on a CUDA tensor or raises for a geometry it does not take.  The
    Hopper kernel takes head_dim 80 natively, so ``'fused_padded'`` (a TPU
    lane-padding workaround) dispatches like ``'fused'``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        c = cfg.embed_dim
        self.cfg = cfg
        self.qkv = Linear(c, 3 * c, bias=cfg.qkv_bias, compute_dtype=dt)
        self.proj = Linear(c, c, compute_dtype=dt)

    def forward(
        self, x: torch.Tensor, need_scores: bool
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        mode = cfg.importance if need_scores else None
        attend = (fused_qkv_attention_plain if cfg.attention_impl == "xla"
                  else fused_qkv_attention)
        out, scores = attend(
            self.qkv(x), cfg.num_heads, mode, cfg.num_extra_tokens
        )
        return self.proj(out), scores


class Block(nn.Module):
    """Pre-norm transformer block with post-attention token pruning
    (``vit.py:307-348``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.num_extra_tokens = cfg.num_extra_tokens
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, dt)
        self.attn = PrunedAttention(cfg)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, dt)
        self.mlp = Mlp(cfg)

    def forward(
        self, x: torch.Tensor, keep_rate: float, extract_features: bool
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (x, aux); aux may hold 'scores' and 'topk_idx'."""
        e = self.num_extra_tokens
        p_in = x.shape[1] - e
        prune = keep_rate < 1.0
        attn_out, scores = self.attn(
            self.norm1(x), need_scores=prune or extract_features
        )
        x = x + attn_out
        aux: Dict[str, torch.Tensor] = {}
        if extract_features and scores is not None:
            aux["scores"] = scores
        if prune:
            idx = pruning.topk_select(
                scores, pruning.num_left_tokens(keep_rate, p_in)
            )
            x = pruning.gather_tokens(x, idx, e)
            aux["topk_idx"] = idx
        return x + self.mlp(self.norm2(x)), aux


def _check_ported(cfg: ViTConfig):
    if cfg.num_extra_tokens != 1 or cfg.pooling != "gap_fcnorm" or cfg.use_final_norm:
        raise NotImplementedError(
            "only the AudioMAE flavour (1 extra token, gap_fcnorm pooling, no "
            "final norm) is ported; the AST flavour is not yet"
        )
    if cfg.remat:
        raise NotImplementedError("remat (training) is not ported yet")


class AudioViT(nn.Module):
    """The token-pruning audio ViT, static eval path.

    Parameters are created on the CPU, initialised from ``generator`` (a
    fresh ``torch.Generator`` seeded 0 when None) and then moved to
    ``device``.
    """

    def __init__(
        self,
        cfg: ViTConfig,
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + cfg.num_extra_tokens, d),
            requires_grad=not cfg.frozen_pos_embed,
        )
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.fc_norm = LayerNorm(d, cfg.layer_norm_eps, compute_dtype(cfg))
        self.head = nn.Linear(d, cfg.num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Initialise like the JAX package: trunc-normal(0.02, +-2 std) for
        the weight matrices, the patch conv and the CLS token, zero biases,
        unit LayerNorm scales, trunc-normal(2e-5) for the head, and the
        fixed 2D sin-cos table for a frozen pos embed.  (flax's default conv
        init is lecun-normal; weights cross between the packages through the
        state dict, never through the initialiser.)"""
        cfg = self.cfg

        def trunc(t, std):
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                trunc(m.weight, 0.02)
                if m.bias is not None:
                    m.bias.zero_()
        trunc(self.head.weight, 2e-5)
        trunc(self.cls_token, 0.02)
        if cfg.frozen_pos_embed:
            grid = sincos_2d(cfg.embed_dim, (cfg.grid_t, cfg.grid_f))
            table = np.concatenate(
                [np.zeros((cfg.num_extra_tokens, cfg.embed_dim)), grid]
            ).astype(np.float32)
            self.pos_embed.copy_(torch.from_numpy(table)[None])
        else:
            trunc(self.pos_embed, 0.02)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Patchify, prepend CLS, add the positional table (pos and CLS
        cast to the token dtype, ``vit.py:563-601``)."""
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        return torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)

    def pool_and_head(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over patch tokens (f32 accumulation, result in the token
        dtype), fc_norm, f32 head (``vit.py:603-616``)."""
        feat = x[:, self.cfg.num_extra_tokens:].float().mean(dim=1).to(x.dtype)
        return self.head(self.fc_norm(feat).float())

    def forward(
        self,
        x: torch.Tensor,
        keep_rates: Optional[Sequence[float]] = None,
        *,
        extract_features: bool = False,
        custom_rank: Optional[str] = None,
        mask_t_prob: float = 0.0,
        mask_f_prob: float = 0.0,
    ):
        """Static-shape forward (``vit.py:626-689``).  x: (B, 1, T, F).

        keep_rates: per-block floats (len == depth); None uses the config's
        baked rates.  Returns logits (B, num_classes) f32, or (logits,
        features) when ``extract_features``: 'mel', 'block-{i}.attn_score'
        and 'block-{i}.topk_idx'.
        """
        cfg = self.cfg
        if custom_rank is not None:
            raise NotImplementedError("custom_rank is not ported yet")
        if mask_t_prob > 0.0 or mask_f_prob > 0.0:
            raise NotImplementedError(
                "2D time/frequency token masking is not ported yet"
            )
        if self.training and (cfg.drop_rate > 0.0 or cfg.drop_path_rate > 0.0):
            raise NotImplementedError(
                "dropout and drop-path are not ported yet: call .eval(), or "
                "set drop_rate and drop_path_rate to 0"
            )
        if keep_rates is None:
            keep_rates = cfg.keep_rates
        keep_rates = tuple(float(r) for r in keep_rates)
        if len(keep_rates) != cfg.depth:
            raise ValueError(
                f"keep_rates must have length {cfg.depth}, got {len(keep_rates)}"
            )

        features: Dict[str, torch.Tensor] = {}
        if extract_features:
            features["mel"] = x
        tokens = self.embed(x)
        for i, blk in enumerate(self.blocks):
            tokens, aux = blk(tokens, keep_rates[i], extract_features)
            if extract_features:
                if "scores" in aux:
                    features[f"block-{i}.attn_score"] = aux["scores"]
                if "topk_idx" in aux:
                    features[f"block-{i}.topk_idx"] = aux["topk_idx"]
        logits = self.pool_and_head(tokens)
        if extract_features:
            return logits, features
        return logits
