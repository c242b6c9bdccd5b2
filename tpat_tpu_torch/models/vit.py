"""Token-pruning audio ViT (port of ``tpat_tpu/models/vit.py``:
``PatchEmbed``, ``Mlp``, ``FusedLayerNorm``, ``PrunedAttention``, ``Block``
and ``AudioViT`` with its static, masked and hybrid forwards).

After the attention residual of a pruning block the ``ceil(keep_rate * P)``
highest-importance patch tokens are kept (extra tokens stay at the front,
kept tokens in descending importance) and the MLP runs on the reduced
sequence, so every width is static for a given keep-rate tuple.  The anneal
forwards carry the exact scheduled kept counts as a boolean token mask:
``forward_masked`` at full width, ``forward_hybrid`` inside bucket-level
widths, where the mask is a uniform prefix the prefix kernel consumes.

Module names equal the reference ``.pth`` keys (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``fc_norm``, ``head``), so a reference state dict loads
with ``strict=True``.

Precision follows the JAX package: parameters are f32 and are cast to the
compute dtype at use (flax's ``Dense(dtype=...)``), LayerNorm statistics run
in f32 with the output cast to the compute dtype, the residual stream is in
the compute dtype, and the head runs in f32.  With ``use_fused_layernorm``
every block's ``norm1`` and ``norm2`` is a ``FusedLayerNorm`` (the LayerNorm
kernels); ``fc_norm`` stays the plain ``LayerNorm``, as in the JAX model.

Training randomness (drop-path, 2D time/frequency masking) draws from the
``torch.Generator`` the caller passes, never from the global RNG.

Ported: the AudioMAE flavour (1 extra token, gap_fcnorm pooling), with
drop-path and 2D masking in training.  Not yet ported, and refused with an
error: the AST flavour (cls_dist pooling), ``custom_rank``, dropout
(``drop_rate`` > 0 in training; every reference config has 0), ``remat``,
and ``forward_masked``'s ``num_left_tables`` and intensity band.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpat_tpu_torch.config import ViTConfig, compose_kept_counts
from tpat_tpu_torch.models.pos_embed import sincos_2d
from tpat_tpu_torch.ops import pruning
from tpat_tpu_torch.ops.fast_gelu import gelu_poly
from tpat_tpu_torch.ops.attention import attention_with_scores
from tpat_tpu_torch.ops.layernorm import fused_layernorm
from tpat_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
    fused_qkv_attention_prefix,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ViTConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _need_generator(generator: Optional[torch.Generator], what: str):
    if generator is None:
        raise ValueError(
            f"{what} draws random numbers: pass a torch.Generator on the "
            "model's device as `generator`"
        )
    return generator


def drop_path(
    x: torch.Tensor, rate: float, training: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Stochastic depth on a residual branch (timm DropPath, ``vit.py:84-94``):
    each sample's branch is kept with probability 1 - rate and then divided
    by 1 - rate, or zeroed.  Off in eval and at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=_need_generator(generator, "drop-path"),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


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


class FusedLayerNorm(LayerNorm):
    """``LayerNorm`` through ``ops.layernorm.fused_layernorm`` (the
    counterpart of ``vit.py:132-162``): on the card its kernels, forward and
    backward, or an error; on the CPU their plain versions through the same
    autograd Function.  The output is cast to ``out_dtype``, as the JAX
    module casts the kernel's.  Parameter names stay ``weight``/``bias``, so
    the ``.pth`` keys are those of ``LayerNorm``.  The JAX module's backend
    check (the Pallas kernel on a TPU only, ``vit.py:149-153``) has no
    counterpart: the flag alone decides."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_layernorm(x, self.weight, self.bias, self.eps)
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
    attention; any other value takes the kernels (``ops/qkv_attention.py``),
    which launch on a CUDA tensor or raise for a geometry they do not take.
    The Hopper kernels take head_dim 80 natively, so ``'fused_padded'`` (a
    TPU lane-padding workaround) dispatches like ``'fused'``.

    ``token_mask`` ((B, P) bool) restricts attention to kept tokens; with
    ``prefix_len`` (a host int) the caller states that the mask keeps the
    first ``prefix_len`` patch tokens of every sample, and the kernel path
    takes ``fused_qkv_attention_prefix`` instead of the masked plain
    attention (``vit.py:217-247``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        c = cfg.embed_dim
        self.cfg = cfg
        self.qkv = Linear(c, 3 * c, bias=cfg.qkv_bias, compute_dtype=dt)
        self.proj = Linear(c, c, compute_dtype=dt)

    def forward(
        self,
        x: torch.Tensor,
        need_scores: bool,
        token_mask: Optional[torch.Tensor] = None,
        prefix_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        e = cfg.num_extra_tokens
        mode = cfg.importance if need_scores else None
        qkv = self.qkv(x)
        kernel = cfg.attention_impl != "xla"
        if token_mask is None:
            attend = fused_qkv_attention if kernel else fused_qkv_attention_plain
            out, scores = attend(qkv, cfg.num_heads, mode, e)
        elif kernel and prefix_len is not None:
            out, scores = fused_qkv_attention_prefix(
                qkv, e + prefix_len, cfg.num_heads, mode, e
            )
        else:
            b, n, c3 = qkv.shape
            q, k, v = (
                t.reshape(b, n, cfg.num_heads, -1).transpose(1, 2)
                for t in qkv.chunk(3, dim=-1)
            )
            out, scores = attention_with_scores(
                q, k, v, num_extra_tokens=e, importance=cfg.importance,
                token_mask=token_mask, need_scores=need_scores,
            )
            out = out.transpose(1, 2).reshape(b, n, c3 // 3)
        return self.proj(out), scores


class Block(nn.Module):
    """Pre-norm transformer block with post-attention token pruning
    (``vit.py:257-433``)."""

    def __init__(self, cfg: ViTConfig, drop_path_rate: float = 0.0):
        super().__init__()
        dt = compute_dtype(cfg)
        self.num_extra_tokens = cfg.num_extra_tokens
        self.drop_path_rate = drop_path_rate
        norm = FusedLayerNorm if cfg.use_fused_layernorm else LayerNorm
        self.norm1 = norm(cfg.embed_dim, cfg.layer_norm_eps, dt)
        self.attn = PrunedAttention(cfg)
        self.norm2 = norm(cfg.embed_dim, cfg.layer_norm_eps, dt)
        self.mlp = Mlp(cfg)

    def _residual(self, x, branch, generator):
        return x + drop_path(branch, self.drop_path_rate, self.training,
                             generator)

    def forward(
        self, x: torch.Tensor, keep_rate: float, extract_features: bool,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Static-shape path.  Returns (x, aux); aux may hold 'scores' and
        'topk_idx'."""
        e = self.num_extra_tokens
        p_in = x.shape[1] - e
        prune = keep_rate < 1.0
        attn_out, scores = self.attn(
            self.norm1(x), need_scores=prune or extract_features
        )
        x = self._residual(x, attn_out, generator)
        aux: Dict[str, torch.Tensor] = {}
        if extract_features and scores is not None:
            aux["scores"] = scores
        if prune:
            idx = pruning.topk_select(
                scores.detach(), pruning.num_left_tokens(keep_rate, p_in)
            )
            x = pruning.gather_tokens(x, idx, e)
            aux["topk_idx"] = idx
        return self._residual(x, self.mlp(self.norm2(x)), generator), aux

    def masked_call(
        self,
        x: torch.Tensor,
        token_mask: torch.Tensor,
        *,
        keep_rate: Optional[float],
        num_left: Optional[Union[int, torch.Tensor]] = None,
        bucket_k: Optional[int] = None,
        mask_is_full: bool = False,
        prefix_len: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked (anneal) path (``vit.py:350-433``).  ``keep_rate`` is None
        for a block that does not prune.  ``num_left`` is the exact kept
        count from the host (``engine.schedules.masked_kept_counts``); None
        takes the f32 ceil of ``pruning.masked_num_left`` per sample.

        ``bucket_k`` (hybrid anneal): after the block, gather the top
        ``bucket_k`` patch tokens by masked score (descending, ties to the
        lower index -- the order ``masked_refine`` ranks by), so the kept set
        becomes the prefix [0, num_left) of a static width.  ``mask_is_full``
        states that no block has refined the mask yet, so attention runs
        unmasked; ``prefix_len`` states that the mask is the uniform prefix
        [0, prefix_len).  Returns (x, refined token_mask)."""
        attn_out, scores = self.attn(
            self.norm1(x),
            need_scores=keep_rate is not None,
            token_mask=None if mask_is_full else token_mask,
            prefix_len=None if mask_is_full else prefix_len,
        )
        x = self._residual(x, attn_out, generator)

        if keep_rate is not None:
            scores = scores.detach()
            if num_left is None:
                num_left = pruning.masked_num_left(keep_rate, token_mask.sum(1))
            if bucket_k is not None:
                masked = scores.masked_fill(~token_mask, float("-inf"))
                idx = pruning.topk_select(masked, bucket_k)
                x = pruning.gather_tokens(x, idx, self.num_extra_tokens)
                if isinstance(num_left, torch.Tensor):
                    num_left = num_left[:, None]
                rank = torch.arange(bucket_k, device=x.device)
                token_mask = (rank[None, :] < num_left).expand(x.shape[0], -1)
            else:
                token_mask = pruning.masked_refine(scores, token_mask, num_left)

        x = self._residual(x, self.mlp(self.norm2(x)), generator)
        return x, token_mask


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch's xavier-uniform over ``w`` flattened to (out, in*...): bound
    sqrt(6 / (fan_in + fan_out)).  A Linear's (out, in) weight gives its
    own fans; a conv's (O, I, kh, kw) weight gives fan_in I*kh*kw and
    fan_out O, the JAX package's ``_conv_flat_xavier``
    (``models_mae.py:159-161``), not flax's conv fans."""
    bound = math.sqrt(6.0 / (w[0].numel() + w.shape[0]))
    return w.uniform_(-bound, bound, generator=generator)


def _check_ported(cfg: ViTConfig):
    if cfg.num_extra_tokens != 1 or cfg.pooling != "gap_fcnorm" or cfg.use_final_norm:
        raise NotImplementedError(
            "only the AudioMAE flavour (1 extra token, gap_fcnorm pooling, no "
            "final norm) is ported; the AST flavour is not yet"
        )
    if cfg.remat:
        raise NotImplementedError("remat (training) is not ported yet")


def mask2d_noise(
    batch: int, cfg: ViTConfig, generator: torch.Generator, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform noise over the time rows and the frequency columns of the
    patch grid, whose argsorts pick the tokens 2D masking keeps."""
    return (
        torch.rand((batch, cfg.grid_t), generator=generator, device=device),
        torch.rand((batch, cfg.grid_f), generator=generator, device=device),
    )


class AudioViT(nn.Module):
    """The token-pruning audio ViT: static, masked and hybrid forwards.

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
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(Block(cfg, float(r)) for r in dpr)
        self.fc_norm = LayerNorm(d, cfg.layer_norm_eps, compute_dtype(cfg))
        self.head = nn.Linear(d, cfg.num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Initialise like the JAX package: the weight matrices and the
        patch conv by ``cfg.dense_init`` (trunc-normal(0.02, +-2 std), or
        xavier-uniform with the conv flattened, ``vit.py::_kinit`` and
        ``_conv_flat_xavier``), trunc-normal(0.02) for the CLS token, zero
        biases, unit LayerNorm scales, trunc-normal(2e-5) for the head under
        either, and the fixed 2D sin-cos table for a frozen pos embed.
        (flax's default conv init is lecun-normal; weights cross between the
        packages through the state dict, never through the initialiser.)"""
        cfg = self.cfg

        def trunc(t, std):
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                if cfg.dense_init == "xavier_uniform":
                    xavier_uniform_(m.weight, generator)
                else:
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

    def embed_masked2d(
        self,
        x: torch.Tensor,
        mask_t_prob: float,
        mask_f_prob: float,
        noise: Tuple[torch.Tensor, torch.Tensor],
    ) -> torch.Tensor:
        """Structured 2D time/frequency token masking (``vit.py:691-736``):
        pos is added to the patches, then the ``int(T (1 - p_t))`` time rows
        with the smallest ``noise[0]`` are kept, then the ``int(F (1 - p_f))``
        frequency columns with the smallest ``noise[1]``, tokens staying in
        that permuted order; the CLS token gets pos row 0."""
        cfg = self.cfg
        tokens = self.patch_embed(x)
        pos = self.pos_embed.to(tokens.dtype)
        tokens = tokens + pos[:, 1:]
        b, d = tokens.shape[0], cfg.embed_dim
        t, f = cfg.grid_t, cfg.grid_f
        keep_t = int(t * (1 - mask_t_prob))
        keep_f = int(f * (1 - mask_f_prob))
        noise_t, noise_f = noise
        grid = tokens.reshape(b, t, f, d)
        ids_t = torch.argsort(noise_t, dim=1, stable=True)[:, :keep_t]
        grid = torch.gather(grid, 1, ids_t[:, :, None, None].expand(-1, -1, f, d))
        grid = grid.transpose(1, 2)  # (B, F, T', D)
        ids_f = torch.argsort(noise_f, dim=1, stable=True)[:, :keep_f]
        grid = torch.gather(
            grid, 1, ids_f[:, :, None, None].expand(-1, -1, keep_t, d)
        )
        tokens = grid.transpose(1, 2).reshape(b, keep_t * keep_f, d)
        cls = (self.cls_token.to(tokens.dtype) + pos[:, :1]).expand(b, -1, -1)
        return torch.cat([cls, tokens], dim=1)

    def pool_and_head(
        self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Mean over patch tokens (f32 accumulation, result in the token
        dtype; over kept tokens only, through ``masked_mean``, when
        ``token_mask`` is given), fc_norm, f32 head (``vit.py:603-616``)."""
        patches = x[:, self.cfg.num_extra_tokens:]
        if token_mask is not None:
            feat = pruning.masked_mean(patches, token_mask)
        else:
            feat = patches.float().mean(dim=1).to(x.dtype)
        return self.head(self.fc_norm(feat).float())

    def _check_training(self):
        if self.training and self.cfg.drop_rate > 0.0:
            raise NotImplementedError(
                "dropout is not ported: call .eval(), or set drop_rate to 0"
            )

    def forward(
        self,
        x: torch.Tensor,
        keep_rates: Optional[Sequence[float]] = None,
        *,
        extract_features: bool = False,
        custom_rank: Optional[str] = None,
        mask_t_prob: float = 0.0,
        mask_f_prob: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        """Static-shape forward (``vit.py:626-689``).  x: (B, 1, T, F).

        keep_rates: per-block floats (len == depth); None uses the config's
        baked rates.  ``mask_t_prob``/``mask_f_prob`` > 0 embed through 2D
        masking, with noise drawn from ``generator``, which drop-path in
        training draws from too.  Returns logits (B, num_classes) f32, or
        (logits, features) when ``extract_features``: 'mel',
        'block-{i}.attn_score' and 'block-{i}.topk_idx'.
        """
        cfg = self.cfg
        if custom_rank is not None:
            raise NotImplementedError("custom_rank is not ported yet")
        self._check_training()
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
        if mask_t_prob > 0.0 or mask_f_prob > 0.0:
            gen = _need_generator(generator, "2D masking")
            noise = mask2d_noise(x.shape[0], cfg, gen, x.device)
            tokens = self.embed_masked2d(x, mask_t_prob, mask_f_prob, noise)
        else:
            tokens = self.embed(x)
        for i, blk in enumerate(self.blocks):
            tokens, aux = blk(tokens, keep_rates[i], extract_features, generator)
            if extract_features:
                if "scores" in aux:
                    features[f"block-{i}.attn_score"] = aux["scores"]
                if "topk_idx" in aux:
                    features[f"block-{i}.topk_idx"] = aux["topk_idx"]
        logits = self.pool_and_head(tokens)
        if extract_features:
            return logits, features
        return logits

    def forward_masked(
        self,
        x: torch.Tensor,
        keep_rates: Sequence[float],
        *,
        num_left: Optional[Sequence[int]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Full-width forward with per-block keep rates carried as a token
        mask (``vit.py:742-833``, without the intensity band and
        ``num_left_tables``).  ``num_left``: the exact per-block kept counts
        from ``engine.schedules.masked_kept_counts``; None takes the f32 ceil
        per sample.  Entries at blocks outside ``drop_loc`` are ignored."""
        cfg = self.cfg
        self._check_training()
        tokens = self.embed(x)
        token_mask = pruning.full_token_mask(x.shape[0], cfg.num_patches, x.device)
        first = min(cfg.drop_loc) if cfg.drop_loc else cfg.depth
        for i, blk in enumerate(self.blocks):
            drop = i in cfg.drop_loc
            tokens, token_mask = blk.masked_call(
                tokens, token_mask,
                keep_rate=float(keep_rates[i]) if drop else None,
                num_left=num_left[i] if drop and num_left is not None else None,
                mask_is_full=i <= first,
                generator=generator,
            )
        return self.pool_and_head(tokens, token_mask)

    def forward_hybrid(
        self,
        x: torch.Tensor,
        keep_rates: Sequence[float],
        *,
        num_left: Sequence[int],
        bucket_rates: Sequence[float],
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Hybrid anneal forward (``vit.py:835-897``): each pruning block
        gathers to the static width of ``bucket_rates`` (the scheduled rates
        snapped up, ``engine.schedules.bucket_keep_rates``) while the exact
        kept counts ``num_left`` ride inside it as a prefix mask.  After the
        first drop block every attention takes the prefix kernel with
        kv_valid = extra + the last drop block's kept count."""
        cfg = self.cfg
        self._check_training()
        bucket_rates = tuple(float(r) for r in bucket_rates)
        if len(bucket_rates) != cfg.depth:
            raise ValueError(
                f"bucket_rates must have length {cfg.depth}, got "
                f"{len(bucket_rates)}"
            )
        bucket_counts = compose_kept_counts(bucket_rates, cfg.num_patches)
        tokens = self.embed(x)
        token_mask = pruning.full_token_mask(x.shape[0], cfg.num_patches, x.device)
        first = min(cfg.drop_loc) if cfg.drop_loc else cfg.depth
        prefix = None
        for i, blk in enumerate(self.blocks):
            drop = i in cfg.drop_loc
            tokens, token_mask = blk.masked_call(
                tokens, token_mask,
                keep_rate=float(keep_rates[i]) if drop else None,
                num_left=int(num_left[i]) if drop else None,
                bucket_k=bucket_counts[i] if drop else None,
                mask_is_full=i <= first,
                prefix_len=prefix,
                generator=generator,
            )
            if drop:
                prefix = int(num_left[i])
        return self.pool_and_head(tokens, token_mask)
