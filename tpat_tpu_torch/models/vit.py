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
mlp.fc1,mlp.fc2}``, then ``fc_norm`` and ``head`` for AudioMAE, or
``dist_token``, ``norm`` and ``mlp_head.{0,1}`` for AST, whose reference
``.pth`` holds the same keys under ``module.v.`` and ``module.``), so a
reference state dict loads with ``strict=True``.

Precision follows the JAX package: parameters are f32 and are cast to the
compute dtype at use (flax's ``Dense(dtype=...)``), LayerNorm statistics run
in f32 with the output cast to the compute dtype, the residual stream is in
the compute dtype, and the head runs in f32.  With ``use_fused_layernorm``
every block's ``norm1`` and ``norm2`` is a ``FusedLayerNorm`` (the LayerNorm
kernels); ``fc_norm`` stays the plain ``LayerNorm``, as in the JAX model.

Training randomness (drop-path, dropout, 2D time/frequency masking) draws
from the ``torch.Generator`` the caller passes, never from the global RNG.
Under data parallelism every mask with a batch axis is drawn at the global
batch's shape and cut to the rank's rows (``parallel/mesh.py``), so two
ranks draw what one process draws for the same global batch.
Dropout (``drop_rate``) sits where the JAX model has it (``vit.py:125,
128, 253, 494``): after the embedding (``pos_drop``), after the attention's
``proj``, and after the MLP's GELU and ``fc2``; ``attn_drop_rate`` stays
refused by the config, as in JAX.  A block draws all its keep masks before
it computes (``Block.draw``), in forward order, and takes them as inputs,
so that ``remat`` can recompute a block: ``torch.utils.checkpoint`` restores
the global RNG state on recompute but not an explicit generator.  ``remat``
checkpoints each block of the static forward in training, as the JAX model
wraps ``Block.__call__`` in ``nn.remat`` (``vit.py:516-519``); the masked and
hybrid forwards are not rematerialised, in JAX either.

Ported: both flavours, AudioMAE (1 extra token, patch-mean importance,
gap_fcnorm pooling) and AST (CLS and distillation tokens, CLS-row
importance, a final norm, cls_dist pooling), with drop-path, dropout and 2D
masking (AudioMAE only, as in JAX) in training; the custom-rank ablation
(``custom_rank``: per-patch mel mean or std in place of the attention
importance), ``forward_masked``'s intensity band with its host-double
kept-count tables, and ``remat``.

Tensor parallelism (``parallel/sharding.py``): ``shard_model_`` cuts a
built model in place over a mesh's model axis.  Each block's ``qkv`` and
``fc1`` become column-parallel (``qkv`` cut by heads), its ``proj`` and
``fc2`` row-parallel, each followed by the model group's all-reduce and
then the replicated bias; the attention runs the plain path over the
rank's heads, and its importance scores, each rank's mean over its own
heads, are averaged over the model group before any top-k, so every rank
keeps the same tokens.  Every other draw is replicated across the model
group; fc1's dropout is drawn at the full hidden width and cut to the
rank's columns.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpat_tpu_torch.config import ViTConfig, compose_kept_counts
from tpat_tpu_torch.models.pos_embed import sincos_2d
from tpat_tpu_torch.ops import pruning
from tpat_tpu_torch.ops.fast_gelu import gelu_poly
from tpat_tpu_torch.ops.attention import attention_with_scores
from tpat_tpu_torch.ops.layernorm import fused_layernorm
from tpat_tpu_torch.parallel import sharding
from tpat_tpu_torch.parallel.mesh import rand_rows
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
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return _apply_keep(x, _keep_mask(shape, rate, generator, x.device,
                                     "drop-path"), rate)


def _keep_mask(
    shape, rate: float, generator: Optional[torch.Generator], device, what: str,
) -> Optional[torch.Tensor]:
    """A keep mask of ``shape``, True with probability 1 - rate, drawn from
    ``generator``; None at rate 0 (nothing drawn)."""
    if rate == 0.0:
        return None
    u = rand_rows(shape, _need_generator(generator, what), device)
    return u < 1.0 - rate


def _apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor],
                rate: float) -> torch.Tensor:
    """x / (1 - rate) where ``keep``, else 0 (flax's ``nn.Dropout`` and
    timm's DropPath); x itself where ``keep`` is None."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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


class _ParallelLinear(Linear):
    """A ``Linear`` holding this rank's cut of a tensor-parallel weight
    (``parallel/sharding.py``), its collectives over ``group``."""

    def __init__(self, lin: Linear, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], group):
        nn.Module.__init__(self)
        self.out_features, self.in_features = weight.shape
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.compute_dtype = lin.compute_dtype
        self.group = group


class ColumnParallelLinear(_ParallelLinear):
    """Rows of the weight and the bias cut: f, then the local product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(sharding.copy_to_model(x, self.group))


class RowParallelLinear(_ParallelLinear):
    """Columns of the weight cut: the local product, g (the sum over the
    model group), then the replicated bias, added once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return sharding.reduce_from_model(y, self.group) + self.bias.to(dt)


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
    """fc1 -> GELU -> dropout -> fc2 -> dropout.  Exact erf GELU, or the
    polynomial GELU when the activation is bf16 under ``gelu_impl='auto'``
    (``vit.py:97-129``).  The dropouts apply the keep masks the caller
    passes (``Block.draw``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.hidden = hidden
        self.cols = slice(None)  # this rank's hidden columns
        self.fc1 = Linear(cfg.embed_dim, hidden, compute_dtype=dt)
        self.fc2 = Linear(hidden, cfg.embed_dim, compute_dtype=dt)
        self.use_poly = cfg.gelu_impl == "poly" or (
            cfg.gelu_impl == "auto" and dt == torch.bfloat16
        )
        self.drop_rate = cfg.drop_rate

    def forward(self, x: torch.Tensor, keep1: Optional[torch.Tensor] = None,
                keep2: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fc1(x)
        x = gelu_poly(x) if self.use_poly else F.gelu(x)
        x = _apply_keep(x, keep1, self.drop_rate)
        return _apply_keep(self.fc2(x), keep2, self.drop_rate)


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
    attention (``vit.py:217-247``).  ``proj_keep`` is the dropout mask of
    ``proj``'s output."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        c = cfg.embed_dim
        self.cfg = cfg
        self.qkv = Linear(c, 3 * c, bias=cfg.qkv_bias, compute_dtype=dt)
        self.proj = Linear(c, c, compute_dtype=dt)
        self.num_heads = cfg.num_heads  # this rank's heads
        self.model_group, self.tp = None, 1

    def forward(
        self,
        x: torch.Tensor,
        need_scores: bool,
        token_mask: Optional[torch.Tensor] = None,
        prefix_len: Optional[int] = None,
        proj_keep: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        e = cfg.num_extra_tokens
        mode = cfg.importance if need_scores else None
        qkv = self.qkv(x)
        kernel = cfg.attention_impl != "xla"
        if token_mask is None:
            attend = fused_qkv_attention if kernel else fused_qkv_attention_plain
            out, scores = attend(qkv, self.num_heads, mode, e)
        elif kernel and prefix_len is not None:
            out, scores = fused_qkv_attention_prefix(
                qkv, e + prefix_len, self.num_heads, mode, e
            )
        else:
            b, n, c3 = qkv.shape
            q, k, v = (
                t.reshape(b, n, self.num_heads, -1).transpose(1, 2)
                for t in qkv.chunk(3, dim=-1)
            )
            out, scores = attention_with_scores(
                q, k, v, num_extra_tokens=e, importance=cfg.importance,
                token_mask=token_mask, need_scores=need_scores,
            )
            out = out.transpose(1, 2).reshape(b, n, c3 // 3)
        if scores is not None and self.model_group is not None:
            scores = sharding.model_mean(scores, self.model_group, self.tp)
        return _apply_keep(self.proj(out), proj_keep, cfg.drop_rate), scores


class Block(nn.Module):
    """Pre-norm transformer block with post-attention token pruning
    (``vit.py:257-433``)."""

    def __init__(self, cfg: ViTConfig, drop_path_rate: float = 0.0):
        super().__init__()
        dt = compute_dtype(cfg)
        self.num_extra_tokens = cfg.num_extra_tokens
        self.drop_path_rate = drop_path_rate
        self.drop_rate = cfg.drop_rate
        self.remat = cfg.remat
        norm = FusedLayerNorm if cfg.use_fused_layernorm else LayerNorm
        self.norm1 = norm(cfg.embed_dim, cfg.layer_norm_eps, dt)
        self.attn = PrunedAttention(cfg)
        self.norm2 = norm(cfg.embed_dim, cfg.layer_norm_eps, dt)
        self.mlp = Mlp(cfg)

    def draw(
        self, batch: int, n_attn: int, n_mlp: int, device,
        generator: Optional[torch.Generator],
    ) -> Dict[str, Optional[torch.Tensor]]:
        """The block's keep masks, drawn in forward order: the attention
        proj's dropout ((B, n_attn, D)), the attention branch's drop-path
        ((B, 1, 1)), the MLP's two dropouts ((B, n_mlp, hidden) and (B,
        n_mlp, D)) and the MLP branch's drop-path; None where the rate is 0
        and all None in eval.  Under a model axis fc1's mask is drawn at
        the full hidden width and cut to the rank's columns."""
        if not self.training:
            return dict.fromkeys(("proj", "path1", "fc1", "fc2", "path2"))
        d = self.mlp.fc2.out_features
        dr, pr = self.drop_rate, self.drop_path_rate

        def mask(shape, rate, what):
            return _keep_mask(shape, rate, generator, device, what)

        noise = {
            "proj": mask((batch, n_attn, d), dr, "dropout"),
            "path1": mask((batch, 1, 1), pr, "drop-path"),
            "fc1": mask((batch, n_mlp, self.mlp.hidden), dr, "dropout"),
            "fc2": mask((batch, n_mlp, d), dr, "dropout"),
            "path2": mask((batch, 1, 1), pr, "drop-path"),
        }
        if noise["fc1"] is not None:
            noise["fc1"] = noise["fc1"][..., self.mlp.cols]
        return noise

    def _attention(self, x, noise, **kw):
        attn_out, scores = self.attn(self.norm1(x), proj_keep=noise["proj"], **kw)
        return x + _apply_keep(attn_out, noise["path1"], self.drop_path_rate), scores

    def _mlp(self, x, noise):
        branch = self.mlp(self.norm2(x), noise["fc1"], noise["fc2"])
        return x + _apply_keep(branch, noise["path2"], self.drop_path_rate)

    def forward(
        self, x: torch.Tensor, keep_rate: float, extract_features: bool,
        generator: Optional[torch.Generator] = None,
        custom_rank: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Static-shape path (``vit.py:311-348``).  Returns (x, aux); aux may
        hold 'scores' and 'topk_idx'.  ``custom_rank`` ((B, P') per-patch
        values) replaces the attention importance: the attention then runs
        without scores unless features are extracted.  With ``remat`` in
        training the block runs under ``torch.utils.checkpoint``, its keep
        masks drawn before it."""
        e = self.num_extra_tokens
        n_mlp = x.shape[1]
        if keep_rate < 1.0:
            k = pruning.num_left_tokens(keep_rate, x.shape[1] - e)
            # the custom-rank gather keeps k rows of the whole sequence
            n_mlp = k if custom_rank is not None else e + k
        noise = self.draw(x.shape[0], x.shape[1], n_mlp, x.device, generator)
        if self.remat and self.training and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._static, x, keep_rate, extract_features, custom_rank,
                noise, use_reentrant=False)
        return self._static(x, keep_rate, extract_features, custom_rank, noise)

    def _static(self, x, keep_rate, extract_features, custom_rank, noise):
        e = self.num_extra_tokens
        p_in = x.shape[1] - e
        prune = keep_rate < 1.0
        need_scores = (prune and custom_rank is None) or extract_features
        x, scores = self._attention(x, noise, need_scores=need_scores)
        aux: Dict[str, torch.Tensor] = {}
        if extract_features and scores is not None:
            aux["scores"] = scores
        if prune:
            k = pruning.num_left_tokens(keep_rate, p_in)
            if custom_rank is None:
                idx = pruning.topk_select(scores.detach(), k)
                x = pruning.gather_tokens(x, idx, e)
            else:
                # the reference's quirk (models_vit.py:215-220), kept: the
                # gather indexes the FULL sequence, extras included, with
                # patch-space indices
                idx = pruning.topk_select(custom_rank, k)
                x = pruning.take_rows(x, idx)
            aux["topk_idx"] = idx
        return self._mlp(x, noise), aux

    def masked_call(
        self,
        x: torch.Tensor,
        token_mask: torch.Tensor,
        *,
        keep_rate: Optional[float],
        num_left: Optional[Union[int, torch.Tensor]] = None,
        num_left_table: Optional[torch.Tensor] = None,
        bucket_k: Optional[int] = None,
        mask_is_full: bool = False,
        prefix_len: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked (anneal) path (``vit.py:350-433``).  ``keep_rate`` is None
        for a block that does not prune.  ``num_left`` is the exact kept
        count from the host (``engine.schedules.masked_kept_counts``);
        ``num_left_table`` ((P + 1,) ints, ``engine.schedules.
        kept_count_tables``) instead maps each sample's kept count through
        the host-double ceil; with neither, the f32 ceil of
        ``pruning.masked_num_left`` per sample.

        ``bucket_k`` (hybrid anneal): after the block, gather the top
        ``bucket_k`` patch tokens by masked score (descending, ties to the
        lower index -- the order ``masked_refine`` ranks by), so the kept set
        becomes the prefix [0, num_left) of a static width.  ``mask_is_full``
        states that no block has refined the mask yet, so attention runs
        unmasked; ``prefix_len`` states that the mask is the uniform prefix
        [0, prefix_len).  Returns (x, refined token_mask)."""
        n = x.shape[1]
        n_mlp = self.num_extra_tokens + bucket_k if bucket_k is not None else n
        noise = self.draw(x.shape[0], n, n_mlp, x.device, generator)
        x, scores = self._attention(
            x, noise,
            need_scores=keep_rate is not None,
            token_mask=None if mask_is_full else token_mask,
            prefix_len=None if mask_is_full else prefix_len,
        )

        if keep_rate is not None:
            scores = scores.detach()
            if num_left is None:
                kept = token_mask.sum(1)
                num_left = (num_left_table[kept] if num_left_table is not None
                            else pruning.masked_num_left(keep_rate, kept))
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

        return self._mlp(x, noise), token_mask


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
    if cfg.num_extra_tokens not in (1, 2):
        raise ValueError("num_extra_tokens must be 1 or 2")
    if cfg.pooling not in ("gap_fcnorm", "cls_dist"):
        raise ValueError(f"unknown pooling: {cfg.pooling}")


def patch_stats(x: torch.Tensor, patch: int = 16, kind: str = "mean") -> torch.Tensor:
    """Per-patch mean or std (ddof 1) of the input over its
    ``patch`` x ``patch`` patches, in the row-major token order: the
    custom-rank and intensity-band signal (``vit.py:464-476``).
    x: (B, C, H, W) -> (B, (H / patch) * (W / patch))."""
    b, c, hh, ww = x.shape
    gh, gw = hh // patch, ww // patch
    t = x.reshape(b, c, gh, patch, gw, patch).permute(0, 1, 3, 5, 2, 4)
    t = t.reshape(b, c * patch * patch, gh * gw)
    if kind == "mean":
        return t.mean(dim=1)
    if kind == "std":
        return t.std(dim=1, correction=1)
    raise ValueError(f"unknown patch stat: {kind}")


def mask2d_noise(
    batch: int, cfg: ViTConfig, generator: torch.Generator, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform noise over the time rows and the frequency columns of the
    patch grid, whose argsorts pick the tokens 2D masking keeps."""
    return (
        rand_rows((batch, cfg.grid_t), generator, device),
        rand_rows((batch, cfg.grid_f), generator, device),
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
        dt, eps = compute_dtype(cfg), cfg.layer_norm_eps
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        if cfg.num_extra_tokens == 2:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + cfg.num_extra_tokens, d),
            requires_grad=not cfg.frozen_pos_embed,
        )
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(Block(cfg, float(r)) for r in dpr)
        if cfg.use_final_norm:
            self.norm = LayerNorm(d, eps, dt)
        if cfg.pooling == "gap_fcnorm":
            self.fc_norm = LayerNorm(d, eps, dt)
            self.head = nn.Linear(d, cfg.num_classes)
        else:
            # AST's mlp_head (ast_models.py:290): LayerNorm + Linear in f32
            self.mlp_head = nn.Sequential(
                LayerNorm(d, eps, torch.float32), nn.Linear(d, cfg.num_classes)
            )
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
        ``_conv_flat_xavier``), trunc-normal(0.02) for the CLS and
        distillation tokens, zero biases, unit LayerNorm scales,
        trunc-normal(2e-5) for the AudioMAE head under either, torch's
        default Linear init for AST's mlp_head (weight and bias U(+-1 /
        sqrt(fan_in)), ``vit.py:540-555``), and the fixed 2D sin-cos table
        for a frozen pos embed.  (flax's default conv init is lecun-normal;
        weights cross between the packages through the state dict, never
        through the initialiser.)"""
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
        if cfg.pooling == "gap_fcnorm":
            trunc(self.head.weight, 2e-5)
        else:
            head = self.mlp_head[1]
            bound = 1.0 / math.sqrt(head.in_features)
            head.weight.uniform_(-bound, bound, generator=generator)
            head.bias.uniform_(-bound, bound, generator=generator)
        trunc(self.cls_token, 0.02)
        if cfg.num_extra_tokens == 2:
            trunc(self.dist_token, 0.02)
        if cfg.frozen_pos_embed:
            grid = sincos_2d(cfg.embed_dim, (cfg.grid_t, cfg.grid_f))
            table = np.concatenate(
                [np.zeros((cfg.num_extra_tokens, cfg.embed_dim)), grid]
            ).astype(np.float32)
            self.pos_embed.copy_(torch.from_numpy(table)[None])
        else:
            trunc(self.pos_embed, 0.02)

    def _pos_drop(self, tokens: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        """Dropout of the embedded tokens (``pos_drop``) in training."""
        if not self.training:
            return tokens
        keep = _keep_mask(tokens.shape, self.cfg.drop_rate, generator,
                          tokens.device, "dropout")
        return _apply_keep(tokens, keep, self.cfg.drop_rate)

    def embed(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Patchify, prepend CLS (and AST's distillation token), add the
        whole positional table (pos and tokens cast to the token dtype,
        ``vit.py:563-601``; AudioMAE's 'pre_cls' order gives the same sum),
        then ``pos_drop``."""
        tokens = self.patch_embed(x)
        extras = [self.cls_token]
        if self.cfg.num_extra_tokens == 2:
            extras.append(self.dist_token)
        b = tokens.shape[0]
        extras = [t.to(tokens.dtype).expand(b, -1, -1) for t in extras]
        tokens = (torch.cat([*extras, tokens], dim=1)
                  + self.pos_embed.to(tokens.dtype))
        return self._pos_drop(tokens, generator)

    def embed_masked2d(
        self,
        x: torch.Tensor,
        mask_t_prob: float,
        mask_f_prob: float,
        noise: Tuple[torch.Tensor, torch.Tensor],
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Structured 2D time/frequency token masking (``vit.py:691-736``):
        pos is added to the patches, then the ``int(T (1 - p_t))`` time rows
        with the smallest ``noise[0]`` are kept, then the ``int(F (1 - p_f))``
        frequency columns with the smallest ``noise[1]``, tokens staying in
        that permuted order; the CLS token gets pos row 0; then
        ``pos_drop``."""
        cfg = self.cfg
        if cfg.pos_embed_mode != "pre_cls":
            raise ValueError("2D masking is AudioMAE-only")
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
        return self._pos_drop(torch.cat([cls, tokens], dim=1), generator)

    def pool_and_head(
        self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The final norm where the flavour has one (in the compute dtype),
        then ``vit.py:603-621``'s pooling.  gap_fcnorm: the mean over patch
        tokens (f32 accumulation, result in the token dtype; over kept
        tokens only, through ``masked_mean``, when ``token_mask`` is given),
        fc_norm, f32 head.  cls_dist: (x[:, 0] + x[:, 1]) / 2 in the token
        dtype, then cast to f32 for mlp_head's LayerNorm and Linear."""
        cfg = self.cfg
        if cfg.use_final_norm:
            x = self.norm(x)
        if cfg.pooling == "cls_dist":
            return self.mlp_head(((x[:, 0] + x[:, 1]) / 2.0).float())
        patches = x[:, cfg.num_extra_tokens:]
        if token_mask is not None:
            feat = pruning.masked_mean(patches, token_mask)
        else:
            feat = patches.float().mean(dim=1).to(x.dtype)
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
        generator: Optional[torch.Generator] = None,
    ):
        """Static-shape forward (``vit.py:626-689``).  x: (B, 1, T, F).

        keep_rates: per-block floats (len == depth); None uses the config's
        baked rates.  ``mask_t_prob``/``mask_f_prob`` > 0 embed through 2D
        masking, with noise drawn from ``generator``, which drop-path and
        dropout in training draw from too.  ``custom_rank`` ('mean' or
        'std'): the drop blocks keep the patches of largest ``patch_stats``
        instead of largest importance; ignored under 2D masking, whose
        permuted tokens the full-grid ranks do not index
        (``vit.py:656-668``).
        Returns logits (B, num_classes) f32, or (logits, features) when
        ``extract_features``: 'mel', 'block-{i}.attn_score' and
        'block-{i}.topk_idx'.
        """
        cfg = self.cfg
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
        masked2d = mask_t_prob > 0.0 or mask_f_prob > 0.0
        rank = None
        if custom_rank is not None and not masked2d:
            rank = patch_stats(x, cfg.patch_size, custom_rank)
        if masked2d:
            gen = _need_generator(generator, "2D masking")
            noise = mask2d_noise(x.shape[0], cfg, gen, x.device)
            tokens = self.embed_masked2d(x, mask_t_prob, mask_f_prob, noise,
                                         generator)
        else:
            tokens = self.embed(x, generator)
        for i, blk in enumerate(self.blocks):
            tokens, aux = blk(tokens, keep_rates[i], extract_features, generator,
                              custom_rank=rank)
            if rank is not None and "topk_idx" in aux:
                rank = pruning.gather_scores(rank, aux["topk_idx"])
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
        num_left_tables: Optional[torch.Tensor] = None,
        intensity_band: Optional[Tuple[float, float, int]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Full-width forward with per-block keep rates carried as a token
        mask (``vit.py:742-833``).  ``num_left``: the exact per-block kept
        counts from ``engine.schedules.masked_kept_counts``;
        ``num_left_tables`` ((depth, P + 1) ints, ``engine.schedules.
        kept_count_tables``): each drop block maps its runtime kept count
        through its row instead; with neither, the f32 ceil per sample.
        Entries at blocks outside ``drop_loc`` are ignored.

        ``intensity_band`` = (retain_min, retain_max, block): after that
        block only the patches whose input mean (``patch_stats``) lies in
        the open interval stay in the mask, intersected with it in the
        original grid's order (the reference indexes the pruned sequence
        with grid indices, which fails once a drop block precedes the
        band; where it runs the two agree).  Returns (logits, kept counts
        per sample) with the band, else the logits."""
        cfg = self.cfg
        if num_left is not None and intensity_band is not None:
            raise ValueError("num_left and intensity_band are exclusive: the "
                             "band makes the kept counts data-dependent")
        band_mask, band_blk = None, -1
        if intensity_band is not None:
            lo, hi, band_blk = intensity_band
            intensity = patch_stats(x, cfg.patch_size, "mean")
            band_mask = (intensity > lo) & (intensity < hi)
        tokens = self.embed(x, generator)
        token_mask = pruning.full_token_mask(x.shape[0], cfg.num_patches, x.device)
        first = min(cfg.drop_loc) if cfg.drop_loc else cfg.depth
        if band_mask is not None:
            first = min(first, band_blk)
        for i, blk in enumerate(self.blocks):
            drop = i in cfg.drop_loc
            tokens, token_mask = blk.masked_call(
                tokens, token_mask,
                keep_rate=float(keep_rates[i]) if drop else None,
                num_left=num_left[i] if drop and num_left is not None else None,
                num_left_table=(num_left_tables[i]
                                if drop and num_left_tables is not None else None),
                mask_is_full=i <= first,
                generator=generator,
            )
            if band_mask is not None and i == band_blk:
                token_mask = token_mask & band_mask
        logits = self.pool_and_head(tokens, token_mask)
        if intensity_band is not None:
            return logits, token_mask.sum(1)
        return logits

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
        bucket_rates = tuple(float(r) for r in bucket_rates)
        if len(bucket_rates) != cfg.depth:
            raise ValueError(
                f"bucket_rates must have length {cfg.depth}, got "
                f"{len(bucket_rates)}"
            )
        bucket_counts = compose_kept_counts(bucket_rates, cfg.num_patches)
        tokens = self.embed(x, generator)
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


@torch.no_grad()
def shard_model_(model: AudioViT, mesh: sharding.Mesh2D) -> AudioViT:
    """Cut ``model`` in place over ``mesh``'s model axis: each block's
    ``qkv`` (by heads) and ``fc1`` column-parallel, its ``proj`` and
    ``fc2`` row-parallel, the attention over the rank's heads.  Parameter
    names stay those of the tp = 1 model (``parallel/sharding.py``'s
    table).  The model keeps ``mesh`` as ``model.mesh``.  Refuses a
    model axis that does not divide the heads or the hidden width, and an
    attention other than the plain one (the kernels take every head of a
    sample; a model axis runs ``attention_impl='xla'``, as in JAX)."""
    cfg = model.cfg
    tp, rank = mesh.tp, mesh.model_rank
    model.mesh = mesh
    if tp == 1:
        return model
    sharding.check_divisible(cfg.num_heads, model.blocks[0].mlp.hidden, tp)
    if cfg.attention_impl != "xla":
        raise ValueError("tensor parallelism runs attention_impl='xla', not "
                         f"{cfg.attention_impl!r}")
    group = mesh.model_group

    def cut(lin, name, cls):
        w = sharding.shard_tensor(f"{name}.weight", lin.weight.detach(), tp,
                                  rank)
        b = lin.bias
        if b is not None and cls is ColumnParallelLinear:
            b = sharding.shard_tensor(f"{name}.bias", b.detach(), tp, rank)
        return cls(lin, w, None if b is None else b.detach().clone(), group)

    for i, blk in enumerate(model.blocks):
        attn, mlp, pre = blk.attn, blk.mlp, f"blocks.{i}."
        attn.qkv = cut(attn.qkv, pre + "attn.qkv", ColumnParallelLinear)
        attn.proj = cut(attn.proj, pre + "attn.proj", RowParallelLinear)
        attn.num_heads = cfg.num_heads // tp
        attn.model_group, attn.tp = group, tp
        mlp.fc1 = cut(mlp.fc1, pre + "mlp.fc1", ColumnParallelLinear)
        mlp.fc2 = cut(mlp.fc2, pre + "mlp.fc2", RowParallelLinear)
        width = mlp.hidden // tp
        mlp.cols = slice(rank * width, (rank + 1) * width)
    return model
