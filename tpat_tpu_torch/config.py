"""Typed configuration of the port: its own copy of ``tpat_tpu/config.py``.

The JAX package's config module is pure Python, and the port keeps a copy of
it rather than importing it, so that ``tpat_tpu_torch`` imports nothing of
the JAX package.  Every dataclass field, default, preset and factory is the
JAX module's (``tests/test_torch_config.py`` holds the two equal), so a
config means the same model, schedule and dataset in both packages; only
the comments and messages below speak of the port where they differ.

The reference drives everything through argparse flags + hard-coded
per-dataset tables (``audiomae/main_finetune.py:254-258``,
``ast/src/run.py:150-169``).  Here those become frozen
dataclasses with per-dataset presets, so configs are hashable and
self-documenting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def compose_kept_counts(
    rates: Tuple[float, ...], num_patches: int
) -> Tuple[int, ...]:
    """Per-block kept-PATCH counts under the ceil-chain composition
    ``kept = math.ceil(r * kept)`` for each ``r < 1.0``
    (``models_vit.py:104``), in Python double precision.

    The single source of truth for pruning widths: both the static path
    (``ViTConfig.tokens_per_block``) and the masked anneal path
    (``engine.schedules.masked_kept_counts``) derive from it, so the two
    paths can never disagree on a width.
    """
    counts = []
    kept = num_patches
    for r in rates:
        if r < 1.0:
            kept = math.ceil(r * kept)
        counts.append(kept)
    return tuple(counts)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Unified ViT trunk covering both reference model families.

    The two stacks in the reference differ only in (a) number of extra
    tokens, (b) the attention-importance reduction, (c) the pooling head and
    (d) where the positional embedding is added:

    - AudioMAE flavor (``audiomae/models_vit.py:49-527``):
      1 CLS token, importance = patch-to-patch attention averaged over heads
      and query rows (``models_vit.py:113``), mean-pool non-CLS + fc_norm
      head (``models_vit.py:387-389``), pos-embed added to patches before
      the CLS concat (``models_vit.py:357-362``), frozen sin-cos pos-embed.

    - AST flavor (``ast/src/models/ast_models.py:62-508``):
      2 extra tokens (CLS + distill), importance = CLS-row attention
      averaged over heads (``ast_models.py:124``), ``(x0 + x1)/2`` after a
      final LayerNorm, then LayerNorm+Linear mlp_head
      (``ast_models.py:500-503``), pos-embed added after the concat
      (``ast_models.py:463-466``), learnable pos-embed.
    """

    # Trunk
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-6
    patch_size: int = 16
    # Patch stride; < patch_size gives overlapping patches
    # (util/patch_embed.py PatchEmbed_new, stride-10 variant — unused by
    # the reference finetune path but part of its API surface).
    patch_stride: int = 0  # 0 -> patch_size (non-overlapping)
    in_chans: int = 1
    num_classes: int = 527

    # Input geometry: spectrogram is (B, 1, target_length, num_mel_bins)
    target_length: int = 1024
    num_mel_bins: int = 128

    # Family-specific policy
    num_extra_tokens: int = 1  # 1 = AudioMAE (CLS), 2 = AST (CLS + dist)
    importance: str = "patch_mean"  # 'patch_mean' (AudioMAE) | 'cls' (AST)
    pooling: str = "gap_fcnorm"  # 'gap_fcnorm' (AudioMAE) | 'cls_dist' (AST)
    pos_embed_mode: str = "pre_cls"  # 'pre_cls' (AudioMAE) | 'post_cat' (AST)
    use_final_norm: bool = False  # AST applies v.norm before pooling
    frozen_pos_embed: bool = True  # AudioMAE: fixed sin-cos; AST: learnable

    # Regularization
    drop_rate: float = 0.0
    # Attention-probability dropout is NOT implemented (every reference
    # config runs attn_drop_rate 0.0; the fused kernel's probabilities
    # never leave VMEM).  The knob exists for config-file parity only and
    # __post_init__ rejects nonzero values rather than silently ignoring
    # them.
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    # Rematerialize block activations in the backward pass (trades FLOPs
    # for HBM; useful for large batches / long targets on-chip).
    remat: bool = False

    # Pruning: per-block default keep-rates baked from (drop_loc,
    # base_keep_rate) exactly like models_vit.py:283-293.
    drop_loc: Tuple[int, ...] = (3, 6, 9)
    base_keep_rate: float = 1.0

    # Compute policy: bfloat16 matmuls, float32 softmax/accumulation.
    # bfloat16 is the default (the reference's recipes all train under
    # AMP, engine_finetune.py:102 autocast); float32 is the explicit
    # override for parity tests and cross-checks.
    compute_dtype: str = "bfloat16"
    # The fused LayerNorm kernel for the block norms (the JAX package's
    # Pallas kernel; here csrc/layernorm.cu through models/vit.py's
    # FusedLayerNorm), off by default as there.
    use_fused_layernorm: bool = False
    # Attention implementation: 'xla' (plain attention, reference math),
    # 'fused' (the hand-written attention kernels, ops/qkv_attention.py,
    # which never write the probability matrix to device memory; the
    # hybrid anneal's uniform prefix masks take the prefix form), or
    # 'fused_padded' (a JAX-package lane-padding variant for head dims
    # that do not divide 128, e.g. ViT-H's 80; the port's kernels take
    # head_dim 80 natively, so it dispatches like 'fused').
    attention_impl: str = "fused"
    # GELU implementation for the MLP epilogues: 'auto' (the degree-8
    # normal-CDF polynomial, ops/fast_gelu.py, when the compute dtype is
    # bfloat16 — at most one-ulp bf16 deviations from erf; float32
    # compute keeps exact erf), 'exact' (erf always), or 'poly'
    # (polynomial always).
    gelu_impl: str = "auto"
    # Dense/conv weight init for from-scratch training: 'trunc_normal'
    # (timm/finetune trunk default) or 'xavier_uniform' (the MAE
    # pretraining init, models_mae.py:157-177 — xavier on every Linear and
    # on the flattened patch-embed conv).
    dense_init: str = "trunc_normal"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            # jnp.dtype("float16") would parse fine and silently run the
            # model in an unsupported/unbenchmarked precision
            raise ValueError(
                "compute_dtype must be 'float32' or 'bfloat16', "
                f"got {self.compute_dtype!r}"
            )
        if self.attn_drop_rate != 0.0:
            raise ValueError(
                "attn_drop_rate is not implemented (all reference configs "
                "use 0.0, models_vit.py:93); got "
                f"{self.attn_drop_rate}"
            )
        if self.gelu_impl not in ("auto", "exact", "poly"):
            raise ValueError(
                f"gelu_impl must be 'auto', 'exact', or 'poly', "
                f"got {self.gelu_impl!r}"
            )
        if self.dense_init not in ("trunc_normal", "xavier_uniform"):
            raise ValueError(
                f"dense_init must be 'trunc_normal' or 'xavier_uniform', "
                f"got {self.dense_init!r}"
            )
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}"
            )
        for loc in self.drop_loc:
            if not 0 <= loc < self.depth:
                raise ValueError(
                    f"drop_loc {self.drop_loc} out of range for depth "
                    f"{self.depth}"
                )
        if not 0.0 < self.base_keep_rate <= 1.0:
            raise ValueError(
                f"base_keep_rate must be in (0, 1], got {self.base_keep_rate}"
            )
        if self.target_length % self.patch_size or self.num_mel_bins % self.patch_size:
            raise ValueError(
                "target_length and num_mel_bins must be multiples of "
                f"patch_size={self.patch_size}"
            )

    # ---- derived helpers -------------------------------------------------

    @property
    def stride(self) -> int:
        return self.patch_stride or self.patch_size

    @property
    def grid_t(self) -> int:
        if self.stride == self.patch_size:
            return self.target_length // self.patch_size
        return (self.target_length - self.patch_size) // self.stride + 1

    @property
    def grid_f(self) -> int:
        if self.stride == self.patch_size:
            return self.num_mel_bins // self.patch_size
        return (self.num_mel_bins - self.patch_size) // self.stride + 1

    @property
    def num_patches(self) -> int:
        return self.grid_t * self.grid_f

    @property
    def keep_rates(self) -> Tuple[float, ...]:
        """Per-block default keep rate (models_vit.py:283-293)."""
        rates = [1.0] * self.depth
        for loc in self.drop_loc:
            rates[loc] = self.base_keep_rate
        return tuple(rates)

    def tokens_per_block(
        self, keep_rates: Optional[Tuple[float, ...]] = None
    ) -> Tuple[Tuple[int, int], ...]:
        """Static (n_in, n_patches_out) token counts entering/leaving each
        block under physical pruning.

        num_left = ceil(keep * (N - extra)) per models_vit.py:104.
        """
        rates = self.keep_rates if keep_rates is None else keep_rates
        counts = compose_kept_counts(rates, self.num_patches)
        shapes = []
        prev = self.num_patches
        for out in counts:
            shapes.append((prev + self.num_extra_tokens, out))
            prev = out
        return tuple(shapes)


def audiomae_vit_base(**kw) -> ViTConfig:
    """AudioMAE finetune ViT-B/16 (models_vit.py:537-541 + main_finetune.py
    patch-embed/pos-embed surgery at :374-382)."""
    return ViTConfig(
        embed_dim=768,
        depth=12,
        num_heads=12,
        num_extra_tokens=1,
        importance="patch_mean",
        pooling="gap_fcnorm",
        pos_embed_mode="pre_cls",
        use_final_norm=False,
        frozen_pos_embed=True,
        **kw,
    )


def audiomae_vit_small(**kw) -> ViTConfig:
    """models_vit.py:531-535."""
    return ViTConfig(
        embed_dim=384,
        depth=12,
        num_heads=6,
        num_extra_tokens=1,
        importance="patch_mean",
        pooling="gap_fcnorm",
        pos_embed_mode="pre_cls",
        use_final_norm=False,
        frozen_pos_embed=True,
        **kw,
    )


def audiomae_vit_large(**kw) -> ViTConfig:
    """models_vit.py:544-548."""
    return ViTConfig(
        embed_dim=1024,
        depth=24,
        num_heads=16,
        num_extra_tokens=1,
        importance="patch_mean",
        pooling="gap_fcnorm",
        pos_embed_mode="pre_cls",
        use_final_norm=False,
        frozen_pos_embed=True,
        **kw,
    )


def audiomae_vit_huge(**kw) -> ViTConfig:
    """models_vit.py:550-554 (``vit_huge_patch14``) trunk dims.  The
    reference's factory name says patch 14 (ImageNet MAE heritage), but
    the audio driver swaps in a 16x16 patch embed for every model
    (``main_finetune.py:374-382``), so 16 is the audio default here; pass
    ``patch_size=14`` for the raw ImageNet geometry.  The port's
    attention kernels take its head_dim of 80 natively."""
    kw.setdefault("patch_size", 16)
    return ViTConfig(
        embed_dim=1280,
        depth=32,
        num_heads=16,
        num_extra_tokens=1,
        importance="patch_mean",
        pooling="gap_fcnorm",
        pos_embed_mode="pre_cls",
        use_final_norm=False,
        frozen_pos_embed=True,
        **kw,
    )


def audiomae_vit_tiny(**kw) -> ViTConfig:
    """Debug-scale model (not in the reference; for smokes and CI)."""
    return ViTConfig(
        embed_dim=192,
        depth=6,
        num_heads=3,
        num_extra_tokens=1,
        importance="patch_mean",
        pooling="gap_fcnorm",
        pos_embed_mode="pre_cls",
        use_final_norm=False,
        frozen_pos_embed=True,
        **kw,
    )


def ast_vit_base(**kw) -> ViTConfig:
    """AST DeiT-B distilled backbone (ast_models.py:239-508)."""
    kw.setdefault("drop_path_rate", 0.0)
    return ViTConfig(
        embed_dim=768,
        depth=12,
        num_heads=12,
        num_extra_tokens=2,
        importance="cls",
        pooling="cls_dist",
        pos_embed_mode="post_cat",
        use_final_norm=True,
        frozen_pos_embed=False,
        **kw,
    )


# ---------------------------------------------------------------------------
# Data / dataset presets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Per-dataset constants (main_finetune.py:254-258)."""

    name: str
    num_classes: int
    target_length: int
    norm_mean: float
    norm_std: float
    multilabel: bool
    use_noise: bool
    loss_type: str  # 'bce' | 'ce'
    num_mel_bins: int = 128
    # Train-time augmentation defaults (from the ft_*.sh run scripts).
    freqm: int = 0
    timem: int = 0
    mixup: float = 0.0
    roll_mag_aug: bool = False


DATASET_PRESETS = {
    "audioset": DataConfig(
        name="audioset",
        num_classes=527,
        target_length=1024,
        norm_mean=-4.2677393,
        norm_std=4.5689974,
        multilabel=True,
        use_noise=False,
        loss_type="bce",
        freqm=48,
        timem=192,
        mixup=0.5,
        roll_mag_aug=True,
    ),
    "esc50": DataConfig(
        name="esc50",
        num_classes=50,
        target_length=512,
        norm_mean=-6.6268077,
        norm_std=5.358466,
        multilabel=False,
        use_noise=False,
        loss_type="ce",
        freqm=24,
        timem=96,
        mixup=0.0,
        roll_mag_aug=True,  # ft_esc50.sh:21
    ),
    "spc2": DataConfig(
        name="spc2",
        num_classes=35,
        target_length=128,
        norm_mean=-6.845978,
        norm_std=5.5654526,
        multilabel=True,
        use_noise=True,
        loss_type="bce",
        freqm=48,
        timem=48,
        mixup=0.5,  # ft_spc2.sh:25
        roll_mag_aug=True,  # ft_spc2.sh:26
    ),
    "voxceleb1": DataConfig(
        name="voxceleb1",
        num_classes=1251,
        target_length=1024,
        norm_mean=-6.370,
        norm_std=3.074,
        multilabel=False,
        use_noise=True,
        loss_type="ce",
        freqm=48,
        timem=192,
        roll_mag_aug=True,  # ft_voxceleb1.sh:30
    ),
}


# ---------------------------------------------------------------------------
# Training config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters mirroring the reference knob names.

    - LR rule: ``lr = blr * eff_batch / 256`` (main_finetune.py:437-441).
    - AdamW betas (0.9, 0.95) over layer-wise-decayed param groups
      (main_finetune.py:464-468, util/lr_decay.py).
    - Per-iteration warmup + half-cosine schedule (util/lr_sched.py:9-21).
    - Keep-rate cosine anneal over `shrink_epochs` starting at
      `shrink_start_epoch` (engine_finetune.py:29-53).
    - Augmentations force-disabled once shrink begins
      (main_finetune.py:518-522).
    """

    batch_size: int = 64  # per-process batch.  On a
    # single host this is the global batch; multi-host, the global batch
    # is batch_size * num_hosts (torch per-process --batch_size semantics,
    # main_finetune.py:437-439).
    num_hosts: int = 1  # the process count; scales the effective batch
    # in the blr -> lr rule exactly like the reference's world_size
    epochs: int = 120
    accum_iter: int = 1
    blr: float = 1e-3
    lr: Optional[float] = None
    min_lr: float = 1e-6
    warmup_epochs: float = 5.0
    weight_decay: float = 1e-4
    layer_decay: float = 0.75
    clip_grad: Optional[float] = None
    seed: int = 0

    # Pruning schedule
    base_keep_rate: float = 1.0
    drop_loc: Tuple[int, ...] = (3, 6, 9)
    shrink_start_epoch: int = 10
    shrink_epochs: int = 0
    # How the shrink-phase cosine anneal executes:
    # 'hybrid'   — DEFAULT: exact reference schedule at near-static cost.
    #              Keep rates snap UP to `anneal_buckets` bucket levels;
    #              each level runs a physically-pruned step at the
    #              bucket's static widths, and the EXACT scheduled kept
    #              counts are threaded through a token mask inside those
    #              widths (models/vit.py::forward_hybrid).  Same kept
    #              sets/widths as 'masked', MAC cost close to the static
    #              step.
    # 'masked'   — exact reference semantics: keep rates as data, full
    #              shapes (every anneal step pays full dense-sequence
    #              MACs).
    # 'bucketed' — keep rates snap UP to `anneal_buckets` discrete levels
    #              between 1.0 and base_keep_rate; each level runs a
    #              physically-pruned static step (reduced shapes -> real
    #              MAC savings during the anneal).  Effective keep rate is always >= the
    #              scheduled one, so pruning is never more aggressive
    #              than the reference schedule — but the schedule is
    #              quantized, unlike 'hybrid'/'masked'.
    anneal_mode: str = "hybrid"
    anneal_buckets: int = 4

    # Finetune-time structured masking (regularization)
    mask_t_prob: float = 0.0
    mask_f_prob: float = 0.0

    first_eval_ep: int = 0
    dist_eval: bool = False

    # Optimizer family: 'adamw_lrd' (AudioMAE, main_finetune.py:463-468) or
    # 'ast_adam' (AST: Adam(lr, wd=5e-7, betas=(0.95, 0.999)) + MultiStepLR
    # + manual 1000-step warmup, traintest.py:86-95, 160-164).
    optimizer: str = "adamw_lrd"
    ast_weight_decay: float = 5e-7
    lrscheduler_start: int = 2
    lrscheduler_step: int = 1
    lrscheduler_decay: float = 0.5
    warmup: bool = False  # AST manual step-warmup flag
    warmup_steps: int = 1000
    # BOTH reference drivers pass it = epoch * iters_per_epoch to the
    # keep-rate scheduler and never increment it inside the batch loop
    # (engine_finetune.py:81, traintest.py:167) — the scheduled keep rate
    # is CONSTANT within an epoch.  'per_iter' (anneal every iteration)
    # is kept as an opt-in smoother variant, but the reference-faithful
    # default is 'per_epoch'.
    keep_rate_iter_mode: str = "per_epoch"  # 'per_epoch' | 'per_iter'
    epoch_base: int = 0

    def __post_init__(self):
        # main_finetune.py:511 asserts the two probs are equal; the engine
        # applies one probability to both axes, so unequal values would
        # silently train a different augmentation than configured.
        if self.mask_t_prob != self.mask_f_prob:
            raise ValueError(
                f"mask_t_prob ({self.mask_t_prob}) must equal mask_f_prob "
                f"({self.mask_f_prob}) (main_finetune.py:511)"
            )
        if self.keep_rate_iter_mode not in ("per_epoch", "per_iter"):
            raise ValueError(
                "keep_rate_iter_mode must be 'per_epoch' or 'per_iter', "
                f"got {self.keep_rate_iter_mode!r}"
            )

    def resolved_lr(self, eff_batch_size: int) -> float:
        if self.lr is not None:
            return self.lr
        return self.blr * eff_batch_size / 256.0
