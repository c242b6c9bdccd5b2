"""AdamW with BEiT layer-wise LR decay, as the JAX package's optax chain
(``tpat_tpu/engine/optimizer.py:59-112``) computes it:

    p <- p - lr(update) * scale * (m_hat / (sqrt(v_hat) + eps) + wd * p)

with betas (0.9, 0.95) and eps 1e-8.  ``torch.optim.AdamW`` takes one param
group per (layer scale, decay flag); each group's lr is set to
``lr_fn(update_index) * scale`` before every update.  Weight decay applies
to >= 2-D tensors outside pos_embed and cls_token.  The frozen pos_embed
has no gradient and is left out.

The AST recipe's Adam waits for the AST flavour.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from tpat_tpu_torch.config import TrainConfig, ViTConfig
from tpat_tpu_torch.engine import schedules


def param_groups(
    model: torch.nn.Module, depth: int, weight_decay: float, layer_decay: float
) -> List[Dict]:
    """The trainable parameters grouped by (layer scale, decay flag); each
    group carries its ``lr_scale``."""
    groups: Dict[tuple, Dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        scale = schedules.layer_decay_scale(name, depth, layer_decay)
        decay = schedules.weight_decay_mask(name, p)
        group = groups.setdefault((scale, decay), {
            "params": [], "names": [], "lr_scale": scale,
            "weight_decay": weight_decay if decay else 0.0,
        })
        group["params"].append(p)
        group["names"].append(name)
    return list(groups.values())


def make_optimizer(
    model: torch.nn.Module, model_cfg: ViTConfig, train_cfg: TrainConfig
) -> torch.optim.AdamW:
    if train_cfg.optimizer != "adamw_lrd":
        raise NotImplementedError(
            f"optimizer {train_cfg.optimizer!r} is not ported yet (only "
            "'adamw_lrd'; the AST Adam waits for the AST flavour)"
        )
    groups = param_groups(
        model, model_cfg.depth, train_cfg.weight_decay, train_cfg.layer_decay
    )
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.95), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_scale"]


def make_lr_fn(
    train_cfg: TrainConfig, iters_per_epoch: int, eff_batch_size: int
) -> Callable[[int], float]:
    """Update index -> lr: fractional epoch = index / iters_per_epoch (in
    updates), warmup + cosine from ``resolved_lr(eff_batch_size)``."""
    lr = train_cfg.resolved_lr(eff_batch_size)

    def lr_fn(step: int) -> float:
        return schedules.warmup_cosine_lr(
            step / iters_per_epoch,
            lr=lr,
            min_lr=train_cfg.min_lr,
            warmup_epochs=train_cfg.warmup_epochs,
            total_epochs=train_cfg.epochs,
        )

    return lr_fn


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient, in f32, on the device."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float):
    """Scale the gradients in place by min(1, max_norm / norm), as
    ``optax.clip_by_global_norm`` does (no epsilon in the norm)."""
    norm = global_grad_norm(grads)
    factor = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
