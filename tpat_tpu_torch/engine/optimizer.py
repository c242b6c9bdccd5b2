"""The two optimizers of the JAX package (``tpat_tpu/engine/optimizer.py``).

AdamW with BEiT layer-wise LR decay, as its optax chain (``:59-112``)
computes it:

    p <- p - lr(update) * scale * (m_hat / (sqrt(v_hat) + eps) + wd * p)

with betas (0.9, 0.95) and eps 1e-8.  ``torch.optim.AdamW`` takes one param
group per (layer scale, decay flag); each group's lr is set to
``lr_fn(update_index) * scale`` before every update.  Weight decay applies
to >= 2-D tensors outside pos_embed and cls_token.  The frozen pos_embed
has no gradient and is left out.

The AST recipe (``:115-173``, ``traintest.py:86-95, 160-164, 249``):
``torch.optim.Adam`` over every trainable parameter with betas (0.95,
0.999), eps 1e-8 and coupled L2 (``weight_decay`` adds decay * p to the
gradient before the moments, as ``optax.add_decayed_weights`` before
``scale_by_adam``; AdamW would decouple it), its lr from a table that
replays the reference's warmup writes and MultiStepLR decays per
micro-batch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

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
) -> torch.optim.Optimizer:
    """The train config's optimizer: 'adamw_lrd' or 'ast_adam'."""
    if train_cfg.optimizer == "ast_adam":
        return make_ast_optimizer(model, train_cfg)
    if train_cfg.optimizer != "adamw_lrd":
        raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
    groups = param_groups(
        model, model_cfg.depth, train_cfg.weight_decay, train_cfg.layer_decay
    )
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.95), eps=1e-8)


def make_ast_optimizer(
    model: torch.nn.Module, train_cfg: TrainConfig
) -> torch.optim.Adam:
    """The AST recipe's Adam over every trainable parameter, one group (no
    layer scale, no decay mask)."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(
        [{"params": params, "lr_scale": 1.0}], lr=0.0, betas=(0.95, 0.999),
        eps=1e-8, weight_decay=train_cfg.ast_weight_decay,
    )


def make_ast_lr_fn(
    train_cfg: TrainConfig, iters_per_epoch: int, accum: int = 1
) -> Callable[[int], float]:
    """Update index -> lr of the AST recipe, as ``make_ast_lr_fn``: the
    reference's loop replayed on the host into a per-micro-batch table.
    Warmup (``train_cfg.warmup``) overwrites the lr with
    ``gstep / warmup_steps * base`` at every 50th step up to
    ``warmup_steps``; MultiStepLR multiplies the current lr by the decay at
    the end of each epoch in ``range(start, 1000, step)``, epochs counted
    from ``epoch_base``.  So a decay that fires during the warmup is
    wiped out by the next write, and milestones stop at epoch 999.  Update
    u reads the lr at its last micro-batch, ``table[u * accum + accum -
    1]``, where the reference's ``opt.step()`` would fire."""
    base = train_cfg.lr if train_cfg.lr is not None else train_cfg.blr
    milestones = set(range(train_cfg.lrscheduler_start, 1000,
                           max(train_cfg.lrscheduler_step, 1)))
    iters = max(iters_per_epoch, 1)
    lr, gstep, table = base, 0, []
    for e in range(train_cfg.epoch_base,
                   train_cfg.epoch_base + max(train_cfg.epochs, 1)):
        for _ in range(iters):
            if (train_cfg.warmup and gstep <= train_cfg.warmup_steps
                    and gstep % 50 == 0):
                lr = gstep / train_cfg.warmup_steps * base
            table.append(lr)
            gstep += 1
        if e in milestones:  # scheduler.step() at the epoch's end
            lr *= train_cfg.lrscheduler_decay

    def lr_fn(step: int) -> float:
        return table[min(max(step * accum + accum - 1, 0), len(table) - 1)]

    return lr_fn


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


def global_grad_norm(
    grads: Sequence[torch.Tensor],
    sharded: Optional[Sequence[bool]] = None,
    group=None,
) -> torch.Tensor:
    """L2 norm over every gradient, in f32, on the device.  Under a model
    axis (``group``, the model group) the squares of the gradients that
    ``sharded`` marks as cut are summed over the group, and a replicated
    gradient counts once."""
    squares = [(g.float() ** 2).sum() for g in grads]
    if group is None:
        return torch.sqrt(sum(squares))
    cut = torch.stack([s for s, c in zip(squares, sharded) if c]).sum()
    dist.all_reduce(cut, group=group)
    return torch.sqrt(sum(s for s, c in zip(squares, sharded) if not c) + cut)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None):
    """Scale the gradients in place by min(1, max_norm / norm), as
    ``optax.clip_by_global_norm`` does (no epsilon in the norm); ``norm``
    defaults to ``global_grad_norm(grads)``."""
    if norm is None:
        norm = global_grad_norm(grads)
    factor = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
