"""Plain AdamW with per-parameter learning rates and decays, and the two
recipes' schedules (AudioMAE ``main_finetune.py`` with BEiT layer decay,
``util/lr_sched.py``; MAE pretraining), written from their descriptions:

    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    p <- p (1 - lr wd) - lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class AdamW:
    def __init__(self, lr_scale: Dict[str, float], decay: Dict[str, float],
                 betas=(0.9, 0.95), eps=1e-8):
        self.lr_scale, self.decay = lr_scale, decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for name, g in grads.items():
            p = params[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            lr_p = lr * self.lr_scale[name]
            p.mul_(1 - lr_p * self.decay[name])
            denom = (v / bc2).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-lr_p / bc1)


def warmup_cosine(fractional_epoch: float, lr: float, min_lr: float,
                  warmup_epochs: float, epochs: float) -> float:
    """Linear warmup per iteration, then a half-cosine to ``min_lr``."""
    e = fractional_epoch
    if e < warmup_epochs:
        return lr * e / max(warmup_epochs, 1e-8)
    return min_lr + (lr - min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * (e - warmup_epochs)
                       / max(epochs - warmup_epochs, 1e-8)))


def beit_layer_id(name: str, depth: int) -> int:
    """Embedding parameters 0, ``blocks.i`` i + 1, the rest depth + 1."""
    head = name.split(".")[0]
    if head in ("cls_token", "pos_embed", "patch_embed"):
        return 0
    if head == "blocks":
        return int(name.split(".")[1]) + 1
    return depth + 1


def finetune_groups(shapes: Dict[str, tuple], depth: int, layer_decay: float,
                    weight_decay: float):
    """(lr scale, weight decay) per trainable parameter: layer decay
    ``layer_decay ** (depth + 1 - layer id)``; decay on matrices outside
    the pos embed and the CLS token."""
    scale, decay = {}, {}
    for name, shape in shapes.items():
        scale[name] = layer_decay ** (depth + 1 - beit_layer_id(name, depth))
        top = name.split(".")[0]
        decay[name] = (weight_decay if len(shape) > 1
                       and top not in ("pos_embed", "cls_token") else 0.0)
    return scale, decay


def pretrain_groups(shapes: Dict[str, tuple], weight_decay: float):
    """No layer decay; decay on every trainable tensor of two or more
    dimensions."""
    return ({n: 1.0 for n in shapes},
            {n: weight_decay if len(s) > 1 else 0.0 for n, s in shapes.items()})
