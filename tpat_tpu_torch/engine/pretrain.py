"""The MAE pretrain optimizer and train step (port of
``tpat_tpu/engine/pretrain.py``).

AudioMAE's pretrain recipe: AdamW with betas (0.9, 0.95) over two parameter
groups (``add_weight_decay``: decay on tensors with ndim > 1, never on the
frozen sin-cos pos embeds, which take no gradient and join no group), a
warmup-cosine LR (``engine/schedules.py::warmup_cosine_lr``, or any
``lr_fn(update) -> lr``), and the masked-MSE loss summed on the device.

The JAX chain ``scale_by_adam -> add_decayed_weights -> -lr`` updates

    p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)

which is ``torch.optim.AdamW``'s decoupled update, with the decay taken
from the parameter before the Adam step (``tests/test_torch_pretrain.py``
holds the two equal after a step).

Randomness: the JAX step folds the step index into its key; here each step
draws its masking noise and the decoder's meta-MLP dropout from a
``torch.Generator`` seeded from ``(seed, step)`` (``step_generator``).

``check_epoch_loss`` is the pretraining CLI's stop on a non-finite epoch loss
(``cli/pretrain.py``, as ``tpat_tpu/cli/pretrain.py`` stops).

Data parallelism (``parallel/``): in a process group the step averages the
gradients across ranks before the AdamW update (one flat ``all_reduce``,
JAX's ``psum``), and the masking noise is drawn at the global batch's shape
and cut to the rank's rows, so two ranks take the one-process step of the
same global batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from tpat_tpu_torch.engine import schedules
from tpat_tpu_torch.models.mae import MaskedAutoencoderViT, Noise
from tpat_tpu_torch.parallel import distributed as dist_lib
from tpat_tpu_torch.utils import tracing

FROZEN_POS = ("pos_embed", "decoder_pos_embed")


def mae_decay_mask(model: torch.nn.Module, pos_trainable: bool) -> Dict[str, bool]:
    """{parameter name: decayed}: ndim > 1, minus the pos embeds unless
    they are trainable (``pretrain.py:26-38``)."""
    return {
        name: p.dim() > 1 and (pos_trainable or name not in FROZEN_POS)
        for name, p in model.named_parameters()
    }


def make_mae_optimizer(
    model: torch.nn.Module,
    *,
    weight_decay: float,
    pos_trainable: bool,
    b1: float = 0.9,
    b2: float = 0.95,
) -> torch.optim.AdamW:
    """AdamW over the decay and no-decay groups of the trainable
    parameters; the lr is set by the train step before each update."""
    decay = mae_decay_mask(model, pos_trainable)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[decay[name]].append(p)
    return torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=0.0, betas=(b1, b2), eps=1e-8,
    )


def mae_lr_fn(
    *, lr: float, min_lr: float, warmup_epochs: float, epochs: int,
    iters_per_epoch: int,
) -> Callable[[int], float]:
    """Update index -> lr: per-iteration warmup, then a half-cosine to
    ``min_lr`` over ``epochs`` (``tpat_tpu/cli/pretrain.py:161-166``)."""

    def lr_fn(step: int) -> float:
        return schedules.warmup_cosine_lr(
            step / iters_per_epoch, lr=lr, min_lr=min_lr,
            warmup_epochs=warmup_epochs, total_epochs=epochs,
        )

    return lr_fn


def check_epoch_loss(mean_loss: float, epoch: int) -> float:
    """``mean_loss``, or ``FloatingPointError`` when it is not finite
    (``engine_finetune.py:108-110`` semantics)."""
    if not math.isfinite(mean_loss):
        raise FloatingPointError(
            f"Non-finite loss in epoch {epoch}, stopping pretraining"
        )
    return mean_loss


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator a step draws its masking noise and dropout from: a
    fresh one seeded from (seed, step), so a step's randomness does not
    depend on what ran before it."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def make_mae_train_step(
    model: MaskedAutoencoderViT,
    optimizer: torch.optim.Optimizer,
    mask_ratio: float,
    lr_fn: Callable[[int], float],
    seed: int = 0,
):
    """``train_step(loss_sum, step, x, *, noise=None, deterministic=False)
    -> loss_sum + loss``, one forward, backward and AdamW update at
    ``lr_fn(step)``, traced as ``pretrain.step`` around
    ``pretrain.forward``, ``pretrain.backward`` and ``pretrain.update``
    (which holds ``pretrain.grad_sync`` where there are ranks).  The loss
    is added to the device-side ``loss_sum`` without a host read.  ``noise`` replaces the step generator's masking
    noise and ``deterministic=True`` switches the meta-MLP dropout off, for
    comparisons that must see the same masks."""

    def train_step(
        loss_sum: torch.Tensor, step: int, x: torch.Tensor, *,
        noise: Optional[Noise] = None, deterministic: bool = False,
    ) -> torch.Tensor:
        with tracing.span("pretrain.step"):
            model.train()
            for group in optimizer.param_groups:
                group["lr"] = lr_fn(step)
            with tracing.span("pretrain.forward"):
                gen = step_generator(seed, step, x.device)
                loss, _, _ = model(x, mask_ratio, noise=noise, generator=gen,
                                   deterministic=deterministic)
            with tracing.span("pretrain.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with tracing.span("pretrain.update"):
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None]
                sync = (tracing.span("pretrain.grad_sync")
                        if dist_lib.group_rank_world()[1] > 1 else tracing.OFF)
                with sync:
                    dist_lib.all_reduce_mean_(grads)
                optimizer.step()
                return loss_sum + loss.detach()

    return train_step
