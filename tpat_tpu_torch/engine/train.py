"""Training engine of the port (``tpat_tpu/engine/train.py``), run eagerly.

- per-update warmup + cosine LR through AdamW with layer-wise decay
  (``engine/optimizer.py``);
- keep-rate phases: dense (with 2D time/frequency masking) -> anneal
  ('hybrid' by default, or 'bucketed' / 'masked') -> static pruned;
- the soft-target CE, BCE and hard CE losses;
- gradient accumulation over ``accum_iter`` micro-steps, updating on the
  mean gradient, as ``optax.MultiSteps``;
- metric sums kept on the device and read only at ``nan_check_every``, at
  log points and at the epoch's end, where a non-finite loss aborts with
  ``FloatingPointError``.

Drop-path and 2D masking draw from the state's ``torch.Generator`` on the
model's device.  The JAX package's compiled-step memo, its mesh and tensor
parallelism, ``custom_rank`` and the device frontend (``preprocess``) have
no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpat_tpu_torch.config import TrainConfig, ViTConfig
from tpat_tpu_torch.engine import optimizer as opt_lib
from tpat_tpu_torch.engine import schedules
from tpat_tpu_torch.models.vit import AudioViT


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -(sum targets * log_softmax(logits))."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy over every element."""
    return F.binary_cross_entropy_with_logits(logits, targets)


def hard_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against the argmax of the targets (the AST CE path)."""
    idx = targets.argmax(dim=-1)
    return -F.log_softmax(logits, dim=-1).gather(1, idx[:, None]).mean()


LOSS_FNS = {
    "ce": soft_cross_entropy,
    "bce": bce_with_logits,
    "ce_hard": hard_cross_entropy,
}


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the generator training draws from.
    ``step`` counts micro-steps, as the JAX ``TrainState.step``; the
    optimizer's update index is ``step // accum_iter``."""

    model: AudioViT
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    grad_sum: Optional[List[torch.Tensor]] = None  # inside an accumulation window

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


@dataclasses.dataclass
class TrainModule:
    """Configs plus the step functions; ``init`` or ``load`` makes the
    state that ``train_epoch`` advances."""

    model_cfg: ViTConfig
    train_cfg: TrainConfig
    loss_type: str
    iters_per_epoch: int
    device: Union[str, torch.device] = "cpu"

    def __post_init__(self):
        tc = self.train_cfg
        if tc.base_keep_rate < 1.0:
            if tuple(tc.drop_loc) != tuple(self.model_cfg.drop_loc):
                raise ValueError(
                    f"train_cfg.drop_loc {tc.drop_loc} != model_cfg.drop_loc "
                    f"{self.model_cfg.drop_loc}"
                )
            if tc.base_keep_rate != self.model_cfg.base_keep_rate:
                raise ValueError(
                    f"train_cfg.base_keep_rate {tc.base_keep_rate} != "
                    f"model_cfg.base_keep_rate {self.model_cfg.base_keep_rate}"
                )
        if tc.anneal_mode not in ("masked", "bucketed", "hybrid"):
            raise ValueError(f"unknown anneal_mode {tc.anneal_mode!r}")
        self.loss_fn = LOSS_FNS[self.loss_type]
        self.accum = max(tc.accum_iter, 1)
        eff_batch = tc.batch_size * tc.accum_iter * tc.num_hosts
        self.lr_fn = opt_lib.make_lr_fn(
            tc, max(self.iters_per_epoch // tc.accum_iter, 1), eff_batch
        )
        self.device = torch.device(self.device)

    # -- state ----------------------------------------------------------

    def _build_state(self, model: AudioViT, seed: Optional[int]) -> TrainState:
        seed = self.train_cfg.seed if seed is None else seed
        return TrainState(
            model=model,
            optimizer=opt_lib.make_optimizer(model, self.model_cfg, self.train_cfg),
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

    def init(self, seed: Optional[int] = None) -> TrainState:
        """Fresh parameters from ``seed`` (the train config's by default)."""
        s = self.train_cfg.seed if seed is None else seed
        model = AudioViT(
            self.model_cfg, generator=torch.Generator().manual_seed(s),
            device=self.device,
        )
        return self._build_state(model, seed)

    def load(
        self, state_dict: Mapping[str, torch.Tensor], seed: Optional[int] = None
    ) -> TrainState:
        """State around imported weights (a reference ``.pth`` state dict);
        the update counter starts at 0, as in JAX."""
        model = AudioViT(self.model_cfg, device=self.device)
        model.load_state_dict(state_dict, strict=True)
        return self._build_state(model, seed)

    # -- steps ----------------------------------------------------------

    def _forward(
        self, state: TrainState, x, phase: str, mask_prob: float,
        static_rates=None, keep_rates=None, num_left=None,
    ) -> torch.Tensor:
        model, gen = state.model, state.generator
        if phase == "anneal":
            if static_rates is not None:
                return model.forward_hybrid(
                    x, keep_rates, num_left=num_left, bucket_rates=static_rates,
                    generator=gen,
                )
            return model.forward_masked(
                x, keep_rates, num_left=num_left, generator=gen
            )
        if static_rates is not None:
            kr = static_rates
        else:
            kr = (1.0,) * self.model_cfg.depth if phase == "dense" else None
        return model(
            x, kr, mask_t_prob=mask_prob, mask_f_prob=mask_prob, generator=gen
        )

    def loss_and_grads(
        self, state: TrainState, x, y, phase: str, mask_prob: float = 0.0,
        static_rates=None, keep_rates=None, num_left=None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One forward and backward in training mode: (loss, gradients of
        ``state.params``)."""
        state.model.train()
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        logits = self._forward(
            state, x, phase, mask_prob, static_rates, keep_rates, num_left
        )
        loss = self.loss_fn(logits, y)
        grads = torch.autograd.grad(loss, state.params)
        return loss.detach(), list(grads)

    def train_step(
        self, state: TrainState, acc: Dict, x, y, phase: str,
        mask_prob: float = 0.0, static_rates=None, keep_rates=None,
        num_left=None,
    ):
        """One micro-step (``train.py:229-278``): gradients, an optimizer
        update every ``accum_iter`` micro-steps on their mean, and the
        device-side metric sums."""
        loss, grads = self.loss_and_grads(
            state, x, y, phase, mask_prob, static_rates, keep_rates, num_left
        )
        update = state.step // self.accum
        acc["grad_norm_sum"] += opt_lib.global_grad_norm(grads)
        if self.accum > 1:
            if state.grad_sum is None:
                state.grad_sum = [g.clone() for g in grads]
            else:
                torch._foreach_add_(state.grad_sum, grads)
        if (state.step + 1) % self.accum == 0:
            mean = grads
            if self.accum > 1:
                mean = [g / self.accum for g in state.grad_sum]
                state.grad_sum = None
            if self.train_cfg.clip_grad is not None:
                opt_lib.clip_by_global_norm_(mean, self.train_cfg.clip_grad)
            for p, g in zip(state.params, mean):
                p.grad = g
            opt_lib.set_lr(state.optimizer, self.lr_fn(update))
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        acc["loss_sum"] += loss
        acc["finite"] &= torch.isfinite(loss)
        acc["lr_last"] = self.lr_fn(update)
        state.step += 1

    def _zero_acc(self) -> Dict:
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return {
            "loss_sum": zero.clone(),
            "grad_norm_sum": zero.clone(),
            "lr_last": 0.0,
            "finite": torch.ones((), dtype=torch.bool, device=self.device),
        }

    # -- epoch ----------------------------------------------------------

    def train_epoch(
        self,
        state: TrainState,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        epoch: int,
        log_every: int = 0,
        log_fn: Callable[[str], None] = print,
        nan_check_every: int = 100,
    ) -> Tuple[TrainState, Dict]:
        """One epoch with the reference's phase rules (``train.py:392-611``).
        ``batches`` yields (x, y) with a fixed batch size, as numpy arrays or
        tensors.  Every ``log_every`` steps the window means of loss and
        grad norm go to ``log_fn``.  Returns (state, {'loss', 'grad_norm',
        'phase'})."""
        cfg = self.train_cfg
        depth = self.model_cfg.depth
        phase = schedules.schedule_phase(
            epoch,
            shrink_start_epoch=cfg.shrink_start_epoch,
            shrink_epochs=cfg.shrink_epochs,
            base_keep_rate=cfg.base_keep_rate,
        )
        # 2D masking regularises only before the shrink
        mask_prob = cfg.mask_t_prob if phase == "dense" else 0.0
        all_ones = (1.0,) * depth
        it = epoch * self.iters_per_epoch
        acc = self._zero_acc()
        n_steps = 0
        check_from = 0
        prev = {"loss_sum": 0.0, "grad_norm_sum": 0.0, "n": 0}

        def fetch_and_check(i):
            """One host read covering every step since the last check."""
            nonlocal check_from
            if not bool(acc["finite"]):
                raise FloatingPointError(
                    f"Non-finite loss between iters {check_from}..{i} of epoch "
                    f"{epoch}, stopping training"
                )
            check_from = i + 1
            return float(acc["loss_sum"]), float(acc["grad_norm_sum"])

        for i, (x, y) in enumerate(batches):
            if phase != "anneal":
                self.train_step(state, acc, x, y, phase, mask_prob)
            else:
                sched_it = it if cfg.keep_rate_iter_mode == "per_epoch" else it + i
                rates = schedules.scheduled_keep_rates(
                    sched_it,
                    epoch,
                    shrink_start_epoch=cfg.shrink_start_epoch,
                    total_epochs=cfg.shrink_start_epoch + cfg.shrink_epochs,
                    iters_per_epoch=self.iters_per_epoch,
                    base_keep_rate=cfg.base_keep_rate,
                    num_blocks=depth,
                    drop_loc=cfg.drop_loc,
                )
                bucketed = schedules.bucket_keep_rates(
                    rates,
                    base_keep_rate=cfg.base_keep_rate,
                    n_buckets=cfg.anneal_buckets,
                )
                num_left = schedules.masked_kept_counts(
                    rates, cfg.drop_loc, self.model_cfg.num_patches
                )
                if cfg.anneal_mode == "bucketed":
                    # each bucket is a static pruned step at its own widths
                    self.train_step(
                        state, acc, x, y, "static", static_rates=bucketed
                    )
                elif cfg.anneal_mode == "masked":
                    self.train_step(
                        state, acc, x, y, "anneal", keep_rates=rates,
                        num_left=num_left,
                    )
                elif rates == all_ones:
                    # the cosine's t=0 point: the refine is the identity, so
                    # the dense step (without 2D masking) is the same math
                    self.train_step(state, acc, x, y, "dense")
                else:
                    self.train_step(
                        state, acc, x, y, "anneal", static_rates=bucketed,
                        keep_rates=rates, num_left=num_left,
                    )
            n_steps += 1
            if log_every and i % log_every == 0:
                loss_sum, gn_sum = fetch_and_check(i)
                win = max(n_steps - prev["n"], 1)
                log_fn(
                    f"Epoch: [{epoch}] [{i}] loss: "
                    f"{(loss_sum - prev['loss_sum']) / win:.4f}  lr: "
                    f"{acc['lr_last']:.6f}  grad_norm: "
                    f"{(gn_sum - prev['grad_norm_sum']) / win:.4f}"
                )
                prev = {"loss_sum": loss_sum, "grad_norm_sum": gn_sum,
                        "n": n_steps}
            elif nan_check_every and (i + 1) % nan_check_every == 0:
                fetch_and_check(i)
        if not n_steps:
            return state, {"loss": float("nan"), "grad_norm": float("nan"),
                           "phase": phase}
        loss_sum, gn_sum = fetch_and_check(n_steps - 1)
        return state, {
            "loss": loss_sum / n_steps,
            "grad_norm": gn_sum / n_steps,
            "phase": phase,
        }
