"""Training engine of the port (``tpat_tpu/engine/train.py``), run eagerly.

- per-update warmup + cosine LR through AdamW with layer-wise decay, or
  the AST recipe (``optimizer='ast_adam'``: Adam with coupled L2 and the
  replayed warmup/MultiStepLR table), ``engine/optimizer.py``;
- keep-rate phases: dense (with 2D time/frequency masking) -> anneal
  ('hybrid' by default, or 'bucketed' / 'masked') -> static pruned;
- the soft-target CE, BCE and hard CE losses;
- gradient accumulation over ``accum_iter`` micro-steps, updating on the
  mean gradient, as ``optax.MultiSteps``;
- metric sums kept on the device and read only at ``nan_check_every``, at
  log points and at the epoch's end, where a non-finite loss aborts with
  ``FloatingPointError``.

Drop-path, dropout and 2D masking draw from the state's ``torch.Generator``
on the model's device.  ``custom_rank`` (the custom-rank ablation) reaches
the static forwards; an anneal epoch refuses it, as in JAX.  ``preprocess``
(the device frontend of ``--device_frontend``, ``ops/frontend.py``) runs at
the head of every step, ``preprocess(x, generator, specaug, train=True)``,
with SpecAug only in the dense phase (the reference switches the
augmentations off once the shrink starts); with a preprocess, the hybrid
anneal's t = 0 point stays a hybrid step instead of taking the dense one,
which would turn SpecAug back on.  Batches come as numpy arrays (the host
loader, copied to the device at the step) or as f32 tensors already on the
device (the device dataset cache, ``data/device_cache.py``), which the step
uses where they lie.

Data parallelism (``parallel/``): in a process group each rank trains on
its own rows of the global batch.  The parameters start equal (broadcast
from rank 0 when the state is built), the gradients are averaged across
ranks before each optimizer update (one flat ``all_reduce`` per update,
after the ``accum_iter`` micro-steps: JAX's ``psum``), and the loss and
grad-norm sums are averaged across ranks wherever they are read, so every
rank logs the global means.  At ``accum_iter`` 1 the grad norm is that of
the averaged gradient, as in JAX; above 1 each micro-step's norm is the
rank's own, averaged.  The lr rule counts ``num_hosts`` (the data ranks)
in the effective batch.  The JAX package's compiled-step memo has no
counterpart here.

Tensor parallelism (``mesh``, a ``parallel.sharding.Mesh2D`` with a model
axis, ``train.py:104-115, 345-376``): the attention is forced to
``attention_impl='xla'`` (the kernels are batch-parallel only, so a model
axis launches no B1-B3; ``use_fused_layernorm`` is left as it is), the
state is built whole on every rank (rank 0's, broadcast) and then cut
(``models.vit.shard_model_``), so the AdamW moments of a cut weight are
cut alike; the gradient mean and the metric sums run over the data group,
and the grad norm sums the squares of each cut gradient over the model
group.  Checkpoints gather the cuts (``utils/checkpoint.py``).
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
from tpat_tpu_torch.models.vit import AudioViT, shard_model_
from tpat_tpu_torch.parallel import distributed as dist_lib
from tpat_tpu_torch.parallel import sharding


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
    # which of ``params`` the model axis cuts (all False without one)
    sharded: Optional[List[bool]] = None

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


@dataclasses.dataclass
class TrainModule:
    """Configs plus the step functions; ``init`` or ``load`` makes the
    state that ``train_epoch`` advances.  It runs on the card unless
    ``device`` says otherwise (the CPU tests pass ``device='cpu'``)."""

    model_cfg: ViTConfig
    train_cfg: TrainConfig
    loss_type: str
    iters_per_epoch: int
    device: Union[str, torch.device] = "cuda"
    # the custom-rank ablation ('mean' or 'std'): static phases only
    custom_rank: Optional[str] = None
    # on-device preprocessing of each batch:
    # fn(x, generator, specaug: bool, train: bool) -> model input
    preprocess: Optional[Callable] = None
    # a (data, model) mesh (parallel.sharding.make_mesh_2d); None: the
    # process group's ranks are all data ranks
    mesh: Optional[sharding.Mesh2D] = None

    def __post_init__(self):
        tc = self.train_cfg
        self.tp = self.mesh.tp if self.mesh is not None else 1
        if self.tp > 1:
            mc = self.model_cfg
            sharding.check_divisible(
                mc.num_heads, int(mc.embed_dim * mc.mlp_ratio), self.tp)
            if mc.attention_impl != "xla":
                self.model_cfg = dataclasses.replace(mc, attention_impl="xla")
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
        if tc.optimizer == "ast_adam":
            self.lr_fn = opt_lib.make_ast_lr_fn(
                tc, max(self.iters_per_epoch, 1), accum=tc.accum_iter
            )
        else:
            eff_batch = tc.batch_size * tc.accum_iter * tc.num_hosts
            self.lr_fn = opt_lib.make_lr_fn(
                tc, max(self.iters_per_epoch // tc.accum_iter, 1), eff_batch
            )
        self.device = torch.device(self.device)

    # -- state ----------------------------------------------------------

    def _build_state(self, model: AudioViT, seed: Optional[int]) -> TrainState:
        seed = self.train_cfg.seed if seed is None else seed
        # every rank starts from rank 0's parameters, then takes its cut
        dist_lib.broadcast_(list(model.state_dict().values()))
        if self.mesh is not None:
            shard_model_(model, self.mesh)
        state = TrainState(
            model=model,
            optimizer=opt_lib.make_optimizer(model, self.model_cfg, self.train_cfg),
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )
        names = {id(p): n for n, p in model.named_parameters()}
        state.sharded = [bool(sharding.param_pspec(names[id(p)])) and self.tp > 1
                         for p in state.params]
        return state

    def _data_mean_(self, tensors: List[torch.Tensor]):
        """Each tensor's mean over the data ranks, in place."""
        if self.mesh is None:
            dist_lib.all_reduce_mean_(tensors)
        elif self.mesh.dp > 1:
            dist_lib.all_reduce_mean_(tensors, group=self.mesh.data_group)

    def _grad_norm(self, state: TrainState, grads) -> torch.Tensor:
        return opt_lib.global_grad_norm(
            grads, state.sharded,
            self.mesh.model_group if self.tp > 1 else None)

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
            if self.custom_rank is not None:
                raise AssertionError("custom-rank ablation is static-phase only")
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
            x, kr, mask_t_prob=mask_prob, mask_f_prob=mask_prob,
            custom_rank=self.custom_rank, generator=gen,
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
        if self.preprocess is not None:
            x = self.preprocess(x, state.generator, specaug=phase == "dense",
                                train=True)
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
        if self.accum == 1:
            # the global batch's gradient (JAX's psum)
            self._data_mean_(grads)
        acc["grad_norm_sum"] += self._grad_norm(state, grads)
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
                self._data_mean_(mean)
            if self.train_cfg.clip_grad is not None:
                opt_lib.clip_by_global_norm_(
                    mean, self.train_cfg.clip_grad,
                    norm=self._grad_norm(state, mean))
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
        log_fn: Callable[[str], None] = dist_lib.print_rank0,
        nan_check_every: int = 100,
    ) -> Tuple[TrainState, Dict]:
        """One epoch with the reference's phase rules (``train.py:392-611``).
        ``batches`` yields (x, y) with a fixed batch size, as numpy arrays or
        tensors.  Every ``log_every`` steps the window means of loss and
        grad norm go to ``log_fn`` (rank 0's ``print`` by default).  In a
        process group every rank must run the same number of steps; the
        sums read are the means over the ranks.  Returns (state, {'loss',
        'grad_norm', 'phase'})."""
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
        if (phase == "anneal" and cfg.anneal_mode != "masked"
                and self.custom_rank is not None):
            # the masked mode refuses it in _forward, as JAX's does
            raise AssertionError("custom-rank ablation is static-phase only")
        all_ones = (1.0,) * depth
        it = epoch * self.iters_per_epoch
        acc = self._zero_acc()
        n_steps = 0
        check_from = 0
        prev = {"loss_sum": 0.0, "grad_norm_sum": 0.0, "n": 0}

        def fetch_and_check(i):
            """One host read covering every step since the last check: the
            sums' means over the ranks, and a non-finite loss on any rank
            stops every rank."""
            nonlocal check_from
            sums = torch.stack([acc["loss_sum"], acc["grad_norm_sum"],
                                acc["finite"].float()])
            self._data_mean_([sums])
            loss_sum, gn_sum, finite = sums.tolist()
            if finite != 1.0:
                raise FloatingPointError(
                    f"Non-finite loss between iters {check_from}..{i} of epoch "
                    f"{epoch}, stopping training"
                )
            check_from = i + 1
            return loss_sum, gn_sum

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
                elif rates == all_ones and self.preprocess is None:
                    # the cosine's t=0 point: the refine is the identity, so
                    # the dense step (without 2D masking) is the same math;
                    # not with a preprocess, whose dense step runs SpecAug
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
        dist_lib.check_equal(n_steps, f"steps of epoch {epoch}")
        if not n_steps:
            return state, {"loss": float("nan"), "grad_norm": float("nan"),
                           "phase": phase}
        loss_sum, gn_sum = fetch_and_check(n_steps - 1)
        return state, {
            "loss": loss_sum / n_steps,
            "grad_norm": gn_sum / n_steps,
            "phase": phase,
        }
