"""Pretrain traffic: the port's MAE train step
(``engine/pretrain.py::make_mae_train_step``) closed loop on seeded
spectrograms on the device, at the recipe's batch and flags.

The traffic file gives the batch, how many distinct batches the steps
cycle through, the epoch whose learning rate the run starts at, how many
first steps the reference follows, the rows the reference computes at a
time, and the limits.  Set-up builds the model from the seeded weights,
its AdamW and its step, and runs the first ``check_steps`` steps, which
give the correctness readings and warm the step's one shape; the window
runs steps without a sync until ``seconds`` have passed and waits for the
device.  Each step draws its masks and the decoder's dropout from a
generator seeded from (the run's step seed, the step's index), as the
program's step does.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark.harness import Window
from benchmark.lib import seeds
from benchmark.lib.program import (check_sizes, first_moment, leaf_norms,
                                   leaf_sizes, no_tf32, train_numbers,
                                   tuples)
from benchmark.reference import adamw as ref_adamw
from benchmark.reference import mae as ref_mae
from benchmark.reference import precision

STEP_SEED_BITS = 40  # seed * 1_000_003 + step must stay under 2**64


def data(config: Dict, traffic: Dict, seed: int, device) -> List:
    m = config["model"]
    gen = seeds.generator(seed, "data", device)
    return [torch.randn(traffic["batch"], 1, m["target_length"],
                        m["num_mel_bins"], device=device, generator=gen)
            for _ in range(traffic["distinct_batches"])]


def step_seed(seed: int) -> int:
    return seeds.derive(seed, "steps") % (1 << STEP_SEED_BITS)


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.start = (traffic["start_epoch"]
                      * config["deployment"]["iters_per_epoch"])
        self.lr = config["train"]["blr"] * self.batch / 256.0

    def _step(self, i: int):
        x = self.batches[i % len(self.batches)]
        self.loss_sum = self.step_fn(self.loss_sum, self.start + i, x)

    def setup(self):
        from tpat_tpu_torch.engine import pretrain
        from tpat_tpu_torch.models import mae

        c, t = self.config, self.config["train"]
        prog = c["program"]
        cfg = getattr(mae, prog["factory"])(**tuples(prog["args"]))
        check_sizes(cfg, c["model"])
        w0 = seeds.weights(ref_mae.param_specs(c["model"]), self.seed,
                           self.device)
        self.model = mae.MaskedAutoencoderViT(cfg, device=self.device)
        self.model.load_state_dict(w0, strict=True)
        self.opt = pretrain.make_mae_optimizer(
            self.model, weight_decay=t["weight_decay"], pos_trainable=False)
        lr_fn = pretrain.mae_lr_fn(
            lr=self.lr, min_lr=t["min_lr"], warmup_epochs=t["warmup_epochs"],
            epochs=t["epochs"],
            iters_per_epoch=c["deployment"]["iters_per_epoch"])
        self.step_fn = pretrain.make_mae_train_step(
            self.model, self.opt, t["mask_ratio"], lr_fn,
            seed=step_seed(self.seed))
        self.loss_sum = torch.zeros((), device=self.device)
        self.batches = data(c, self.traffic, self.seed, self.device)
        params = [(n, p) for n, p in self.model.named_parameters()
                  if p.requires_grad]
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses = []
        for i in range(self.traffic["check_steps"]):
            before = self.loss_sum.clone()
            self._step(i)
            losses.append(self.loss_sum - before)
            if i == 0:
                grad = leaf_norms({n: first_moment(self.opt, p) / (1 - beta1)
                                   for n, p in params})
        change = leaf_norms({n: p.detach() - w0[n] for n, p in params})
        self.readings = {"loss": [float(v) for v in losses], "grad": grad,
                         "change": change}
        del w0
        self.next = self.traffic["check_steps"]

    def run(self, seconds: float) -> Window:
        from torch.profiler import record_function

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        enq, units = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            with record_function("bench.pretrain_step"):
                self._step(self.next)
            enq.append(time.perf_counter() - ts)
            units.append({"model": "mae", "batch": self.batch,
                         "rows": self.batch, "backward": True})
            self.next += 1
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        return Window(t1 - t0, len(units), len(units) * self.batch, enq,
                      units)

    def end_to_end(self, window: Window) -> Dict:
        return {"pretrain_clips_per_s": window.clips / window.seconds}

    def free(self):
        del self.model, self.opt, self.step_fn, self.loss_sum, self.batches

    def reference(self, prec) -> Dict:
        """The reference's readings over the first ``check_steps`` steps, in
        blocks of ``reference_rows`` rows (the loss is a sum over rows over
        the batch's masked-patch count, so the blocks' gradients add)."""
        c, t = self.config, self.traffic
        m, tr = c["model"], c["train"]
        dev = self.device
        with no_tf32():
            w0 = seeds.weights(ref_mae.param_specs(m), self.seed, dev)
            P = {n: w.clone().requires_grad_(n not in ref_mae.FROZEN)
                 for n, w in w0.items()}
            train = [n for n in P if n not in ref_mae.FROZEN]
            scale, decay = ref_adamw.pretrain_groups(
                {n: tuple(P[n].shape) for n in train}, tr["weight_decay"])
            opt = ref_adamw.AdamW(scale, decay)
            batches = data(c, t, self.seed, dev)
            b, chunk = t["batch"], t["reference_rows"]
            ipe = c["deployment"]["iters_per_epoch"]
            losses, grad = [], None
            for i in range(t["check_steps"]):
                step = self.start + i
                gen = torch.Generator(device=dev).manual_seed(
                    step_seed(self.seed) * 1_000_003 + step)
                draw = ref_mae.draws(m, b, gen, dev, train=True)
                x = batches[i % len(batches)]
                _, mask, _ = ref_mae.mask_2d(m, draw["noise"], b, dev)
                count = mask.sum()
                total = 0.0
                for s in range(0, b, chunk):
                    rows = slice(s, s + chunk)
                    sub = dict(draw, noise=tuple(n[rows] for n in draw["noise"]))
                    part, _ = ref_mae.loss_sum(P, m, x[rows], sub, prec)
                    loss = part / count
                    loss.backward()
                    total += float(loss.detach())
                losses.append(total)
                grads = {n: P[n].grad for n in train}
                if i == 0:
                    grad = leaf_norms(grads)
                lr = ref_adamw.warmup_cosine(step / ipe, self.lr, tr["min_lr"],
                                             tr["warmup_epochs"], tr["epochs"])
                opt.step({n: P[n].data for n in train}, grads, lr)
                for n in train:
                    P[n].grad = None
            change = leaf_norms({n: P[n].detach() - w0[n] for n in train})
        return {"loss": losses, "grad": grad, "change": change,
                "sizes": leaf_sizes({n: P[n] for n in train})}

    def check(self, prec=precision.F32) -> Dict:
        return train_numbers(self.readings, self.reference(prec))
