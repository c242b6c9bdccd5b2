"""Finetune traffic: ``TrainModule.train_step`` of the port in a fixed
period of step kinds, closed loop, on seeded batches on the device.

The traffic file gives the batch, the period (``{'kind': 'dense',
'mask_prob'}``, ``{'kind': 'hybrid'}``, ``{'kind': 'static'}``), the
scheduled rates the hybrid steps take in turn across periods, how many
distinct batches the steps cycle through, the epoch whose learning rate
the run starts at, how many first steps the reference follows, and the
limits of the correctness numbers.

Set-up builds one ``TrainModule`` and its state from the seeded weights
and drives it through two whole periods: the first ``check_steps`` steps
give the correctness readings (each step's loss, every leaf's first
gradient as AdamW's first moment holds it, every leaf's change over those
steps), and the rest warm up every step kind and width of the mix.  The
window then runs whole periods, without a sync, until ``seconds`` have
passed, and waits for the device.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark.harness import Window
from benchmark.lib import frozen, seeds, work
from benchmark.lib.program import (check_sizes, first_moment, leaf_norms,
                                   leaf_sizes, no_tf32, train_numbers,
                                   tuples)
from benchmark.reference import adamw as ref_adamw
from benchmark.reference import precision
from benchmark.reference import vit as ref_vit


def data(config: Dict, traffic: Dict, seed: int, device) -> List[tuple]:
    """The distinct seeded (spectrogram, one-hot label) batches."""
    m = config["model"]
    return frozen.synthetic_batches(
        torch, (traffic["batch"], 1, m["target_length"], m["num_mel_bins"]),
        m["num_classes"], traffic["distinct_batches"],
        seeds.generator(seed, "data", device), device)


def schedule(config: Dict, traffic: Dict, i: int) -> Dict:
    """Step ``i``'s descriptor: its kind, and its hybrid rate or keep rates
    (``lib/work.py``'s form)."""
    m = config["model"]
    period = traffic["period"]
    p, j = divmod(i, len(period))
    entry = dict(period[j])
    if entry["kind"] == "hybrid":
        per = sum(e["kind"] == "hybrid" for e in period)
        h = p * per + sum(e["kind"] == "hybrid" for e in period[:j])
        rates = traffic["hybrid_rates"]
        entry.update(rate=rates[h % len(rates)],
                     n_buckets=config["train"]["anneal_buckets"])
    elif entry["kind"] == "static":
        entry = work.static_step(m)
    return entry


def lr_at(config: Dict, traffic: Dict, update: int) -> float:
    t = config["train"]
    ipe = config["deployment"]["iters_per_epoch"]
    lr = t["blr"] * traffic["batch"] / 256.0
    return ref_adamw.warmup_cosine(update / ipe, lr, t["min_lr"],
                                   t["warmup_epochs"], t["epochs"])


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.start = (traffic["start_epoch"]
                      * config["deployment"]["iters_per_epoch"])

    # -- the program ----------------------------------------------------

    def _program_step_args(self, desc: Dict) -> Dict:
        from tpat_tpu_torch.engine import schedules

        cfg = self.cfg
        if desc["kind"] == "dense":
            return dict(phase="dense", mask_prob=desc.get("mask_prob", 0.0))
        if desc["kind"] == "static":
            return dict(phase="static")
        rates = tuple(desc["rate"] if i in cfg.drop_loc else 1.0
                      for i in range(cfg.depth))
        return dict(
            phase="anneal", keep_rates=rates,
            static_rates=schedules.bucket_keep_rates(
                rates, base_keep_rate=cfg.base_keep_rate,
                n_buckets=self.tc.anneal_buckets),
            num_left=schedules.masked_kept_counts(rates, cfg.drop_loc,
                                                  cfg.num_patches))

    def _step(self, i: int):
        desc = schedule(self.config, self.traffic, i)
        x, y = self.batches[i % len(self.batches)]
        self.mod.train_step(self.state, self.acc, x, y,
                            **self._program_step_args(desc))
        return desc

    def setup(self):
        from tpat_tpu_torch import config as pc
        from tpat_tpu_torch.engine.train import TrainModule

        c = self.config
        prog = c["program"]
        self.cfg = getattr(pc, prog["factory"])(**tuples(prog["args"]))
        check_sizes(self.cfg, c["model"])
        self.tc = pc.TrainConfig(**tuples(c["train"]))
        specs = ref_vit.param_specs(c["model"])
        w0 = seeds.weights(specs, self.seed, self.device)
        self.mod = TrainModule(self.cfg, self.tc, "ce",
                               iters_per_epoch=c["deployment"]["iters_per_epoch"],
                               device=self.device)
        self.state = self.mod.load(w0, seed=seeds.derive(self.seed, "steps"))
        self.state.step = self.start
        self.acc = self.mod._zero_acc()
        self.batches = data(c, self.traffic, self.seed, self.device)
        names = {id(p): n for n, p in self.state.model.named_parameters()}
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        losses = []
        for i in range(self.traffic["check_steps"]):
            before = self.acc["loss_sum"].clone()
            self._step(i)
            losses.append(self.acc["loss_sum"] - before)
            if i == 0:
                grad = leaf_norms({
                    names[id(p)]: first_moment(self.state.optimizer, p)
                    / (1 - beta1) for p in self.state.params})
        change = leaf_norms({names[id(p)]: p.detach() - w0[names[id(p)]]
                             for p in self.state.params})
        self.readings = {"loss": [float(v) for v in losses], "grad": grad,
                         "change": change}
        del w0
        self.next = self.traffic["check_steps"]
        warm = 2 * len(self.traffic["period"])
        while self.next < warm:
            self._step(self.next)
            self.next += 1

    def run(self, seconds: float) -> Window:
        from torch.profiler import record_function

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        enq, units = [], []
        t0 = time.perf_counter()
        while True:
            for _ in range(len(self.traffic["period"])):
                ts = time.perf_counter()
                with record_function("bench.train_step"):
                    desc = self._step(self.next)
                enq.append(time.perf_counter() - ts)
                units.append({"model": "vit", "step": desc,
                             "batch": self.batch, "rows": self.batch,
                             "backward": True})
                self.next += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        return Window(t1 - t0, len(units), len(units) * self.batch, enq,
                      units)

    def end_to_end(self, window: Window) -> Dict:
        return {"train_clips_per_s": window.clips / window.seconds}

    def free(self):
        del self.mod, self.state, self.acc, self.batches

    # -- the reference --------------------------------------------------

    def reference(self, prec) -> Dict:
        """The reference's readings over the first ``check_steps`` steps:
        each step's loss, every leaf's first gradient norm, every leaf's
        change; on the same seeded weights, data and draws."""
        c, t = self.config, self.traffic
        m = c["model"]
        dev = self.device
        with no_tf32():
            w0 = seeds.weights(ref_vit.param_specs(m), self.seed, dev)
            P = {n: w.clone().requires_grad_(n not in ref_vit.FROZEN)
                 for n, w in w0.items()}
            train = [n for n in P if n not in ref_vit.FROZEN]
            scale, decay = ref_adamw.finetune_groups(
                {n: tuple(P[n].shape) for n in train}, m["depth"],
                c["train"]["layer_decay"], c["train"]["weight_decay"])
            opt = ref_adamw.AdamW(scale, decay)
            gen = torch.Generator(device=dev).manual_seed(
                seeds.derive(self.seed, "steps"))
            batches = data(c, t, self.seed, dev)
            b, chunk = t["batch"], t["reference_rows"]
            losses, grad = [], None
            for i in range(t["check_steps"]):
                desc = schedule(c, t, i)
                x, y = batches[i % len(batches)]
                draw = ref_vit.draws(m, desc, b, gen, dev, train=True)
                total = 0.0
                for s in range(0, b, chunk):
                    rows = slice(s, s + chunk)
                    logits = ref_vit.forward(P, m, desc, x[rows],
                                             ref_vit.take(draw, rows), prec)
                    loss = ref_vit.soft_ce_sum(logits, y[rows]) / b
                    loss.backward()
                    total += float(loss.detach())
                losses.append(total)
                grads = {n: P[n].grad for n in train}
                if i == 0:
                    grad = leaf_norms(grads)
                opt.step({n: P[n].data for n in train}, grads,
                         lr_at(c, t, self.start + i))
                for n in train:
                    P[n].grad = None
            change = leaf_norms({n: P[n].detach() - w0[n] for n in train})
        return {"loss": losses, "grad": grad, "change": change,
                "sizes": leaf_sizes({n: P[n] for n in train})}

    def check(self, prec=precision.F32) -> Dict:
        return train_numbers(self.readings, self.reference(prec))
