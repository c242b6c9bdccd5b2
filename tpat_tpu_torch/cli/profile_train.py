"""Profile the train step on one CUDA card.

Builds the finetune default, ViT-B/16 at ESC-50 geometry (512x128 input,
N = 257), keep 0.7 at blocks (3, 6, 9), bf16, drop-path 0.1, from seeded
random weights, and runs ``TrainModule.train_step`` at ft_esc50's batch of
128 in each step variant of the hybrid schedule:

- ``dense_mask2d``: the dense phase, 2D time/frequency masking at 0.3;
- ``dense``: the dense step without masking (the anneal at rates 1.0);
- ``hybrid_0.8``: the hybrid anneal step at bucket 0.8 (rates 0.775);
- ``hybrid_0.9``: the hybrid anneal step at bucket 0.9 (rates 0.85);
- ``static``: keep 0.7.

For each it takes a ``torch.profiler`` trace of 3 steps through the
kernels: wall ms, device-kernel ms (so the device-busy share) and the
device kernels ranked by time.  The ms per step through the kernels and
through plain attention are ``chip_smoke.py``'s to measure; it reuses
``train_configs``, ``step_variants`` and ``synthetic_batches``.

Example:
    python -m tpat_tpu_torch.cli.profile_train --out profile_train.json
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpat_tpu_torch.cli.profile_forward import card_name, kernel_rows

TRAIN_BATCH = 128  # ft_esc50.sh's batch_size
TOP = 15  # device kernels listed from each profile
# the schedule's rate at the drop blocks for each hybrid variant's bucket
HYBRID_RATES = {"hybrid_0.8": 0.775, "hybrid_0.9": 0.85}


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def train_configs():
    """The model and train configuration of ``scripts/ft_esc50.sh``."""
    from tpat_tpu_torch.config import TrainConfig, audiomae_vit_base

    cfg = audiomae_vit_base(
        target_length=512, num_classes=50, base_keep_rate=0.7,
        drop_loc=(3, 6, 9), compute_dtype="bfloat16",
    )
    tc = TrainConfig(
        batch_size=TRAIN_BATCH, epochs=60, blr=1e-3, min_lr=1e-5,
        warmup_epochs=4, mask_t_prob=0.3, mask_f_prob=0.3, base_keep_rate=0.7,
        drop_loc=(3, 6, 9), shrink_start_epoch=20, shrink_epochs=40,
        anneal_mode="hybrid", anneal_buckets=4, keep_rate_iter_mode="per_epoch",
    )
    return cfg, tc


def step_variants(cfg):
    """{name: train_step keyword arguments}."""
    from tpat_tpu_torch.engine import schedules

    variants = {
        "dense_mask2d": dict(phase="dense", mask_prob=0.3),
        "dense": dict(phase="dense"),
    }
    for name, rate in HYBRID_RATES.items():
        rates = tuple(rate if i in cfg.drop_loc else 1.0
                      for i in range(cfg.depth))
        variants[name] = dict(
            phase="anneal", keep_rates=rates,
            static_rates=schedules.bucket_keep_rates(rates, base_keep_rate=0.7),
            num_left=schedules.masked_kept_counts(rates, cfg.drop_loc,
                                                  cfg.num_patches),
        )
    variants["static"] = dict(phase="static")
    return variants


def synthetic_batches(cfg, batch: int, n: int, seed: int, device="cuda"):
    """``n`` seeded (spectrogram, one-hot label) batches on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn(batch, 1, cfg.target_length, cfg.num_mel_bins,
                        device=device, generator=gen)
        labels = torch.randint(0, cfg.num_classes, (batch,), device=device,
                               generator=gen)
        out.append((x, torch.nn.functional.one_hot(labels, cfg.num_classes)
                    .float()))
    return out


def profile_step(mod, state, x, y, kw) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acc = mod._zero_acc()
    mod.train_step(state, acc, x, y, **kw)
    torch.cuda.synchronize()
    steps = 3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.train_step(state, acc, x, y, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = kernel_rows(prof, steps)
    device = sum(r["device_ms"] for r in rows)
    return {"wall_ms_per_step": wall, "device_ms_per_step": device,
            "busy_share": device / wall, "kernels": rows[:TOP]}


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    from tpat_tpu_torch.engine.train import TrainModule

    card = card_name()
    print(f"card: {card}", flush=True)
    cfg, tc = train_configs()
    (x, y), = synthetic_batches(cfg, TRAIN_BATCH, 1, seed=0)
    mod = TrainModule(cfg, tc, "ce", iters_per_epoch=100, device="cuda")
    state = mod.init()
    result = {"card": card, "batch": TRAIN_BATCH, "profile": {}}
    for name, kw in step_variants(cfg).items():
        prof = profile_step(mod, state, x, y, kw)
        result["profile"][name] = prof
        print(f"profile {name}: wall {prof['wall_ms_per_step']:.3f} ms, device "
              f"kernels {prof['device_ms_per_step']:.3f} ms per step (busy "
              f"{prof['busy_share']:.3f})", flush=True)
        for r in prof["kernels"]:
            print(f"  {r['device_ms']:9.3f} ms  x{r['calls']:g}  "
                  f"{r['name'][:100]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def cli(argv=None):
    main(get_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
