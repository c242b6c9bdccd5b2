"""Time and profile the MAE pretrain step on one CUDA card (the port's
counterpart of ``scripts/bench_mae_step.py``).

Builds ``mae_vit_base_dec512d8b`` (encoder 768 wide, 12 deep; decoder 512
wide, 16 swin blocks, window (4, 4), shifts (0,0)/(2,0)), bf16, from seeded
random weights, and runs ``engine/pretrain.py``'s train step (AdamW, mask
ratio 0.8) at batch 32 on one fixed seeded spectrogram batch, at
``--target_length`` 1024 (the AudioSet grid, 64 x 8 patches: the decoder
takes the banded window kernel) or 512 (the ESC-50 grid, 32 x 8: the dense
one).  It measures:

- ms per step through the window kernels ('auto') and through the
  partitioned plain path (``window_attention_impl='xla'``), host clock over
  ``ITERS`` steps after a device sync, in turns xla, kernels, kernels,
  xla; each number is the mean of its two turns;
- a ``torch.profiler`` trace of 3 steps through the kernels: wall ms and
  device-kernel ms per step (so the device-busy share) and the device
  kernels ranked by time.

Example:
    python -m tpat_tpu_torch.cli.profile_pretrain --target_length 1024 \\
        --out profile_pretrain.json
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpat_tpu_torch.cli.profile_forward import card_name, kernel_rows

BATCH = 32  # scripts/bench_mae_step.py's batch
MASK_RATIO = 0.8
LR = 1e-4
WEIGHT_DECAY = 1e-4
TOP = 15  # device kernels listed from the profile
ITERS = 10  # timed steps per turn


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target_length", type=int, default=1024,
                   choices=(512, 1024),
                   help="1024: the AudioSet grid (banded kernel); 512: the "
                        "ESC-50 grid (dense kernel)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def pretrain_config(target_length: int, impl: str = "auto",
                    dtype: str = "bfloat16"):
    from tpat_tpu_torch.models.mae import mae_vit_base_dec512d8b

    return mae_vit_base_dec512d8b(
        target_length=target_length, num_mel_bins=128, compute_dtype=dtype,
        window_attention_impl=impl,
    )


def build(cfg, seed: int = 0, device="cuda"):
    """(model, train_step) from seeded weights: ``train_step(loss_sum,
    step, x, **kw)`` as ``engine.pretrain.make_mae_train_step`` returns it,
    at a constant lr."""
    from tpat_tpu_torch.engine import pretrain
    from tpat_tpu_torch.models.mae import MaskedAutoencoderViT

    model = MaskedAutoencoderViT(
        cfg, generator=torch.Generator().manual_seed(seed), device=device)
    opt = pretrain.make_mae_optimizer(model, weight_decay=WEIGHT_DECAY,
                                      pos_trainable=cfg.pos_trainable)
    step = pretrain.make_mae_train_step(model, opt, MASK_RATIO,
                                        lambda s: LR, seed=seed)
    return model, step


def synthetic_batch(cfg, batch: int, seed: int, device="cuda") -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(batch, 1, cfg.target_length, cfg.num_mel_bins,
                       device=device, generator=gen)


def run_steps(step, x, first: int, n: int) -> float:
    """ms per step over n steps from index ``first``, host clock between
    two device syncs."""
    total = torch.zeros((), device=x.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, first + n):
        total = step(total, i, x)
    torch.cuda.synchronize()
    if not torch.isfinite(total):
        raise FloatingPointError(f"non-finite loss in steps {first}..{first + n}")
    return (time.perf_counter() - t0) * 1e3 / n


def time_steps(target_length: int, iters: int) -> dict:
    """{'kernels': ms, 'xla': ms} per step, each the mean of two turns (xla,
    kernels, kernels, xla), after one warm-up step each."""
    x = synthetic_batch(pretrain_config(target_length), BATCH, seed=1)
    steps = {name: build(pretrain_config(target_length, impl))[1]
             for name, impl in (("kernels", "auto"), ("xla", "xla"))}
    turns: dict = {name: [] for name in steps}
    for s in steps.values():
        run_steps(s, x, 0, 1)  # warm-up: allocator growth, cuBLAS choices
    done = dict.fromkeys(steps, 1)
    for name in ("xla", "kernels", "kernels", "xla"):
        turns[name].append(run_steps(steps[name], x, done[name], iters))
        done[name] += iters
    return {name: sum(v) / len(v) for name, v in turns.items()}


def profile(target_length: int) -> dict:
    """Wall ms, device-kernel ms and busy share per step, and the device
    kernels ranked by time, over 3 steps through the kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cfg = pretrain_config(target_length)
    _, step = build(cfg)
    x = synthetic_batch(cfg, BATCH, seed=1)
    run_steps(step, x, 0, 1)
    steps = 3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        wall = run_steps(step, x, 1, steps)
    rows = kernel_rows(prof, steps)
    device = sum(r["device_ms"] for r in rows)
    return {"wall_ms_per_step": wall, "device_ms_per_step": device,
            "busy_share": device / wall, "kernels": rows[:TOP]}


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(f"card: {card}", flush=True)
    tl = args.target_length
    times = time_steps(tl, ITERS)
    print(f"MAE pretrain step b{BATCH} {tl}x128 bf16: kernels "
          f"{times['kernels']:.3f} ms, xla {times['xla']:.3f} ms per step",
          flush=True)
    prof = profile(tl)
    print(f"profile: wall {prof['wall_ms_per_step']:.3f} ms, device kernels "
          f"{prof['device_ms_per_step']:.3f} ms per step (busy "
          f"{prof['busy_share']:.3f})", flush=True)
    for r in prof["kernels"]:
        print(f"  {r['device_ms']:9.3f} ms  x{r['calls']:g}  {r['name'][:100]}",
              flush=True)
    result = {"card": card, "batch": BATCH, "target_length": tl,
              "step_ms": times, "profile": prof}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def cli(argv=None):
    main(get_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
