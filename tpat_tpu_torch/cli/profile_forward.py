"""Time and profile the serving forward on one CUDA card.

Builds the serving default, ViT-B/16 at ESC-50 geometry (512x128 input,
N = 257), keep 0.7 at blocks (3, 6, 9), bf16, from seeded random weights,
and measures:

- forward ms per bucket (CUDA events, ``--iters`` forwards after 3 warm-up
  forwards) for three variants of one config knob each: the default
  (fused attention kernel, ``gelu_poly``), ``gelu_impl='exact'`` and
  ``attention_impl='xla'`` (plain attention).  The variants run in the order
  A B C and then C B A, and each number is the mean of its two turns;
- a ``torch.profiler`` trace of 3 forwards of the default at the largest
  bucket: the wall ms per forward and the device kernels ranked by device
  time.

Example:
    python -m tpat_tpu_torch.cli.profile_forward --out profile.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

VARIANTS = (
    ("default", {}),
    ("gelu_exact", {"gelu_impl": "exact"}),
    ("attention_xla", {"attention_impl": "xla"}),
)


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--buckets", default="1,8,32,128",
                   help="comma-separated batch sizes to time")
    p.add_argument("--iters", type=int, default=10,
                   help="timed forwards per bucket and turn")
    p.add_argument("--top", type=int, default=15,
                   help="device kernels listed from the profile")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def serving_config():
    from tpat_tpu_torch.config import audiomae_vit_base

    return audiomae_vit_base(
        target_length=512, num_classes=50, base_keep_rate=0.7,
        drop_loc=(3, 6, 9), drop_path_rate=0.0, compute_dtype="bfloat16",
    )


def _forward_ms(model, x, iters: int) -> float:
    with torch.no_grad():
        for _ in range(3):
            model(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_buckets(cfg, buckets, iters: int) -> dict:
    """{variant: {bucket: ms}}, each the mean of two turns."""
    from tpat_tpu_torch.models.vit import AudioViT

    models = {}
    for name, change in VARIANTS:
        m = AudioViT(dataclasses.replace(cfg, **change),
                     generator=torch.Generator().manual_seed(0), device="cuda")
        models[name] = m.eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {b: torch.randn(b, 1, cfg.target_length, cfg.num_mel_bins,
                             device="cuda", generator=gen) for b in buckets}
    turns: dict = {name: {b: [] for b in buckets} for name, _ in VARIANTS}
    order = [name for name, _ in VARIANTS]
    for name in order + order[::-1]:
        for b in buckets:
            turns[name][b].append(_forward_ms(models[name], inputs[b], iters))
    return {name: {b: sum(v) / len(v) for b, v in per.items()}
            for name, per in turns.items()}


def profile(cfg, batch: int, top: int) -> dict:
    """Wall ms per forward and the device kernels ranked by device time,
    over 3 forwards of the default variant at ``batch``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpat_tpu_torch.models.vit import AudioViT

    model = AudioViT(cfg, generator=torch.Generator().manual_seed(0),
                     device="cuda").eval()
    x = torch.randn(batch, 1, cfg.target_length, cfg.num_mel_bins,
                    device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    forwards = 3
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(forwards):
                model(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / forwards
    rows = [
        {"name": e.key, "calls_per_forward": e.count / forwards,
         "device_ms_per_forward": e.self_device_time_total / 1e3 / forwards}
        for e in prof.key_averages()
        if e.self_device_time_total > 0 and e.device_type.name == "CUDA"
    ]
    rows.sort(key=lambda r: -r["device_ms_per_forward"])
    return {
        "batch": batch,
        "wall_ms_per_forward": wall,
        "device_ms_per_forward": sum(r["device_ms_per_forward"] for r in rows),
        "kernels": rows[:top],
    }


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    buckets = [int(b) for b in args.buckets.split(",") if b.strip()]
    cfg = serving_config()
    times = time_buckets(cfg, buckets, args.iters)
    for name, per in times.items():
        row = ", ".join(f"b{b} {ms:.3f} ms" for b, ms in per.items())
        print(f"{name}: {row}; b{buckets[-1]} "
              f"{buckets[-1] / (per[buckets[-1]] / 1e3):.1f} clips/s",
              flush=True)
    prof = profile(cfg, buckets[-1], args.top)
    print(f"profile b{prof['batch']}: wall {prof['wall_ms_per_forward']:.3f} "
          f"ms, device kernels {prof['device_ms_per_forward']:.3f} ms per "
          "forward", flush=True)
    for r in prof["kernels"]:
        print(f"  {r['device_ms_per_forward']:9.3f} ms  "
              f"x{r['calls_per_forward']:g}  {r['name'][:100]}", flush=True)
    result = {"card": card,
              "forward_ms": times, "profile": prof}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def cli(argv=None):
    main(get_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
