"""Run one cell of the benchmark once on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, with
``--trace 1``, ``breakdown``; then ``checks``, each correctness number with
its limit, which also end standard error.  Exits non-zero and prints no
result without a CUDA card, with fewer cards than the cell asks for, or
when the run (set-up, window, metrics and check) has loaded JAX, jaxlib,
flax or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches stay inside the checkout, at fixed
# paths (``tpat_tpu_torch/ops/_build.py`` builds into build/tpat_tpu_torch)
CACHE = ROOT / "build" / "benchmark_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    from benchmark import harness

    man = harness.manifest()
    entry, config, traffic = harness.cell(man, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from benchmark.lib import frozen

    card = frozen.card_name()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "power_limit": card.split(",")[-1].strip()}
    sm_clock = frozen.sm_clock_max_hz() if args.trace else 0.0
    return measure(args, config, traffic,
                   harness.metric_names(man, args.workload, True),
                   harness.metric_names(man, args.workload, False),
                   "cuda", device, sm_clock)


def measure(args, config, traffic, per_layer, end_to_end, device_type: str,
            device: dict, sm_clock: float = 0.0) -> int:
    """Everything of a run after the look for a card: set-up, the window,
    the metrics, the check; then, once all of that has run in this
    process, the look for JAX, and the result line."""
    from benchmark import harness

    out = harness.run_cell(config, traffic, args.seed, args.seconds,
                           bool(args.trace), device_type, T_START, per_layer,
                           end_to_end, sm_clock)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the benchmark measures "
              "tpat_tpu_torch alone; no result", file=sys.stderr)
        return 3
    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
