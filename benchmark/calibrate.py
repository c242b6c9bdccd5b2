"""Readings from which the correctness limits are set (run on the card,
not by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--faults half_batch] --out <file>.json

For each of ``--seeds``: the cell's set-up (its first steps, or for a
serving cell a short window at the cell's load), then the comparison with
the float32 reference, as a run makes it.  For each of
``--control-seeds``: the control, the reference computed in fp8 in the
program's place, against the float32 reference, and each fault named in
``--faults`` that the cell can have (``faults.py``), planted in the
program, against the reference.  With ``--rates`` (a serving cell), a
sweep of offered loads.  One process, so that the kernels build once.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(drv, kind, prec=None):
    import torch

    from benchmark.lib import compare
    from benchmark.lib.program import train_numbers
    from benchmark.reference import precision

    if prec is None:
        drv.setup()
        if kind == "serve":
            drv.run(2.0)
        drv.free()
        gc.collect()
        torch.cuda.empty_cache()
        if kind == "serve":
            return drv.check()
        ref = drv.reference(precision.F32)
        return dict(train_numbers(drv.readings, ref),
                    worst_change=worst_leaves(drv.readings, ref))
    if kind == "serve":
        return compare.serve_numbers(drv.reference(prec),
                                     drv.reference(precision.F32))
    ctl, ref = drv.reference(prec), drv.reference(precision.F32)
    return dict(train_numbers(ctl, ref), worst_change=worst_leaves(ctl, ref))


def worst_leaves(program, ref, top=4):
    """The leaves of largest change gap, with their gradients' norms
    beside the median leaf's and their numbers of entries, for the look at
    what drives the number."""
    import statistics

    from benchmark.lib import compare

    med = statistics.median(ref["change"].values())
    gmed = statistics.median(ref["grad"].values())
    rows = sorted(((abs(program["change"][n] - ref["change"][n])
                    / max(ref["change"][n], med), n, ref["grad"][n] / gmed,
                   ref["sizes"][n])
                   for n in compare.moved_leaves(ref["grad"])), reverse=True)
    return rows[:top]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="",
                   help="comma-separated faults of faults.py to plant, on "
                        "each control seed")
    p.add_argument("--rates", default="",
                   help="serving cells: clips/s to offer in turn (0: a "
                        "closed loop), each for --sweep-seconds")
    p.add_argument("--sweep-seconds", type=float, default=10.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import faults, harness
    from benchmark.reference import precision

    if not torch.cuda.is_available():
        raise SystemExit("calibrate runs on a CUDA card")
    _, config, traffic = harness.cell(harness.manifest(), args.workload)
    kind = traffic["kind"]
    Driver = harness.driver_class(kind)
    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {}}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        out["program"][seed] = readings(Driver(config, traffic, seed, "cuda"),
                                        kind)
        print(f"program seed {seed}: {out['program'][seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for seed in controls:
        t0 = time.perf_counter()
        out["control"][seed] = readings(Driver(config, traffic, seed, "cuda"),
                                        kind, precision.FP8)
        print(f"control seed {seed}: {out['control'][seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for name in [f for f in args.faults.split(",") if f]:
            if name in faults.CELL_FAULTS[kind]:
                with faults.FAULTS[name]():
                    r = readings(Driver(config, traffic, seed, "cuda"), kind)
                out["faults"].setdefault(name, {})[seed] = r
                print(f"fault {name} seed {seed}: {r}", flush=True)
    rates = [float(r) for r in args.rates.split(",") if r]
    if rates:
        from benchmark.lib.trace import percentile

        drv = Driver(config, dict(traffic), 1, "cuda")
        drv.setup()
        out["sweep"] = {}
        for rate in rates:
            drv.traffic["rate_clips_per_s"] = rate
            w = drv.run(args.sweep_seconds)
            r = {"offered": rate, "served_clips_per_s": w.clips / w.seconds,
                 "p50_ms": percentile(w.latency_s, 50) * 1e3,
                 "p95_ms": percentile(w.latency_s, 95) * 1e3,
                 "max_ms": max(w.latency_s) * 1e3,
                 "last_ms": w.latency_s[-1] * 1e3, "requests": w.units}
            out["sweep"][str(rate)] = r
            print(f"sweep {r}", flush=True)
        drv.free()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
