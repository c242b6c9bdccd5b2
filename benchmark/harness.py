"""The benchmark's harness: find a cell's files by name, run its driver, read
its metrics, decide ``correct`` and build the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``benchmark/configs/<config>.json`` (the entry's ``file``): the sizes,
  the program's factory and arguments, the recipe, what was assumed;
- ``benchmark/traffic/<traffic>.json``: a mix's parameters, with ``kind``
  naming the driver (``benchmark/drivers/<kind>.py``) that reads them, and
  the limits of its correctness numbers;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float or None`` (None: nothing to read, the metric is left
  out of the line).

``run_cell`` drives a cell on any device, so that the tests can run it on
the CPU at tiny sizes; ``run.py`` is the entry point that insists on the
card.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpat_tpu")  # top-level module names


@dataclasses.dataclass
class Window:
    """What a driver's measured window did."""

    seconds: float  # host clock: start to the end of the last unit's work
    units: int  # train steps or requests completed
    clips: int  # clips trained on or classified
    enqueue_s: List[float]  # host seconds of each call, without a sync
    work: List[Dict]  # per unit: the shape descriptor ``lib/work.py`` reads
    latency_s: List[float] = dataclasses.field(default_factory=list)
    # seconds the units were in service, where the window also waits for
    # arrivals (an open loop); None: the whole window
    service_s: Optional[float] = None


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader sees."""

    window: Window
    trace: object  # lib.trace.Trace, or None without a trace
    model: Dict  # the configuration's sizes
    sm_clock_hz: float


def manifest(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: Dict, workload: str, root: Path = ROOT):
    """(workload entry, config dict, traffic dict) of a cell, by name."""
    wl = {w["name"]: w for w in man["workloads"]}
    if workload not in wl:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(wl)}")
    entry = wl[workload]
    cfg_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    return entry, config, traffic


def metric_names(man: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's metric entries: its end-to-end ones, or with ``trace`` its
    per-layer ones."""
    if not trace:
        return [m for m in man["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in man["per_layer"] if workload in m["workloads"]]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(kind: str):
    return load_module(BENCH / "drivers" / f"{kind}.py",
                       f"benchmark_driver_{kind}").Driver


def read_metric(name: str, ctx: Context) -> Optional[float]:
    mod = load_module(BENCH / "metrics" / f"{name}.py",
                      "benchmark_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(config: Dict, traffic: Dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             per_layer: List[Dict], end_to_end: List[Dict],
             sm_clock_hz: float = 0.0) -> Dict:
    """Set up, measure, check.  Returns {'metrics', 'checks', 'correct',
    'attempted', 'failed', 'memory_peak_bytes', 'busy_s', 'window_s',
    'breakdown'}; ``t_start`` is the host clock when the run began, so
    that set-up counts the imports too."""
    import torch

    from benchmark.lib import compare
    from benchmark.lib import trace as trace_lib

    drv = driver_class(traffic["kind"])(config, traffic, seed, device)
    drv.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(trace_lib.WINDOW):
                window = drv.run(seconds)
        tr = trace_lib.from_profiler(prof)
        del prof
    else:
        window = drv.run(seconds)
    out: Dict = {"attempted": window.units, "failed": 0}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    metrics: Dict = {}
    if trace:
        ctx = Context(window, tr, config["model"], sm_clock_hz)
        for m in per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["busy_s"] = tr.busy_s()
        out["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    else:
        values = drv.end_to_end(window)
        values["setup_s"] = setup_s
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.check()
    limits = traffic["limits"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    out["correct"] = compare.verdict(numbers, limits)
    return out
