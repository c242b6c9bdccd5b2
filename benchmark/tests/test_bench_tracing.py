"""The readers of the program's spans (``lib/spans.py``): a traced window's
readers see its own records and no earlier window's; the attention rows
the program counts are ``lib/work.py``'s geometry of the window's steps;
on the card, a step's forward, backward and update tile the step on the
device."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness
from benchmark.lib import spans, work
from benchmark.lib import trace as trace_lib
from benchmark.tests import tiny

MAN = harness.manifest()
SEED = 2**31 + 57
FINETUNE = "vitb16-esc50.finetune-b128"
PRETRAIN = "mae-dec512d8b-as.pretrain-b256"


def _driver(config, traffic, device="cpu"):
    drv = harness.driver_class(traffic["kind"])(config, traffic, SEED, device)
    drv.setup()
    return drv


def _traced(drv, config, seconds, device="cpu"):
    """A window traced as ``harness.run_cell`` traces it, as its readers'
    context."""
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace_lib.WINDOW):
            window = drv.run(seconds)
    return harness.Context(window, trace_lib.from_profiler(prof),
                           config["model"], 0.0)


def _rows_per_clip(model, window):
    """``lib/work.py``'s attention rows of the window's steps, per clip."""
    rows = sum(u["batch"] * sum(b["n"] for b in work.vit_block_geometry(
        model, u["step"])) for u in window.work)
    return rows / window.clips


def test_a_windows_readers_see_its_records_alone():
    from tpat_tpu_torch.utils import tracing

    config, traffic = tiny.finetune()
    drv = _driver(config, traffic)
    first = _traced(drv, config, 0.0)  # one period: hybrid rates 0.85, 0.75
    second = _traced(drv, config, 0.0)  # the next: 0.7, 0.95
    every = tracing.records("train.forward")
    mine = spans.window_records(second, "train.forward")
    assert len(mine) == second.window.units == len(traffic["period"])
    assert mine == every[-len(mine):]
    assert not set(map(id, mine)) & set(map(id, every[:-len(mine)]))
    got = harness.read_metric("attention_tokens.train", second)
    assert got == _rows_per_clip(config["model"], second.window)
    assert got != _rows_per_clip(config["model"], first.window)
    # no device time on the CPU: the device-ms readers read nothing
    assert harness.read_metric("forward_ms.train", second) is None


def test_attention_tokens_are_the_work_of_the_windows_steps():
    from benchmark.drivers.finetune import schedule

    config, traffic = tiny.finetune()
    metric = [m for m in harness.metric_names(MAN, FINETUNE, True)
              if m["name"] == "attention_tokens.train"]
    out = harness.run_cell(config, traffic, SEED, 0.0, True, "cpu", 0.0,
                           metric, [])
    n = out["attempted"]
    start = 2 * len(traffic["period"])  # set-up's steps: two periods
    steps = [schedule(config, traffic, start + i) for i in range(n)]
    assert {s["kind"] for s in steps} == {"static", "dense", "hybrid"}
    rows = sum(sum(b["n"] for b in work.vit_block_geometry(config["model"], s))
               for s in steps)
    assert out["metrics"]["attention_tokens.train"]["value"] == rows / n


@pytest.mark.card
@pytest.mark.parametrize("workload,prefix", [(FINETUNE, "train"),
                                             (PRETRAIN, "pretrain")])
def test_forward_backward_and_update_tile_the_step(workload, prefix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, config, traffic = harness.cell(MAN, workload)
    drv = _driver(config, traffic, "cuda")
    ctx = _traced(drv, config, 3.0, "cuda")
    step = spans.device_ms_per_unit(ctx, f"{prefix}.step")
    parts = sum(spans.device_ms_per_unit(ctx, f"{prefix}.{p}")
                for p in ("forward", "backward", "update"))
    drv.free()
    torch.cuda.empty_cache()
    assert step and parts == pytest.approx(step, rel=0.01)
