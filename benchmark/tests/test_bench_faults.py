"""A run with the timed path broken underneath reads ``correct`` false, and
so does the control; a sound run reads it true.  Each drives the rest of a
run (``harness.run_cell``) past the look for a card, on the CPU at tiny
sizes, with the cells' own traffic files and limits."""

import pytest

from benchmark import faults, harness
from benchmark.lib import compare
from benchmark.lib.program import train_numbers
from benchmark.reference import precision
from benchmark.tests import tiny

MAN = harness.manifest()
SEED = 2**31 + 99


def _kind(wl):
    return tiny.CELLS[wl]()[1]["kind"]


def _run(wl, trace=False):
    config, traffic = tiny.CELLS[wl]()
    return harness.run_cell(config, traffic, SEED, 0.3, trace, "cpu", 0.0,
                            harness.metric_names(MAN, wl, True),
                            harness.metric_names(MAN, wl, False))


def test_every_cell_has_a_tiny_copy():
    assert set(tiny.CELLS) == {w["name"] for w in MAN["workloads"]}


@pytest.mark.parametrize("wl", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(wl):
    out = _run(wl)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("wl,fault", [
    (w, f) for w in sorted(tiny.CELLS) for f in faults.CELL_FAULTS[_kind(w)]])
def test_a_broken_step_is_caught(wl, fault):
    with faults.FAULTS[fault]():
        out = _run(wl)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("wl", sorted(tiny.CELLS))
def test_the_control_fails_a_limit(wl):
    config, traffic = tiny.CELLS[wl]()
    drv = harness.driver_class(traffic["kind"])(config, traffic, SEED, "cpu")
    ctl, ref = drv.reference(precision.FP8), drv.reference(precision.F32)
    numbers = (compare.serve_numbers(ctl, ref) if traffic["kind"] == "serve"
               else train_numbers(ctl, ref))
    assert not compare.verdict(numbers, traffic["limits"]), numbers


def test_a_traced_run_reads_its_host_metrics():
    out = _run("vitb16-esc50.finetune-b128", trace=True)
    assert out["metrics"]["enqueue_ms.train"]["value"] > 0
    # no device on the CPU: the device metrics find nothing to read
    assert "idle.train" not in out["metrics"]
    assert out["busy_s"] == 0
