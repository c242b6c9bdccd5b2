"""On the card: one short run of each cell through ``run.py``, whose last
line must be the result the contract asks for.  Each test skips on a
machine without a CUDA card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

MAN = harness.manifest()


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_a_short_run_prints_a_correct_result(workload, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    names = {m["name"] for m in harness.metric_names(MAN, workload,
                                                     bool(trace))}
    assert set(line["metrics"]) == names
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
