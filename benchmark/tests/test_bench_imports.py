"""What the benchmark's processes load, by top-level module name: the run
path loads neither JAX, jaxlib, flax nor the JAX package, and the
reference loads nothing of the program.  Each check runs in a fresh
interpreter."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpat_tpu"}


def _tops(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_path_loads_no_jax():
    tops = _tops(
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "man = harness.manifest()\n"
        "for wl, make in tiny.CELLS.items():\n"
        "    c, t = make()\n"
        "    harness.run_cell(c, t, 5, 0.2, True, 'cpu', 0.0,\n"
        "                     harness.metric_names(man, wl, True),\n"
        "                     harness.metric_names(man, wl, False))\n"
        "    harness.run_cell(c, t, 5, 0.2, False, 'cpu', 0.0,\n"
        "                     harness.metric_names(man, wl, True),\n"
        "                     harness.metric_names(man, wl, False))\n")
    assert "tpat_tpu_torch" in tops
    assert not tops & FORBIDDEN


# a run past the look for a card (``run.measure`` on the CPU, the tiny
# finetune cell, traced) in which {where} imports a stub package named
# {name}: the metric readers, which run after the window, or the check
_GATE = """
import sys
sys.path[:0] = [{stub!r}, {root!r}]
from benchmark import harness, run
from benchmark.tests import tiny

where, name = {where!r}, {name!r}
if where == "metric":
    read = harness.read_metric

    def read_metric(metric, ctx):
        __import__(name)
        return read(metric, ctx)

    harness.read_metric = read_metric
elif where == "check":
    driver_class = harness.driver_class

    def patched(kind):
        class Driver(driver_class(kind)):
            def check(self, *a, **k):
                __import__(name)
                return super().check(*a, **k)
        return Driver

    harness.driver_class = patched
wl = "vitb16-esc50.finetune-b128"
man = harness.manifest()
c, t = tiny.CELLS[wl]()
args = run.get_parser().parse_args(
    ["--workload", wl, "--seed", "5", "--seconds", "0.2", "--trace", "1"])
sys.exit(run.measure(args, c, t, harness.metric_names(man, wl, True),
                     harness.metric_names(man, wl, False), "cpu",
                     {{"platform": "cpu", "count": 1}}))
"""


@pytest.mark.parametrize("where,name", [
    ("none", "json"), ("metric", "jax"), ("metric", "tpat_tpu"),
    ("check", "flax"), ("check", "jaxlib")])
def test_a_run_that_loads_jax_prints_no_result(tmp_path, where, name):
    for stub in ("jax", "jaxlib", "flax", "tpat_tpu"):
        (tmp_path / stub).mkdir()
        (tmp_path / stub / "__init__.py").write_text("")
    code = _GATE.format(stub=str(tmp_path), root=str(ROOT), where=where,
                        name=name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    if where == "none":
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
        return
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert name in out.stderr.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops("import benchmark.reference.vit, benchmark.reference.mae, "
                 "benchmark.reference.adamw, benchmark.reference.precision, "
                 "benchmark.lib.frozen, benchmark.lib.work, "
                 "benchmark.lib.compare, benchmark.lib.seeds")
    assert "torch" in tops
    assert not tops & (FORBIDDEN | {"tpat_tpu_torch"})


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "vitb16-esc50.serve-b128", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        return  # on a card the run is the card test's to check
    assert out.returncode != 0
    assert "correct" not in out.stdout
