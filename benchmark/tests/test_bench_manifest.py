"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re

import pytest

from benchmark import harness
from benchmark.lib.program import check_sizes, tuples

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]] + [
        w["name"] for w in MAN["workloads"]] + [
        m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert _line_ok(w["why"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert _line_ok(c["why"]) and _line_ok(c["source"])
        assert c["reduced"] == []
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["per_layer"]:
        assert _line_ok(m["layer"])


def test_keys_of_each_entry():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in MAN["workloads"]:
        mine = harness.metric_names(MAN, w["name"], False)
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = harness.metric_names(MAN, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in [x["name"] for x in mine], m["name"]
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(workload):
    entry, config, traffic = harness.cell(MAN, workload)
    assert (harness.BENCH / "drivers" / f"{traffic['kind']}.py").exists()
    for m in harness.metric_names(MAN, workload, True):
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    assert set(traffic["limits"]) and all(v > 0 for v in traffic["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_sizes_are_the_programs(config):
    from tpat_tpu_torch import config as pc
    from tpat_tpu_torch.models import mae

    entry = {c["name"]: c for c in MAN["configs"]}[config]
    c = json.loads((harness.ROOT / entry["file"]).read_text())
    factory = c["program"]["factory"]
    module = pc if hasattr(pc, factory) else mae
    cfg = getattr(module, factory)(**tuples(c["program"]["args"]))
    check_sizes(cfg, c["model"])
    assert c["source"] == entry["source"]


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_no_cell_pair_twice():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
