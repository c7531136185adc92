"""BENCHMARK.json against the limits of its format, and the files the
harness finds by name: every cell's workload file names an existing
configuration and traffic mix and agrees with BENCHMARK.json, every
metric has its reader, every op of every pipeline its plain reference."""

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

import check  # noqa: E402
import generator  # noqa: E402
import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    return harness.load_benchmark()


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    # the check's budget with 24 cells
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    b = bench()
    assert 1 <= len(b["configs"]) <= 24
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for name, arg in check.parse_spec(cfg["pipeline"]):
            assert os.path.isfile(os.path.join(BENCH, "reference", f"{name}.py")), name
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_workloads_name_existing_files_and_agree():
    b = bench()
    names = [w["name"] for w in b["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(names) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        cell = harness.load_cell(w["name"], b)  # raises where the files disagree
        assert cell.traffic["loop"] in generator.loop_kinds()
        assert cell.traffic["entry"] in harness.entry_forms()
        assert cell.workload["check_calls"] >= 1 and cell.workload["trace_calls"] >= 10
        assert harness.metric_names(b, w["name"], per_layer=True)
        e2e = harness.metric_names(b, w["name"], per_layer=False)
        assert "setup_s" in e2e and len(e2e) >= 2
    assert sorted(os.listdir(os.path.join(BENCH, "workloads"))) == sorted(
        f"{n}.json" for n in names)


def test_metrics_have_their_readers():
    b = bench()
    seen = set()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        cap = 0.25
        assert 0.01 <= m["bound"] <= cap
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        assert m["better"] in ("lower", "higher")
        seen.add(m["name"])
        mod = harness.load_metric(m["name"])
        assert callable(mod.read)


@pytest.mark.parametrize("sub", ["configs", "traffic", "workloads", "metrics", "reference",
                                 "loops", "entries"])
def test_files_are_named_from_names(sub):
    for f in os.listdir(os.path.join(BENCH, sub)):
        if f == "__pycache__":
            continue
        stem, ext = os.path.splitext(f)
        assert NAME.match(stem) and ext in (".json", ".py"), f
