"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench_small import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_metric_entries(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reported
    for cell in cells:
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])
        assert any(m["name"] != "setup_s" and cell in m.get("workloads", cells)
                   for m in bench["end_to_end"])


def test_every_named_file_is_found(bench):
    from portbench import harness

    for w in bench["workloads"]:
        cell = harness.cell_of(bench, w["name"])
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "kinds", cell["config"]["kind"] + ".py"))
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(harness.reader(m["name"]).read)
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path, bench):
    """A new configuration, traffic mix and metric, each a new file, are
    found by their names in ``BENCHMARK.json``."""
    import importlib.util
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "flow100k.json").read_text())
    cfg["engine"]["max_flows"] = 50_000
    (pb / "configs" / "flow50k.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "pull16k-door.json").read_text())
    mix["rows_per_pull"] = 4096
    (pb / "traffic" / "pull4k-door.json").write_text(json.dumps(mix))
    (pb / "metrics" / "rows_per_pull.door.py").write_text(
        "def read(ctx):\n    return ctx.traffic['rows_per_pull']\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({**new["configs"][0], "name": "flow50k",
                           "file": "portbench/configs/flow50k.json"})
    new["workloads"].append({"name": "flow50k-pull4k-door",
                             "config": "flow50k", "traffic": "pull4k-door",
                             "chips": 1, "why": "a new cell"})
    new["per_layer"].append({"name": "rows_per_pull.door", "unit": "rows",
                             "better": "higher", "source": "program_counter",
                             "layer": "client", "moves": "verdicts_per_s",
                             "workloads": ["flow50k-pull4k-door"]})
    new["end_to_end"][0]["workloads"].append("flow50k-pull4k-door")
    spec = importlib.util.spec_from_file_location(
        "copied_harness", pb / "harness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.HERE = str(pb)
    cell = mod.cell_of(new, "flow50k-pull4k-door", str(root))
    assert cell["config"]["engine"]["max_flows"] == 50_000
    assert cell["traffic"]["rows_per_pull"] == 4096
    assert [m["name"] for m in cell["per_layer"]] == ["rows_per_pull.door"]
    ctx = mod.Context(traffic=cell["traffic"])
    assert mod.reader("rows_per_pull.door").read(ctx) == 4096
