"""BENCHMARK.json keeps to the benchmark's contract: its names, units,
lengths and keys, and which metric each cell reports."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_units_and_lengths():
    b = _bench()
    assert set(b) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51 and len(b["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for kind in ("end_to_end", "per_layer") for m in b[kind]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert [m["bound"] for m in b["end_to_end"] if m["name"] == "setup_s"] == [0.25]


def test_every_cell_reports_what_the_contract_asks():
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    e2e = {m["name"]: m for m in b["end_to_end"]}
    for cell in cells:
        mine = [m["name"] for m in b["end_to_end"] if reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(reports(m, cell) for m in b["per_layer"]), cell
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_named_file_exists():
    from benchmark import harness

    b = _bench()
    for w in b["workloads"]:
        cell = harness.find_cell(b, w["name"])
        harness.load_module("drivers", cell.mix["driver"])
        harness.reference(cell.cfg)
        assert set(cell.limits) == {"logp_gap", "argmax_lp_gap"}
        for m in cell.metrics:
            assert hasattr(harness.metric_reader(m["name"]), "read")
