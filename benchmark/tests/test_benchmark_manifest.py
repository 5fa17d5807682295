"""BENCHMARK.json against the shapes the benchmark keeps to, and every
piece it names found by name under ``benchmark/``."""

import json
import os
import re

import pytest

from benchmark import run
from benchmark.tests.tiny import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(spec["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in spec["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            texts = ["why", "source"] if group == "configs" else (
                ["why"] if group == "workloads" else ["layer"] if group == "per_layer" else [])
            for key in texts:
                assert LINE.match(e[key]), (e["name"], key)
    assert all(LINE.match(w) for w in spec["command"])
    assert len(names) == len(set(names))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in spec["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entries_have_exactly_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in spec["workloads"]:
        mine = [m["name"] for m in run.cell_metrics(spec, w["name"], "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        assert run.cell_metrics(spec, w["name"], "per_layer")


def test_moves_and_workloads_agree(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        for w in m.get("workloads", sorted(cells)):
            assert w in cells and w in moved, (m["name"], w)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(LINE.match(layer) for layer in layers)


def test_every_piece_is_found_by_name(spec):
    for c in spec["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in spec["workloads"]:
        cell, cfg, traffic, limits = run.cell_files(spec, w["name"])
        assert limits, f"{w['name']} has no limits"
        assert run.driver(traffic).KIND
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_every_file_under_paths_is_named_from_name_characters(spec):
    for p in spec["paths"]:
        for dirpath, dirnames, files in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".cache")]
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
    assert os.path.isdir(HERE)
