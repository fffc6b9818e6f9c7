"""BENCHMARK.json keeps to its schema's shapes and characters, and every
configuration, traffic mix, limit set and metric it names is found as a
file of its own by that name."""

import json
import os
import re

import pytest

from slam_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["slam_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    assert BENCH["command"][1] == "slam_bench/run.py"


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert line_ok(x["why"])
    for c in BENCH["configs"]:
        assert line_ok(c["source"]) and set(c) == {"name", "source", "file", "reduced", "why"}
    for m in BENCH["per_layer"]:
        assert line_ok(m["layer"])


def test_cells_end_to_end_and_per_layer():
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    assert all(w["chips"] == 1 and set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["frames_per_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "frames_per_s" and set(m.get("workloads", cells)) <= cells
    for cell in cells:
        assert harness.metrics_for(BENCH, cell, "per_layer")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = harness.load_json(harness.config_file(w["config"]))
    mix = harness.load_json(harness.traffic_file(w["traffic"]))
    lim = harness.load_json(harness.limits_file(w["name"]))
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert harness.generator(mix["generator"]).generate
    assert {"ate_mm", "kp_bad_pct", "desc_bits", "reproj_px", "ba_gap_pct"} <= set(lim)
    if cfg["sensor"] == "stereo_inertial":
        assert "preint_rel_err" in lim
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"slam_bench/configs/{w['config']}.json"
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    mod = harness.metric_reader(m["name"])
    assert mod.NAME == m["name"] and mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    assert callable(mod.read) and mod.READS
    if "layer" in m:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_config_files_state_their_settings():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["capacity"] == {"max_keyframes": 512, "max_landmarks": 32768}
        assert cfg["orb"]["n_features"] == 1200 and cfg["camera"]["width"] == 752
