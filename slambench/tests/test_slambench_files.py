"""BENCHMARK.json and the files it names: every configuration, traffic
mix, per-layer reader and kernel count is found by its name, and every
name and unit keeps to the allowed characters."""

import json
import re

import pytest

from slambench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end":
                    assert LINE.fullmatch(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = run.load_cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    assert c["traffic"]["feed"] in ("host", "device")
    assert c["traffic"]["frames"] > c["traffic"]["warm_frames"]
    run.program_config(c["config"])
    layer = [m for m in BENCH["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_found_by_name(metric):
    assert callable(run.load_module("metrics", metric).read)


@pytest.mark.parametrize("kernel", ["klt_track", "build_pyramid"])
def test_kernel_count_found_by_name(kernel):
    assert callable(run.load_module("roofline", kernel).work)


def test_config_files_hold_their_names():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("slambench/configs/")
        assert json.loads((run.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
