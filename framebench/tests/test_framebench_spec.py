"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import math
import os
import re

import pytest

from framebench.harness import spec

BENCH = json.load(open(os.path.join(spec.REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.REPO, p))
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.load(open(os.path.join(spec.REPO, c["file"])))
        assert cfg.get("reduced", []) == c["reduced"]


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len(set(WORKLOADS)) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, math.floor(0.25 * len(ws)))
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = spec.load_cell(workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(spec.metric_reader(m["name"]).read)
    assert cell.config["output"] and cell.traffic and cell.check["limits"]
    assert int(cell.config.get("ranks", 1)) == cell.chips


def test_every_metric_file_is_named_in_the_benchmark():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.ROOT, "metrics"))
             if f.endswith(".py")}
    assert files == names


def test_split_metric_reads_its_quantity():
    """``frame_ms.bands4`` is the frame time of the cells it lists."""
    from framebench.harness import frames, main, trace
    cell = spec.load_cell("demo_spheres_bands4.sweep")
    win = frames.Window(frames=10, window_s=0.5, intervals_ms=[50.0] * 10,
                        host_step_ms=[], spill_waves=0.0, peak_bytes=0,
                        kept=[])
    out = main.result_of(cell, win, trace.Reading(device_name="cpu"), {},
                         12.0, 0, [], 0, False, "")
    assert out["metrics"]["frame_ms.bands4"]["value"] == 50.0
    assert out["metrics"]["frame_ms_p95.bands4"]["value"] == 50.0
    assert out["metrics"]["setup_s"]["value"] == 12.0
    assert "frame_ms" not in out["metrics"]
