"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its check (``checks/<workload>.json``) and
the readers of its per-layer metrics (``metrics/<metric>.py``).

A later cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with everything a run needs."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: tuple     # metric entries of BENCHMARK.json
    per_layer: tuple


def _reports(metric: dict, cell: str, reported: set) -> bool:
    """Whether `cell` reports `metric`: its own ``workloads`` list, or, for
    a per-layer metric without one, every cell that reports the metric it
    moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(name: str, bench_path: str | None = None) -> Cell:
    bench_path = bench_path or os.path.join(REPO, "BENCHMARK.json")
    bench = _load_json(bench_path)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(REPO, cfg_entry["file"]))
    traffic = _load_json(os.path.join(ROOT, "traffic", w["traffic"] + ".json"))
    check = _load_json(os.path.join(ROOT, "checks", name + ".json"))
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name, set()))
    reported = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"]
                  if _reports(m, name, reported))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                check=check, end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(reading)`` returns the
    metric or None, and an optional ``WRAP`` = (module, attribute,
    bytes function) names a kernel wrapper whose calls' least bytes the
    eager frames count under the metric's name."""
    path = os.path.join(ROOT, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "framebench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
