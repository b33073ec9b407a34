"""The port's bench record (``python -m drts_tpu_torch.bench --record``)
against the reference's ``bench.py:main``, on the CPU with no render:

- with the five bench functions of each side stubbed to return the same
  fixed numbers, the two records have the same keys (nested keys
  included) and the same headline, pipeline and mesh values, full and
  fast (``DRTS_BENCH_FAST=1`` against ``fast=True``);
- a bench that raises lands in "errors" under the reference's prefix, the
  other keys stay as the reference's do, and the port's main exits 1;
- ``counter_report`` equals the report the reference's
  ``bench_full_pipeline`` computes (``bench.py:128-147``) from the same
  counters;
- the six recipes: the configs each side's record builds, the
  ``load_textures`` it passes to ``myscene.build`` and the tessellation it
  passes to ``as_mesh_scene``, captured on their way and stopped before
  the first render;
- the keys of the line without a flag stay as they were.

The reference's ``bench.py`` arms a 45-minute SIGALRM when imported; the
fixture cancels it at once and restores the previous handler.
"""

import dataclasses
import importlib.util
import inspect
import json
import os
import shutil
import signal
import types

import jax
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import camera as jcamera, pathtrace as jpathtrace
from drts_tpu.models import clusters as jclusters
from drts_tpu_torch import bench
from drts_tpu_torch.models import clusters as tclusters
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.models import pipeline as tpipeline
from drts_tpu_torch.ops import camera as tcamera, pathtrace as tpathtrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# The stubs' numbers: (Mray/s, frame ms, rays per frame), ...
TRACE = (123.456789, 16.789012, 2071234.0)
PASSES = {"update": 3.14, "gbuffer": 5.56, "restir_initial": 27.1,
          "trace": 140.23, "sharc_update": 33.95, "post": 20.6}
REPORT = {"wavefront_overflow_paths": 0.0, "lights_dropped": 12.0,
          "sharc_hit_rate": {"b2": 0.5, "b3": 0.25},
          "sharc_gate_rate": {"b2": 0.75, "b3": 0.5},
          "sharc_entry_rate": {"b2": 0.625, "b3": 0.375}}
FULL_MS, UP_MS, MESH_PIPE_MS = 250.123456, 210.987654, 350.554321
MESH = {2: (33.3333333, 60.606061), 8: (12.345678, 170.171717)}
BENCHES = ("trace", "full_pipeline", "upscaled", "mesh", "mesh8",
           "mesh_pipeline")


class Stop(Exception):
    """Raised where a recipe would render its first frame."""


@pytest.fixture(scope="module")
def ref():
    """The reference's root bench.py as a module, its import alarm
    cancelled."""
    previous = signal.getsignal(signal.SIGALRM)
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
    return module


@pytest.fixture
def fidelity_copy(tmp_path):
    path = str(tmp_path / "FIDELITY_TORCH.json")
    shutil.copy(os.path.join(REPO, "FIDELITY.json"), path)
    return path


def failing(name, fails):
    if name == fails:
        raise RuntimeError(f"{name} failed")


def stubbed(calls, real, fn):
    """`fn` in place of `real`, recording the arguments of each call with
    `real`'s defaults filled in (the device and textures aside)."""
    sig = inspect.signature(real)

    def stub(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append((real.__name__, {
            k: v for k, v in bound.arguments.items()
            if k not in ("device", "load_textures")}))
        return fn(*args, **kw)
    return stub


def stub_reference(monkeypatch, ref, fails=None, calls=None):
    monkeypatch.setattr(ref, "_enable_compile_cache", lambda: None)

    def trace(**kw):
        failing("trace", fails)
        return TRACE

    def full(**kw):
        failing("full_pipeline", fails)
        return FULL_MS, dict(PASSES), json.loads(json.dumps(REPORT))

    def upscaled(**kw):
        failing("upscaled", fails)
        return UP_MS

    def mesh(bounces=2, **kw):
        failing("mesh" if bounces == 2 else "mesh8", fails)
        return MESH[bounces]

    def mesh_pipeline(**kw):
        failing("mesh_pipeline", fails)
        return MESH_PIPE_MS
    for name, fn in (("bench_trace", trace), ("bench_full_pipeline", full),
                     ("bench_upscaled", upscaled), ("bench_mesh", mesh),
                     ("bench_mesh_pipeline", mesh_pipeline)):
        monkeypatch.setattr(ref, name, stubbed(
            [] if calls is None else calls, getattr(ref, name), fn))


def stub_port(monkeypatch, fails=None, calls=None):
    info = {"frames": 5, "spill_waves": 0}
    out = types.SimpleNamespace(radiance=torch.zeros(2, 2, 3))

    def trace(**kw):
        failing("trace", fails)
        return dict(info, mray_s=TRACE[0], frame_ms=TRACE[1],
                    rays_per_frame=TRACE[2]), out

    def full(**kw):
        failing("full_pipeline", fails)
        return FULL_MS, dict(PASSES), json.loads(json.dumps(REPORT)), info

    def upscaled(**kw):
        failing("upscaled", fails)
        return UP_MS, info

    def mesh(bounces=8, **kw):
        failing("mesh" if bounces == 2 else "mesh8", fails)
        mray_s, ms = MESH[bounces]
        return dict(info, mray_s=mray_s, frame_ms=ms), out

    def mesh_pipeline(**kw):
        failing("mesh_pipeline", fails)
        return MESH_PIPE_MS, info
    for name, fn in (("bench_trace", trace), ("bench_full_pipeline", full),
                     ("bench_upscaled", upscaled), ("bench_mesh", mesh),
                     ("bench_mesh_pipeline", mesh_pipeline)):
        monkeypatch.setattr(bench, name, stubbed(
            [] if calls is None else calls, getattr(bench, name), fn))


def reference_record(ref, capsys):
    capsys.readouterr()
    ref.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def key_tree(value):
    """The keys of a record, nested dicts' keys included."""
    if isinstance(value, dict):
        return {k: key_tree(v) for k, v in value.items()}
    return None


SAME_VALUES = ("value", "vs_baseline", "frame_ms", "rays_per_frame",
               "full_pipeline_ms", "passes_ms", "counters", "passes_sum_ms",
               "full_pipeline_upscaled_ms", "mesh_trace_mray_s",
               "mesh_trace_ms", "mesh_trace_8b_mray_s", "mesh_trace_8b_ms",
               "mesh_pipeline_upscaled_ms", "metric", "unit",
               "fidelity_recorded")


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_record_matches_reference(ref, monkeypatch, capsys, fidelity_copy,
                                  fast):
    if fast:
        monkeypatch.setenv("DRTS_BENCH_FAST", "1")
    jcalls, tcalls = [], []
    stub_reference(monkeypatch, ref, calls=jcalls)
    want = reference_record(ref, capsys)
    stub_port(monkeypatch, calls=tcalls)
    notes = []
    got, errors = bench.record(CPU, fast=fast, fidelity_path=fidelity_copy,
                               note=notes.append)
    assert errors == [] and "errors" not in want
    assert key_tree(got) == key_tree(want)
    assert set(got) == (bench.FAST_RECORD_KEYS if fast
                        else bench.RECORD_KEYS)
    for key in SAME_VALUES:
        assert got.get(key) == want.get(key), key
    assert got["device"] == "cpu"
    # The same benches at the same sizes, bounces and iteration counts.
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for (name, targs), (_, jargs) in zip(tcalls, jcalls):
        common = set(targs) & set(jargs)
        assert "iters" in common, name
        assert {k: targs[k] for k in common} == \
            {k: jargs[k] for k in common}, name
    launches = [n for n in notes if n.startswith("bench: launches ")]
    assert [json.loads(n[len("bench: launches "):])["bench"]
            for n in launches] == (["trace"] if fast else list(BENCHES))


@pytest.mark.parametrize("fails", BENCHES)
def test_failed_bench_lands_in_errors(ref, monkeypatch, capsys,
                                      fidelity_copy, fails):
    stub_reference(monkeypatch, ref, fails)
    want = reference_record(ref, capsys)
    stub_port(monkeypatch, fails)
    got, errors = bench.record(CPU, fidelity_path=fidelity_copy,
                               note=lambda msg: None)
    assert len(errors) == len(want["errors"]) == 1
    prefix = want["errors"][0].split(":")[0]
    assert prefix == fails and errors[0].startswith(prefix + ": ")
    assert f"RuntimeError: {fails} failed" in errors[0]
    assert got["errors"] == errors
    assert key_tree(got) == key_tree(want)
    if fails != "trace":
        assert got["value"] == want["value"] == round(TRACE[0], 2)
    on_cpu(monkeypatch, fidelity_copy)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        bench.main(["--record"])
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert key_tree(line) == key_tree(want)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def on_cpu(monkeypatch, fidelity_path=None):
    """The port's main on the CPU (its device is the card), reading the
    fidelity record from `fidelity_path`."""
    monkeypatch.setattr(bench.backend, "device", lambda name: CPU)
    if fidelity_path is not None:
        monkeypatch.setattr(bench, "FIDELITY_PATH", fidelity_path)


def test_main_record_exits_zero(monkeypatch, capsys, fidelity_copy):
    stub_port(monkeypatch)
    on_cpu(monkeypatch, fidelity_copy)
    capsys.readouterr()
    assert bench.main(["--record"]) is None
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert set(line) == bench.RECORD_KEYS
    assert captured.err.count("bench: launches ") == len(BENCHES)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    for bad in (["--record", "--frame"], ["--record", "--mesh-cand", "2"],
                ["--fast"]):
        with pytest.raises(SystemExit) as exc:
            bench.main(bad)
        assert exc.value.code == 2


def test_counter_report_follows_reference(ref, monkeypatch):
    """The reference's bench_full_pipeline run with its pipeline faked, so
    its lines 128-147 build the report from these counters."""
    counters = {"wavefront_overflow_paths": 3.0, "lights_dropped": 12.04,
                "lights_dropped_power_frac": 0.1234,
                "sharc_splat_dropped_rows": 1234.56, "spill_waves": 0.0,
                "sharc_hits_b2": 300.0, "sharc_queries_b2": 900.0,
                "sharc_gate_b2": 600.0, "sharc_entry_b2": 450.0,
                "sharc_hits_b3": 7.0, "sharc_queries_b3": 11.0,
                "sharc_gate_b3": 9.0, "sharc_entry_b3": 8.0,
                "sharc_hits_b4": 0.0, "sharc_queries_b4": 0.0,
                "sharc_gate_b4": 0.0, "sharc_entry_b4": 0.0}

    class Pipe:
        def __init__(self, cfg):
            pass

        def init_state(self, host):
            return None

        def default_camera_pose(self, host):
            return None

        def render_frame(self, state, pose, dt):
            return types.SimpleNamespace(counters=counters), np.zeros(1)

        def profile_passes(self, state, pose, iters):
            return {"trace": 1.0}
    monkeypatch.setattr(jpipeline, "RenderPipeline", Pipe)
    monkeypatch.setattr(jmyscene, "build", lambda **kw: None)
    monkeypatch.setattr(jax, "jit", lambda fn: fn)
    monkeypatch.setattr(jax, "block_until_ready", lambda x: x)
    _, _, want = ref.bench_full_pipeline()
    assert "sharc_hit_rate" in want and "b4" not in want["sharc_hit_rate"]
    assert bench.counter_report(counters) == want
    assert bench.counter_report({"x": 1.26}) == {"x": 1.3}


def plain(value):
    """A config as nested dicts (so the two packages' classes compare)."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    return value


def capture_reference(ref, monkeypatch, capsys, events):
    stub = types.SimpleNamespace(
        scene=types.SimpleNamespace(center=np.zeros((4, 3), np.float32),
                                    radius=np.ones(4, np.float32)),
        camera_position=np.zeros(3), camera_forward=np.float32([0, 0, 1]))
    real_cfg = jpathtrace.PathTraceConfig

    def build(**kw):
        events.append(("build", kw.get("load_textures", False),
                       kw.get("oscillator_grid")))
        return stub

    def as_mesh(host, tessellation):
        events.append(("as_mesh", tessellation))
        return host

    def trace_cfg(**kw):
        events.append(("trace_config", plain(real_cfg(**kw))))
        return real_cfg(**kw)

    class Pipe:
        def __init__(self, cfg):
            events.append(("pipeline_config", plain(cfg)))

        def init_state(self, host):
            return None

        def default_camera_pose(self, host):
            return None

    def jit(fn):
        raise Stop
    monkeypatch.setattr(ref, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jmyscene, "build", build)
    monkeypatch.setattr(jmyscene, "as_mesh_scene", as_mesh)
    monkeypatch.setattr(jclusters, "build_plan_morton", lambda *a, **k: None)
    monkeypatch.setattr(jcamera, "make_camera", lambda *a, **k: None)
    monkeypatch.setattr(jpathtrace, "PathTraceConfig", trace_cfg)
    monkeypatch.setattr(jpipeline, "RenderPipeline", Pipe)
    monkeypatch.setattr(jax, "jit", jit)
    return reference_record(ref, capsys)


def capture_port(monkeypatch, events, fidelity_path):
    stub = types.SimpleNamespace(
        scene=types.SimpleNamespace(center=torch.zeros(4, 3),
                                    radius=torch.ones(4)),
        camera_position=np.zeros(3), camera_forward=np.float32([0, 0, 1]))
    real_cfg = tpathtrace.PathTraceConfig

    def build(**kw):
        events.append(("build", kw.get("load_textures", False),
                       kw.get("oscillator_grid")))
        return stub

    def as_mesh(host, tessellation):
        events.append(("as_mesh", tessellation))
        return host

    def trace_cfg(**kw):
        events.append(("trace_config", plain(real_cfg(**kw))))
        return real_cfg(**kw)

    class Pipe:
        def __init__(self, cfg, device="cuda"):
            events.append(("pipeline_config", plain(cfg)))
            self.cfg, self.device = cfg, device

        def init_state(self, host):
            return None

        def default_camera_pose(self, host):
            return None

        def render_frame(self, *args, **kw):
            raise Stop

    def render(*args, **kw):
        raise Stop
    monkeypatch.setattr(tmyscene, "build", build)
    monkeypatch.setattr(tmyscene, "as_mesh_scene", as_mesh)
    monkeypatch.setattr(tclusters, "build_plan_morton", lambda *a, **k: None)
    monkeypatch.setattr(tcamera, "make_camera", lambda *a, **k: None)
    monkeypatch.setattr(tpathtrace, "PathTraceConfig", trace_cfg)
    monkeypatch.setattr(tpathtrace, "trace_image", render)
    monkeypatch.setattr(tpipeline, "RenderPipeline", Pipe)
    monkeypatch.setattr(bench, "trace_frame", render)
    return bench.record(CPU, fidelity_path=fidelity_path,
                        note=lambda msg: None)


def by_bench(events):
    """Split the captured events at each bench's first call."""
    groups, current = [], None
    for event in events:
        starts = (event[0] == "build" and not (
            current and current[-1][0] == "pipeline_config")) or \
            event[0] == "pipeline_config"
        if starts:
            current = []
            groups.append(current)
        current.append(event)
    return groups


@pytest.mark.parametrize("index", range(len(BENCHES)), ids=BENCHES)
def test_recipes_match_reference(ref, monkeypatch, capsys, fidelity_copy,
                                 index):
    """Each of the six benches builds the reference's config (every field
    the port's config has; the reference's own TPU fields left at their
    defaults), builds the scene with the same load_textures and oscillator
    grid and tessellates it alike, and both stop before the first
    render."""
    jevents, tevents = [], []
    want = capture_reference(ref, monkeypatch, capsys, jevents)
    got, errors = capture_port(monkeypatch, tevents, fidelity_copy)
    assert [e.split(":")[0] for e in want["errors"]] == list(BENCHES)
    assert [e.split(":")[0] for e in errors] == list(BENCHES)
    assert all("Stop" in e for e in want["errors"] + errors)
    jgroups, tgroups = by_bench(jevents), by_bench(tevents)
    assert len(jgroups) == len(tgroups) == len(BENCHES)
    jg, tg = jgroups[index], tgroups[index]
    assert [e[0] for e in jg] == [e[0] for e in tg]
    for je, te in zip(jg, tg):
        if je[0] == "trace_config":
            jcfg, tcfg = je[1], te[1]
            assert set(tcfg) <= set(jcfg)
            assert {k: jcfg[k] for k in tcfg} == tcfg
            defaults = plain(jpathtrace.PathTraceConfig(width=1, height=1))
            for k in set(jcfg) - set(tcfg):
                assert jcfg[k] == defaults[k], k
        else:
            assert je == te
    kinds = {e[0] for e in jg}
    assert ("trace_config" in kinds) != ("pipeline_config" in kinds)


def test_no_flag_line_keys(monkeypatch, capsys):
    """The line without a flag keeps its keys (slice 1's contract)."""
    monkeypatch.setattr(bench, "bench_trace", lambda iters, device, graph: (
        {"mray_s": 1.5, "frame_ms": 2.5, "rays_per_frame": 3.0},
        types.SimpleNamespace(radiance=torch.zeros(2, 2, 3))))
    on_cpu(monkeypatch)
    capsys.readouterr()
    bench.main([])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "frame_ms",
                         "rays_per_frame", "device"}
    assert line["metric"] == "path_trace_1080p_1spp_8bounce"
