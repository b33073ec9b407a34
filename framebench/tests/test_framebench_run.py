"""Whole runs at a CPU test's size: the contract's last line, a sound run
correct, and ``correct`` false with the timed path broken underneath
(the state left unchanged, half the pixels left out and the mean of the
rest put in, an answer altered where it is produced, and on bands the
exchange between ranks left out) and with the bfloat16 control in the
program's place; no result line where JAX is loaded by the check; the
program's scene start against the reference's. The harness's look for a chip is skipped: run_one and
rank_main are driven directly on the CPU."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from framebench import faults
from framebench.harness import bands, main, spec, system
from framebench.reference import compare, scene
from tiny import tiny_cell

SEED = 2147483913          # more than 31 bits, as the driver's seeds


def _run(cell, **kw):
    return main.run_one(cell, SEED, 1.0, False, time.perf_counter(),
                        device="cpu", **kw)


def test_last_line_and_checks(capsys):
    result = _run(tiny_cell())
    main.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for text, (name, c) in zip(tail, line["checks"].items()):
        assert text.startswith(f"check {name} ") and " limit " in text
    assert line["correct"] is True and line["failed"] == 0
    assert main.banned_modules() == []


@pytest.mark.parametrize("tess", [None, 4])
def test_sound_run_is_correct(tess):
    result = _run(tiny_cell(tess=tess))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    faults.plant(fault, monkeypatch.setattr)
    result = _run(tiny_cell())
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_jax_loaded_during_the_check_prints_no_result(monkeypatch, capsys):
    """A module of JAX loaded as late as the check (say, by the reference)
    ends the run without a result line."""
    inner = compare.numbers

    def numbers(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return inner(*a, **kw)
    monkeypatch.setattr(compare, "numbers", numbers)
    with pytest.raises(SystemExit) as ended:
        main.emit(_run(tiny_cell()))
    assert "jax" in str(ended.value)
    out, _ = capsys.readouterr()
    assert not out.strip()


def test_program_start_is_the_demos():
    """The program's scene start equals the one the reference builds from
    the demo's layout, to float32 rounding; the start in bfloat16, or with
    one material changed, does not."""
    from drts_tpu_torch.models import myscene
    host = myscene.build(seed=0, oscillator_grid=10, device="cpu")
    got = system.program_start(host)
    want = scene.demo_start(0, 10)
    limit = spec.load_cell("demo_spheres.sweep").check["limits"]["start_gap"]
    assert scene.start_gap(got, want) <= 1e-7 < limit
    assert scene.start_gap(compare._bf16(want), want) > 100 * limit
    got["roughness"] = got["roughness"].copy()
    got["roughness"][7] += 0.01
    assert scene.start_gap(got, want) > limit
    got = system.program_start(myscene.build(seed=1, oscillator_grid=10,
                                             device="cpu"))
    assert scene.start_gap(got, want) > limit


def test_control_is_not_correct():
    result = _run(tiny_cell(), control=True)
    assert not result["correct"], result["checks"]


def _exchange_left_out():
    from drts_tpu_torch.parallel import mesh
    mesh._all_gather = lambda t, n, group: torch.zeros((n,) + tuple(t.shape),
                                                       dtype=t.dtype)


def faulty_rank(group, cell, seed, fault):
    if fault:
        _exchange_left_out()
    bands.rank_main(group, cell, seed, 1.0, False, time.perf_counter(), "cpu")


@pytest.mark.parametrize("fault", [False, True])
def test_bands_on_gloo_ranks(capfd, fault):
    from drts_tpu_torch.parallel import multihost
    cell = tiny_cell(ranks=4, size=(64, 32))
    multihost.spawn(faulty_rank, 4, device="cpu", args=(cell, SEED, fault))
    out, _ = capfd.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["device"]["count"] == 4
    assert "replica_gap" in line["checks"]
    assert line["correct"] is (not fault), line["checks"]


def test_no_card_no_result(tmp_path):
    """Where PyTorch sees no card, or the program is missing (a folder of
    BENCHMARK.json and the benchmark's files alone), a run fails and
    prints no result line."""
    shutil.copy(os.path.join(spec.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "framebench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for cwd in (spec.REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "framebench/run.py", "--workload",
             "demo_spheres.sweep", "--seed", str(SEED), "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert not out.stdout.strip()


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """The control on the card at the cell's own size (run on the chip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.load_cell("demo_spheres.sweep")
    result = main.run_one(cell, SEED, 3.0, False, time.perf_counter(),
                          device="cuda", control=True)
    assert not result["correct"], result["checks"]
