"""The port's CLI (``python -m drts_tpu_torch.app``) on the CPU at 16x16
(``--device cpu``; every path under a temporary directory): ``render``
with ``--mutate``, ``--watch-settings``, ``--resume`` with
``--checkpoint-every`` and ``--metrics-out``; ``bench --passes``;
``interactive --keys`` and the scripted orbit; ``set``, whose JSON must
equal the reference's ``app.main(["set", ...])`` byte for byte. Also:
importing the shell leaves ``jax`` and ``drts_tpu`` out of
``sys.modules`` (a subprocess); the default device, ``cuda``, raises
where PyTorch sees no card; ``obs.device_trace`` writes a Chrome trace
holding a ``pass_scope`` label; ``image.tonemap_preview`` equals the
reference's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from drts_tpu import app as japp
from drts_tpu.utils import image as jimage
from drts_tpu_torch import app, session
from drts_tpu_torch.utils import image, obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["raytracing.bounces=2", "sharc.capacity_log2=16"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the same cores, and this module's small frames lose most of their
    time to the workers' OpenMP threads contending (~10x in a six-worker
    run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def settings(tmp_path, monkeypatch, capsys):
    """A settings file made by `set`: the reference's defaults with 2
    bounces and a 2^16-slot SHARC cache."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "Settings" / "graphics.json")
    app.main(["--settings", path, "set", *SMALL])
    capsys.readouterr()
    return path


def _run(capsys, settings, *argv, size=16):
    app.main(["--device", "cpu", "--width", str(size), "--height",
              str(size), "--settings", settings, *argv])
    return capsys.readouterr().out


@pytest.mark.parametrize("assignments", [
    SMALL, ["post.denoiser=NRDReLAX", "post.exposure=1e9",
            "restir_di.local_light_mode=Uniform", "render_width=8"]])
def test_set_writes_the_references_json(tmp_path, capsys, assignments):
    ours, ref = str(tmp_path / "a" / "g.json"), str(tmp_path / "b" / "g.json")
    app.main(["--settings", ours, "set", *assignments])
    japp.main(["--settings", ref, "set", *assignments])
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    # A second `set` starts from the file it wrote.
    app.main(["--settings", ours, "set", "post.sharpness=0.25"])
    japp.main(["--settings", ref, "set", "post.sharpness=0.25"])
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    assert "saved" in capsys.readouterr().out
    with pytest.raises(KeyError):
        app.main(["--settings", ours, "set", "post.nonsense=1"])


def test_render_mutate_resume_metrics(tmp_path, capsys, settings):
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    metrics = str(tmp_path / "metrics.jsonl")
    text = _run(capsys, settings, "render", "--frames", "4", "--out-dir",
                out, "--mutate", "1:post.exposure=2.0", "--mutate",
                "2:post.denoiser=NRDReLAX", "--mutate",
                "2:post.upscaler=None", "--resume", ckpt,
                "--checkpoint-every", "2", "--metrics-out", metrics)
    assert "frame 1: set post.exposure=2.0 (dynamic)" in text
    assert "frame 2: set post.denoiser=NRDReLAX (static)" in text
    assert "frame 2: set post.upscaler=None (realloc)" in text
    assert "checkpointed frame 2" in text and "checkpointed frame 4" in text
    assert "resumed" not in text
    png = image.read_png(os.path.join(out, "frame_0003.png"))
    assert png.shape == (16, 16, 3) and np.isfinite(png).all()
    summary = json.loads(text.split("metrics: ")[1].splitlines()[0])
    assert summary["frame_ms"] > 0 and "sharc_splat_dropped_rows" in summary
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    assert [r["frame_index"] for r in records] == [0, 1, 2, 3]
    assert all(r["frame_ms"] > 0 for r in records)
    with open(os.path.join(ckpt, "LATEST")) as f:
        assert f.read() == "s1"

    # The run resumes under the file's settings (ReBLUR, SR Auto), whose
    # state has the checkpoint's shapes at 16x16.
    text = _run(capsys, settings, "render", "--frames", "2", "--out-dir",
                out, "--resume", ckpt)
    assert "resumed at frame 4" in text
    assert "checkpointed frame 6" in text


def test_render_watch_settings(tmp_path, capsys, settings, monkeypatch):
    """--watch-settings: the file changes after frame 0, and frame 1
    applies it."""
    step = session.Session.step
    calls = []

    def stepped(self, *a, **k):
        img = step(self, *a, **k)
        calls.append(1)
        if len(calls) == 1:
            app.main(["--settings", settings, "set", "post.exposure=3.0",
                      "raytracing.bounces=1"])
            mtime = os.path.getmtime(settings) + 10.0
            os.utime(settings, (mtime, mtime))
        return img
    monkeypatch.setattr(session.Session, "step", stepped)
    text = _run(capsys, settings, "render", "--frames", "3", "--out-dir",
                str(tmp_path / "out"), "--watch-settings")
    assert text.count("settings reloaded: ") == 1
    assert ("settings reloaded: raytracing.bounces, post.exposure" in text)
    assert len(calls) == 3


def test_bench_passes(capsys, settings):
    text = _run(capsys, settings, "bench", "--frames", "2", "--passes",
                size=32)
    record = json.loads(text.strip().splitlines()[-1])
    assert record["frames"] == 2 and record["frame_ms"] > 0
    assert record["resolution"] == "16x16->32x32"
    assert {"update", "gbuffer", "restir_initial", "sharc_update", "trace",
            "denoise", "taa", "post"} <= set(record["passes_ms"])
    assert "lights_dropped" in record["counters"]


def test_interactive_keys_and_orbit(tmp_path, capsys, settings):
    out = str(tmp_path / "out")
    controls = str(tmp_path / "controls.json")
    with open(controls, "w") as f:
        json.dump({"camera_movement_speed": 60.0}, f)
    text = _run(capsys, settings, "interactive", "--keys", "wjp r x",
                "--out-dir", out, "--controls", controls, "--mutate",
                "2:post.exposure=2")
    lines = text.splitlines()
    assert lines[0].startswith("w/s fwd/back")
    # 60 units/s x a scripted tick's 1/60 s: 1 unit forward from the
    # demo camera at (0, 0, -15).
    assert "tick 0: move pos=[0.0, 0.0, -14.0]" in lines
    assert "tick 1: turn" in text and "tick 4: reset" in text
    assert "tick 2: set post.exposure=2 (dynamic)" in text
    assert os.path.exists(os.path.join(out, "shot_0000.png"))
    assert os.path.exists(os.path.join(out, "final.png"))
    assert "tick 5" not in text   # x quits before its frame

    text = _run(capsys, settings, "interactive", "--frames", "2",
                "--save-last", "1", "--out-dir", out, "--controls", controls)
    assert os.path.join(out, "orbit_0001.png") in text
    assert image.read_png(os.path.join(out, "orbit_0001.png")).shape == (
        16, 16, 3)


def test_default_device_raises_without_a_card(settings, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        app.main(["--width", "16", "--height", "16", "--settings", settings,
                  "render", "--frames", "1"])


def test_shell_imports_no_jax():
    code = (
        "import sys\n"
        "import drts_tpu_torch.app, drts_tpu_torch.session, "
        "drts_tpu_torch.config, drts_tpu_torch.bench\n"
        "import drts_tpu_torch.utils.checkpoint, drts_tpu_torch.utils.obs, "
        "drts_tpu_torch.utils.timer, drts_tpu_torch.utils.image, "
        "drts_tpu_torch.ops.camera\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'drts_tpu', 'flax'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_device_trace_and_tonemap_preview(tmp_path):
    with obs.device_trace(str(tmp_path / "trace")):
        with obs.pass_scope("shell_scope"):
            torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "shell_scope" in f.read()
    m = obs.FrameMetrics("cpu")
    with m.frame() as rec:
        rec["frame_index"] = 0
    assert m.summary()["frame_ms"] >= 0.0

    rng = np.random.RandomState(0)
    radiance = rng.standard_normal((8, 8, 3)).astype(np.float32) * 4.0
    for exposure in (1.0, 0.3):
        np.testing.assert_array_equal(
            image.tonemap_preview(radiance, exposure),
            jimage.tonemap_preview(radiance, exposure))
