"""The port's live session (``drts_tpu_torch/session.py``) against the
reference's.

- ``set_by_path`` and ``Session.set`` give the reference's answers
  ("dynamic", "static", "realloc", KeyError) and settings JSON over the
  settings window's kinds of change, a pinned CLI override included, and
  the same pipeline config after each; ``reload_settings`` reports the
  same changed keys.
- One render: a reference ``Session`` and a port ``Session`` at the
  reference's ``GraphicsSettings()`` cut to a 32x32 output (so SR Auto
  renders 16x16 and TAA upscales), 2 bounces and a 2^16-slot SHARC cache
  (ReBLUR, ReSTIR and SHARC on) start from one converted ``FrameState``
  on the demo scene with oscillator grid 3: two frames, a dynamic set
  (exposure), one frame, a static set (bounces), one frame. The
  reference runs on its XLA path. Its three frames before the static
  set hold the port's to tests/test_torch_default_frame.py's bounds (the
  same graph; measured in brackets): frame 0 by <= 2e-4 on average
  (3.0e-5) and by more than 1e-3 on <= 2% of pixels (1.3%); later frames
  by <= 4e-3 on average (4.8e-5, 6.0e-5), by more than 0.02 on <= 12%
  and by more than 0.05 on <= 3% of pixels (none). After the static set
  the reference would compile its frame a second time (~20 s of the
  suite's budget; its frame there agreed within 4.4e-8 on average when
  measured), so the port's frame is held instead, bit for bit, to the
  port's own ``render_frame(..., reset=True)`` under
  ``PipelineConfig.from_settings`` of the new settings, from the state
  before the set.
- Port only: the realloc branch carries the frame index, the host frame
  count, the bodies and the scene; a dynamic set brightens the next
  frame.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from drts_tpu import config as jconfig, session as jsession
from drts_tpu.models import myscene as jmyscene
from drts_tpu_torch import config as tconfig, convert, session as tsession
from drts_tpu_torch.models import myscene as tmyscene, pipeline as tpipeline

SET_CASES = {
    "dynamic": [("post.exposure", "2.5"), ("post.bloom_strength", "0.3"),
                ("post.sharpness", "7")],
    "static": [("raytracing.bounces", "1"), ("post.denoiser", "NRDReLAX"),
               ("restir_di.local_light_mode", "Power_RIS"),
               ("camera.horizontal_field_of_view", "200"),
               ("post.is_bloom_enabled", "off"), ("rtxgi", "None")],
    "realloc": [("post.upscaler", "None"),
                ("post.super_resolution_mode", "Native"),
                ("sharc.capacity_log2", "17"), ("render_width", "48")],
    "pinned": [("raytracing.bounces", "3"), ("post.denoiser", "None")],
    "unknown": [("post.nonsense", "1"), ("nonsense", "1"),
                ("sharc.capacity", "17")],
}


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


def _settings(mod, size=16):
    s = mod.GraphicsSettings(render_width=size, render_height=size)
    return dataclasses.replace(
        s, raytracing=dataclasses.replace(s.raytracing, bounces=2),
        sharc=dataclasses.replace(s.sharc, capacity_log2=16)).check()


def _json(mod, settings):
    return json.dumps(mod._to_jsonable(settings), indent=2)


@pytest.fixture(scope="module")
def hosts():
    return (jmyscene.build(oscillator_grid=2),
            tmyscene.build(oscillator_grid=2, device="cpu"))


def _sessions(hosts, overrides=None):
    jh, th = hosts
    js = jsession.Session(_settings(jconfig), host=jh,
                          config_overrides=overrides)
    ts = tsession.Session(_settings(tconfig), host=th,
                          config_overrides=overrides, device="cpu")
    return js, ts


def _same_config(ts, js):
    assert dataclasses.asdict(ts.pipe.cfg) == dataclasses.asdict(js.pipe.cfg)


@pytest.mark.parametrize("kind", sorted(SET_CASES))
def test_set_matches(hosts, kind):
    overrides = ({"bounces": 4, "denoiser": "NRDReLAX"}
                 if kind == "pinned" else None)
    js, ts = _sessions(hosts, overrides)
    _same_config(ts, js)
    for key, value in SET_CASES[kind]:
        if kind == "unknown":
            with pytest.raises(KeyError):
                jsession.set_by_path(js.settings, key, value)
            with pytest.raises(KeyError):
                tsession.set_by_path(ts.settings, key, value)
            with pytest.raises(KeyError):
                ts.set(key, value)
            continue
        assert (_json(tconfig, tsession.set_by_path(ts.settings, key, value))
                == _json(jconfig, jsession.set_by_path(js.settings, key,
                                                       value)))
        how = ts.set(key, value)
        assert how == js.set(key, value)
        assert _json(tconfig, ts.settings) == _json(jconfig, js.settings)
        assert ts.config_overrides == js.config_overrides
        assert ts._pending_reset == js._pending_reset
        _same_config(ts, js)
        if how == "dynamic":
            field = key.split(".")[-1]
            assert (float(getattr(ts.dyn, field))
                    == float(getattr(js.dyn, field)))
    if kind == "pinned":
        assert ts.pipe.cfg.bounces == 3 and ts.pipe.cfg.denoiser == "None"


def test_reload_settings_matches(hosts, tmp_path):
    js, ts = _sessions(hosts)
    new = tsession.set_by_path(ts.settings, "post.exposure", "2.5")
    new = tsession.set_by_path(new, "raytracing.bounces", "1")
    new = tsession.set_by_path(new, "post.upscaler", "None")
    path = str(tmp_path / "graphics.json")
    tconfig.save_settings(new, path)
    changed = ts.reload_settings(path)
    assert changed == js.reload_settings(path)
    assert set(changed) == {"post.exposure", "raytracing.bounces",
                            "post.upscaler"}
    assert ts.settings.post.exposure == 2.5 and ts.pipe.cfg.bounces == 1
    assert float(ts.dyn.exposure) == 2.5
    _same_config(ts, js)
    assert ts.reload_settings(path) == [] == js.reload_settings(path)


def test_realloc_carries_the_simulation(hosts):
    _, th = hosts
    ts = tsession.Session(_settings(tconfig, 32), host=th, device="cpu")
    assert (ts.pipe.cfg.render_width, ts.pipe.cfg.output_width) == (16, 32)
    for _ in range(3):
        img = ts.step()
    before = ts.state
    assert before.frame_count == 3
    assert ts.set("post.super_resolution_mode", "Native") == "realloc"
    st = ts.state
    assert (ts.pipe.cfg.render_width, ts.pipe.cfg.render_height) == (32, 32)
    assert st.frame_count == 3 and int(st.frame_index) == 3
    assert st.bodies is before.bodies and st.scene is before.scene
    assert tuple(st.prev_depth.shape) == (32, 32)
    assert float(st.taa.history.abs().sum()) == 0.0
    img2 = ts.step()
    assert ts.state.frame_count == 4 and ts.frame_count == 4
    assert img2.shape == img.shape == (32, 32, 3)
    assert torch.isfinite(img2).all()
    assert ts.set("post.exposure", "4.0") == "dynamic"
    img3 = ts.step()
    assert float(img3.mean()) > float(img2.mean()) + 1e-3


def test_static_set_into_the_real_previous_surface(hosts):
    """Pairwise temporal reuse on the real previous surface keeps a
    (H, W, 7) buffer: a static set into it resizes that buffer, and the
    next frame renders."""
    _, th = hosts
    ts = tsession.Session(_settings(tconfig), host=th, device="cpu")
    ts.step()
    assert ts.set("restir_di.temporal_bias_correction", "pairwise") == \
        "static"
    assert ts.set("restir_di.temporal_prev_surface", "real") == "static"
    rw, rh = ts.pipe.cfg.render_width, ts.pipe.cfg.render_height
    assert tuple(ts.state.prev_surface_rows.shape) == (rh, rw, 7)
    assert torch.isfinite(ts.step()).all()
    assert tuple(ts.state.prev_surface_rows.shape) == (rh, rw, 7)


@pytest.fixture(scope="module")
def frames():
    js = jsession.Session(_settings(jconfig, 32),
                          host=jmyscene.build(oscillator_grid=3))
    ts = tsession.Session(_settings(tconfig, 32),
                          host=tmyscene.build(oscillator_grid=3,
                                              device="cpu"),
                          device="cpu")
    ts.state = convert.frame_state(jax.tree.map(np.asarray, js.state), "cpu")
    out = []

    def step(label):
        out.append((label, np.asarray(js.step()), ts.step().numpy()))

    step("frame 0")
    step("frame 1")
    assert ts.set("post.exposure", "1.5") == js.set("post.exposure", "1.5")
    step("after dynamic")
    before = ts.state
    assert (ts.set("raytracing.bounces", "1")
            == js.set("raytracing.bounces", "1") == "static")
    assert ts._pending_reset and js._pending_reset
    after = ts.step().numpy()
    assert not ts._pending_reset
    # The frame after the static set, held to the port's own frame with
    # the history reset under the new settings' config (see the module
    # docstring: the reference would compile its frame a second time).
    pipe = tpipeline.RenderPipeline(
        tpipeline.PipelineConfig.from_settings(ts.settings), "cpu")
    assert pipe.cfg == ts.pipe.cfg and pipe.cfg.bounces == 1
    pipe.build_plan(ts.host)
    pose = ts.default_pose()
    state, own = pipe.render_frame(before, pose, prev_pose=pose, reset=True,
                                   dyn=ts.dyn)
    assert ts.state.frame_count == state.frame_count == 4
    return out, after, own.numpy()


@pytest.mark.parametrize("i", range(3))
def test_session_frames_match(frames, i):
    label, jimg, timg = frames[0][i]
    assert timg.shape == (32, 32, 3) and np.isfinite(timg).all(), label
    assert timg.min() >= 0.0 and timg.max() <= 1.0
    d = np.abs(timg - jimg)
    off = d.max(-1)
    if i == 0:
        assert d.mean() <= 2e-4, d.mean()
        assert (off > 1e-3).mean() <= 0.02
    else:
        assert d.mean() <= 4e-3, (label, d.mean())
        assert (off > 0.02).mean() <= 0.12
        assert (off > 0.05).mean() <= 0.03


def test_static_set_frame_is_a_reset_frame(frames):
    _, after, own = frames
    assert after.shape == (32, 32, 3) and np.isfinite(after).all()
    np.testing.assert_array_equal(after, own)
