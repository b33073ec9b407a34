"""The port's fidelity harness (``drts_tpu_torch/fidelity.py``) and PNG
writer against the reference's, on the CPU at tiny sizes.

- ``_orbit_poses`` equal to the reference's;
- ``reference_render`` at 24x16, ``spp_total=20`` (both round up to one
  chunk of 32 jittered frames), 3 bounces, no accel on either side:
  within 1e-3 on >= 99% of pixels (99.5%; a path that leaves on another
  branch where XLA:CPU's fused multiply-adds move a hit point stays in
  the 32-frame average, up to 0.11), and the means within 1e-3 relative
  (3.8e-4);
- ``realtime_render`` at 32x32, 3 frames, with a 4,096-slot SHARC cache
  and a small ReGIR grid: the tone-mapped frames differ by <= 4e-3 on
  average (4.6e-5) and by more than 0.02 on <= 5% of pixels (none), the
  bounds of tests/test_torch_default_frame.py's later frames (border
  pixels may flip their in-frame test between the packages);
- ``run``, ``run_mesh`` and ``run_motion`` (renders stubbed) return the
  reference's keys plus ``"textures"``; a second call reads the cached
  ``.npz`` and does not render; with ``load_textures=True`` and the
  texture directory absent, ``run`` scores the reference's untextured
  scene under the reference's cache key;
- ``write_png`` -> ``read_png`` gives the pixels the reference's numpy
  encoder writes;
- ``main --record`` merges its result into a JSON file;
- ``run``, ``run_mesh`` and ``run_motion`` default every parameter as the
  reference's do (``load_textures=True`` among them), but the reference
  cache directory, which is each package's own.
"""

import dataclasses
import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch

from drts_tpu import fidelity as jfidelity
from drts_tpu.models import assets as jassets, myscene as jmyscene
from drts_tpu.ops import sharc as jsharc, restir as jrestir
from drts_tpu.utils import image as jimage
from drts_tpu_torch import convert, fidelity as tfidelity
from drts_tpu_torch.models import assets as tassets, myscene as tmyscene
from drts_tpu_torch.ops import sharc as tsharc, restir as trestir
from drts_tpu_torch.utils import image as timage


@pytest.fixture(scope="module")
def hosts():
    jhost = jmyscene.build(seed=0, load_textures=False)
    thost = tmyscene.build(seed=0, device="cpu")
    tscene = convert.scene(jax.tree.map(np.asarray, jhost.scene), "cpu")
    for name in ("center", "radius"):
        assert torch.equal(getattr(thost.scene, name),
                           getattr(tscene, name))
    return jhost, thost


def test_orbit_poses_match(hosts):
    jhost, thost = hosts
    for (jp, jf), (tp, tf) in zip(jfidelity._orbit_poses(jhost, 16),
                                  tfidelity._orbit_poses(thost, 16)):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tf, jf)


def test_reference_render_matches(hosts):
    jhost, thost = hosts
    jref = jfidelity.reference_render(jhost, 24, 16, spp_total=20,
                                      bounces=3)
    tref = tfidelity.reference_render(thost, 24, 16, spp_total=20,
                                      bounces=3, device="cpu")
    assert tref.shape == (16, 24, 3) and tref.dtype == np.float32
    assert np.isfinite(tref).all()
    off = np.abs(tref - jref).max(-1)
    assert (off <= 1e-3).mean() >= 0.99, (off <= 1e-3).mean()
    assert abs(tref.mean() - jref.mean()) <= 1e-3 * jref.mean()


def test_realtime_render_matches(hosts):
    jhost, thost = hosts
    jimg, _ = jfidelity.realtime_render(
        jhost, 32, 32, frames=3, pipeline_overrides=dict(
            sharc=jsharc.SHARCConfig(capacity_log2=12),
            restir=jrestir.ReSTIRConfig(regir_cells_per_axis=8)))
    timg, pipe = tfidelity.realtime_render(
        thost, 32, 32, frames=3, pipeline_overrides=dict(
            sharc=tsharc.SHARCConfig(capacity_log2=12),
            restir=trestir.ReSTIRConfig(regir_cells_per_axis=8)),
        device="cpu")
    assert not pipe.cfg.bloom_enabled and not pipe.cfg.physics_enabled
    assert timg.shape == (32, 32, 3) and np.isfinite(timg).all()
    d = np.abs(timg - jimg)
    assert d.mean() <= 4e-3, d.mean()
    assert (d.max(-1) > 0.02).mean() <= 0.05


def stub_renders(monkeypatch, module, calls):
    """Replace `module`'s reference and real-time renders by constant
    images, counting calls."""
    def ref_render(host, width, height, *args, **kw):
        calls.append("reference")
        return np.full((height, width, 3), 0.5, np.float32)

    def realtime(host, width, height, *args, **kw):
        calls.append("realtime")
        return np.full((height, width, 3), 0.6, np.float32), None
    monkeypatch.setattr(module, "reference_render", ref_render)
    monkeypatch.setattr(module, "realtime_render", realtime)


def test_run_results_and_cache(tmp_path, monkeypatch):
    """run, run_mesh and run_motion at 16x8 with both renders stubbed
    (test_reference_render_matches and test_realtime_render_matches hold
    them; chip_smoke.py phase 18 runs run and run_mesh whole): the
    reference's keys plus "textures", each reference cached under the
    reference's key; a second call reads the cache and renders no
    reference."""
    jcalls, tcalls = [], []
    stub_renders(monkeypatch, jfidelity, jcalls)
    stub_renders(monkeypatch, tfidelity, tcalls)
    jkeys = {
        "run": set(jfidelity.run(16, 8, 32, 1, load_textures=False,
                                 ref_cache=None)),
        "run_mesh": set(jfidelity.run_mesh(16, 8, 32, 1,
                                           load_textures=False,
                                           ref_cache=None)),
        # drts_tpu/fidelity.py run_motion's dict (running it would
        # compile the reference's whole pipeline).
        "run_motion": {"metric", "value", "min", "per_frame", "unit",
                       "frames", "evaluated", "reference_spp",
                       "resolution"},
    }
    for name, kw in (("run", {}), ("run_mesh", {"tessellation": 1})):
        fn = getattr(tfidelity, name)
        res = fn(16, 8, 32, 1, load_textures=False, ref_cache=str(tmp_path),
                 device="cpu", **kw)
        assert set(res) == jkeys[name] | {"textures"}
        assert res["textures"] is False and np.isfinite(res["value"])
    assert sorted(os.listdir(tmp_path)) == ["mesh1_s0_t0_16x8_spp32.npz",
                                            "static_s0_t0_16x8_spp32.npz"]
    assert tcalls == ["reference", "realtime"] * 2
    tcalls.clear()
    again = tfidelity.run(16, 8, 32, 1, load_textures=False,
                          ref_cache=str(tmp_path), device="cpu")
    assert tcalls == ["realtime"]
    assert set(again) == jkeys["run"] | {"textures"}
    motion = tfidelity.run_motion(16, 8, 32, 2, warmup=0,
                                  load_textures=False,
                                  ref_cache=str(tmp_path), device="cpu")
    assert set(motion) == jkeys["run_motion"] | {"textures"}
    assert "orbit_s0_t0_16x8_spp32_f0.npz" in os.listdir(tmp_path)
    # load_textures=True with no texture directory (each package's loader
    # pointed at one that does not exist): the reference's untextured
    # scene under the reference's key.
    absent = str(tmp_path / "no_textures_here")
    monkeypatch.setattr(jassets.load_texture_atlas, "__defaults__",
                        (absent, 512))
    monkeypatch.setattr(tassets, "DEFAULT_ASSET_DIR", absent)
    scenes = {}
    for name, module, kw in (("jax", jfidelity, {}),
                             ("torch", tfidelity, {"device": "cpu"})):
        def grab(host, width, height, *args, _name=name, **kwargs):
            scenes[_name] = host.scene
            return np.full((height, width, 3), 0.5, np.float32)
        monkeypatch.setattr(module, "reference_render", grab)
        res = module.run(16, 8, 32, 1, load_textures=True,
                         ref_cache=str(tmp_path / name), **kw)
        assert os.listdir(tmp_path / name) == ["static_s0_t1_16x8_spp32.npz"]
    assert res["textures"] is False
    assert scenes["jax"].textures is None and scenes["torch"].textures is None
    want = convert.scene(jax.tree.map(np.asarray, scenes["jax"]), "cpu")
    for f in ("center", "radius", "rotation"):
        assert torch.equal(getattr(scenes["torch"], f), getattr(want, f))
    for f in dataclasses.fields(want.materials):
        assert torch.equal(getattr(scenes["torch"].materials, f.name),
                           getattr(want.materials, f.name)), f.name


def test_write_png_round_trip(tmp_path, monkeypatch):
    from drts_tpu import native
    monkeypatch.setattr(native, "write_png", lambda *a: False)
    img = np.random.default_rng(0).random((9, 13, 3)).astype(np.float32)
    img[0, 0] = (-0.5, 1.5, 0.5)
    tpath, jpath = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    timage.write_png(tpath, img)
    jimage.write_png(jpath, img)
    got = timage.read_png(tpath)
    np.testing.assert_array_equal(got, timage.read_png(jpath))
    np.testing.assert_array_equal(
        got, np.round(np.clip(img, 0, 1) * 255) / np.float32(255))
    timage.write_png(tpath, (img[..., 0] * 255).astype(np.uint8))
    assert timage.read_png(tpath).shape == (9, 13, 3)


def test_main_records(tmp_path, monkeypatch):
    record = tmp_path / "fid.json"
    record.write_text(json.dumps({"other": {"value": 1}}))
    seen = {}

    def run(width, height, spp, frames, **kw):
        seen.update(width=width, height=height, spp=spp, frames=frames,
                    **kw)
        return {"metric": "ssim_vs_reference", "value": 0.5}
    monkeypatch.setattr(tfidelity, "run", run)
    tfidelity.main(["--width", "16", "--height", "8", "--spp", "32",
                    "--frames", "2", "--record", str(record)])
    assert seen == {"width": 16, "height": 8, "spp": 32, "frames": 2,
                    "save_dir": None, "crosscheck_spp": 0}
    rec = json.loads(record.read_text())
    assert rec == {"other": {"value": 1},
                   "ssim_vs_reference": {"metric": "ssim_vs_reference",
                                         "value": 0.5}}


@pytest.mark.parametrize("name", ["run", "run_motion", "run_mesh"])
def test_defaults_match_the_reference(name):
    """The same parameters with the same defaults as the reference's
    function (so `python -m drts_tpu_torch.fidelity` builds the scene with
    load_textures=True, as the reference's does), but ``device`` (the
    port's alone) and ``ref_cache`` (each package's own directory)."""
    ref = inspect.signature(getattr(jfidelity, name)).parameters
    port = inspect.signature(getattr(tfidelity, name)).parameters
    assert set(port) == set(ref) | {"device"}
    assert port["load_textures"].default is True
    for pname, param in ref.items():
        if pname != "ref_cache":
            assert port[pname].default == param.default, pname
    assert port["ref_cache"].default == tfidelity.DEFAULT_REF_CACHE
