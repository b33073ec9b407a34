"""The port's settings (``drts_tpu_torch/config.py``) and
``PipelineConfig.from_settings`` against the reference's.

- ``save_settings`` writes the same bytes as the reference's for the
  defaults and for every settings file the loader clamps or repairs:
  values out of range, unknown enum names, missing keys, a JSON list
  where an object belongs (at the top, the defaults; nested, the same
  exception in both), a file that is not JSON;
- ``load_controls`` returns the same speeds;
- ``from_settings`` sets every field as the reference's, ``restir`` and
  ``sharc`` included, over every Denoiser x Upscaler x
  SuperResolutionMode x RTXGITechnique choice (144 cases) and with the
  output size given. Nothing renders.
"""

import dataclasses
import itertools
import json

import pytest

from drts_tpu import config as jconfig
from drts_tpu.models import pipeline as jpipeline
from drts_tpu_torch import config as tconfig
from drts_tpu_torch.models import pipeline as tpipeline

SETTINGS_FILES = {
    "missing": None,
    "defaults": {},
    "out_of_range": {
        "render_width": 4, "render_height": 100000,
        "camera": {"horizontal_field_of_view": 500.0,
                   "aperture_radius": -2.0, "focus_distance": 0.0},
        "raytracing": {"bounces": 99, "samples_per_pixel": 0,
                       "throughput_threshold": 7.0},
        "restir_di": {"regir_cells_per_axis": 1, "spatial_radius": 1e9,
                      "local_light_samples": -3, "max_history_length": 1000,
                      "spatial_bias_correction": "nonsense"},
        "sharc": {"capacity_log2": 40, "downscale_factor": 0,
                  "accumulation_frames": 1000},
        "post": {"exposure": 0.0, "sharpness": 3.0, "bloom_strength": -1.0,
                 "paper_white_nits": 1e6, "denoiser_max_history": 0,
                 "chromatic_aberration_strength": 1.0}},
    "unknown_enums": {
        "rtxgi": "RTXGI2",
        "restir_di": {"local_light_mode": "Magic"},
        "post": {"denoiser": "OIDN", "upscaler": "FSR",
                 "super_resolution_mode": "Ultra",
                 "tone_map_operator": "Hable",
                 "hdr_color_rotation": "none"}},
    "missing_keys": {"render_width": 1280,
                     "post": {"upscaler": "None", "exposure": 2.0},
                     "restir_di": {"is_enabled": False}},
    "types": {"render_width": 800.7, "is_vsync_enabled": 1,
              "raytracing": {"bounces": "3", "is_russian_roulette_enabled":
                             0},
              "post": {"exposure": 2}},
    "unknown_fields": {"gpu": "H100", "post": {"lens_flare": True}},
    "top_level_list": [1, 2, 3],
    "nested_list": {"post": [1, 2]},
    "not_json": "{ this is not json",
}


def _write(tmp_path, name, payload):
    path = tmp_path / f"{name}.json"
    if payload is None:
        return str(path)
    text = payload if isinstance(payload, str) else json.dumps(payload)
    path.write_text(text)
    return str(path)


def _load_and_save(mod, src, dst):
    try:
        settings = mod.load_settings(src)
    except Exception as e:   # the reference's own failure, compared below
        return type(e).__name__
    mod.save_settings(settings, dst)
    with open(dst, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(SETTINGS_FILES))
def test_save_settings_byte_equal(tmp_path, name):
    src = _write(tmp_path, name, SETTINGS_FILES[name])
    ref = _load_and_save(jconfig, src, str(tmp_path / "ref.json"))
    port = _load_and_save(tconfig, src, str(tmp_path / "port.json"))
    assert port == ref
    if name == "nested_list":
        assert ref == "AttributeError"
    else:
        assert isinstance(ref, bytes) and ref.startswith(b"{")


@pytest.mark.parametrize("payload", [
    None, {}, {"camera_movement_speed": 5000, "camera_rotation_speed": -1},
    {"camera_movement_speed": 3.5}, [1.0, 2.0], "not json"],
    ids=["missing", "empty", "clamped", "partial", "list", "not_json"])
def test_load_controls_match(tmp_path, payload):
    path = _write(tmp_path, "controls", payload)
    assert (dataclasses.asdict(tconfig.load_controls(path))
            == dataclasses.asdict(jconfig.load_controls(path)))


def _settings(mod, denoiser, upscaler, sr, gi, **fields):
    s = mod.GraphicsSettings(**fields)
    return dataclasses.replace(
        s, rtxgi=mod.RTXGITechnique(gi),
        post=dataclasses.replace(
            s.post, denoiser=mod.Denoiser(denoiser),
            upscaler=mod.Upscaler(upscaler),
            super_resolution_mode=mod.SuperResolutionMode(sr))).check()


def _same_fields(port_cfg, ref_cfg):
    ref = dataclasses.asdict(ref_cfg)
    port = dataclasses.asdict(port_cfg)
    assert set(port) == set(ref)
    for key, value in ref.items():
        assert port[key] == value, key


CHOICES = list(itertools.product(
    [d.value for d in jconfig.Denoiser], [u.value for u in jconfig.Upscaler],
    [m.value for m in jconfig.SuperResolutionMode],
    [g.value for g in jconfig.RTXGITechnique]))


@pytest.mark.parametrize("denoiser,upscaler,sr,gi", CHOICES)
def test_from_settings_every_choice(denoiser, upscaler, sr, gi):
    kw = dict(render_width=1920, render_height=1080)
    ref = jpipeline.PipelineConfig.from_settings(
        _settings(jconfig, denoiser, upscaler, sr, gi, **kw))
    port = tpipeline.PipelineConfig.from_settings(
        _settings(tconfig, denoiser, upscaler, sr, gi, **kw))
    _same_fields(port, ref)


@pytest.mark.parametrize("sr,ow,oh", [("Auto", 640, 360),
                                      ("Quality", 1280, 720),
                                      ("UltraPerformance", 40, 30),
                                      ("Native", 100, None)])
def test_from_settings_output_size(sr, ow, oh):
    kw = dict(render_width=333, render_height=222)
    ref = jpipeline.PipelineConfig.from_settings(
        _settings(jconfig, "NRDReLAX", "XeSS", sr, "SHARC", **kw),
        output_width=ow, output_height=oh)
    port = tpipeline.PipelineConfig.from_settings(
        _settings(tconfig, "NRDReLAX", "XeSS", sr, "SHARC", **kw),
        output_width=ow, output_height=oh)
    _same_fields(port, ref)
    assert port.output_width == ow


def test_from_settings_of_a_perturbed_file(tmp_path):
    """Every clamped field of the out-of-range file reaches the config as
    the reference's does."""
    src = _write(tmp_path, "oor", SETTINGS_FILES["out_of_range"])
    _same_fields(
        tpipeline.PipelineConfig.from_settings(tconfig.load_settings(src)),
        jpipeline.PipelineConfig.from_settings(jconfig.load_settings(src)))
