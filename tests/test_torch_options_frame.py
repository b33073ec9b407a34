"""Every option of this slice at once in the port's ReSTIR frame
(``RenderPipeline.render_frame``: physics, ReSTIR DI, path trace with the
DI handoff, sharpen, bloom, tone map; denoiser "None", SHARC off) against
the reference's, two consecutive frames at 32x32, 2 bounces, on the demo
scene with oscillator grid 3, both started from the same converted
``FrameState``: the thin lens (aperture 0.05) focused at 4, no sphere
accel (``accel_mode="none"``: the brute-force sweep), Power_RIS
candidates evaluated as one batch, raytraced temporal and spatial bias
correction with the real previous surface and shared spatial offsets (2
neighbours).

The reference runs on its XLA path under one jit (no Pallas kernel, as
on the CPU its pipeline builds no accel either). Tolerances, as
tests/test_torch_pipeline.py's for the same reasons (the border pixels'
in-frame test flips on motion noise of ~1e-5 px; XLA:CPU contracts
multiply-adds), with the measured values in brackets:

- reservoir picks differ on <= 1% of pixels (0 and 0.68%);
- sample counts M differ on <= 5% of pixels (0 and 1.6%);
- where pick and M agree, w_out within 5e-3 relative (1.9e-4 and
  8.6e-5);
- the previous-surface rows kept for the next frame: position within
  5e-4 absolute (positions of ~10 units) on >= 99% of the pixels the
  reference hit (all; largest 9.0e-5);
- the tone-mapped images differ by <= 1e-6 on average (9.7e-8 both) and
  by <= 1e-4 anywhere (2.3e-5 and 2.7e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import restir as jrestir
from drts_tpu_torch import convert
from drts_tpu_torch.models import pipeline as tpipeline
from drts_tpu_torch.ops import restir as trestir

W = H = 32
FRAMES = 2
EYE = (0.0, 2.5, -4.0)
TARGET = (0.0, 0.5, 0.0)
RESTIR = dict(local_light_mode="Power_RIS", candidate_batch=True,
              spatial_bias_correction="raytraced",
              temporal_bias_correction="raytraced",
              temporal_prev_surface="real", spatial_offset_mode="shared",
              spatial_samples=2)
OPTIONS = dict(aperture_radius=0.05, focus_distance=4.0, accel_mode="none")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def frames():
    jcfg = jpipeline.PipelineConfig(
        output_width=W, output_height=H, render_width=W, render_height=H,
        upscaling=False, bounces=2, denoiser="None", sharc_enabled=False,
        block_size=4096, compact_from=2,
        restir=jrestir.ReSTIRConfig(**RESTIR), **OPTIONS)
    jp = jpipeline.RenderPipeline(jcfg)
    jstate = jp.init_state(jmyscene.build(oscillator_grid=3))
    fwd = np.array(TARGET, np.float32) - np.array(EYE, np.float32)
    pose = jpipeline.CameraPose(
        position=jnp.asarray(EYE, jnp.float32),
        forward=jnp.asarray(fwd / np.linalg.norm(fwd)),
        up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))
    step = jax.jit(lambda s, p: jp.render_frame(s, p))
    ref = []
    tstate = convert.frame_state(np_tree(jstate), "cpu")
    for _ in range(FRAMES):
        jstate, img = step(jstate, pose)
        ref.append((np_tree(jstate), np.asarray(img)))

    tcfg = dataclasses.replace(
        tpipeline.restir_frame_config(W, H, 2), block_size=4096,
        restir=trestir.ReSTIRConfig(**RESTIR), **OPTIONS)
    tp = tpipeline.RenderPipeline(tcfg, device="cpu")
    tp.build_plan(tstate)
    tpose = tpipeline.CameraPose(*(torch.from_numpy(np.array(x)) for x in
                                   (pose.position, pose.forward, pose.up)))
    port = []
    for _ in range(FRAMES):
        tstate, img = tp.render_frame(tstate, tpose)
        port.append((tstate, img.numpy()))
    return ref, port, tp


def test_config_and_state(frames):
    """The port builds no accel, keeps (H, W, 7) previous-surface rows and
    counts no ReGIR occupancy (Power_RIS builds no grid)."""
    ref, port, tp = frames
    assert tp.cluster_plan is None
    for (js, _), (ts, _) in zip(ref, port):
        assert tuple(ts.prev_surface_rows.shape) == (H, W, 7)
        assert set(ts.counters) == set(js.counters)
        assert "regir_occupancy" not in ts.counters
        hit = np.asarray(js.prev_surface_rows[..., 6] != 0)
        same = np.abs(ts.prev_surface_rows.numpy()[..., :3]
                      - js.prev_surface_rows[..., :3]).max(-1) <= 5e-4
        assert same[hit].mean() >= 0.99


@pytest.mark.parametrize("i", range(FRAMES))
def test_reservoirs_match(frames, i):
    ref, port, _ = frames
    jr, tr = ref[i][0].reservoirs, port[i][0].reservoirs
    same = tr.light_index.numpy() == np.asarray(jr.light_index)
    assert 1.0 - same.mean() <= 0.01
    same_m = tr.m_count.numpy() == np.asarray(jr.m_count)
    assert 1.0 - same_m.mean() <= 0.05
    both = same & same_m
    np.testing.assert_allclose(tr.w_out.numpy()[both],
                               np.asarray(jr.w_out)[both], rtol=5e-3,
                               atol=1e-6)
    assert len(np.unique(np.asarray(jr.light_index))) > 1
    assert (np.asarray(jr.w_out) > 0).mean() > 0.2


@pytest.mark.parametrize("i", range(FRAMES))
def test_images_match(frames, i):
    ref, port, _ = frames
    jimg, timg = ref[i][1], port[i][1]
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert timg.min() >= 0.0 and timg.max() <= 1.0
    d = np.abs(timg - jimg)
    assert d.mean() <= 1e-6, d.mean()
    assert d.max() <= 1e-4, d.max()
