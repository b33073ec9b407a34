"""The port's ReSTIR frame (``RenderPipeline.render_frame``: physics,
ReSTIR DI, path trace with the DI handoff, sharpen, bloom, tone map)
against the reference's, two consecutive frames at 32x32, 2 bounces, on
the demo scene with oscillator grid 3 (45 spheres, 9 of them lights),
both started from the same converted ``FrameState``.

The reference runs its Pallas kernels in interpret mode and the whole
frame under one jit. Its temporal pass reprojects through tile windows
(``reproject_pallas``) where the port gathers exactly; the test checks
that the windows' ``ok`` mask is the in-frame test on these frames, so
both take the same history.

Tolerances (measured on these frames in brackets):

- reservoir picks differ on <= 1% of pixels (0 and 0.29%);
- sample counts M differ on <= 5% of pixels (0 and 2.0%). The motion of
  a still pixel is rounding noise of about 1e-5 px in both packages, so
  the in-frame test of the border pixels flips between them (7 and 9 of
  1,024 pixels); the second frame then takes or drops that history, and
  spatial reuse over a 30 px radius carries the different M to the
  pixels that pick such a neighbour;
- where pick and M agree, w_out within 5e-3 relative (9.9e-4 and
  3.3e-4);
- the tone-mapped images differ by <= 1e-6 on average (6.3e-8 and
  6.7e-8) and by <= 1e-4 anywhere (largest 4.9e-6); counters within
  1e-6.

Both work in float32; the reference's XLA:CPU contracts multiply-adds
into FMAs, the port rounds each operation.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import intersect as jintersect
from drts_tpu.ops import reproject_pallas as jrp
from drts_tpu_torch import backend, convert
from drts_tpu_torch.models import pipeline as tpipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32
FRAMES = 2
POSE_EYE = (0.0, 2.5, -4.0)
POSE_TARGET = (0.0, 0.5, 0.0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames from one start state; the reference's window
    ok mask and the port's DI per frame."""
    jcfg = jpipeline.PipelineConfig(
        output_width=W, output_height=H, render_width=W, render_height=H,
        upscaling=False, bounces=2, denoiser="None", sharc_enabled=False,
        block_size=4096, compact_from=2)
    jp = jpipeline.RenderPipeline(jcfg)
    host = jmyscene.build(oscillator_grid=3)
    jstate = jp.init_state(host)
    # Close to the oscillator grid, so that most pixels see lit spheres
    # (from the default pose at 32x32 nearly all pixels see the sky).
    fwd = np.array(POSE_TARGET, np.float32) - np.array(POSE_EYE, np.float32)
    pose = jpipeline.CameraPose(
        position=jax.numpy.asarray(POSE_EYE, jax.numpy.float32),
        forward=jax.numpy.asarray(fwd / np.linalg.norm(fwd)),
        up=jax.numpy.asarray((0.0, 1.0, 0.0), jax.numpy.float32))

    def frame(state, pose):
        motion = {}

        def run(name, fn, *args):
            out = fn(*args)
            if name == "gbuffer":
                motion["m"] = out.motion
            return out
        new, img = jp.render_frame(state, pose, _run=run)
        _, ok = jrp.reproject_packed(jax.numpy.zeros((H, W, 4)),
                                     motion["m"], "nearest", interpret=True)
        return new, img, motion["m"], ok

    tcfg = dataclasses.replace(tpipeline.restir_frame_config(W, H, 2),
                               block_size=4096)
    tp = tpipeline.RenderPipeline(tcfg, device="cpu")
    tp.cluster_plan = convert.cluster_plan(jp.cluster_plan, "cpu")
    tstate = convert.frame_state(np_tree(jstate), "cpu")
    tpose = tpipeline.CameraPose(*(torch.from_numpy(np.array(x)) for x in
                                   (pose.position, pose.forward, pose.up)))

    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        step = jax.jit(frame)
        ref = []
        for _ in range(FRAMES):
            jstate, img, motion, ok = step(jstate, pose)
            ref.append((np_tree(jstate), np.asarray(img), np.asarray(motion),
                        np.asarray(ok)))
    finally:
        jintersect.BACKEND = old

    port = []
    for _ in range(FRAMES):
        di = {}

        def run(name, fn, *args):
            out = fn(*args)
            if name == "restir_final":
                di["total"] = out[0] + out[1]
            if name == "gbuffer":
                di["motion"] = out.motion
            return out
        tstate, img = tp.render_frame(tstate, tpose, _run=run)
        port.append((tstate, img.numpy(), di["total"].numpy(),
                     di["motion"].numpy()))
    return ref, port


@pytest.mark.parametrize("i", range(FRAMES))
def test_reservoirs_match(frames, i):
    ref, port = frames
    jr, tr = ref[i][0].reservoirs, port[i][0].reservoirs
    same = tr.light_index.numpy() == np.asarray(jr.light_index)
    assert 1.0 - same.mean() <= 0.01
    same_m = tr.m_count.numpy() == np.asarray(jr.m_count)
    assert 1.0 - same_m.mean() <= 0.05
    both = same & same_m
    np.testing.assert_allclose(tr.w_out.numpy()[both],
                               np.asarray(jr.w_out)[both], rtol=5e-3,
                               atol=1e-6)
    # Several lights are picked, and a good share of pixels is lit.
    assert len(np.unique(np.asarray(jr.light_index))) > 1
    assert (np.asarray(jr.w_out) > 0).mean() > 0.2


@pytest.mark.parametrize("i", range(FRAMES))
def test_images_match(frames, i):
    ref, port = frames
    jimg, timg = ref[i][1], port[i][1]
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert timg.min() >= 0.0 and timg.max() <= 1.0
    d = np.abs(timg - jimg)
    assert d.mean() <= 1e-6, d.mean()
    assert d.max() <= 1e-4, d.max()
    # Direct light from ReSTIR reaches a good share of the frame.
    assert (port[i][2].sum(-1) > 0).mean() > 0.2


def test_state_and_counters_match(frames):
    ref, port = frames
    for (js, *_), (ts, *_) in zip(ref, port):
        assert int(ts.frame_index) == int(js.frame_index)
        for k, v in js.counters.items():
            assert float(ts.counters[k]) == pytest.approx(float(v), abs=1e-6)
        np.testing.assert_allclose(ts.bodies.position.numpy(),
                                   np.asarray(js.bodies.position), atol=1e-5)
        np.testing.assert_allclose(ts.prev_depth.numpy(),
                                   np.asarray(js.prev_depth), rtol=1e-4)


def test_reference_windows_keep_every_in_frame_pixel(frames):
    """The reference's window reprojection rejected no in-frame pixel on
    these frames, so its history equals the exact gather's; and objects
    moved (the motion field is not all zero)."""
    ref, _ = frames
    moving = 0.0
    for _, _, motion, ok in ref:
        py = np.arange(H, dtype=np.float32)[:, None] + motion[..., 1]
        px = np.arange(W, dtype=np.float32)[None, :] + motion[..., 0]
        in_frame = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
        np.testing.assert_array_equal(ok, in_frame)
        moving = max(moving, float(np.abs(motion).max()))
    assert moving > 0.0


def test_options_that_wait_raise():
    """No option waits any more: the thin lens, a focus distance other
    than 1, accel_mode "none", the ReSTIR modes, SHARC, the denoisers,
    TAA, upscaling and the debug views construct, the reference's default
    config included; unknown names raise ValueError."""
    base = tpipeline.restir_frame_config(W, H, 2)
    for kw in (dict(aperture_radius=0.1), dict(focus_distance=2.0),
               dict(accel_mode="none"),
               dict(restir=dataclasses.replace(
                   base.restir, spatial_bias_correction="pairwise")),
               dict(sharc_enabled=True), dict(denoiser="NRDReBLUR"),
               dict(upscaling=True), dict(taa_mode="on"),
               dict(debug_view="ReGIRCells")):
        tpipeline.RenderPipeline(dataclasses.replace(base, **kw),
                                 device="cpu")
    tpipeline.RenderPipeline(tpipeline.PipelineConfig(), device="cpu")
    for kw in (dict(denoiser="NRD"), dict(debug_view="Heat"),
               dict(taa_history_filter="lanczos"), dict(taa_mode="always"),
               dict(accel_mode="bvh"),
               dict(restir=dataclasses.replace(
                   base.restir, spatial_bias_correction="exact"))):
        with pytest.raises(ValueError):
            tpipeline.RenderPipeline(dataclasses.replace(base, **kw),
                                     device="cpu")


def test_defaults_to_the_card():
    """The pipeline and every builder default to "cuda"; without a card
    they raise instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg = tpipeline.restir_frame_config(W, H, 2)
    with pytest.raises(RuntimeError, match="no GPU"):
        tpipeline.RenderPipeline(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.device("cuda")


def test_frame_bench_runs_without_jax():
    """A fresh interpreter runs the frame bench at 16x16 on the CPU and
    never imports jax or the reference package."""
    code = (
        "import sys\n"
        "from drts_tpu_torch import bench\n"
        "stats, img = bench.bench_frame(16, 16, bounces=2, iters=1,"
        " device='cpu')\n"
        "assert img.shape == (16, 16, 3) and bool(img.isfinite().all())\n"
        "assert set(stats['passes_ms']) >= {'update', 'restir_initial',"
        " 'trace', 'post'}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'drts_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
