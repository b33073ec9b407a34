"""The port's default frame (``RenderPipeline(PipelineConfig())``: physics,
ReSTIR DI, SHARC with its update every second frame and queries from
bounce 2, the NRD ReBLUR denoiser, TAA at native resolution, sharpen,
bloom and ACES) against the reference's, three consecutive frames at
64x64, 3 bounces, on the demo scene with oscillator grid 3 (45 spheres, 9
of them lights), with ``SHARCConfig(capacity_log2=12)``, both started from
the same converted ``FrameState``.

The reference runs its Pallas kernels in interpret mode and each frame
under one jit; its reprojections go through tile windows, whose ``ok`` mask
is the in-frame test at these motions (tests/test_torch_pipeline.py checks
that), so both packages take the same history. Frame 0 and frame 2 run
the SHARC update (frame 1 skips it), so frame 2's trace reads a cache
filled by two updates.

Tolerances (measured on these frames in brackets). Frame 0 has no
history, and the two agree closely; from frame 1 on, the in-frame test of
the outermost pixel ring flips between the packages (the motion of a
still pixel is rounding noise of ~1e-5 px in both), so the denoiser takes
history on one side and not the other there (30 and 48 ring pixels), and
the ReSTIR temporal pass does the same (tests/test_torch_pipeline.py);
ReSTIR's spatial reuse (30 px radius), the a-trous passes (15 x 15
footprint) and TAA spread those pixels over the frame. The module tests
(tests/test_torch_denoise.py, tests/test_torch_taa.py, tests/
test_torch_sharc.py) hold each pass to the reference on identical inputs.

- frame 0: tone-mapped images differ by <= 2e-4 on average (6.1e-5), by
  more than 1e-3 on <= 2% of pixels (0.73%: paths that end in another
  voxel or light where XLA:CPU's fused multiply-adds move a hit point);
- frames 1 and 2: by <= 4e-3 on average (1.2e-3, 1.6e-3), by more than
  0.02 on <= 12% of pixels (5.2%, 6.3%) and by more than 0.05 on <= 3%
  (1.1%, 1.4%);
- the denoiser's history lengths differ only on the outer ring; the TAA
  histories by <= 1e-2 on average (5.3e-5, 2.7e-3, 3.4e-3);
- SHARC: fingerprints equal on >= 99% of the slots either side fills and
  sample counts on >= 98% (1.0 and 1.0 on every frame); the counters
  within 2% of the larger value plus 2 (largest relative difference
  1.2e-7); sharc_splat_dropped_rows exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import intersect as jintersect, sharc as jsharc
from drts_tpu_torch import convert
from drts_tpu_torch.models import pipeline as tpipeline
from drts_tpu_torch.ops import sharc as tsharc

W = H = 64
FRAMES = 3
POSE_EYE = (0.0, 2.5, -4.0)
POSE_TARGET = (0.0, 0.5, 0.0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def small_config(cls, sharc_cls):
    return cls(output_width=W, output_height=H, render_width=W,
               render_height=H, bounces=3, block_size=4096,
               sharc=sharc_cls(capacity_log2=12))


@pytest.fixture(scope="module")
def frames():
    jcfg = small_config(jpipeline.PipelineConfig, jsharc.SHARCConfig)
    jp = jpipeline.RenderPipeline(jcfg)
    host = jmyscene.build(oscillator_grid=3)
    jstate = jp.init_state(host)
    fwd = np.array(POSE_TARGET, np.float32) - np.array(POSE_EYE, np.float32)
    pose = jpipeline.CameraPose(
        position=jax.numpy.asarray(POSE_EYE, jax.numpy.float32),
        forward=jax.numpy.asarray(fwd / np.linalg.norm(fwd)),
        up=jax.numpy.asarray((0.0, 1.0, 0.0), jax.numpy.float32))

    tcfg = small_config(tpipeline.PipelineConfig, tsharc.SHARCConfig)
    tp = tpipeline.RenderPipeline(tcfg, device="cpu")
    tp.cluster_plan = convert.cluster_plan(jp.cluster_plan, "cpu")
    tstate = convert.frame_state(np_tree(jstate), "cpu")
    tpose = tpipeline.CameraPose(*(torch.from_numpy(np.array(x)) for x in
                                   (pose.position, pose.forward, pose.up)))

    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        step = jax.jit(jp.render_frame)
        ref = []
        for _ in range(FRAMES):
            jstate, img = step(jstate, pose)
            ref.append((np_tree(jstate), np.asarray(img)))
    finally:
        jintersect.BACKEND = old

    port = []
    for _ in range(FRAMES):
        tstate, img = tp.render_frame(tstate, tpose)
        port.append((tstate, img.numpy()))
    return ref, port


@pytest.mark.parametrize("i", range(FRAMES))
def test_images_match(frames, i):
    ref, port = frames
    jimg, timg = ref[i][1], port[i][1]
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert timg.min() >= 0.0 and timg.max() <= 1.0
    d = np.abs(timg - jimg)
    off = d.max(-1)
    if i == 0:
        assert d.mean() <= 2e-4, d.mean()
        assert (off > 1e-3).mean() <= 0.02
    else:
        assert d.mean() <= 4e-3, d.mean()
        assert (off > 0.02).mean() <= 0.12
        assert (off > 0.05).mean() <= 0.03


@pytest.mark.parametrize("i", range(FRAMES))
def test_histories_match(frames, i):
    ref, port = frames
    js, ts = ref[i][0], port[i][0]
    assert ts.frame_count == int(js.frame_index) == i + 1
    hist_j = np.asarray(js.denoiser.history_length)
    hist_t = ts.denoiser.history_length.numpy()
    inner = (slice(1, H - 1), slice(1, W - 1))
    np.testing.assert_array_equal(hist_t[inner], hist_j[inner])
    assert hist_t.max() == i + 1
    taa_d = np.abs(ts.taa.history.numpy() - np.asarray(js.taa.history))
    assert taa_d.mean() <= 1e-2


@pytest.mark.parametrize("i", range(FRAMES))
def test_sharc_cache_and_counters_match(frames, i):
    ref, port = frames
    js, ts = ref[i][0], port[i][0]
    fp_j = np.asarray(js.sharc.fingerprint).astype(np.int64)
    fp_t = ts.sharc.fingerprint.numpy()
    filled = (fp_j > 0) | (fp_t > 0)
    assert filled.sum() > 100
    fp_same = (fp_j == fp_t)[filled].mean()
    cnt_same = (np.asarray(js.sharc.sample_count)
                == ts.sharc.sample_count.numpy())[filled].mean()
    assert fp_same >= 0.99 and cnt_same >= 0.98
    for k, v in js.counters.items():
        a, b = float(v), float(ts.counters[k])
        assert abs(a - b) <= 0.02 * max(abs(a), abs(b)) + 2.0, (k, a, b)
    assert (float(ts.counters["sharc_splat_dropped_rows"])
            == float(js.counters["sharc_splat_dropped_rows"]))


def test_cache_is_used_by_the_last_frame(frames):
    """Frame 1 skips the update (the cache is frame 0's); frame 2 updates
    again and its trace ends paths in the cache."""
    ref, port = frames
    for k in ("fingerprint", "sample_count"):
        assert torch.equal(getattr(port[1][0].sharc, k),
                           getattr(port[0][0].sharc, k))
    last = port[2][0].counters
    hits = sum(float(last[f"sharc_hits_b{b}"]) for b in (2, 3))
    assert hits > 0
    assert float(last["sharc_hits_b1"]) == 0.0   # queries start at bounce 2


def test_other_denoisers_and_views_run(frames):
    """ReLAX, DLSS-RR's core (with its TAA confidence) and the three debug
    views run from the last state and give finite images in [0, 1]."""
    _, port = frames
    state = port[-1][0]
    tcfg = small_config(tpipeline.PipelineConfig, tsharc.SHARCConfig)
    pose = tpipeline.CameraPose(torch.tensor(POSE_EYE),
                                torch.tensor([0.0, -0.447214, 0.894427]),
                                torch.tensor([0.0, 1.0, 0.0]))
    for kw in (dict(denoiser="NRDReLAX"),
               dict(denoiser="DLSSRayReconstruction"),
               dict(debug_view="ReGIRCells"), dict(debug_view="SHARC"),
               dict(debug_view="NRDValidation")):
        pipe = tpipeline.RenderPipeline(dataclasses.replace(tcfg, **kw),
                                        device="cpu")
        pipe.build_plan(type("Host", (), {"scene": state.scene})())
        new, img = pipe.render_frame(state, pose)
        assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
        assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0, kw
        assert new.frame_count == state.frame_count + 1
