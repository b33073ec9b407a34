"""The port's camera options against the reference's: the uniform disk
sample, the thin-lens camera and its focus distance, the G-buffer's lens
branch with its per-pixel aperture stream and the pipeline's cameras (the
previous one built with the focus distance too), and ``accel_mode="none"``
(no sphere accel: the brute-force sweep carries the closest hits and the
shadow rays).

The reference runs on its XLA path. Tolerances:

- the G-buffer's aperture stream (the rng state after ``init(px + 977,
  py + 557, frame)`` and its two uniforms): exact;
- camera frames: 1e-6 relative (both round in float32; the reference's
  XLA:CPU may contract multiply-adds);
- disk samples, ray origins and directions: 2e-6 absolute;
- G-buffer on the oscillator field at 32x32, pose moving between frames:
  the hit mask on >= 99% of pixels; where both hit, depth within 1e-4
  relative, motion within 2e-3 px, ray origins within 2e-6;
- the brute-force shadow rays: the same occlusion bit on >= 99.9% of
  rays; closest hits: the same index on >= 99.9%, t within 1e-4
  relative where both hit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import brdf as jbrdf, camera as jcamera
from drts_tpu.ops import gbuffer as jgbuffer, trace as jtrace
from drts_tpu.utils import rng as jrng
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene, pipeline as tpipeline
from drts_tpu_torch.ops import brdf as tbrdf, camera as tcamera
from drts_tpu_torch.ops import gbuffer as tgbuffer, trace as ttrace
from drts_tpu_torch.utils import rng as trng

W = H = 32
FRAME = 7
APERTURE = 0.05
EYE = (0.0, 2.5, -4.0)
TARGET = (0.0, 0.5, 0.0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t(x):
    return torch.from_numpy(np.array(x))


def test_uniform_disk():
    u = np.random.default_rng(3).random((4096, 2)).astype(np.float32)
    got = tbrdf.sample_uniform_disk(t(u)).numpy()
    want = np.asarray(jbrdf.sample_uniform_disk(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert (np.linalg.norm(got, axis=-1) <= 1.0 + 1e-6).all()


@pytest.mark.parametrize("focus", [1.0, 4.0, 17.5])
def test_thin_lens_camera(focus):
    """make_camera's frame at a focus distance, and thin-lens rays from
    one set of uniforms: each ray leaves its own aperture point."""
    kw = dict(horizontal_fov_deg=75.0, aspect=1.5, jitter=(0.1, -0.2),
              aperture_radius=APERTURE, focus_distance=focus)
    fwd = (0.3, -0.2, 1.0)
    jc = jcamera.make_camera(EYE, fwd, **kw)
    tc = tcamera.make_camera(EYE, fwd, device="cpu", **kw)
    for name in ("right", "up", "forward", "aperture_radius"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-6,
                                   err_msg=name)
    assert float(np.linalg.norm(tc.forward.numpy())) == pytest.approx(
        focus, rel=1e-6)
    ndc = jcamera.pixel_ndc(W, H, jc.jitter)
    u = np.random.default_rng(4).random((H, W, 2)).astype(np.float32)
    want = jcamera.generate_thin_lens_rays(jc, ndc, jnp.asarray(u))
    got = tcamera.generate_thin_lens_rays(tc, t(ndc), t(u))
    for g, w_, name in zip(got, want, ("origin", "direction", "tmin",
                                       "tmax")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=2e-6,
                                   atol=2e-6, err_msg=name)
    spread = np.ptp(got[0].numpy().reshape(-1, 3), axis=0).max()
    assert 0.5 * APERTURE < spread <= 2.0 * APERTURE


@pytest.fixture(scope="module")
def frames():
    """Both pipelines' cameras (pose moving from a previous pose) and the
    thin-lens G-buffers of the oscillator field at 32x32, focus distance
    4, frame FRAME."""
    host = jmyscene.build(oscillator_grid=3)
    jcfg = jpipeline.PipelineConfig(
        output_width=W, output_height=H, render_width=W, render_height=H,
        aperture_radius=APERTURE, focus_distance=4.0, accel_mode="none")
    jp = jpipeline.RenderPipeline(jcfg)
    fwd = np.array(TARGET, np.float32) - np.array(EYE, np.float32)
    fwd = fwd / np.linalg.norm(fwd)

    def pose(eye, lib):
        cast = (lambda x: jnp.asarray(x, jnp.float32)) if lib == "jax" \
            else (lambda x: torch.tensor(x, dtype=torch.float32))
        cls = jpipeline.CameraPose if lib == "jax" else tpipeline.CameraPose
        return cls(cast(eye), cast(fwd), cast((0.0, 1.0, 0.0)))
    prev_eye = (0.15, 2.45, -4.1)
    jcam = jp._camera(types.SimpleNamespace(frame_index=jnp.int32(FRAME)),
                      pose(EYE, "jax"), pose(prev_eye, "jax"))
    gen = jax.jit(lambda sc, cm, fi: jgbuffer.generate(
        sc, cm, W, H, 4096, thin_lens=True, frame_index=fi))
    jg = np_tree(gen(host.scene, jcam, jnp.int32(FRAME)))

    tcfg = tpipeline.PipelineConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tpipeline.PipelineConfig)
        if f.name not in ("restir", "sharc")})
    tp = tpipeline.RenderPipeline(tcfg, device="cpu")
    tcam = tp._camera(types.SimpleNamespace(frame_index=torch.tensor(FRAME)),
                      pose(EYE, "torch"), pose(prev_eye, "torch"))
    scene = convert.scene(np_tree(host.scene), "cpu")
    tg = tgbuffer.generate(scene, tcam, W, H, 4096, thin_lens=True,
                           frame_index=FRAME)
    return dict(jcam=jcam, tcam=tcam, jg=jg, tg=tg, tp=tp, host=host,
                scene=scene)


def test_pipeline_cameras(frames):
    """The current camera (lens and focus distance) and the previous one
    (built with the focus distance) of both pipelines."""
    jc, tc = frames["jcam"], frames["tcam"]
    for name in ("position", "right", "up", "forward", "prev_position",
                 "prev_right", "prev_up", "prev_forward", "jitter",
                 "aperture_radius"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert float(torch.linalg.norm(tc.prev_forward)) == pytest.approx(4.0)


def test_lens_stream_exact():
    py, px = np.mgrid[0:H, 0:W].astype(np.int32)
    j_state = jrng.init(jnp.asarray(px + 977), jnp.asarray(py + 557),
                        jnp.int32(FRAME))
    j_u, j_next = jrng.next_floats(j_state, 2)
    t_state = trng.init(t(px) + 977, t(py) + 557, FRAME)
    t_u, t_next = trng.next_floats(t_state, 2)
    np.testing.assert_array_equal(t_state.numpy(),
                                  np.asarray(j_state).astype(np.int64))
    np.testing.assert_array_equal(t_next.numpy(),
                                  np.asarray(j_next).astype(np.int64))
    np.testing.assert_array_equal(t_u.numpy(), np.asarray(j_u))


def test_thin_lens_gbuffer(frames):
    jg, tg = frames["jg"], frames["tg"]
    valid_j = jg.surf.valid
    valid_t = tg.surf.valid.numpy()
    assert (valid_j == valid_t).mean() >= 0.99
    assert valid_j.mean() > 0.3
    np.testing.assert_allclose(tg.ray_origin.numpy(), jg.ray_origin,
                               atol=2e-6)
    np.testing.assert_allclose(tg.ray_direction.numpy(), jg.ray_direction,
                               atol=2e-6)
    # Every pixel has its own origin on the aperture.
    off = tg.ray_origin.numpy() - np.asarray(EYE, np.float32)
    assert np.unique(off.reshape(-1, 3), axis=0).shape[0] > 0.9 * W * H
    both = valid_j & valid_t
    np.testing.assert_allclose(tg.linear_depth.numpy()[both],
                               jg.linear_depth[both], rtol=1e-4)
    np.testing.assert_allclose(tg.motion.numpy()[both], jg.motion[both],
                               atol=2e-3)
    assert np.abs(jg.motion[both]).max() > 0.5


def test_accel_none(frames):
    """accel_mode="none" builds no plan and no accel; the shadow rays and
    closest hits of the brute-force sweep against the reference's."""
    tp, host, scene = frames["tp"], frames["host"], frames["scene"]
    state = tp.init_state(tmyscene.build(oscillator_grid=3, device="cpu"))
    assert tp.cluster_plan is None
    _, _, _, accel = tp._stage_update(
        state, tp.default_camera_pose(), 1.0 / 60.0)
    assert accel is None

    rng = np.random.default_rng(5)
    n = 4096
    o = (rng.random((n, 3)) * np.array([8, 3, 8]) - [4, 0, 4]).astype(
        np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = (rng.random(n) * 6.0).astype(np.float32)
    excl = rng.integers(-1, host.scene.center.shape[0], n).astype(np.int32)
    want = np.asarray(jtrace.occluded_scene(
        host.scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(excl), 4096))
    got = ttrace.occluded_scene(scene, t(o), t(d), t(tmax), t(excl).long(),
                                4096).numpy()
    assert (got == want).mean() >= 0.999
    assert 0.05 < want.mean() < 0.95
    js = np_tree(jtrace.trace_scene(host.scene, jnp.asarray(o),
                                    jnp.asarray(d), jnp.zeros(n),
                                    jnp.full(n, 1e8), 4096))
    ts = ttrace.trace_scene(scene, t(o), t(d), torch.zeros(n),
                            torch.full((n,), 1e8), 4096)
    same = ts.object_index.numpy() == js.object_index
    assert same.mean() >= 0.999
    both = same & js.valid & ts.valid.numpy()
    np.testing.assert_allclose(ts.distance.numpy()[both], js.distance[both],
                               rtol=1e-4)
