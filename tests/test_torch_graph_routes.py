"""The port's compiled frame for the rest of the one-device frames, on the
CPU: ``RenderPipeline.render_frame_graph`` and ``pathtrace.
trace_image_graph`` run as the pieces a CUDA graph capture splits them
into (drts_tpu_torch/graphs.py), at 16x16 and 2 bounces, on
``myscene.build(oscillator_grid=2)`` (the frames) or 3 (the traces):

- the textured frame: ``PipelineConfig()`` on ``add_mesh_content(...,
  tessellation=1)`` (alpha rounds, packed textures, textured emitters),
  lit by a seeded lat-long EXR map;
- the options frame (``bench.options_frame_config``: the thin lens, the
  raytraced temporal and spatial bias correction, the real previous
  surface, shared spatial offsets), and each of its options alone on the
  ReSTIR frame;
- ``accel_mode="none"`` (B11 for every sphere hit and shadow ray);
- the MXU route (``clusters._USE_MXU``) at ``MXU_PREC`` "default",
  "high" and "highest";
- the headline trace on the clustered accel (B13) and on the MXU route.

The tests:

- (a) the capture audit: tests/test_torch_graph.py's ``HostAudit`` around
  every piece of each frame (two frames, the SHARC update and skip,
  after one eager warm-up frame; the traces with a forced spill wave),
  the kernels' plain versions outside it, as in
  tests/test_torch_graph_mesh.py: no host read, no host-made tensor;
- (b) under tests/test_torch_graph.py's fake capture (a replay re-runs
  the captured function on the captured buffers, so a choice baked into
  the capture shows), the pieces against ``render_frame`` bit for bit,
  images and every state leaf: 4 frames of the options frame (the shared
  offsets move each frame: a frozen offset fails), 2 of the others;
- (c) the shared-offset ReSTIR frame through the graph callable against
  the reference's ``render_frame_jit`` over 3 frames (its XLA path; no
  accel on either side), to tests/test_torch_options_frame.py's
  tolerances (picks differ on <= 1% of pixels, M on <= 5%, w_out within
  5e-3 relative where both agree; the tone-mapped images within 1e-6 on
  average and 1e-4 anywhere); the clustered headline trace against the
  reference's jitted frame (accel refit, G-buffer, trace) with B13 in
  interpret mode, to tests/test_torch_mxu_clustered.py's (radiance within
  1e-3 on >= 99.5% of pixels, the same rays traced);
- (d) ``clusters._USE_MXU`` or ``intersect_kernels.MXU_PREC`` changed
  after the first frame makes the next call raise ValueError;
- (e) ``Session(graph=True)`` through a static change that turns the thin
  lens on (``camera.aperture_radius``) gives the eager Session's frames
  bit for bit under the fake capture (the Session drops its callable and
  captures again).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import clusters as jclusters, myscene as jmyscene
from drts_tpu.models import pipeline as jpipeline
from drts_tpu.ops import camera as jcamera, gbuffer as jgbuffer
from drts_tpu.ops import intersect as jintersect, pathtrace as jpathtrace
from drts_tpu.ops import restir as jrestir
from drts_tpu_torch import bench, convert
from drts_tpu_torch.models import clusters, myscene, pipeline
from drts_tpu_torch.ops import camera, intersect_kernels as ik, pathtrace
from drts_tpu_torch.ops import restir, sharc
from drts_tpu_torch.utils import image

from test_torch_graph import (  # noqa: F401
    assert_same_bits, audit, bits, fake_card, one_thread)
from test_torch_graph_mesh import plain_unaudited  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

W = H = 16
BOUNCES = 2
SMALL = dict(output_width=W, output_height=H, render_width=W,
             render_height=H, bounces=BOUNCES, block_size=4096,
             sharc=sharc.SHARCConfig(capacity_log2=12))
FOCUS = float(np.linalg.norm(myscene.MySceneHost.camera_position))
# Each option of the options frame alone, on the ReSTIR frame.
ALONE = {
    "thin_lens": dict(aperture_radius=0.05, focus_distance=FOCUS),
    "raytraced": dict(restir=restir.ReSTIRConfig(
        spatial_bias_correction="raytraced",
        temporal_bias_correction="raytraced")),
    "real_surface": dict(restir=restir.ReSTIRConfig(
        temporal_bias_correction="pairwise", temporal_prev_surface="real")),
    "shared": dict(restir=restir.ReSTIRConfig(spatial_offset_mode="shared")),
}
PRECS = ("default", "high", "highest")
# The traces' deep segment: few enough slots that a 16x16 frame spills.
SPILL_CAPACITY = 16


@pytest.fixture(scope="module")
def env_path(tmp_path_factory):
    """A seeded 16x32 lat-long EXR map."""
    path = str(tmp_path_factory.mktemp("env") / "env.exr")
    rng = np.random.default_rng(7)
    image.write_exr(path, rng.uniform(0.0, 4.0, (16, 32, 3))
                    .astype(np.float32))
    return path


@pytest.fixture
def mxu(request, monkeypatch):
    """The MXU route at the precision `request.param`."""
    monkeypatch.setattr(clusters, "_USE_MXU", True)
    monkeypatch.setattr(ik, "MXU_PREC", request.param)
    return request.param


def frame_setup(frame, env=None):
    """(pipeline, start state, pose) of `frame`: "textured", "options",
    "accel_none", "mxu" (the default frame; the route is the caller's) or
    an ALONE key."""
    host = myscene.build(oscillator_grid=2, device="cpu",
                         env_map_path=env if frame == "textured" else None)
    if frame == "textured":
        host = myscene.add_mesh_content(host, tessellation=1)
    if frame == "options":
        cfg = bench.options_frame_config(**SMALL)
    elif frame in ALONE:
        cfg = dataclasses.replace(pipeline.restir_frame_config(
            W, H, BOUNCES, **ALONE[frame]), block_size=4096)
    else:
        cfg = pipeline.PipelineConfig(
            **SMALL, accel_mode="none" if frame == "accel_none" else "morton")
    pipe = pipeline.RenderPipeline(cfg, "cpu")
    return pipe, pipe.init_state(host), pipe.default_camera_pose(host)


def trace_setup(accel, capacity=0):
    """The headline trace's (call, scene, camera) on `accel`'s plan."""
    host = myscene.build(oscillator_grid=3, device="cpu")
    pos = np.array([0.0, 1.0, -5.0])
    cam = camera.make_camera(tuple(pos), tuple(-pos / np.linalg.norm(pos)),
                             aspect=1.0, device="cpu")
    centers, radii = host.scene.center.numpy(), host.scene.radius.numpy()
    plan = (clusters.build_plan(centers, radii, device="cpu")
            if accel == "clustered" else
            clusters.build_plan_morton(centers, radii, max_members=8,
                                       device="cpu"))
    cfg = pathtrace.PathTraceConfig(width=W, height=H, bounces=3,
                                    compact_capacity=capacity,
                                    block_size=4096)
    call = pathtrace.trace_image_graph(
        cfg, plan, "clustered" if accel == "clustered" else "morton")
    return call, host.scene, cam


def audited_frames(audit, pipe, state, pose):
    """One eager warm-up frame, then two frames of the callable's pieces
    under the audit; returns the last image."""
    pipe.render_frame(state, pose, prev_pose=pose)
    call = pipe.render_frame_graph()
    audit.clear()
    s1, img = call(state, pose)
    s2, img = call(s1, pose, 1.0 / 90.0, reset=True)
    assert audit == []
    assert s2.frame_count == 2 and call.stats.frames == 2
    assert torch.isfinite(img).all()
    return img


@pytest.mark.parametrize("frame", ["textured", "options", "accel_none",
                                   *ALONE])
def test_frame_pieces_make_no_host_traffic(audit, plain_unaudited, env_path,
                                           frame):
    pipe, state, pose = frame_setup(frame, env_path)
    audited_frames(audit, pipe, state, pose)


@pytest.mark.parametrize("mxu", PRECS, indirect=True)
def test_mxu_frame_pieces_make_no_host_traffic(audit, plain_unaudited, mxu):
    pipe, state, pose = frame_setup("mxu")
    audited_frames(audit, pipe, state, pose)
    acc = clusters.make_morton_accel(pipe.cluster_plan, state.scene.center,
                                     state.scene.radius)
    assert acc.mxu_a is not None


@pytest.mark.parametrize("accel", ["clustered", "mxu"])
def test_trace_pieces_make_no_host_traffic(audit, plain_unaudited,
                                           monkeypatch, accel):
    """The headline trace's pieces A, S (the spill wave) and B."""
    if accel == "mxu":
        monkeypatch.setattr(clusters, "_USE_MXU", True)
    call, scene, cam = trace_setup(accel, SPILL_CAPACITY)
    call(scene, cam, 0)                 # the warm-up frame
    audit.clear()
    out = call(scene, cam, 1)
    assert audit == []
    assert out.spill_waves == 1 and call.stats.frames == 2


@pytest.mark.parametrize("frame,frames", [("options", 4), ("textured", 2),
                                          ("accel_none", 2), ("mxu", 2)])
def test_frame_pieces_match_eager(fake_card, monkeypatch, env_path, frame,
                                  frames):
    """The callable under the fake capture against render_frame, bit for
    bit, frame by frame from one start (a reset on the third)."""
    if frame == "mxu":
        monkeypatch.setattr(clusters, "_USE_MXU", True)
    pipe, state, pose = frame_setup(frame, env_path)
    call = pipe.render_frame_graph()
    got = want = state
    for f in range(frames):
        got, image_ = call(got, pose, reset=f == 2)
        want, expect = pipe.render_frame(want, pose, reset=f == 2)
        assert torch.equal(bits(image_), bits(expect)), f
        assert_same_bits(got, want)
    assert call.stats.frames == frames


def test_device_offsets_are_the_roll():
    """The shared offsets as a device tensor gather the rows the host
    roll moves, bit for bit, for offsets of either sign."""
    cfg = restir.ReSTIRConfig(spatial_offset_mode="shared",
                              spatial_samples=3)
    packed = torch.randn(H, W, 5, generator=torch.Generator().manual_seed(3))
    ys, xs = torch.arange(H), torch.arange(W)
    signs = set()
    for frame_count in (0, 1, 7, 40):
        host = restir.shared_offsets(frame_count, cfg)
        dev = torch.tensor(host, dtype=torch.int64)
        for (dx, dy), (tx, ty) in zip(host, dev):
            signs |= {dx < 0, dy < 0}
            want = torch.roll(packed, shifts=(-dy, -dx), dims=(0, 1))
            got = packed.index_select(0, (ys + ty) % H).index_select(
                1, (xs + tx) % W)
            assert torch.equal(bits(got), bits(want))
    assert signs == {True, False}


def np_tree(x):
    return jax.tree.map(np.asarray, x)


SHARED = dict(local_light_mode="Power_RIS", spatial_offset_mode="shared",
              spatial_samples=2)


def test_shared_offset_frames_match_reference():
    """Three ReSTIR frames with shared offsets (no accel, 32x32, 1 bounce)
    through the graph callable against the reference's
    render_frame_jit."""
    frames, w, h, bounces = 3, 32, 32, 1
    jcfg = jpipeline.PipelineConfig(
        output_width=w, output_height=h, render_width=w, render_height=h,
        upscaling=False, bounces=bounces, denoiser="None",
        sharc_enabled=False, block_size=4096, compact_from=2,
        accel_mode="none", restir=jrestir.ReSTIRConfig(**SHARED))
    jp = jpipeline.RenderPipeline(jcfg)
    jstate = jp.init_state(jmyscene.build(oscillator_grid=3))
    eye, target = np.array((0.0, 2.5, -4.0)), np.array((0.0, 0.5, 0.0))
    fwd = (target - eye) / np.linalg.norm(target - eye)
    jpose = jpipeline.CameraPose(
        position=jnp.asarray(eye, jnp.float32),
        forward=jnp.asarray(fwd, jnp.float32),
        up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))
    tstate = convert.frame_state(np_tree(jstate), "cpu")
    step = jp.render_frame_jit()
    tcfg = dataclasses.replace(pipeline.restir_frame_config(
        w, h, bounces, accel_mode="none",
        restir=restir.ReSTIRConfig(**SHARED)), block_size=4096)
    tp = pipeline.RenderPipeline(tcfg, "cpu")
    tp.build_plan(tstate)
    tpose = pipeline.CameraPose(*(torch.tensor(np.asarray(x)) for x in
                                  (jpose.position, jpose.forward, jpose.up)))
    call = tp.render_frame_graph()
    for f in range(frames):
        jstate, jimg = step(jstate, jpose, jnp.float32(1.0 / 60.0), False)
        tstate, timg = call(tstate, tpose)
        jr, tr = np_tree(jstate.reservoirs), tstate.reservoirs
        same = tr.light_index.numpy() == jr.light_index
        assert 1.0 - same.mean() <= 0.01, (f, same.mean())
        same_m = tr.m_count.numpy() == jr.m_count
        assert 1.0 - same_m.mean() <= 0.05, (f, same_m.mean())
        both = same & same_m
        np.testing.assert_allclose(tr.w_out.numpy()[both], jr.w_out[both],
                                   rtol=5e-3, atol=1e-6)
        d = np.abs(timg.numpy() - np.asarray(jimg))
        assert d.mean() <= 1e-6 and d.max() <= 1e-4, (f, d.mean(), d.max())
    assert tstate.frame_count == frames
    assert (jr.w_out > 0).mean() > 0.2


def test_clustered_trace_matches_reference():
    """The clustered headline trace through trace_image_graph against the
    reference's jitted frame on its clustered accel (B13 in interpret
    mode)."""
    host = jmyscene.build(oscillator_grid=3)
    pos = np.array([0.0, 1.0, -5.0])
    jcam = jcamera.make_camera(tuple(pos), tuple(-pos / np.linalg.norm(pos)),
                               horizontal_fov_deg=90.0, aspect=1.0)
    kw = dict(width=W, height=H, bounces=BOUNCES, block_size=4096)
    jcfg = jpathtrace.PathTraceConfig(**kw)
    jplan = jclusters.build_plan(np.asarray(host.scene.center),
                                 np.asarray(host.scene.radius))

    @jax.jit
    def frame(s, c):
        acc = jclusters.make_accel(jplan, s.center, s.radius)
        gbuf = jgbuffer.generate(s, c, W, H, jcfg.block_size, accel=acc)
        return jpathtrace.trace_image(s, c, jcfg, 0, gbuf=gbuf, accel=acc)

    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        jout = np_tree(frame(host.scene, jcam))
    finally:
        jintersect.BACKEND = old
    scene = convert.scene(np_tree(host.scene), "cpu")
    plan = clusters.build_plan(scene.center.numpy(), scene.radius.numpy(),
                               device="cpu")
    call = pathtrace.trace_image_graph(pathtrace.PathTraceConfig(**kw), plan,
                                       "clustered")
    out = call(scene, convert.camera(np_tree(jcam), "cpu"), 0)
    diff = np.abs(out.radiance.numpy() - jout.radiance).max(-1)
    assert (diff <= 1e-3).mean() >= 0.995, (diff <= 1e-3).mean()
    assert float(out.rays_traced) == float(jout.rays_traced) > W * H


@pytest.mark.parametrize("kind", ["trace", "frame"])
@pytest.mark.parametrize("name,value", [("_USE_MXU", True),
                                        ("MXU_PREC", "highest")])
def test_changed_route_global_raises(monkeypatch, kind, name, value):
    """A callable holds the route globals of its first frame: a later call
    after one of them changed raises ValueError."""
    mod = clusters if name == "_USE_MXU" else ik
    assert getattr(mod, name) != value
    if kind == "trace":
        call, scene, cam = trace_setup("morton")
        step = functools.partial(call, scene, cam, 0)
    else:
        pipe, state, pose = frame_setup("shared")
        step = functools.partial(pipe.render_frame_graph(), state, pose)
    step()
    monkeypatch.setattr(mod, name, value)
    with pytest.raises(ValueError, match=name):
        step()


def test_session_captures_again_after_the_thin_lens(fake_card):
    """Session(graph=True) through a static change that turns the thin
    lens on equals the eager Session (16x16, 2 bounces)."""
    from drts_tpu_torch import config, session
    s = config.GraphicsSettings(render_width=W, render_height=H)
    s = dataclasses.replace(
        s, raytracing=dataclasses.replace(s.raytracing, bounces=BOUNCES),
        sharc=dataclasses.replace(s.sharc, capacity_log2=12)).check()
    runs = []
    for graph in (False, True):
        sess = session.Session(
            s, host=myscene.build(oscillator_grid=2, device="cpu"),
            device="cpu", graph=graph)
        images = []
        for i in range(3):
            if i == 1:
                assert sess.set("camera.aperture_radius", "0.05") == "static"
                assert sess.pipe.cfg.aperture_radius == 0.05
            images.append(sess.step().clone())
        runs.append(images)
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))
    assert not torch.equal(runs[0][0], runs[0][2])
