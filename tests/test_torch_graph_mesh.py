"""The port's compiled mesh frames on the CPU: ``pathtrace.trace_image_graph``
on an all-mesh scene (``bench_mesh``'s frame) and
``RenderPipeline.render_frame_graph`` on the all-mesh ReSTIR frame and the
all-mesh pipeline (``bench.mesh_pipeline_config``), run as the pieces a
CUDA graph capture splits them into (drts_tpu_torch/graphs.py), on
``as_mesh_scene(build(oscillator_grid=2), tessellation=1)`` at 32x32 or
less, 3 bounces.

- The capture audit: tests/test_torch_graph.py's ``HostAudit`` entered
  around every piece of the mesh trace (with a forced spill, so that the
  second wave is a piece too, at ``MESH_CAND`` 0, 1 and 2), of the
  all-mesh ReSTIR frame and of the all-mesh pipeline (SHARC update and
  skip frames; the bounce-1 segment in partition mode), each after one
  eager warm-up frame: no host read, no host-made tensor. The kernels'
  plain versions, which stand in for the kernel launches on the CPU (the
  card launches the kernel there), run outside the audit; the wrappers'
  own code, the instance tables and everything around them run inside.
- The graph pieces against the eager frame, bit for bit: the pipeline
  frames' images and every state leaf; the mesh trace's radiance with a
  forced spill (one wave) and a clean frame (none).
- The slice against the reference: ``trace_image_graph`` on the mesh
  scene against the reference's ``trace_image_jit`` on the converted
  scene (its Pallas kernels in interpret mode), to
  tests/test_torch_mesh_trace.py's tolerances: ``primary_valid`` equal,
  the ray count equal, radiance within 1e-3 on >= 99.5% of pixels.
- A mesh global changed after the first frame (``MESH_CAND``,
  ``B9_SPARSE_LIVE``) makes the next call raise ValueError.
- Under tests/test_torch_graph.py's fake capture (a replay re-runs the
  captured function into the capture's outputs), ``Session(host=<all-mesh>,
  graph=True)`` through a static change gives the eager Session's frames
  bit for bit.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from drts_tpu.models import myscene as jmyscene
from drts_tpu.ops import camera as jcamera, intersect as jintersect
from drts_tpu.ops import pathtrace as jpathtrace
from drts_tpu_torch import bench, convert, graphs
from drts_tpu_torch.models import myscene, pipeline
from drts_tpu_torch.ops import camera, intersect_kernels, pathtrace
from drts_tpu_torch.ops import reproject_kernels, restir_kernels, sharc
from drts_tpu_torch.ops import trimesh, trimesh_kernels

from test_torch_graph import (  # noqa: F401
    assert_same_bits, audit, bits, fake_card, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

W = H = 32
BOUNCES = 3
# A pose close above the instances: its deep segment holds ~40 lanes, so
# SPILL_CAPACITY slots overflow into the second wave.
EYE, TARGET = (0.0, 1.0, -3.0), (0.0, -2.0, 0.0)
SPILL_CAPACITY = 8
KERNEL_MODULES = (intersect_kernels, reproject_kernels, restir_kernels,
                  trimesh_kernels)


def mesh_host():
    return myscene.as_mesh_scene(
        myscene.build(oscillator_grid=2, device="cpu"), tessellation=1)


def close_camera():
    eye = np.array(EYE)
    fwd = np.array(TARGET) - eye
    return camera.make_camera(tuple(eye), tuple(fwd / np.linalg.norm(fwd)),
                              horizontal_fov_deg=90.0, aspect=1.0,
                              device="cpu")


def trace_config(capacity=0):
    """bench.make_mesh_setup's config at 32x32 and 3 bounces."""
    return pathtrace.PathTraceConfig(width=W, height=H, bounces=BOUNCES,
                                     block_size=32768, compact_from=2,
                                     compact_capacity=capacity)


@pytest.fixture
def plain_unaudited(monkeypatch):
    """Every kernel's plain version runs with the audit suspended."""
    def unaudited(fn):
        @functools.wraps(fn)
        def plain(*args, **kw):
            with _disable_current_modes():
                return fn(*args, **kw)
        return plain
    for mod in KERNEL_MODULES:
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, unaudited(getattr(mod, name)))


@pytest.fixture
def mesh_cand(request, monkeypatch):
    monkeypatch.setattr(trimesh, "MESH_CAND", request.param)
    return request.param


def frame_setup(frame):
    """The all-mesh ReSTIR frame (physics on) or the all-mesh pipeline
    (render 16x16 upscaled to 32x32, compact_from=1 with the bounce-1
    segment in partition mode, SHARC, ReBLUR, TAA, physics off): the
    pipeline, its start state and pose."""
    if frame == "restir":
        cfg = pipeline.restir_frame_config(W, H, BOUNCES)
    else:
        cfg = bench.mesh_pipeline_config(
            output_width=W, output_height=H, render_width=W // 2,
            render_height=H // 2, bounces=BOUNCES, block_size=4096,
            sharc=sharc.SHARCConfig(capacity_log2=12))
    pipe = pipeline.RenderPipeline(cfg, "cpu")
    if frame == "pipeline":
        base = pipe._pt_cfg
        pipe._pt_cfg = lambda: dataclasses.replace(
            base(), compact_sort_partition_min=0)
    host = mesh_host()
    return pipe, pipe.init_state(host), pipe.default_camera_pose(host)


@pytest.mark.parametrize("mesh_cand", [0, 1, 2], indirect=True)
def test_mesh_trace_pieces_make_no_host_traffic(audit, plain_unaudited,
                                                mesh_cand):
    """The mesh trace's pieces A, S (the spill wave) and B make no host
    traffic at each closest-hit form."""
    scene, cam = mesh_host().scene, close_camera()
    call = pathtrace.trace_image_graph(trace_config(SPILL_CAPACITY))
    call(scene, cam, 0)                 # the warm-up frame
    audit.clear()
    out = call(scene, cam, 1)
    assert audit == []
    assert out.spill_waves == 1 and call.stats.frames == 2


@pytest.mark.parametrize("frame", ["restir", "pipeline"])
def test_mesh_frame_pieces_make_no_host_traffic(audit, plain_unaudited,
                                                frame):
    """Two frames (SHARC update, then skip) of the graph callable's pieces
    after one eager warm-up frame: no host read, no host-made tensor."""
    pipe, state, pose = frame_setup(frame)
    pipe.render_frame(state, pose, prev_pose=pose)
    call = pipe.render_frame_graph()
    audit.clear()
    s1, img = call(state, pose)
    s2, _ = call(s1, pose, 1.0 / 90.0, reset=True)
    assert audit == []
    assert s2.frame_count == 2 and call.stats.frames == 2
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("frame", ["restir", "pipeline"])
def test_mesh_frame_pieces_match_eager(frame):
    """Two frames through the callable's pieces equal render_frame's bit
    for bit: the image and every state leaf."""
    pipe, state, pose = frame_setup(frame)
    call = pipe.render_frame_graph()
    got = want = state
    for f in range(2):
        got, image = call(got, pose, 1.0 / 60.0)
        want, expect = pipe.render_frame(want, pose, 1.0 / 60.0)
        assert torch.equal(bits(image), bits(expect)), f
        assert_same_bits(got, want)


@pytest.mark.parametrize("capacity", [SPILL_CAPACITY, 0])
def test_mesh_trace_pieces_match_eager(capacity):
    """The mesh trace through the callable's pieces equals trace_image's
    radiance, rays and overflow bit for bit; at SPILL_CAPACITY slots it
    runs the second wave, at the default capacity none."""
    scene, cam = mesh_host().scene, close_camera()
    cfg = trace_config(capacity)
    want = pathtrace.trace_image(scene, cam, cfg, 3)
    call = pathtrace.trace_image_graph(cfg)
    got = call(scene, cam, 3)
    assert got.spill_waves == want.spill_waves == (1 if capacity else 0)
    for name in ("radiance", "rays_traced", "primary_valid"):
        assert torch.equal(bits(getattr(got, name)),
                           bits(getattr(want, name))), name
    assert torch.equal(got.counters["wavefront_overflow_paths"],
                       want.counters["wavefront_overflow_paths"])


def test_mesh_trace_graph_matches_reference():
    """trace_image_graph on the mesh scene against the reference's
    trace_image_jit on the same scene (2 bounces, the demo camera)."""
    host = jmyscene.build(oscillator_grid=2)
    jsc = jmyscene.as_mesh_scene(host, tessellation=1).scene
    jcam = jcamera.make_camera(host.camera_position, host.camera_forward,
                               horizontal_fov_deg=90.0, aspect=1.0)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    kw = dict(width=W, height=H, bounces=2, samples_per_pixel=1,
              block_size=32768, compact_from=2)
    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        jout = np_tree(jpathtrace.trace_image_jit(
            jsc, jcam, jpathtrace.PathTraceConfig(**kw), 0))
    finally:
        jintersect.BACKEND = old
    call = pathtrace.trace_image_graph(pathtrace.PathTraceConfig(**kw))
    tout = call(convert.scene(np_tree(jsc), "cpu"),
                convert.camera(np_tree(jcam), "cpu"), 0)
    valid = jout.primary_valid
    np.testing.assert_array_equal(tout.primary_valid.numpy(), valid)
    assert 0.1 < valid.mean() < 0.95
    assert float(tout.rays_traced) == float(jout.rays_traced) > W * H
    rad = tout.radiance.numpy()
    assert rad.shape == (H, W, 3) and np.isfinite(rad).all()
    diff = np.abs(rad - jout.radiance).max(-1)
    assert (diff <= 1e-3).mean() >= 0.995, (diff <= 1e-3).mean()


@pytest.mark.parametrize("kind", ["trace", "frame"])
@pytest.mark.parametrize("name,value", [("MESH_CAND", 2),
                                        ("B9_SPARSE_LIVE", 64)])
def test_changed_mesh_global_raises(monkeypatch, kind, name, value):
    """A callable holds the mesh globals of its first frame: a later call
    after one of them changed raises ValueError."""
    mod = trimesh if name == "MESH_CAND" else trimesh_kernels
    assert getattr(mod, name) != value
    if kind == "trace":
        scene, cam = mesh_host().scene, close_camera()
        call = pathtrace.trace_image_graph(dataclasses.replace(
            trace_config(), width=16, height=16))
        step = functools.partial(call, scene, cam, 0)
    else:
        pipe, state, pose = frame_setup("restir")
        call = pipe.render_frame_graph()
        step = functools.partial(call, state, pose)
    step()
    monkeypatch.setattr(mod, name, value)
    with pytest.raises(ValueError, match=name):
        step()


def test_mesh_session_captures_again_after_a_static_change(fake_card):
    """Session(host=<all-mesh>, graph=True) through a static change (3 to
    2 bounces) equals the eager Session (16x16 output, rendered at 8x8)."""
    from drts_tpu_torch import config, session
    s = config.GraphicsSettings(render_width=16, render_height=16)
    s = dataclasses.replace(
        s, raytracing=dataclasses.replace(s.raytracing, bounces=3),
        sharc=dataclasses.replace(s.sharc, capacity_log2=12)).check()
    runs = []
    for graph in (False, True):
        sess = session.Session(s, host=mesh_host(), device="cpu",
                               graph=graph)
        images = []
        for i in range(3):
            if i == 1:
                assert sess.set("raytracing.bounces", "2") == "static"
            images.append(sess.step().clone())
        runs.append(images)
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))
