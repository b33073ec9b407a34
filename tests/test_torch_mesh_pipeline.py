"""The port's all-mesh default frame graph against the reference's:
``RenderPipeline(PipelineConfig())`` (physics, ReSTIR DI with triangle
lights, SHARC with its update every second frame and queries from bounce
2, ReBLUR, TAA, sharpen, bloom, ACES) on ``as_mesh_scene(build(
oscillator_grid=2), tessellation=1)`` at 32x32, 3 bounces, a 4,096-slot
cache, three consecutive frames from one converted start state, with
``compact_from=2``. tests/test_torch_mesh_pipeline_first.py runs the same
graph with ``compact_from=1`` (the reference's ``bench_mesh_pipeline``
integrator: the bounce-1 wavefront compacted and sorted too, and the SHARC
update trace compacted after bounce 0). Each file compiles one reference
frame graph under jit, which takes most of its time.
tests/test_torch_compact_first.py holds the partition-mode sort.

The reference runs its Pallas kernels in interpret mode, each frame under
one jit; the port takes its plain versions.

Tolerances: the tone-mapped images differ by <= 1e-3 on average (the
re-anchor of the ``compact_from=2`` graph saw <= 2e-4; measured here
<= 2.8e-4), and every counting counter (overflow, lights dropped, ReGIR
occupancy, SHARC hits, queries, gates, entries and dropped rows per
bounce) is equal. The one fraction among the counters,
lights_dropped_power_frac, is 1 minus a float32 ratio and agrees within
1e-6 (under jit XLA rounds it to 1.2e-7 where the port gives 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import intersect as jintersect, sharc as jsharc
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.models import pipeline as tpipeline
from drts_tpu_torch.ops import sharc as tsharc

W = H = 32
FRAMES = 3
POSE_EYE = (-1.455, 1.6, 0.6)
POSE_TARGET = (-1.455, 0.2, 1.6)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def render_both(compact_from):
    kw = dict(output_width=W, output_height=H, render_width=W,
              render_height=H, bounces=3, block_size=4096,
              compact_from=compact_from)
    jp = jpipeline.RenderPipeline(jpipeline.PipelineConfig(
        sharc=jsharc.SHARCConfig(capacity_log2=12), **kw))
    jstate = jp.init_state(jmyscene.as_mesh_scene(
        jmyscene.build(oscillator_grid=2), tessellation=1))
    assert jp.cluster_plan is None
    fwd = np.array(POSE_TARGET, np.float32) - np.array(POSE_EYE, np.float32)
    pose = jpipeline.CameraPose(
        position=jnp.asarray(POSE_EYE, jnp.float32),
        forward=jnp.asarray(fwd / np.linalg.norm(fwd)),
        up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))

    tp = tpipeline.RenderPipeline(tpipeline.PipelineConfig(
        sharc=tsharc.SHARCConfig(capacity_log2=12), **kw), device="cpu")
    tp.build_plan(tmyscene.as_mesh_scene(
        tmyscene.build(oscillator_grid=2, device="cpu"), tessellation=1))
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
            ref.append((np_tree(jstate.counters), np.asarray(img)))
    finally:
        jintersect.BACKEND = old
    port = []
    for _ in range(FRAMES):
        tstate, img = tp.render_frame(tstate, tpose)
        port.append((tstate.counters, img.numpy()))
    return ref, port


def assert_frames_match(ref, port):
    """The bounds of the module docstring, frame by frame."""
    for i, ((jc, jimg), (tc, timg)) in enumerate(zip(ref, port)):
        assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
        assert timg.min() >= 0.0 and timg.max() <= 1.0
        assert np.abs(timg - jimg).mean() <= 1e-3, (i, np.abs(
            timg - jimg).mean())
        assert set(tc) == set(jc)
        for k, v in jc.items():
            tol = 1e-6 if k == "lights_dropped_power_frac" else 0.0
            assert abs(float(tc[k]) - float(v)) <= tol, (i, k, float(tc[k]),
                                                         float(v))
    # The deep bounces queried the cache (the open 32x32 scene sends few
    # paths there; hits are phase 16 of chip_smoke.py's, at full size).
    assert sum(float(v) for k, v in port[-1][0].items()
               if k.startswith("sharc_queries")) > 0


@pytest.mark.parametrize("compact_from", [2],
                         ids=lambda c: f"compact_from={c}")
def test_mesh_pipeline_frames_match(compact_from):
    assert_frames_match(*render_both(compact_from))
