"""The port's default frame graph (``RenderPipeline(PipelineConfig())``:
physics, ReSTIR DI, SHARC, ReBLUR, TAA, sharpen, bloom, ACES) on the
textured mixed scene against the reference's: ``add_mesh_content(build(
oscillator_grid=2), tessellation=2)`` (spheres and three geosphere
instances, one alpha-tested, in one trace), two consecutive frames at
48x48, 3 bounces, a 4,096-slot cache, from one converted start state and
a pose 4 units from the instances.

The reference runs its Pallas kernels in interpret mode and each frame
under one jit (compiling that graph is most of this file's time); the
port takes its plain versions.

Tolerances (measured in brackets): frame 0 within chip_smoke.py's
DEFAULT_* bounds, mean |difference| <= 2e-4 (1.4e-4) and off by more than
0.05 on <= 0.2% of pixels (0.087%, 2 pixels: paths that go another way
where a uv on a texel edge picks another texel); frame 1 by <= 4e-3 on
average (1.1e-3) and off by more than 0.05 on <= 5% of pixels (1.1%): the
reprojected ReSTIR and denoiser histories spread those pixels, as in
tests/test_torch_default_frame.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import intersect as jintersect, sharc as jsharc
from drts_tpu_torch import convert
from drts_tpu_torch.models import pipeline as tpipeline
from drts_tpu_torch.ops import sharc as tsharc

FRAME_W = 48
POSE_EYE = (0.0, 2.0, -9.5)
POSE_TARGET = (0.0, 1.4, -4.0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def frames():
    jhost = jmyscene.add_mesh_content(jmyscene.build(oscillator_grid=2),
                                      tessellation=2)
    kw = dict(output_width=FRAME_W, output_height=FRAME_W,
              render_width=FRAME_W, render_height=FRAME_W, bounces=3,
              block_size=4096)
    jp = jpipeline.RenderPipeline(jpipeline.PipelineConfig(
        sharc=jsharc.SHARCConfig(capacity_log2=12), **kw))
    jstate = jp.init_state(jhost)
    fwd = np.subtract(POSE_TARGET, POSE_EYE).astype(np.float32)
    pose = jpipeline.CameraPose(
        position=jnp.asarray(POSE_EYE, jnp.float32),
        forward=jnp.asarray(fwd / np.linalg.norm(fwd)),
        up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))
    tp = tpipeline.RenderPipeline(tpipeline.PipelineConfig(
        sharc=tsharc.SHARCConfig(capacity_log2=12), **kw), device="cpu")
    tp.cluster_plan = convert.cluster_plan(jp.cluster_plan, "cpu")
    tstate = convert.frame_state(np_tree(jstate), "cpu")
    tpose = tpipeline.CameraPose(*(torch.from_numpy(np.array(x)) for x in
                                   (pose.position, pose.forward, pose.up)))
    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        step = jax.jit(jp.render_frame)
        ref = []
        for _ in range(2):
            jstate, img = step(jstate, pose)
            ref.append(np.asarray(img))
    finally:
        jintersect.BACKEND = old
    port = []
    for _ in range(2):
        tstate, img = tp.render_frame(tstate, tpose)
        port.append(img.numpy())
    return ref, port


@pytest.mark.parametrize("i", range(2))
def test_default_frames_match_reference(frames, i):
    ref, port = frames
    jimg, timg = ref[i], port[i]
    assert timg.shape == (FRAME_W, FRAME_W, 3) and np.isfinite(timg).all()
    assert timg.min() >= 0.0 and timg.max() <= 1.0
    d = np.abs(timg - jimg)
    off = (d.max(-1) > 0.05).mean()
    if i == 0:
        assert d.mean() <= 2e-4 and off <= 2e-3, (d.mean(), off)
    else:
        assert d.mean() <= 4e-3 and off <= 0.05, (d.mean(), off)
