"""The port's textured mixed scene against the reference's:
``add_mesh_content(build(oscillator_grid=2), tessellation=2)`` (the
24-sphere demo field, three geosphere instances: gold metal, a checker
and an alpha-tested cutout checker, two alpha-test rounds) through
``trace.trace_scene`` and ``pathtrace.trace_image``;
tests/test_torch_textured_pipeline.py runs it through the default frame
graph.

The reference runs its Pallas kernels in interpret mode; the port takes
its plain versions. Both start from one scene, converted from the
reference's (``convert.scene``); the port's own ``add_mesh_content`` is
held to the reference's build separately.

Tolerances. A uv on a texel edge picks the next texel under "nearest0"
when to_latlong or the barycentric uv differ by an ulp between the
packages (XLA:CPU contracts multiply-adds into FMAs), and on the cutout
checker that turns a hit into a pass-through. So:

- alpha-tested ray wall through the cutout instance: the object index
  agrees on every lane but those whose reference uv x S (S = 256, level
  0) lies within 1e-3 of an integer on a surface the alpha test read, and
  those are <= 1% of lanes; some lanes pass through a hole;
- the 32x32 path-trace frame (3 bounces, texture_bounces 2): primary hit
  bits differ on <= 1% of pixels, radiance within 1e-3 on >= 99% of
  pixels, the primary position, normal and albedo within 1e-4 where both
  hit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene
from drts_tpu.ops import camera as jcamera, intersect as jintersect
from drts_tpu.ops import pathtrace as jpathtrace, trace as jtrace
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.ops import pathtrace as tpathtrace, trace as ttrace

TRACE_W = 32
# A pose 4 units from the instances (z = -5, -6), the sphere field behind.
POSE_EYE = (0.0, 2.0, -9.5)
POSE_TARGET = (0.0, 1.4, -4.0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def scenes():
    jhost = jmyscene.add_mesh_content(jmyscene.build(oscillator_grid=2),
                                      tessellation=2)
    return jhost, convert.scene(np_tree(jhost.scene), "cpu")


def interpret(fn, *args, **kw):
    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        return np_tree(fn(*args, **kw))
    finally:
        jintersect.BACKEND = old


def test_add_mesh_content_matches_reference(scenes):
    """The port's own build: the same atlas, texture rows, materials and
    instances as the reference's; its geosphere the same triangles."""
    jhost, _ = scenes
    thost = tmyscene.add_mesh_content(
        tmyscene.build(oscillator_grid=2, device="cpu"), tessellation=2)
    js, ts = jhost.scene, thost.scene
    np.testing.assert_array_equal(thost.atlas, jhost.atlas)
    np.testing.assert_array_equal(
        ts.textures.rows.numpy(),
        np.asarray(js.textures.rows, np.uint32).view(np.int32))
    np.testing.assert_array_equal(
        ts.textures.rows_half.numpy(),
        np.asarray(js.textures.rows_half, np.uint32).view(np.int32))
    assert (ts.textures.n_words, ts.textures.size) == (2, 256)
    for f in dataclasses.fields(ts.materials):
        np.testing.assert_array_equal(
            getattr(ts.materials, f.name).numpy(),
            np.asarray(getattr(js.materials, f.name)), f.name)
        np.testing.assert_array_equal(
            getattr(thost.raw_materials, f.name).numpy(),
            np.asarray(getattr(jhost.raw_materials, f.name)), f.name)
    for f in dataclasses.fields(ts.mesh_instances):
        np.testing.assert_array_equal(
            getattr(ts.mesh_instances, f.name).numpy(),
            np.asarray(getattr(js.mesh_instances, f.name)), f.name)
    assert ts.alpha_test_rounds == js.alpha_test_rounds == 2

    def tris(mesh):
        v = np.stack([np.asarray(mesh.v0), np.asarray(mesh.v0)
                      + np.asarray(mesh.e1), np.asarray(mesh.v0)
                      + np.asarray(mesh.e2)], 1)
        return sorted(tuple(np.round(sorted(map(tuple, t)), 5).ravel())
                      for t in v)
    assert tris(ts.mesh) == tris(js.mesh)


def ray_wall(n=48, seed=0):
    """n x n rays from z = -9 through the cutout instance (centre (0, 2.2,
    -6), radius 0.5), jittered and tilted so that they cross its checker
    at many texels."""
    rng = np.random.RandomState(seed)
    g = (np.arange(n) + 0.5) / n * 1.3 - 0.65
    x, y = np.meshgrid(g, g, indexing="xy")
    o = np.stack([x, y + 2.2, np.full_like(x, -9.0)], -1)
    o[..., :2] += rng.uniform(-0.01, 0.01, o[..., :2].shape)
    d = np.stack([0.15 * rng.uniform(-1, 1, x.shape),
                  0.15 * rng.uniform(-1, 1, x.shape), np.ones_like(x)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def edge_lanes(uv, valid, size=256, eps=1e-3):
    """Lanes whose uv x size lies within eps of an integer."""
    x = uv * size
    return valid & (np.abs(x - np.round(x)) < eps).any(-1)


def test_alpha_rounds_match_reference(scenes):
    jhost, tsc = scenes
    jsc = jhost.scene
    o, d = ray_wall()
    n = o.shape[0] * o.shape[1]
    tmin, tmax = np.zeros(o.shape[:2], np.float32), np.full(
        o.shape[:2], np.inf, np.float32)
    jargs = tuple(jnp.asarray(a) for a in (o, d, tmin, tmax))
    targs = tuple(torch.from_numpy(a) for a in (o, d, tmin, tmax))
    k = tsc.center.shape[0]
    # The surfaces the alpha test reads: the first hit (round 1) and the
    # hit behind a first rejection (round 2).
    read = [interpret(jtrace.trace_scene, jsc, *jargs, n, alpha_rounds=r)
            for r in (0, 1)]
    jsurf = interpret(jtrace.trace_scene, jsc, *jargs, n, alpha_rounds=2)
    tsurf = ttrace.trace_scene(tsc, *targs, n, alpha_rounds=2)
    tidx = np.where(tsurf.valid.numpy(), tsurf.object_index.numpy(), -1)
    jidx = np.where(jsurf.valid, jsurf.object_index, -1)
    differ = tidx != jidx
    explained = np.zeros_like(differ)
    for s in read:
        explained |= edge_lanes(s.uv, s.valid & (s.object_index >= k))
    assert not (differ & ~explained).any(), int((differ & ~explained).sum())
    assert differ.mean() <= 0.01 and explained.mean() <= 0.01
    # Lanes whose first hit is the cutout instance: some pass through a
    # hole, some stop on its opaque squares.
    first = read[0].valid & (read[0].object_index == k + 2)
    assert first.mean() > 0.3
    through = first & (tidx != k + 2)
    assert through.sum() > 0.1 * first.sum()
    assert (first & (tidx == k + 2)).sum() > 0.1 * first.sum()
    moved = through & tsurf.valid.numpy()
    assert (tsurf.distance.numpy()[moved] > read[0].distance[moved]).all()


def test_trace_image_matches_reference(scenes):
    jhost, tsc = scenes
    fwd = np.subtract(POSE_TARGET, POSE_EYE)
    fwd = tuple(fwd / np.linalg.norm(fwd))
    jcam = jcamera.make_camera(POSE_EYE, fwd, horizontal_fov_deg=90.0,
                               aspect=1.0)
    tcam = convert.camera(np_tree(jcam), "cpu")
    kw = dict(width=TRACE_W, height=TRACE_W, bounces=3, samples_per_pixel=1,
              block_size=1024, texture_bounces=2)
    jout = interpret(jpathtrace.trace_image, jhost.scene, jcam,
                     jpathtrace.PathTraceConfig(**kw), 0)
    tout = tpathtrace.trace_image(tsc, tcam, tpathtrace.PathTraceConfig(**kw),
                                  0)
    valid = jout.primary_valid
    assert (tout.primary_valid.numpy() != valid).mean() <= 0.01
    rad = tout.radiance.numpy()
    assert rad.shape == (TRACE_W, TRACE_W, 3) and np.isfinite(rad).all()
    diff = np.abs(rad - jout.radiance).max(-1)
    assert (diff <= 1e-3).mean() >= 0.99, (diff <= 1e-3).mean()
    # Where both hit: the primary channels agree.
    same = valid & tout.primary_valid.numpy()
    for field in ("primary_position", "primary_normal", "primary_albedo"):
        np.testing.assert_allclose(
            getattr(tout, field).numpy()[same], getattr(jout, field)[same],
            rtol=1e-4, atol=1e-4, err_msg=field)
    assert same.sum() > 0.3 * TRACE_W * TRACE_W
