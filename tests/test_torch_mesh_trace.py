"""The instanced-mesh path-trace frame of the port against the reference at
48x48: the demo scene as instances of one geosphere
(``as_mesh_scene(build(oscillator_grid=2), tessellation=2)``) and a mixed
scene (the same spheres plus three untextured mesh instances, one of them
alpha-tested away), at 2 and 3 bounces.

The reference runs its Pallas kernels in interpret mode
(``intersect.BACKEND = "interpret"``: the bounds pre-pass, the bound scan,
the shared-BLAS sweeps and the serial backstop) under its
``trace_image_jit``, once per module. The port takes its plain versions. Held, as
tests/test_torch_pathtrace.py holds the sphere frame: ``primary_valid``
equal, the ray count equal, radiance within 1e-3 on >= 99.5% of pixels
(the remainder may take another branch on a last-bit difference: XLA:CPU
contracts multiply-adds into FMAs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import geometry as jgeometry, material as jmaterial
from drts_tpu.models import myscene as jmyscene, scene as jscene
from drts_tpu.ops import camera as jcamera, intersect as jintersect
from drts_tpu.ops import pathtrace as jpathtrace, trimesh as jtrimesh
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.ops import camera as tcamera, pathtrace as tpathtrace
from drts_tpu_torch.ops import trace as ttrace

W = H = 48
BOUNCES = (2, 3)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def mixed_scene(host):
    """The sphere scene plus three mesh instances of a tessellation-2
    geosphere: bare metal, diffuse, and one whose alpha 0.3 lies below its
    cutoff 0.5, so every hit on it is rejected and re-traced."""
    mesh = jtrimesh.make_mesh(*jgeometry.create_geosphere(1.0, 2))
    mats = [
        jmaterial.MaterialDesc(base_color=(0.9, 0.7, 0.3, 1.0), metallic=1.0,
                               roughness=0.15),
        jmaterial.MaterialDesc(base_color=(0.2, 0.8, 0.3, 1.0),
                               roughness=0.6),
        jmaterial.MaterialDesc(base_color=(0.9, 0.6, 0.2, 0.3),
                               roughness=0.4, alpha_cutoff=0.5),
    ]
    centers = jnp.asarray([[2.5, 1.2, -5.0], [-2.5, 1.2, -5.0],
                           [0.0, 2.2, -6.0]], jnp.float32)
    rot = np.random.RandomState(1).randn(3, 4)
    rot = jnp.asarray(rot / np.linalg.norm(rot, axis=1, keepdims=True),
                      jnp.float32)
    mi = jscene.MeshInstances(
        center=centers, rotation=rot, prev_center=centers, prev_rotation=rot,
        scale=jnp.asarray([0.8, 0.8, 1.0], jnp.float32))
    materials = jmyscene._concat_materials(host.scene.materials,
                                           jmaterial.pack_materials(mats))
    return dataclasses.replace(host.scene, materials=materials, mesh=mesh,
                               mesh_instances=mi, alpha_test_rounds=1)


@pytest.fixture(scope="module")
def frames():
    """(scene name, bounces) -> (reference TraceOutput as numpy, port
    TraceOutput)."""
    host = jmyscene.build(oscillator_grid=2)
    scenes = {"mesh": jmyscene.as_mesh_scene(host, tessellation=2).scene,
              "mixed": mixed_scene(host)}
    jcam = jcamera.make_camera(host.camera_position, host.camera_forward,
                               horizontal_fov_deg=90.0, aspect=1.0)
    tcam = convert.camera(to_np(jcam), "cpu")
    out = {}
    for name, jsc in scenes.items():
        tsc = convert.scene(to_np(jsc), "cpu")
        for bounces in BOUNCES:
            kw = dict(width=W, height=H, bounces=bounces,
                      samples_per_pixel=1, block_size=2304)
            old = jintersect.BACKEND
            jintersect.BACKEND = "interpret"
            try:
                jout = to_np(jpathtrace.trace_image_jit(
                    jsc, jcam, jpathtrace.PathTraceConfig(**kw), 0))
            finally:
                jintersect.BACKEND = old
            tout = tpathtrace.trace_image(
                tsc, tcam, tpathtrace.PathTraceConfig(**kw), 0)
            out[name, bounces] = (jout, tout)
    return out


@pytest.mark.parametrize("bounces", BOUNCES)
@pytest.mark.parametrize("name", ["mesh", "mixed"])
def test_trace_image_matches_reference(frames, name, bounces):
    jout, tout = frames[name, bounces]
    valid = jout.primary_valid
    np.testing.assert_array_equal(tout.primary_valid.numpy(), valid)
    assert 0.2 < valid.mean() < 0.95
    assert float(tout.rays_traced) == float(jout.rays_traced) > W * H
    rad = tout.radiance.numpy()
    assert rad.shape == (H, W, 3) and np.isfinite(rad).all()
    diff = np.abs(rad - jout.radiance).max(-1)
    assert (diff <= 1e-3).mean() >= 0.995, (diff <= 1e-3).mean()
    for field in ("primary_position", "primary_normal", "primary_albedo"):
        np.testing.assert_allclose(
            getattr(tout, field).numpy()[valid], getattr(jout, field)[valid],
            rtol=1e-4, atol=1e-4, err_msg=field)


def test_mixed_scene_hits_both_geometries_and_drops_the_cutout():
    """Primary hits land on spheres and on mesh instances; after two
    alpha-test rounds (its front face, then its back face) none lands on
    the alpha-tested instance (object index K + 2)."""
    host = jmyscene.build(oscillator_grid=2)
    jsc = mixed_scene(host)
    tsc = convert.scene(to_np(jsc), "cpu")
    cam = tcamera.make_camera(host.camera_position, host.camera_forward,
                              horizontal_fov_deg=90.0, aspect=1.0,
                              device="cpu")
    ndc = tcamera.pixel_ndc(W, H, cam.jitter)
    o, d, tmin, tmax = tcamera.generate_pinhole_rays(cam, ndc)
    k = tsc.center.shape[0]
    opaque = ttrace.trace_scene(tsc, o, d, tmin, tmax, 2304)
    tested = ttrace.trace_scene(tsc, o, d, tmin, tmax, 2304, alpha_rounds=2)
    idx = opaque.object_index[opaque.valid]
    assert bool((idx < k).any()) and bool((idx == k).any())
    assert bool((idx == k + 2).any())
    assert not bool((tested.object_index[tested.valid] == k + 2).any())
    # Rejected lanes moved on to what lies behind, or to the sky.
    moved = opaque.valid & (opaque.object_index == k + 2)
    assert bool((tested.distance[moved & tested.valid]
                 > opaque.distance[moved & tested.valid]).all())


def test_port_as_mesh_scene_equals_reference():
    """The port's own as_mesh_scene (its numpy geosphere, its make_mesh)
    builds the reference's scene: instances exact, the mesh as the
    reference's after the Morton sort."""
    jhost = jmyscene.as_mesh_scene(jmyscene.build(oscillator_grid=2), 2)
    thost = tmyscene.as_mesh_scene(
        tmyscene.build(oscillator_grid=2, device="cpu"), tessellation=2)
    ts, js = thost.scene, jhost.scene
    assert ts.center.shape == (0, 3) and ts.radius.shape == (0,)
    for name in ("center", "rotation", "prev_center", "prev_rotation",
                 "scale"):
        np.testing.assert_array_equal(
            getattr(ts.mesh_instances, name).numpy(),
            np.asarray(getattr(js.mesh_instances, name)))
    assert ts.mesh.tri_tbl.shape == (64, 9)
    assert ts.mesh.inscribed_radius == js.mesh.inscribed_radius
    # Same faces as sets of (v0, e1, e2) rows.
    def rows(tbl):
        return sorted(map(tuple, np.round(np.asarray(tbl) * 1e5).astype(int)))
    assert rows(ts.mesh.tri_tbl.numpy()) == rows(js.mesh.tri_tbl)
    moved = tmyscene.sync_mesh_pose(ts, ts.mesh_instances.center + 1.0,
                                    ts.mesh_instances.rotation)
    assert torch.equal(moved.mesh_instances.prev_center,
                       ts.mesh_instances.center)
    assert torch.equal(moved.mesh_instances.center,
                       ts.mesh_instances.center + 1.0)
