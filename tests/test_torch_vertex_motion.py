"""Deforming meshes in the port against the reference: the case of
tests/test_trimesh.py's test_per_vertex_motion_vectors (oscillator grid
2 as an all-mesh scene, tessellation 2) at 32x32. Every vertex carries one
object-space previous-minus-current displacement; the G-buffer's motion
must be the projected displacement, and without vertex motion the static
scene's motion is zero.

The reference runs on its XLA path. ``convert.scene`` carries
``TriMesh.vertex_motion``. Tolerances: the hit mask equal on >= 99% of
pixels; where both hit, the hit's ``prev_offset`` within 1e-6 absolute
of the reference's, motion within 2e-3 px of the reference's and of the
analytic expectation (the reference's own bar is 2e-2 px against the
expectation), and zero motion within 1e-2 px for the rigid mesh (the
reference's bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene
from drts_tpu.ops import camera as jcamera, gbuffer as jgbuffer
from drts_tpu_torch import convert
from drts_tpu_torch.ops import camera as tcamera, gbuffer as tgbuffer
from drts_tpu_torch.utils import math as tm

W = H = 32
D_OBJ = np.array([0.12, -0.07, 0.05], np.float32)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def gbuffers():
    base = jmyscene.as_mesh_scene(jmyscene.build(oscillator_grid=2),
                                  tessellation=2)
    mesh = base.scene.mesh
    vm = np.tile(D_OBJ, (np.asarray(mesh.positions).shape[0], 1))
    scene_vm = dataclasses.replace(
        base.scene, mesh=dataclasses.replace(mesh,
                                             vertex_motion=jnp.asarray(vm)))
    jcam = jcamera.make_camera(base.camera_position, base.camera_forward,
                               horizontal_fov_deg=90.0, aspect=1.0)
    gen = jax.jit(lambda sc: jgbuffer.generate(sc, jcam, W, H, 4096))
    out = {"jax": np_tree(gen(scene_vm))}
    tcam = tcamera.make_camera(base.camera_position, base.camera_forward,
                               horizontal_fov_deg=90.0, aspect=1.0,
                               device="cpu")
    for key, sc in (("port_rigid", base.scene), ("port", scene_vm)):
        tscene = convert.scene(np_tree(sc), "cpu")
        out[key] = tgbuffer.generate(tscene, tcam, W, H, 4096)
        out[key + "_scene"] = tscene
    out["cam"] = tcam
    out["k"] = base.scene.center.shape[0]
    return out


def test_convert_carries_vertex_motion(gbuffers):
    vm = gbuffers["port_scene"].mesh.vertex_motion
    assert vm is not None and vm.shape[1] == 3
    np.testing.assert_array_equal(vm.numpy(), np.broadcast_to(D_OBJ,
                                                              vm.shape))
    assert gbuffers["port_rigid_scene"].mesh.vertex_motion is None


def test_rigid_mesh_has_no_motion(gbuffers):
    g = gbuffers["port_rigid"]
    valid = g.surf.valid.numpy()
    assert valid.mean() > 0.2
    assert g.surf.prev_offset is None
    np.testing.assert_allclose(g.motion.numpy()[valid], 0.0, atol=1e-2)


def test_vertex_motion_vectors(gbuffers):
    jg, tg = gbuffers["jax"], gbuffers["port"]
    valid_j, valid_t = jg.surf.valid, tg.surf.valid.numpy()
    assert (valid_j == valid_t).mean() >= 0.99
    both = valid_j & valid_t
    np.testing.assert_allclose(tg.surf.prev_offset.numpy()[both],
                               jg.surf.prev_offset[both], atol=1e-6)
    got = tg.motion.numpy()
    np.testing.assert_allclose(got[both], jg.motion[both], atol=2e-3)

    # The analytic expectation: hit + R (d * scale), projected.
    scene, cam = gbuffers["port_scene"], gbuffers["cam"]
    mi = scene.mesh_instances
    inst = tg.surf.object_index - gbuffers["k"]
    inst = torch.clamp(inst, 0, mi.scale.shape[0] - 1)
    prev_world = tg.surf.position + tm.quat_rotate(
        mi.rotation[inst], torch.from_numpy(D_OBJ).expand_as(
            tg.surf.position) * mi.scale[inst][..., None])
    prev_ndc, _ = tcamera.project_to_ndc(cam, prev_world, previous=True)
    cur_ndc, _ = tcamera.project_to_ndc(cam, tg.surf.position,
                                        previous=False)
    exp = (tcamera.ndc_to_pixel(prev_ndc, W, H)
           - tcamera.ndc_to_pixel(cur_ndc, W, H)).numpy()
    np.testing.assert_allclose(got[valid_t], exp[valid_t], atol=2e-3)
    assert np.abs(got[valid_t]).max() > 0.05
