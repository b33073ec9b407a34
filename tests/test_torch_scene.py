"""Scene building, conversion, the object table, surface attributes and the
Morton accel of the port against the reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import clusters as jclusters, myscene as jmyscene
from drts_tpu.models import scene as jscene
from drts_tpu.ops import intersect as jintersect
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.models import clusters as tclusters, myscene as tmyscene
from drts_tpu_torch.models import scene as tscene
from drts_tpu_torch.models.material import Materials
from drts_tpu_torch.ops import intersect as tintersect

MATERIAL_FIELDS = [f.name for f in dataclasses.fields(Materials)]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def hosts():
    return (jmyscene.build(oscillator_grid=4),
            tmyscene.build(oscillator_grid=4, device="cpu"))


def test_build_equals_reference(hosts):
    """Same numpy RandomState stream -> identical arrays (tolerance 0)."""
    jh, th = hosts
    js, ts = jh.scene, th.scene
    for name in ("center", "rotation", "prev_center", "prev_rotation",
                 "radius"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for name in MATERIAL_FIELDS:
        np.testing.assert_array_equal(
            getattr(ts.materials, name).numpy(),
            np.asarray(getattr(js.materials, name)))
    np.testing.assert_array_equal(ts.env.color.numpy(), np.asarray(js.env.color))
    np.testing.assert_array_equal(ts.env.rotation.numpy(),
                                  np.asarray(js.env.rotation))
    np.testing.assert_array_equal(th.kinds, jh.kinds)
    for name in ("velocity", "angular_velocity", "mass", "inv_mass",
                 "is_oscillator", "attracted_to_earth"):
        np.testing.assert_array_equal(getattr(th.bodies, name).numpy(),
                                      np.asarray(getattr(jh.bodies, name)))
    assert th.bodies.earth_index == int(jh.bodies.earth_index)
    assert th.bodies.star_index == int(jh.bodies.star_index)
    assert th.camera_position == jh.camera_position


def test_convert_round_trip_and_object_table(hosts):
    """convert.scene carries every array unchanged; the packed object
    table, a concatenation and one multiply, matches bit for bit."""
    jh, th = hosts
    cs = convert.scene(to_np(jh.scene), "cpu")
    for name in ("center", "rotation", "radius"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(),
                                      getattr(th.scene, name).numpy())
    jt = np.asarray(jscene.object_table(jh.scene))
    np.testing.assert_array_equal(tscene.object_table(cs).numpy(), jt)
    np.testing.assert_array_equal(tscene.object_table(th.scene).numpy(), jt)


def test_object_table_with_mesh_instances(hosts):
    """as_mesh_scene moves every sphere into the mesh instances: the object
    table's rows [K, K+M) = [0, M) carry the instance transform and radius
    0, and equal the reference's bit for bit, through convert.scene and
    through the port's own as_mesh_scene. A mixed scene (K spheres kept, 3
    instances appended) puts the instances after the spheres."""
    jh, th = hosts
    jm_host = jmyscene.as_mesh_scene(jh, tessellation=2)
    expect = np.asarray(jscene.object_table(jm_host.scene))
    k = jh.scene.center.shape[0]
    assert expect.shape == (k, 33) and not expect[:, 3].any()
    cs = convert.scene(to_np(jm_host.scene), "cpu")
    assert cs.center.shape == (0, 3) and cs.mesh_instances.scale.shape == (k,)
    np.testing.assert_array_equal(cs.mesh_instances.scale.numpy(),
                                  np.asarray(jh.scene.radius))
    np.testing.assert_array_equal(tscene.object_table(cs).numpy(), expect)
    tm_host = tmyscene.as_mesh_scene(th, tessellation=2)
    np.testing.assert_array_equal(tscene.object_table(tm_host.scene).numpy(),
                                  expect)
    np.testing.assert_array_equal(cs.mesh.tri_tbl.numpy(),
                                  np.asarray(jm_host.scene.mesh.tri_tbl))

    mi = jscene.MeshInstances(
        center=jh.scene.center[:3] + 1.0, rotation=jh.scene.rotation[:3],
        prev_center=jh.scene.center[:3], prev_rotation=jh.scene.rotation[:3],
        scale=jnp.asarray([0.5, 1.0, 2.0]))
    mats = jax.tree.map(lambda x: jnp.concatenate([x, x[:3]]),
                        jh.scene.materials)
    mixed = dataclasses.replace(jh.scene, materials=mats,
                                mesh=jm_host.scene.mesh, mesh_instances=mi)
    expect = np.asarray(jscene.object_table(mixed))
    got = tscene.object_table(convert.scene(to_np(mixed), "cpu")).numpy()
    np.testing.assert_array_equal(got, expect)
    assert got.shape == (k + 3, 33)
    assert not got[k:, 3].any() and (got[:k, 3] > 0).all()
    np.testing.assert_array_equal(got[k:, 0:3], np.asarray(mi.center))
    np.testing.assert_array_equal(got[k:, 8:11], np.asarray(mi.prev_center))


def test_surface_attributes_match(hosts):
    """Same SphereHit in -> same refined HitSurface out. Tolerance rtol
    1e-5 / atol 1e-5: the Newton step and normalize are float32 formulas
    that XLA:CPU may contract into FMAs."""
    jh, th = hosts
    rng = np.random.RandomState(2)
    n = 2048
    o = np.asarray(rng.randn(n, 3) * [4, 1, 1] + [0, 1, -6], np.float32)
    d = np.array(jm.normalize(jnp.asarray(
        rng.randn(n, 3) * 0.3 + [0, 0, 1], jnp.float32)))
    jhit = jintersect.intersect_spheres(
        jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full(n, 1e9),
        jh.scene.center, jh.scene.radius, attributes=False)
    assert 0.2 < float(jnp.mean(jhit.hit)) < 0.95
    h = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jhit)
    thit = tintersect.SphereHit(hit=h.hit, t=h.t, index=h.index.long(),
                                position=h.position)
    js = jscene.surface_attributes(jh.scene, jhit, jnp.asarray(d))
    ts = tscene.surface_attributes(th.scene, thit, torch.from_numpy(d))
    for name in ("valid", "is_front_face", "object_index"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for name in ("position", "geometric_normal", "shading_normal",
                 "tangent", "distance"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-5, atol=1e-5)
    for name in MATERIAL_FIELDS:
        np.testing.assert_array_equal(
            getattr(ts.material, name).numpy(),
            np.asarray(getattr(js.material, name)))


def _columns(table):
    """Table columns as a set: sorted by (object id, radius)."""
    order = np.lexsort((table[3], table[4]))
    return table[:, order]


def test_morton_plan_and_accel_match(hosts):
    """build_plan_morton is identical; make_morton_accel's tables match as
    sets of columns (an argsort of near-equal chunk keys may order chunks
    differently). Rows 0-7 are copies and exact; |c|^2 - r^2 and the
    refit bounds (the reference's unsorted bounds table) carry float32
    sums (rtol 1e-6)."""
    jh, th = hosts
    centers = th.scene.center.numpy()
    radii = th.scene.radius.numpy()
    jplan = jclusters.build_plan_morton(centers, radii, max_members=8)
    tplan = tclusters.build_plan_morton(centers, radii, max_members=8,
                                        device="cpu")
    np.testing.assert_array_equal(tplan.member_object.numpy(),
                                  jplan.member_object)
    assert tplan.num_clusters == jplan.num_clusters

    origin = np.array([0.0, 1.0, -5.0], np.float32)
    for sort_origin in (None, origin):
        ja = jclusters.make_morton_accel(
            jplan, jh.scene.center, jh.scene.radius,
            sort_origin=None if sort_origin is None
            else jnp.asarray(sort_origin))
        ta = tclusters.make_morton_accel(
            tplan, th.scene.center, th.scene.radius,
            sort_origin=None if sort_origin is None
            else torch.from_numpy(sort_origin))
        assert (ta.n_chunks, ta.chunk) == (ja.n_chunks, ja.chunk)
        jt, tt = _columns(np.asarray(ja.table)), _columns(ta.table.numpy())
        np.testing.assert_array_equal(tt[:8], jt[:8])
        np.testing.assert_allclose(tt[8], jt[8], rtol=1e-6)
        if sort_origin is None:
            bounds = tclusters.refit(tplan, th.scene.center, th.scene.radius)
            tb = torch.cat([bounds.center.T, bounds.radius[None]]).numpy()
            jb = np.asarray(ja.bounds_tbl)[:, :tplan.num_clusters]
            np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-6)
        # Chunk membership is the same set of objects per chunk.
        c, mm = ta.n_chunks, ta.chunk
        jobj = np.sort(np.asarray(ja.table)[4].reshape(c, mm), axis=1)
        tobj = np.sort(ta.table[4].numpy().reshape(c, mm), axis=1)
        assert sorted(map(tuple, jobj)) == sorted(map(tuple, tobj))
