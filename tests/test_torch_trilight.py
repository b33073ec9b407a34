"""The port's triangle lights against the reference's, on the CPU.

Scenes: a mixed one (a floor sphere, an emissive sphere and an emissive
quad of two triangles, as tests/test_light_restir.py), the all-mesh demo
scene at oscillator grid 2 / tessellation 2 (32 triangle lights, none
dropped) and at grid 3 / tessellation 3, where 9 emissive instances bring
1,152 equal-area faces against the cap of 128: the cut falls inside a run
of equal powers, so the order of ties decides which faces are lights.

Tolerances: compact ids, `tri_light_id`, the kind column and the counters'
counts equal exactly; the rows' floats to rtol 1e-6 / atol 1e-7 (the
reference's XLA:CPU contracts multiply-adds; measured 0 on these scenes).
Triangle sampling (direction, distance, pdf) and its inversion: rtol 1e-4
/ atol 1e-5 away from grazing angles (the pdf divides by cos). The dense
sweep ``intersect_mesh``: the same hit bit on > 99.9% of rays, the same
face on > 99% of common hits, t to rtol 1e-4 / atol 1e-5, u and v to 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, scene as jscene
from drts_tpu.models.material import MaterialDesc, pack_materials
from drts_tpu.ops import light as jlight, restir as jrestir, sky as jsky
from drts_tpu.ops import trimesh as jtrimesh
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.ops import light as tlight, restir as trestir
from drts_tpu_torch.ops import trimesh as ttrimesh
from drts_tpu_torch.utils import math as tm

T = torch.from_numpy


def emissive_mesh_scene():
    """tests/test_light_restir.py's mixed-kind scene: a diffuse floor
    sphere, an emissive sphere and an emissive quad mesh instance."""
    pos = np.array([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5],
                    [0.5, 0.0, 0.5], [-0.5, 0.0, 0.5]], np.float32)
    nrm = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tan = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    mesh = jtrimesh.make_mesh(pos, nrm, uv, faces, tangents=tan)
    mats = pack_materials([
        MaterialDesc(base_color=(0.8, 0.8, 0.8, 1), roughness=0.6),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=5.0,
                     emissive_color=(1.0, 0.2, 0.2)),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=15.0,
                     emissive_color=(0.9, 0.9, 0.7)),
    ])
    center = jnp.array([[0.0, -100.0, 0.0], [-2.0, 2.0, 0.0]])
    rot = jnp.tile(jm.QUAT_IDENTITY, (2, 1))
    mi = jscene.MeshInstances(
        center=jnp.array([[1.5, 2.5, 0.0]]),
        rotation=jnp.tile(jm.QUAT_IDENTITY, (1, 1)),
        prev_center=jnp.array([[1.5, 2.5, 0.0]]),
        prev_rotation=jnp.tile(jm.QUAT_IDENTITY, (1, 1)),
        scale=jnp.array([1.2]))
    return jscene.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3]), materials=mats,
        env=jsky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)),
        mesh=mesh, mesh_instances=mi)


def build_scene(kind):
    if kind == "mixed":
        return emissive_mesh_scene()
    grid, tess = {"allmesh": (2, 2), "ties": (3, 3)}[kind]
    return jmyscene.as_mesh_scene(jmyscene.build(oscillator_grid=grid),
                                  tessellation=tess).scene


@pytest.fixture(scope="module", params=["mixed", "allmesh", "ties"])
def lights(request):
    scene = build_scene(request.param)
    jl = jlight.prepare(scene)
    tl = tlight.prepare(convert.scene(jax.tree.map(np.asarray, scene),
                                      "cpu"))
    return request.param, scene, jl, tl


def test_prepare_matches(lights):
    kind, scene, jl, tl = lights
    jc, tc = np.asarray(jl.compact), tl.compact.numpy()
    assert tl.has_triangles and jl.has_triangles
    assert tc.shape == jc.shape == (128, 16)
    # Object ids, kinds and the (instance, face) -> light id map: exact.
    np.testing.assert_array_equal(tc[:, 8], jc[:, 8])
    np.testing.assert_array_equal(tc[:, 15], jc[:, 15])
    assert tl.tri_light_id.dtype == torch.int64
    np.testing.assert_array_equal(tl.tri_light_id.numpy(),
                                  np.asarray(jl.tri_light_id))
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tl.cdf.numpy(), np.asarray(jl.cdf), rtol=1e-6)
    np.testing.assert_allclose(tl.table.numpy(), np.asarray(jl.table),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tl.total_power), float(jl.total_power),
                               rtol=1e-6)
    assert float(tl.dropped_lights) == float(jl.dropped_lights)
    np.testing.assert_allclose(float(tl.dropped_power_frac),
                               float(jl.dropped_power_frac), atol=1e-6)
    # Each light id names the row that names its triangle's instance.
    ids = tl.tri_light_id.numpy()
    f = scene.mesh.v0.shape[0]
    k = scene.center.shape[0]
    rows = np.nonzero(ids >= 0)[0]
    np.testing.assert_array_equal(tc[ids[rows], 8], k + rows // f)
    assert (tc[ids[rows], 15] == 1).all() and (tc[ids[rows], 3] == 0).all()
    n_tri = int((tc[:, 15] == 1).sum())
    assert len(rows) == n_tri == {"mixed": 2, "allmesh": 32, "ties": 128}[kind]
    if kind == "mixed":
        # One sphere light too, with its object id in the object table.
        assert int(((tc[:, 15] == 0) & (tc[:, 7] > 0)).sum()) == 1
        assert (tl.table.numpy()[:, 8] >= 0).sum() == 1
    if kind == "ties":
        # The cap cuts a run of equal powers: the lowest indices stay.
        assert float(tl.dropped_lights) == 9 * 128 - 128
        assert tc[127, 7] == tc[120, 7]
        kept = np.sort(rows)
        assert (np.diff(kept) > 0).all()


def test_tie_order_is_lowest_index_first():
    """Six equal triangle lights and a cap that keeps them all: compact id
    i is candidate i, in both packages."""
    scene = emissive_mesh_scene()
    mi = scene.mesh_instances
    three = jscene.MeshInstances(
        center=jnp.array([[1.5, 2.5, 0.0], [3.5, 2.5, 0.0], [5.5, 2.5, 0.0]]),
        rotation=jnp.tile(jm.QUAT_IDENTITY, (3, 1)),
        prev_center=jnp.zeros((3, 3)),
        prev_rotation=jnp.tile(jm.QUAT_IDENTITY, (3, 1)),
        scale=jnp.array([1.0, 1.0, 1.0]))
    mats = jax.tree.map(lambda x: jnp.concatenate([x[:1], x[2:3], x[2:3],
                                                   x[2:3]]), scene.materials)
    scene = scene.replace(center=scene.center[:1], rotation=scene.rotation[:1],
                          prev_center=scene.prev_center[:1],
                          prev_rotation=scene.prev_rotation[:1],
                          radius=scene.radius[:1], materials=mats,
                          mesh_instances=three)
    assert mi.center.shape[0] == 1
    jl = jlight.prepare(scene)
    tl = tlight.prepare(convert.scene(jax.tree.map(np.asarray, scene),
                                      "cpu"))
    expect = np.arange(6)
    np.testing.assert_array_equal(np.asarray(jl.tri_light_id), expect)
    np.testing.assert_array_equal(tl.tri_light_id.numpy(), expect)
    assert len(np.unique(tl.compact.numpy()[:6, 7])) == 1


def test_triangle_sampling_and_inversion_match(lights):
    """fetch_rows with the triangle columns, sample_light_rows with both
    kinds, triangle_uv_from_direction and restir._uv_from_direction."""
    _, _, jl, tl = lights
    rng = np.random.RandomState(11)
    valid = np.nonzero(np.asarray(jl.compact)[:, 7] > 0)[0]
    idx = rng.choice(valid, (48, 40))
    jr = jlight.fetch_rows(jl, jnp.asarray(idx))
    tr = tlight.fetch_rows(tl, T(idx))
    for name in ("center", "radius", "emission", "power", "aux", "e1", "e2",
                 "kind"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    kind = np.asarray(jr.kind)
    assert kind.any()
    pos = (np.asarray(jr.center) + rng.randn(48, 40, 3) * 2).astype(np.float32)
    rand2 = rng.rand(48, 40, 2).astype(np.float32)
    jout = jlight.sample_light_rows(jr, jnp.asarray(pos), jnp.asarray(rand2))
    tout = tlight.sample_light_rows(tr, T(pos), T(rand2))
    # Triangle lanes away from grazing angles (pdf = d^2 / (area cos)).
    n_unit = np.cross(np.asarray(jr.e1), np.asarray(jr.e2))
    n_unit /= np.maximum(np.linalg.norm(n_unit, axis=-1, keepdims=True), 1e-12)
    cos = np.abs((np.asarray(jout[0]) * n_unit).sum(-1))
    sel = kind & (cos > 0.05)
    assert sel.mean() > 0.3
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy()[sel], np.asarray(b)[sel],
                                   rtol=1e-4, atol=1e-5)
    # The sample lies on the triangle: the inversion recovers the uniforms.
    for fn_j, fn_t in ((jlight.triangle_uv_from_direction,
                        tlight.triangle_uv_from_direction),
                       (jrestir._uv_from_direction,
                        trestir._uv_from_direction)):
        juv, jin = fn_j(jr, jnp.asarray(pos), jout[0])
        tuv, tin = fn_t(tr, T(pos), tout[0])
        both = sel & np.asarray(jin) & tin.numpy()
        assert both[sel].mean() > 0.9
        np.testing.assert_allclose(tuv.numpy()[both], np.asarray(juv)[both],
                                   atol=2e-3)
        assert np.quantile(np.abs(tuv.numpy()[both] - rand2[both]), 0.99) \
            < 1e-2
    # A direction that misses the triangle's plane side is outside.
    _, tin = tlight.triangle_uv_from_direction(tr, T(pos), -tout[0])
    assert not tin.numpy()[sel].any()


def test_sample_triangle_matches():
    rng = np.random.RandomState(3)
    u = rng.rand(1000, 2).astype(np.float32)
    got = tm.sample_triangle(T(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.sample_triangle(
        jnp.asarray(u))), rtol=1e-6, atol=1e-7)
    assert (got >= 0).all() and (got.sum(-1) <= 1 + 1e-6).all()
    np.testing.assert_allclose(
        tm.to_solid_angle_pdf(T(u[:, 0]), T(u[:, 1]) + 1, T(u[:, 0])).numpy(),
        np.asarray(jm.to_solid_angle_pdf(jnp.asarray(u[:, 0]),
                                         jnp.asarray(u[:, 1]) + 1,
                                         jnp.asarray(u[:, 0]))), rtol=1e-6)


def check_dense(got, expect, n_faces):
    t_g, f_g, u_g, v_g = (x.numpy() for x in got)
    t_e, f_e, u_e, v_e = (np.asarray(x) for x in expect)
    hit_g, hit_e = np.isfinite(t_g), np.isfinite(t_e)
    assert (hit_g == hit_e).mean() > 0.999
    both = hit_g & hit_e
    assert both.mean() > 0.05
    np.testing.assert_allclose(t_g[both], t_e[both], rtol=1e-4, atol=1e-5)
    same = both & (f_g == f_e)
    assert same[both].mean() > 0.99
    np.testing.assert_allclose(u_g[same], u_e[same], atol=2e-4)
    np.testing.assert_allclose(v_g[same], v_e[same], atol=2e-4)
    assert f_g.max() < n_faces and f_g.min() >= 0
    assert (f_g[~hit_g] == 0).all()


@pytest.mark.parametrize("n_faces,lead", [(128, (40, 50)), (300, (1500,)),
                                          (2, (7, 3))])
def test_intersect_mesh_matches(n_faces, lead, monkeypatch):
    """The dense sweep over 128 triangles (the light table's size), over
    300 (beyond the reference's face block of 256) and over 2, on (H, W)
    and flat rays, with dead lanes and a degenerate face; the port's ray
    blocks cut to 512 elements a plane, so several blocks run."""
    import types
    rng = np.random.RandomState(n_faces)
    v0 = (rng.randn(n_faces, 3) * 3).astype(np.float32)
    e1 = rng.randn(n_faces, 3).astype(np.float32)
    e2 = rng.randn(n_faces, 3).astype(np.float32)
    e2[0] = 0.0                                   # zero area: never hit
    n = int(np.prod(lead))
    o = (rng.randn(n, 3) * 6).astype(np.float32)
    # Aimed into a face's interior, so that enough rays hit.
    j = rng.randint(0, n_faces, n)
    aim = v0[j] + 0.3 * (e1[j] + e2[j]) + 0.2 * rng.randn(n, 3) - o
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.rand(n) < 0.2, -1.0,
                    np.where(rng.rand(n) < 0.3, 5.0, np.inf)
                    ).astype(np.float32)
    expect = jtrimesh.intersect_mesh(
        jnp.asarray(o).reshape(lead + (3,)),
        jnp.asarray(d).reshape(lead + (3,)), jnp.zeros(lead),
        jnp.asarray(tmax).reshape(lead),
        types.SimpleNamespace(v0=jnp.asarray(v0), e1=jnp.asarray(e1),
                              e2=jnp.asarray(e2)))
    monkeypatch.setattr(ttrimesh, "_DENSE_PLANE", 512)
    got = ttrimesh.intersect_mesh(
        T(o).reshape(lead + (3,)), T(d).reshape(lead + (3,)), 0.0,
        T(tmax).reshape(lead),
        types.SimpleNamespace(v0=T(v0), e1=T(e1), e2=T(e2)))
    assert got[0].shape == lead and got[1].dtype == torch.int64
    check_dense(got, expect, n_faces)
    assert not np.isfinite(got[0].numpy().reshape(n)[tmax < 0]).any()


def test_intersect_tri_lights_matches(lights):
    """Rays from around the scene toward the light triangles: the same
    closest triangle light, t and barycentrics; sphere rows never hit."""
    _, _, jl, tl = lights
    rng = np.random.RandomState(5)
    comp = np.asarray(jl.compact)
    tri = np.nonzero(comp[:, 15] > 0.5)[0]
    lead = (32, 24)
    n = lead[0] * lead[1]
    pick = rng.choice(tri, n)
    o = (comp[pick, 0:3] + rng.randn(n, 3) * 3).astype(np.float32)
    aim = comp[pick, 0:3] + 0.1 * rng.randn(n, 3) * np.linalg.norm(
        comp[pick, 9:12], axis=1, keepdims=True) - o
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    live = rng.rand(n) < 0.9
    o, d, live = o.reshape(lead + (3,)), d.reshape(lead + (3,)), \
        live.reshape(lead)
    expect = jrestir._intersect_tri_lights(jl, jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(live))
    got = trestir._intersect_tri_lights(tl, T(o), T(d), T(live))
    check_dense(got, expect, 128)
    hit = np.isfinite(got[0].numpy())
    assert not hit[~live].any()
    assert (comp[got[1].numpy()[hit], 15] == 1).all()
