"""The port's lat-long environment map and textured emitters against the
reference: the EXR reader and writer, ``make_environment_light(texture=)``
with its quarter-size mip, ``environment_color`` with and without
``wide``, ``myscene.build(env_map_path=)``, the per-face filtered emission
``light._face_emissive_avg`` and ``light.prepare`` on mesh instances with
an emissive map (3-word texture sets).

Tolerances: EXR pixels equal; the mip within 1e-6 absolute, and the
environment lookups too where both packages find the same lat-long uv
(elsewhere within the blend's slope over their uv difference: acos
differs by up to 3 ulp between XLA and PyTorch); the per-face emission
and the prepared light tables within 1e-6 relative (the reference's
XLA:CPU contracts multiply-adds into FMAs and sums its mask product in
another order).
"""

import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import geometry as jgeometry, material as jmaterial
from drts_tpu.models import myscene as jmyscene, scene as jscene
from drts_tpu.models import texpack as jtexpack
from drts_tpu.ops import light as jlight, sky as jsky, trimesh as jtrimesh
from drts_tpu.utils import image as jimage
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.ops import light as tlight, sky as tsky
from drts_tpu_torch.utils import image as timage
from drts_tpu_torch.utils import math as tm


def rand_img(h, w, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32) * 9.0


def zip_exr(path, img):
    """The reference's test_exr_zip_block recipe: the reference writer's
    header with compression ZIP and all rows in one block (halves
    interleaved, delta-coded, deflated)."""
    h, w = img.shape[:2]
    jimage.write_exr(path, img)
    raw = open(path, "rb").read()
    tag = b"compression\0compression\0"
    pos = raw.index(tag) + len(tag) + 4
    out = bytearray(raw[:pos]) + b"\x03" + raw[pos + 1:]
    hdr_end = len(raw) - (8 * h + sum(8 + w * 4 * 3 for _ in range(h)))
    body_rows = b"".join(img[y, :, c].astype("<f4").tobytes()
                         for y in range(h) for c in (2, 1, 0))
    t = np.frombuffer(body_rows, np.uint8)
    half = (t.size + 1) // 2
    inter = np.empty(t.size, np.uint8)
    inter[:half] = t[0::2]
    inter[half:] = t[1::2]
    d = inter.astype(np.int64)
    enc = np.empty_like(d)
    enc[0] = d[0]
    enc[1:] = (d[1:] - d[:-1] + 128) & 0xFF
    comp = zlib.compress(enc.astype(np.uint8).tobytes())
    body = (struct.pack("<Q", hdr_end + 8)
            + struct.pack("<ii", 0, len(comp)) + comp)
    open(path, "wb").write(bytes(out[:hdr_end]) + body)


@pytest.mark.parametrize("compression", ["none", "zip"])
def test_read_exr_of_reference_files(tmp_path, compression):
    img = rand_img(5, 7, seed=3)
    path = str(tmp_path / "ref.exr")
    if compression == "zip":
        zip_exr(path, img)
    else:
        jimage.write_exr(path, img)
    got = timage.read_exr(path)
    np.testing.assert_array_equal(got, jimage.read_exr(path))
    np.testing.assert_array_equal(got, img)


def test_write_exr_round_trips(tmp_path):
    img = rand_img(7, 13)
    tpath, jpath = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    timage.write_exr(tpath, img)
    jimage.write_exr(jpath, img)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    np.testing.assert_array_equal(timage.read_exr(tpath), img)


def env_pair(texture, rotation_deg=30.0):
    jrot = jm.quat_from_axis_angle((0.0, 1.0, 0.0), np.radians(rotation_deg))
    jenv = jsky.make_environment_light(rotation=jrot,
                                       texture=jnp.asarray(texture))
    tenv = tsky.make_environment_light(rotation=np.array(jrot),
                                       texture=texture, device="cpu")
    return jenv, tenv


def test_environment_light_mip_matches_reference():
    tex = rand_img(16, 32, seed=1)
    jenv, tenv = env_pair(tex)
    assert tuple(tenv.texture_low.shape) == (4, 8, 3)
    np.testing.assert_allclose(tenv.texture_low.numpy(),
                               np.asarray(jenv.texture_low), rtol=0,
                               atol=1e-6)
    # A map whose sides are no multiple of 4 has no mip, in both.
    jodd, todd = env_pair(rand_img(6, 10))
    assert jodd.texture_low is None and todd.texture_low is None


@pytest.mark.parametrize("wide", [False, True])
def test_environment_color_matches_reference(wide):
    """Within 1e-6 where both packages find the same lat-long uv. acos
    differs by up to 3 ulp between XLA and PyTorch (so v on ~15% of
    lanes); there the lookup is held to the bilinear blend's slope: the
    uv difference in texels times twice the map's largest value."""
    tex = rand_img(16, 32, seed=2)
    jenv, tenv = env_pair(tex)
    rng = np.random.RandomState(5)
    d = rng.randn(999, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # The poles and the seam of the map.
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [1e-7, 0.0, -1.0]]
    want = np.asarray(jsky.environment_color(jenv, jnp.asarray(d),
                                             wide=wide))
    got = tsky.environment_color(tenv, torch.from_numpy(d),
                                 wide=wide).numpy()
    juv = np.asarray(jm.to_latlong(jm.normalize(jm.quat_rotate(
        jenv.rotation, jnp.asarray(d)))))
    tuv = tm.to_latlong(tm.normalize(tm.quat_rotate(
        tenv.rotation, torch.from_numpy(d)))).numpy()
    # u agrees; v (acos) by at most 3 ulp.
    assert (np.abs(juv - tuv) <= 3 * np.spacing(np.abs(juv))).all()
    same = (juv == tuv).all(-1)
    assert same.mean() > 0.5
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-6)
    h, w = (tenv.texture_low if wide else tenv.texture).shape[:2]
    slope = (np.abs(juv - tuv) * [w, h]).sum(-1) * 2.0 * tex.max()
    off = np.abs(got - want).max(-1)
    assert (off <= 1e-6 + slope).all(), (off - slope).max()


def test_build_wires_the_environment_map(tmp_path):
    """myscene.build(env_map_path=) feeds the lat-long map, and its mip,
    into the sky lookup (tests/test_parity_extras.py's recipe), as the
    reference's build does."""
    img = np.zeros((8, 16, 3), np.float32)
    img[:4] = (0.0, 0.0, 5.0)
    img[4:] = (5.0, 0.0, 0.0)
    path = str(tmp_path / "env.exr")
    timage.write_exr(path, img)
    host = tmyscene.build(oscillator_grid=1, env_map_path=path,
                          device="cpu")
    env = host.scene.env
    assert env.texture is not None and tuple(env.texture_low.shape) == (
        2, 4, 3)
    up = tsky.environment_color(env, torch.tensor([[0.0, 1.0, 0.0]]))
    down = tsky.environment_color(env, torch.tensor([[0.0, -1.0, 0.0]]))
    assert float(up[0, 2]) > 1.0 and float(up[0, 0]) < 1e-3
    assert float(down[0, 0]) > 1.0 and float(down[0, 2]) < 1e-3
    up_w = tsky.environment_color(env, torch.tensor([[0.0, 1.0, 0.0]]),
                                  wide=True)
    np.testing.assert_allclose(up_w.numpy(), up.numpy(), atol=1e-5)
    jenv = jmyscene.build(oscillator_grid=1, env_map_path=path).scene.env
    cenv = convert.environment(jax.tree.map(np.asarray, jenv), "cpu")
    for f in ("color", "rotation", "texture", "texture_low"):
        np.testing.assert_array_equal(getattr(env, f).numpy(),
                                      getattr(cenv, f).numpy(), f)


def emissive_mesh_scene():
    """Two spheres and three instances of a tessellation-2 geosphere; the
    first instance maps an emissive texture (and a base colour map, so it
    has a set of its own), the second is a constant emitter, the third a
    dark diffuse; one sphere maps the same emissive texture (its radiance
    takes the map's mean)."""
    rng = np.random.RandomState(11)
    atlas = rng.random_sample((2, 64, 64, 4)).astype(np.float32)
    md = jmaterial.MaterialDesc
    mats = jmaterial.pack_materials([
        md(base_color=(1, 1, 1, 1), emissive_strength=4.0,
           emissive_color=(1.0, 0.7, 0.4), emissive_color_map=0),
        md(base_color=(0.5, 0.5, 0.5, 1)),
        md(base_color=(1, 1, 1, 1), emissive_strength=6.0,
           emissive_color=(0.9, 0.9, 1.0), emissive_color_map=0,
           base_color_map=1),
        md(base_color=(1, 1, 1, 1), emissive_strength=2.0,
           emissive_color=(1.0, 0.2, 0.2)),
        md(base_color=(0.2, 0.2, 0.2, 1)),
    ])
    packed, mats = jtexpack.build(atlas, mats, size=32)
    mesh = jtrimesh.make_mesh(*jgeometry.create_geosphere(1.0, 2))
    centers = jnp.asarray([[2.0, 1.0, 0.0], [-2.0, 1.0, 0.0],
                           [0.0, 3.0, 1.0]], jnp.float32)
    rot = rng.randn(3, 4)
    rot = jnp.asarray(rot / np.linalg.norm(rot, axis=1, keepdims=True),
                      jnp.float32)
    mi = jscene.MeshInstances(center=centers, rotation=rot,
                              prev_center=centers, prev_rotation=rot,
                              scale=jnp.asarray([0.8, 1.2, 1.0],
                                                jnp.float32))
    c = jnp.asarray([[0.0, 0.5, 0.0], [1.0, 0.5, 2.0]], jnp.float32)
    q = jnp.tile(jnp.asarray(jm.QUAT_IDENTITY, jnp.float32), (2, 1))
    return jscene.SphereScene(
        center=c, rotation=q, prev_center=c, prev_rotation=q,
        radius=jnp.asarray([0.5, 0.3], jnp.float32), materials=mats,
        env=jsky.make_environment_light(), textures=packed, mesh=mesh,
        mesh_instances=mi)


def test_face_emissive_avg_matches_reference():
    jsc = emissive_mesh_scene()
    tsc = convert.scene(jax.tree.map(np.asarray, jsc), "cpu")
    assert tsc.textures.n_words == 3
    want = np.asarray(jlight._face_emissive_avg(
        jsc.textures.emissive_small, jsc.mesh.uvs, jsc.mesh.faces))
    got = tlight._face_emissive_avg(tsc.textures.emissive_small,
                                    tsc.mesh.uvs, tsc.mesh.faces).numpy()
    assert got.shape == want.shape == (2, jsc.mesh.faces.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.std() > 0.0


def test_prepare_with_textured_emitters_matches_reference():
    jsc = emissive_mesh_scene()
    tsc = convert.scene(jax.tree.map(np.asarray, jsc), "cpu")
    jl = jax.tree.map(np.asarray, jlight.prepare(jsc))
    tl = tlight.prepare(tsc)
    assert tl.has_triangles and jl.has_triangles
    for f in ("emission", "power", "table", "compact", "cdf"):
        np.testing.assert_allclose(getattr(tl, f).numpy(), getattr(jl, f),
                                   rtol=1e-6, atol=1e-30, err_msg=f)
    np.testing.assert_allclose(float(tl.total_power), float(jl.total_power),
                               rtol=1e-6)
    np.testing.assert_array_equal(tl.tri_light_id.numpy(),
                                  jl.tri_light_id)
    # The mapped sphere's radiance is its material's times the map mean.
    raw = 4.0 * np.array([1.0, 0.7, 0.4], np.float32)
    np.testing.assert_allclose(
        tl.emission[0].numpy(), raw * tsc.textures.emissive_mean[0].numpy(),
        rtol=1e-6)
    # Faces of the mapped instance differ from one another.
    faces = tsc.mesh.faces.shape[0]
    rows = tl.compact.numpy()
    mapped = rows[(rows[:, 15] > 0.5) & (rows[:, 8] == 2)]
    assert len(mapped) > 1 and mapped[:, 4:7].std(0).max() > 0
    assert faces == jsc.mesh.faces.shape[0]


def test_prepare_of_the_textured_mesh_scene():
    """add_mesh_content's scene: no emissive map (2-word sets), so the
    emitters are the sphere lights and zero-power faces; both packages
    give the same tables."""
    jhost = jmyscene.add_mesh_content(jmyscene.build(oscillator_grid=2),
                                      tessellation=2)
    tsc = convert.scene(jax.tree.map(np.asarray, jhost.scene), "cpu")
    jl = jax.tree.map(np.asarray, jlight.prepare(jhost.scene))
    tl = tlight.prepare(dataclasses.replace(tsc))
    assert tsc.textures.n_words == 2 and tsc.textures.emissive_small is None
    for f in ("emission", "power", "compact", "cdf"):
        np.testing.assert_allclose(getattr(tl, f).numpy(), getattr(jl, f),
                                   rtol=1e-6, atol=1e-30, err_msg=f)
