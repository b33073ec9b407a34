"""The port's packed texture sets and material evaluation against the
reference: ``texpack.build``, ``shading.sample_packed`` (bilinear,
"nearest" from the half-size mip, "nearest0" at level 0),
``shading.sample_atlas`` and ``shading.evaluate_material`` with a normal
map, on seeded random atlases of 2 and 3 words per texel.

Tolerances: the baked rows (as uint32 bits), ``rows_half``,
``emissive_mean``, ``emissive_small`` and the rewritten map columns are
equal bit for bit (the baker is the same numpy code). Samples agree to
1e-6 absolute, the perturbed shading normal to 1e-5: the reference's
XLA:CPU contracts multiply-adds into FMAs, the port rounds each
operation. The reference's own cases (tests/test_parity_extras.py:
transmission map, half-size mip, packed against float atlas) run through
the port with their own tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import material as jmaterial, texpack as jtexpack
from drts_tpu.ops import shading as jshading
from drts_tpu_torch.models import material as tmaterial
from drts_tpu_torch.models import texpack as ttexpack
from drts_tpu_torch.ops import shading as tshading

# (words, atlas size, baked size): 2 words with the area downsample, 3
# words with the nearest resample (24 is no multiple of 16).
CASES = [(2, 32, 16), (3, 24, 16)]
FILTERS = ("bilinear", "nearest", "nearest0")


def descs(words, cls):
    """Materials using base, normal, metallic and roughness maps (and, for
    3 words, emissive and transmission maps), one sharing a combination
    with another, and two with no map at all."""
    mats = [
        cls(base_color=(0.8, 0.7, 0.6, 1.0), metallic=0.5, roughness=0.9,
            base_color_map=0, normal_map=1, metallic_map=2, roughness_map=3),
        cls(base_color=(1.0, 1.0, 1.0, 0.9), base_color_map=4,
            normal_map=1),
        cls(base_color=(0.3, 0.3, 0.3, 1.0)),
        cls(base_color=(0.5, 0.9, 0.2, 1.0), roughness=0.3,
            base_color_map=4, normal_map=1),
        cls(base_color=(0.2, 0.4, 0.6, 1.0), normal_map=5),
    ]
    if words == 3:
        mats += [
            cls(base_color=(1.0, 1.0, 1.0, 1.0), emissive_strength=3.0,
                emissive_color=(1.0, 0.8, 0.5), transmission=0.7,
                base_color_map=0, emissive_color_map=5, transmission_map=2,
                normal_map=3),
            cls(base_color=(0.9, 0.9, 0.9, 1.0), emissive_strength=2.0,
                emissive_color=(0.5, 0.5, 1.0), emissive_color_map=4),
        ]
    mats.append(cls(base_color=(0.1, 0.2, 0.3, 1.0)))
    return mats


def built(words, s0, size, seed=0):
    atlas = np.random.RandomState(seed).random_sample(
        (6, s0, s0, 4)).astype(np.float32)
    jraw = jmaterial.pack_materials(descs(words, jmaterial.MaterialDesc))
    traw = tmaterial.pack_materials(descs(words, tmaterial.MaterialDesc),
                                    "cpu")
    jpk, jmats = jtexpack.build(atlas, jraw, size=size)
    tpk, tmats = ttexpack.build(atlas, traw, size=size)
    return jpk, jmats, tpk, tmats


def bits(x):
    return np.asarray(x, np.uint32).view(np.int32)


def sample_inputs(tpk, n=517, seed=1):
    """uv over [-0.3, 1.3]^2 with the edges the frame may not reach (u
    below 0.5/S, u = 0 and 1, v = 0 and 1), set ids over [-1, T'), -1
    included."""
    rng = np.random.RandomState(seed)
    uv = rng.uniform(-0.3, 1.3, (n, 2)).astype(np.float32)
    s = tpk.size
    edges = np.array([[0.2 / s, 0.5], [0.0, 0.0], [1.0, 1.0], [0.5, 0.0],
                      [0.5, 1.0], [0.49 / s, 1.0 - 0.2 / s],
                      [1.0 - 0.1 / s, 0.3]], np.float32)
    uv[:len(edges)] = edges
    n_sets = tpk.rows.shape[0] // (s * s)
    sets = rng.randint(-1, n_sets, n).astype(np.int32)
    sets[:3] = -1 if n_sets > 1 else 0
    return uv, sets


@pytest.mark.parametrize("words,s0,size", CASES)
def test_build_matches_reference_bit_for_bit(words, s0, size):
    jpk, jmats, tpk, tmats = built(words, s0, size)
    assert tpk.n_words == jpk.n_words == words
    assert (tpk.size, tpk.half_size) == (jpk.size, jpk.half_size)
    assert tpk.rows.dtype == torch.int32
    np.testing.assert_array_equal(tpk.rows.numpy(), bits(jpk.rows))
    np.testing.assert_array_equal(tpk.rows_half.numpy(),
                                  bits(jpk.rows_half))
    np.testing.assert_array_equal(tpk.emissive_mean.numpy(),
                                  np.asarray(jpk.emissive_mean))
    if words == 3:
        np.testing.assert_array_equal(tpk.emissive_small.numpy(),
                                      np.asarray(jpk.emissive_small))
    else:
        assert tpk.emissive_small is None and jpk.emissive_small is None
    for f in ttexpack.MAP_FIELDS:
        np.testing.assert_array_equal(getattr(tmats, f).numpy(),
                                      np.asarray(getattr(jmats, f)), f)


def test_build_without_maps_is_none():
    traw = tmaterial.pack_materials([tmaterial.MaterialDesc()], "cpu")
    atlas = np.ones((1, 8, 8, 4), np.float32)
    assert ttexpack.build(None, traw) == (None, traw)
    assert ttexpack.build(atlas, traw) == (None, traw)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("words,s0,size", CASES)
def test_sample_packed_matches_reference(words, s0, size, filt):
    jpk, _, tpk, _ = built(words, s0, size)
    uv, sets = sample_inputs(tpk)
    js = jshading.sample_packed(jpk, jnp.asarray(sets), jnp.asarray(uv),
                                filt)
    ts = tshading.sample_packed(tpk, torch.from_numpy(sets),
                                torch.from_numpy(uv), filt)
    for f in ("base_rgb", "alpha", "normal_xy", "metallic", "roughness",
              "emissive_rgb", "transmission"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    unused = sets < 0
    assert (ts.base_rgb.numpy()[unused] == 1.0).all()
    assert (ts.normal_xy.numpy()[unused] == 0.0).all()


@pytest.mark.parametrize("filt", ("bilinear", "nearest"))
def test_sample_atlas_matches_reference(filt):
    rng = np.random.RandomState(4)
    atlas = rng.random_sample((3, 16, 16, 4)).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (400, 2)).astype(np.float32)
    idx = rng.randint(-1, 3, 400).astype(np.int32)
    want = jshading.sample_atlas(jnp.asarray(atlas), jnp.asarray(idx),
                                 jnp.asarray(uv), filt)
    got = tshading.sample_atlas(torch.from_numpy(atlas),
                                torch.from_numpy(idx), torch.from_numpy(uv),
                                filt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("words,s0,size", CASES)
def test_evaluate_material_matches_reference(words, s0, size, filt):
    jpk, jmats, tpk, tmats = built(words, s0, size)
    uv, _ = sample_inputs(tpk, seed=2)
    rng = np.random.RandomState(3)
    n_mat = tmats.base_color.shape[0]
    obj = rng.randint(0, n_mat, uv.shape[0])
    nrm = rng.randn(uv.shape[0], 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = rng.randn(uv.shape[0], 3).astype(np.float32)
    jm = jshading.evaluate_material(jmats.gather(jnp.asarray(obj)),
                                    jnp.asarray(uv), jnp.asarray(nrm),
                                    jnp.asarray(tan), jpk, filt)
    tm = tshading.evaluate_material(tmats.gather(torch.from_numpy(obj)),
                                    torch.from_numpy(uv),
                                    torch.from_numpy(nrm),
                                    torch.from_numpy(tan), tpk, filt)
    for f in ("base_color", "alpha", "emission", "metallic", "roughness",
              "ior", "transmission"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tm.shading_normal.numpy(),
                               np.asarray(jm.shading_normal), rtol=0,
                               atol=1e-5)
    mapped = tmats.normal_map.numpy()[obj] >= 0
    assert mapped.any() and (~mapped).any()
    # Unmapped lanes keep their normal exactly.
    np.testing.assert_array_equal(tm.shading_normal.numpy()[~mapped],
                                  nrm[~mapped])


def test_transmission_map_sampling():
    """tests/test_parity_extras.py's case through the port: the
    transmission map scales the material's transmission."""
    atlas = np.full((1, 4, 4, 4), 0.25, np.float32)
    mats = tmaterial.pack_materials([
        tmaterial.MaterialDesc(base_color=(1, 1, 1, 1), transmission=0.8,
                               transmission_map=0),
        tmaterial.MaterialDesc(base_color=(1, 1, 1, 1), transmission=0.8),
    ], "cpu")
    packed, mats = ttexpack.build(atlas, mats, size=4)
    mat = mats.gather(torch.tensor([0, 1]))
    uv = torch.full((2, 2), 0.5)
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(2, 1)
    t = torch.tensor([[1.0, 0.0, 0.0]]).repeat(2, 1)
    ev = tshading.evaluate_material(mat, uv, n, t, packed)
    np.testing.assert_allclose(float(ev.transmission[0]), 0.8 * 0.25,
                               atol=1.0 / 255.0)
    np.testing.assert_allclose(float(ev.transmission[1]), 0.8, rtol=1e-5)


def test_packed_texture_half_mip():
    """tests/test_parity_extras.py's case through the port: "nearest"
    reads the half-size mip (each texel the mean of its 2x2 block),
    "nearest0" level 0."""
    rng = np.random.RandomState(7)
    s = 16
    atlas = rng.random_sample((1, s, s, 4)).astype(np.float32)
    mats = tmaterial.pack_materials([
        tmaterial.MaterialDesc(base_color=(1, 1, 1, 1), base_color_map=0)],
        "cpu")
    packed, _ = ttexpack.build(atlas, mats, size=s)
    assert packed.half_size == s // 2
    assert tuple(packed.rows_half.shape) == ((s // 2) ** 2,
                                             packed.rows.shape[1])
    hs = s // 2
    uv = torch.tensor([[(i + 0.5) / hs, (j + 0.5) / hs]
                       for j in range(hs) for i in range(hs)])
    idx = torch.zeros(uv.shape[0], dtype=torch.int32)
    ts = tshading.sample_packed(packed, idx, uv, "nearest")
    want = atlas[0, :, :, :3].reshape(hs, 2, hs, 2, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(ts.base_rgb.numpy().reshape(hs, hs, 3), want,
                               atol=0.02)
    uv0 = torch.tensor([[0.5 / s, 0.5 / s]])
    ts0 = tshading.sample_packed(packed, torch.zeros(1, dtype=torch.int32),
                                 uv0, "nearest0")
    np.testing.assert_allclose(ts0.base_rgb.numpy()[0], atlas[0, 0, 0, :3],
                               atol=0.02)


def test_packed_texture_set_matches_float_atlas():
    """tests/test_parity_extras.py's case through the port: the one-gather
    packed path reproduces the float atlas's bilinear sample to u8
    precision."""
    rng = np.random.RandomState(3)
    s = 16
    atlas = rng.random_sample((5, s, s, 4)).astype(np.float32)
    mats = tmaterial.pack_materials([
        tmaterial.MaterialDesc(
            base_color=(1, 1, 1, 1), metallic=1.0, roughness=1.0,
            transmission=1.0, emissive_strength=1.0,
            emissive_color=(1, 1, 1), base_color_map=0, normal_map=1,
            metallic_map=2, roughness_map=3, emissive_color_map=4,
            transmission_map=2)], "cpu")
    packed, pmats = ttexpack.build(atlas, mats, size=s)
    assert packed.n_words == 3
    n_pts = 257
    uv = torch.from_numpy(rng.random_sample((n_pts, 2)).astype(np.float32))
    idx = torch.zeros(n_pts, dtype=torch.int64)
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n_pts, 1)
    tan = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n_pts, 1)
    ev = tshading.evaluate_material(pmats.gather(idx), uv, nrm, tan, packed)
    raw = mats.gather(idx)
    tatlas = torch.from_numpy(atlas)
    bc = tshading.sample_atlas(tatlas, raw.base_color_map, uv)
    mtl = tshading.sample_atlas(tatlas, raw.metallic_map, uv)
    rgh = tshading.sample_atlas(tatlas, raw.roughness_map, uv)
    np.testing.assert_allclose(ev.base_color.numpy(), bc[..., :3].numpy(),
                               atol=0.02)
    np.testing.assert_allclose(ev.alpha.numpy(), bc[..., 3].numpy(),
                               atol=0.01)
    np.testing.assert_allclose(ev.metallic.numpy(), mtl[..., 0].numpy(),
                               atol=0.01)
    np.testing.assert_allclose(ev.roughness.numpy(), rgh[..., 0].numpy(),
                               atol=0.01)
