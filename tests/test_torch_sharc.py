"""The port's SHARC cache (``drts_tpu_torch/ops/sharc.py``) against the
reference's ``drts_tpu/ops/sharc.py`` on the CPU, from numpy seeds.

Tolerances:
- cache keys (slots, fingerprints), the query mirror's meta words, the
  footprint gate, the splat's fingerprint claims, counts and dropped rows:
  bit for bit. (The voxel level is floor(log2(distance)): the inputs keep
  distances off powers of two, where the two libraries' log2 could round
  to either side.)
- splat radiance sums: rtol 1e-6 / atol 1e-6 (float sums of up to a few
  dozen rows, taken in another order by index_add_ than by XLA's scatter).
- resolve: radiance rtol 1e-5 / atol 1e-6 (a blend of those sums); counts,
  staleness and fingerprints exact; packed rows: the meta column exact, the
  f16 pairs within one f16 step of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.ops import sharc as jsharc
from drts_tpu_torch.ops import sharc as tsharc

T = torch.from_numpy
CFG = tsharc.SHARCConfig(capacity_log2=12)
JCFG = jsharc.SHARCConfig(capacity_log2=12)


def points(seed, n):
    """Hit points near a camera, normals, and distances off powers of 2."""
    rng = np.random.RandomState(seed)
    cam = np.array([0.3, 1.2, -6.0], np.float32)
    pos = (rng.randn(n, 3) * 4.0).astype(np.float32)
    # Voxel-sized clusters: many points share a voxel.
    pos[: n // 2] = np.round(pos[: n // 2] * 2.0) / 2.0 + 0.01
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dist = np.linalg.norm(pos - cam, axis=1)
    frac = np.log2(np.maximum(dist, 1e-3)) % 1.0
    ok = (frac > 1e-4) & (frac < 1 - 1e-4)
    return cam, pos[ok], nrm[ok]


def test_cache_key_and_footprint_match():
    cam, pos, nrm = points(0, 8192)
    j_slot, j_fp = (np.asarray(x) for x in jsharc.cache_key(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam), JCFG))
    t_slot, t_fp = tsharc.cache_key(T(pos), T(nrm), T(cam), CFG)
    np.testing.assert_array_equal(t_slot.numpy(), j_slot.astype(np.int64))
    np.testing.assert_array_equal(t_fp.numpy(), j_fp.astype(np.int64))
    assert t_fp.min() >= 1 and t_slot.max() < 1 << 12
    assert len(np.unique(j_slot)) < len(j_slot) * 0.9   # shared voxels
    rng = np.random.RandomState(1)
    hd = (rng.rand(len(pos)) * 3.0).astype(np.float32)
    rough = (rng.rand(len(pos)) * 1.5).astype(np.float32)
    j_ok = np.asarray(jsharc.footprint_valid(
        jnp.asarray(hd), jnp.asarray(rough), jnp.asarray(pos),
        jnp.asarray(cam), JCFG))
    t_ok = tsharc.footprint_valid(T(hd), T(rough), T(pos), T(cam), CFG)
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    assert 0.1 < j_ok.mean() < 0.9


def splat_inputs(seed, levels, n_per):
    cam, pos, nrm = points(seed, levels * n_per * 2)
    pos, nrm = pos[:levels * n_per], nrm[:levels * n_per]
    rng = np.random.RandomState(seed + 7)
    slot, fp = tsharc.cache_key(T(pos), T(nrm), T(cam), CFG)
    rad = (rng.rand(len(pos), 3) * 2.0).astype(np.float32)
    act = rng.rand(len(pos)) < 0.55
    split = [slice(i * n_per, (i + 1) * n_per) for i in range(levels)]
    return ([slot.numpy()[s] for s in split], [fp.numpy()[s] for s in split],
            [rad[s] for s in split], [act[s] for s in split])


_j_splat_levels = jax.jit(jsharc.splat_levels)
_j_resolve = jax.jit(jsharc.resolve, static_argnums=4)


def run_splat(inputs, capacity=1 << 12):
    slots, fps, rads, acts = inputs
    j = _j_splat_levels(
        (jnp.zeros((capacity, 3)), jnp.zeros(capacity),
         jnp.zeros(capacity, jnp.uint32)),
        [jnp.asarray(s, jnp.int32) for s in slots],
        [jnp.asarray(f.astype(np.uint32)) for f in fps],
        [jnp.asarray(r) for r in rads], [jnp.asarray(a) for a in acts])
    t = tsharc.splat_levels(
        (torch.zeros((capacity, 3)), torch.zeros(capacity),
         torch.zeros(capacity, dtype=torch.int64)),
        [T(s) for s in slots], [T(f) for f in fps], [T(r) for r in rads],
        [T(a) for a in acts])
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("levels,n_per", [(3, 700), (8, 4000)])
def test_splat_levels_match(levels, n_per):
    """A small stream (every live row kept) and one of 32,000 rows, where
    the n/3 live cap and the n/6 row cap both drop rows."""
    j, t = run_splat(splat_inputs(levels, levels, n_per))
    np.testing.assert_array_equal(t[2], j[2].astype(np.int64))
    np.testing.assert_array_equal(t[1], j[1])
    assert float(t[3]) == float(j[3])
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6, atol=1e-6)
    assert (j[1] > 1).any()            # merged duplicates
    if levels * n_per > 16384:
        assert float(j[3]) > 0         # the caps dropped rows


def test_resolve_and_query_match():
    """Two splats resolved into a cache (a slot conflict, staleness), then
    queried at the points that were splatted."""
    cfg_j = jsharc.SHARCConfig(capacity_log2=12, max_stale_frames=1)
    cfg_t = tsharc.SHARCConfig(capacity_log2=12, max_stale_frames=1)
    j_state = jsharc.init_state(cfg_j)
    t_state = tsharc.init_state(cfg_t, "cpu")
    for seed in (3, 4, 5):
        inputs = splat_inputs(seed, 2, 1500)
        j, t = run_splat(inputs)
        j_state = _j_resolve(j_state, jnp.asarray(j[0]), jnp.asarray(j[1]),
                             jnp.asarray(j[2]), cfg_j)
        t_state = tsharc.resolve(t_state, T(t[0]), T(t[1]), T(t[2]), cfg_t)
        np.testing.assert_array_equal(t_state.fingerprint.numpy(),
                                      np.asarray(j_state.fingerprint))
        for name in ("sample_count", "stale_frames"):
            np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                          np.asarray(getattr(j_state, name)))
        np.testing.assert_allclose(t_state.radiance.numpy(),
                                   np.asarray(j_state.radiance), rtol=1e-5,
                                   atol=1e-6)
        jp, tp = np.asarray(j_state.packed), t_state.packed.numpy()
        np.testing.assert_array_equal(tp[:, 2].view(np.uint32),
                                      jp[:, 2].view(np.uint32))
        f16 = tp[:, :2].view(np.uint32), jp[:, :2].view(np.uint32)
        for shift in (0, 16):
            a = ((f16[0] >> shift) & 0xFFFF).astype(np.uint16).view(np.float16)
            b = ((f16[1] >> shift) & 0xFFFF).astype(np.uint16).view(np.float16)
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), rtol=1e-3,
                                       atol=1e-4)
    assert (np.asarray(j_state.fingerprint) > 0).mean() > 0.1
    assert (np.asarray(j_state.stale_frames) > 0).any()

    cam, pos, nrm = points(5, 2 * 1500 * 2)
    j_rad, j_ok = (np.asarray(x) for x in jsharc.query(
        j_state, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam),
        cfg_j))
    t_rad, t_ok = tsharc.query(t_state, T(pos), T(nrm), T(cam), cfg_t)
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    assert j_ok.any()
    np.testing.assert_allclose(t_rad.numpy(), j_rad, rtol=1e-3, atol=1e-4)
