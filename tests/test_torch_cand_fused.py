"""The port's fused candidate closest hit (B10, ``trimesh_kernels.cand_fused``)
and the ``trimesh.MESH_CAND`` modes against the multi-launch loop and the
reference, on the CPU.

Inputs: tests/test_trimesh.py's candidate scene (24 instances of a 128-face
geosphere, one giant ground-like instance whose bound holds most origins,
half the rays spawned on instance surfaces), from a numpy seed, every 7th
lane dead.

Tolerances:
- ``cand_fused_plain`` against the port's multi-launch loop
  (``cand_loop``): best, binst and key bit for bit on every lane (the
  same candidates in the same order, the same operations).
- against the reference's ``trimesh_pallas.cand_fused`` in interpret mode:
  the bars of tests/test_torch_trimesh.py for B5 and B6. Its XLA:CPU
  contracts multiply-adds into FMAs, which moves a t by a few ulp across a
  truncation step of the packed words: hit classification equal on >
  99.9% of lanes, t within rtol 1e-3 / atol 1e-4, the same (instance,
  face) on > 98%; the last scan's key found on the same live lanes (>
  99.9%). The reference's scan skips no dead lane (its liveness is the
  range it starts with), so keys are compared on live lanes only.
- ``intersect_instances`` in modes 1 and 2: bit for bit; each mode against
  the reference's serial walk with tests/test_trimesh.py's bars (hit bit
  > 99.9%, t rtol 1e-3 / atol 1e-4, instance > 99%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import geometry as jgeometry
from drts_tpu.ops import intersect as jintersect, trimesh as jtrimesh
from drts_tpu.ops import trimesh_pallas as jtp
from drts_tpu_torch.ops import intersect as tintersect, trimesh as ttrimesh
from drts_tpu_torch.ops import trimesh_kernels as tk
from drts_tpu_torch.ops.intersect_kernels import INF_BITS, pos_bits

T = torch.from_numpy


def unit_rows(rng, n, cols):
    v = rng.randn(n, cols)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def cand_scene(seed, k=24, n=4096):
    """tests/test_trimesh.py's _cand_vs_serial_scene."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(k, 3).astype(np.float32) * 6
    scale = (0.4 + rng.rand(k) * 1.4).astype(np.float32)
    pos[0] = [0.0, -100.0, 0.0]
    scale[0] = 99.0
    rot = unit_rows(rng, k, 4)
    o = rng.randn(n, 3).astype(np.float32) * 8
    half = n // 2
    which = rng.randint(0, k, half)
    o[:half] = pos[which] + unit_rows(rng, half, 3) * scale[which][:, None] \
        * 1.001
    return pos, rot, scale, o, unit_rows(rng, n, 3)


@pytest.fixture(scope="module")
def case():
    arrays = jgeometry.create_geosphere(2.0, 3)
    jmesh = jtrimesh.make_mesh(*arrays)
    tmesh = ttrimesh.make_mesh(*arrays, device="cpu")
    pos, rot, scale, o, d = cand_scene(7)
    n = o.shape[0]
    jt = jtp.make_inst_tables(jnp.asarray(pos), jnp.asarray(rot),
                              jnp.asarray(scale), jmesh.bound_radius,
                              sort_origin=jnp.asarray(o.mean(0)))
    rays = tintersect.pack_rays(T(o), T(d), torch.zeros(n),
                                torch.full((n,), 1e9))
    rays[7, ::7] = -1.0
    inst = T(np.array(jt[0]))
    return {"jmesh": jmesh, "tmesh": tmesh, "scene": (pos, rot, scale, o, d),
            "rays": rays, "jt": jt, "inst": inst,
            "bounds": T(np.array(jt[1])), "n_ic": jt[3],
            "bscan": tk.make_bscan_table(inst),
            "live": (rays[7] >= rays[6]).numpy()}


@pytest.mark.parametrize("rounds", [1, 3, 5])
def test_fused_plain_equals_the_loop(case, rounds):
    tmesh = case["tmesh"]
    args = (case["rays"], case["bscan"], case["inst"], case["bounds"],
            tmesh.tri_tbl, tmesh.tri_bounds, tmesh.tri_chunk, rounds)
    fused = tk.cand_fused_plain(*args)
    loop = tk.cand_loop(case["rays"], case["bscan"], case["inst"],
                        case["bounds"], tmesh.tri_tbl, tmesh.tri_bounds,
                        tmesh.tri_chunk, rounds)
    for f, lp in zip(fused, loop):
        assert torch.equal(f, lp)
    best, _, key = fused
    live = torch.from_numpy(case["live"])
    assert bool((best[~live] == INF_BITS).all())
    assert bool((key[~live] == INF_BITS).all())
    assert 0.3 < float((best < INF_BITS).float().mean()) < 0.99
    # With 1 round, lanes are left with a sphere ahead for the backstop.
    if rounds == 1:
        assert bool((key < INF_BITS).any())
    # The wrapper on a CPU tensor is the plain version.
    for w, f in zip(tk.cand_fused(*args), fused):
        assert torch.equal(w, f)


def test_fused_plain_matches_interpret(case):
    jmesh, jt = case["jmesh"], case["jt"]
    rounds = 3
    j_best, j_binst, j_key = (np.asarray(x)[0] for x in jtp.cand_fused(
        jnp.asarray(case["rays"].numpy()), jt[0], jt[1],
        jtp.make_bscan_table(jt[0]), jmesh.tri_bounds, jmesh.tri_tbl, rounds,
        jt[0].shape[1], jt[3], jtp.INST_CHUNK, jmesh.n_chunks,
        jmesh.tri_tbl.shape[0] // jmesh.n_chunks, interpret=True,
        conv=bool(jmesh.convex), conv_r=float(jmesh.local_radius)))
    tmesh = case["tmesh"]
    best, binst, key = (x.numpy() for x in tk.cand_fused_plain(
        case["rays"], case["bscan"], case["inst"], case["bounds"],
        tmesh.tri_tbl, tmesh.tri_bounds, tmesh.tri_chunk, rounds))
    mask = (1 << pos_bits(case["tmesh"].tri_tbl.shape[0])) - 1
    hit, j_hit = best < INF_BITS, j_best < INF_BITS
    assert (hit == j_hit).mean() > 0.999
    both = hit & j_hit
    assert both.mean() > 0.3
    np.testing.assert_allclose((best[both] & ~mask).view(np.float32),
                               (j_best[both] & ~mask).view(np.float32),
                               rtol=1e-3, atol=1e-4)
    same = ((best & mask) == (j_best & mask)) & (binst == j_binst)
    assert same[both].mean() > 0.98
    live = case["live"]
    assert ((key < INF_BITS) == (j_key < INF_BITS))[live].mean() > 0.999


@pytest.fixture(scope="module")
def serial_reference(case):
    pos, rot, scale, o, d = case["scene"]
    n = o.shape[0]
    old = (jintersect.BACKEND, jtrimesh.MESH_CAND)
    jintersect.BACKEND, jtrimesh.MESH_CAND = "interpret", 0
    try:
        out = jtrimesh.intersect_instances(
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full((n,), 1e9),
            case["jmesh"], jnp.asarray(pos), jnp.asarray(rot),
            jnp.asarray(scale))
    finally:
        jintersect.BACKEND, jtrimesh.MESH_CAND = old
    return {k: np.asarray(getattr(out, k))
            for k in ("hit", "t", "instance", "face")}


def port_hits(case, monkeypatch, mode):
    pos, rot, scale, o, d = case["scene"]
    n = o.shape[0]
    monkeypatch.setattr(ttrimesh, "MESH_CAND", mode)
    return ttrimesh.intersect_instances(
        T(o), T(d), torch.zeros(n), torch.full((n,), 1e9), case["tmesh"],
        T(pos), T(rot), T(scale))


def test_intersect_instances_modes(case, serial_reference, monkeypatch):
    """Modes 0, 1 and 2 against the reference's serial walk; 1 and 2
    return the same hits bit for bit."""
    got = {mode: port_hits(case, monkeypatch, mode) for mode in (0, 1, 2)}
    for name in ("hit", "t", "face", "instance", "barycentrics"):
        assert torch.equal(getattr(got[1], name), getattr(got[2], name))
    expect = serial_reference
    for mode, hits in got.items():
        hit = hits.hit.numpy()
        assert (hit == expect["hit"]).mean() > 0.999, mode
        both = hit & expect["hit"]
        assert both.mean() > 0.3
        np.testing.assert_allclose(hits.t.numpy()[both], expect["t"][both],
                                   rtol=1e-3, atol=1e-4)
        same = hits.instance.numpy()[both] == expect["instance"][both]
        assert same.mean() > 0.99, (mode, same.mean())


def test_mode_switch(case, monkeypatch):
    """An unknown mode raises; the any-hit walk takes the loop for modes 1
    and 2 and the serial walk for 0, and they agree."""
    pos, rot, scale, o, d = case["scene"]
    n = 1024
    args = (T(o[:n]), T(d[:n]), torch.zeros(n), torch.full((n,), 30.0),
            case["tmesh"], T(pos), T(rot), T(scale))
    occ = {}
    for mode in (0, 1, 2):
        monkeypatch.setattr(ttrimesh, "MESH_CAND", mode)
        occ[mode] = ttrimesh.intersect_instances_any(*args)
    assert torch.equal(occ[1], occ[2])
    assert float((occ[0] != occ[1]).float().mean()) <= 1e-3
    assert 0 < int(occ[0].sum()) < n
    monkeypatch.setattr(ttrimesh, "MESH_CAND", 3)
    with pytest.raises(ValueError):
        ttrimesh.intersect_instances(*args)
    with pytest.raises(ValueError):
        tk.cand_fused(case["rays"], case["bscan"], case["inst"],
                      case["bounds"], case["tmesh"].tri_tbl,
                      case["tmesh"].tri_bounds, case["tmesh"].tri_chunk, -1)
