"""The port's any-hit mesh path against the reference, on the CPU.

The port takes its plain PyTorch versions here; the reference runs its
Pallas kernels in interpret mode (``interpret=True``, or
``intersect.BACKEND = "interpret"`` for the whole path). Inputs come from
numpy seeds and go through both.

Tolerances: an any-hit result is one bit per ray. XLA:CPU contracts
multiply-adds into FMAs, so a hit whose t, u or v lies within rounding of a
range end or a triangle edge may fall on either side; B8 compares t in
object units and B9 in world units, which moves the same few lanes. Held,
as tests/test_trimesh.py holds the reference's own any-hit forms against
each other: the same bit on > 99.9% of lanes, never a blocked dead lane.
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
AGREE = 0.999


def unit_rows(rng, n, cols):
    v = rng.randn(n, cols)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    """tess -> (reference TriMesh, port TriMesh)."""
    out = {}
    for tess in (2, 3):
        arrays = jgeometry.create_geosphere(2.0, tess)
        out[tess] = (jtrimesh.make_mesh(*arrays),
                     ttrimesh.make_mesh(*arrays, device="cpu"))
    return out


def hard_scene(seed, k=24, n=4096):
    """tests/test_trimesh.py's _cand_vs_serial_scene: a giant ground-like
    instance whose bound contains most origins, overlapping bounds, and
    half the rays spawned on instance surfaces."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(k, 3).astype(np.float32) * 6
    scale = (0.4 + rng.rand(k) * 1.4).astype(np.float32)
    pos[0] = [0.0, -100.0, 0.0]
    scale[0] = 99.0
    rot = unit_rows(rng, k, 4)
    o = rng.randn(n, 3).astype(np.float32) * 8
    half = n // 2
    which = rng.randint(0, k, half)
    dir_out = unit_rows(rng, half, 3)
    o[:half] = pos[which] + dir_out * scale[which][:, None] * 1.001
    return pos, rot, scale, o, unit_rows(rng, n, 3)


def mixed_tmax(seed, n):
    """tests/test_trimesh.py:305: a fifth of the ranges short (0.5), a
    tenth of the rest dead, the others unbounded."""
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(n) < 0.2, 0.5,
                    np.where(rng.rand(n) < 0.1, -1.0, 1e9)).astype(np.float32)


@pytest.fixture(scope="module")
def kernel_case(meshes):
    """The hard scene's rays with mixed ranges and the per-call tables, as
    the reference builds them, for the kernel-alone tests."""
    jmesh, tmesh = meshes[3]
    pos, rot, scale, o, d = hard_scene(13)
    n = o.shape[0]
    jt = jtp.make_inst_tables(jnp.asarray(pos), jnp.asarray(rot),
                              jnp.asarray(scale), jmesh.bound_radius,
                              sort_origin=jnp.asarray(o.mean(0)))
    rays = tintersect.pack_rays(T(o), T(d), torch.zeros(n),
                                T(mixed_tmax(13, n)))
    bscan = jtp.make_bscan_table(jt[0])
    return {
        "jmesh": jmesh, "tmesh": tmesh, "n": n, "n_ic": jt[3],
        "jrays": jnp.asarray(rays.numpy()), "rays": rays,
        "jinst": jt[0], "jbounds": jt[1], "jbscan": bscan,
        "inst": T(np.array(jt[0])), "bounds": T(np.array(jt[1])),
        "bscan": T(np.array(bscan)),
        "dead": (rays[7] < rays[6]).numpy(),
    }


def j_bound_scan(case, cursor):
    bs = case["jbscan"]
    return np.asarray(jtp.bound_scan(
        case["jrays"], bs, bs.shape[0] // jtp.BSCAN_CHUNK, jtp.BSCAN_CHUNK,
        jnp.asarray(cursor)[None], interpret=True))[0]


def j_blas_any(case, cand, occ):
    jmesh = case["jmesh"]
    return np.asarray(jtp.shared_blas_any(
        case["jrays"], jnp.asarray(cand)[None], jnp.asarray(occ)[None],
        case["jinst"], jmesh.tri_bounds, jmesh.tri_tbl,
        case["jinst"].shape[1], jmesh.n_chunks,
        jmesh.tri_tbl.shape[0] // jmesh.n_chunks, interpret=True))[0]


# ----------------------------------------------------------------------------
# The kernels alone


def test_shared_blas_any_matches_interpret(kernel_case):
    """B8 on the first round's candidates from a clear bit row, then on the
    second round's with the first round's bits set: a set bit stays, a lane
    without a candidate or with a dead range returns its bit."""
    case = kernel_case
    n, m_tbl = case["n"], case["inst"].shape[1]
    tri_tbl = case["tmesh"].tri_tbl
    mask = (1 << pos_bits(case["bscan"].shape[0])) - 1
    key = j_bound_scan(case, np.full(n, -1, np.int32))
    occ = np.zeros(n, np.int32)
    for round_ in range(2):
        cand = np.where(key < INF_BITS, key & mask, m_tbl).astype(np.int32)
        expect = j_blas_any(case, cand, occ)
        work = {}
        got = tk.shared_blas_any_plain(case["rays"], T(cand), T(occ.copy()),
                                       case["inst"], tri_tbl, work=work)
        via_wrapper = tk.shared_blas_any(
            case["rays"], T(cand), T(occ.copy()), case["inst"], tri_tbl,
            case["tmesh"].tri_bounds, case["tmesh"].tri_chunk)
        assert torch.equal(got, via_wrapper)
        got = got.numpy()
        assert (got == expect).mean() > AGREE, (got != expect).sum()
        assert set(np.unique(got)) <= {0, 1}
        idle = (cand == m_tbl) | case["dead"] | (occ > 0)
        np.testing.assert_array_equal(got[idle], occ[idle])
        assert 0 < (got > occ).sum() < n
        assert work["live"] == int((~idle).sum())
        # A blocked lane stops early; a free one visits every row.
        assert tri_tbl.shape[0] * int((got[~idle] == 0).sum()) \
            < work["tri_tests"] < tri_tbl.shape[0] * work["live"]
        occ = expect
        key = j_bound_scan(case, key)


def test_serial_anyhit_matches_interpret(kernel_case):
    """B9 over every instance on the mixed ranges, and with every live
    range cut to 9 units."""
    case = kernel_case
    jmesh, tmesh = case["jmesh"], case["tmesh"]
    for tmax in (None, 9.0):
        rays = case["rays"].clone()
        if tmax is not None:
            rays[7] = torch.where(rays[7] > tmax, tmax, rays[7])
        expect = np.asarray(jtp.intersect_mesh_instances_any(
            jnp.asarray(rays.numpy()), case["jinst"], case["jbounds"],
            jmesh.tri_bounds, jmesh.tri_tbl, case["n_ic"], jtp.INST_CHUNK,
            jmesh.n_chunks, jmesh.tri_tbl.shape[0] // jmesh.n_chunks,
            interpret=True))
        work = {}
        args = (rays, case["inst"], case["bounds"], tmesh.tri_tbl,
                tmesh.tri_bounds, tmesh.tri_chunk, case["n_ic"])
        got = tk.intersect_mesh_instances_any_plain(*args, work=work)
        assert torch.equal(got, tk.intersect_mesh_instances_any(*args))
        got = got.numpy()
        assert ((got > 0) == (expect > 0)).mean() > AGREE
        assert not got[case["dead"]].any()
        assert 0.05 < (got > 0).mean() < 0.95
        assert work["live"] == int((~case["dead"]).sum())
        assert work["sweeps"] >= int((got > 0).sum())


def test_serial_anyhit_sparse_batch_matches_interpret(kernel_case):
    """B9 on a batch as sparse as the frame's backstop batches: 9 live
    lanes scattered through 4,096, the rest dead, on instances whose scales
    are none of them 1 (the direction is scaled by 1/scale)."""
    case = kernel_case
    jmesh, tmesh = case["jmesh"], case["tmesh"]
    inst = case["inst"]
    assert not (inst[7][inst[8] > 0] == 1.0).any()   # padding: radius 0
    rng = np.random.RandomState(5)
    keep = rng.choice(np.flatnonzero(~case["dead"]), 9, replace=False)
    rays = case["rays"].clone()
    dead = np.ones(case["n"], bool)
    dead[keep] = False
    rays[7, T(dead)] = -1.0
    expect = np.asarray(jtp.intersect_mesh_instances_any(
        jnp.asarray(rays.numpy()), case["jinst"], case["jbounds"],
        jmesh.tri_bounds, jmesh.tri_tbl, case["n_ic"], jtp.INST_CHUNK,
        jmesh.n_chunks, jmesh.tri_tbl.shape[0] // jmesh.n_chunks,
        interpret=True))
    work = {}
    got = tk.intersect_mesh_instances_any_plain(
        rays, case["inst"], case["bounds"], tmesh.tri_tbl, tmesh.tri_bounds,
        tmesh.tri_chunk, case["n_ic"], work=work).numpy()
    np.testing.assert_array_equal(got > 0, expect > 0)
    assert not got[dead].any() and work["live"] == 9
    assert 0 < (got > 0).sum() < 9


def dense_anyhit(rays, inst_tbl, tri_tbl):
    """B9 with no cull at all: every live ray against every instance with a
    positive radius."""
    occ = torch.zeros(rays.shape[1], dtype=torch.bool)
    tmax = torch.where(rays[7] >= rays[6], rays[7], -1.0)
    for k in range(inst_tbl.shape[1]):
        row = inst_tbl[:, k]
        if float(row[8]) <= 0.0:
            continue
        ol, dl, inv_s = tk._to_object(rays, row)
        hit = tk._sweep_packed(ol, tuple(x * inv_s for x in dl), rays[6],
                               tmax, tri_tbl, 0, 4096)
        occ |= hit < INF_BITS
    return occ


def test_serial_anyhit_culls_change_nothing(kernel_case):
    """The plain B9's per-ray sphere tests against the lane's own tmax are
    conservative: it equals the unculled dense walk exactly, and a
    closest hit found by the plain B7 is a blocker."""
    case = kernel_case
    rays = case["rays"][:, :1024].contiguous()
    tri_tbl = case["tmesh"].tri_tbl
    got = tk.intersect_mesh_instances_any(
        rays, case["inst"], case["bounds"], tri_tbl, case["tmesh"].tri_bounds,
        case["tmesh"].tri_chunk, case["n_ic"]) > 0
    assert torch.equal(got, dense_anyhit(rays, case["inst"], tri_tbl))
    t, _, _ = tk.intersect_mesh_instances(rays, case["inst"], case["bounds"],
                                          tri_tbl, case["n_ic"])
    assert torch.equal(got, torch.isfinite(t))
    assert 0 < int(got.sum()) < 1024


def test_anyhit_wrappers_refuse_wrong_tensors(kernel_case):
    case = kernel_case
    words = torch.zeros(case["n"], dtype=torch.int32)
    tri_tbl = case["tmesh"].tri_tbl
    with pytest.raises(ValueError):
        tk.shared_blas_any(case["rays"], words[:-1], words, case["inst"],
                           tri_tbl, case["tmesh"].tri_bounds,
                           case["tmesh"].tri_chunk)
    with pytest.raises(ValueError):
        tk.shared_blas_any(case["rays"], words, words.long(), case["inst"],
                           tri_tbl, case["tmesh"].tri_bounds,
                           case["tmesh"].tri_chunk)
    blas = (case["tmesh"].tri_bounds, case["tmesh"].tri_chunk)
    with pytest.raises(ValueError):
        tk.intersect_mesh_instances_any(case["rays"], case["inst"],
                                        case["bounds"].T.contiguous(),
                                        tri_tbl, *blas, case["n_ic"])
    with pytest.raises(ValueError):
        tk.intersect_mesh_instances_any(case["rays"], case["inst"],
                                        case["bounds"], tri_tbl, *blas,
                                        case["n_ic"] + 1)
    with pytest.raises(ValueError, match="chunk"):
        tk.intersect_mesh_instances_any(case["rays"], case["inst"],
                                        case["bounds"], tri_tbl, blas[0], 12,
                                        case["n_ic"])


# ----------------------------------------------------------------------------
# intersect_instances_any


def reference_any(cand, mesh, pos, rot, scale, o, d, tmax):
    """The reference's any-hit under BACKEND = "interpret": the candidate
    loop (cand True) or its serial any-hit kernel alone."""
    n = o.shape[0]
    old = (jintersect.BACKEND, jtrimesh.MESH_CAND)
    jintersect.BACKEND, jtrimesh.MESH_CAND = "interpret", cand
    try:
        return np.asarray(jtrimesh.intersect_instances_any(
            jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.asarray(tmax),
            mesh, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(scale)))
    finally:
        jintersect.BACKEND, jtrimesh.MESH_CAND = old


def port_any(mesh, pos, rot, scale, o, d, tmax, rounds):
    n = o.shape[0]
    return ttrimesh.intersect_instances_any(
        T(o), T(d), torch.zeros(n), T(tmax), mesh, T(pos), T(rot), T(scale),
        rounds=rounds).numpy()


@pytest.fixture(scope="module")
def any_cases(meshes):
    """name -> (port mesh, scene, tmax, the reference's loop result, the
    reference's serial result): the ground scene with mixed ranges
    (tests/test_trimesh.py:296) and 24 instances with unbounded, short and
    dead rays (tests/test_trimesh.py:163, half of the rays aimed)."""
    out = {}
    jmesh, tmesh = meshes[3]
    scene = hard_scene(13)
    tmax = mixed_tmax(13, scene[3].shape[0])
    out["ground"] = (tmesh, scene, tmax,
                     reference_any(True, jmesh, *scene, tmax),
                     reference_any(False, jmesh, *scene, tmax))
    jmesh, tmesh = meshes[2]
    rng = np.random.RandomState(23)
    k, n = 24, 4096
    pos = (rng.randn(k, 3) * 8).astype(np.float32)
    rot = unit_rows(rng, k, 4)
    scale = (0.5 + rng.rand(k)).astype(np.float32)
    o = (rng.randn(n, 3) * 10).astype(np.float32)
    d = unit_rows(rng, n, 3)
    # Every other ray aims near an instance, so enough rays are blocked.
    aim = pos[rng.randint(0, k, n)] + 0.5 * rng.randn(n, 3) - o
    d[::2] = (aim / np.linalg.norm(aim, axis=1, keepdims=True))[::2]
    tmax = np.where(rng.rand(n) < 0.3, 1e9,
                    np.where(rng.rand(n) < 0.5, rng.rand(n) * 12, -1.0)
                    ).astype(np.float32)
    scene = (pos, rot, scale, o, d)
    out["scattered"] = (tmesh, scene, tmax,
                        reference_any(True, jmesh, *scene, tmax),
                        reference_any(False, jmesh, *scene, tmax))
    return out


@pytest.mark.parametrize("rounds", [2, 1, 0])
@pytest.mark.parametrize("name", ["ground", "scattered"])
def test_intersect_instances_any_matches_reference(any_cases, name, rounds):
    """2 rounds (the default), 1 round and the serial walk alone against
    the reference's loop and its serial kernel."""
    tmesh, scene, tmax, j_loop, j_serial = any_cases[name]
    got = port_any(tmesh, *scene, tmax, rounds)
    assert got.dtype == np.bool_ and got.shape == tmax.shape
    assert (got == j_loop).mean() > AGREE, (got != j_loop).sum()
    assert (got == j_serial).mean() > AGREE, (got != j_serial).sum()
    assert not got[tmax < 0].any()
    assert 0.02 < got.mean() < 0.98


@pytest.mark.parametrize("name", ["ground", "scattered"])
def test_anyhit_rounds_agree_and_match_closest_hit(any_cases, name):
    """The loop with 0, 1 and 2 rounds answers the same question as the
    closest hit's hit bit on the same range."""
    tmesh, (pos, rot, scale, o, d), tmax, _, _ = any_cases[name]
    n = o.shape[0]
    results = [port_any(tmesh, pos, rot, scale, o, d, tmax, r)
               for r in (0, 1, 2)]
    for other in results[1:]:
        assert (other == results[0]).mean() > AGREE
    closest = ttrimesh.intersect_instances(
        T(o), T(d), torch.zeros(n), T(tmax), tmesh, T(pos), T(rot), T(scale))
    assert (results[2] == closest.hit.numpy()).mean() > AGREE


def test_anyhit_keeps_the_lead_shape(meshes):
    """(H, W) rays in, an (H, W) bool out, equal to the flat call."""
    _, tmesh = meshes[2]
    pos, rot, scale, o, d = hard_scene(5, k=6, n=96)
    tmax = torch.full((8, 12), 20.0)
    args = (tmesh, T(pos), T(rot), T(scale))
    got = ttrimesh.intersect_instances_any(
        T(o).reshape(8, 12, 3), T(d).reshape(8, 12, 3), 0.0, tmax, *args)
    flat = ttrimesh.intersect_instances_any(T(o), T(d), 0.0, tmax.reshape(96),
                                            *args)
    assert got.shape == (8, 12) and got.dtype == torch.bool
    assert torch.equal(got.reshape(96), flat) and bool(got.any())
