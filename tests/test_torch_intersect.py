"""The plain versions of the port's closest-hit kernels (B1 Morton, B11
brute force) against the reference's Pallas kernels in interpret mode, the
wrappers' dispatch by tensor device, and B1's per-lane chunk cull
(``closest_chunk_walk``, ``intersect_morton_work``).

Tolerance: object indices equal exactly, hit/miss equal exactly, and t
within 7e-4 absolute. The port computes every product and sum separately
rounded, as its CUDA kernels built with -fmad=false do; the reference's
interpret mode runs on XLA:CPU, which contracts multiply-adds into FMAs.
The difference comes from the quadratic's constant term |o-c|^2 - r^2,
which is a few hundred here (the rays start ~10 units out) and cancels
near grazing incidence: its rounding moves t by an amount that does not
scale with t, so the bound is absolute. Measured on this data: the largest
|t difference| is 5.5e-4 for the Morton sweep (72 of 278 hits differ) and
5.7e-4 for the brute-force sweep (258 of 278); above t = 1 the largest
relative difference is 1.4e-4. The largest relative one, 1.75e-3, is a
hit at t = 0.0066, where it is 1.2e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import clusters as jclusters
from drts_tpu.ops import intersect_pallas as ip
from drts_tpu.utils import math as jm
from drts_tpu_torch import backend, convert
from drts_tpu_torch.models import clusters as tclusters
from drts_tpu_torch.ops import intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik


@pytest.fixture(scope="module")
def case():
    """tests/test_post_denoise.py's setup: 53 spheres, 4096 random rays."""
    rng = np.random.RandomState(7)
    k = 53
    centers = np.asarray(rng.randn(k, 3) * 6, np.float32)
    radii = np.asarray(0.2 + rng.rand(k), np.float32)
    n = 4096
    o = jnp.asarray(rng.randn(n, 3) * 10, jnp.float32)
    d = jm.normalize(jnp.asarray(rng.randn(n, 3), jnp.float32))
    rays, _ = ip.pack_rays(o, d, jnp.zeros(n), jnp.full((n,), 1e9))
    return centers, radii, n, rays, torch.from_numpy(np.array(rays)[:, :n])


def assert_hits_match(t_port, i_port, t_ref, i_ref):
    t_port, i_port = t_port.numpy(), i_port.numpy()
    fin = np.isfinite(t_ref)
    np.testing.assert_array_equal(np.isfinite(t_port), fin)
    np.testing.assert_array_equal(i_port, i_ref)
    np.testing.assert_allclose(t_port[fin], t_ref[fin], rtol=0, atol=7e-4)
    assert 0.05 < fin.mean() < 0.95


def test_morton_plain_matches_pallas(case):
    centers, radii, n, rays, trays = case
    plan = jclusters.build_plan_morton(centers, radii, max_members=8)
    origin = jnp.asarray([3.0, -2.0, 7.0])
    acc = jclusters.make_morton_accel(plan, jnp.asarray(centers),
                                      jnp.asarray(radii), sort_origin=origin)
    t_ref, i_ref = ip.intersect_morton_planar(
        rays, acc.bounds_tbl, acc.table, acc.n_chunks, acc.chunk,
        interpret=True)
    t_ref, i_ref = np.asarray(t_ref)[:n], np.asarray(i_ref)[:n]

    # Same table through convert, and the port's own build of it.
    for accel in (convert.morton_accel(acc, "cpu"),
                  tclusters.make_morton_accel(
                      convert.cluster_plan(plan, "cpu"),
                      torch.from_numpy(centers),
                      torch.from_numpy(radii),
                      sort_origin=torch.tensor([3.0, -2.0, 7.0]))):
        table = accel.table
        t, i = ik.intersect_morton(trays, table, accel.bounds)
        assert t.dtype == torch.float32 and i.dtype == torch.int32
        assert_hits_match(t, i, t_ref, i_ref)
        # t is truncated down to the packed precision: low bits are zero.
        low = (1 << ik.pos_bits(table.shape[1])) - 1
        assert not (t.view(torch.int32) & low).any()


def test_brute_plain_matches_pallas(case):
    centers, radii, n, rays, trays = case
    table = ip.pack_spheres(jnp.asarray(centers), jnp.asarray(radii))
    t_ref, i_ref = ip.intersect_spheres_planar(rays, table, interpret=True)
    spheres = tintersect.pack_spheres(torch.from_numpy(centers),
                                      torch.from_numpy(radii))
    t, i = ik.intersect_brute(trays, spheres, block=1000)
    assert_hits_match(t, i, np.asarray(t_ref)[:n], np.asarray(i_ref)[:n])


def test_brute_ties_go_to_lowest_index():
    """Spheres 1 and 2 coincide: the ray through them reports 1. The last
    column is padding (r = 0) at the same place and never wins."""
    spheres = torch.tensor([[5.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                            [5.0, 5.0, 5.0, 5.0], [1.0, 1.0, 1.0, 0.0]])
    rays = torch.tensor([[0.0, 5.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0],
                         [0.0, 0.0], [1.0, 1.0], [0.0, 0.0], [1e9, 1e9]])
    t, i = ik.intersect_brute(rays, spheres)
    assert i.tolist() == [1, 0] and t.tolist() == [4.0, 4.0]


def test_cpu_tensor_takes_plain_version_without_launch(case):
    _, _, n, _, trays = case
    spheres = torch.tensor([[0.0], [0.0], [0.0], [1.0]])
    accel = tclusters.make_morton_accel(
        tclusters.build_plan_morton(np.zeros((1, 3), np.float32),
                                    np.ones(1, np.float32), max_members=8,
                                    device="cpu"),
        torch.zeros((1, 3)), torch.ones(1))
    before = dict(backend.LAUNCHES)
    ik.intersect_brute(trays, spheres)
    ik.intersect_morton(trays, accel.table, accel.bounds)
    assert backend.LAUNCHES == before


def test_kernel_request_without_cuda_raises(case):
    """No fallback: without a card the CUDA device cannot be chosen, and a
    tensor on any other non-CPU device is refused, not computed."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; chip_smoke.py checks the "
                    "kernels there")
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.device("cuda")
    _, _, _, _, trays = case
    meta = trays.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ik.intersect_brute(meta, torch.zeros((4, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ik.intersect_morton(meta, torch.zeros((9, 8), device="meta"),
                            torch.zeros((5, 1), device="meta"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Where no CUDA compiler exists, building the kernels raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(backend, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        backend.build()


def test_wrappers_check_shapes(case):
    _, _, _, _, trays = case
    with pytest.raises(ValueError, match=r"\(9, N\)"):
        ik.intersect_morton(trays, torch.zeros((4, 8)), torch.zeros((5, 1)))
    with pytest.raises(ValueError, match=r"\(5, N\)"):
        ik.intersect_morton(trays, torch.zeros((9, 8)), torch.zeros((4, 1)))
    with pytest.raises(ValueError, match="divide"):
        ik.intersect_morton(trays, torch.zeros((9, 8)), torch.zeros((5, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        ik.intersect_brute(trays.T.contiguous().T, torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="float32"):
        ik.intersect_brute(trays.double(), torch.zeros((4, 8)))


def port_accel(case, members=8):
    centers, radii, _, _, _ = case
    plan = tclusters.build_plan_morton(centers, radii, max_members=members,
                                       device="cpu")
    return tclusters.make_morton_accel(
        plan, torch.from_numpy(centers), torch.from_numpy(radii),
        sort_origin=torch.tensor([3.0, -2.0, 7.0]))


def half_infinite(rays):
    """The rays with every other tmax set to +inf, as primary and bounce
    rays carry it."""
    rays = rays.clone()
    rays[7, ::2] = torch.where(rays[7, ::2] >= rays[6, ::2], float("inf"),
                               rays[7, ::2])
    return rays


@pytest.mark.parametrize("kind", ["random", "tangent", "tangent-no-margin"])
def test_closest_cull_never_skips_the_winner(case, kind, monkeypatch):
    """B1's walk meets the chunk that holds each ray's packed winner, so its
    best equals the unculled sweep's bit for bit: on the file's rays and on
    rays tangent to chunk bounds refit with no slack, half of them with
    tmax = inf. Without the rounding margin the tangent case does skip
    winners: it tests the margin. On the random rays the cull skips at
    least 30% of the chunk tests."""
    if kind == "random":
        accel = port_accel(case)
        bounds, rays = accel.bounds, half_infinite(case[4])
    else:
        from test_torch_cuda import tangent_case
        accel, bounds, rays9 = tangent_case(400, seed=400)
        rays = half_infinite(rays9[:8])
    if kind == "tangent-no-margin":
        monkeypatch.setattr(ik, "CULL_SCALE", 0.0)
    assert bool(torch.isinf(rays[7]).any())
    n, chunk = rays.shape[1], accel.chunk
    trunc = ~((1 << ik.pos_bits(accel.table.shape[1])) - 1)
    per_chunk = ik.closest_pairs(rays, accel.table, trunc)[0].reshape(
        n, -1, chunk).amin(-1)
    t, obj = ik.intersect_morton_plain(rays, accel.table)
    hit = torch.isfinite(t)
    winner = per_chunk.argmin(1)
    assert torch.equal(per_chunk.amin(1)[hit], (t.view(torch.int32)
                                                | obj)[hit])
    met, best, _ = ik.closest_chunk_walk(rays, accel.table, bounds)
    skipped = int((hit & ~met[torch.arange(n), winner]).sum())
    assert int(hit.sum()) > 50
    if kind == "tangent-no-margin":
        assert skipped > 0
    else:
        assert skipped == 0
        assert torch.equal(best, torch.where(hit, t.view(torch.int32) | obj,
                                             ik.INF_BITS))
    if kind == "random":
        live = rays[7] >= rays[6]
        assert float(met[live].float().mean()) <= 0.7


def test_closest_work_counts_the_kernels_walk(case):
    """intersect_morton_work equals a lane-by-lane walk of the kernel's
    loops on 400 of the file's rays (half with tmax = inf, some dead),
    written out here in float32 scalars: chunks in table order, the cull
    against [tmin, t_end] with t_end from the packed best, filled slots,
    the roots of the swept pairs whose discriminant is not negative; and
    the walk sweeps well under the unculled table."""
    accel = port_accel(case)
    rays = half_infinite(case[4][:, :400])
    rays[7, 1::7] = -1.0
    table, bounds = accel.table, accel.bounds
    tests, met_n, pairs, roots = ik.intersect_morton_work(rays, table,
                                                          bounds, block=128)
    trunc = ~((1 << ik.pos_bits(table.shape[1])) - 1)
    packed, root = (x.numpy() for x in ik.closest_pairs(rays, table, trunc))
    f = np.float32
    scale = f(ik.CULL_SCALE)
    b = bounds.numpy()
    want = []
    for i in range(rays.shape[1]):
        ox, oy, oz, dx, dy, dz, tmin, tmax = (f(x) for x in rays[:, i])
        walk = [0, 0, 0, 0]
        if tmax >= tmin:
            dd = dx * dx + dy * dy + dz * dz
            dev = abs(dd - f(1.0))
            slope = (f(1.125) * (np.sqrt(dev) + scale)
                     if dev <= f(2.0 ** -8) else f(np.inf))
            m_o = scale * (abs(ox) + abs(oy) + abs(oz))
            inv_dd = f(1.0) / dd
            best = ik.INF_BITS
            for k in range(accel.n_chunks):
                walk[0] += 1
                t_end = tmax
                if 0 <= best < ik.INF_BITS:
                    top = np.array((best & trunc) | ~trunc,
                                   np.int32).view(np.float32)[()]
                    t_end = np.fmin(tmax, top)
                bx, by, bz, br, cnt = b[:, k]
                bw = br + scale * (abs(bx) + abs(by) + abs(bz) + br)
                vx, vy, vz = bx - ox, by - oy, bz - oz
                s_star = (vx * dx + vy * dy + vz * dz) * inv_dd
                s = np.fmin(np.fmax(s_star, tmin), t_end)
                wx, wy, wz = vx - s * dx, vy - s * dy, vz - s * dz
                e = bw + m_o
                lim = e + slope * (abs(s_star) + e)
                if wx * wx + wy * wy + wz * wz > lim * lim:
                    continue
                walk[1] += 1
                walk[2] += int(cnt)
                c0 = k * accel.chunk
                walk[3] += int(root[i, c0:c0 + int(cnt)].sum())
                best = min(best, int(packed[i, c0:c0 + int(cnt)].min()))
        want.append(walk)
    got = torch.stack([tests, met_n, pairs, roots], 1)
    assert torch.equal(got, torch.tensor(want))
    live = rays[7] >= rays[6]
    assert bool((tests[~live] == 0).all())
    assert float(pairs[live].float().mean()) < 0.7 * table.shape[1]
    assert 0 < int(roots.sum()) < 0.5 * int(pairs.sum())
