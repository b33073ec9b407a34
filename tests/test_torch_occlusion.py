"""The port's any-hit kernel (B2) plain version against the reference's
Pallas ``occlusion_morton_planar`` in interpret mode, the port's
visibility ray (``intersect.intersect_spheres_any``, ``trace.occluded_scene``)
around it, and the chunk bounds and culls of the kernel (``MortonAccel.bounds``
against the reference's ``bounds_tbl``, ``occlusion_chunk_met``,
``occlusion_morton_work``).

Tolerance: the occluded bits are equal. A bit could flip only where a hit
t lands within rounding of a ray's tmin or tmax (XLA:CPU contracts the
quadratic's multiply-adds into FMAs, the port rounds each operation);
measured on this data: 0 of 4,096 bits differ, with and without excluded
objects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import clusters as jclusters
from drts_tpu.ops import intersect_pallas as ip
from drts_tpu.utils import math as jm
from drts_tpu_torch import backend, convert
from drts_tpu_torch.models import clusters as tclusters, scene as tscene
from drts_tpu_torch.ops import intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik
from drts_tpu_torch.ops import trace as ttrace


@pytest.fixture(scope="module")
def case():
    """53 spheres, 4,096 shadow rays of random length (a fifth dead)."""
    rng = np.random.RandomState(11)
    k, n = 53, 4096
    centers = np.asarray(rng.randn(k, 3) * 6, np.float32)
    radii = np.asarray(0.2 + rng.rand(k), np.float32)
    o = jnp.asarray(rng.randn(n, 3) * 10, jnp.float32)
    # Half the rays aim at a sphere, so exclusion decides many of them.
    target = rng.randint(0, k, n)
    aim = jnp.asarray(centers[target]) - o
    d = jnp.asarray(rng.randn(n, 3), jnp.float32)
    d = jm.normalize(jnp.where((np.arange(n) % 2 == 0)[:, None], aim, d))
    tmax = np.where(rng.rand(n) < 0.2, -1.0, 5.0 + 25.0 * rng.rand(n))
    rays, _ = ip.pack_rays(o, d, jnp.zeros(n), jnp.asarray(tmax, jnp.float32))
    plan = jclusters.build_plan_morton(centers, radii, max_members=8)
    acc = jclusters.make_morton_accel(plan, jnp.asarray(centers),
                                      jnp.asarray(radii),
                                      sort_origin=jnp.asarray([1.0, 2.0, 3.0]))
    exclude = np.where(np.arange(n) % 2 == 0, target, -1).astype(np.float32)
    return centers, radii, n, rays, acc, plan, exclude


def port_accel(case):
    centers, radii, _, _, _, plan, _ = case
    return tclusters.make_morton_accel(
        convert.cluster_plan(plan, "cpu"), torch.from_numpy(centers),
        torch.from_numpy(radii), sort_origin=torch.tensor([1.0, 2.0, 3.0]))


def case_rays9(case):
    _, _, n, rays, _, _, exclude = case
    return torch.from_numpy(np.concatenate(
        [np.asarray(rays)[:, :n], exclude[None]]).astype(np.float32))


def reference(rays, acc, exclude_row):
    rays9 = jnp.concatenate([rays, jnp.asarray(exclude_row)[None, :]])
    occ = ip.occlusion_morton_planar(rays9, acc.bounds_tbl, acc.table,
                                     acc.n_chunks, acc.chunk, interpret=True)
    return np.asarray(occ)


@pytest.mark.parametrize("with_exclude", [True, False])
def test_plain_matches_pallas(case, with_exclude):
    centers, radii, n, rays, acc, plan, exclude = case
    n_pad = rays.shape[1]
    row = np.full(n_pad, -1.0, np.float32)
    if with_exclude:
        row[:n] = exclude
    ref = reference(rays, acc, row)[:n]
    rays9 = torch.from_numpy(np.concatenate([np.asarray(rays), row[None]])
                             [:, :n].copy())
    for accel in (convert.morton_accel(acc, "cpu"), port_accel(case)):
        occ = ik.occlusion_morton(rays9, accel.table, accel.bounds,
                                  block=1000)
        assert occ.dtype == torch.bool
        np.testing.assert_array_equal(occ.numpy(), ref)
    live = np.asarray(rays)[7, :n] >= 0
    assert 0.05 < ref[live].mean() < 0.95
    assert not ref[~live].any(), "dead lanes are never occluded"


def test_exclusion_changes_the_answer(case):
    """Rays aimed at their excluded sphere: excluding it unblocks some."""
    _, _, n, rays, acc, _, exclude = case
    with_ex = np.full(rays.shape[1], -1.0, np.float32)
    with_ex[:n] = exclude
    a = reference(rays, acc, with_ex)[:n]
    b = reference(rays, acc, np.full(rays.shape[1], -1.0, np.float32))[:n]
    assert (b & ~a).sum() > 50 and not (a & ~b).any()


def test_visibility_ray_entry_points(case):
    """intersect_spheres_any and trace.occluded_scene pack (H, W) rays and
    reach the same kernel; without a Morton accel they take the
    reference's other function, the closest hit then the exclusion."""
    centers, radii, n, rays, acc, plan, exclude = case
    r = np.asarray(rays)[:, :n]
    o = torch.from_numpy(r[0:3].T.copy()).reshape(64, 64, 3)
    d = torch.from_numpy(r[3:6].T.copy()).reshape(64, 64, 3)
    tmax = torch.from_numpy(r[7].copy()).reshape(64, 64)
    ex = torch.from_numpy(exclude).reshape(64, 64).long()
    accel = convert.morton_accel(acc, "cpu")
    got = tintersect.intersect_spheres_any(o, d, 0.0, tmax, 4096,
                                           exclude_index=ex, accel=accel)
    rays9 = torch.from_numpy(np.concatenate([r, exclude[None]]))
    want = ik.occlusion_morton_plain(rays9, accel.table,
                                     accel.bounds).reshape(64, 64)
    assert torch.equal(got, want)
    sc = tscene.SphereScene(
        center=torch.from_numpy(centers), rotation=None, prev_center=None,
        prev_rotation=None, radius=torch.from_numpy(radii), materials=None,
        env=None)
    assert torch.equal(ttrace.occluded_scene(sc, o, d, tmax, ex, 4096,
                                             accel=accel), want)
    # Without an accel: the closest sphere (B11), blocked where it is not
    # the excluded one. Equal to the reference's same branch (its XLA
    # sweep; measured: 0 of 4,096 bits differ).
    import drts_tpu.ops.intersect as jintersect
    brute = tintersect.intersect_spheres_any(
        o, d, 0.0, tmax, 4096, exclude_index=ex, accel=None,
        centers=torch.from_numpy(centers), radii=torch.from_numpy(radii))
    saved, jintersect.BACKEND = jintersect.BACKEND, "xla"
    try:
        ref = np.asarray(jintersect.intersect_spheres_any(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0.0,
            jnp.asarray(tmax.numpy()), jnp.asarray(centers),
            jnp.asarray(radii), 4096, exclude_index=jnp.asarray(ex.numpy())))
    finally:
        jintersect.BACKEND = saved
    np.testing.assert_array_equal(brute.numpy(), ref)
    # A ray whose closest sphere is the excluded one passes, whatever lies
    # behind it: the any-hit kernel over the table blocks more, never less.
    assert 0.05 < brute.float().mean() < 0.95
    assert not bool((brute & ~want).any())
    assert torch.equal(ttrace.occluded_scene(sc, o, d, tmax, ex, 4096), brute)
    with pytest.raises(ValueError, match="centers"):
        tintersect.intersect_spheres_any(o, d, 0.0, tmax, accel=None)


def test_cpu_tensor_takes_plain_version_without_launch(case):
    _, _, n, rays, acc, _, exclude = case
    rays9 = torch.zeros((9, 8))
    accel = convert.morton_accel(acc, "cpu")
    before = dict(backend.LAUNCHES)
    ik.occlusion_morton(rays9, accel.table, accel.bounds)
    assert backend.LAUNCHES == before
    with pytest.raises(ValueError, match=r"\(9, N\)"):
        ik.occlusion_morton(torch.zeros((8, 8)), accel.table, accel.bounds)
    with pytest.raises(ValueError, match="unsupported device"):
        ik.occlusion_morton(rays9.to("meta"),
                            torch.zeros((9, 8), device="meta"),
                            torch.zeros((5, 1), device="meta"))
    with pytest.raises(ValueError, match=r"\(5, N\)"):
        ik.occlusion_morton(rays9, accel.table, accel.bounds[:4])
    with pytest.raises(ValueError, match="divide"):
        ik.occlusion_morton(rays9, accel.table,
                            accel.bounds[:, :-1].contiguous())


def test_bounds_match_reference(case):
    """MortonAccel.bounds rows 0-3 are the reference's bounds_tbl without
    its padding columns, both as converted and as the port's own refit
    builds them (the refit's sums round in another order: 1e-6 relative,
    2e-6 absolute); row 4 is each chunk's filled-slot count, in the
    table's sorted chunk order."""
    _, _, _, _, acc, plan, _ = case
    ref = np.asarray(acc.bounds_tbl)[:, :acc.n_chunks]
    mine = port_accel(case)
    conv = convert.morton_accel(acc, "cpu")
    assert conv.bounds.shape == mine.bounds.shape == (5, acc.n_chunks)
    np.testing.assert_array_equal(conv.bounds[:4].numpy(), ref)
    np.testing.assert_allclose(mine.bounds[:4].numpy(), ref, rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_array_equal(mine.bounds[4].numpy(),
                                  conv.bounds[4].numpy())
    filled = np.asarray(acc.table)[3].reshape(acc.n_chunks, acc.chunk) > 0
    np.testing.assert_array_equal(conv.bounds[4].numpy(), filled.sum(1))
    assert sorted(conv.bounds[4].tolist()) == sorted(
        (np.asarray(plan.member_object) >= 0).sum(1).tolist())


@pytest.mark.parametrize("kind", ["random", "tangent", "tangent-no-margin"])
def test_cull_never_skips_a_blocker(case, kind, monkeypatch):
    """No chunk that holds a blocking slot fails B2's cull: on the file's
    case, and on rays tangent to chunk bounds refit with no slack (their
    distance to the bound's centre within 1 ulp of its radius), where the
    rounding margin alone keeps the touching sphere's chunk. Without that
    margin the tangent case does skip blockers: it tests the margin."""
    if kind == "random":
        accel, rays9 = port_accel(case), case_rays9(case)
        bounds = accel.bounds
    else:
        from test_torch_cuda import tangent_case
        accel, bounds, rays9 = tangent_case(400, seed=400)
    if kind == "tangent-no-margin":
        monkeypatch.setattr(ik, "CULL_SCALE", 0.0)
    n, chunk = rays9.shape[1], accel.chunk
    holds = ik.occlusion_pair_blocked(rays9, accel.table)
    holds = holds.reshape(n, -1, chunk)
    holds = holds.any(-1) & (rays9[7] >= rays9[6])[:, None]
    met = ik.occlusion_chunk_met(rays9, bounds)
    skipped = int((holds & ~met).sum())
    assert int(holds.sum()) > 50
    if kind == "tangent-no-margin":
        assert skipped > 0
    else:
        assert skipped == 0
        assert float(met.float().mean()) < 0.7   # the cull does cull


def test_work_counts_the_kernels_walk(case):
    """occlusion_morton_work equals a lane-by-lane walk of the kernel's
    loops (chunks in table order, the cull, filled slots, the exit at the
    first blocker) on 400 of the file's rays, and a walk stops no later
    than the unculled sweep would (and, on average, well before)."""
    accel, rays9 = port_accel(case), case_rays9(case)[:, :400].contiguous()
    tests, met_n, pairs = ik.occlusion_morton_work(rays9, accel.table,
                                                   accel.bounds, block=128)
    met = ik.occlusion_chunk_met(rays9, accel.bounds)
    blocked = ik.occlusion_pair_blocked(rays9, accel.table)
    count = accel.bounds[4].long().tolist()
    want = []
    for i in range(rays9.shape[1]):
        walk = [0, 0, 0]
        if rays9[7, i] >= rays9[6, i]:
            for k in range(accel.n_chunks):
                walk[0] += 1
                if not met[i, k]:
                    continue
                walk[1] += 1
                hit = blocked[i, k * accel.chunk:k * accel.chunk + count[k]]
                if bool(hit.any()):
                    walk[2] += int(hit.to(torch.uint8).argmax()) + 1
                    break
                walk[2] += count[k]
        want.append(walk)
    got = torch.stack([tests, met_n, pairs], 1)
    assert torch.equal(got, torch.tensor(want))
    live = rays9[7] >= rays9[6]
    first = torch.where(blocked.any(1),
                        blocked.to(torch.uint8).argmax(1) + 1,
                        accel.table.shape[1])
    assert bool((pairs[live] <= first[live]).all())
    assert float(pairs[live].float().mean()) < 0.7 * float(
        first[live].float().mean())
