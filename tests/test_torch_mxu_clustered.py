"""The reference's other two sphere-accel routes in the port: the clustered
accel with its cluster-culled kernel (B13) and the MXU opt-in with its
tensor-core Morton kernels (B12a closest hit, B12b any hit).

The tables (``build_plan``, ``pack_for_kernel``, ``make_accel``,
``make_mxu_tables``) against the reference's; the kernels' plain versions
against the reference's Pallas kernels in interpret mode (its XLA path
never runs them), on tests/test_post_denoise.py's data cut to one
RAY_BLOCK (2048 rays), 53 spheres, 8 per chunk; the routes
(``intersect_spheres``, ``intersect_spheres_any``) against the
reference on its XLA path, and ``trace_image`` against the reference's
frame on each route.

Tolerances:
- tables: integers and gathered floats exact; refit bounds and
  |c|^2 - r^2 within 1e-6 relative (XLA:CPU contracts multiply-adds into
  FMAs, the port rounds each operation);
- B13: hit/miss and the index equal on every ray, t within 7e-4 absolute
  (tests/test_torch_intersect.py states why the bound is absolute);
- B12a/B12b against interpret mode: both take the same bf16 halves and
  exact products, summed in another order. Hit/miss may flip only where
  a sphere is within 1e-3 of grazing and on < 0.5% of rays; t within 1e-4
  relative where none is within 3e-2, the index equal there (measured
  here: no flip in either kernel, t within 7.1e-6 relative, 94% of hits
  bit-equal; the reference's margins for its MXU kernel,
  tests/test_post_denoise.py:292-310, are rtol 1e-3, atol 1e-2);
- the MXU route against the XLA path's exact closest hit: the
  reference's margins (flips under 1e-3 of grazing, < 0.5% of rays; t
  within rtol 1e-3, atol 1e-2 away from grazing);
- trace_image at 32x32, 2 bounces, against the reference's frame on the
  same route: radiance within 1e-3 on >= 99.5% of pixels
  (tests/test_torch_pathtrace.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import clusters as jclusters, myscene as jmyscene
from drts_tpu.ops import camera as jcamera, intersect as jintersect
from drts_tpu.ops import intersect_pallas as ip, pathtrace as jpathtrace
from drts_tpu.utils import math as jm
from drts_tpu_torch import backend, convert
from drts_tpu_torch.models import clusters as tclusters
from drts_tpu_torch.ops import intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik
from drts_tpu_torch.ops import pathtrace as tpathtrace


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs six workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """53 spheres and 2048 random rays (tests/test_post_denoise.py's seed
    and scales), the reference's Morton accel at 8 per chunk and its
    clustered accel, and the grazing margin of each ray."""
    rng = np.random.RandomState(7)
    k = 53
    centers = np.asarray(rng.randn(k, 3) * 6, np.float32)
    radii = np.asarray(0.2 + rng.rand(k), np.float32)
    n = ip.RAY_BLOCK
    o = jnp.asarray(rng.randn(n, 3) * 10, jnp.float32)
    d = jm.normalize(jnp.asarray(rng.randn(n, 3), jnp.float32))
    rays, _ = ip.pack_rays(o, d, jnp.zeros(n), jnp.full((n,), 1e9))
    plan = jclusters.build_plan_morton(centers, radii, max_members=8)
    cplan = jclusters.build_plan(centers, radii)
    # Jitted: one compile instead of one per eager operation.
    macc, cacc = jax.jit(lambda c, r: (
        jclusters.make_morton_accel(plan, c, r),
        jclusters.make_accel(cplan, c, r)))(centers, radii)
    oc = np.asarray(o)[:, None, :] - centers[None]
    dn = np.asarray(d)[:, None, :]
    perp = oc - (oc * dn).sum(-1, keepdims=True) * dn
    graze = np.abs(np.linalg.norm(perp, axis=-1) - radii[None]).min(1)
    return dict(centers=centers, radii=radii, n=n, rays=rays,
                trays=torch.from_numpy(np.array(rays)), plan=plan,
                macc=macc, cacc=cacc, graze=graze,
                o=np.array(o), d=np.array(d))


def port_morton(c, monkeypatch, mxu=True):
    """The port's Morton accel for the case, built under the MXU opt-in
    (or without it)."""
    monkeypatch.setattr(tclusters, "_USE_MXU", mxu)
    return tclusters.make_morton_accel(
        convert.cluster_plan(c["plan"], "cpu"), torch.from_numpy(c["centers"]),
        torch.from_numpy(c["radii"]))


def port_clustered(c):
    plan = tclusters.build_plan(c["centers"], c["radii"], device="cpu")
    return tclusters.make_accel(plan, torch.from_numpy(c["centers"]),
                                torch.from_numpy(c["radii"]))


# ----------------------------------------------------------------------------
# The tables


def _bins_case():
    """100 spheres: 60 in one 4x4 cell of the xz plane, 58 of them small
    (a bin of more than 32), 5 larger than half a cell (singletons), the
    rest spread."""
    rng = np.random.RandomState(3)
    pos = np.asarray(rng.randn(100, 3) * 10, np.float32)
    pos[:60, 0] = 4.0 + 3.9 * rng.rand(60)
    pos[:60, 2] = -8.0 + 3.9 * rng.rand(60)
    radii = np.asarray(0.1 + 0.5 * rng.rand(100), np.float32)
    radii[[3, 17, 61, 80, 99]] = 2.5
    return pos, radii


@pytest.mark.parametrize("which", ["demo", "bins"])
def test_build_plan_matches_reference(which):
    """build_plan bit for bit: the demo scene's rest pose (438 spheres),
    and a set with a bin of 58 small spheres (split into runs of 32 and
    26) and five big spheres (singletons)."""
    if which == "demo":
        scene = jmyscene.build().scene
        pos, radii = np.asarray(scene.center), np.asarray(scene.radius)
    else:
        pos, radii = _bins_case()
    ref = jclusters.build_plan(pos, radii)
    got = tclusters.build_plan(pos, radii, device="cpu")
    assert got.num_clusters == ref.num_clusters
    np.testing.assert_array_equal(got.member_object.numpy(),
                                  ref.member_object)
    if which == "bins":
        sizes = (ref.member_object >= 0).sum(1)
        assert sizes.max() == jclusters.MAX_MEMBERS and 26 in sizes
        assert (sizes == 1).sum() >= 5


def test_pack_for_kernel_and_make_accel_match_reference():
    """pack_for_kernel and make_accel against the reference's on the bins
    case: the member table exactly (gathered centres and radii, object
    ids), the refit bounds within 1e-6 relative, the counts equal."""
    pos, radii = _bins_case()
    plan = jclusters.build_plan(pos, radii)
    (jbt, jmt), jacc = jax.jit(lambda p, r: (
        jclusters.pack_for_kernel(plan, jclusters.refit(plan, p, r), p, r),
        jclusters.make_accel(plan, p, r)))(pos, radii)
    tplan = tclusters.build_plan(pos, radii, device="cpu")
    tp, tr = torch.from_numpy(pos), torch.from_numpy(radii)
    tbt, tmt = tclusters.pack_for_kernel(
        tplan, tclusters.refit(tplan, tp, tr), tp, tr)
    tacc = tclusters.make_accel(tplan, tp, tr)
    assert tbt.shape == tuple(jbt.shape) == (4, 8 * -(-plan.num_clusters
                                                      // 8))
    for bt, mt in ((tbt, tmt), (tacc.bounds_tbl, tacc.members_tbl)):
        np.testing.assert_array_equal(mt.numpy(), np.asarray(jmt))
        np.testing.assert_allclose(bt.numpy(), np.asarray(jbt), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(tacc.members_tbl.numpy(),
                                  np.asarray(jacc.members_tbl))
    assert (tacc.n_clusters, tacc.max_members) == (jacc.n_clusters,
                                                   jacc.max_members)


def test_clustered_filled_matches_reference_member_counts():
    """clustered_filled (the slots B13's sweep stops at: the last r > 0
    slot plus one) on the reference's own member table equals the member
    counts of its plan, bit for bit: the bins case holds a full cluster
    (32), a run of 26 and five singletons."""
    pos, radii = _bins_case()
    plan = jclusters.build_plan(pos, radii)
    _, members = jax.jit(lambda p, r: jclusters.pack_for_kernel(
        plan, jclusters.refit(plan, p, r), p, r))(pos, radii)
    got = ik.clustered_filled(torch.from_numpy(np.array(members)),
                              plan.num_clusters, jclusters.MAX_MEMBERS)
    want = (plan.member_object >= 0).sum(1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert {1, 26, jclusters.MAX_MEMBERS} <= set(want.tolist())


def test_make_mxu_tables_matches_reference(case, monkeypatch):
    """make_mxu_tables from the port's Morton table against the
    reference's A-matrices, and make_morton_accel under the opt-in carries
    them:
    every entry but |c|^2 - r^2 exact, that one within 1e-6 relative."""
    acc = port_morton(case, monkeypatch)
    ref = np.asarray(case["macc"].mxu_a)
    for a in (acc.mxu_a, tclusters.make_mxu_tables(acc.table, acc.n_chunks,
                                                   acc.chunk)):
        a = a.numpy()
        assert a.shape == ref.shape
        np.testing.assert_array_equal(a[:, :7], ref[:, :7])
        np.testing.assert_allclose(a[:, 7], ref[:, 7], rtol=1e-6, atol=1e-6)


def test_opt_in_off_builds_no_mxu_tables(case, monkeypatch):
    """Without the opt-in make_morton_accel builds no A-matrices and the
    same table, and the Morton route runs B1's plain version unchanged:
    the same words as intersect_morton on the table built with them."""
    on = port_morton(case, monkeypatch)
    off = port_morton(case, monkeypatch, mxu=False)
    assert off.mxu_a is None
    assert torch.equal(off.table, on.table)
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    c, r = torch.from_numpy(case["centers"]), torch.from_numpy(case["radii"])
    hit = tintersect.intersect_spheres(o, d, 0.0, 1e9, c, r, accel=off)
    t, i = ik.intersect_morton(case["trays"], on.table, on.bounds)
    assert torch.equal(hit.t.view(torch.int32), t.view(torch.int32))
    assert torch.equal(hit.index, i.long())


# ----------------------------------------------------------------------------
# The kernels' plain versions against the reference's Pallas kernels


def test_clustered_plain_matches_interpret(case):
    acc = case["cacc"]
    t_ref, i_ref = ip.intersect_clustered_planar(
        case["rays"], acc.bounds_tbl, acc.members_tbl, acc.n_clusters,
        acc.max_members, interpret=True)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    tacc = port_clustered(case)
    t, i = ik.intersect_clustered(case["trays"], tacc.bounds_tbl,
                                  tacc.members_tbl, tacc.n_clusters,
                                  tacc.max_members, block=500)
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    fin = np.isfinite(t_ref)
    assert 0.02 < fin.mean() < 0.95
    np.testing.assert_array_equal(np.isfinite(t.numpy()), fin)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(t.numpy()[fin], t_ref[fin], rtol=0, atol=7e-4)


def assert_mxu_matches(flip, t, t_ref, idx, i_ref, graze, rtol, atol):
    assert flip.mean() < 0.005 and (graze[flip] < 1e-3).all()
    strict = graze > 3e-2
    assert strict.mean() > 0.9
    both = np.isfinite(t) & np.isfinite(t_ref) & strict
    np.testing.assert_allclose(t[both], t_ref[both], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(idx[both], i_ref[both])


def test_mxu_closest_plain_matches_interpret(case, monkeypatch):
    macc = case["macc"]
    t_ref, i_ref = ip.intersect_morton_mxu(
        case["rays"], macc.bounds_tbl, macc.table, macc.mxu_a,
        macc.n_chunks, macc.chunk, interpret=True)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    acc = port_morton(case, monkeypatch)
    t, i = ik.intersect_morton_mxu(case["trays"], acc.table, acc.bounds,
                                   acc.mxu_a, block=500)
    t, i = t.numpy(), i.numpy()
    flip = np.isfinite(t) != np.isfinite(t_ref)
    assert np.isfinite(t_ref).mean() > 0.02
    assert_mxu_matches(flip, t, t_ref, i, i_ref, case["graze"], 1e-4, 0.0)


def test_mxu_occlusion_plain_matches_interpret(case, monkeypatch):
    """B12b with every third ray excluding its closest sphere and a
    finite range (tmax 25 x a uniform number)."""
    macc = case["macc"]
    n = case["n"]
    rng = np.random.RandomState(11)
    rays = np.array(case["rays"])
    rays[7] = 25.0 * rng.rand(n)
    t_x, i_x = ip.intersect_morton_planar(
        jnp.asarray(rays[:8]), macc.bounds_tbl, macc.table, macc.n_chunks,
        macc.chunk, interpret=True)
    exclude = np.where(np.arange(n) % 3 == 0,
                       np.where(np.isfinite(np.asarray(t_x)), i_x, -1), -1)
    rays9 = np.concatenate([rays, exclude[None].astype(np.float32)])
    occ_ref = np.asarray(ip.occlusion_morton_mxu(
        jnp.asarray(rays9), macc.bounds_tbl, macc.table, macc.mxu_a,
        macc.n_chunks, macc.chunk, interpret=True))
    acc = port_morton(case, monkeypatch)
    occ = ik.occlusion_morton_mxu(torch.from_numpy(rays9), acc.table,
                                  acc.bounds, acc.mxu_a, block=500).numpy()
    assert 0.02 < occ_ref.mean() < 0.95
    flip = occ != occ_ref
    assert flip.mean() < 0.005 and (case["graze"][flip] < 1e-3).all()


# ----------------------------------------------------------------------------
# The routes against the reference's XLA path


@pytest.mark.parametrize("route", ["clustered", "mxu"])
def test_routes_match_xla(case, route, monkeypatch):
    """intersect_spheres and intersect_spheres_any with a ClusteredAccel,
    and with the MXU opt-in and a MortonAccel, against the reference's
    XLA path (brute force; the accel is a TPU aid there). The clustered
    any hit is the closest hit's, every second ray excluding its closest
    sphere; the MXU any hit is B12b's, which excludes nothing here (where
    the reference's two any-hit functions agree)."""
    o, d = case["o"], case["d"]
    c, r = case["centers"], case["radii"]
    n = case["n"]
    tmax = np.asarray(30.0 * np.random.RandomState(5).rand(n), np.float32)

    @jax.jit
    def reference(o, d, c, r, tmax, excl):
        hit = jintersect.intersect_spheres(o, d, 0.0, 1e9, c, r)
        occ = jintersect.intersect_spheres_any(
            o, d, 0.0, tmax, c, r,
            exclude_index=jnp.where(excl, hit.index, -1))
        return hit.t, hit.index, occ

    args = (torch.from_numpy(o), torch.from_numpy(d), 0.0)
    tc, tr = torch.from_numpy(c), torch.from_numpy(r)
    # The clustered any hit excludes every second ray's closest sphere.
    excl = (np.arange(n) % 2 == 0) & (route == "clustered")
    t_ref, i_ref, occ_ref = (np.asarray(x) for x in reference(
        o, d, c, r, tmax, excl))
    exclude = np.where(excl, i_ref, -1).astype(np.int32)
    if route == "clustered":
        acc = port_clustered(case)
    else:
        acc = port_morton(case, monkeypatch)
    before = dict(backend.LAUNCHES)
    hit = tintersect.intersect_spheres(*args, 1e9, tc, tr, accel=acc)
    occ = tintersect.intersect_spheres_any(
        *args, torch.from_numpy(tmax), accel=acc, centers=tc, radii=tr,
        exclude_index=torch.from_numpy(exclude))
    assert backend.LAUNCHES == before      # CPU tensors: plain versions
    t, i = hit.t.numpy(), hit.index.numpy()
    if route == "clustered":
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_ref))
        np.testing.assert_array_equal(i, i_ref)
        fin = np.isfinite(t_ref)
        np.testing.assert_allclose(t[fin], t_ref[fin], rtol=0, atol=7e-4)
        np.testing.assert_array_equal(occ.numpy(), occ_ref)
    else:
        flip = np.isfinite(t) != np.isfinite(t_ref)
        assert_mxu_matches(flip, t, t_ref, i, i_ref, case["graze"], 1e-3,
                           1e-2)
        oflip = occ.numpy() != occ_ref
        assert oflip.mean() < 0.005 and (case["graze"][oflip] < 1e-3).all()
    assert 0.02 < occ_ref.mean() < 0.95


FRAME = dict(width=32, height=32, bounces=2, block_size=1024)


@pytest.fixture(scope="module")
def frame_case():
    """The small demo scene and its camera, in both packages."""
    host = jmyscene.build(oscillator_grid=3)
    pos = np.array([0.0, 1.0, -5.0])
    cam = jcamera.make_camera(tuple(pos), tuple(-pos / np.linalg.norm(pos)),
                              horizontal_fov_deg=90.0, aspect=1.0)
    port = (convert.scene(jax.tree.map(np.asarray, host.scene), "cpu"),
            convert.camera(jax.tree.map(np.asarray, cam), "cpu"))
    return (host.scene, cam), port


def reference_frame(scene, cam, route):
    """The reference's 32x32, 2-bounce frame on the route: its XLA path
    for the clustered accel (the same closest hit; the accel is a TPU
    aid there), its MXU kernels in interpret mode under its opt-in for
    the Morton accel (8 per chunk, sorted from the camera), at HIGHEST
    for "mxu_highest" (its precision patched, JAX's caches cleared before
    and after: the jitted kernels read it at trace time)."""
    cfg = jpathtrace.PathTraceConfig(**FRAME)
    if route == "clustered":
        out = jax.jit(lambda s, c: jpathtrace.trace_image(s, c, cfg, 0))(
            scene, cam)
        return np.asarray(out.radiance), float(out.rays_traced)
    plan = jclusters.build_plan_morton(np.asarray(scene.center),
                                       np.asarray(scene.radius),
                                       max_members=8)

    @jax.jit
    def frame(s, c):
        acc = jclusters.make_morton_accel(plan, s.center, s.radius,
                                          sort_origin=c.position)
        return jpathtrace.trace_image(s, c, cfg, 0, accel=acc)

    old = (jintersect.BACKEND, jintersect._USE_MXU)
    old_prec = (ip._MXU_PREC_NAME, ip._MXU_PRECISION)
    jintersect.BACKEND, jintersect._USE_MXU = "interpret", True
    if route == "mxu_highest":
        ip._MXU_PREC_NAME = "highest"
        ip._MXU_PRECISION = jax.lax.Precision.HIGHEST
        jax.clear_caches()
    try:
        out = jax.block_until_ready(frame(scene, cam))
    finally:
        jintersect.BACKEND, jintersect._USE_MXU = old
        if route == "mxu_highest":
            ip._MXU_PREC_NAME, ip._MXU_PRECISION = old_prec
            jax.clear_caches()
    return np.asarray(out.radiance), float(out.rays_traced)


@pytest.mark.parametrize("route", ["clustered", "mxu", "mxu_highest"])
def test_trace_image_routes_match_reference(frame_case, route, monkeypatch):
    """trace_image through each route (B13's plain version, or B12a's, at
    "high" or, "mxu_highest", at DRTS_MXU_PREC=highest on both sides)
    against the reference's frame on the same route: radiance within 1e-3
    on >= 99.5% of pixels, the same rays traced. (The MXU route's bf16x3
    quadratic moves roots near grazing and at a bounce ray's own sphere,
    so against the exact closest hit ~0.8% of these pixels differ.)"""
    (jscene, jcam), (scene, cam) = frame_case
    ref, rays_ref = reference_frame(jscene, jcam, route)
    centers, radii = scene.center.numpy(), scene.radius.numpy()
    if route == "clustered":
        acc = tclusters.make_accel(
            tclusters.build_plan(centers, radii, device="cpu"),
            scene.center, scene.radius)
    else:
        monkeypatch.setattr(tclusters, "_USE_MXU", True)
        monkeypatch.setattr(ik, "MXU_PREC", "highest" if route ==
                            "mxu_highest" else "high")
        acc = tclusters.make_morton_accel(
            tclusters.build_plan_morton(centers, radii, max_members=8,
                                        device="cpu"),
            scene.center, scene.radius, sort_origin=cam.position)
        assert acc.mxu_a is not None
    out = tpathtrace.trace_image(scene, cam,
                                 tpathtrace.PathTraceConfig(**FRAME), 0,
                                 accel=acc)
    diff = np.abs(out.radiance.numpy() - ref).max(-1)
    assert (diff <= 1e-3).mean() >= 0.995, (diff <= 1e-3).mean()
    assert float(out.rays_traced) == rays_ref


@pytest.mark.parametrize("prec", ["default", "high", "highest", "bf16x3",
                                  "no mxu_a"])
def test_mxu_precision_names(case, monkeypatch, prec):
    """DRTS_MXU_PREC's three names run both MXU kernels (hits, some rays
    blocked); any other name raises a ValueError that names the variable,
    in both kernels, and the route without MortonAccel.mxu_a raises at
    every precision."""
    acc = port_morton(case, monkeypatch)
    rays9 = torch.cat([case["trays"], torch.full((1, case["n"]), -1.0)])
    args = (acc.table, acc.bounds, acc.mxu_a)
    if prec == "no mxu_a":
        for name in ik.MXU_PARTS:
            monkeypatch.setattr(ik, "MXU_PREC", name)
            with pytest.raises(ValueError, match="mxu_a"):
                ik.intersect_morton_mxu(case["trays"], acc.table,
                                        acc.bounds, None)
            with pytest.raises(ValueError, match="mxu_a"):
                ik.occlusion_morton_mxu(rays9, acc.table, acc.bounds, None)
        return
    monkeypatch.setattr(ik, "MXU_PREC", prec)
    if prec not in ik.MXU_PARTS:
        with pytest.raises(ValueError, match="DRTS_MXU_PREC"):
            ik.intersect_morton_mxu(case["trays"], *args)
        with pytest.raises(ValueError, match="DRTS_MXU_PREC"):
            ik.occlusion_morton_mxu(rays9, *args)
        return
    t, i = ik.intersect_morton_mxu(case["trays"], *args, block=500)
    occ = ik.occlusion_morton_mxu(rays9, *args, block=500)
    assert t.shape == i.shape == occ.shape == (case["n"],)
    assert bool(torch.isfinite(t).any()) and bool(occ.any())
