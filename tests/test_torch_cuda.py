"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked ``cuda``; each test skips where PyTorch sees no GPU. They cover what
the main paths' shapes do not: tables wider than one shared-memory tile
(512 columns), ray and pixel counts that are not a multiple of the block
size, dead lanes, light tables of 1 and 128 rows, B1's chunk culls (a
table of five shared-memory tiles, every tmax +inf or every one finite, a
dead batch, singleton chunks, rays tangent to chunk bounds with the cull's
rounding margin from the wrapper and at 0), B3 with 1 to 200 slots (seven
slot tiles) and 1 to 12 rounds, reprojection of 1 to
4,100 channels (each vector width, and pixels wider than one block) with
motion off every edge and on views that are not 16-byte aligned, and the
pairwise ReSTIR history rows at 5 and 12 words (a ragged width, an
unaligned view, a strided view), B11's any hit as accel_mode="none" runs
it (every lane dead; a third live with an excluded sphere each), B2 with
a table wider than one shared-memory tile, a dead batch, singleton chunks,
rays tangent to its chunk bounds and the cull's rounding margin taken
from the wrapper, and for the mesh kernels 1 and 600
instances (a scan table beyond one 512-row tile), a 2,048-face mesh (a
triangle table of 72 KB, beyond one shared-memory tile) and a batch of
dead lanes only; B5's chunk culls with 1,000 instances (two tiles), tmax
+inf, advanced cursors, rays tangent to members at a chunk's rim and the
cull's margin from the wrapper and at 0; B11's skips with 1, 128 (every
third row zeroed) and 700 spheres, rays that all miss and one live lane
in a dead batch; the any-hit mesh kernels also with short ranges and with
blocked bits already set, and B10 with 1 to 5 rounds; the triangle-chunk
culls of B8 and B10 at chunks 8, 32 and the kept one (600 instances, a
2,048-face table, a dead batch, one live lane in it, the hand scene of
tests/test_torch_tri_culls.py with grazing rays) against the walks and
the plain versions, and with their margin and guard from the wrappers
and at 0; B6's at chunks 8 and 32 over two rounds, with candidates -1
and m_tbl and incoming bests closer than every face; and B9's sparse and
dense paths (1 to 200 live lanes scattered through 4,099, all live, and
blocks of 1, 40 in one warp, 63, 64, 100 and 256 live lanes; 600
instances at scales 0.5, 1 and 2, a table of two face tiles), each with
the threshold patched so that every block takes one path, and B9's
triangle-chunk culls on the hand scene's rays for its instances of scale
0.5, 1 and 2 with the margin and guard from the wrapper and at 0; B7
(faces staged per block, the triangle-chunk culls in B8's frame) against
its plain version and its walk at instance scales 0.25, 1 and 4
(tests/test_torch_b7_culls.py's edge, grazing, rim and segment-end rays),
at 4,099 rays over 600 instances, with every lane dead, dead warps, 20
live lanes of 4,099 (a backstop batch) and a 2,048-face table staged in
scratch memory. Whole
``compact_from=1`` path-trace frames at 48x48 (spheres through B1, the
mesh scene through B5-B7 and B11) hold the card to the CPU with the key
sort, the partition at every capacity, the partition over ragged tiles
and a 32-slot deep segment with and without the spill wave. The packed
texture path (shading.sample_packed in its three filters and
evaluate_material with a normal map, 2- and 3-word sets) runs on the card
through every index clamp: u below half a texel, u and v at 0 and 1, set
ids -1 and past the last set, NaN and infinite uv. The banded frame
(drts_tpu_torch/parallel) at 64x64: one NCCL rank bit for bit against the
unbanded frame on a SHARC skip frame, and two and three gloo ranks
sharing the card (even and uneven bands) within chip_smoke.py's
DEFAULT_* bounds of the one-device frames; the one-rank frame as graph
replays (render_frame_graph()(..., group=)) against the eager banded
frame (bit for bit on a skip frame, DEFAULT_* on the update frames, the
launches the capture's), and the banded trace through
trace_image_graph(cfg, rows=) and banded_trace(graph=True) bit for bit
the eager ones. graft_entry.entry()'s frame
step once: a finite (256, 256, 3) image. B12a and B12b (the tensor-core
Morton kernels) at chunks of 8, 12 (padded to 16), 16, 32 and 64 slots
(three shared-memory tiles at 64), ragged ray counts, partly filled
chunks, shadow-ray ranges, an excluded object on every ray, a batch of
dead lanes and one of dead warps, within the MXU_* tolerances, and every
word the same with their chunk cull off; their tables resident in each
block of their persistent grids and tiled, and batches beyond one wave of
those grids (equal, bit for bit, to the same kernel on sub-batches); each
at the reference's three precisions (DRTS_MXU_PREC default, high and
highest: a build of each kernel per precision); B13
with cluster counts that are no multiple of 8, empty slots, clusters of
1, 12 and 32 filled slots, rays that start inside a cluster bound, a dead
batch, dead warps and finite ranges, its plan resident and tiled and a
batch beyond one wave, every word equal; intersect_spheres and
intersect_spheres_any through both routes launch B13, and B12a and B12b
under the opt-in. Run on a GPU
machine, which has no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The frames: equal rays and overflow counts, radiance within 1e-3 on >=
99.5% of pixels and 1e-5 on average. Tolerance 0 for B1, B11, B2, B4,
B5 to B10 and B13: the kernels are built with
-fmad=false and compute the same separately rounded operations in the same
order as the plain versions (B4 nearest copies words). B3 calls the CUDA library's
sincosf where the plain version calls PyTorch's sin and cos: picks may
differ on <= 0.1% of pixels and the outputs elsewhere by <= 1e-5 of each
row's largest value. B12a and B12b sum on the tensor cores (MXU_* below
states their tolerance).

The graph frames (drts_tpu_torch/graphs.py) against eager frames: the
sphere ReSTIR frame bit for bit, the default frame within the DEFAULT_*
bounds plus two eager runs' spread (SHARC's float atomics), physics'
device dt, a Session resume; and the mesh frames: the mesh trace at
MESH_CAND 0, 1 and 2 with and without a spill wave and the all-mesh
ReSTIR frame bit for bit, the all-mesh pipeline (partition mode) and a
mesh Session through a static set within those bounds; and the rest of
the one-device frames: the ReSTIR frame with the options frame's
choices (shared offsets moving over four frames; a callable whose offsets
stay the first frame's differs) and at accel_mode="none" bit for bit,
the textured frame within the DEFAULT_* bounds plus two eager runs'
spread, the headline frame on the MXU route at each DRTS_MXU_PREC (bit
for bit where two eager runs agree) and on the clustered accel bit for
bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from drts_tpu_torch import backend
from drts_tpu_torch.models import clusters, geometry
from drts_tpu_torch.ops import intersect, intersect_kernels as ik
from drts_tpu_torch.ops import trimesh, trimesh_kernels as tk
from drts_tpu_torch.ops import reproject_kernels as rp
from drts_tpu_torch.ops import restir_kernels as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_case(k, n, seed):
    rng = np.random.RandomState(seed)
    centers = np.asarray(rng.randn(k, 3) * 8, np.float32)
    radii = np.asarray(0.05 + 0.5 * rng.rand(k), np.float32)
    o = np.asarray(rng.randn(n, 3) * 12, np.float32)
    # Every other ray aims near a sphere, so small scenes get hits too.
    d = rng.randn(n, 3)
    aim = centers[rng.randint(0, k, n)] + 0.1 * rng.randn(n, 3) - o
    d[::2] = aim[::2]
    d = np.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), np.float32)
    tmax = np.where(rng.rand(n) < 0.2, -1.0, 1e9).astype(np.float32)
    rays = intersect.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(n), torch.from_numpy(tmax))
    return centers, radii, rays


def assert_equal(kernel_out, plain_out):
    for k_val, p_val in zip(kernel_out, plain_out):
        assert torch.equal(k_val.cpu().view(torch.int32),
                           p_val.cpu().view(torch.int32))


@pytest.mark.parametrize("k,n", [(1500, 5001), (40, 300)])
def test_morton_kernel_equals_plain(dev, k, n):
    centers, radii, rays = random_case(k, n, seed=k)
    plan = clusters.build_plan_morton(centers, radii, max_members=32,
                                      device=dev)
    accel = clusters.make_morton_accel(plan, torch.from_numpy(centers).to(dev),
                                       torch.from_numpy(radii).to(dev))
    rays = rays.to(dev)
    before = backend.LAUNCHES["intersect_morton"]
    out = ik.intersect_morton(rays, accel.table, accel.bounds)
    assert backend.LAUNCHES["intersect_morton"] == before + 1
    assert_equal(out, ik.intersect_morton_plain(rays, accel.table))
    assert bool(torch.isfinite(out[0]).any())


def closest_case(kind, dev):
    """(accel, bounds, rays) on `dev` for test_morton_kernel_culls_exactly:
    `kind` is (spheres, rays, variant)."""
    k, n, variant = kind
    if variant == "tangent":
        accel, bounds, rays9 = tangent_case(k, seed=k)
        rays = rays9[:8].clone()
        rays[7, ::2] = float("inf")
        return (clusters.MortonAccel(accel.table.to(dev), bounds.to(dev),
                                     accel.n_chunks, accel.chunk),
                bounds.to(dev), rays.to(dev))
    centers, radii, rays = random_case(k, n, seed=k + 2)
    if variant == "singletons":
        radii[::7] = 2.5 + radii[::7]   # beyond big_radius: one per chunk
    plan = clusters.build_plan_morton(centers, radii, max_members=32,
                                      device=dev)
    accel = clusters.make_morton_accel(plan, torch.from_numpy(centers).to(dev),
                                       torch.from_numpy(radii).to(dev),
                                       sort_origin=rays[:3].mean(1).to(dev))
    live = rays[7] >= rays[6]
    rng = np.random.RandomState(n)
    if variant == "inf":
        rays[7] = torch.where(live, float("inf"), -1.0)
    if variant == "finite":
        rays[7] = torch.where(live, torch.from_numpy(
            np.asarray(30.0 * rng.rand(n), np.float32)), -1.0)
    if variant == "dead":
        rays[7] = -1.0
    return accel, accel.bounds, rays.to(dev).contiguous()


@pytest.mark.parametrize("k,n,variant", [
    (7000, 3001, "inf"), (1500, 5001, "finite"), (300, 1000, "dead"),
    (300, 2001, "singletons"), (40, 257, "inf"), (400, 0, "tangent")])
def test_morton_kernel_culls_exactly(dev, k, n, variant):
    """B1's culls change no bit: equal to the unculled plain version with a
    table of 7,008 columns (five shared-memory tiles), a ragged ray count,
    every live tmax +inf or every one finite, a batch of dead lanes only,
    big spheres in singleton chunks, and rays tangent to chunk bounds
    refit with no slack (half of them with tmax = +inf); and the cull
    does skip chunks."""
    accel, bounds, rays = closest_case((k, n, variant), dev)
    before = backend.LAUNCHES["intersect_morton"]
    out = ik.intersect_morton(rays, accel.table, bounds)
    assert backend.LAUNCHES["intersect_morton"] == before + 1
    assert_equal(out, ik.intersect_morton_plain(rays, accel.table))
    met, best, _ = ik.closest_chunk_walk(rays, accel.table, bounds)
    live = rays[7] >= rays[6]
    if variant == "dead":
        assert not bool(torch.isfinite(out[0]).any())
        assert not bool(met.any())
    else:
        assert bool(torch.isfinite(out[0]).any())
        assert float(met[live].float().mean()) < 0.9
    if variant == "singletons":
        assert bool((bounds[4] == 1).any())
    if k == 7000:   # more chunks than one 48 KB tile holds
        assert bounds.shape[1] * (2 * 16 * 32 + 20) > 4 * 48 * 1024


@pytest.mark.parametrize("scale", [ik.CULL_SCALE, 0.0])
def test_morton_kernel_culls_with_the_wrappers_scale(dev, scale,
                                                     monkeypatch):
    """B1 on rays tangent to chunk bounds refit with no slack, half with
    tmax = +inf, culls with the rounding margin the wrapper passes: with
    CULL_SCALE it equals the unculled plain version, and with the margin
    set to 0 it equals the culled walk of the same scale
    (closest_chunk_walk), which drops winners there."""
    monkeypatch.setattr(ik, "CULL_SCALE", scale)
    accel, bounds, rays = closest_case((400, 0, "tangent"), "cpu")
    _, best, _ = ik.closest_chunk_walk(rays, accel.table, bounds)
    trunc = ~((1 << ik.pos_bits(accel.table.shape[1])) - 1)
    t, obj = ik.intersect_morton(rays.to(dev), accel.table.to(dev),
                                 bounds.to(dev))
    t, obj = t.cpu(), obj.cpu()
    assert torch.equal(t, (best & trunc).view(torch.float32))
    assert torch.equal(obj, best & ~trunc)
    plain = ik.intersect_morton_plain(rays, accel.table)
    same = torch.equal(t.view(torch.int32), plain[0].view(torch.int32))
    assert same == (scale > 0)


@pytest.mark.parametrize("k,n", [(1300, 3001), (7, 257)])
def test_brute_kernel_equals_plain(dev, k, n):
    centers, radii, rays = random_case(k, n, seed=k)
    spheres = intersect.pack_spheres(torch.from_numpy(centers),
                                     torch.from_numpy(radii)).to(dev)
    rays = rays.to(dev)
    before = backend.LAUNCHES["intersect_brute"]
    out = ik.intersect_brute(rays, spheres)
    assert backend.LAUNCHES["intersect_brute"] == before + 1
    assert_equal(out, ik.intersect_brute_plain(rays, spheres))
    assert bool(torch.isfinite(out[0]).any())


def brute_case(k, n, variant, seed):
    """(spheres, rays) on the CPU for test_brute_kernel_skips_exactly."""
    centers, radii, rays = random_case(k, n, seed=seed)
    if variant == "zeroed":
        # The compact light table's layout: rows that are no light are 0.
        centers[1::3] = 0.0
        radii[1::3] = 0.0
    if variant == "misses":
        # Every ray leaves the scene: origins beyond it, pointing away.
        rays[0] = 1000.0 + torch.rand(n) * 10.0
        rays[3:6] = torch.tensor([1.0, 0.0, 0.0])[:, None]
    if variant == "one live":
        rays[7] = -1.0
        rays[7, n // 2] = 1e9
    spheres = intersect.pack_spheres(torch.from_numpy(centers),
                                     torch.from_numpy(radii))
    return spheres, rays


@pytest.mark.parametrize("k,n,variant", [
    (1, 1001, "aimed"), (128, 2049, "zeroed"), (700, 3001, "aimed"),
    (128, 1024, "misses"), (128, 769, "one live")])
def test_brute_kernel_skips_exactly(dev, k, n, variant):
    """B11's skips (dead blocks, rows of radius 0, roots of missed rows)
    change no bit: equal to the plain version with one sphere, a light
    table with every third row zeroed, 700 spheres (two shared-memory
    tiles), rays that all miss, and one live lane in an otherwise dead
    batch (its block holds 255 dead lanes, the others none live)."""
    spheres, rays = brute_case(k, n, variant, seed=k + n)
    spheres, rays = spheres.to(dev), rays.to(dev)
    before = backend.LAUNCHES["intersect_brute"]
    out = ik.intersect_brute(rays, spheres)
    assert backend.LAUNCHES["intersect_brute"] == before + 1
    assert_equal(out, ik.intersect_brute_plain(rays, spheres))
    hits = int(torch.isfinite(out[0]).sum())
    if variant == "misses":
        assert hits == 0
    elif variant == "one live":
        assert hits == int(torch.isfinite(out[0][n // 2]))
        assert bool((out[1][torch.arange(n, device=dev) != n // 2] == 0)
                    .all())
    else:
        assert hits > 0
    if variant == "zeroed":
        assert not bool((out[1][torch.isfinite(out[0])] % 3 == 1).any())


def tangent_case(k, seed, per_chunk=6):
    """k spheres, their Morton accel, bounds refit with no slack (the
    outermost sphere of each chunk touches its bound) and shadow rays
    tangent to each chunk's bound where that sphere touches it, their
    distance to the bound's centre moved by -1, 0 and +1 ulp; nothing is
    excluded, so the touching sphere blocks wherever the quadratic rounds
    to a hit. Returns (accel, tight bounds, rays9), all on the CPU."""
    rng = np.random.RandomState(seed)
    centers = np.asarray(rng.randn(k, 3) * 8, np.float32)
    radii = np.asarray(0.05 + 0.5 * rng.rand(k), np.float32)
    plan = clusters.build_plan_morton(centers, radii, device="cpu")
    c_t, r_t = torch.from_numpy(centers), torch.from_numpy(radii)
    accel = clusters.make_morton_accel(plan, c_t, r_t)
    tight = clusters.refit(plan, c_t, r_t, slack=0.0)
    bounds = torch.cat([tight.center.T, tight.radius[None],
                        accel.bounds[4:]]).contiguous()
    rows = []
    for ch, members in enumerate(plan.member_object.numpy()):
        members = members[members >= 0]
        bc = tight.center[ch].double().numpy()
        br = float(tight.radius[ch])
        e = centers[members].astype(np.float64) - bc
        far = np.linalg.norm(e, axis=1) + radii[members]
        e = e[np.argmax(far)]
        e = e / max(np.linalg.norm(e), 1e-12)
        for j in range(per_chunk):
            u = np.cross(e, rng.randn(3))
            u /= np.linalg.norm(u)
            length = 2.0 + 10.0 * rng.rand()
            for step in (-1, 0, 1):
                dist = br + step * float(np.spacing(np.float32(br)))
                o = bc + e * dist - u * length
                rows.append([*o, *u, 0.0, 2.0 * length, -1.0])
    rays9 = torch.from_numpy(np.asarray(rows, np.float32).T.copy())
    return accel, bounds, rays9


def occlusion_case(kind, dev):
    """(accel, bounds, rays9) on `dev` for test_occlusion_kernel_equals_plain:
    `kind` is (spheres, rays, excluded, variant)."""
    k, n, excluded, variant = kind
    if variant == "tangent":
        accel, bounds, rays9 = tangent_case(k, seed=k)
        return (clusters.MortonAccel(accel.table.to(dev), bounds.to(dev),
                                     accel.n_chunks, accel.chunk),
                bounds.to(dev), rays9.to(dev))
    centers, radii, rays = random_case(k, n, seed=k + 1)
    if variant == "singletons":
        radii[::7] = 2.5 + radii[::7]   # beyond big_radius: one per chunk
    plan = clusters.build_plan_morton(centers, radii, max_members=32,
                                      device=dev)
    accel = clusters.make_morton_accel(plan, torch.from_numpy(centers).to(dev),
                                       torch.from_numpy(radii).to(dev),
                                       sort_origin=rays[:3].mean(1).to(dev))
    rng = np.random.RandomState(n)
    rays[7] = torch.where(rays[7] > 0, torch.from_numpy(
        np.asarray(30.0 * rng.rand(n), np.float32)), rays[7])
    if variant == "dead":
        rays[7] = -1.0
    exclude = (rng.randint(0, k, n) if excluded else np.full(n, -1))
    rays9 = torch.cat([rays, torch.from_numpy(
        exclude.astype(np.float32))[None]]).to(dev).contiguous()
    return accel, accel.bounds, rays9


@pytest.mark.parametrize("k,n,excluded,variant", [
    (1500, 5001, True, None), (40, 300, False, None),
    (7000, 3001, True, None), (300, 1000, True, "dead"),
    (300, 2001, True, "singletons"), (400, 0, False, "tangent")])
def test_occlusion_kernel_equals_plain(dev, k, n, excluded, variant):
    """B2 with a ragged ray count, dead lanes (tmax = -1), finite tmax and
    an excluded object per ray (or none); a table of 7,008 columns, five
    shared-memory tiles; a batch of dead lanes only; big
    spheres in singleton chunks; and rays tangent to chunk bounds refit
    with no slack."""
    accel, bounds, rays9 = occlusion_case((k, n, excluded, variant), dev)
    n = rays9.shape[1]
    before = backend.LAUNCHES["occlusion_morton"]
    occ = ik.occlusion_morton(rays9, accel.table, bounds)
    assert backend.LAUNCHES["occlusion_morton"] == before + 1
    assert torch.equal(occ.cpu(), ik.occlusion_morton_plain(
        rays9, accel.table, bounds).cpu())
    assert not bool(occ[rays9[7] < rays9[6]].any())
    if variant == "dead":
        assert not bool(occ.any())
    else:
        assert 0 < int(occ.sum()) < n
    if variant == "singletons":
        assert bool((bounds[4] == 1).any())
    if k == 7000:   # more chunks than one 48 KB tile holds
        assert bounds.shape[1] * (2 * 16 * 32 + 20) > 4 * 48 * 1024


@pytest.mark.parametrize("scale", [ik.CULL_SCALE, 0.0])
def test_occlusion_kernel_culls_with_the_wrappers_scale(dev, scale,
                                                        monkeypatch):
    """B2 on rays tangent to chunk bounds refit with no slack culls with
    the rounding margin the wrapper passes: with CULL_SCALE it equals the
    unculled plain version, and with the margin set to 0 it equals the
    culled sweep of the same scale, which drops blockers there."""
    monkeypatch.setattr(ik, "CULL_SCALE", scale)
    accel, bounds, rays9 = tangent_case(400, seed=400)
    chunk = accel.chunk
    filled = (torch.arange(chunk)[None, :]
              < bounds[4].long()[:, None]).reshape(-1)
    met = ik.occlusion_chunk_met(rays9, bounds).repeat_interleave(chunk, 1)
    culled = (ik.occlusion_pair_blocked(rays9, accel.table) & filled
              & met).any(1)
    plain = ik.occlusion_morton_plain(rays9, accel.table)
    occ = ik.occlusion_morton(rays9.to(dev), accel.table.to(dev),
                              bounds.to(dev)).cpu()
    assert torch.equal(occ, culled)
    assert torch.equal(occ, plain) == (scale > 0)


def candidate_inputs(n, n_lights, seed, n_l=8, s=8):
    """A random surface stream, uniforms, slot rows and light table in the
    layout of restir_kernels."""
    rng = np.random.RandomState(seed)

    def unit(m):
        v = rng.randn(m, 3)
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    nrm = unit(n)
    view = unit(n)
    view = np.where((view * nrm).sum(1, keepdims=True) < 0, -view, view)
    lobes = rng.rand(n, 3)
    lobes /= lobes.sum(1, keepdims=True)
    surf = np.concatenate([
        rng.randn(n, 3) * 4, nrm, nrm, view, rng.rand(n, 3),
        (rng.rand(n, 1) < 0.5), 0.05 + 0.95 * rng.rand(n, 1),
        np.ones((n, 1)), np.full((n, 1), 1.5), (rng.rand(n, 1) < 0.2),
        (rng.rand(n, 1) < 0.95), lobes], axis=1).T
    uni = rng.rand(4 * n_l, n)
    slots = np.concatenate([rng.randint(0, n_lights, (s, n)),
                            np.where(rng.rand(s, n) < 0.9,
                                     rng.rand(s, n) * 5, 0.0)])
    table = np.concatenate([
        rng.randn(n_lights, 3) * 6, 0.1 + 0.4 * rng.rand(n_lights, 1),
        rng.rand(n_lights, 3) * 10, (rng.rand(n_lights, 1) < 0.9) * 2.0,
        rng.randint(0, 400, (n_lights, 1))], axis=1)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in (surf, uni, slots, table)]


@pytest.mark.parametrize("n,n_lights,n_b", [(5001, 128, 1), (300, 1, 1),
                                            (257, 128, 0)])
def test_candidate_kernel_equals_plain(dev, n, n_lights, n_b):
    """B3 at ragged pixel counts with a light table of 1 and 128 rows, with
    and without the BRDF candidate's MIS term."""
    surf, uni, slots, table = (x.to(dev) for x in
                               candidate_inputs(n, n_lights, seed=n))
    before = backend.LAUNCHES["initial_light_candidates"]
    f_k, i_k = rk.initial_light_candidates(surf, uni, slots, table, 8, 8, n_b)
    assert backend.LAUNCHES["initial_light_candidates"] == before + 1
    f_p, i_p = rk.initial_light_candidates_plain(surf, uni, slots, table, 8,
                                                 8, n_b)
    same = (i_k == i_p).all(0)
    assert 1.0 - float(same.float().mean()) <= 1e-3
    diff = (f_k - f_p).abs()[:, same].amax(1)
    assert bool((diff <= 1e-5 * f_p.abs().amax(1)).all()), diff
    assert float(f_k[3].max()) > 0.0   # some candidate carries weight


@pytest.mark.parametrize("n_b,n_lights", [(0, 1), (1, 128)])
@pytest.mark.parametrize("n_l", [1, 8, 12])
@pytest.mark.parametrize("s", [1, 8, 32, 200])
def test_candidate_kernel_stages_any_slot_count(dev, s, n_l, n_b, n_lights):
    """B3's slot rows staged in shared memory for 1 to 200 slots (200 are
    seven tiles of 32, restaged in every round), 1 to 12 rounds, with and
    without the MIS term and with 1 and 128 lights, at a ragged pixel
    count: within the bounds of test_candidate_kernel_equals_plain."""
    n = 1001
    surf, uni, slots, table = (x.to(dev) for x in candidate_inputs(
        n, n_lights, seed=s + n_l, n_l=n_l, s=s))
    f_k, i_k = rk.initial_light_candidates(surf, uni, slots, table, n_l, s,
                                           n_b)
    f_p, i_p = rk.initial_light_candidates_plain(surf, uni, slots, table,
                                                 n_l, s, n_b)
    same = (i_k == i_p).all(0)
    assert 1.0 - float(same.float().mean()) <= 1e-3
    diff = (f_k - f_p).abs()[:, same].amax(1)
    assert bool((diff <= 1e-5 * f_p.abs().amax(1)).all()), diff
    assert float(f_k[3].max()) > 0.0
    assert rk.initial_light_candidates_info(n_lights, s)["blocks_per_sm"] >= 1


@pytest.mark.parametrize("c", [1, 2, 3, 4, 8, 9, 129, 258, 1025, 4100])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_reproject_kernel_equals_plain(dev, c, mode):
    """B4 with 1 to 4,100 channels (vector widths 1, 2 and 4; 129 and 258
    fit fewer rows in a block, 1025 and 4100 hold more vector slots than a
    block has threads), a frame that is not a multiple of the block size,
    and motion that leaves the frame on every side."""
    h, w = 37, 53
    rng = np.random.RandomState(c)
    src = torch.from_numpy(np.asarray(rng.randn(h, w, c), np.float32)).to(dev)
    motion = torch.from_numpy(np.asarray(rng.randn(h, w, 2) * 30,
                                         np.float32)).to(dev)
    before = backend.LAUNCHES["reproject_packed"]
    out, ok = rp.reproject_packed(src, motion, mode)
    assert backend.LAUNCHES["reproject_packed"] == before + 1
    out_p, ok_p = rp.reproject_packed_plain(src, motion, mode)
    assert torch.equal(out.cpu().view(torch.int32),
                       out_p.cpu().view(torch.int32))
    assert torch.equal(ok.cpu(), ok_p.cpu())
    assert rp.vector_width(c, src, out) == {
        1: 1, 2: 2, 3: 1, 4: 4, 8: 4, 9: 1, 129: 1, 258: 2, 1025: 1,
        4100: 4}[c]
    m = motion.cpu()
    assert bool((m[..., 0] + torch.arange(w) < 0).any())
    assert bool((m[..., 0] + torch.arange(w) > w - 1).any())
    assert bool((m[..., 1] + torch.arange(h)[:, None] < 0).any())
    assert bool((m[..., 1] + torch.arange(h)[:, None] > h - 1).any())
    assert 0 < int(ok.sum()) < h * w


@pytest.mark.parametrize("row0", ["0", "1", "half-1"])
@pytest.mark.parametrize("c", [5, 12])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_reproject_kernel_row_offset(dev, row0, c, mode):
    """B4 writing a band of the frame (the sharded frame's history fetch):
    the rows from row offset 0, 1 and H/2 - 1 of a 38-row history, 19
    rows each, at 5 and 12 words, in both modes, bit for bit the plain
    version's; and the band's rows of the whole frame's."""
    h, w, rows = 38, 45, 19
    r0 = {"0": 0, "1": 1, "half-1": h // 2 - 1}[row0]
    rng = np.random.RandomState(c)
    src = torch.from_numpy(np.asarray(rng.randn(h, w, c), np.float32)).to(dev)
    motion = torch.from_numpy(np.asarray(rng.randn(h, w, 2) * 12,
                                         np.float32)).to(dev)
    band = motion[r0:r0 + rows]
    before = backend.LAUNCHES["reproject_packed"]
    out, ok = rp.reproject_packed(src, band, mode, r0)
    assert backend.LAUNCHES["reproject_packed"] == before + 1
    assert tuple(out.shape) == (rows, w, c)
    out_p, ok_p = rp.reproject_packed_plain(src, band, mode, r0)
    assert torch.equal(out.cpu().view(torch.int32),
                       out_p.cpu().view(torch.int32))
    assert torch.equal(ok.cpu(), ok_p.cpu())
    whole, whole_ok = rp.reproject_packed(src, motion, mode)
    assert torch.equal(out.cpu().view(torch.int32),
                       whole[r0:r0 + rows].cpu().view(torch.int32))
    assert torch.equal(ok.cpu(), whole_ok[r0:r0 + rows].cpu())
    assert 0 < int(ok.sum()) < rows * w


@pytest.mark.parametrize("c,offset,vec", [(4, 1, 1), (4, 2, 2), (8, 2, 2),
                                          (8, 1, 1)])
def test_reproject_kernel_misaligned_src(dev, c, offset, vec):
    """B4 nearest on src and motion views that start `offset` words into
    their storage: the wrapper takes a narrower vector (or copies the
    motion), and the words are still those of the plain version."""
    h, w = 29, 41
    rng = np.random.RandomState(c + offset)
    store = torch.from_numpy(np.asarray(rng.randn(h * w * c + offset),
                                        np.float32)).to(dev)
    src = store[offset:].view(h, w, c)
    mstore = torch.from_numpy(np.asarray(rng.randn(h * w * 2 + 1) * 20,
                                         np.float32)).to(dev)
    motion = mstore[1:].view(h, w, 2)
    assert src.data_ptr() % 16 == 4 * offset and motion.data_ptr() % 8 == 4
    assert rp.vector_width(c, src) == vec
    out, ok = rp.reproject_packed(src, motion, "nearest")
    out_p, ok_p = rp.reproject_packed_plain(src, motion, "nearest")
    assert torch.equal(out.cpu().view(torch.int32),
                       out_p.cpu().view(torch.int32))
    assert torch.equal(ok.cpu(), ok_p.cpu())


@pytest.mark.parametrize("c", [5, 12])
@pytest.mark.parametrize("variant", ["ragged", "unaligned", "strided"])
def test_reproject_kernel_restir_rows(dev, c, variant):
    """B4 nearest on the pairwise ReSTIR history rows: C = 5 (the four
    reservoir words and the target pdf) and C = 12 (and the seven words of
    the previous surface), 67 px wide (not a whole number of the kernel's
    patches), on a view one word into its storage (C = 12 then takes one
    word per thread) and on the first C words of wider rows (a strided
    view, which the wrapper makes contiguous). The words are random bit
    patterns, NaN payloads included: nearest copies them."""
    h, w = 31, 67
    rng = np.random.RandomState(c)
    words = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(h, w, c + 3),
                        dtype=np.int64).astype(np.int32)
    full = torch.from_numpy(words).view(torch.float32).to(dev)
    if variant == "ragged":
        src = full[..., :c].contiguous()
        assert rp.vector_width(c, src) == {5: 1, 12: 4}[c]
    elif variant == "unaligned":
        store = torch.empty(h * w * c + 1, dtype=torch.float32, device=dev)
        src = store[1:].view(h, w, c)
        src.copy_(full[..., :c])
        assert src.data_ptr() % 16 == 4 and rp.vector_width(c, src) == 1
    else:
        src = full[..., :c]
        assert not src.is_contiguous()
    motion = torch.from_numpy(np.asarray(rng.randn(h, w, 2) * 3,
                                         np.float32)).to(dev)
    before = backend.LAUNCHES["reproject_packed"]
    out, ok = rp.reproject_packed(src, motion, "nearest")
    assert backend.LAUNCHES["reproject_packed"] == before + 1
    out_p, ok_p = rp.reproject_packed_plain(src, motion, "nearest")
    assert torch.equal(out.cpu().view(torch.int32),
                       out_p.cpu().view(torch.int32))
    assert torch.equal(ok.cpu(), ok_p.cpu())
    assert 0 < int(ok.sum()) < h * w


@pytest.mark.parametrize("variant", ["all dead", "all dead excluded",
                                     "mixed excluded"])
def test_brute_anyhit_dead_lanes(dev, variant):
    """The shadow rays of accel_mode="none": intersect_spheres_any with no
    accel launches B11 once and reads its hit bit, against the excluded
    object. A batch whose every lane is dead (tmax = -1, as the raytraced
    batches give the lanes whose answer nobody reads) blocks nothing; a
    batch with a third of its lanes live, each excluding a random sphere,
    equals the CPU's."""
    n, k = 4097, 438
    centers, radii, rays = random_case(k, n, seed=11)
    rng = np.random.RandomState(12)
    tmax = torch.full((n,), -1.0)
    if variant == "mixed excluded":
        live = torch.from_numpy(rng.rand(n) < 1 / 3)
        tmax = torch.where(live, torch.from_numpy(
            np.asarray(30.0 * rng.rand(n), np.float32)), tmax)
    excl = (torch.from_numpy(rng.randint(0, k, n)) if "excluded" in variant
            else None)
    args = (rays[0:3].T.contiguous(), rays[3:6].T.contiguous(),
            torch.zeros(n), tmax)
    kw = dict(centers=torch.from_numpy(centers),
              radii=torch.from_numpy(radii))
    want = intersect.intersect_spheres_any(*args, 4096, exclude_index=excl,
                                           **kw)
    before = backend.LAUNCHES["intersect_brute"]
    got = intersect.intersect_spheres_any(
        *(a.to(dev) for a in args), 4096,
        exclude_index=None if excl is None else excl.to(dev),
        **{key: v.to(dev) for key, v in kw.items()})
    assert backend.LAUNCHES["intersect_brute"] == before + 1
    assert torch.equal(got.cpu(), want)
    if variant == "mixed excluded":
        assert 0 < int(want.sum()) < int(live.sum())
    else:
        assert not bool(got.any())


def mesh_case(k, n, tess, seed, dev, dead=False):
    """k rotated, scaled instances of a geosphere, n rays of which every
    other one aims near an instance and a fifth are dead (all, with
    `dead`), and the per-call tables."""
    rng = np.random.RandomState(seed)
    pos = np.asarray(rng.randn(k, 3) * 6, np.float32)
    rot = rng.randn(k, 4)
    rot = np.asarray(rot / np.linalg.norm(rot, axis=1, keepdims=True),
                     np.float32)
    scale = np.asarray(0.4 + rng.rand(k) * 1.4, np.float32)
    o = np.asarray(rng.randn(n, 3) * 9, np.float32)
    d = rng.randn(n, 3)
    aim = pos[rng.randint(0, k, n)] + 0.3 * rng.randn(n, 3) - o
    d[::2] = aim[::2]
    d = np.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), np.float32)
    tmax = np.where(rng.rand(n) < (1.0 if dead else 0.2), -1.0,
                    1e9).astype(np.float32)
    rays = intersect.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(n), torch.from_numpy(tmax)).to(dev)
    mesh = trimesh.make_mesh(*geometry.create_geosphere(2.0, tess),
                             device=dev)
    tables = tk.make_inst_tables(
        torch.from_numpy(pos).to(dev), torch.from_numpy(rot).to(dev),
        torch.from_numpy(scale).to(dev), mesh.bound_radius,
        sort_origin=torch.from_numpy(o.mean(0)).to(dev))
    return mesh, rays, tables


@pytest.mark.parametrize("k,n,tess,dead", [
    (24, 5001, 3, False), (1, 300, 2, False), (600, 3001, 3, False),
    (24, 2049, 5, False), (24, 1024, 3, True)])
def test_mesh_kernels_equal_plain(dev, k, n, tess, dead):
    """B5, B6 and B7 round by round as the candidate loop calls them, each
    against its plain version on the same inputs, then the whole loop on
    the card against the whole loop on the CPU."""
    mesh, rays, (inst_tbl, inst_bounds, _, n_ic) = mesh_case(
        k, n, tess, seed=k + n, dev=dev, dead=dead)
    tri_tbl = mesh.tri_tbl
    assert tri_tbl.shape[0] == max(64, 8 * 4 ** (tess - 1))
    bscan = tk.make_bscan_table(inst_tbl)
    assert bscan.shape[0] == -(-inst_tbl.shape[1] // 128) * 128
    m_tbl = inst_tbl.shape[1]
    mask = (1 << ik.pos_bits(bscan.shape[0])) - 1
    trunc_f = ~((1 << ik.pos_bits(tri_tbl.shape[0])) - 1)
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best = torch.full((n,), ik.INF_BITS, dtype=torch.int32, device=dev)
    binst = torch.zeros(n, dtype=torch.int32, device=dev)
    cur = rays.clone()
    before = dict(backend.LAUNCHES)
    for _ in range(2):
        key = tk.bound_scan(cur, bscan, cursor, inst_bounds, m_tbl)
        assert torch.equal(key, tk.bound_scan_plain(cur, bscan, cursor))
        cand = torch.where(key < ik.INF_BITS, key & mask, m_tbl).to(
            torch.int32)
        out = tk.shared_blas_sweep(cur, cand, best, binst, inst_tbl, tri_tbl,
                                   mesh.tri_bounds, mesh.tri_chunk)
        assert_equal(out, tk.shared_blas_sweep_plain(cur, cand, best, binst,
                                                     inst_tbl, tri_tbl))
        best, binst = out
        cursor = key
        cur[7] = torch.minimum(rays[7],
                               (best & trunc_f).view(torch.float32))
    # The loop's rays, tightened to the best so far, then the untouched.
    for batch in (cur, rays):
        out = tk.intersect_mesh_instances(batch, inst_tbl, inst_bounds,
                                          tri_tbl, n_ic, mesh.tri_bounds,
                                          mesh.tri_chunk)
        assert_equal(out, tk.intersect_mesh_instances_plain(
            batch, inst_tbl, inst_bounds, tri_tbl, n_ic))
    assert backend.LAUNCHES["bound_scan"] == before["bound_scan"] + 2
    assert (backend.LAUNCHES["shared_blas_sweep"]
            == before["shared_blas_sweep"] + 2)
    assert (backend.LAUNCHES["intersect_mesh_instances"]
            == before["intersect_mesh_instances"] + 2)
    hits = int(torch.isfinite(out[0]).sum())
    assert hits == 0 if dead else 0 < hits < n
    assert dead or bool((best < ik.INF_BITS).any())

    whole = tk.intersect_mesh_instances_cand(rays, inst_tbl, inst_bounds,
                                             tri_tbl, mesh.tri_bounds,
                                             mesh.tri_chunk, n_ic)
    on_cpu = tk.intersect_mesh_instances_cand(
        rays.cpu(), inst_tbl.cpu(), inst_bounds.cpu(), tri_tbl.cpu(),
        mesh.tri_bounds.cpu(), mesh.tri_chunk, n_ic)
    assert_equal(whole, on_cpu)


def b7_batch(variant, dev):
    """B7's arguments for a card case: tests/test_torch_b7_culls.py's
    scene with the rays built for the instance of one scale live
    ("scale0.25", "scale1", "scale4": edge, grazing, rim and segment-end
    rays, the segment ending at the running best); or mesh_case's 600
    instances of the 512-face geosphere (the demo mesh) at 4,099 rays
    (ragged: no multiple of the block), with every lane dead ("dead"),
    every other warp dead but for one lane ("dead warps"), or all lanes
    dead but 20 scattered ones with tmax cut to 3 units ("backstop", the
    candidate loop's leftovers); "wide" is the 2,048-face geosphere, a
    table B7 stages once per launch in scratch memory."""
    if variant.startswith("scale"):
        from test_torch_b7_culls import scene_for
        args = scene_for(float(variant[5:]))
        return tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    mesh, rays, (inst_tbl, inst_bounds, _, n_ic) = mesh_case(
        600, 4099, 5 if variant == "wide" else 4, seed=19, dev=dev,
        dead=variant == "dead")
    if variant == "dead warps":
        dead_warps(rays)
    if variant == "backstop":
        keep = torch.zeros(rays.shape[1], dtype=torch.bool, device=dev)
        live = torch.nonzero(rays[7] >= rays[6])[:, 0]
        keep[live[torch.randperm(live.numel(), generator=torch.Generator()
                                 .manual_seed(19))[:20].to(dev)]] = True
        rays[7] = torch.where(keep, torch.clamp(rays[7], max=3.0), -1.0)
    return (rays, inst_tbl, inst_bounds, mesh.tri_tbl, mesh.tri_bounds,
            mesh.tri_chunk, n_ic)


@pytest.mark.parametrize("variant", [
    "scale0.25", "scale1", "scale4", "ragged", "dead", "dead warps",
    "backstop", "wide"])
def test_b7_kernel_equals_plain_and_walk(dev, variant):
    """B7's kernel (faces staged once per block, the triangle-chunk culls
    of csrc/trimesh.cu in B8's frame, Moeller-Trumbore on B7's own ray)
    gives every word of its plain version and of its walk, and launches
    once: at instance scales 0.25, 1 and 4, ragged n, a batch of dead
    lanes, dead warps, a backstop-shaped batch and a table wider than one
    shared-memory tile (see b7_batch)."""
    rays, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk, n_ic = \
        b7_batch(variant, dev)
    before = backend.LAUNCHES["intersect_mesh_instances"]
    out = tk.intersect_mesh_instances(rays, inst_tbl, inst_bounds, tri_tbl,
                                      n_ic, tri_bounds, chunk)
    assert backend.LAUNCHES["intersect_mesh_instances"] == before + 1
    assert_equal(out, tk.intersect_mesh_instances_plain(
        rays, inst_tbl, inst_bounds, tri_tbl, n_ic))
    words, counts, work = tk.intersect_mesh_instances_walk(
        rays, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk, n_ic)
    assert_equal(out, words)
    hits = int(torch.isfinite(out[0]).sum())
    if variant == "dead":
        assert hits == 0 and counts["live"] == 0
        return
    assert 0 < hits <= counts["live"]
    if variant == "backstop":
        assert counts["live"] == 20
    if variant == "dead warps":
        assert counts["live"] < rays.shape[1] // 2
    tests, met = work.sum(0).tolist()[:2]
    assert met < tests


def scan_case(k, n, variant, dev):
    """(inst_tbl, inst_bounds, bscan, rays) for the bound-scan tests:
    mesh_case's tables and rays, or the hand scene of
    tests/test_torch_scan_culls.py (rays tangent to the members that touch
    their chunk's covering sphere, origins inside covering spheres)."""
    if variant == "tangent":
        from test_torch_scan_culls import hand_scene
        (inst_tbl, inst_bounds, _, _), rays = hand_scene()
        inst_tbl, inst_bounds, rays = (x.to(dev) for x in
                                       (inst_tbl, inst_bounds, rays))
    else:
        _, rays, (inst_tbl, inst_bounds, _, _) = mesh_case(
            k, n, 2, seed=k + n + 2, dev=dev, dead=variant == "dead")
        if variant == "inf":
            rays[7] = torch.where(rays[7] >= rays[6], float("inf"), rays[7])
    return inst_tbl, inst_bounds, tk.make_bscan_table(inst_tbl), rays


@pytest.mark.parametrize("k,n,variant", [
    (1000, 3001, "inf"), (438, 2049, "cursors"), (24, 1027, "dead"),
    (600, 5001, "cursors"), (5, 300, "inf"), (20, 0, "tangent")])
def test_bound_scan_kernel_culls_exactly(dev, k, n, variant):
    """B5's chunk culls change no bit: equal to the unculled plain version
    and to the culled walk with 1,000 instances (a 1,024-row scan table,
    two shared-memory tiles) and every live tmax +inf, the mesh frame's
    438 and 600 instances over three rounds of advanced cursors with the
    segment ending at the entry found plus 2, a ragged ray count, a batch
    of dead lanes only, one ragged chunk, and rays tangent to members at
    their chunk's rim (half with tmax = +inf); and the cull skips
    chunks."""
    inst_tbl, inst_bounds, bscan, rays = scan_case(k, n, variant, dev)
    m_tbl = inst_tbl.shape[1]
    trunc = ~((1 << ik.pos_bits(bscan.shape[0])) - 1)
    cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32, device=dev)
    cur = rays.clone()
    skipped = 0
    for _ in range(3 if variant == "cursors" else 1):
        before = backend.LAUNCHES["bound_scan"]
        key = tk.bound_scan(cur, bscan, cursor, inst_bounds, m_tbl)
        assert backend.LAUNCHES["bound_scan"] == before + 1
        assert torch.equal(key, tk.bound_scan_plain(cur, bscan, cursor))
        met, walked, _ = tk.bound_scan_walk(cur, bscan, cursor, inst_bounds,
                                            m_tbl)
        assert torch.equal(key, walked)
        skipped += int((~met[cur[7] >= cur[6]]).sum())
        found = key < ik.INF_BITS
        assert bool(found.any()) == (variant != "dead")
        entry = (key & trunc).view(torch.float32)
        cur[7] = torch.where(found, torch.fmin(rays[7], entry + 2.0), cur[7])
        cursor = key
    assert skipped > 0 or variant == "dead" or met.shape[1] == 1


@pytest.mark.parametrize("scale", [ik.CULL_SCALE, 0.0])
def test_bound_scan_kernel_culls_with_the_wrappers_scale(dev, scale,
                                                         monkeypatch):
    """B5 on rays tangent to members at their chunk's rim culls with the
    rounding margin the wrapper passes: with CULL_SCALE it equals the
    unculled plain version, and with the margin set to 0 it equals the
    culled walk of the same scale, which drops keys there."""
    monkeypatch.setattr(ik, "CULL_SCALE", scale)
    inst_tbl, inst_bounds, bscan, rays = scan_case(20, 0, "tangent", "cpu")
    cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32)
    walked = tk.bound_scan_walk(rays, bscan, cursor, inst_bounds,
                                inst_tbl.shape[1])[1]
    key = tk.bound_scan(rays.to(dev), bscan.to(dev), cursor.to(dev),
                        inst_bounds.to(dev), inst_tbl.shape[1]).cpu()
    assert torch.equal(key, walked)
    plain = tk.bound_scan_plain(rays, bscan, cursor)
    assert torch.equal(key, plain) == (scale > 0)


@pytest.mark.parametrize("k,n,tess,dead", [
    (24, 5001, 3, False), (1, 300, 2, False), (600, 3001, 3, False),
    (24, 2049, 5, False), (24, 1024, 3, True)])
def test_mesh_anyhit_kernels_equal_plain(dev, k, n, tess, dead):
    """B5 and B8 round by round as the any-hit candidate loop calls them
    (the second round with blocked bits already set), B8 with every bit
    set, B9 on the loop's rays and on the untouched ones, each against its
    plain version, then the whole loop on the card against the whole loop
    and the serial walk alone on the CPU. Half of the live rays end
    short of 12 units."""
    mesh, rays, (inst_tbl, inst_bounds, _, n_ic) = mesh_case(
        k, n, tess, seed=k + n + 1, dev=dev, dead=dead)
    rng = np.random.RandomState(n)
    short = torch.from_numpy(np.asarray(12.0 * rng.rand(n), np.float32)
                             ).to(dev)
    rays[7] = torch.where((rays[7] > 0) & (torch.arange(n, device=dev) % 2
                                           == 0), short, rays[7])
    tri_tbl = mesh.tri_tbl
    blas = (mesh.tri_bounds, mesh.tri_chunk)
    bscan = tk.make_bscan_table(inst_tbl)
    m_tbl = inst_tbl.shape[1]
    mask = (1 << ik.pos_bits(bscan.shape[0])) - 1
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros(n, dtype=torch.int32, device=dev)
    cur = rays
    before = dict(backend.LAUNCHES)
    for _ in range(2):
        key = tk.bound_scan(cur, bscan, cursor, inst_bounds, m_tbl)
        cand = torch.where(key < ik.INF_BITS, key & mask, m_tbl).to(
            torch.int32)
        out = tk.shared_blas_any(cur, cand, occ, inst_tbl, tri_tbl, *blas)
        assert torch.equal(out, tk.shared_blas_any_plain(cur, cand, occ,
                                                         inst_tbl, tri_tbl))
        assert bool((out >= occ).all())
        occ, cursor = out, key
        cur = rays.clone()
        cur[7] = torch.where(occ > 0, rays[6] - 1.0, rays[7])
    ones = torch.ones_like(occ)
    assert torch.equal(tk.shared_blas_any(rays, cand, ones, inst_tbl, tri_tbl,
                                          *blas), ones)
    for batch in (cur, rays):
        out = tk.intersect_mesh_instances_any(batch, inst_tbl, inst_bounds,
                                              tri_tbl, *blas, n_ic)
        assert torch.equal(out, tk.intersect_mesh_instances_any_plain(
            batch, inst_tbl, inst_bounds, tri_tbl, *blas, n_ic))
    assert backend.LAUNCHES["shared_blas_any"] == before["shared_blas_any"] + 3
    assert (backend.LAUNCHES["intersect_mesh_instances_any"]
            == before["intersect_mesh_instances_any"] + 2)
    blocked = int(out.sum())
    assert blocked == 0 if dead else 0 < blocked < n
    assert dead or bool((occ > 0).any())

    whole = tk.intersect_mesh_instances_any_cand(rays, inst_tbl, inst_bounds,
                                                 tri_tbl, *blas, n_ic)
    cpu = (rays.cpu(), inst_tbl.cpu(), inst_bounds.cpu(), tri_tbl.cpu())
    assert torch.equal(whole.cpu(), tk.intersect_mesh_instances_any_cand(
        *cpu, blas[0].cpu(), blas[1], n_ic))
    # The loop and the serial walk answer the same question; B8 compares in
    # object units and B9 in world units, so a hit within rounding of a
    # range end may fall on either side.
    serial = tk.intersect_mesh_instances_any(*cpu, blas[0].cpu(), blas[1],
                                             n_ic) > 0
    assert float((whole.cpu() != serial).float().mean()) <= 1e-3


@pytest.mark.parametrize("k,n,tess,dead,rounds", [
    (24, 5001, 3, False, 1), (24, 5001, 3, False, 3), (1, 300, 2, False, 2),
    (600, 3001, 3, False, 4), (24, 2049, 5, False, 5),
    (24, 1024, 3, True, 3)])
def test_cand_fused_kernel_equals_plain(dev, k, n, tess, dead, rounds):
    """B10 against its plain version and against the multi-launch loop on
    the card (best, binst, key bit for bit), at a ragged ray count, with
    every lane dead, with 1 to 5 rounds, a 600-instance scan table (two
    512-row tiles) and a 2,048-face triangle table (four tiles); then the
    fused closest hit against the loop's."""
    mesh, rays, (inst_tbl, inst_bounds, _, n_ic) = mesh_case(
        k, n, tess, seed=k + n + rounds, dev=dev, dead=dead)
    tri_tbl = mesh.tri_tbl
    bscan = tk.make_bscan_table(inst_tbl)
    args = (rays, bscan, inst_tbl, inst_bounds, tri_tbl, mesh.tri_bounds,
            mesh.tri_chunk, rounds)
    before = backend.LAUNCHES["cand_fused"]
    out = tk.cand_fused(*args)
    assert backend.LAUNCHES["cand_fused"] == before + 1
    assert_equal(out, tk.cand_fused_plain(*args))
    assert_equal(out, tk.cand_loop(rays, bscan, inst_tbl, inst_bounds,
                                   tri_tbl, mesh.tri_bounds, mesh.tri_chunk,
                                   rounds))
    found = int((out[0] < ik.INF_BITS).sum())
    assert found == 0 if dead else found > 0
    fused = tk.intersect_mesh_instances_cand_fused(
        rays, inst_tbl, inst_bounds, tri_tbl, mesh.tri_bounds, mesh.tri_chunk,
        n_ic, rounds=rounds)
    loop = tk.intersect_mesh_instances_cand(rays, inst_tbl, inst_bounds,
                                            tri_tbl, mesh.tri_bounds,
                                            mesh.tri_chunk, n_ic,
                                            rounds=rounds)
    assert_equal(fused, loop)


def tri_case(variant, chunk, dev):
    """(inst_tbl, inst_bounds, rays, cand, tri_tbl, tri_bounds) for the
    triangle-chunk culls of B8 and B10: mesh_case's 600 instances over a
    128-face geosphere (two scan tiles), its 24 instances over a
    2,048-face one (four face tiles) with a ragged ray count, a batch of
    dead lanes, one live lane in it, or tests/test_torch_tri_culls.py's
    hand scene (grazing rays, origins inside, tangent rays, segments
    ending on a hit). cand: B5's first candidates, or the hand scene's
    instances. The triangle table's spheres at `chunk`."""
    if variant == "hand":
        from test_torch_tri_culls import hand_scene
        inst_tbl, inst_bounds, rays, cand, (tri_tbl, _) = hand_scene(
            chunk=chunk)
        inst_tbl, inst_bounds, rays, cand, tri_tbl = (
            x.to(dev) for x in (inst_tbl, inst_bounds, rays, cand, tri_tbl))
    else:
        k, n, tess = {"600": (600, 3001, 3), "2048": (24, 2049, 5)}.get(
            variant, (24, 1024, 3))
        mesh, rays, (inst_tbl, inst_bounds, _, _) = mesh_case(
            k, n, tess, seed=k + n + chunk, dev=dev,
            dead=variant in ("dead", "one"))
        if variant == "one":
            rays[7, 516] = 1e9  # an even lane: aimed at an instance
        tri_tbl = mesh.tri_tbl
        bscan = tk.make_bscan_table(inst_tbl)
        key = tk.bound_scan(rays, bscan, torch.full(
            (n,), -1, dtype=torch.int32, device=dev), inst_bounds,
            inst_tbl.shape[1])
        mask = (1 << ik.pos_bits(bscan.shape[0])) - 1
        cand = torch.where(key < ik.INF_BITS, key & mask,
                           inst_tbl.shape[1]).to(torch.int32)
    tri_bounds = torch.from_numpy(tk.tri_chunk_bounds(
        tri_tbl.cpu().numpy(), chunk)).to(dev)
    return inst_tbl, inst_bounds, rays, cand, tri_tbl, tri_bounds


TRI_VARIANTS = ("600", "2048", "dead", "one", "hand")


@pytest.mark.parametrize("chunk", sorted({8, 32, tk.TRI_CHUNK}))
@pytest.mark.parametrize("variant", TRI_VARIANTS)
def test_anyhit_tri_culls_equal_walk(dev, variant, chunk):
    """B8's triangle-chunk culls change no bit: equal to the unculled plain
    version and to shared_blas_any_walk at chunks 8, 32 and the kept one,
    with the full ranges and with every other live tmax cut to 3 units."""
    inst_tbl, _, rays, cand, tri_tbl, tri_bounds = tri_case(variant, chunk,
                                                            dev)
    occ = torch.zeros(rays.shape[1], dtype=torch.int32, device=dev)
    short = rays.clone()
    short[7, ::2] = torch.clamp(short[7, ::2], max=3.0)
    for batch in (rays, short):
        before = backend.LAUNCHES["shared_blas_any"]
        out = tk.shared_blas_any(batch, cand, occ, inst_tbl, tri_tbl,
                                 tri_bounds, chunk)
        assert backend.LAUNCHES["shared_blas_any"] == before + 1
        assert torch.equal(out, tk.shared_blas_any_plain(
            batch, cand, occ, inst_tbl, tri_tbl))
        walked = tk.shared_blas_any_walk(batch, cand, occ, inst_tbl, tri_tbl,
                                         tri_bounds, chunk)[0]
        assert torch.equal(out, walked)
        assert int(out.sum()) > 0 or variant in ("dead", "one")


@pytest.mark.parametrize("chunk", sorted({8, 32, tk.TRI_CHUNK}))
@pytest.mark.parametrize("variant,rounds", [
    ("600", 4), ("2048", 5), ("dead", 3), ("one", 1), ("hand", 2),
    ("hand", 3)])
def test_fused_tri_culls_equal_walk(dev, variant, rounds, chunk):
    """B10 with the scan's and the sweep's culls equals its unculled plain
    version, cand_fused_walk and the multi-launch loop, best, binst and
    key bit for bit, at chunks 8, 32 and the kept one, over 1 to 5
    rounds."""
    inst_tbl, inst_bounds, rays, _, tri_tbl, tri_bounds = tri_case(
        variant, chunk, dev)
    bscan = tk.make_bscan_table(inst_tbl)
    args = (rays, bscan, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk,
            rounds)
    out = tk.cand_fused(*args)
    assert_equal(out, tk.cand_fused_plain(*args))
    assert_equal(out, tk.cand_fused_walk(*args)[0])
    assert_equal(out, tk.cand_loop(rays, bscan, inst_tbl, inst_bounds,
                                   tri_tbl, tri_bounds, chunk, rounds))
    found = int((out[0] < ik.INF_BITS).sum())
    assert found == 0 if variant == "dead" else found > 0


@pytest.mark.parametrize("margin", [True, False])
def test_tri_culls_with_the_wrappers_margin(dev, margin, monkeypatch):
    """B8 and B10 on the hand scene cull with the margin and guard the
    wrappers pass: at TRI_CULL_SCALE and TRI_GUARD they equal the plain
    versions; with both set to 0 they equal the walks of the same
    settings, which drop hits on grazing rays."""
    inst_tbl, inst_bounds, rays, cand, tri_tbl, tri_bounds = tri_case(
        "hand", tk.TRI_CHUNK, dev)
    occ = torch.zeros(rays.shape[1], dtype=torch.int32, device=dev)
    fused = (rays, tk.make_bscan_table(inst_tbl), inst_tbl, inst_bounds,
             tri_tbl, tri_bounds, tk.TRI_CHUNK, 1)
    plain8 = tk.shared_blas_any_plain(rays, cand, occ, inst_tbl, tri_tbl)
    plain10 = tk.cand_fused_plain(*fused)
    if not margin:
        monkeypatch.setattr(tk, "TRI_CULL_SCALE", 0.0)
        monkeypatch.setattr(tk, "TRI_GUARD", 0.0)
    out8 = tk.shared_blas_any(rays, cand, occ, inst_tbl, tri_tbl, tri_bounds,
                              tk.TRI_CHUNK)
    assert torch.equal(out8, tk.shared_blas_any_walk(
        rays, cand, occ, inst_tbl, tri_tbl, tri_bounds, tk.TRI_CHUNK)[0])
    out10 = tk.cand_fused(*fused)
    assert_equal(out10, tk.cand_fused_walk(*fused)[0])
    assert torch.equal(out8, plain8) == margin
    assert torch.equal(out10[0], plain10[0]) == margin


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("variant", ["600", "2048", "dead", "hand"])
def test_sweep_kernel_culls_exactly(dev, variant, chunk):
    """B6 with the triangle-chunk culls changes no bit: equal to its
    unculled plain version and to the fold of its culled walk
    (shared_blas_sweep_work) at chunks 8 and 32, over two rounds (the
    second folding into the first's best), with a 2,048-face table (four
    shared-memory tiles) and 600 instances at ragged ray counts, a batch
    of dead lanes, the hand scene's grazing rays, candidates -1 and m_tbl,
    and lanes whose incoming best (t = 0) is at or before every face."""
    inst_tbl, _, rays, cand, tri_tbl, tri_bounds = tri_case(variant, chunk,
                                                            dev)
    n, m_tbl = rays.shape[1], inst_tbl.shape[1]
    cand = cand.clone()
    cand[1::7] = -1
    cand[2::7] = m_tbl
    best = torch.full((n,), ik.INF_BITS, dtype=torch.int32, device=dev)
    binst = torch.zeros(n, dtype=torch.int32, device=dev)
    best[3::5] = 0
    binst[3::5] = 7
    for _ in range(2):
        args = (rays, cand, best, binst, inst_tbl, tri_tbl)
        before = backend.LAUNCHES["shared_blas_sweep"]
        out = tk.shared_blas_sweep(*args, tri_bounds, chunk)
        assert backend.LAUNCHES["shared_blas_sweep"] == before + 1
        assert_equal(out, tk.shared_blas_sweep_plain(*args))
        assert_equal(out, tk.shared_blas_sweep_work(*args, tri_bounds,
                                                    chunk)[0])
        # A best of t = 0 stays, but for a hit at t = -0.0 (a ray in a
        # face's plane from the face), whose packed word is negative.
        kept = out[0][3::5] == best[3::5]
        assert bool((kept | (out[0][3::5] < 0)).all())
        assert torch.equal(out[1][3::5][kept], binst[3::5][kept])
        none = (cand < 0) | (cand >= m_tbl)
        assert torch.equal(out[0][none], best[none])
        best, binst = out
        cand = torch.where((cand >= 0) & (cand < m_tbl - 1), cand + 1, cand)
    found = int((best[torch.arange(n, device=dev) % 5 != 3]
                 < ik.INF_BITS).sum())
    assert found == 0 if variant == "dead" else found > 0


def b9_case(live, dev, n=4099, k=600, seed=3):
    """B9's inputs: k instances at scales 0.5, 1 and 2 of a 1,024-face mesh
    (two geospheres of 512 faces, the second moved and shrunk: two
    shared-memory face tiles) and n rays, every other one aimed near an
    instance and half of the live ones ending short of 12 units. `live`:
    that many live lanes scattered over the batch, or "all", or "mixed":
    blocks of 1 live lane, 256, 40 in one warp, 100 scattered, 63 and 64
    (B9_SPARSE_LIVE's neighbours), the rest dead."""
    rng = np.random.RandomState(seed)
    pos, nrm, uv, faces = geometry.create_geosphere(2.0, 4)
    mesh = trimesh.make_mesh(
        np.concatenate([pos, pos * 0.5 + 0.3]), np.concatenate([nrm, nrm]),
        np.concatenate([uv, uv]), np.concatenate([faces, faces + len(pos)]),
        device=dev)
    assert mesh.tri_tbl.shape[0] == 1024
    ipos = np.asarray(rng.randn(k, 3) * 8, np.float32)
    rot = rng.randn(k, 4)
    rot = np.asarray(rot / np.linalg.norm(rot, axis=1, keepdims=True),
                     np.float32)
    scale = np.asarray(rng.choice([0.5, 1.0, 2.0], k), np.float32)
    o = np.asarray(rng.randn(n, 3) * 12, np.float32)
    d = rng.randn(n, 3)
    d[::2] = (ipos[rng.randint(0, k, n)] + 0.3 * rng.randn(n, 3) - o)[::2]
    d = np.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), np.float32)
    tmax = np.where(rng.rand(n) < 0.5, 12.0 * rng.rand(n), 1e9)
    keep = np.zeros(n, bool)
    if live == "all":
        keep[:] = True
    elif live == "mixed":
        for b, lanes in enumerate((
                [77], range(256), range(96, 136), rng.choice(256, 100, False),
                rng.choice(256, 63, False), rng.choice(256, 64, False))):
            keep[256 * b + np.asarray(list(lanes))] = True
    else:
        keep[rng.choice(n, live, replace=False)] = True
    tmax = np.asarray(np.where(keep, tmax, -1.0), np.float32)
    rays = intersect.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(n), torch.from_numpy(tmax)).to(dev)
    inst_tbl, inst_bounds, _, n_ic = tk.make_inst_tables(
        torch.from_numpy(ipos).to(dev), torch.from_numpy(rot).to(dev),
        torch.from_numpy(scale).to(dev), mesh.bound_radius,
        sort_origin=torch.from_numpy(o.mean(0)).to(dev))
    return ((rays, inst_tbl, inst_bounds, mesh.tri_tbl, mesh.tri_bounds,
             mesh.tri_chunk, n_ic), int(keep.sum()))


@pytest.mark.parametrize("live", [1, 5, 31, 33, 200, "all", "mixed"])
def test_anyhit_serial_kernel_paths_equal_plain(dev, live, monkeypatch):
    """B9's sparse path (a block's threads share its live rays) and its
    dense path (a thread per compacted live lane) each equal the plain
    version and its culled walk, bit for bit: on 1, 5, 31, 33 and 200
    live lanes scattered
    through 4,099, on every lane live, and on a batch with blocks of 1
    live lane, 256, 40 in one warp, 100, 63 and 64, at the wrapper's
    B9_SPARSE_LIVE, with every block sparse (257) and with every block
    dense (0); 600 instances at scales 0.5, 1 and 2 and a table of two
    face tiles."""
    args, n_live = b9_case(live, dev)
    plain = tk.intersect_mesh_instances_any_plain(*args)
    assert torch.equal(tk.intersect_mesh_instances_any_walk(*args)[0], plain)
    for sparse_live in (tk.B9_SPARSE_LIVE, 257, 0):
        monkeypatch.setattr(tk, "B9_SPARSE_LIVE", sparse_live)
        before = backend.LAUNCHES["intersect_mesh_instances_any"]
        out = tk.intersect_mesh_instances_any(*args)
        assert (backend.LAUNCHES["intersect_mesh_instances_any"]
                == before + 1)
        assert torch.equal(out, plain)
    blocked = int(plain.sum())
    assert blocked <= n_live and (blocked > 0 or n_live < 31)
    assert blocked < n_live or n_live < 31


@pytest.mark.parametrize("margin", [True, False])
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_anyhit_serial_kernel_culls_with_the_wrappers_margin(
        dev, scale, margin, monkeypatch):
    """B9 on the hand scene's rays built for the instance of scale 0.5, 1
    or 2 culls triangle chunks with the margin and guard the wrapper
    passes, on both paths: at TRI_CULL_SCALE and TRI_GUARD it equals the
    plain version; with both set to 0 it equals the culled walk of the
    same settings, which drops hits on grazing rays."""
    from test_torch_tri_culls import b9_hand
    rays, inst, bounds, tri_tbl, tri_bounds, n_ic = b9_hand(scale)
    args = (rays, inst, bounds, tri_tbl, tri_bounds, tk.TRI_CHUNK, n_ic)
    plain = tk.intersect_mesh_instances_any_plain(*args)
    if not margin:
        monkeypatch.setattr(tk, "TRI_CULL_SCALE", 0.0)
        monkeypatch.setattr(tk, "TRI_GUARD", 0.0)
    walked = tk.intersect_mesh_instances_any_walk(*args)[0]
    on_dev = tuple(x.to(dev) if torch.is_tensor(x) else x for x in args)
    for sparse_live in (tk.B9_SPARSE_LIVE, 257, 0):
        monkeypatch.setattr(tk, "B9_SPARSE_LIVE", sparse_live)
        out = tk.intersect_mesh_instances_any(*on_dev).cpu()
        assert torch.equal(out, walked)
    assert torch.equal(out, plain) == margin


def compact_first_frame(device, mesh, **cfg_kw):
    """One compact_from=1 path-trace frame of the demo scene (oscillator
    grid 3; with `mesh` as tessellation-1 instances, no accel, else the
    Morton accel) at 48x48, 6 bounces, seen from (0, 1, -5)."""
    from drts_tpu_torch.models import myscene
    from drts_tpu_torch.ops import camera, pathtrace
    host = myscene.build(oscillator_grid=3, device=device)
    if mesh:
        host = myscene.as_mesh_scene(host, tessellation=1)
    eye = np.array([0.0, 1.0, -5.0])
    cam = camera.make_camera(tuple(eye), tuple(-eye / np.linalg.norm(eye)),
                             aspect=1.0, device=device)
    accel = None
    if not mesh:
        plan = clusters.build_plan_morton(host.scene.center.cpu().numpy(),
                                          host.scene.radius.cpu().numpy(),
                                          max_members=8, device=device)
        accel = clusters.make_morton_accel(plan, host.scene.center,
                                           host.scene.radius,
                                           sort_origin=cam.position)
    cfg = pathtrace.PathTraceConfig(width=48, height=48, bounces=6,
                                    block_size=4096, compact_from=1,
                                    compact_fraction=4, **cfg_kw)
    return pathtrace.trace_image(host.scene, cam, cfg, 3, accel=accel)


@pytest.mark.parametrize("mesh", [False, True], ids=["spheres", "mesh"])
@pytest.mark.parametrize("variant", ["key", "partition", "ragged",
                                     "spill", "no_spill"])
def test_compact_first_trace_card_equals_cpu(dev, mesh, variant):
    """compact_from=1 on the card (B1 or the mesh kernels) against the CPU
    (plain versions): the key sort, the partition at every capacity
    (compact_sort_partition_min=0), the partition over ragged 20-pixel
    tiles (48 = 2 x 20 + 8), and a deep capacity of 32 slots with the
    spill wave and with overflow_spill=False. The rays, the spill waves
    and the overflow count are equal, and the radiance within 1e-3 on >=
    99.5% of pixels, 1e-5 on average (plain PyTorch ops may round
    differently on the card)."""
    kw = {"key": {}, "partition": {"compact_sort_partition_min": 0},
          "ragged": {"compact_sort_partition_min": 0,
                     "compact_sort_tile": 20},
          "spill": {"compact_capacity": 32},
          "no_spill": {"compact_capacity": 32,
                       "overflow_spill": False}}[variant]
    before = dict(backend.LAUNCHES)
    card = compact_first_frame(dev, mesh, **kw)
    launched = {k: v - before[k] for k, v in backend.LAUNCHES.items()}
    cpu = compact_first_frame("cpu", mesh, **kw)
    assert card.spill_waves == cpu.spill_waves
    assert (card.spill_waves > 0) == (variant == "spill")
    kernel = "intersect_mesh_instances" if mesh else "intersect_morton"
    assert launched[kernel] >= 7
    assert float(card.rays_traced) == float(cpu.rays_traced)
    assert (float(card.counters["wavefront_overflow_paths"])
            == float(cpu.counters["wavefront_overflow_paths"]))
    if variant == "no_spill":
        assert float(cpu.counters["wavefront_overflow_paths"]) > 0
    d = (card.radiance.cpu() - cpu.radiance).abs()
    assert torch.isfinite(card.radiance).all()
    assert float(d.mean()) <= 1e-5, float(d.mean())
    assert float((d.amax(-1) <= 1e-3).float().mean()) >= 0.995
    assert torch.equal(card.is_diffuse.cpu(), cpu.is_diffuse)


def texture_case(words, n=4099, seed=0):
    """A packed texture set of 2 or 3 words (64^2 baked at 32) and per-lane
    (set id, uv): random uv over [-0.3, 1.3]^2, then the edges a frame
    rarely reaches (u below 0.5/S, u = 0 and 1, v = 0 and 1), set id -1,
    ids past the last set, and uv NaN or infinite on invalid lanes."""
    from drts_tpu_torch.models import material, texpack
    rng = np.random.RandomState(seed)
    atlas = rng.random_sample((4, 64, 64, 4)).astype(np.float32)
    md = material.MaterialDesc
    descs = [md(base_color_map=0, normal_map=1, metallic_map=2,
                roughness_map=3),
             md(base_color_map=1, normal_map=0)]
    if words == 3:
        descs.append(md(emissive_color_map=2, transmission_map=3,
                        emissive_strength=2.0, emissive_color=(1, 1, 1)))
    packed, mats = texpack.build(atlas, material.pack_materials(descs,
                                                                "cpu"),
                                 size=32)
    uv = rng.uniform(-0.3, 1.3, (n, 2)).astype(np.float32)
    s = packed.size
    edges = [[0.1 / s, 0.5], [0.49 / s, 0.0], [0.0, 1.0], [1.0, 0.0],
             [0.5, 1.0], [np.nan, 0.5], [0.5, np.nan], [np.inf, -np.inf],
             [1.0 - 1e-7, 1.0], [-1e-7, 0.5]]
    uv[:len(edges)] = edges
    obj = rng.randint(0, len(descs), n)
    return packed, mats, obj, uv


def to_dev(x, dev):
    import dataclasses
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_dev(getattr(x, f.name), dev)
                          for f in dataclasses.fields(x)})
    return x.to(dev) if torch.is_tensor(x) else x


@pytest.mark.parametrize("filt", ["bilinear", "nearest", "nearest0"])
@pytest.mark.parametrize("words", [2, 3])
def test_sample_packed_on_the_card(dev, words, filt):
    """shading.sample_packed on the card against the CPU, through every
    index clamp: no device assert, every channel within 1e-6 (the same
    separately rounded operations), finite everywhere, NaN uv read as 0."""
    from drts_tpu_torch.ops import shading
    packed, _, _, uv = texture_case(words)
    rng = np.random.RandomState(1)
    n_sets = packed.rows.shape[0] // packed.size ** 2
    sets = torch.from_numpy(rng.randint(-1, n_sets + 2, uv.shape[0]))
    sets[:4] = -1
    uv_t = torch.from_numpy(uv)
    cpu = shading.sample_packed(packed, sets, uv_t, filt)
    card = shading.sample_packed(to_dev(packed, dev), sets.to(dev),
                                 uv_t.to(dev), filt)
    torch.cuda.synchronize()
    zero = shading.sample_packed(packed, sets, torch.nan_to_num(
        uv_t, nan=0.0, posinf=0.0, neginf=0.0), filt)
    for f in ("base_rgb", "alpha", "normal_xy", "metallic", "roughness",
              "emissive_rgb", "transmission"):
        c, g = getattr(cpu, f), getattr(card, f).cpu()
        assert torch.isfinite(g).all(), f
        assert float((c - g).abs().max()) <= 1e-6, f
        assert torch.equal(c, getattr(zero, f)), f


@pytest.mark.parametrize("words", [2, 3])
def test_evaluate_material_on_the_card(dev, words):
    """shading.evaluate_material with a normal map on the card against the
    CPU on the same edge cases: within 1e-6, the perturbed normal too."""
    from drts_tpu_torch.ops import shading
    packed, mats, obj, uv = texture_case(words, seed=2)
    rng = np.random.RandomState(3)
    nrm = rng.randn(uv.shape[0], 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = rng.randn(uv.shape[0], 3).astype(np.float32)
    args = [mats.gather(torch.from_numpy(obj))] + [
        torch.from_numpy(x) for x in (uv, nrm, tan)]
    cpu = shading.evaluate_material(*args, packed, "bilinear")
    card = shading.evaluate_material(*[to_dev(a, dev) for a in args],
                                     to_dev(packed, dev), "bilinear")
    torch.cuda.synchronize()
    for f in ("base_color", "alpha", "emission", "metallic", "roughness",
              "transmission", "shading_normal"):
        c, g = getattr(cpu, f), getattr(card, f).cpu()
        assert torch.isfinite(g).all(), f
        assert float((c - g).abs().max()) <= 1e-6, f


def _shell_settings(size=64):
    """The reference's GraphicsSettings() at `size` x `size` (SR Auto:
    rendered at half), 3 bounces and the smallest SHARC cache (2^16)."""
    import dataclasses

    from drts_tpu_torch import config
    s = config.GraphicsSettings(render_width=size, render_height=size)
    return dataclasses.replace(
        s, raytracing=dataclasses.replace(s.raytracing, bounces=3),
        sharc=dataclasses.replace(s.sharc, capacity_log2=16)).check()


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A 64x64 default-graph FrameState saved from the card and restored
    to the card by resume_or_init: every leaf equal, on the card, and the
    host frame count back."""
    from drts_tpu_torch.models import myscene, pipeline
    from drts_tpu_torch.utils import checkpoint
    cfg = pipeline.PipelineConfig.from_settings(_shell_settings())
    pipe = pipeline.RenderPipeline(cfg, dev)
    host = myscene.build(oscillator_grid=3, device=dev)
    state, pose = pipe.init_state(host), pipe.default_camera_pose(host)
    for _ in range(3):
        state, _ = pipe.render_frame(state, pose)
    checkpoint.save_rotating(state, str(tmp_path))
    pipe2 = pipeline.RenderPipeline(cfg, dev)
    restored, ok = checkpoint.resume_or_init(pipe2, str(tmp_path), host)
    assert ok and restored.frame_count == 3
    saved, back = checkpoint.flatten(state), checkpoint.flatten(restored)
    assert set(saved) == set(back)
    on_card = 0
    for k, v in back.items():
        # Host numbers flatten to CPU tensors; every tensor of the state
        # stays on the card.
        assert v.device == saved[k].device, k
        on_card += v.device.type == "cuda"
        assert torch.equal(v.cpu(), saved[k].cpu()), k
    # frame_count, scene.alpha_test_rounds and the bodies' spring_rest_y,
    # earth_index and star_index are the host numbers.
    assert on_card == len(back) - 5


def test_session_card_against_cpu(dev):
    """One Session on the card and one on the CPU from one start state
    (the CPU's, restored onto the card), 64x64 output rendered at 32x32,
    through two frames, a dynamic set, a frame, a static set and a frame:
    each image within chip_smoke.py's DEFAULT_* bounds (mean |difference|
    <= 2e-4; <= 0.2% of pixels off by more than 0.05)."""
    from drts_tpu_torch import session
    from drts_tpu_torch.models import myscene
    from drts_tpu_torch.utils import checkpoint
    sessions = [session.Session(
        _shell_settings(), host=myscene.build(oscillator_grid=3, device=d),
        device=d) for d in ("cpu", dev)]
    cpu, card = sessions
    card.state = checkpoint.restore_flat(card.state,
                                         checkpoint.flatten(cpu.state))
    script = [None, None, ("post.exposure", "1.5"), ("raytracing.bounces",
                                                      "2")]
    for change in script:
        if change is not None:
            assert cpu.set(*change) == card.set(*change)
        a, b = cpu.step(), card.step().cpu()
        assert b.shape == (64, 64, 3) and torch.isfinite(b).all()
        d = (a - b).abs()
        off = float((d.amax(-1) > 0.05).float().mean())
        assert float(d.mean()) <= 2e-4 and off <= 2e-3, (change,
                                                          float(d.mean()),
                                                          off)


def _banded_config(height=64):
    from drts_tpu_torch.models import pipeline
    from drts_tpu_torch.ops import sharc
    return pipeline.PipelineConfig(
        output_width=64, output_height=height, render_width=64,
        render_height=height, bounces=2, block_size=4096,
        sharc=sharc.SHARCConfig(capacity_log2=12))


def test_one_nccl_rank_equals_the_unbanded_frame(dev):
    """A 64x64 default-graph frame banded over one NCCL rank against
    render_frame(group=None) from the same state, on a SHARC skip frame
    (no float atomics): the image and every FrameState leaf bit for bit,
    the same launches."""
    import torch.distributed as dist

    from drts_tpu_torch import graft_entry
    from drts_tpu_torch.parallel import mesh, multihost
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    pipe, state, pose = graft_entry._setup(_banded_config(), dev, 3)
    state, _ = pipe.render_frame(state, pose)     # frame 1 skips SHARC
    assert multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                device="cuda")
    try:
        backend.reset_launches()
        s_g, img_g = pipe.render_frame(state, pose,
                                       group=multihost.global_group())
        launches = dict(backend.LAUNCHES)
        backend.reset_launches()
        s_n, img_n = pipe.render_frame(state, pose)
        assert launches == backend.LAUNCHES
        assert torch.equal(img_g, img_n)
        assert mesh.replica_checksums(s_g) == mesh.replica_checksums(s_n)
    finally:
        dist.destroy_process_group()


def test_one_nccl_rank_graph_frame_equals_the_eager_banded_frame(dev):
    """Three 64x64 default-graph frames banded over one NCCL rank through
    render_frame_graph()(..., group=) against the eager banded frame from
    the same state: bit for bit (the image and every FrameState leaf) on
    the SHARC skip frame, within chip_smoke.py's DEFAULT_* bounds on the
    update frames (the splat's float atomics); each eager frame's kernel
    launches those its phase's capture holds plus its spill waves'."""
    import torch.distributed as dist

    from drts_tpu_torch import graft_entry, graphs
    from drts_tpu_torch.ops import pathtrace
    from drts_tpu_torch.parallel import mesh, multihost
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    pipe, state, pose = graft_entry._setup(_banded_config(), dev, 3)
    assert multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                device="cuda")
    try:
        group = multihost.global_group()
        call = pipe.render_frame_graph()
        for i in range(3):
            update = state.frame_count % pipe.cfg.sharc_update_period == 0
            waves = []

            def decide(overflow, wave1):
                run = overflow.item() > 0
                if run:
                    wave1()
                waves.append(int(run))
                return int(run)
            backend.reset_launches()
            with pathtrace.spill_hook(decide):
                s_e, img_e = pipe.render_frame(state, pose, group=group)
            launches = {k: v for k, v in backend.LAUNCHES.items() if v}
            s_g, img_g = call(state, pose, group=group)
            cap = call.stats.captured_launches[state.frame_count
                                               % call.cycle]
            want = dict(cap["frame"])
            for sp in cap["spill_waves"][:sum(waves)]:
                for k, v in sp.items():
                    want[k] = want.get(k, 0) + v
            assert launches == want, (i, launches, want)
            if update:
                mean, off = image_off(img_e, img_g)
                assert mean <= 2e-4 and off <= 2e-3, (i, mean, off)
            else:
                assert torch.equal(img_g, img_e), i
                assert (mesh.replica_checksums(s_g)
                        == mesh.replica_checksums(s_e)), i
            state = graphs.clone_tree(s_g)
        assert call.stats.frames == 3
    finally:
        dist.destroy_process_group()


def test_banded_trace_graph_equals_the_eager_banded_trace(dev):
    """The banded trace as CUDA graphs: graft_entry.banded_trace(graph=
    True) over one NCCL rank (the dry run's 32x32 mesh recipe) equals
    graph=False bit for bit, and trace_image_graph(cfg, rows=(8, 24))
    equals trace_image(..., rows=(8, 24)) bit for bit on a band of 16 of
    the 32 rows, frames 0 and 1."""
    import torch.distributed as dist

    from drts_tpu_torch import graft_entry
    from drts_tpu_torch.models import myscene
    from drts_tpu_torch.ops import camera, pathtrace
    from drts_tpu_torch.parallel import multihost
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    host = myscene.as_mesh_scene(myscene.build(oscillator_grid=4,
                                               device=dev), tessellation=2)
    cfg = pathtrace.PathTraceConfig(width=32, height=32, bounces=2,
                                    samples_per_pixel=1, block_size=4096,
                                    compact_from=2)
    assert multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                device="cuda")
    try:
        group = multihost.global_group()
        got = graft_entry.banded_trace(group, host, cfg, graph=True)
        want = graft_entry.banded_trace(group, host, cfg)
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()
    cam = camera.make_camera(host.camera_position, host.camera_forward,
                             aspect=1.0, device=dev)
    call = pathtrace.trace_image_graph(cfg, rows=(8, 24))
    for index in (0, 1):
        out = call(host.scene, cam, index)
        ref = pathtrace.trace_image(host.scene, cam, cfg, index,
                                    rows=(8, 24))
        assert out.radiance.shape == (16, 32, 3)
        assert torch.equal(out.radiance, ref.radiance), index


@pytest.mark.parametrize("ranks,height", [(2, 64), (3, 64)],
                         ids=["even", "uneven"])
def test_gloo_ranks_on_the_card_near_one_device(dev, tmp_path, ranks,
                                                height):
    """Two frames sharded over gloo ranks sharing the card (two: bands of
    32 rows; three: bands of 21, 21 and 22 rows, and 5, 5 and 6 rows of
    the SHARC update trace) against the one-device frames: the ranks'
    image bands together within chip_smoke.py's DEFAULT_* bounds (mean
    |difference| <= 2e-4; <= 0.2% of pixels off by more than 0.05), every
    leaf shaped as the placement says, the replicated leaves equal on
    every rank."""
    from drts_tpu_torch import graft_entry
    from drts_tpu_torch.parallel import mesh, multihost
    cfg = _banded_config(height)
    multihost.spawn(graft_entry.frames_worker, ranks, "cuda",
                    backend_name="gloo",
                    args=([cfg], 2, str(tmp_path), 3, None, "cuda"))
    runs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)[0]
            for r in range(ranks)]
    pipe, state, pose = graft_entry._setup(cfg, dev, 3)
    for i in range(2):
        state, img = pipe.render_frame(state, pose)
        whole = torch.cat([run["images"][i] for run in runs])
        d = (whole - img.cpu()).abs()
        off = float((d.amax(-1) > 0.05).float().mean())
        assert float(d.mean()) <= 2e-4 and off <= 2e-3, (
            i, float(d.mean()), off)
    assert all(not run["misplaced"] for run in runs)
    assert all(run["checksums"] == runs[0]["checksums"] for run in runs)
    assert not mesh.replicas_differ(runs[0]["checksums"])
    assert [run["band"] for run in runs] == [
        mesh.row_band(height, r, ranks) for r in range(ranks)]
    assert all(run["launches"]["intersect_morton"] > 0 for run in runs)


def test_graft_entry_frame_on_the_card(dev):
    """graft_entry.entry()'s frame step (the flagship pipeline at 256x256,
    4 bounces), called once on the card: a finite (256, 256, 3) image that
    launched B1."""
    from drts_tpu_torch import graft_entry
    fn, args = graft_entry.entry(device="cuda")
    backend.reset_launches()
    image = fn(*args)
    assert tuple(image.shape) == (256, 256, 3)
    assert image.device.type == "cuda"
    assert bool(torch.isfinite(image).all())
    assert backend.LAUNCHES["intersect_morton"] > 0


# B12a, B12b (the tensor-core Morton kernels) and B13 (cluster-culled)

# B12 against its plain version: the tensor cores sum the bf16 products in
# their own order and with their own rounding, coarser than the plain
# version's float32 matmuls (measured on an H100 on the demo frame's
# primary rays: the kernel differs from the product summed in float64 in
# 18,958 words where the float32 plain version does in 7,037). Hit/miss may
# flip only on rays that graze a sphere (|distance(line, centre) - r| <
# MXU_GRAZE) and on at most MXU_FLIP_SHARE of the live rays (the
# reference's share for its MXU kernel). MXU_GRAZE is this port's own
# limit, not the reference's 1e-3 (tests/test_post_denoise.py:300, on a
# scene of small coordinates): the error in the discriminant grows with
# the square of the coordinates' scale, and on the demo scene an H100
# showed flips up to 0.026 (B12a) and 0.039 (B12b). Where no sphere is
# within MXU_STRICT of grazing, t agrees within MXU_T_RTOL relative plus
# MXU_T_ATOL absolute (the reference's margins, tests/test_post_denoise.py:
# 304-310; the sums' error in c0 moves a root by δc0 / (2 sqrt(disc))),
# and the object index is the plain version's, or one that the plain
# version's own pair test meets at its t within that tolerance (a tie, the
# reference's index rule, :316-319). With the chunk cull off
# (MXU_CULL_SCALE infinite) the kernels give every word they give with it.
# The same limits hold at each precision, the kernel and its plain version
# differing by the sums' order alone: "highest" splits the operands exactly
# and "high" as the plain version does. At "default" both take the same
# single bf16 pass, which moves each discriminant by up to ~2^-5 S^2
# (intersect_kernels.MXU_CULL_SCALE) from the exact one, so grazing there
# is measured on the plain version's own quadratic (own_grazing: the
# radius its discriminant implies), not on the spheres; the sums' order
# moves that measure no more than at "high". A flip also comes where a
# root lies within the sums' error of tmin or tmax (one B12b ray of the
# 300,001-ray case at "default" on an H100, own margin 0.20), so there
# own_grazing counts a pair whose root lies within MXU_T_RTOL |t| +
# MXU_T_ATOL of either end as grazing (margin 0).
MXU_GRAZE = 5e-2
MXU_FLIP_SHARE = 5e-3
MXU_STRICT = 3e-2
MXU_T_RTOL = 1e-3
MXU_T_ATOL = 1e-2


def grazing(rays, centers, radii):
    """(N,) float64: min over spheres of |distance(ray line, centre) - r|."""
    o = rays[:3].T.double().cpu().numpy()
    d = rays[3:6].T.double().cpu().numpy()
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    out = np.empty(o.shape[0])
    for s in range(0, o.shape[0], 2048):
        oc = o[s:s + 2048, None, :] - centers[None].astype(np.float64)
        perp = oc - (oc * d[s:s + 2048, None, :]).sum(-1, keepdims=True) \
            * d[s:s + 2048, None, :]
        out[s:s + 2048] = np.abs(np.linalg.norm(perp, axis=-1)
                                 - radii[None]).min(1)
    return torch.from_numpy(out)


def own_grazing(rays, accel, step=32768):
    """(N,) float64: min over the table's filled columns of
    |sqrt(r^2 - disc) - r|, disc the plain version's own discriminant at
    MXU_PREC: its grazing margin (for unit directions, disc = r^2 -
    distance^2); 0 for a column whose root (the tail's: near, else far)
    lies within MXU_T_RTOL |t| + MXU_T_ATOL of tmin or tmax."""
    out = torch.empty(rays.shape[1], dtype=torch.float64)
    r = accel.table[3][None, :].double()
    for s in range(0, rays.shape[1], step):
        part = rays[:, s:s + step]
        b2, c2 = ik.mxu_coefficients(part, accel.mxu_a, accel.chunk)
        disc = (b2 * b2 - c2).double()
        dist = torch.sqrt(torch.clamp(r * r - disc, min=0.0))
        graze = torch.where(r > 0, (dist - r).abs(), float("inf"))
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tmin, tmax = (x.double()[:, None] for x in part[6:8])
        t = torch.where(-b2 - sq >= tmin, -b2 - sq, sq - b2)
        tol = MXU_T_RTOL * t.abs() + MXU_T_ATOL
        edge = (disc >= 0) & (((t - tmin).abs() <= tol)
                              | ((t - tmax).abs() <= tol))
        out[s:s + step] = torch.where(edge, 0.0, graze).amin(1).cpu()
    return out


def mxu_grazing(rays, centers, radii, accel):
    """The grazing margin the MXU_* limits read at MXU_PREC: the plain
    version's own at "default", the spheres' (grazing) at the others."""
    if ik.MXU_PREC == "default":
        return own_grazing(rays, accel)
    return grazing(rays, centers, radii)


def mxu_resident(accel, prec):
    """Whether B12's table image (per chunk, 8-slot groups of 4 fragments
    of 8 bytes a part and an object each, the bound and the count) fits
    the 92 KB that a block keeps resident."""
    pad = (accel.chunk + 7) // 8 * 8
    image = accel.n_chunks * (pad * (32 * ik.MXU_PARTS[prec] + 4) + 20)
    return image <= 92 * 1024


def assert_mxu_close(out, plain, rays, graze, accel):
    (t_k, i_k), (t_p, i_p) = [(t.cpu(), i.cpu()) for t, i in (out, plain)]
    live = (rays[7] >= rays[6]).cpu()
    flip = torch.isfinite(t_k) != torch.isfinite(t_p)
    assert not bool((flip & ~live).any())
    assert bool((graze[flip] < MXU_GRAZE).all())
    assert int(flip.sum()) <= MXU_FLIP_SHARE * max(int(live.sum()), 1)
    both = torch.isfinite(t_k) & torch.isfinite(t_p)
    strict = both & (graze > MXU_STRICT)
    assert torch.allclose(t_k[strict], t_p[strict], rtol=MXU_T_RTOL,
                          atol=MXU_T_ATOL)
    # A differing index is a tie: the plain version's own pair test meets
    # the kernel's object at the plain version's t.
    diff = strict & (i_k != i_p)
    if not bool(diff.any()):
        return
    trunc = ~((1 << ik.pos_bits(accel.table.shape[1])) - 1)
    pairs = ik.mxu_closest_pairs(rays[:, diff.to(rays.device)],
                                 accel.table, accel.mxu_a, accel.chunk,
                                 trunc).cpu()
    mine = accel.table[4].to(torch.int32).cpu()[None, :] == i_k[diff][:, None]
    word = torch.where(mine, pairs, ik.INF_BITS).amin(1)
    t_obj, t_ref = (word & trunc).view(torch.float32), t_p[diff]
    assert bool((word != ik.INF_BITS).all())
    assert bool(((t_obj - t_ref).abs() <= MXU_T_RTOL * t_ref + MXU_T_ATOL)
                .all())


def assert_same_with_cull_off(fn, out, monkeypatch):
    """`fn` run again with the MXU chunk cull off gives every word of
    `out`."""
    with monkeypatch.context() as m:
        m.setitem(ik.MXU_CULL_SCALE, ik.MXU_PREC, float("inf"))
        again = fn()
    if isinstance(out, tuple):
        assert_equal(out, again)
    else:
        assert torch.equal(out, again)


def mxu_case(k, n, chunk, seed, dev):
    centers, radii, rays = random_case(k, n, seed)
    plan = clusters.build_plan_morton(centers, radii, max_members=chunk,
                                      device=dev)
    accel = clusters.make_morton_accel(
        plan, torch.from_numpy(centers).to(dev),
        torch.from_numpy(radii).to(dev), sort_origin=rays[:3].mean(1).to(dev))
    accel = dataclasses.replace(accel, mxu_a=clusters.make_mxu_tables(
        accel.table, accel.n_chunks, accel.chunk))
    return centers, radii, accel, rays.to(dev).contiguous()


def dead_warps(rays):
    """Every other warp of 32 lanes dead, but for one live lane in the
    first dead warp."""
    lane = torch.arange(rays.shape[1], device=rays.device)
    dead = ((lane // 32) % 2 == 1) & (lane != 45)
    rays[7] = torch.where(dead, -1.0, rays[7])


@pytest.mark.parametrize("prec", ["high", "default", "highest"])
@pytest.mark.parametrize("k,n,chunk,variant,path", [
    (1500, 3001, 32, "aimed", "tiled"), (43, 257, 8, "aimed", "resident"),
    (300, 1000, 16, "aimed", "resident"), (1500, 2049, 64, "aimed", "tiled"),
    (200, 777, 12, "aimed", "resident"), (300, 1000, 32, "dead", "resident"),
    (300, 300001, 32, "aimed", "resident"),
    (1500, 140001, 64, "aimed", "tiled"),
    (300, 5000, 32, "dead warps", "resident"),
    (3000, 4001, 64, "aimed", "tiled")])
def test_mxu_closest_kernel_near_plain(dev, k, n, chunk, variant, path,
                                       prec, monkeypatch):
    """B12a against its plain version: chunks of 8, 12 (padded to 16 in
    shared memory), 16, 32 and 64 slots, ragged ray counts, partly filled
    chunks (empty slots), within the MXU_* tolerances; it launches once,
    and its walk's lanes cull chunks. Tables of up to 92 KB stay resident
    in each block of the persistent grid, larger ones (1,500 spheres in
    chunks of 32 or 64) take the tiled loop (three tiles at 64); 300,001
    and 140,001 rays are more than one persistent wave of blocks can hold,
    with a ragged end, and give the words that launches of sub-batches
    below one wave give. "dead" is a batch of dead lanes only: no hit;
    "dead warps" kills every other warp but for one lane. Each case runs
    at the three precisions; `path` is "high"'s and "highest"'s, and
    "default"'s smaller image keeps the 1,500-sphere tables resident (the
    3,000-sphere one is tiled at every precision)."""
    monkeypatch.setattr(ik, "MXU_PREC", prec)
    centers, radii, accel, rays = mxu_case(k, n, chunk, k + n, dev)
    if variant == "dead":
        rays[7] = -1.0
    if variant == "dead warps":
        dead_warps(rays)
    info = ik.intersect_morton_mxu_info(accel.table, accel.bounds, n)
    assert info["resident"] == mxu_resident(accel, prec)
    if prec != "default":
        assert info["resident"] == (path == "resident")
    assert info["local_bytes"] == 0
    if n > 100000:
        assert n > info["grid"] * info["threads"]
    else:
        assert info["grid"] == -(-n // info["threads"])
    before = backend.LAUNCHES["intersect_morton_mxu"]
    out = ik.intersect_morton_mxu(rays, accel.table, accel.bounds,
                                  accel.mxu_a)
    assert backend.LAUNCHES["intersect_morton_mxu"] == before + 1
    if n > 100000:
        # The persistent grid's loop over blocks of rays, bit for bit: the
        # same warps of 32 rays in launches below one wave.
        step = 65536
        assert step < info["grid"] * info["threads"]
        assert_equal(out, [torch.cat(x) for x in zip(*(
            ik.intersect_morton_mxu(rays[:, s:s + step].contiguous(),
                                    accel.table, accel.bounds, accel.mxu_a)
            for s in range(0, n, step)))])
    plain = ik.intersect_morton_mxu_plain(rays, accel.table, accel.bounds,
                                          accel.mxu_a)
    assert_mxu_close(out, plain, rays,
                     mxu_grazing(rays, centers, radii, accel), accel)
    assert_same_with_cull_off(
        lambda: ik.intersect_morton_mxu(rays, accel.table, accel.bounds,
                                        accel.mxu_a), out, monkeypatch)
    assert bool((accel.bounds[4] < chunk).any())
    if variant == "dead":
        assert not bool(torch.isfinite(out[0]).any())
        assert not bool(out[1].any())
        return
    assert bool(torch.isfinite(out[0]).any())
    met, _, _ = ik.mxu_chunk_walk(rays, accel.table, accel.bounds,
                                  accel.mxu_a)
    if prec != "default":   # "default" runs with the cull off
        assert float(met[rays[7] >= rays[6]].float().mean()) < 0.9


@pytest.mark.parametrize("prec", ["high", "default", "highest"])
@pytest.mark.parametrize("k,n,chunk,variant", [
    (1500, 3001, 32, "aimed"), (43, 257, 8, "aimed"), (300, 1000, 16,
                                                       "exclude"),
    (1500, 2049, 64, "exclude"), (200, 777, 12, "aimed"),
    (300, 1000, 32, "dead"), (300, 300001, 32, "aimed"),
    (1500, 140001, 64, "aimed"), (300, 5000, 32, "dead warps"),
    (3000, 4001, 64, "aimed")])
def test_mxu_occlusion_kernel_near_plain(dev, k, n, chunk, variant, prec,
                                         monkeypatch):
    """B12b against its plain version at chunks of 8 to 64 slots, ragged
    ray counts and shadow-ray ranges (tmax 30 x a uniform number): hit bits
    may flip only on grazing rays (MXU_GRAZE, MXU_FLIP_SHARE); "exclude"
    excludes on every ray the sphere it aims at, "dead" is a batch of dead
    lanes only (nothing occluded), "dead warps" kills every other warp but
    for one lane. Tables of up to 92 KB stay resident in each block of the
    persistent grid, those of 1,500 spheres take the tiled loop; 300,001
    and 140,001 rays are more than one persistent wave holds, and give the
    bits that launches of sub-batches below one wave give. Each case runs
    at the three precisions ("default" keeps the 1,500-sphere tables
    resident; the 3,000-sphere one is tiled at every precision)."""
    monkeypatch.setattr(ik, "MXU_PREC", prec)
    centers, radii, accel, rays = mxu_case(k, n, chunk, k + n + 1, dev)
    rng = np.random.RandomState(n)
    live = rays[7] >= rays[6]
    tmax = torch.from_numpy(np.asarray(30.0 * rng.rand(n), np.float32))
    rays[7] = torch.where(live, tmax.to(dev), -1.0)
    if variant == "dead":
        rays[7] = -1.0
    if variant == "dead warps":
        dead_warps(rays)
    live = rays[7] >= rays[6]
    info = ik.occlusion_morton_mxu_info(accel.table, accel.bounds, n)
    assert info["resident"] == mxu_resident(accel, prec)
    assert info["resident"] == (k < 1500 or (prec == "default"
                                             and k < 3000))
    assert info["local_bytes"] == 0
    if n > 100000:
        assert n > info["grid"] * info["threads"]
    else:
        assert info["grid"] == -(-n // info["threads"])
    exclude = torch.full((n,), -1.0)
    if variant == "exclude":
        o = rays[:3].T.cpu().numpy()
        d = rays[3:6].T.cpu().numpy()
        aim = ((centers[None] - o[:, None]) * d[:, None]).sum(-1)
        perp = np.linalg.norm(centers[None] - o[:, None] - aim[..., None]
                              * d[:, None], axis=-1)
        exclude = torch.from_numpy(np.argmin(perp - radii[None], 1)
                                   .astype(np.float32))
    rays9 = torch.cat([rays, exclude[None].to(dev)]).contiguous()
    before = backend.LAUNCHES["occlusion_morton_mxu"]
    occ = ik.occlusion_morton_mxu(rays9, accel.table, accel.bounds,
                                  accel.mxu_a).cpu()
    assert backend.LAUNCHES["occlusion_morton_mxu"] == before + 1
    if n > 100000:
        # The persistent grid's loop over blocks of rays, bit for bit: the
        # same warps of 32 rays in launches below one wave.
        step = 65536
        assert step < info["grid"] * info["threads"]
        assert torch.equal(occ, torch.cat([ik.occlusion_morton_mxu(
            rays9[:, s:s + step].contiguous(), accel.table, accel.bounds,
            accel.mxu_a).cpu() for s in range(0, n, step)]))
    plain = ik.occlusion_morton_mxu_plain(rays9, accel.table, accel.bounds,
                                          accel.mxu_a).cpu()
    assert_same_with_cull_off(
        lambda: ik.occlusion_morton_mxu(rays9, accel.table, accel.bounds,
                                        accel.mxu_a).cpu(), occ, monkeypatch)
    graze = mxu_grazing(rays, centers, radii, accel)
    flip = occ != plain
    assert bool((graze[flip] < MXU_GRAZE).all())
    assert int(flip.sum()) <= MXU_FLIP_SHARE * max(int(live.sum()), 1)
    if variant == "dead":
        assert not bool(occ.any())
    else:
        assert bool(occ.any()) and not bool(occ.all())


def filled_case(n, seed):
    """Clusters of 32, 12 and 1 filled slots (40 small spheres in one xz
    cell of 4, 12 in another, one bigger than half a cell) and 60 spread,
    with every other ray aimed near a sphere."""
    centers, radii, rays = random_case(113, n, seed)
    rng = np.random.RandomState(seed)
    centers[:40, 0] = 0.5 + 3.0 * rng.rand(40)
    centers[:40, 2] = 0.5 + 3.0 * rng.rand(40)
    centers[40:52, 0] = 8.5 + 3.0 * rng.rand(12)
    centers[40:52, 2] = 0.5 + 3.0 * rng.rand(12)
    centers[52:, 0] = np.where(centers[52:, 0] < 12, centers[52:, 0] - 12,
                               centers[52:, 0])
    radii[52] = 2.5
    o = rays[:3].T.numpy()
    aim = centers[rng.randint(0, 113, n)] - o
    d = np.where(np.arange(n)[:, None] % 2 == 0, aim, rays[3:6].T.numpy())
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[3:6] = torch.from_numpy(np.asarray(d, np.float32)).T
    return centers, radii, rays


@pytest.mark.parametrize("k,n,variant", [
    (438, 3001, "aimed"), (55, 257, "aimed"), (700, 2048, "inside"),
    (300, 1000, "dead"), (130, 1001, "finite"), (438, 300001, "aimed"),
    (3000, 5001, "tiled"), (113, 4001, "filled"),
    (438, 5000, "dead warps")])
def test_clustered_kernel_equals_plain(dev, k, n, variant):
    """B13 against its plain version, every word equal: xz-binned plans
    whose cluster count is no multiple of 8 (padded bound columns) and
    whose clusters hold empty slots, ragged ray counts, rays that start
    inside a cluster bound ("inside": origins at cluster centres, some
    inside a member), a batch of dead lanes only, finite tmax. Plans of up
    to 92 KB stay resident in each block of the persistent grid; "tiled"
    spreads 3,000 spheres over ~1,000 clusters (beyond 92 KB: the tiled
    loop over clusters); 300,001 rays are more than one persistent wave
    of blocks can hold, with a ragged end; "filled" holds clusters of 32,
    12 and 1 filled slots; "dead warps" kills every other warp but for
    one lane."""
    if variant == "filled":
        centers, radii, rays = filled_case(n, seed=k + n + 2)
    else:
        centers, radii, rays = random_case(k, n, seed=k + n + 2)
        radii[::50] = 2.5    # bigger than half a cell: singleton clusters
    if variant == "tiled":
        centers[:, [0, 2]] *= 8.0
    plan = clusters.build_plan(centers, radii, device=dev)
    accel = clusters.make_accel(plan, torch.from_numpy(centers).to(dev),
                                torch.from_numpy(radii).to(dev))
    if variant == "inside":
        at = accel.bounds_tbl[:3, :accel.n_clusters].T.cpu()
        rays[:3] = at[torch.arange(n) % accel.n_clusters].T
        rays[7] = torch.where(rays[7] >= rays[6], 1e9, -1.0)
    if variant == "dead":
        rays[7] = -1.0
    if variant == "finite":
        live = rays[7] >= rays[6]
        rays[7] = torch.where(live, torch.from_numpy(np.asarray(
            20.0 * np.random.RandomState(n).rand(n), np.float32)), -1.0)
    if variant == "dead warps":
        dead_warps(rays)
    rays = rays.to(dev).contiguous()
    if variant != "filled":
        assert accel.n_clusters % 8 != 0
    assert bool((accel.members_tbl[:, 3] == 0).any())
    filled = ik.clustered_filled(accel.members_tbl, accel.n_clusters,
                                 accel.max_members)
    if variant == "filled":
        assert {1, 12, 32} <= set(filled.tolist())
    info = ik.intersect_clustered_info(accel.n_clusters, accel.max_members,
                                       n)
    assert info["resident"] == (variant != "tiled")
    assert info["local_bytes"] == 0
    if n > 100000:
        assert n > info["grid"] * info["threads"]
    before = backend.LAUNCHES["intersect_clustered"]
    out = ik.intersect_clustered(rays, accel.bounds_tbl, accel.members_tbl,
                                 accel.n_clusters, accel.max_members)
    assert backend.LAUNCHES["intersect_clustered"] == before + 1
    assert_equal(out, ik.intersect_clustered_plain(
        rays, accel.bounds_tbl, accel.members_tbl, accel.n_clusters,
        accel.max_members))
    if variant == "dead":
        assert not bool(torch.isfinite(out[0]).any())
        assert not bool(out[1].any())
    else:
        assert bool(torch.isfinite(out[0]).any())


def test_routes_dispatch_on_the_card(dev, monkeypatch):
    """intersect_spheres and intersect_spheres_any with a ClusteredAccel
    launch B13 (the any hit through the closest hit), and under the MXU
    opt-in a MortonAccel launches B12a and B12b, not B1 or B2."""
    centers, radii, rays = random_case(438, 2000, seed=5)
    c, r = torch.from_numpy(centers).to(dev), torch.from_numpy(radii).to(dev)
    o, d = rays[:3].T.to(dev), rays[3:6].T.to(dev)
    tmax = rays[7].to(dev)
    acc = clusters.make_accel(clusters.build_plan(centers, radii, device=dev),
                              c, r)
    backend.reset_launches()
    hit = intersect.intersect_spheres(o, d, 0.0, tmax, c, r, accel=acc)
    occ = intersect.intersect_spheres_any(o, d, 0.0, tmax, accel=acc,
                                          centers=c, radii=r,
                                          exclude_index=hit.index)
    assert backend.LAUNCHES["intersect_clustered"] == 2
    assert not bool(occ.any())   # the closest hit is the excluded one
    monkeypatch.setattr(clusters, "_USE_MXU", True)
    macc = clusters.make_morton_accel(
        clusters.build_plan_morton(centers, radii, device=dev), c, r)
    assert macc.mxu_a is not None
    backend.reset_launches()
    intersect.intersect_spheres(o, d, 0.0, tmax, c, r, accel=macc)
    intersect.intersect_spheres_any(o, d, 0.0, tmax, accel=macc)
    assert backend.LAUNCHES["intersect_morton_mxu"] == 1
    assert backend.LAUNCHES["occlusion_morton_mxu"] == 1
    assert backend.LAUNCHES["intersect_morton"] == 0
    assert backend.LAUNCHES["occlusion_morton"] == 0


# ---------------------------------------------------------------------------
# The graph frames (drts_tpu_torch/graphs.py): replays against eager frames.

GRAPH_EYE, GRAPH_TARGET = (0.0, 2.5, -4.0), (0.0, 0.5, 0.0)


def graph_setup(dev, cfg):
    from drts_tpu_torch.models import myscene, pipeline
    pipe = pipeline.RenderPipeline(cfg, dev)
    state = pipe.init_state(myscene.build(oscillator_grid=3, device=dev))
    eye = torch.tensor(GRAPH_EYE)
    fwd = torch.tensor(GRAPH_TARGET) - eye
    pose = pipeline.CameraPose(eye.to(dev), (fwd / fwd.norm()).to(dev),
                               torch.tensor([0.0, 1.0, 0.0]).to(dev))
    return pipe, state, pose


def word_bits(t):
    return t if t.dtype == torch.bool else t.reshape(-1).view(torch.uint8)


def tensor_leaves(tree):
    from drts_tpu_torch.utils.checkpoint import leaves
    return [(p, t) for p, t in leaves(tree) if isinstance(t, torch.Tensor)]


def run_graph_frames(pipe, state, pose, graph, dts, resets=None):
    """Frames from `state` (images cloned: a graph call rewrites them);
    returns (the last state, cloned, and the images)."""
    from drts_tpu_torch import graphs
    call = pipe.render_frame_graph() if graph else pipe.render_frame
    images = []
    for i, dt in enumerate(dts):
        reset = bool(resets and resets[i])
        state, img = call(state, pose, dt, reset=reset)
        images.append(img.clone())
    return graphs.clone_tree(state), images, call


def image_off(a, b, limit=0.05):
    d = (a.float() - b.float()).abs()
    return float(d.mean()), float((d.amax(-1) > limit).float().mean())


def test_graph_restir_frame_equals_eager(dev):
    """The ReSTIR frame (no SHARC: no float atomics) at 64x64 through four
    graph replays (dt and reset changing) equals the eager frames bit for
    bit: images, every state leaf, the counters."""
    from drts_tpu_torch import graphs
    from drts_tpu_torch.models import pipeline
    pipe, state, pose = graph_setup(dev, pipeline.restir_frame_config(
        64, 64, 3))
    dts, resets = (1 / 60, 1 / 120, 1 / 30, 1 / 60), (0, 0, 1, 0)
    se, ie, _ = run_graph_frames(pipe, state, pose, False, dts, resets)
    sg, ig, call = run_graph_frames(pipe, state, pose, True, dts, resets)
    assert call.stats.frames == 4 and len(call.stats.capture_s) == 2
    for a, b in zip(ie, ig):
        assert torch.equal(word_bits(a), word_bits(b))
    for (p, a), (_, b) in zip(tensor_leaves(se),
                              tensor_leaves(sg)):
        assert torch.equal(word_bits(a), word_bits(b)), p
    assert sg.frame_count == se.frame_count == 4


def test_graph_default_frame_near_eager(dev):
    """The default frame (SHARC's splat sums with float atomics) at 64x64,
    four frames: two eager runs from one start differ by some amount; the
    graph frames stay within chip_smoke.py's DEFAULT_* bounds of the eager
    ones and within that run-to-run amount plus those bounds; the bodies
    (no atomics) equal bit for bit, the counters within 2% + 2."""
    from drts_tpu_torch.ops import sharc
    from drts_tpu_torch.models import pipeline
    cfg = pipeline.PipelineConfig(
        output_width=64, output_height=64, render_width=64,
        render_height=64, bounces=3, block_size=4096,
        sharc=sharc.SHARCConfig(capacity_log2=12))
    pipe, state, pose = graph_setup(dev, cfg)
    dts = (1 / 60,) * 4
    se, ie, _ = run_graph_frames(pipe, state, pose, False, dts)
    se2, ie2, _ = run_graph_frames(pipe, state, pose, False, dts)
    sg, ig, call = run_graph_frames(pipe, state, pose, True, dts)
    for a, a2, b in zip(ie, ie2, ig):
        spread = image_off(a, a2)
        mean, off = image_off(a, b)
        assert mean <= 2e-4 + spread[0] and off <= 2e-3 + spread[1], (
            mean, off, spread)
    assert torch.equal(sg.bodies.position, se.bodies.position)
    for k, v in se.counters.items():
        g = float(sg.counters[k])
        assert abs(g - float(v)) <= 0.02 * max(abs(float(v)), abs(g)) + 2, k
    assert call.stats.frames == 4


def test_graph_dt_reaches_the_physics(dev):
    """Each replay reads the call's dt: the graph frames' bodies equal the
    eager frames' bit for bit under a changing dt and move otherwise than
    under a fixed one."""
    from drts_tpu_torch.models import pipeline
    pipe, state, pose = graph_setup(dev, pipeline.restir_frame_config(
        32, 32, 2))
    dts = (1 / 60, 1 / 240, 1 / 30, 1 / 100)
    se, _, _ = run_graph_frames(pipe, state, pose, False, dts)
    sg, _, _ = run_graph_frames(pipe, state, pose, True, dts)
    sf, _, _ = run_graph_frames(pipe, state, pose, True, (1 / 60,) * 4)
    for name in ("position", "velocity", "rotation"):
        assert torch.equal(getattr(sg.bodies, name),
                           getattr(se.bodies, name)), name
    assert not torch.equal(sg.bodies.position, sf.bodies.position)


def test_graph_session_resume_equals_eager_resume(dev, tmp_path):
    """A checkpoint of three eager Session frames, resumed by an eager
    Session and by Session(graph=True): three more frames each (a static
    set before the last), images within the DEFAULT_* bounds plus the
    run-to-run spread of two eager resumes, the host frame count equal."""
    from drts_tpu_torch import session
    from drts_tpu_torch.models import myscene
    from drts_tpu_torch.utils import checkpoint

    def make(graph=False):
        return session.Session(_shell_settings(),
                               host=myscene.build(oscillator_grid=3,
                                                  device=dev),
                               device=dev, graph=graph)
    first = make()
    for _ in range(3):
        first.step()
    checkpoint.save_rotating(first.state, str(tmp_path))
    runs = []
    for graph in (False, False, True):
        s = make(graph)
        s.state, ok = checkpoint.resume_or_init(s.pipe, str(tmp_path),
                                                s.host)
        assert ok and s.state.frame_count == 3
        images = []
        for i in range(3):
            if i == 2:
                assert s.set("raytracing.bounces", "2") == "static"
            images.append(s.step().clone())
        runs.append((s.state.frame_count, images))
    (c0, e0), (_, e1), (cg, g) = runs
    assert c0 == cg == 6
    for a, a2, b in zip(e0, e1, g):
        spread = image_off(a, a2)
        mean, off = image_off(a, b)
        assert mean <= 2e-4 + spread[0] and off <= 2e-3 + spread[1], (
            mean, off, spread)


def mesh_graph_setup(dev, cfg):
    """graph_setup's pipeline and pose on the demo scene as instances of a
    tessellation-1 geosphere (myscene.as_mesh_scene)."""
    from drts_tpu_torch.models import myscene
    pipe, _, pose = graph_setup(dev, cfg)
    host = myscene.as_mesh_scene(myscene.build(oscillator_grid=3,
                                               device=dev), tessellation=1)
    return pipe, pipe.init_state(host), pose


def test_graph_mesh_trace_equals_eager(dev):
    """The mesh trace (bench_mesh's frame) at 64x64, 3 bounces, at
    MESH_CAND 0, 1 and 2, with a 64-slot deep segment (the spill wave) and
    the default one: four graph replays each equal trace_image's frames
    bit for bit (radiance, rays, overflow), with the same spill waves."""
    from drts_tpu_torch.models import myscene
    from drts_tpu_torch.ops import camera, pathtrace
    scene = myscene.as_mesh_scene(myscene.build(oscillator_grid=3,
                                                device=dev),
                                  tessellation=1).scene
    eye = np.array(GRAPH_EYE)
    fwd = np.array(GRAPH_TARGET) - eye
    cam = camera.make_camera(tuple(eye), tuple(fwd / np.linalg.norm(fwd)),
                             horizontal_fov_deg=90.0, aspect=1.0,
                             device=dev)
    old = trimesh.MESH_CAND
    waves = {}
    try:
        for cand in (0, 1, 2):
            for capacity in (64, 0):
                trimesh.MESH_CAND = cand
                cfg = pathtrace.PathTraceConfig(
                    width=64, height=64, bounces=3, block_size=32768,
                    compact_from=2, compact_capacity=capacity)
                call = pathtrace.trace_image_graph(cfg)
                for i in range(4):
                    want = pathtrace.trace_image(
                        scene, cam, cfg, torch.tensor(i, device=dev))
                    got = call(scene, cam, i)
                    assert got.spill_waves == want.spill_waves
                    waves[cand, capacity] = waves.get((cand, capacity), 0) \
                        + got.spill_waves
                    for name in ("radiance", "rays_traced"):
                        assert torch.equal(
                            word_bits(getattr(got, name)),
                            word_bits(getattr(want, name))), (cand, name)
                    assert torch.equal(
                        got.counters["wavefront_overflow_paths"],
                        want.counters["wavefront_overflow_paths"])
    finally:
        trimesh.MESH_CAND = old
    assert all(waves[c, 64] == 4 and waves[c, 0] == 0 for c in (0, 1, 2)), \
        waves


def test_graph_mesh_restir_frame_equals_eager(dev):
    """The all-mesh ReSTIR frame (physics on, no SHARC) at 64x64 through
    four graph replays (dt and reset changing) equals the eager frames bit
    for bit: images and every state leaf."""
    from drts_tpu_torch.models import pipeline
    pipe, state, pose = mesh_graph_setup(dev, pipeline.restir_frame_config(
        64, 64, 3))
    dts, resets = (1 / 60, 1 / 120, 1 / 30, 1 / 60), (0, 0, 1, 0)
    se, ie, _ = run_graph_frames(pipe, state, pose, False, dts, resets)
    sg, ig, call = run_graph_frames(pipe, state, pose, True, dts, resets)
    assert call.stats.frames == 4 and len(call.stats.capture_s) == 2
    for a, b in zip(ie, ig):
        assert torch.equal(word_bits(a), word_bits(b))
    for (p, a), (_, b) in zip(tensor_leaves(se), tensor_leaves(sg)):
        assert torch.equal(word_bits(a), word_bits(b)), p


def test_graph_mesh_pipeline_near_eager(dev):
    """The all-mesh pipeline (bench.mesh_pipeline_config: compact_from=1,
    SHARC, ReBLUR, TAA, physics off) rendered at 32x32 and upscaled to
    64x64, the bounce-1 segment in partition mode, four frames: the graph
    frames stay within the DEFAULT_* bounds plus the run-to-run spread of
    two eager runs, with the eager frames' spill waves."""
    from drts_tpu_torch import bench
    from drts_tpu_torch.ops import sharc
    cfg = bench.mesh_pipeline_config(
        output_width=64, output_height=64, render_width=32,
        render_height=32, bounces=3, block_size=4096,
        sharc=sharc.SHARCConfig(capacity_log2=12))
    pipe, state, pose = mesh_graph_setup(dev, cfg)
    base = pipe._pt_cfg
    pipe._pt_cfg = lambda: dataclasses.replace(
        base(), compact_sort_partition_min=0)
    dts = (1 / 60,) * 4
    _, ie, _ = run_graph_frames(pipe, state, pose, False, dts)
    _, ie2, _ = run_graph_frames(pipe, state, pose, False, dts)
    _, ig, call = run_graph_frames(pipe, state, pose, True, dts)
    for a, a2, b in zip(ie, ie2, ig):
        spread = image_off(a, a2)
        mean, off = image_off(a, b)
        assert mean <= 2e-4 + spread[0] and off <= 2e-3 + spread[1], (
            mean, off, spread)
        assert bool(torch.isfinite(b).all())
    assert call.stats.frames == 4 and len(call.stats.capture_s) == 2


def test_graph_mesh_session_near_eager(dev):
    """Session(host=<all-mesh>, graph=True) at GraphicsSettings() 64x64
    (rendered at 32x32, SHARC), three frames with a static set (3 to 2
    bounces) before the last: within the DEFAULT_* bounds plus the
    run-to-run spread of two eager Sessions."""
    from drts_tpu_torch import session
    from drts_tpu_torch.models import myscene
    runs = []
    for graph in (False, False, True):
        s = session.Session(
            _shell_settings(), host=myscene.as_mesh_scene(
                myscene.build(oscillator_grid=3, device=dev),
                tessellation=1), device=dev, graph=graph)
        images = []
        for i in range(3):
            if i == 2:
                assert s.set("raytracing.bounces", "2") == "static"
            images.append(s.step().clone())
        runs.append(images)
    for a, a2, b in zip(*runs):
        spread = image_off(a, a2)
        mean, off = image_off(a, b)
        assert mean <= 2e-4 + spread[0] and off <= 2e-3 + spread[1], (
            mean, off, spread)
        assert bool(torch.isfinite(b).all())


# The rest of the one-device frames as graphs: the options frame, the
# accel-none frame, the textured frame, the MXU route and the clustered
# accel.

OPTIONS_RESTIR = dict(spatial_bias_correction="raytraced",
                      temporal_bias_correction="raytraced",
                      temporal_prev_surface="real",
                      spatial_offset_mode="shared")


def assert_frames_equal(ie, ig, se, sg):
    for a, b in zip(ie, ig):
        assert torch.equal(word_bits(a), word_bits(b))
    for (p, a), (_, b) in zip(tensor_leaves(se), tensor_leaves(sg)):
        assert torch.equal(word_bits(a), word_bits(b)), p


@pytest.mark.parametrize("frame", ["options", "accel_none"])
def test_graph_route_frame_equals_eager(dev, frame):
    """The ReSTIR frame (no SHARC) at 64x64 with the options frame's
    choices (the thin lens, raytraced bias correction, the real previous
    surface, shared offsets: four frames, so that the offsets move) or
    with accel_mode="none": four graph replays (dt and reset changing)
    equal the eager frames bit for bit, images and every state leaf."""
    from drts_tpu_torch.models import pipeline
    from drts_tpu_torch.ops import restir
    if frame == "options":
        cfg = pipeline.restir_frame_config(
            64, 64, 3, aperture_radius=0.05, focus_distance=4.0,
            restir=restir.ReSTIRConfig(**OPTIONS_RESTIR))
    else:
        cfg = pipeline.restir_frame_config(64, 64, 3, accel_mode="none")
    pipe, state, pose = graph_setup(dev, cfg)
    dts, resets = (1 / 60, 1 / 120, 1 / 30, 1 / 60), (0, 0, 1, 0)
    se, ie, _ = run_graph_frames(pipe, state, pose, False, dts, resets)
    sg, ig, call = run_graph_frames(pipe, state, pose, True, dts, resets)
    assert call.stats.frames == 4 and len(call.stats.capture_s) == 2
    assert_frames_equal(ie, ig, se, sg)
    if frame == "accel_none":
        assert not any(call.stats.captured_launches[p]["frame"].get(k, 0)
                       for p in (0, 1) for k in ("intersect_morton",
                                                 "occlusion_morton"))


def test_graph_options_frame_offsets_move(dev):
    """The options frame's offsets reach every replay: four graph frames
    equal four eager frames bit for bit, while a callable whose offsets
    input is frozen at the first frame's (the capture's) differs."""
    from drts_tpu_torch.models import pipeline
    from drts_tpu_torch.ops import restir
    cfg = pipeline.restir_frame_config(
        64, 64, 2, restir=restir.ReSTIRConfig(spatial_offset_mode="shared"))
    pipe, state, pose = graph_setup(dev, cfg)
    dts = (1 / 60,) * 4
    se, ie, _ = run_graph_frames(pipe, state, pose, False, dts)
    sg, ig, _ = run_graph_frames(pipe, state, pose, True, dts)
    assert_frames_equal(ie, ig, se, sg)
    first = pipe.shared_offsets(0)
    frozen = pipe.shared_offsets
    pipe.shared_offsets = lambda frame_count: first
    try:
        _, iz, _ = run_graph_frames(pipe, state, pose, True, dts)
    finally:
        pipe.shared_offsets = frozen
    assert torch.equal(word_bits(iz[0]), word_bits(ie[0]))
    assert not all(torch.equal(word_bits(a), word_bits(b))
                   for a, b in zip(iz[1:], ie[1:]))


def test_graph_textured_frame_near_eager(dev):
    """The textured frame (PipelineConfig() at 64x64 on add_mesh_content
    of the demo scene: alpha rounds, packed textures, textured emitters),
    four frames: within the DEFAULT_* bounds plus the run-to-run spread
    of two eager runs; B3 captured nowhere (the triangle lights gate it
    off), the instance kernels captured."""
    from drts_tpu_torch.models import myscene, pipeline
    from drts_tpu_torch.ops import sharc
    cfg = pipeline.PipelineConfig(
        output_width=64, output_height=64, render_width=64,
        render_height=64, bounces=3, block_size=4096,
        sharc=sharc.SHARCConfig(capacity_log2=12))
    pipe, _, pose = graph_setup(dev, cfg)
    state = pipe.init_state(myscene.add_mesh_content(
        myscene.build(oscillator_grid=3, device=dev), tessellation=2))
    dts = (1 / 60,) * 4
    _, ie, _ = run_graph_frames(pipe, state, pose, False, dts)
    _, ie2, _ = run_graph_frames(pipe, state, pose, False, dts)
    _, ig, call = run_graph_frames(pipe, state, pose, True, dts)
    for a, a2, b in zip(ie, ie2, ig):
        spread = image_off(a, a2)
        mean, off = image_off(a, b)
        assert mean <= 2e-4 + spread[0] and off <= 2e-3 + spread[1], (
            mean, off, spread)
        assert bool(torch.isfinite(b).all())
    captured = call.stats.captured_launches
    assert all(captured[p]["frame"].get("initial_light_candidates", 0) == 0
               for p in (0, 1))
    for k in ("bound_scan", "shared_blas_sweep", "shared_blas_any",
              "intersect_mesh_instances_any", "intersect_morton"):
        assert captured[0]["frame"].get(k, 0) > 0, k


def mxu_trace_setup(dev, accel="morton"):
    """The headline frame's setup at 128x128, 4 bounces, on `accel`."""
    from drts_tpu_torch import bench
    return bench.make_trace_setup(128, 128, 4, oscillator_grid=4,
                                  device=dev, accel=accel)


def trace_frames(setup, graph, frames=4):
    """`frames` headline frames from index 1 (eager or through the graph
    callable); returns (radiance images cloned, the callable or None)."""
    from drts_tpu_torch import bench
    from drts_tpu_torch.ops import pathtrace
    call = (pathtrace.trace_image_graph(setup.cfg, setup.plan, setup.accel)
            if graph else None)
    out = []
    for i in range(1, frames + 1):
        o = (call(setup.scene, setup.cam, i) if graph
             else bench.trace_frame(setup, torch.tensor(i, device=setup.
                                                         scene.center.
                                                         device)))
        out.append(o.radiance.clone())
    return out, call


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
def test_graph_mxu_headline_near_eager(dev, prec, monkeypatch):
    """The headline frame on the MXU route at each DRTS_MXU_PREC: four
    graph replays against two eager runs; where the eager runs agree bit
    for bit (the tensor-core sums are the same each launch), the graph
    frames equal them; B12a captured, B1 not."""
    monkeypatch.setattr(clusters, "_USE_MXU", True)
    monkeypatch.setattr(ik, "MXU_PREC", prec)
    setup = mxu_trace_setup(dev)
    ie, _ = trace_frames(setup, False)
    ie2, _ = trace_frames(setup, False)
    ig, call = trace_frames(setup, True)
    for a, a2, b in zip(ie, ie2, ig):
        if torch.equal(word_bits(a), word_bits(a2)):
            assert torch.equal(word_bits(a), word_bits(b))
        else:
            assert image_off(a, b)[0] <= image_off(a, a2)[0]
    frame = call.stats.captured_launches[0]["frame"]
    assert frame.get("intersect_morton_mxu", 0) > 0
    assert frame.get("intersect_morton", 0) == 0


def test_graph_clustered_trace_equals_eager(dev):
    """The headline frame on the clustered accel: four graph replays equal
    bench.trace_frame's frames bit for bit; B13 captured, B1 and B11
    not."""
    setup = mxu_trace_setup(dev, "clustered")
    ie, _ = trace_frames(setup, False)
    ig, call = trace_frames(setup, True)
    for a, b in zip(ie, ig):
        assert torch.equal(word_bits(a), word_bits(b))
    frame = call.stats.captured_launches[0]["frame"]
    assert frame.get("intersect_clustered", 0) > 0
    assert frame.get("intersect_morton", 0) == frame.get(
        "intersect_brute", 0) == 0
