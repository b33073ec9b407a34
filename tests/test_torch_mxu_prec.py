"""B12a and B12b at the reference's three MXU precisions
(``DRTS_MXU_PREC``: "default", "high", "highest"; the port's contract is
in ``drts_tpu_torch/ops/intersect_kernels.py`` above MXU_PRODUCTS).

On tests/test_torch_mxu_clustered.py's case (2048 rays, 53 spheres, 8 to a
chunk; its ``case`` fixture): the splits and the products against JAX,
then the kernels' plain versions against the reference's Pallas kernels
in interpret mode at the same precision. The reference's jitted kernels
read the precision at trace time, so each reference run here patches
``intersect_pallas._MXU_PREC_NAME`` and ``_MXU_PRECISION`` and clears
JAX's caches before and after (its files stay as they are).

u = 2^-24 is float32's unit roundoff; a K-term float32 sum errs by at
most (K - 1) u of the sum of its terms' magnitudes (in any order), and a
bf16 rounding by at most 2^-8 of its operand.

Tolerances, each derived where it is used:
- the splits: bit for bit against the chain of ``astype(jnp.bfloat16)``
  casts;
- "default" product against ``jax.lax.dot_general`` of the bf16 operands
  with float32 accumulation (JAX's own single pass on the CPU): both sum
  the same 8 exact products, so they differ only by the two sums'
  rounding: a sum in pairs (log2 K = 3 levels, as vectorised kernels add)
  errs by at most 3 u of sum |a||x|, so the two by 6 u, within the K u =
  8 u that the test holds (in the worst order each could err by (K - 1) u,
  14 u between them; measured: 2.0 u at most, 99.9% of the elements bit
  for bit);
- "highest" product against ``intersect_pallas._mxu_dot`` under HIGHEST
  (a float32 dot on the CPU): 24 u of sum |a||x| (PROD_HIGHEST below;
  measured: 3.8 u);
- "high" product: bit for bit the formula it had before the other two
  precisions were added;
- the plain kernels at "highest" against interpret mode at HIGHEST: the
  flip and index margins of test_mxu_*_matches_interpret (flips only
  within 1e-3 of grazing and on < 0.5% of rays; the index equal where no
  sphere is within 3e-2), and there t within its 1e-4 relative plus the
  two products' own bound on the root (quadratic_bounds): the split is
  exact at "highest", so the two sides round independently where at
  "high" both take the same halves, and a near root of small t, -b -
  sqrt(D) with |b| large, keeps their float32 errors in b and D as an
  absolute error;
- the plain kernels at "default" against interpret mode at DEFAULT (a
  float32 dot on the CPU, not the single pass): the single pass's own
  bound, per pair from the exact quadratic (quadratic_bounds): a ray
  may flip only where a pair's exact discriminant lies within the bound
  or a root within its t bound of tmin or tmax, and elsewhere t agrees
  within the bound of the two winning pairs.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.ops import intersect_pallas as ip
from drts_tpu_torch import bench
from drts_tpu_torch.models import clusters as tclusters
from drts_tpu_torch.ops import camera as tcamera, intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik
from test_torch_mxu_clustered import (  # noqa: F401
    case, one_thread, port_morton)

U = 2.0 ** -24
K = 8
# "highest" against the float32 dot, relative to sum |a||x|: the port's
# hi.hi sum (K - 1) u (1 + 2^-8)^2, its five other sums < 0.1 u (their
# terms are at most 2^-8 of hi.hi's), its five float32 adds of the
# products 5 u (1 + 2^-7), the dropped mid.lo + lo.mid + lo.lo 2 u
# (1 + 2^-7), and the float32 dot's own sum (K - 1) u: < 21.3 u.
PROD_HIGHEST = 24 * U
# The single pass's error relative to sum |a||x| (the port's "default"):
# hi(a) hi(x) drops hi(a) (x - hi(x)) + (a - hi(a)) x, at most
# (2 2^-8 + 2^-16) (1 + 2^-8), and its K-term sum (K - 1) u.
EPS_DEFAULT = (2 * 2.0 ** -8 + 2.0 ** -16) * (1 + 2.0 ** -8) + (K - 1) * U
# "highest"'s on the CPU: the dropped mid.lo + lo.mid + lo.lo, 2 u
# (1 + 2^-7), hi.hi's sum (K - 1) u (1 + 2^-8)^2, the five other sums
# < 0.1 u and the five float32 adds 5 u (1 + 2^-7): < 14.3 u.
EPS_HIGHEST = 14.3 * U
# The float32 dot's (the reference's CPU run): its K-term sum.
EPS_F32 = (K - 1) * U


@contextlib.contextmanager
def reference_precision(name):
    """The reference's MXU precision patched to `name` for its jitted
    kernels (traced anew: JAX's caches cleared on entry and exit)."""
    old = (ip._MXU_PREC_NAME, ip._MXU_PRECISION)
    ip._MXU_PREC_NAME = name
    ip._MXU_PRECISION = (jax.lax.Precision.HIGHEST if name == "highest"
                         else jax.lax.Precision.DEFAULT)
    jax.clear_caches()
    try:
        yield
    finally:
        ip._MXU_PREC_NAME, ip._MXU_PRECISION = old
        jax.clear_caches()


def product_operands(c, monkeypatch):
    """The port's A-matrices and the case's rays as the product's X
    (8, N) [d, o, o.d, 1]."""
    acc = port_morton(c, monkeypatch)
    ox, oy, oz, dx, dy, dz = c["trays"][:6]
    x = torch.stack([dx, dy, dz, ox, oy, oz, ox * dx + oy * dy + oz * dz,
                     torch.ones_like(ox)])
    return acc, acc.mxu_a, x


def magnitude(a, x):
    """sum_k |a_ik||x_kj| in float64, (rows, N)."""
    return a.double().abs() @ x.double().abs()


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_split_matches_jax_casts(parts):
    """split_bf16's 1, 2 and 3 parts against the reference's chain of
    casts (hi = x.astype(bf16), then what x - hi, x - hi - mid leave), bit
    for bit, on values of 24 binades, both signs, zeros and ties of the
    rounding; and 3 parts add up to x exactly."""
    rng = np.random.RandomState(parts)
    x = (rng.randn(4096) * 2.0 ** rng.randint(-12, 12, 4096)).astype(
        np.float32)
    x[:4] = [0.0, -0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8)]
    got = ik.split_bf16(torch.from_numpy(x), parts)
    rest = jnp.asarray(x)
    for p, g in enumerate(got):
        want = rest.astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
        rest = rest - want
    assert len(got) == parts
    if parts == 3:
        np.testing.assert_array_equal(
            ((got[0] + got[1]) + got[2]).numpy(), x)


def test_default_product_matches_jax_single_pass(case, monkeypatch):
    """mxu_product at "default" against jax.lax.dot_general of the
    bf16-cast operands with preferred_element_type=float32: within
    K u = 8 u of sum |a||x| (the module's docstring derives it); and far
    from the float64 product, as one pass is: off by more than 2^-10 of
    sum |a||x| somewhere."""
    _, a, x = product_operands(case, monkeypatch)
    got = ik.mxu_product(a, x, "default").double().numpy()
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a.numpy()).astype(jnp.bfloat16),
        jnp.asarray(x.numpy()).astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32), np.float64)
    mag = magnitude(a, x).numpy()
    assert (np.abs(got - want) <= K * U * mag).all()
    exact = (a.double() @ x.double()).numpy()
    assert (np.abs(got - exact) > 2.0 ** -10 * mag).any()


def test_highest_product_matches_reference_dot(case, monkeypatch):
    """mxu_product at "highest" (bf16x6) against the reference's
    ``_mxu_dot`` under HIGHEST, within PROD_HIGHEST of sum |a||x|; and
    nearer the float64 product than "high" is, on every element that
    "high" misses by more than PROD_HIGHEST."""
    _, a, x = product_operands(case, monkeypatch)
    with reference_precision("highest"):
        want = np.asarray(ip._mxu_dot(jnp.asarray(a.numpy()),
                                      jnp.asarray(x.numpy())), np.float64)
    got = ik.mxu_product(a, x, "highest").double().numpy()
    mag = magnitude(a, x).numpy()
    assert (np.abs(got - want) <= PROD_HIGHEST * mag).all()
    exact = (a.double() @ x.double()).numpy()
    high = ik.mxu_product(a, x, "high").double().numpy()
    coarse = np.abs(high - exact) > PROD_HIGHEST * mag
    assert coarse.any()
    assert (np.abs(got - exact)[coarse] < np.abs(high - exact)[coarse]).all()


def test_high_product_unchanged(case, monkeypatch):
    """mxu_product at "high" and at MXU_PREC's default value is bit for
    bit the bf16x3 formula it had before the other precisions: (hi.hi +
    hi.lo) + lo.hi of the two halves."""
    _, a, x = product_operands(case, monkeypatch)
    a_hi = a.to(torch.bfloat16).to(torch.float32)
    a_lo = (a - a_hi).to(torch.bfloat16).to(torch.float32)
    x_hi = x.to(torch.bfloat16).to(torch.float32)
    x_lo = (x - x_hi).to(torch.bfloat16).to(torch.float32)
    want = (a_hi @ x_hi + a_hi @ x_lo) + a_lo @ x_hi
    assert ik.MXU_PREC == "high"
    for got in (ik.mxu_product(a, x, "high"), ik.mxu_product(a, x)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def occlusion_rays(c):
    """test_mxu_occlusion_plain_matches_interpret's rays9: tmax 25 x a
    uniform number, every third ray excluding its closest sphere."""
    macc, n = c["macc"], c["n"]
    rng = np.random.RandomState(11)
    rays = np.array(c["rays"])
    rays[7] = 25.0 * rng.rand(n)
    t_x, i_x = ip.intersect_morton_planar(
        jnp.asarray(rays[:8]), macc.bounds_tbl, macc.table, macc.n_chunks,
        macc.chunk, interpret=True)
    exclude = np.where(np.arange(n) % 3 == 0,
                       np.where(np.isfinite(np.asarray(t_x)), i_x, -1), -1)
    return np.concatenate([rays, exclude[None].astype(np.float32)])


def reference_kernels(c, rays9, name):
    """The reference's B12a (on the case's rays) and B12b (on rays9) in
    interpret mode at its precision `name`."""
    macc = c["macc"]
    with reference_precision(name):
        t, i = ip.intersect_morton_mxu(
            c["rays"], macc.bounds_tbl, macc.table, macc.mxu_a,
            macc.n_chunks, macc.chunk, interpret=True)
        occ = ip.occlusion_morton_mxu(
            jnp.asarray(rays9), macc.bounds_tbl, macc.table, macc.mxu_a,
            macc.n_chunks, macc.chunk, interpret=True)
    return np.asarray(t), np.asarray(i), np.asarray(occ)


def port_kernels(c, rays9, monkeypatch, prec):
    """The port's B12a and B12b (their plain versions: CPU tensors) at
    `prec`."""
    acc = port_morton(c, monkeypatch)
    monkeypatch.setattr(ik, "MXU_PREC", prec)
    t, i = ik.intersect_morton_mxu(c["trays"], acc.table, acc.bounds,
                                   acc.mxu_a, block=500)
    occ = ik.occlusion_morton_mxu(torch.from_numpy(rays9), acc.table,
                                  acc.bounds, acc.mxu_a, block=500)
    return acc, t.numpy(), i.numpy(), occ.numpy()


def column_of(table):
    """(max object + 1,) int64: each object's table column (-1: none)."""
    obj = table[4].to(torch.int64)
    filled = table[3] > 0
    out = torch.full((int(obj.max()) + 1,), -1, dtype=torch.int64)
    out[obj[filled]] = torch.nonzero(filled)[:, 0]
    return out


def test_highest_plain_kernels_match_interpret(case, monkeypatch):
    """B12a's and B12b's plain versions at "highest" against the
    reference's kernels in interpret mode at HIGHEST: flips only within
    1e-3 of grazing and on < 0.5% of rays, and where no sphere is within
    3e-2 the index equal and t within 1e-4 relative plus the root bound of
    quadratic_bounds (EPS_HIGHEST) of the port's winning pair
    (measured: no flip in either kernel; t within 3.7e-4 relative, at
    t = 0.08, and within 0.06 of the root bound)."""
    rays9 = occlusion_rays(case)
    t_ref, i_ref, occ_ref = reference_kernels(case, rays9, "highest")
    acc, t, i, occ = port_kernels(case, rays9, monkeypatch, "highest")
    fin, fin_ref = np.isfinite(t), np.isfinite(t_ref)
    flip = fin != fin_ref
    graze = case["graze"]
    assert fin_ref.mean() > 0.02
    assert flip.mean() < 0.005 and (graze[flip] < 1e-3).all()
    strict = graze > 3e-2
    assert strict.mean() > 0.9
    rows = np.nonzero(fin & fin_ref & strict)[0]
    np.testing.assert_array_equal(i[rows], i_ref[rows])
    _, _, _, _, e_t = quadratic_bounds(case["trays"], acc.mxu_a, acc.chunk,
                                       EPS_HIGHEST)
    col = column_of(acc.table)[i[rows]]
    lim = 1e-4 * t_ref[rows] + e_t[rows, col].numpy()
    assert (np.abs(t[rows].astype(np.float64) - t_ref[rows]) <= lim).all()
    assert 0.02 < occ_ref.mean() < 0.95
    oflip = occ != occ_ref
    assert oflip.mean() < 0.005 and (graze[oflip] < 1e-3).all()


def quadratic_bounds(rays, a, chunk, eps_port):
    """Per ray x table column, from the exact (float64) quadratic of the
    float32 operands: (b, disc, roots (2, N, cols), e_disc, e_t). e_disc
    bounds how far the port's discriminant (its product within eps_port
    of sum |a||x|) and the reference's float32 one each lie from it,
    summed; e_t bounds how far a root of either lies from the exact root
    (inf where the exact discriminant is within e_disc).

    Each side's b and c0 - |o|^2 lie within eps sum |a||x| of the exact
    product (eps_port, EPS_F32), o.d within 3 u sum |o_i d_i| (its
    float32 sum, which both take as an operand) and |o|^2 within 3 u |o|^2,
    so db = eps S_b + 3 u |o.d|_1 and dc = eps S_c + 3 u |o|^2; the float32
    tail b^2 - (y_c + |o|^2) adds 3 u (b^2 + |c|); a side's discriminant is
    then off by (2 |b| + db) db + dc + 3 u (b^2 + |c|). A root -b +- sqrt(D)
    moves by db + e_disc / sqrt(D) where D > e_disc (sqrt(D) - sqrt(D - e)
    <= e / sqrt(D)), plus 4 u |t| for the float32 sqrt, negation and add
    on each side."""
    r = rays.double()
    ox, oy, oz, dx, dy, dz = r[:6]
    od = ox * dx + oy * dy + oz * dz
    od_mag = (ox * dx).abs() + (oy * dy).abs() + (oz * dz).abs()
    oo = ox * ox + oy * oy + oz * oz
    rf = rays[:6]
    od32 = (rf[0] * rf[3] + rf[1] * rf[4] + rf[2] * rf[5]).double()
    x = torch.stack([dx, dy, dz, ox, oy, oz, od32, torch.ones_like(ox)])
    y = (a.double() @ x).reshape(-1, 2, chunk, x.shape[1])
    mag = (a.double().abs() @ x.abs()).reshape(-1, 2, chunk, x.shape[1])
    b = y[:, 0].reshape(-1, x.shape[1]).T
    c = y[:, 1].reshape(-1, x.shape[1]).T + oo[:, None]
    s_b = mag[:, 0].reshape(-1, x.shape[1]).T
    s_c = mag[:, 1].reshape(-1, x.shape[1]).T
    # The exact b takes o.d exactly; each side's operand is od32.
    b = b + (od - od32)[:, None]
    e_disc = 0.0
    db_all = 0.0
    for eps in (eps_port, EPS_F32):
        db = eps * s_b + 3 * U * od_mag[:, None]
        dc = eps * s_c + 3 * U * oo[:, None]
        e_disc = e_disc + (2 * b.abs() + db) * db + dc \
            + 3 * U * (b * b + c.abs())
        db_all = db_all + db
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    roots = torch.stack([-b - sq, -b + sq])
    e_t = torch.where(disc > e_disc, db_all + e_disc / sq.clamp(min=1e-300)
                      + 8 * U * roots.abs().amax(0), float("inf"))
    return b, disc, roots, e_disc, e_t


def pair_states(disc, roots, e_disc, e_t, tmin, tmax):
    """(sure, unsure), each (N, cols) bool, from quadratic_bounds: `sure`
    pairs hit on both sides (the exact discriminant beyond its bound, the
    root the kernels take in [tmin, tmax] and the choice of root alike,
    each with its t bound to spare); `unsure` ones may hit on one side and
    miss on the other (the rest are sure misses)."""
    lo, hi = tmin[:, None], tmax[:, None]
    t_near, t_far = roots
    real = disc > e_disc
    near = real & (t_near - e_t >= lo) & (t_near + e_t <= hi)
    far = real & (t_near + e_t < lo) & (t_far - e_t >= lo) & (
        t_far + e_t <= hi)
    sure = near | far
    miss = (disc < -e_disc) | (real & (
        (t_far + e_t < lo) | (t_near - e_t > hi)
        | ((t_near + e_t < lo) & (t_far - e_t > hi))))
    return sure, ~sure & ~miss


def aimed_rays(c):
    """2048 rays from within ~0.05 of the coordinate origin, each aimed
    within ~0.3 of one of the case's spheres (tmin 0, tmax 1e9): there
    the single pass's bound leaves the larger spheres' pairs sure hits."""
    n, centers = c["n"], c["centers"]
    rng = np.random.RandomState(13)
    o = rng.randn(n, 3) * 0.05
    aim = centers[rng.randint(0, len(centers), n)] + 0.3 * rng.randn(n, 3)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    return np.ascontiguousarray(np.concatenate(
        [o.T, d.T, np.zeros((1, n)), np.full((1, n), 1e9)]), np.float32)


def check_default_closest(rays, t, i, t_ref, i_ref, acc):
    """B12a at "default" against the reference on `rays` (see
    test_default_plain_kernels_within_single_pass_bound): (flips, rays
    whose winners are sure, the largest t gap over its bound)."""
    table = acc.table
    col_of = column_of(table)
    filled = (table[3] > 0)[None, :]
    _, disc, roots, e_disc, e_t = quadratic_bounds(rays, acc.mxu_a,
                                                   acc.chunk, EPS_DEFAULT)
    tmin, tmax = rays[6].double(), rays[7].double()
    sure, unsure = pair_states(disc, roots, e_disc, e_t, tmin, tmax)
    sure, unsure = sure & filled, unsure & filled
    may_flip = (~sure.any(1) & unsure.any(1)).numpy()
    fin, fin_ref = np.isfinite(t), np.isfinite(t_ref)
    flip = fin != fin_ref
    assert not (flip & ~may_flip).any()
    np.testing.assert_array_equal(fin[sure.any(1).numpy()], True)
    rows = np.nonzero(fin & fin_ref)[0]
    jr, jp = col_of[i_ref[rows]], col_of[i[rows]]
    assert (jr >= 0).all() and (jp >= 0).all()
    keep = (sure[rows, jr] & sure[rows, jp]).numpy()
    rows, jr, jp = rows[keep], jr[keep], jp[keep]
    trunc = 2.0 ** (ik.pos_bits(table.shape[1]) - 23)
    lim = torch.maximum(e_t[rows, jr], e_t[rows, jp]).numpy() \
        + 2 * trunc * np.abs(t_ref[rows])
    gap = np.abs(t[rows].astype(np.float64) - t_ref[rows])
    assert (gap <= lim).all()
    diff = i[rows] != i_ref[rows]
    t_pick = torch.where(roots[0] >= tmin[:, None], roots[0], roots[1])
    gap_pairs = (t_pick[rows[diff], jp[diff]]
                 - t_pick[rows[diff], jr[diff]]).abs().numpy()
    tie = (e_t[rows[diff], jp[diff]] + e_t[rows[diff], jr[diff]]).numpy() \
        + 2 * trunc * np.abs(t_ref[rows[diff]])
    assert (gap_pairs <= tie).all()
    return int(flip.sum()), len(rows), float((gap / lim).max(initial=0.0))


def test_default_plain_kernels_within_single_pass_bound(case, monkeypatch):
    """B12a's and B12b's plain versions at "default" (one bf16 pass)
    against the reference's kernels in interpret mode at DEFAULT, which on
    the CPU is a float32 dot: within the single pass's bound, derived per
    pair in quadratic_bounds and sorted by pair_states. A ray's hit/miss
    (B12a) or blocked bit (B12b) may differ only where none of its usable
    pairs is a sure hit and one is unsure, and a ray with a sure pair
    hits (is blocked) on both sides. Where both sides' winning pairs are
    sure hits, t agrees within the larger t bound of the two plus the
    packed word's truncation (2^(pos_bits - 23) of t on each side), and a
    different index is a tie: the two pairs' exact roots lie within their
    bounds and the truncation of each other.

    The single pass rounds each term a_k x_k by up to 2^-7, so on the
    case's scene (centres ~6 from the origin, origins ~10) its bound on a
    discriminant, ~2^-7 (|c|^2 + 2 |b| |c|_1 + 2 |c . o|_1), exceeds r^2
    for almost every pair: the case's rays (flips) and a second batch
    aimed from near the origin (aimed_rays; flips and t) are checked.
    Measured here: B12a flips 69 of the case's 2048 rays (146 reference
    hits) and 248 of the aimed ones, B12b 36 of the case's (60 blocked),
    each on a ray that the bound allows; t within 0.12 of its bound on
    the 115 aimed rays whose winners are sure. ("high" flips none of the
    case's rays against the reference: test_mxu_*_matches_interpret.)"""
    rays9 = occlusion_rays(case)
    aimed = aimed_rays(case)
    t_ref, i_ref, occ_ref = reference_kernels(case, rays9, "default")
    macc = case["macc"]
    with reference_precision("default"):
        ta_ref, ia_ref = (np.asarray(x) for x in ip.intersect_morton_mxu(
            jnp.asarray(aimed), macc.bounds_tbl, macc.table, macc.mxu_a,
            macc.n_chunks, macc.chunk, interpret=True))
    acc, t, i, occ = port_kernels(case, rays9, monkeypatch, "default")
    ta, ia = (x.numpy() for x in ik.intersect_morton_mxu(
        torch.from_numpy(aimed), acc.table, acc.bounds, acc.mxu_a,
        block=500))
    flips, _, _ = check_default_closest(case["trays"], t, i, t_ref, i_ref,
                                        acc)
    assert 0.02 < np.isfinite(t_ref).mean() and flips < 0.1 * len(t)
    a_flips, a_rows, a_gap = check_default_closest(
        torch.from_numpy(aimed), ta, ia, ta_ref, ia_ref, acc)
    assert a_rows >= 30
    # B12b: the same over the columns that are not the ray's excluded
    # object.
    table = acc.table
    r9 = torch.from_numpy(rays9)
    _, disc9, roots9, e9, et9 = quadratic_bounds(r9, acc.mxu_a, acc.chunk,
                                                 EPS_DEFAULT)
    sure9, unsure9 = pair_states(disc9, roots9, e9, et9, r9[6].double(),
                                 r9[7].double())
    usable = (table[3] > 0)[None, :] & (table[4][None, :] != r9[8][:, None])
    sure9, unsure9 = sure9 & usable, unsure9 & usable
    may9 = (~sure9.any(1) & unsure9.any(1)).numpy()
    oflip = occ != occ_ref
    assert not (oflip & ~may9).any()
    assert 0.02 < occ_ref.mean() < 0.95 and oflip.mean() < 0.1
    np.testing.assert_array_equal(occ[sure9.any(1).numpy()], True)


def test_default_cull_margin_cuts_next_to_nothing():
    """The margin that "default"'s derivation gives (2^-2 of S, see
    intersect_kernels.MXU_CULL_SCALE) lets a warp sweep > 99% of the
    chunks on the demo frame's primary rays (96x54), where "high"'s 2^-6
    cuts about half: so that precision runs with the cull off (an
    infinite margin), and its walk sweeps every chunk."""
    setup = bench.make_trace_setup(width=96, height=54, device="cpu")
    scene, cam, cfg = setup.scene, setup.cam, setup.cfg
    old = tclusters._USE_MXU
    tclusters._USE_MXU = True
    try:
        acc = tclusters.make_morton_accel(setup.plan, scene.center,
                                          scene.radius,
                                          sort_origin=cam.position)
    finally:
        tclusters._USE_MXU = old
    ndc = tcamera.pixel_ndc(cfg.width, cfg.height, cam.jitter)
    o, d, tmin, tmax = tcamera.generate_pinhole_rays(cam, ndc)
    n = cfg.width * cfg.height
    rays = tintersect.pack_rays(
        o.reshape(n, 3), d.reshape(n, 3),
        torch.broadcast_to(tmin, o.shape[:2]).reshape(n),
        torch.broadcast_to(tmax, o.shape[:2]).reshape(n))
    live = rays[7] >= rays[6]
    swept = {}
    for prec, scale in (("high", 2.0 ** -6), ("default", 2.0 ** -2),
                        ("default", ik.MXU_CULL_SCALE["default"])):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(ik, "MXU_PREC", prec)
            m.setitem(ik.MXU_CULL_SCALE, prec, scale)
            _, sw, _ = ik.mxu_chunk_walk(rays, acc.table, acc.bounds,
                                         acc.mxu_a)
        swept[(prec, scale)] = float(sw[live].float().mean())
    assert ik.MXU_CULL_SCALE["high"] == 2.0 ** -6
    assert swept[("high", 2.0 ** -6)] < 0.7
    assert swept[("default", 2.0 ** -2)] > 0.99
    assert ik.MXU_CULL_SCALE["default"] == float("inf")
    assert swept[("default", float("inf"))] == 1.0


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
def test_work_counts_precision_products(case, monkeypatch, prec):
    """mxu_products gives 1, 3 and 6 mmas per swept (ray, slot group),
    and the walk that intersect_morton_mxu_work counts uses the
    precision's margin: every live lane meets every chunk at "default",
    and culls some at the other two."""
    acc = port_morton(case, monkeypatch)
    monkeypatch.setattr(ik, "MXU_PREC", prec)
    assert ik.mxu_products() == {"default": 1, "high": 3, "highest": 6}[prec]
    rays = case["trays"]
    tests, met, swept, pairs, slots = ik.intersect_morton_mxu_work(
        rays, acc.table, acc.bounds, acc.mxu_a)
    live = rays[7] >= rays[6]
    assert bool((swept <= tests).all()) and bool((met <= swept).all())
    if prec == "default":
        assert torch.equal(swept[live], tests[live])
        assert torch.equal(met[live], tests[live])
    else:
        assert int(met.sum()) < int(tests.sum())
