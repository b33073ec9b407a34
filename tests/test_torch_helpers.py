"""The port's last public helpers against the reference's, on seeded numpy
inputs: ``light.sample_sphere_light``, ``light.light_pdf``,
``light.fetch_rows_object``, ``SphereScene.object_count``,
``utils/math.safe_div``, ``vec3`` and ``quat_to_matrix``, and
``physics.spring_constant``.

Tolerance: tables, ids and integers equal bit for bit; float results
within 1e-6 relative. Cone sampling's outputs are ill-conditioned, so their
bound is 1e-6 relative widened by each output's own condition number:
torch's CPU ``sqrt`` is not correctly rounded on ~0.6% of inputs and its
``sin``/``cos`` differ from XLA's in the last bit, and ``1 - cos(theta_max)``,
``sqrt(1 - cos_t^2)`` and the near root ``-b - sqrt(b^2 - c)`` cancel
that bit up. So the pdf may differ by one float32 rounding of
``1 - cos(theta_max)`` (2^-24 / (1 - cos(theta_max)) relative; measured at
most 1.0 of it), a direction by 2^-24 / sin(theta) (theta the sample's
angle from the cone's axis; measured 0.34 of it), and the distance by
that direction error along the near root's derivative (measured 0.08 of
it). Each helper is also held, bit for bit, to the port's own rows form on
its own fetched rows.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import scene as jscene
from drts_tpu.ops import light as jlight, physics as jphysics
from drts_tpu.utils import math as jm
from drts_tpu_torch.models import scene as tscene
from drts_tpu_torch.ops import light as tlight, physics as tphysics
from drts_tpu_torch.utils import math as tm

K, L, N = 40, 16, 4096
EPS = 2.0 ** -24


def lights_pair(seed=0):
    """A sphere-only light set (K objects, L compact rows) in both
    packages, from one seeded table."""
    rng = np.random.RandomState(seed)
    table = np.zeros((K, 9), np.float32)
    table[:, 0:3] = rng.uniform(-5, 5, (K, 3))
    table[:, 3] = rng.uniform(0.3, 1.5, K)
    table[:, 4:7] = rng.uniform(0, 4, (K, 3))
    table[:, 7] = rng.uniform(0, 10, K)
    table[:, 8] = np.where(rng.rand(K) < 0.5, rng.randint(0, L, K), -1)
    compact = table[rng.choice(K, L, replace=False)].copy()
    compact[:, 8] = rng.randint(0, K, L)
    cdf = np.cumsum(compact[:, 7])
    fields = dict(center=table[:, 0:3], radius=table[:, 3],
                  emission=table[:, 4:7], power=table[:, 7],
                  total_power=np.float32(table[:, 7].sum()), table=table,
                  compact=compact, cdf=(cdf / cdf[-1]).astype(np.float32))
    jl = jlight.Lights(**{k: jnp.asarray(v) for k, v in fields.items()})
    tl = tlight.Lights(**{k: torch.as_tensor(v) for k, v in fields.items()})
    return jl, tl, rng


def both(fn_j, fn_t, *arrays, int_args=()):
    """fn on jnp and on torch copies of the same numpy arrays (arrays at
    the positions in `int_args` as integer ids)."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.as_tensor(a).long() if i in int_args else
             torch.as_tensor(a) for i, a in enumerate(arrays)]
    return fn_j(*jargs), fn_t(*targs)


def assert_rows_equal(jrows, trows):
    for name in ("center", "radius", "emission", "power", "aux"):
        np.testing.assert_array_equal(getattr(trows, name).numpy(),
                                      np.asarray(getattr(jrows, name)),
                                      err_msg=name)


def test_fetch_rows_object_equal():
    """Object-indexed rows, bit for bit, `aux` the compact light id; ids
    out of range index as the reference's gather does (negative ones from
    the end, then clamped)."""
    jl, tl, rng = lights_pair()
    obj = rng.randint(-3, K + 3, N).astype(np.int32)
    jrows, trows = both(lambda i: jlight.fetch_rows_object(jl, i),
                        lambda i: tlight.fetch_rows_object(tl, i), obj,
                        int_args=(0,))
    assert_rows_equal(jrows, trows)
    assert bool((trows.aux >= -1).all()) and bool((trows.aux < L).all())


def test_sample_sphere_light_matches():
    jl, tl, rng = lights_pair(1)
    idx = rng.randint(0, L, N).astype(np.int32)
    pos = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    (jd, jdist, jpdf, jem), (td, tdist, tpdf, tem) = both(
        lambda i, p, r: jlight.sample_sphere_light(jl, i, p, r),
        lambda i, p, r: tlight.sample_sphere_light(tl, i, p, r),
        idx, pos, u, int_args=(0,))
    # The helper is the rows form on its fetched rows, bit for bit.
    assert_rows_equal(jlight.fetch_rows(jl, jnp.asarray(idx)),
                      tlight.fetch_rows(tl, torch.as_tensor(idx).long()))
    own = tlight.sample_sphere_light_rows(
        tlight.fetch_rows(tl, torch.as_tensor(idx).long()),
        torch.as_tensor(pos), torch.as_tensor(u))
    for got, want in zip((td, tdist, tpdf, tem), own):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))

    jd, jdist, jpdf = (np.asarray(x, np.float64) for x in (jd, jdist, jpdf))
    td, tdist, tpdf = (x.numpy().astype(np.float64)
                       for x in (td, tdist, tpdf))
    # pdf = 1 / (2 pi (1 - cos theta_max)): one rounding of 1 - cos.
    one_minus_cos = 1.0 / (2.0 * math.pi * jpdf)
    assert np.all(np.abs(tpdf - jpdf)
                  <= (1e-6 + EPS / one_minus_cos) * jpdf)
    # Direction: 2^-24 / sin(theta) from the cone's axis.
    to_c = (tl.compact[torch.as_tensor(idx).long(), 0:3].numpy()
            - pos).astype(np.float64)
    dist_c = np.linalg.norm(to_c, axis=1)
    cos_t = np.sum(jd * to_c, axis=1) / dist_c
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 1e-30))
    dir_tol = 1e-6 + EPS / sin_t
    assert np.all(np.abs(td - jd).max(axis=1) <= dir_tol)
    # Distance: the direction's error along the near root's derivative.
    radius = tl.compact[torch.as_tensor(idx).long(), 3].numpy()
    bq = -np.sum(to_c * jd, axis=1)
    disc = np.maximum(bq * bq - (dist_c ** 2 - radius.astype(np.float64)
                                 ** 2), 1e-30)
    slope = dist_c * (1.0 + dist_c * np.abs(bq) / np.sqrt(disc))
    assert np.all(np.abs(tdist - jdist)
                  <= 1e-6 * jdist + dir_tol * slope)


def test_light_pdf_matches():
    jl, tl, rng = lights_pair(2)
    # Compact ids come from sample_light_index, in [0, L); ids above the
    # table clamp to its last row in both packages.
    idx = rng.randint(0, L + 2, N).astype(np.int32)
    pos = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    jpdf, tpdf = both(lambda i, p: jlight.light_pdf(jl, i, p),
                      lambda i, p: tlight.light_pdf(tl, i, p), idx, pos,
                      int_args=(0,))
    ids = torch.as_tensor(idx).long()
    assert torch.equal(tpdf, tlight.light_pdf_rows(
        tlight.fetch_rows(tl, ids), torch.as_tensor(pos)))
    jpdf = np.asarray(jpdf, np.float64)
    one_minus_cos = 1.0 / (2.0 * math.pi * jpdf)
    assert np.all(np.abs(tpdf.numpy() - jpdf)
                  <= (1e-6 + EPS / one_minus_cos) * jpdf)


@pytest.mark.parametrize("k", [1, 7, 438])
def test_object_count(k):
    center = np.random.RandomState(k).randn(k, 3).astype(np.float32)
    rot = np.tile(np.float32([0, 0, 0, 1]), (k, 1))
    radius = np.ones(k, np.float32)
    jsc = jscene.SphereScene(
        center=jnp.asarray(center), rotation=jnp.asarray(rot),
        prev_center=jnp.asarray(center), prev_rotation=jnp.asarray(rot),
        radius=jnp.asarray(radius), materials=None, env=None)
    tsc = tscene.SphereScene(
        center=torch.as_tensor(center), rotation=torch.as_tensor(rot),
        prev_center=torch.as_tensor(center),
        prev_rotation=torch.as_tensor(rot), radius=torch.as_tensor(radius),
        materials=None, env=None)
    assert tsc.object_count == jsc.object_count == k


def test_safe_div_matches():
    """Within 1e-6 relative, |b| < 1e-20 clamped with its sign kept. On
    the two subnormal b the reference's XLA:CPU reads b as zero (it sets
    denormals-are-zero) and takes +1e-20; the port keeps b's sign there."""
    rng = np.random.RandomState(3)
    a = rng.randn(N).astype(np.float32)
    b = (rng.randn(N) * 10.0 ** rng.randint(-30, 3, N)).astype(np.float32)
    b[:8] = (0.0, -0.0, 1e-21, -1e-21, 1e-20, -1e-20, 3e-45, -3e-45)
    want, got = both(jm.safe_div, tm.safe_div, a, b)
    got, want = got.numpy(), np.asarray(want)
    normal = np.abs(b) >= np.finfo(np.float32).tiny
    normal[:2] = True
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-6)
    np.testing.assert_array_equal(
        got[~normal], a[~normal] / np.where(b[~normal] < 0, np.float32(-1e-20),
                                            np.float32(1e-20)))
    assert np.all(np.isfinite(got))


def test_vec3_matches():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 1).astype(np.float32)
    y = rng.randn(1, 6).astype(np.float32)
    want, got = both(jm.vec3, lambda *v: tm.vec3(*v), x, y,
                     np.float32(2.5))
    assert got.shape == want.shape == (5, 6, 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scalars = tm.vec3(1, 2.0, 3, device="cpu")
    np.testing.assert_array_equal(scalars.numpy(),
                                  np.asarray(jm.vec3(1, 2.0, 3)))


def test_quat_to_matrix_matches():
    rng = np.random.RandomState(5)
    q = rng.randn(N, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want, got = both(jm.quat_to_matrix, tm.quat_to_matrix, q)
    assert tuple(got.shape) == (N, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_spring_constant_matches():
    rng = np.random.RandomState(6)
    mass = rng.uniform(0.1, 100.0, N).astype(np.float32)
    period = rng.uniform(0.5, 10.0, N).astype(np.float32)
    want, got = both(jphysics.spring_constant, tphysics.spring_constant,
                     mass, period)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tphysics.spring_constant(2.0, 3.0) == pytest.approx(
        float(jphysics.spring_constant(2.0, 3.0)), rel=1e-12)
