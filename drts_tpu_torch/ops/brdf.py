"""Microfacet BRDF terms and importance sampling (port of
``drts_tpu/ops/brdf.py``): GGX D, height-correlated Smith visibility,
Schlick and dielectric Fresnel, Burley diffuse, the split-sum environment
fit, and cosine, VNDF and unit-disk sampling. Elementwise over
broadcastable tensors; ``roughness`` is the linear (perceptual) roughness.
"""

from __future__ import annotations

import math

import torch

from ..utils import math as m

PI = math.pi
INV_PI = 1.0 / math.pi


def distribution_ggx(roughness, noh):
    """GGX normal distribution D (BRDF::DistributionTerm)."""
    a = roughness * roughness
    a2 = a * a
    d = noh * noh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * d * d, min=1e-10)


def geometry_term_mod(roughness, nol, nov):
    """Height-correlated Smith visibility V = G2 / (4 NoL NoV)."""
    a = roughness * roughness
    a2 = a * a
    gv = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=0.0))
    gl = nov * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2) + a2, min=0.0))
    return 0.5 / torch.clamp(gv + gl, min=1e-8)


def smith_g1(roughness, nov):
    """Smith masking G1 for GGX."""
    a = roughness * roughness
    a2 = a * a
    return 2.0 * nov / torch.clamp(
        nov + torch.sqrt(torch.clamp(a2 + (1.0 - a2) * nov * nov, min=0.0)),
        min=1e-8)


def fresnel_schlick(f0, voh):
    """Schlick Fresnel; f0 is (..., 3), voh (...,)."""
    return f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - voh[..., None], 0.0, 1.0), 5.0)


def fresnel_dielectric(eta, voh):
    """Exact unpolarized dielectric Fresnel; eta = IORi / IORo. Returns 1
    under total internal reflection."""
    cos_i = torch.clamp(voh, 0.0, 1.0)
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-8)
    rp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-8)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def diffuse_term_burley(roughness, nol, nov, voh):
    """Burley (Disney) diffuse, normalized by pi (BRDF::DiffuseTerm)."""
    f90 = 0.5 + 2.0 * roughness * voh * voh
    light = 1.0 + (f90 - 1.0) * torch.pow(torch.clamp(1.0 - nol, 0.0, 1.0),
                                          5.0)
    view = 1.0 + (f90 - 1.0) * torch.pow(torch.clamp(1.0 - nov, 0.0, 1.0),
                                         5.0)
    return INV_PI * light * view


def environment_term_rtg(f0, nov, roughness):
    """Preintegrated split-sum environment BRDF fit (BRDF::EnvironmentTerm_Rtg,
    the "Ray Tracing Gems" rational fit in (NoV, alpha)). Returns (..., 3)."""
    a = m.saturate(roughness * roughness)
    x1 = torch.ones_like(nov)
    x2, x3 = nov, nov * nov
    x4 = nov * x3
    y1 = torch.ones_like(a)
    y2, y3 = a, a * a
    y4 = a * y3

    def dot2x2(m00, m01, m10, m11, xa, xb, ya, yb):
        return (m00 * xa + m01 * xb) * ya + (m10 * xa + m11 * xb) * yb

    def dot3x3(mat, xs, ys):
        acc = 0.0
        for i in range(3):
            row = (mat[3 * i] * xs[0] + mat[3 * i + 1] * xs[1]
                   + mat[3 * i + 2] * xs[2])
            acc = acc + row * ys[i]
        return acc

    bias_num = dot2x2(0.99044, -1.28514, 1.29678, -0.755907, x1, x2, y1, y2)
    bias_den = dot3x3([1.0, 2.92338, 59.4188,
                       20.3225, -27.0302, 222.592,
                       121.563, 626.13, 316.627],
                      (x1, x2, x4), (y1, y2, y4))
    scale_num = dot2x2(0.0365463, 3.32707, 9.0632, -9.04756, x1, x2, y1, y2)
    scale_den = dot3x3([1.0, 3.59685, -1.36772,
                        9.04401, -16.3174, 9.22949,
                        5.56589, 19.7886, -20.2123],
                       (x1, x3, x4), (y1, y2, y4))
    bias = bias_num / torch.clamp(bias_den, min=1e-6)
    scale = scale_num / torch.clamp(scale_den, min=1e-6)
    return m.saturate(f0 * scale[..., None] + bias[..., None])


# ----------------------------------------------------------------------------
# Importance sampling (local/tangent space: +z = normal)


def sample_cosine_hemisphere(random2):
    """Cosine-weighted hemisphere direction (ImportanceSampling::Cosine)."""
    phi = 2.0 * PI * random2[..., 0]
    cos_theta = torch.sqrt(1.0 - random2[..., 1])
    sin_theta = torch.sqrt(torch.clamp(random2[..., 1], min=0.0))
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def pdf_cosine_hemisphere(nol):
    return nol * INV_PI


def sample_uniform_disk(random2):
    """Uniform unit-disk point (ImportanceSampling::Uniform, the thin
    lens's aperture sample)."""
    r = torch.sqrt(random2[..., 0])
    phi = 2.0 * PI * random2[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def sample_vndf_ggx(random2, roughness, v_local):
    """Heitz 2018 VNDF sampling of the GGX visible normals. Returns the
    half-vector H in tangent space (ImportanceSampling::VNDF::GetRay)."""
    a = (roughness * roughness)[..., None]
    vh = m.normalize(v_local * torch.cat([a, a, torch.ones_like(a)], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)],
                    dim=-1) * _rsqrt(lensq)[..., None],
        m.const((1.0, 0.0, 0.0), vh.dtype, vh.device))
    t2 = m.cross(vh, t1)
    r = torch.sqrt(torch.clamp(random2[..., 0], 0.0, 1.0))
    phi = 2.0 * PI * random2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = torch.stack([a[..., 0] * nh[..., 0],
                     a[..., 0] * nh[..., 1],
                     torch.clamp(nh[..., 2], min=0.0)], dim=-1)
    return m.normalize(h)


def pdf_vndf_ggx(roughness, noh, nov_local):
    """Solid-angle PDF of the reflected direction for VNDF-sampled H:
    G1(V) * D(H) / (4 * NoV) (ImportanceSampling::VNDF::GetPDF)."""
    d = distribution_ggx(roughness, noh)
    g1 = smith_g1(roughness, torch.clamp(nov_local, min=1e-6))
    return g1 * d / torch.clamp(4.0 * nov_local, min=1e-6)


def _rsqrt(x):
    return torch.reciprocal(torch.sqrt(torch.clamp(x, min=1e-30)))
