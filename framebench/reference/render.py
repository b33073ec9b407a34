"""Plain PyTorch rendering of the demo scene, in any precision: primary
rays, closest hits on spheres and on instances of one geosphere mesh, and
a path tracer of the demo's light transport.

The camera follows the demo's conventions (Camera.ixx:138-153,
Camera.hlsli:27-41): |forward| = 1, |right| = tan(hfov / 2), |up| =
|right| / aspect, a pixel's ray through (pixel + 0.5 + jitter) / size in
NDC with y up. The geosphere is an octahedron subdivided and projected to
the unit sphere (MyScene.ixx:53-88), instanced at a sphere's pose and
scaled by its radius. The light transport is the independent tracer the
port cross-checks against (Burley diffuse, GGX with height-correlated
Smith visibility, Schlick and exact dielectric Fresnel, Heitz 2018 VNDF
sampling, the demo's sky gradient, emission at every vertex), copied here
from the port's cross-check module and moved from numpy to PyTorch so that
it runs on the card. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .physics import quat_conj, quat_rotate

MIN_ROUGHNESS = 2e-3
LUMA = (0.2126, 0.7152, 0.0722)


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    n = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=0.0))
    return v / torch.clamp(n, min=1e-20)


# ---------------------------------------------------------------------------
# camera


def halton_jitter(count: int) -> np.ndarray:
    """(count, 2) Halton(2, 3) points, indices 1..count, minus 0.5."""
    def radical_inverse(i, base):
        out = np.zeros(i.shape, np.float64)
        f = 1.0 / base
        i = i.copy()
        while np.any(i > 0):
            out += f * (i % base)
            i //= base
            f /= base
        return out
    idx = np.arange(1, count + 1)
    return (np.stack([radical_inverse(idx, 2), radical_inverse(idx, 3)], -1)
            .astype(np.float32) - 0.5)


def camera_rays(position, forward, width, height, px, py, jitter,
                hfov_deg=90.0, dtype=torch.float64):
    """Pinhole rays through pixel positions (px, py) (any shape, float,
    pixel units before the +0.5 centre) of a width x height image.
    Returns (origin (..., 3), direction (..., 3), unit forward (3,))."""
    dev = px.device
    pos = torch.as_tensor(np.asarray(position, np.float64), dtype=dtype,
                          device=dev)
    f = _normalize(torch.as_tensor(np.asarray(forward, np.float64),
                                   dtype=dtype, device=dev))
    up = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    r = _normalize(torch.linalg.cross(up, f, dim=-1))
    u = torch.linalg.cross(f, r, dim=-1)
    tan_half = math.tan(math.radians(hfov_deg) / 2)
    r = r * tan_half
    u = u * (tan_half * height / width)
    ndc_x = (px.to(dtype) + 0.5 + float(jitter[0])) / width * 2.0 - 1.0
    ndc_y = 1.0 - (py.to(dtype) + 0.5 + float(jitter[1])) / height * 2.0
    d = _normalize(ndc_x[..., None] * r + ndc_y[..., None] * u + f)
    return pos.expand(d.shape), d, f


# ---------------------------------------------------------------------------
# scene geometry


def geosphere(tessellation: int):
    """(V, 3) float64 vertices on the unit sphere and (F, 3) faces of an
    octahedron subdivided tessellation - 1 times."""
    verts = [np.array(v, np.float64) for v in
             ([0, 1, 0], [0, 0, -1], [1, 0, 0], [0, 0, 1], [-1, 0, 0],
              [0, -1, 0])]
    faces = [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],
             [5, 2, 1], [5, 3, 2], [5, 4, 3], [5, 1, 4]]
    for _ in range(max(1, int(tessellation)) - 1):
        cache, new = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = new
    v = np.array(verts)
    return v / np.linalg.norm(v, axis=-1, keepdims=True), np.array(faces)


class Scene:
    """The scene's spheres (or their geosphere instances) and materials
    at one pose, as tensors of `dtype` on `device`."""

    def __init__(self, inputs: dict, position, rotation, dtype, device):
        def t(x):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            return x.to(device=device, dtype=dtype)
        self.dtype = dtype
        self.center = t(position)
        self.rotation = t(rotation)
        self.radius = t(inputs["radius"])
        self.base_color = t(inputs["base_color"])
        self.emission = t(inputs["emission"])
        self.metallic = t(inputs["metallic"])
        self.roughness = torch.clamp(t(inputs["roughness"]), min=MIN_ROUGHNESS)
        self.ior = t(inputs["ior"])
        self.transmission = t(inputs["transmission"])
        self.mesh = None
        tess = inputs.get("geosphere_tessellation")
        if tess:
            v, f = geosphere(tess)
            tri = v[f]                                   # (F, 3, 3)
            self.mesh = {"v0": t(tri[:, 0]), "e1": t(tri[:, 1] - tri[:, 0]),
                         "e2": t(tri[:, 2] - tri[:, 0]), "n": t(tri)}

    # -- closest hits ------------------------------------------------------

    def hit(self, o, d, t_min=1e-4, chunk=1 << 15):
        """Closest hit of rays (N, 3): (t (N,), object (N,), outward
        geometric normal (N, 3), shading normal (N, 3)); t = inf on a
        miss."""
        if self.mesh is None:
            return self._hit_spheres(o, d, t_min, chunk)
        return self._hit_mesh(o, d, t_min)

    def _hit_spheres(self, o, d, t_min, chunk):
        ts, ids = [], []
        for s in range(0, o.shape[0], chunk):
            oc = o[s:s + chunk, None, :] - self.center[None]
            dd = d[s:s + chunk, None, :]
            b = (oc * dd).sum(-1)
            c = (oc * oc).sum(-1) - self.radius[None] ** 2
            disc = b * b - c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t0, t1 = -b - sq, -b + sq
            t = torch.where(t0 >= t_min, t0, t1)
            t = torch.where((disc > 0.0) & (t >= t_min), t,
                            torch.full_like(t, float("inf")))
            tb, ib = t.min(-1)
            ts.append(tb)
            ids.append(ib)
        t, idx = torch.cat(ts), torch.cat(ids)
        p = o + d * torch.where(torch.isfinite(t), t,
                                torch.zeros_like(t))[:, None]
        n = _normalize(p - self.center[idx])
        return t, idx, n, n

    def _hit_mesh(self, o, d, t_min, chunk=1 << 14, pair_chunk=1 << 12):
        """Instances whose bounding sphere (the instance radius) the ray
        meets, then every face of each such instance in its object frame
        (Moller-Trumbore), the least t kept."""
        n_rays, dev = o.shape[0], o.device
        best_t = torch.full((n_rays,), float("inf"), dtype=self.dtype,
                            device=dev)
        best_i = torch.zeros(n_rays, dtype=torch.long, device=dev)
        best_f = torch.zeros(n_rays, dtype=torch.long, device=dev)
        best_uv = torch.zeros((n_rays, 2), dtype=self.dtype, device=dev)
        mesh = self.mesh
        for s in range(0, n_rays, chunk):
            oc = o[s:s + chunk, None, :] - self.center[None]
            dd = d[s:s + chunk, None, :]
            b = (oc * dd).sum(-1)
            c = (oc * oc).sum(-1) - (self.radius[None] * 1.0001) ** 2
            disc = b * b - c
            far = -b + torch.sqrt(torch.clamp(disc, min=0.0))
            ray, inst = torch.nonzero((disc > 0) & (far >= t_min),
                                      as_tuple=True)
            ray = ray + s
            for q in range(0, ray.shape[0], pair_chunk):
                r, k = ray[q:q + pair_chunk], inst[q:q + pair_chunk]
                qc = quat_conj(self.rotation[k])
                inv_s = 1.0 / self.radius[k][:, None]
                ol = quat_rotate(qc, o[r] - self.center[k]) * inv_s
                dl = quat_rotate(qc, d[r]) * inv_s
                p = torch.linalg.cross(dl[:, None, :].expand(-1, mesh["e2"].shape[0], -1),
                                       mesh["e2"][None].expand(dl.shape[0], -1, -1), dim=-1)
                det = (mesh["e1"][None] * p).sum(-1)
                inv = 1.0 / torch.where(det.abs() > 1e-12, det,
                                        torch.full_like(det, 1e-12))
                tv = ol[:, None, :] - mesh["v0"][None]
                u = (tv * p).sum(-1) * inv
                qv = torch.linalg.cross(tv, mesh["e1"][None].expand_as(tv), dim=-1)
                v = (dl[:, None, :] * qv).sum(-1) * inv
                t = (mesh["e2"][None] * qv).sum(-1) * inv
                ok = ((det.abs() > 1e-12) & (u >= 0) & (v >= 0)
                      & (u + v <= 1) & (t >= t_min))
                t = torch.where(ok, t, torch.full_like(t, float("inf")))
                tf, face = t.min(-1)
                uf = u.gather(1, face[:, None])[:, 0]
                vf = v.gather(1, face[:, None])[:, 0]
                # Several pairs of one ray: the least t wins.
                best_t.scatter_reduce_(0, r, tf, reduce="amin")
                won = torch.nonzero(torch.isfinite(tf) & (tf == best_t[r]),
                                    as_tuple=True)[0]
                best_i[r[won]] = k[won]
                best_f[r[won]] = face[won]
                best_uv[r[won]] = torch.stack([uf, vf], -1)[won]
        hit = torch.isfinite(best_t)
        q = self.rotation[best_i]
        gn = _normalize(quat_rotate(q, torch.linalg.cross(
            mesh["e1"][best_f], mesh["e2"][best_f], dim=-1)))
        nv = mesh["n"][best_f]
        uu, vv = best_uv[:, 0:1], best_uv[:, 1:2]
        ns = _normalize(quat_rotate(q, nv[:, 0] * (1 - uu - vv) + nv[:, 1] * uu
                                    + nv[:, 2] * vv))
        gn = torch.where(hit[:, None], gn, torch.zeros_like(gn))
        return best_t, best_i, gn, ns


# ---------------------------------------------------------------------------
# light transport


def _sky(d):
    t = (d[..., 1:2] + 1.0) * 0.5
    top = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    c = torch.clamp((1.0 - t) + t * top, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _basis(n):
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def _sample_vndf(u, rough, v_local):
    a = rough[..., None]
    vh = _normalize(v_local * torch.cat([a, a, torch.ones_like(a)], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-30))
    x_axis = torch.zeros_like(vh)
    x_axis[..., 0] = 1.0
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], -1), x_axis)
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1, p2 = r * torch.cos(phi), r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = torch.stack([a[..., 0] * nh[..., 0], a[..., 0] * nh[..., 1],
                     torch.clamp(nh[..., 2], min=0.0)], -1)
    return _normalize(h)


def _smith_g1(rough, c):
    a2 = rough ** 4
    return 2.0 * c / torch.clamp(
        c + torch.sqrt(torch.clamp(a2 + (1.0 - a2) * c * c, min=0.0)),
        min=1e-9)


def _vis(rough, nol, nov):
    a2 = rough ** 4
    gv = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=0.0))
    gl = nov * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2) + a2, min=0.0))
    return 0.5 / torch.clamp(gv + gl, min=1e-9)


def _fresnel_schlick(f0, voh):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - voh, 0.0, 1.0)[..., None] ** 5


def _fresnel_dielectric(eta, voh):
    cos_i = torch.clamp(voh, 0.0, 1.0)
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-9)
    rp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-9)
    return torch.where(sin_t2 >= 1.0, torch.ones_like(rs),
                       torch.clamp(0.5 * (rs * rs + rp * rp), 0.0, 1.0))


def _burley(rough, nol, nov, voh):
    f90 = 0.5 + 2.0 * rough * voh * voh
    lt = 1.0 + (f90 - 1.0) * torch.clamp(1.0 - nol, 0.0, 1.0) ** 5
    vt = 1.0 + (f90 - 1.0) * torch.clamp(1.0 - nov, 0.0, 1.0) ** 5
    return lt * vt / math.pi


def trace(scene: Scene, o, d, bounces: int, gen: torch.Generator):
    """Mean radiance (N, 3) of one path per camera ray (N, 3) with up to
    `bounces` bounces, random numbers from `gen`."""
    n, dt, dev = o.shape[0], scene.dtype, o.device
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    alive = torch.arange(n, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev).to(dt)

    for level in range(bounces + 1):
        if alive.numel() == 0:
            break
        t, idx, n_out, n_sh = scene.hit(o, d)
        hit = torch.isfinite(t)
        miss = ~hit
        acc.index_add_(0, alive[miss], thr[miss] * _sky(d[miss]))
        keep = torch.nonzero(hit, as_tuple=True)[0]
        alive, o, d, thr = alive[keep], o[keep], d[keep], thr[keep]
        t, idx, n_out, n_sh = t[keep], idx[keep], n_out[keep], n_sh[keep]
        if alive.numel() == 0:
            break
        p = o + d * t[:, None]
        front = _dot(n_out, d) < 0.0
        nrm = torch.where((_dot(n_sh, d) < 0.0)[:, None], n_sh, -n_sh)
        acc.index_add_(0, alive, thr * scene.emission[idx])
        if level == bounces:
            break
        bc = scene.base_color[idx]
        metal = scene.metallic[idx]
        rough = scene.roughness[idx]
        ior = scene.ior[idx]
        tw = scene.transmission[idx] * (1.0 - metal)
        rw = 1.0 - tw
        one = torch.ones_like(ior)
        ior_i = torch.where(front, one, ior)
        ior_o = torch.where(front, ior, one)
        eta = ior_i / ior_o
        f_diel = ((ior_i - ior_o) / (ior_i + ior_o)) ** 2
        f0 = f_diel[:, None] * (1.0 - metal[:, None]) + bc * metal[:, None]
        albedo = bc * (1.0 - metal[:, None])

        v = -d
        nov = torch.abs(_dot(nrm, v))
        tb, bb = _basis(nrm)
        v_local = torch.stack([_dot(v, tb), _dot(v, bb), _dot(v, nrm)], -1)
        m = alive.numel()
        u_lobe, u2, u_f = rand(m), rand(m, 2), rand(m)
        take_t = u_lobe < tw
        take_d = ~take_t & (u_lobe < tw + 0.5 * rw)
        p_lobe = torch.where(take_t, torch.clamp(tw, min=1e-9), 0.5 * rw)

        h = _sample_vndf(u2, rough, v_local)
        h_w = h[:, 0:1] * tb + h[:, 1:2] * bb + h[:, 2:3] * nrm
        voh = torch.abs(_dot(v, h_w))
        l_spec = _normalize(2.0 * voh[:, None] * h_w - v)
        r_cos = torch.sqrt(u2[:, 1])
        s_cos = torch.sqrt(torch.clamp(1.0 - u2[:, 1], min=0.0))
        phi = 2.0 * math.pi * u2[:, 0]
        l_diff = ((s_cos * torch.cos(phi))[:, None] * tb
                  + (s_cos * torch.sin(phi))[:, None] * bb
                  + r_cos[:, None] * nrm)
        f_d = _fresnel_dielectric(eta, voh)
        sin2_t = eta * eta * (1.0 - voh * voh)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
        refr = _normalize(eta[:, None] * d + (eta * voh - cos_t)[:, None] * h_w)
        reflect = (sin2_t >= 1.0) | (u_f < f_d)
        l_trans = torch.where(reflect[:, None], l_spec, refr)
        l = torch.where(take_t[:, None], l_trans,
                        torch.where(take_d[:, None], l_diff, l_spec))

        nol = torch.abs(_dot(nrm, l))
        in_front = _dot(nrm, l) > 0.0
        h_e = _normalize(l + v)
        voh_e = torch.abs(_dot(v, h_e))
        w_diff = albedo * (_burley(rough, nol, nov, voh_e) * math.pi
                           * rw / p_lobe)[:, None]
        g1 = _smith_g1(rough, torch.clamp(nov, min=1e-6))
        w_spec = _fresnel_schlick(f0, voh_e) * (
            4.0 * nol * nov * _vis(rough, nol, nov)
            / torch.clamp(g1, min=1e-9) * rw / p_lobe)[:, None]
        w_trans = bc * (tw / p_lobe)[:, None]
        w = torch.where(take_t[:, None], w_trans,
                        torch.where(take_d[:, None], w_diff, w_spec))
        ok = (take_t | in_front) & (p_lobe > 0)
        keep = torch.nonzero(ok, as_tuple=True)[0]
        off = torch.where(_dot(n_out, l) >= 0.0, 1.0, -1.0).to(dt)
        o = (p + n_out * (off * 1e-4)[:, None])[keep]
        d, thr, alive = l[keep], (thr * w)[keep], alive[keep]
    return acc


def luminance(c):
    return (c * torch.tensor(LUMA, dtype=c.dtype, device=c.device)).sum(-1)
