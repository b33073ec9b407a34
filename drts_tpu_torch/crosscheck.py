"""Independent full-scene cross-check tracer (port of
``drts_tpu/crosscheck.py``).

``fidelity.py``'s converged ground truth is the port's own integrator at
high spp, so integrator-wide bias would pass that comparison silently.
This module renders the same scene with a numpy path tracer that shares
no light-transport code with the port's integrator: the physical model
re-implemented from the published formulas (Burley diffuse [Burley 2012],
GGX distribution and height-correlated Smith visibility [Heitz 2014],
Schlick Fresnel, exact dielectric Fresnel, Heitz 2018 VNDF sampling), with
its own RNG stream and its own estimator choices where the model allows
them (a uniform split between the reflection lobes; MIS weights make any
positive lobe probabilities converge to the same integral). Only scene
data (sphere and material tables) and camera rays come from the port. The
tracer is a copy of the reference's, float64 numpy on the host.

Model spec matched (the reference's BxDF contract, BxDF.hlsli:36-321):
- diffuse:       f = NoL * albedo * Burley(roughness, NoL, NoV, VoH) * rw
- specular:      f = NoL * D_GGX * Vis_heightcorr * F_schlick * rw
- transmission:  direction from VNDF half-vector + exact-Fresnel
                 reflect/refract split; carried weight base_color * tw
- rw = 1 - tw, tw = transmission * (1 - metallic); roughness floor 2e-3
- miss = procedural sky gradient FromSrgb(lerp(1,(.5,.7,1),(y+1)/2))
- emission strength*color added at every live vertex

``run()`` renders both sides and returns the metrics; the port's side is
traced with Russian roulette off and no throughput cutoff, untextured, so
both estimate the same integral. ``python -m drts_tpu_torch.crosscheck``
prints ``run()``'s metrics at 48x27, 256 spp, 4 bounces, on the card.
"""

from __future__ import annotations

import numpy as np

MIN_ROUGHNESS = 2e-3


# ---------------------------------------------------------------------------
# scene/material data extraction (data plumbing only — no transport logic)


def _host(x) -> np.ndarray:
    """A tensor on any device (or an array) as a float64 host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def extract_scene(scene) -> dict:
    mats = scene.materials
    return {
        "center": _host(scene.center),
        "radius": _host(scene.radius),
        "base_color": _host(mats.base_color)[:, :3],
        "emission": (_host(mats.emissive_strength)[:, None]
                     * _host(mats.emissive_color)),
        "metallic": _host(mats.metallic),
        "roughness": np.maximum(_host(mats.roughness), MIN_ROUGHNESS),
        "ior": _host(mats.ior),
        "transmission": _host(mats.transmission),
    }


# ---------------------------------------------------------------------------
# independent math (numpy, float64)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _luminance(c):
    return c @ np.array([0.2126, 0.7152, 0.0722])


def _from_srgb(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _sky(d):
    t = (d[..., 1:2] + 1.0) * 0.5
    srgb = (1.0 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
    return _from_srgb(srgb)


def _basis(n):
    """Branchless orthonormal basis (Duff et al. 2017)."""
    s = np.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = np.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    bt = np.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def _intersect_all(o, d, center, radius, t_min=1e-4):
    """Closest sphere hit: rays (N, 3) x spheres (K,). Returns (t, idx)."""
    oc = o[:, None, :] - center[None, :, :]            # (N, K, 3)
    b = np.sum(oc * d[:, None, :], axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius[None, :] ** 2
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = np.where(t0 >= t_min, t0, t1)
    t = np.where((disc > 0.0) & (t >= t_min), t, np.inf)
    idx = np.argmin(t, axis=-1)
    return t[np.arange(t.shape[0]), idx], idx


def _sample_vndf(rng_u, roughness, v_local):
    """Heitz 2018 "Sampling the GGX Distribution of Visible Normals"."""
    a = roughness[..., None]
    vh = _normalize(v_local * np.concatenate(
        [a, a, np.ones_like(a)], axis=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / np.sqrt(np.maximum(lensq, 1e-30))
    t1 = np.where((lensq > 1e-12)[..., None],
                  np.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                            np.zeros_like(inv)], -1),
                  np.broadcast_to(np.array([1.0, 0.0, 0.0]), vh.shape))
    t2 = np.cross(vh, t1)
    r = np.sqrt(rng_u[..., 0])
    phi = 2.0 * np.pi * rng_u[..., 1]
    p1 = r * np.cos(phi)
    p2 = r * np.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * np.sqrt(np.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = np.sqrt(np.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = np.stack([a[..., 0] * nh[..., 0], a[..., 0] * nh[..., 1],
                  np.maximum(nh[..., 2], 0.0)], -1)
    return _normalize(h)


def _smith_g1(roughness, c):
    a2 = roughness ** 4
    return 2.0 * c / np.maximum(
        c + np.sqrt(np.maximum(a2 + (1.0 - a2) * c * c, 0.0)), 1e-9)


def _vis_heightcorr(roughness, nol, nov):
    a2 = roughness ** 4
    gv = nol * np.sqrt(np.maximum(nov * nov * (1.0 - a2) + a2, 0.0))
    gl = nov * np.sqrt(np.maximum(nol * nol * (1.0 - a2) + a2, 0.0))
    return 0.5 / np.maximum(gv + gl, 1e-9)


def _d_ggx(roughness, noh):
    a2 = roughness ** 4
    d = noh * noh * (a2 - 1.0) + 1.0
    return a2 / np.maximum(np.pi * d * d, 1e-12)


def _fresnel_schlick(f0, voh):
    return f0 + (1.0 - f0) * np.clip(1.0 - voh, 0.0, 1.0)[..., None] ** 5


def _fresnel_dielectric(eta, voh):
    cos_i = np.clip(voh, 0.0, 1.0)
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin_t2, 0.0))
    rs = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-9)
    rp = (cos_i - eta * cos_t) / np.maximum(cos_i + eta * cos_t, 1e-9)
    return np.where(tir, 1.0, np.clip(0.5 * (rs * rs + rp * rp), 0.0, 1.0))


def _burley(roughness, nol, nov, voh):
    f90 = 0.5 + 2.0 * roughness * voh * voh
    lt = 1.0 + (f90 - 1.0) * np.clip(1.0 - nol, 0.0, 1.0) ** 5
    vt = 1.0 + (f90 - 1.0) * np.clip(1.0 - nov, 0.0, 1.0) ** 5
    return lt * vt / np.pi


# ---------------------------------------------------------------------------
# the tracer


def trace(scene_np: dict, ray_o: np.ndarray, ray_d: np.ndarray,
          bounces: int, spp: int, seed: int = 0) -> np.ndarray:
    """Path-trace (N, 3) camera rays; returns (N, 3) mean radiance."""
    rng = np.random.default_rng(seed)
    n = ray_o.shape[0]
    acc = np.zeros((n, 3))
    center = scene_np["center"]
    radius = scene_np["radius"]

    for _ in range(spp):
        o = ray_o.copy()
        d = ray_d.copy()
        thr = np.ones((n, 3))
        active = np.ones(n, bool)

        for _level in range(bounces + 1):
            t, idx = _intersect_all(o, d, center, radius)
            hit = np.isfinite(t) & active
            miss = active & ~hit
            acc[miss] += thr[miss] * _sky(d[miss])
            active = hit
            if not active.any():
                break

            p = o + d * np.where(hit, t, 0.0)[:, None]
            n_out = _normalize(p - center[idx])
            front = _dot(n_out, d) < 0.0
            nrm = np.where(front[:, None], n_out, -n_out)  # faces the ray

            acc[active] += (thr * scene_np["emission"][idx])[active]
            if _level == bounces:
                break

            bc = scene_np["base_color"][idx]
            metal = scene_np["metallic"][idx]
            rough = scene_np["roughness"][idx]
            ior = scene_np["ior"][idx]
            tw = scene_np["transmission"][idx] * (1.0 - metal)
            rw = 1.0 - tw
            ior_i = np.where(front, 1.0, ior)
            ior_o = np.where(front, ior, 1.0)
            eta = ior_i / ior_o
            f_diel = ((ior_i - ior_o) / (ior_i + ior_o)) ** 2
            f0 = f_diel[:, None] * (1.0 - metal[:, None]) \
                + bc * metal[:, None]
            albedo = bc * (1.0 - metal[:, None])

            v = -d
            nov = np.abs(_dot(nrm, v))
            tb, bb = _basis(nrm)
            v_local = np.stack([_dot(v, tb), _dot(v, bb), _dot(v, nrm)], -1)

            u_lobe = rng.random(n)
            u2 = rng.random((n, 2))
            u_f = rng.random(n)

            # Our own lobe split: transmission with prob tw (matching its
            # carried weight bc*tw exactly), reflection lobes 50/50.
            take_t = u_lobe < tw
            take_d = ~take_t & (u_lobe < tw + 0.5 * rw)
            take_s = ~take_t & ~take_d
            p_lobe = np.where(take_t, np.maximum(tw, 1e-9), 0.5 * rw)

            # Directions.
            h = _sample_vndf(u2, rough, v_local)
            h_world = (h[:, 0:1] * tb + h[:, 1:2] * bb + h[:, 2:3] * nrm)
            voh = np.abs(_dot(v, h_world))
            l_spec = _normalize(2.0 * voh[:, None] * h_world - v)

            r_cos = np.sqrt(u2[:, 1])
            s_cos = np.sqrt(np.maximum(1.0 - u2[:, 1], 0.0))
            phi = 2.0 * np.pi * u2[:, 0]
            l_diff = (s_cos * np.cos(phi))[:, None] * tb \
                + (s_cos * np.sin(phi))[:, None] * bb + r_cos[:, None] * nrm

            f_d = _fresnel_dielectric(eta, voh)
            cos_th = voh
            sin2_t = eta * eta * (1.0 - cos_th * cos_th)
            tir = sin2_t >= 1.0
            cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
            refr = _normalize(eta[:, None] * d
                              + (eta * cos_th - cos_t)[:, None] * h_world)
            reflect_mask = tir | (u_f < f_d)
            l_trans = np.where(reflect_mask[:, None], l_spec, refr)

            l = np.where(take_t[:, None], l_trans,
                         np.where(take_d[:, None], l_diff, l_spec))

            nol = np.abs(_dot(nrm, l))
            in_front = _dot(nrm, l) > 0.0

            # Weights f / (pdf * p_lobe), in cancellation-stable form.
            h_eval = _normalize(l + v)
            voh_e = np.abs(_dot(v, h_eval))
            w_diff = albedo * (_burley(rough, nol, nov, voh_e)
                               * np.pi)[:, None] * rw[:, None] / p_lobe[:, None]
            g1 = _smith_g1(rough, np.maximum(nov, 1e-6))
            vis = _vis_heightcorr(rough, nol, nov)
            fr = _fresnel_schlick(f0, voh_e)
            # VNDF pdf = G1 D / (4 NoV); f = NoL D Vis F -> f/pdf =
            # F * 4 NoL NoV Vis / G1 (D cancels; stable at mirror rough).
            w_spec = fr * (4.0 * nol * nov * vis
                           / np.maximum(g1, 1e-9))[:, None] \
                * rw[:, None] / p_lobe[:, None]
            w_trans = bc * tw[:, None] / p_lobe[:, None]

            w = np.where(take_t[:, None], w_trans,
                         np.where(take_d[:, None], w_diff, w_spec))
            valid = np.where(take_t, True, in_front)
            active = active & valid & (p_lobe > 0)
            thr = np.where(active[:, None], thr * w, thr)

            off = np.where(_dot(n_out, l) >= 0.0, 1.0, -1.0)
            o = p + n_out * (off * 1e-4)[:, None]
            d = np.where(active[:, None], l, d)

    return acc / spp


def run(width: int = 48, height: int = 27, spp: int = 256,
        bounces: int = 4, seed: int = 0, device="cuda") -> dict:
    """Render the demo scene with both tracers; return the metrics.

    The port's side (``pathtrace.trace_image`` with no accel, so the
    brute-force closest hit) runs on `device`, accumulated there in
    float64; the numpy side runs on the host."""
    import torch

    from . import backend
    from .models import myscene
    from .ops import camera as camera_mod, pathtrace

    dev = backend.device(device)
    host = myscene.build(seed=seed, device=dev)
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0,
                                 aspect=width / height, device=dev)
    ndc = camera_mod.pixel_ndc(width, height, torch.zeros(2, device=dev))
    o, d, _, _ = camera_mod.generate_pinhole_rays(cam, ndc)
    ray_o = _host(o).reshape(-1, 3)
    ray_d = _host(d).reshape(-1, 3)

    cfg = pathtrace.PathTraceConfig(width=width, height=height,
                                    bounces=bounces, samples_per_pixel=1,
                                    russian_roulette=False,
                                    throughput_threshold=0.0,
                                    block_size=16384)
    acc = torch.zeros((height, width, 3), dtype=torch.float64, device=dev)
    for f in range(spp):
        acc += pathtrace.trace_image(host.scene, cam, cfg, f).radiance
    ours = _host(acc) / spp

    theirs = trace(extract_scene(host.scene), ray_o, ray_d, bounces,
                   spp, seed=seed + 7777).reshape(height, width, 3)

    mean_ours = float(ours.mean())
    mean_theirs = float(theirs.mean())
    rel = np.abs(ours - theirs) / np.maximum(theirs, 0.05)
    return {
        "metric": "independent_tracer_crosscheck",
        "resolution": f"{width}x{height}",
        "spp": spp, "bounces": bounces,
        "mean_ours": round(mean_ours, 5),
        "mean_independent": round(mean_theirs, 5),
        "energy_ratio": round(mean_ours / max(mean_theirs, 1e-9), 4),
        "mean_rel_err": round(float(rel.mean()), 4),
        "p95_rel_err": round(float(np.quantile(rel, 0.95)), 4),
    }


if __name__ == "__main__":
    import json

    print(json.dumps(run()))
