"""The NRD-analogue denoisers (port of ``drts_tpu/ops/denoise.py``).

The data contract of the reference's NRD integration: demodulated diffuse
and specular radiance + hit distance in, denoised radiance out, composed
as ``diffuse * albedo + specular * f_env + primary radiance``
(NRDComposition.hlsl:50-87). Two cores:

* ``denoise`` (ReBLUR): exponential accumulation with a per-pixel history
  length, edge-stopping a-trous passes, history-convergence fade.
* ``denoise_relax`` (ReLAX, and DLSS-RR's lighter core): accumulation of
  luminance moments, variance-guided a-trous with w^2 variance
  propagation, firefly suppression.

History is fetched at pixel + motion through the reprojection kernel (B4,
``reproject_kernels.reproject_packed``): nearest on the f16-packed mirror
(a one-tap copy keeps its words), the config's ``history_filter`` on the
full-f32 concatenation otherwise. The kernel is the exact gather, so its
``ok`` is the in-frame test; the reference's TPU windows also reject
residuals beyond 3 px, which its XLA path does not. Images are (H, W, C)
at the public functions, as the reference; the a-trous passes work on
(C, H, W) stacks.

With a ``band`` (``parallel.mesh.Band``, the sharded frame) the inputs and
outputs hold the band's rows: the history leaves that B4 reads at pixel +
motion are gathered for the fetch (B4 writes the band's rows), and each
clamp-addressed filter runs on the band plus a halo of its footprint,
fetched once: one row for the 3x3 clamps (two for ReLAX, whose firefly
clamp comes first), 2^i - 1 rows for i a-trous passes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..utils import math as m
from . import reproject_kernels


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    max_accumulated_frames: int = 30   # ReBLUR-style cap
    atrous_iterations: int = 3
    depth_threshold: float = 0.05      # relative depth disocclusion test
    normal_threshold: float = 0.9      # cos angle for history validity
    sigma_luminance: float = 4.0
    specular_hitdist_scale: float = 1.0
    # History fetch: "nearest" (the f16-packed mirror) or "bilinear".
    history_filter: str = "nearest"
    # Reprojected history is clamped to the current 3x3 mean +- gamma *
    # sigma (ReLAX's history clamp); 0 disables.
    clamp_gamma: float = 2.5
    # Specular from the virtual reflection point (NRD ReBLUR's specular
    # motion) where the caller passes `motion_specular`.
    specular_virtual: bool = True
    relax_atrous_iterations: int = 4
    relax_sigma_luminance: float = 3.0   # in units of sqrt(variance)
    relax_firefly: bool = True
    relax_firefly_factor: float = 8.0    # clamp at N x neighbourhood mean


# Finite stand-in for a miss pixel's depth (inf - inf would be NaN).
_FAR_DEPTH = 1e8
_LUMA_W = (0.2126, 0.7152, 0.0722)
# The a-trous taps: (dy, dx, weight).
_KERNEL = ((0, 0, 0.25), (-1, 0, 0.125), (1, 0, 0.125), (0, -1, 0.125),
           (0, 1, 0.125), (-1, -1, 0.0625), (-1, 1, 0.0625),
           (1, -1, 0.0625), (1, 1, 0.0625))


@dataclasses.dataclass(frozen=True)
class DenoiserState:
    """History buffers. ``moments`` holds ReLAX's luminance moments [diff
    mu1, mu2, spec mu1, mu2] (ReBLUR passes it through). ``packed`` is the
    (H, W, 8) f16-pair fetch mirror [diff.rg, diff.b|hd, spec.rg,
    spec.b|hd, hist|depth, oct normal, mom d1|d2, mom s1|s2];
    ``packed_spec`` the (H, W, 2) specular-only mirror that the
    virtual-point fetch reads at its own motion."""
    diffuse: torch.Tensor         # (H, W, 4) rgb + hit distance
    specular: torch.Tensor        # (H, W, 4)
    history_length: torch.Tensor  # (H, W)
    normal: torch.Tensor          # (H, W, 3) previous shading normal
    depth: torch.Tensor           # (H, W) previous linear depth
    moments: torch.Tensor         # (H, W, 4)
    packed: torch.Tensor          # (H, W, 8)
    packed_spec: torch.Tensor     # (H, W, 2)


def _pack_history(diffuse, specular, hist, normal, depth, moments):
    return torch.stack([
        m.pack2f16(diffuse[..., 0], diffuse[..., 1]),
        m.pack2f16(diffuse[..., 2], diffuse[..., 3]),
        m.pack2f16(specular[..., 0], specular[..., 1]),
        m.pack2f16(specular[..., 2], specular[..., 3]),
        m.pack2f16(hist, torch.clamp(depth, max=3e4)),
        m.pack_oct16(normal),
        m.pack2f16(moments[..., 0], moments[..., 1]),
        m.pack2f16(moments[..., 2], moments[..., 3]),
    ], dim=-1)


def _pack_spec(specular):
    return torch.stack([m.pack2f16(specular[..., 0], specular[..., 1]),
                        m.pack2f16(specular[..., 2], specular[..., 3])],
                       dim=-1)


def _unpack_spec(p):
    s0, s1 = m.unpack2f16(p[..., 0])
    s2, s3 = m.unpack2f16(p[..., 1])
    return torch.stack([s0, s1, s2, s3], dim=-1)


def _unpack_history(prev):
    d0, d1 = m.unpack2f16(prev[..., 0])
    d2, d3 = m.unpack2f16(prev[..., 1])
    s0, s1 = m.unpack2f16(prev[..., 2])
    s2, s3 = m.unpack2f16(prev[..., 3])
    hist, depth = m.unpack2f16(prev[..., 4])
    m0, m1 = m.unpack2f16(prev[..., 6])
    m2, m3 = m.unpack2f16(prev[..., 7])
    return (torch.stack([d0, d1, d2, d3], dim=-1),
            torch.stack([s0, s1, s2, s3], dim=-1),
            hist, m.unpack_oct16(prev[..., 5]), depth,
            torch.stack([m0, m1, m2, m3], dim=-1))


def init_state(height: int, width: int, device="cuda") -> DenoiserState:
    """Fresh history (m_resetHistory, App.cpp:667-679)."""
    zero4 = torch.zeros((height, width, 4), dtype=torch.float32,
                        device=device)
    zero1 = torch.zeros((height, width), dtype=torch.float32, device=device)
    far = torch.full((height, width), _FAR_DEPTH, dtype=torch.float32,
                     device=device)
    up = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    up[..., 2] = 1.0
    return DenoiserState(
        diffuse=zero4, specular=zero4.clone(), history_length=zero1,
        normal=torch.zeros((height, width, 3), dtype=torch.float32,
                           device=device),
        depth=far, moments=zero4.clone(),
        packed=_pack_history(zero4, zero4, zero1, up, far, zero4),
        packed_spec=_pack_spec(zero4))


def _shift(img, dy: int, dx: int):
    """Clamp-addressed shift of an (H, W, ...) image: out[y, x] =
    img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _shift_chw(img, dy: int, dx: int):
    """Clamp-addressed shift on the trailing (H, W) axes of a (..., H, W)
    stack (edge padding, then a slice)."""
    if dy == 0 and dx == 0:
        return img
    lead = img.shape[:-2]
    flat = img.reshape((-1, 1) + img.shape[-2:])
    p = F.pad(flat, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)),
              mode="replicate")
    h, w = img.shape[-2], img.shape[-1]
    out = p[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]
    return out.reshape(lead + (h, w))


def _pow32(x):
    """x ** 32 as five squarings, the reference's integer power."""
    for _ in range(5):
        x = x * x
    return x


def _luma_chw(s):
    return _LUMA_W[0] * s[0] + _LUMA_W[1] * s[1] + _LUMA_W[2] * s[2]


def _luma(rgb):
    return (_LUMA_W[0] * rgb[..., 0] + _LUMA_W[1] * rgb[..., 1]
            + _LUMA_W[2] * rgb[..., 2])


def _reproject(packed, motion, history_filter: str, band=None):
    """History fetch of an (H, W, C) buffer at pixel + motion through B4.
    Returns (prev (H, W, C), in_bounds (H, W)). With a band, `motion` holds
    its rows and `packed` its rows or the whole frame's (gathered)."""
    row0 = 0
    if band is not None:
        packed, row0 = band.full(packed), band.start
    return reproject_kernels.reproject_packed(packed.contiguous(),
                                              motion.contiguous(),
                                              history_filter, row0)


def _with_halo(band, k: int, fn, *tensors):
    """fn(*tensors), a clamp-addressed filter whose rows read at most `k`
    rows away: on a band, run on its rows plus a k-row halo and cut back
    to its rows (a tensor or a tuple of them)."""
    if band is None:
        return fn(*tensors)
    out = fn(*band.halo(list(tensors), k, k))
    if isinstance(out, tuple):
        return tuple(band.inner(o, k) for o in out)
    return band.inner(out, k)


def _clip_box(cur, gamma: float):
    """The 3x3 per-channel mean -+ gamma * sigma of `cur`."""
    m1 = torch.zeros_like(cur)
    m2 = torch.zeros_like(cur)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(cur, dy, dx)
            m1 = m1 + s
            m2 = m2 + s * s
    mean = m1 / 9.0
    sigma = torch.sqrt(torch.clamp(m2 / 9.0 - mean * mean, min=0.0)) * gamma
    return mean - sigma, mean + sigma


def _neighborhood_clamp(prev, cur, gamma: float):
    """Clamp reprojected history to the current frame's 3x3 per-channel
    mean +- gamma * sigma; gamma <= 0 disables."""
    if gamma <= 0.0:
        return prev
    return torch.clamp(prev, *_clip_box(cur, gamma))


def _clamp_pair(prev_d, prev_s, cur_d, cur_s, gamma: float, band=None):
    """_neighborhood_clamp of the diffuse and specular histories; on a
    band, the boxes from a one-row halo of the current signals."""
    if gamma <= 0.0:
        return prev_d, prev_s
    lo_d, hi_d, lo_s, hi_s = _with_halo(
        band, 1, lambda d, s: (*_clip_box(d, gamma), *_clip_box(s, gamma)),
        cur_d, cur_s)
    return torch.clamp(prev_d, lo_d, hi_d), torch.clamp(prev_s, lo_s, hi_s)


def virtual_specular_motion(surface_motion, hit_position, ray_direction,
                            hit_distance, prev_px_of):
    """Specular motion from the virtual reflection point X + view * hitDist
    (NRD ReBLUR's specular motion model). ``prev_px_of`` maps world
    positions to (previous, current) pixel coordinates; lanes without a
    secondary hit keep the surface motion."""
    hd = torch.where(torch.isfinite(hit_distance), hit_distance, 0.0)
    xv = hit_position + ray_direction * torch.clamp(hd, max=3e4)[..., None]
    prev_px, cur_px = prev_px_of(xv)
    motion_v = prev_px - cur_px
    has_hit = torch.isfinite(hit_distance) & (hit_distance > 0)
    return torch.where(has_hit[..., None], motion_v, surface_motion)


def _atrous_pass_chw(signal, normal, depth, step: int, cfg: DenoiseConfig):
    """One edge-stopping a-trous iteration on (C, H, W) stacks; the
    falloffs are rational (1 / (1 + x)), as the reference's."""
    lum_c = _luma_chw(signal)
    inv_depth_sigma = 1.0 / torch.clamp(
        cfg.depth_threshold * torch.abs(depth), min=1e-4)
    acc = torch.zeros_like(signal)
    wsum = torch.zeros(signal.shape[-2:], dtype=torch.float32,
                       device=signal.device)
    for dy, dx, wk in _KERNEL:
        s = _shift_chw(signal, dy * step, dx * step)
        n = _shift_chw(normal, dy * step, dx * step)
        d = _shift_chw(depth, dy * step, dx * step)
        ndot = n[0] * normal[0] + n[1] * normal[1] + n[2] * normal[2]
        w_n = _pow32(torch.clamp(ndot, min=0.0))
        w_d = 1.0 / (1.0 + torch.abs(d - depth) * inv_depth_sigma)
        w_l = 1.0 / (1.0 + torch.abs(_luma_chw(s) - lum_c)
                     / cfg.sigma_luminance)
        w = wk * w_n * w_d * w_l
        acc = acc + s * w[None]
        wsum = wsum + w
    return acc / torch.clamp(wsum, min=1e-8)[None]


def _sanitize(depth, diffuse, specular):
    depth = torch.where(torch.isfinite(depth), depth, _FAR_DEPTH)
    return (depth, torch.nan_to_num(diffuse, nan=0.0, posinf=0.0, neginf=0.0),
            torch.nan_to_num(specular, nan=0.0, posinf=0.0, neginf=0.0))


def _fetch_history(state: DenoiserState, motion, cfg: DenoiseConfig,
                   relax: bool, band=None):
    """(prev diffuse, specular, hist, normal, depth, moments or None,
    in_bounds): nearest from the packed mirror, else the config's filter
    on the full-f32 concatenation."""
    if cfg.history_filter == "nearest":
        prev, in_bounds = _reproject(state.packed, motion, "nearest", band)
        return (*_unpack_history(prev), in_bounds)
    parts = [state.diffuse, state.specular, state.history_length[..., None],
             state.normal, state.depth[..., None]]
    if relax:
        parts.append(state.moments)
    prev, in_bounds = _reproject(torch.cat(parts, dim=-1), motion,
                                 cfg.history_filter, band)
    return (prev[..., 0:4], prev[..., 4:8], prev[..., 8], prev[..., 9:12],
            prev[..., 12], prev[..., 13:17] if relax else None, in_bounds)


def _history_tests(state, motion, motion_specular, normal, depth, valid,
                   reset, cfg, relax, band=None):
    """The history fetch and its disocclusion tests (depth + normal
    consistency). Returns (prev_diffuse, prev_specular, prev_hist,
    prev_moments, history_valid, spec_valid); the specular history comes
    from the virtual-point mirror when `motion_specular` is given."""
    (prev_diffuse, prev_specular, prev_hist, prev_normal, prev_depth,
     prev_moments, in_bounds) = _fetch_history(state, motion, cfg, relax,
                                               band)
    depth_ok = torch.abs(prev_depth - depth) \
        <= cfg.depth_threshold * torch.clamp(torch.abs(depth), min=1e-3)
    normal_ok = m.dot(prev_normal, normal) >= cfg.normal_threshold
    history_valid = in_bounds & depth_ok & normal_ok & valid & ~reset
    spec_valid = history_valid
    if motion_specular is not None and cfg.specular_virtual:
        prev_spec_v, in_bounds_v = _reproject(state.packed_spec,
                                              motion_specular, "nearest",
                                              band)
        prev_specular = _unpack_spec(prev_spec_v)
        spec_valid = in_bounds_v & normal_ok & valid & ~reset
    return (prev_diffuse, prev_specular, prev_hist, prev_moments,
            history_valid, spec_valid)


def denoise(state: DenoiserState, diffuse, specular, motion, normal, depth,
            valid, roughness, reset, cfg: DenoiseConfig = DenoiseConfig(),
            motion_specular=None, band=None):
    """ReBLUR: temporal accumulation + spatial filtering of the demodulated
    signals. diffuse/specular (H, W, 4) rgb + hit distance; motion (H, W,
    2), prev pixel = pixel + motion; normal/depth/valid/roughness the
    current G-buffer's; reset a bool (drop all history);
    motion_specular optional (H, W, 2) virtual-point motion; band the
    sharded frame's (module docstring). Returns (new_state, filtered
    diffuse, filtered specular), each (H, W, 4)."""
    reset = torch.as_tensor(reset, device=diffuse.device)
    depth, diffuse, specular = _sanitize(depth, diffuse, specular)
    (prev_diffuse, prev_specular, prev_hist, _, history_valid,
     spec_valid) = _history_tests(state, motion, motion_specular, normal,
                                  depth, valid, reset, cfg, relax=False,
                                  band=band)
    prev_diffuse, prev_specular = _clamp_pair(
        prev_diffuse, prev_specular, diffuse, specular, cfg.clamp_gamma,
        band)

    hist = torch.where(history_valid, prev_hist, 0.0)
    new_hist = torch.clamp(hist + 1.0, max=float(cfg.max_accumulated_frames))
    alpha = (1.0 / new_hist)[..., None]
    acc_diffuse = m.lerp(torch.where(history_valid[..., None], prev_diffuse,
                                     0.0), diffuse, alpha)
    # Specular history shortens with low roughness; with the virtual-point
    # fetch the floor relaxes toward plain 1/N accumulation.
    lo = 0.35 if (motion_specular is not None and cfg.specular_virtual) \
        else 0.1
    spec_hist_scale = torch.clamp(roughness * 2.0, lo, 1.0)
    spec_alpha = torch.maximum(alpha[..., 0], 1.0 - spec_hist_scale
                               * (1.0 - alpha[..., 0]))[..., None]
    spec_alpha = torch.where(spec_valid[..., None], spec_alpha, 1.0)
    acc_specular = m.lerp(torch.where(spec_valid[..., None], prev_specular,
                                      0.0), specular, spec_alpha)

    def atrous(acc_d, acc_s, nrm, dep):
        normal_chw = nrm.permute(2, 0, 1)
        f_d = acc_d.permute(2, 0, 1)
        f_s = acc_s.permute(2, 0, 1)
        for i in range(cfg.atrous_iterations):
            step = 1 << i
            f_d = _atrous_pass_chw(f_d, normal_chw, dep, step, cfg)
            f_s = _atrous_pass_chw(f_s, normal_chw, dep, step, cfg)
        return f_d.permute(1, 2, 0), f_s.permute(1, 2, 0)

    f_diffuse, f_specular = _with_halo(
        band, (1 << cfg.atrous_iterations) - 1, atrous, acc_diffuse,
        acc_specular, normal, depth)

    # Convergence fade: young pixels take the full spatial kernel,
    # converged ones none; mirror-like specular stays unfiltered.
    hist_blend = torch.clamp(4.0 / new_hist, 0.0, 1.0)[..., None]
    spec_blend = hist_blend * torch.clamp(roughness * 4.0, 0.1,
                                          1.0)[..., None]
    f_diffuse = m.lerp(acc_diffuse, f_diffuse, hist_blend)
    f_specular = m.lerp(acc_specular, f_specular, spec_blend)

    new_state = DenoiserState(
        diffuse=acc_diffuse, specular=acc_specular, history_length=new_hist,
        normal=normal, depth=depth, moments=state.moments,
        packed=_pack_history(acc_diffuse, acc_specular, new_hist, normal,
                             depth, state.moments),
        packed_spec=_pack_spec(acc_specular))
    return new_state, f_diffuse, f_specular


def _firefly_suppress(signal, factor: float):
    """ReLAX anti-firefly: clamp pixels whose luminance exceeds `factor` x
    the mean of their 8 neighbours."""
    rgb = signal[..., :3]
    lum = _luma(rgb)
    nsum = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nsum = nsum + _shift(lum, dy, dx)
    limit = factor * (nsum / 8.0) + 1e-3
    scale = torch.where(lum > limit, limit / torch.clamp(lum, min=1e-6), 1.0)
    return torch.cat([rgb * scale[..., None], signal[..., 3:]], dim=-1)


def _atrous_relax_chw(signal, var, normal, depth, step: int,
                      cfg: DenoiseConfig):
    """One variance-guided a-trous iteration (SVGF / ReLAX) on (C, H, W):
    the luminance falloff scales with the 3x3-prefiltered sqrt(variance),
    and the variance propagates with w^2 weights."""
    lum_c = _luma_chw(signal)
    vsum = var
    for dy, dx, _ in _KERNEL[1:]:
        vsum = vsum + _shift_chw(var, dy, dx)
    sigma = torch.sqrt(torch.clamp(vsum / 9.0, min=0.0))
    inv_sigma_l = 1.0 / (cfg.relax_sigma_luminance * sigma + 1e-4)
    inv_depth_sigma = 1.0 / torch.clamp(
        cfg.depth_threshold * torch.abs(depth), min=1e-4)
    acc = torch.zeros_like(signal)
    acc_var = torch.zeros_like(var)
    wsum = torch.zeros(var.shape, dtype=torch.float32, device=var.device)
    for dy, dx, wk in _KERNEL:
        s = _shift_chw(signal, dy * step, dx * step)
        v = _shift_chw(var, dy * step, dx * step)
        n = _shift_chw(normal, dy * step, dx * step)
        d = _shift_chw(depth, dy * step, dx * step)
        ndot = n[0] * normal[0] + n[1] * normal[1] + n[2] * normal[2]
        w_n = _pow32(torch.clamp(ndot, min=0.0))
        w_d = 1.0 / (1.0 + torch.abs(d - depth) * inv_depth_sigma)
        w_l = 1.0 / (1.0 + torch.abs(_luma_chw(s) - lum_c) * inv_sigma_l)
        w = wk * w_n * w_d * w_l
        acc = acc + s * w[None]
        acc_var = acc_var + v * w * w
        wsum = wsum + w
    wsum = torch.clamp(wsum, min=1e-8)
    return acc / wsum[None], acc_var / (wsum * wsum)


def _spatial_variance(lum):
    """The 3x3 variance of a luminance plane (ReLAX's young-pixel
    estimate)."""
    sp1 = sp2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ls = _shift(lum, dy, dx)
            sp1 = sp1 + ls
            sp2 = sp2 + ls * ls
    return torch.clamp(sp2 / 9.0 - (sp1 / 9.0) ** 2, min=0.0)


def denoise_relax(state: DenoiserState, diffuse, specular, motion, normal,
                  depth, valid, roughness, reset,
                  cfg: DenoiseConfig = DenoiseConfig(),
                  motion_specular=None, band=None):
    """ReLAX: moment accumulation + variance-guided a-trous, with the I/O
    contract of ``denoise``. Young pixels (history < 4) take a 3x3 spatial
    variance estimate; fireflies are clamped first."""
    reset = torch.as_tensor(reset, device=diffuse.device)
    depth, diffuse, specular = _sanitize(depth, diffuse, specular)
    gamma = cfg.clamp_gamma

    def spatial(d, s):
        """The 3x3 filters of the current signals: the firefly clamp, the
        history clip boxes and the luminance variances."""
        if cfg.relax_firefly:
            d = _firefly_suppress(d, cfg.relax_firefly_factor)
            s = _firefly_suppress(s, cfg.relax_firefly_factor)
        boxes = ((*_clip_box(d, gamma), *_clip_box(s, gamma))
                 if gamma > 0.0 else ())
        return (d, s, _spatial_variance(_luma(d)),
                _spatial_variance(_luma(s)), *boxes)

    diffuse, specular, sp_var_d, sp_var_s, *boxes = _with_halo(
        band, 2 if cfg.relax_firefly else 1, spatial, diffuse, specular)
    lum_d = _luma(diffuse)
    lum_s = _luma(specular)
    cur_moments = torch.stack([lum_d, lum_d * lum_d, lum_s, lum_s * lum_s],
                              dim=-1)

    (prev_diffuse, prev_specular, prev_hist, prev_moments, history_valid,
     spec_valid) = _history_tests(state, motion, motion_specular, normal,
                                  depth, valid, reset, cfg, relax=True,
                                  band=band)
    if boxes:
        prev_diffuse = torch.clamp(prev_diffuse, boxes[0], boxes[1])
        prev_specular = torch.clamp(prev_specular, boxes[2], boxes[3])

    hist = torch.where(history_valid, prev_hist, 0.0)
    new_hist = torch.clamp(hist + 1.0, max=float(cfg.max_accumulated_frames))
    alpha = (1.0 / new_hist)[..., None]
    hv = history_valid[..., None]
    sv = spec_valid[..., None]
    spec_alpha = torch.where(sv, alpha, 1.0)
    acc_diffuse = m.lerp(torch.where(hv, prev_diffuse, 0.0), diffuse, alpha)
    acc_specular = m.lerp(torch.where(sv, prev_specular, 0.0), specular,
                          spec_alpha)
    acc_moments = m.lerp(torch.where(hv, prev_moments, 0.0), cur_moments,
                         alpha)

    var_d = torch.clamp(acc_moments[..., 1] - acc_moments[..., 0] ** 2,
                        min=0.0)
    var_s = torch.clamp(acc_moments[..., 3] - acc_moments[..., 2] ** 2,
                        min=0.0)
    young = new_hist < 4.0
    var_d = torch.where(young, torch.maximum(var_d, sp_var_d), var_d)
    var_s = torch.where(young, torch.maximum(var_s, sp_var_s), var_s)

    def atrous(acc_d, v_d, acc_s, v_s, nrm, dep):
        normal_chw = nrm.permute(2, 0, 1)
        f_d = acc_d.permute(2, 0, 1)
        f_s = acc_s.permute(2, 0, 1)
        for i in range(cfg.relax_atrous_iterations):
            step = 1 << i
            f_d, v_d = _atrous_relax_chw(f_d, v_d, normal_chw, dep, step,
                                         cfg)
            f_s, v_s = _atrous_relax_chw(f_s, v_s, normal_chw, dep, step,
                                         cfg)
        return f_d.permute(1, 2, 0), f_s.permute(1, 2, 0)

    f_diffuse, f_specular = _with_halo(
        band, (1 << cfg.relax_atrous_iterations) - 1, atrous, acc_diffuse,
        var_d, acc_specular, var_s, normal, depth)
    spec_keep = torch.clamp(roughness * 4.0, 0.1, 1.0)[..., None]
    f_specular = m.lerp(acc_specular, f_specular, spec_keep)

    new_state = DenoiserState(
        diffuse=acc_diffuse, specular=acc_specular, history_length=new_hist,
        normal=normal, depth=depth, moments=acc_moments,
        packed=_pack_history(acc_diffuse, acc_specular, new_hist, normal,
                             depth, acc_moments),
        packed_spec=_pack_spec(acc_specular))
    return new_state, f_diffuse, f_specular


def compose(gbuf_radiance, f_diffuse, f_specular, diffuse_albedo,
            specular_albedo, valid):
    """NRDComposition unpack (NRDComposition.hlsl:71-87): remodulate and
    add the primary emission / environment radiance."""
    out = (f_diffuse[..., :3] * diffuse_albedo
           + f_specular[..., :3] * specular_albedo)
    return torch.where(valid[..., None], gbuf_radiance + out, gbuf_radiance)


def demodulate(radiance_diffuse, radiance_specular, diffuse_albedo,
               specular_albedo, eps: float = 1e-3):
    """NRDComposition pack (NRDComposition.hlsl:50-70)."""
    return (radiance_diffuse / torch.clamp(diffuse_albedo, min=eps),
            radiance_specular / torch.clamp(specular_albedo, min=eps))
