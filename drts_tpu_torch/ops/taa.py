"""Temporal anti-aliasing upscaler, the DLSS / XeSS super-resolution
stand-in (port of ``drts_tpu/ops/taa.py``).

Jittered render-size frames accumulate into an output-size history
reprojected along the motion vectors, with a neighbourhood variance clip
whose box tightens where pixels move (the motion-adaptive clip). The
quality-mode render-scale table is the reference's (App.cpp:1374-1451).

History fetch: "bilinear" (the default) samples the full-f32 history
through the reprojection kernel (B4, ``reproject_kernels``), as the
reference's TPU path does; its XLA path reads the f16-packed mirror
instead (``packed``, kept here as the state's fetch mirror). "catmull" is
the reference's 16-tap Catmull-Rom in plain PyTorch, as the reference
serves it only by XLA; like its XLA path it has no window mask.

On the sharded frame (``upscale(..., band=, out_band=)``) a rank writes its
band of output rows: its render rows and a halo (the rows its bilinear
taps and its 3x3 clip read, ``source_rows``) come from the neighbours, the
history is gathered for the fetch at pixel + motion, and B4 writes the
band's rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import math as m
from . import post, reproject_kernels

# DLSS/XeSS-style quality-mode render-scale table.
SCALE_FACTORS = {
    "Native": 1.0,
    "Quality": 1.5,
    "Balanced": 1.72,
    "Performance": 2.0,
    "UltraPerformance": 3.0,
    "Auto": 2.0,
}
HISTORY_FILTERS = ("bilinear", "catmull")


def render_size_for(output_w: int, output_h: int, mode: str):
    s = SCALE_FACTORS[mode]
    return max(16, int(round(output_w / s))), max(16, int(round(output_h / s)))


@dataclasses.dataclass(frozen=True)
class TAAConfig:
    blend_alpha: float = 0.1
    clip_gamma: float = 1.0      # variance-clip box size in std-devs
    # The box blends toward this gamma as motion reaches clip_motion_px
    # output pixels per frame; < 0 keeps clip_gamma everywhere.
    clip_gamma_motion: float = -1.0
    clip_motion_px: float = 1.0
    history_filter: str = "bilinear"
    # Resample the current frame at its true (jittered) sample positions
    # and weight each output pixel by its distance to the nearest sample.
    jitter_aware: bool = True
    jitter_sigma: float = 0.45   # reconstruction kernel width (render px)


@dataclasses.dataclass(frozen=True)
class TAAState:
    history: torch.Tensor  # (OH, OW, 3) accumulated output colour
    packed: torch.Tensor   # (OH, OW, 2) f16-pair mirror [r|g, b|0]


def _pack_rgb16(img):
    zero = torch.zeros_like(img[..., 2])
    return torch.stack([m.pack2f16(img[..., 0], img[..., 1]),
                        m.pack2f16(img[..., 2], zero)], dim=-1)


def init_state(out_height: int, out_width: int, device="cuda") -> TAAState:
    zero = torch.zeros((out_height, out_width, 3), dtype=torch.float32,
                       device=device)
    return TAAState(history=zero, packed=_pack_rgb16(zero))


def _catmull_rom_sample(img, y, x):
    """16-tap Catmull-Rom resample at pixel-index coordinates (centres at
    integers, so the filter is the identity at whole pixels), clamp
    addressed, clamped at 0."""
    h, w = img.shape[0], img.shape[1]
    yc = torch.floor(y)
    xc = torch.floor(x)
    fy = y - yc
    fx = x - xc

    def weights(f):
        f2 = f * f
        f3 = f2 * f
        return (-0.5 * f3 + f2 - 0.5 * f, 1.5 * f3 - 2.5 * f2 + 1.0,
                -1.5 * f3 + 2.0 * f2 + 0.5 * f, 0.5 * f3 - 0.5 * f2)

    wy = weights(fy)
    wx = weights(fx)
    flat = img.reshape(-1, img.shape[-1])
    acc = torch.zeros(y.shape + (img.shape[-1],), dtype=img.dtype,
                      device=img.device)
    for iy in range(4):
        yi = torch.clamp((yc + iy - 1).to(torch.int64), 0, h - 1)
        row = torch.zeros_like(acc)
        for ix in range(4):
            xi = torch.clamp((xc + ix - 1).to(torch.int64), 0, w - 1)
            row = row + flat[yi * w + xi] * wx[ix][..., None]
        acc = acc + row * wy[iy][..., None]
    return torch.clamp(acc, min=0.0)


def _separable_bilinear(img, y, x, src_h: int | None = None,
                        src_row0: int = 0):
    """Bilinear resample on a separable grid (per-axis 1-D coordinates
    y (OH,), x (OW,)), clamp addressed. `img` may hold rows src_row0... of
    a src_h-row frame (the frame's edges clamp)."""
    h, w = img.shape[0], img.shape[1]
    if src_h is not None:
        h = src_h
    y0 = torch.floor(y)
    fy = (y - y0)[:, None, None]
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    if src_row0:
        y0i, y1i = y0i - src_row0, y1i - src_row0
    rows = img[y0i] * (1.0 - fy) + img[y1i] * fy
    x0 = torch.floor(x)
    fx = (x - x0)[None, :, None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    return rows[:, x0i] * (1.0 - fx) + rows[:, x1i] * fx


def source_rows(o0: int, o1: int, rh: int, out_h: int, taps: int = 2):
    """[first, last + 1) of the render rows that output rows [o0, o1) of
    an upscale from rh rows read: the bilinear taps at (o + 0.5) * rh /
    out_h - 0.5 shifted by a jitter of at most half a pixel, widened by
    `taps` rows for the float rounding and the tent's second tap."""
    ratio = rh / out_h
    return (math.floor((o0 + 0.5) * ratio - 0.5 - 0.5) - taps + 1,
            math.floor((o1 - 0.5) * ratio - 0.5 + 0.5) + taps + 1)


def upscale(state: TAAState, color, motion, jitter, out_h: int, out_w: int,
            reset, cfg: TAAConfig = TAAConfig(), confidence=None,
            band=None, out_band=None):
    """One TAA-upscale step. color (RH, RW, 3) jittered render-size frame;
    motion (RH, RW, 2) render-size pixel motion (prev = cur + motion);
    jitter (2,) the camera jitter (x, y) in render pixels; reset a bool.
    ``confidence`` (RH, RW) in [0, 1], optional: DLSS-RR's coupling, low
    confidence raises the blend toward the current frame. Returns
    (new_state, output (OH, OW, 3)). With ``band`` and ``out_band`` (the
    sharded frame's render and output bands, ``parallel.mesh.Band``) the
    render inputs and the history hold their band's rows (the history may
    hold the whole frame), and the state and output come back as the
    output band's rows."""
    if cfg.history_filter not in HISTORY_FILTERS:
        raise ValueError(f"history_filter must be one of {HISTORY_FILTERS}, "
                         f"got {cfg.history_filter!r}")
    dev = color.device
    rw = color.shape[1]
    rh = band.height if band is not None else color.shape[0]
    scale_y = out_h / rh
    scale_x = out_w / rw
    history = state.history
    o0, o1 = out_band.span() if out_band is not None else (0, out_h)
    # `up` covers output rows [u0, u1): the band and the clip's one row.
    u0, u1, c0 = o0, o1, 0
    if band is not None:
        u0, u1 = max(0, o0 - 1), min(out_h, o1 + 1)
        lo, hi = out_band.source_halo(band, lambda a, b: source_rows(
            max(0, a - 1), min(out_h, b + 1), rh, out_h))
        parts = [color, motion] + ([confidence[..., None]]
                                   if confidence is not None else [])
        parts = band.halo(parts, lo, hi)
        color, motion = parts[0], parts[1]
        if confidence is not None:
            confidence = parts[2][..., 0]
        c0 = band.ext_span(lo, hi)[0]
        history = out_band.full(history)

    if cfg.jitter_aware:
        # Render sample i sits at i + jitter: read the source at q - jitter.
        qy = (torch.arange(u0, u1, dtype=torch.float32, device=dev)
              + 0.5) / scale_y - 0.5
        qx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
            / scale_x - 0.5
        sy = qy - jitter[1]
        sx = qx - jitter[0]
        up = _separable_bilinear(color, sy, sx, rh, c0)
        dy = sy - torch.round(sy)
        dx = sx - torch.round(sx)
        d2 = (dy * dy)[:, None] + (dx * dx)[None, :]
        sample_w = torch.exp(-d2 / (2.0 * cfg.jitter_sigma ** 2))
    else:
        up = post.resize_bilinear(color, out_h, out_w, (u0, u1), c0, rh)
        sample_w = torch.ones((u1 - u0, out_w), dtype=torch.float32,
                              device=dev)
    h = o1 - o0
    sample_w = sample_w[o0 - u0:o1 - u0]

    # Motion at output size, in output pixels.
    motion_up = post.resize_bilinear(motion, out_h, out_w, (o0, o1), c0,
                                     rh) \
        * m.const((scale_x, scale_y), device=dev)
    py = torch.arange(o0, o1, dtype=torch.float32, device=dev)[:, None] \
        * torch.ones((1, out_w), dtype=torch.float32, device=dev)
    px = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] \
        * torch.ones((h, 1), dtype=torch.float32, device=dev)
    if cfg.history_filter == "catmull":
        hist = _catmull_rom_sample(history, py + motion_up[..., 1],
                                   px + motion_up[..., 0])
    else:
        hist, _ = reproject_kernels.reproject_packed(
            history.contiguous(), motion_up.contiguous(), "bilinear", o0)

    # Neighbourhood variance clip in the upsampled current frame (clamped
    # at the frame's edges: `up` holds the band's rows and one more each
    # side inside the frame).
    m1 = torch.zeros_like(up)
    m2 = torch.zeros_like(up)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            ys = torch.clamp(torch.arange(u1 - u0, device=dev) + oy, 0,
                             u1 - u0 - 1)
            xs = torch.clamp(torch.arange(out_w, device=dev) + ox, 0,
                             out_w - 1)
            s = up[ys][:, xs]
            m1 = m1 + s
            m2 = m2 + s * s
    up = up[o0 - u0:o1 - u0]
    mean = (m1 / 9.0)[o0 - u0:o1 - u0]
    var = torch.clamp((m2 / 9.0)[o0 - u0:o1 - u0] - mean * mean, min=0.0)
    gamma = cfg.clip_gamma
    if cfg.clip_gamma_motion >= 0.0:
        mlen = torch.sqrt(motion_up[..., 0] ** 2 + motion_up[..., 1] ** 2)
        f = torch.clamp(mlen / cfg.clip_motion_px, 0.0, 1.0)[..., None]
        gamma = cfg.clip_gamma + (cfg.clip_gamma_motion - cfg.clip_gamma) * f
    sigma = torch.sqrt(var) * gamma
    hist_clipped = torch.clamp(hist, mean - sigma, mean + sigma)

    in_bounds = (((py + motion_up[..., 1]) >= 0)
                 & ((py + motion_up[..., 1]) <= out_h - 1)
                 & ((px + motion_up[..., 0]) >= 0)
                 & ((px + motion_up[..., 0]) <= out_w - 1))
    alpha = cfg.blend_alpha * (0.25 + 0.75 * sample_w)
    if confidence is not None:
        conf_up = post.resize_bilinear(confidence[..., None], out_h,
                                       out_w, (o0, o1), c0, rh)[..., 0]
        alpha = torch.clamp(alpha * (1.0 + 3.0 * (1.0 - conf_up)), 0.0, 1.0)
    keep = in_bounds & ~torch.as_tensor(reset, device=dev)
    alpha = torch.where(keep, alpha, 1.0)[..., None]
    out = m.lerp(hist_clipped, up, alpha)
    return TAAState(history=out, packed=_pack_rgb16(out)), out

