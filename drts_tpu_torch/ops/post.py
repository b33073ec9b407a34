"""Post-processing: bloom, merge, sharpening, tone mapping, chromatic
aberration, bilinear resize and the mip pyramid (port of
``drts_tpu/ops/post.py``).

Each pass is a pure (H, W, 3) -> (H, W, 3) function over plain PyTorch ops.
Clamp-addressed neighbourhood shifts are index gathers with clamped
indices, the same values as the reference's edge pad and slice.

On the sharded frame each pass takes a ``band`` (``parallel.mesh.Band``)
and works on that band's rows plus a halo of its footprint from the
neighbours, clamped at the frame's edges, so a band's rows are the whole
frame's: sharpen one row; each bloom downsample one row below and two
above, each upsample the source rows of its bilinear taps and its tent
(mip l + 1's band is the rows 2y of mip l's, so no mip is gathered);
chromatic aberration the rows its resample reads; ``resize_band`` the
rows its bilinear taps read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import math as m


# ----------------------------------------------------------------------------
# Tone mapping (ToneMapPostProcess: Saturate | Reinhard | ACESFilmic)


def tonemap_saturate(x, exposure=1.0):
    return m.saturate(x * exposure)


def tonemap_reinhard(x, exposure=1.0):
    x = torch.clamp(x * exposure, min=0.0)
    return x / (1.0 + x)


def tonemap_aces(x, exposure=1.0):
    """ACES filmic fit (Narkowicz), as DirectXTK's Operator_ACESFilmic."""
    x = torch.clamp(x * exposure, min=0.0)
    return m.saturate((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14))


TONEMAP_OPERATORS = {
    "Saturate": tonemap_saturate,
    "Reinhard": tonemap_reinhard,
    "ACESFilmic": tonemap_aces,
}

# Colour-primary rotations (ToneMapPostProcess::SetColorRotation,
# App.cpp:1744, 2216-2225): Rec.709 / DCI-P3-D65 / Rec.2020, D65 white.
REC709_TO_REC2020 = (
    (0.627404, 0.329283, 0.043313),
    (0.069097, 0.919540, 0.011362),
    (0.016392, 0.088013, 0.895595),
)
P3D65_TO_REC2020 = (
    (0.753833, 0.198597, 0.047570),
    (0.045744, 0.941777, 0.012479),
    (-0.001210, 0.017602, 0.983608),
)
REC709_TO_P3D65 = (
    (0.822462, 0.177538, 0.000000),
    (0.033194, 0.966806, 0.000000),
    (0.017083, 0.072397, 0.910520),
)
COLOR_ROTATIONS = {
    "HDTV_to_UHDTV": REC709_TO_REC2020,
    "DCI_P3_D65_to_UHDTV": P3D65_TO_REC2020,
    "HDTV_to_DCI_P3_D65": REC709_TO_P3D65,
}


def st2084_encode(nits):
    """SMPTE ST.2084 (PQ) OETF: absolute luminance in nits -> signal."""
    m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
    c1 = 3424.0 / 4096.0
    c2 = 2413.0 / 4096.0 * 32.0
    c3 = 2392.0 / 4096.0 * 32.0
    yp = torch.pow(torch.clamp(nits / 10000.0, 0.0, 1.0), m1)
    return torch.pow((c1 + c2 * yp) / (1.0 + c3 * yp), m2)


def tonemap_hdr10(x, exposure=1.0, paper_white_nits: float = 200.0,
                  color_rotation: str = "HDTV_to_UHDTV"):
    """HDR10 signal (App.cpp:1737-1744): primaries rotation, paper-white
    scale, ST.2084 encode."""
    v = torch.clamp(x * exposure, min=0.0)
    mat = m.const(tuple(map(tuple, COLOR_ROTATIONS[color_rotation])),
                  v.dtype, v.device)
    v = torch.einsum("...c,rc->...r", v, mat)
    return st2084_encode(v * paper_white_nits)


def tonemap(x, operator: str = "ACESFilmic", exposure=1.0,
            output_srgb: bool = True, hdr: bool = False,
            paper_white_nits: float = 200.0,
            color_rotation: str = "HDTV_to_UHDTV"):
    """Display mapping. SDR: operator curve + sRGB encode. HDR: the
    ST.2084 / Rec.2020 signal (no SDR curve, no sRGB)."""
    if hdr:
        return tonemap_hdr10(x, exposure, paper_white_nits, color_rotation)
    y = TONEMAP_OPERATORS[operator](x, exposure)
    return m.to_srgb(y) if output_srgb else y


# ----------------------------------------------------------------------------
# Merge (Merge.hlsl:24-35) and bilinear resize


def merge(a, b, weight_a, weight_b):
    if b.shape[:2] != a.shape[:2]:
        b = resize_bilinear(b, a.shape[0], a.shape[1])
    return a * weight_a + b * weight_b


def resize_bilinear(img, out_h: int, out_w: int, rows=None,
                    src_row0: int = 0, src_h: int | None = None):
    """Bilinear resize (align-corners=False, clamp addressing), the
    sampler behaviour the post shaders rely on. ``rows`` = (start, end)
    gives those output rows only, from an `img` that holds rows src_row0...
    of a src_h-row source (the rows they read; the source's edges
    clamp)."""
    h, w = img.shape[0], img.shape[1]
    if src_h is not None:
        h = src_h
    o0, o1 = rows if rows is not None else (0, out_h)
    dev = img.device
    y = (torch.arange(o0, o1, dtype=torch.float32, device=dev) + 0.5) \
        * (h / out_h) - 0.5
    x = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * (w / out_w) - 0.5
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = (y - y0)[:, None, None]
    fx = (x - x0)[None, :, None]
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    if src_row0:
        y0i, y1i = y0i - src_row0, y1i - src_row0
    x0i = torch.clamp(x0.long(), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    top = img[y0i][:, x0i] * (1 - fx) + img[y0i][:, x1i] * fx
    bot = img[y1i][:, x0i] * (1 - fx) + img[y1i][:, x1i] * fx
    return top * (1 - fy) + bot * fy


def resize_source(o0: int, o1: int, src_h: int, out_h: int):
    """[first, last + 1) of the source rows that output rows [o0, o1) of a
    resize from src_h rows read (a row of margin each side for the float
    rounding)."""
    ratio = src_h / out_h
    return (math.floor((o0 + 0.5) * ratio - 0.5) - 1,
            math.floor((o1 - 0.5) * ratio - 0.5) + 3)


def resize_band(img, band, out_band, out_w: int, grow: int = 0):
    """``resize_bilinear`` to out_band.height x out_w of the frame whose
    `band` rows `img` holds, as out_band's rows and `grow` more each side
    (cut at the frame's edges, ``out_band.ext_span(grow, grow)``): the
    source rows come as a halo."""
    out_h = out_band.height
    lo, hi = out_band.source_halo(band, lambda a, b: resize_source(
        max(0, a - grow), min(out_h, b + grow), band.height, out_h))
    ext = band.halo([img], lo, hi)[0]
    return resize_bilinear(ext, out_h, out_w, out_band.ext_span(grow, grow),
                           band.ext_span(lo, hi)[0], band.height)

# ----------------------------------------------------------------------------
# Bloom (Bloom.hlsl:33-110): 13-tap Karis-average downsample and 9-tap tent
# upsample over the pyramid, merged at a strength weight (Bloom.ixx:81-131).


def _shift(img, dy: int, dx: int):
    """Clamp-addressed neighbourhood shift: out[y, x] = img[clamp(y + dy),
    clamp(x + dx)]."""
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


def _karis_weight(c):
    return 1.0 / (1.0 + m.luminance(c)[..., None])


def bloom_downsample(img):
    """13-tap downsample with the Karis average over its five 4-tap box
    groups (firefly suppression), then 2x decimation."""
    return _bloom_filter(img)[::2, ::2]


def _bloom_filter(img):
    """bloom_downsample's 13-tap filter at every pixel (rows y - 1 to
    y + 2), before the decimation."""
    def box(dy, dx):
        return 0.25 * (_shift(img, dy, dx) + _shift(img, dy, dx + 1)
                       + _shift(img, dy + 1, dx) + _shift(img, dy + 1, dx + 1))

    g_c = box(0, 0)
    g_tl = box(-1, -1)
    g_tr = box(-1, 1)
    g_bl = box(1, -1)
    g_br = box(1, 1)
    w_c = _karis_weight(g_c) * 0.5
    w_tl = _karis_weight(g_tl) * 0.125
    w_tr = _karis_weight(g_tr) * 0.125
    w_bl = _karis_weight(g_bl) * 0.125
    w_br = _karis_weight(g_br) * 0.125
    total = w_c + w_tl + w_tr + w_bl + w_br
    return (g_c * w_c + g_tl * w_tl + g_tr * w_tr + g_bl * w_bl
            + g_br * w_br) / total


def _tent(up):
    acc = 4.0 * up
    for dy, dx, w in ((-1, 0, 2.0), (1, 0, 2.0), (0, -1, 2.0), (0, 1, 2.0),
                      (-1, -1, 1.0), (-1, 1, 1.0), (1, -1, 1.0), (1, 1, 1.0)):
        acc = acc + w * _shift(up, dy, dx)
    return acc


def bloom_upsample(img, out_h: int, out_w: int, band=None, out_band=None):
    """9-tap tent filter upsample (Bloom.hlsl upsample pass); with bands,
    out_band's rows from `img`'s `band` rows."""
    if band is None:
        return _tent(resize_bilinear(img, out_h, out_w)) / 16.0
    acc = _tent(resize_band(img, band, out_band, out_w, grow=1))
    return out_band.inner(acc, 1) / 16.0


def _half_band(band):
    """The band of mip l + 1 whose rows y are the rows 2y of `band`'s."""
    return dataclasses.replace(
        band, bands=tuple(((s + 1) // 2, (e + 1) // 2)
                          for s, e in band.bands),
        height=(band.height + 1) // 2)


def bloom(img, strength=0.05, levels: int = 4, band=None):
    """The bloom chain (Bloom.ixx::Process): `levels` downsamples, as many
    tent upsamples with additive blend, merged at `strength`. With a
    band, `img` holds its rows and so does the result."""
    mips, bands = [img], [band]
    for _ in range(levels):
        b = bands[-1]
        if b is None:
            mips.append(bloom_downsample(mips[-1]))
            bands.append(None)
            continue
        filtered = b.inner(_bloom_filter(b.halo([mips[-1]], 1, 2)[0]), 1)
        mips.append(filtered[b.start % 2::2, ::2])
        bands.append(_half_band(b))
    up = mips[-1]
    for level in range(levels - 1, -1, -1):
        target = mips[level]
        up = target + bloom_upsample(
            up, bands[level].height if band is not None else target.shape[0],
            target.shape[1], bands[level + 1], bands[level])
    return merge(img, up / (levels + 1), 1.0 - strength, strength)


# ----------------------------------------------------------------------------
# Sharpen (the NIS slot, App.cpp:1498-1502): contrast-adaptive unsharp mask.


def sharpen(img, sharpness=0.5, band=None):
    src = img
    if band is not None:
        src = band.halo([img], 1, 1)[0]
    blur = 0.25 * (_shift(src, -1, 0) + _shift(src, 1, 0)
                   + _shift(src, 0, -1) + _shift(src, 0, 1))
    if band is not None:
        blur = band.inner(blur, 1)
    amount = 0.8 * sharpness
    return torch.clamp(img + (img - blur) * amount, min=0.0)


# ----------------------------------------------------------------------------
# Lateral chromatic aberration: R magnified outward, B inward, about the
# image centre, as separable bilinear resamples with static coordinates.


def _axis_taps(n: int, scale: float):
    """(i0, i1, f) of the resample of an n-long axis about its centre."""
    coords = (np.arange(n, dtype=np.float64) - (n - 1) / 2) / scale \
        + (n - 1) / 2
    i0 = np.clip(np.floor(coords).astype(np.int64), 0, n - 1)
    i1 = np.minimum(i0 + 1, n - 1)
    return i0, i1, np.clip(coords - i0, 0.0, 1.0)


def _scale_about_center(ch, scale: float, band=None, src_row0: int = 0):
    """With a band: its rows of the whole frame's, from `ch` holding rows
    src_row0... (the rows its taps read)."""
    out = ch
    for axis in (0, 1):
        if axis == 0 and band is not None:
            i0, i1, f = _axis_taps(band.height, scale)
            s, e = band.span()
            i0, i1, f = i0[s:e] - src_row0, i1[s:e] - src_row0, f[s:e]
        else:
            i0, i1, f = _axis_taps(out.shape[axis], scale)
        f = torch.as_tensor(f, dtype=torch.float32, device=ch.device)
        a = torch.index_select(out, axis, torch.as_tensor(i0,
                                                          device=ch.device))
        b = torch.index_select(out, axis, torch.as_tensor(i1,
                                                          device=ch.device))
        fshape = [1, 1]
        fshape[axis] = f.shape[0]
        out = a + (b - a) * f.reshape(fshape)
    return out


def chromatic_aberration(img, strength: float = 0.0, band=None):
    """(H, W, 3) display-space image -> lateral CA; `strength` is the
    relative magnification split between R and B (0 = off). With a band,
    `img` holds its rows and so does the result."""
    if strength <= 0.0:
        return img
    scales = (1.0 + strength, 1.0, 1.0 - strength)
    src, row0 = img, 0
    if band is not None:
        taps = [_axis_taps(band.height, sc) for sc in scales if sc != 1.0]

        def need(s, e):
            return (min(int(t[0][s:e].min()) for t in taps),
                    max(int(t[1][s:e].max()) for t in taps) + 1)
        lo, hi = band.source_halo(band, need)
        src = band.halo([img], lo, hi)[0]
        row0 = band.ext_span(lo, hi)[0]
    return torch.stack([img[..., c] if s == 1.0
                        else _scale_about_center(src[..., c], s, band, row0)
                        for c, s in enumerate(scales)], dim=-1)


# ----------------------------------------------------------------------------
# Mip pyramid (MipmapGeneration.hlsl's 2x2 averager)


def generate_mips(img, levels: int):
    """[img, mip1, ..., mipN] with 2x2 averaging per level; img (H, W) or
    (H, W, C) with H and W divisible by 2^levels."""
    mips = [img]
    cur = img
    for _ in range(levels):
        h, w = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur.reshape((h, 2, w, 2) + cur.shape[2:]).mean(dim=(1, 3))
        mips.append(cur)
    return mips
