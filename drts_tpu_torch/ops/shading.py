"""Material evaluation at hit points: texture application and normal
mapping (port of ``drts_tpu/ops/shading.py``, EvaluateMaterial and
friends, ShadingHelpers.hlsli:61-235).

The reference's six independent per-material maps are one packed,
quad-duplicated texture-set row per hit (models/texpack.py). Its bytes
are decoded all at once: the gathered int32 words viewed as u8, scaled by
1/255 in one op, the sqrt-coded channels squared through a constant mask,
and the four corners blended in the reference's order. A map index of -1
means "slot unused" and multiplies by 1. Every texel index is clamped the
way the reference's arithmetic clamps it (U wraps with a floored modulo,
V clamps, the set id is at least 0), and a uv that is not finite reads as
0, so no gather leaves its table.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.material import Materials
from ..models.texpack import PackedTextures
from ..utils import math as m

def sample_atlas(atlas, tex_index, uv, filter: str = "bilinear"):
    """Sample a raw float atlas (T, S, S, C); 1 where tex_index < 0 (U
    wraps, V clamps: the lat-long convention). The texel-exact reference
    of the packed path's tests."""
    t, s, c = atlas.shape[0], atlas.shape[1], atlas.shape[-1]
    flat = atlas.reshape(-1, c)
    base = torch.clamp(tex_index, 0, t - 1).to(torch.int32) * (s * s)
    uv = torch.nan_to_num(uv, nan=0.0, posinf=0.0, neginf=0.0)
    lead = uv.shape[:-1]

    def fetch(i):
        return torch.index_select(flat, 0, i.reshape(-1)).reshape(
            lead + (c,))
    if filter == "nearest":
        xi = torch.remainder((uv[..., 0] * s).to(torch.int32), s)
        yi = torch.clamp((uv[..., 1] * s).to(torch.int32), 0, s - 1)
        value = fetch(base + yi * s + xi)
    else:
        x = uv[..., 0] * s - 0.5
        y = uv[..., 1] * s - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = torch.clamp(y - torch.clamp(y0, 0, s - 1), 0.0, 1.0)[..., None]
        x0i = torch.remainder(x0.to(torch.int32), s)
        x1i = torch.remainder(x0i + 1, s)
        y0i = torch.clamp(y0.to(torch.int32), 0, s - 1)
        y1i = torch.clamp(y0i + 1, 0, s - 1)
        c00 = fetch(base + y0i * s + x0i)
        c10 = fetch(base + y0i * s + x1i)
        c01 = fetch(base + y1i * s + x0i)
        c11 = fetch(base + y1i * s + x1i)
        value = m.lerp(m.lerp(c00, c10, fx), m.lerp(c01, c11, fx), fy)
    return torch.where((tex_index >= 0)[..., None], value, 1.0)


@dataclasses.dataclass(frozen=True)
class SampledSet:
    """Decoded texture-set sample (1, or a flat normal, where unused)."""
    base_rgb: torch.Tensor      # (..., 3) sqrt-decoded
    alpha: torch.Tensor         # (...,)
    normal_xy: torch.Tensor     # (..., 2) in [-1, 1]
    metallic: torch.Tensor      # (...,)
    roughness: torch.Tensor     # (...,)
    emissive_rgb: torch.Tensor  # (..., 3)
    transmission: torch.Tensor  # (...,)


@functools.lru_cache(maxsize=16)
def _channel_consts(n_words: int, device):
    """(sqrt-coded mask, neutral value), each (W, 4): the colour channels
    of words 0 and 2 are sqrt-coded; every channel's neutral value is 1
    but the normal's x and y, 0.5."""
    sq = torch.zeros((n_words, 4), dtype=torch.bool, device=device)
    sq[0, :3] = True
    if n_words >= 3:
        sq[2, :3] = True
    neutral = torch.ones((n_words, 4), dtype=torch.float32, device=device)
    neutral[1, :2] = 0.5
    return sq, neutral


def sample_packed(tex: PackedTextures, set_index, uv,
                  filter: str = "bilinear") -> SampledSet:
    """One row gather -> the whole material texture sample (exact bilinear
    through the quad-duplicated footprint). Lanes with set_index < 0
    decode to neutral. "nearest" reads the half-size mip where there is
    one (deep-bounce fetches, whose footprint wants the area-filtered
    value); "nearest0" pins level 0 (the alpha test: cutout silhouettes
    must not blur)."""
    w_n = tex.n_words
    lead = set_index.shape
    uv = torch.nan_to_num(uv, nan=0.0, posinf=0.0, neginf=0.0)
    n_sets = tex.rows.shape[0] // (tex.size * tex.size)
    idx = torch.clamp(set_index, 0, n_sets - 1).to(torch.int32)
    sq, neutral = _channel_consts(w_n, uv.device)

    def gather(table, rows_idx, corners):
        """(..., corners, W, 4) decoded channels of the gathered rows."""
        row = torch.index_select(table, 0, rows_idx.reshape(-1))
        byte = row[:, :corners * w_n].contiguous().view(torch.uint8)
        ch = byte.to(torch.float32).reshape(
            lead + (corners, w_n, 4)) * (1.0 / 255.0)
        # sqrt-coded colour is decoded per tap, before the blend.
        return torch.where(sq, ch * ch, ch)

    if filter in ("nearest", "nearest0"):
        use_half = filter == "nearest" and tex.rows_half is not None
        table = tex.rows_half if use_half else tex.rows
        s = tex.half_size if use_half else tex.size
        xi = torch.remainder((uv[..., 0] * s).to(torch.int32), s)
        yi = torch.clamp((uv[..., 1] * s).to(torch.int32), 0, s - 1)
        words = gather(table, idx * (s * s) + yi * s + xi, 1)[..., 0, :, :]
    else:
        s = tex.size
        x = uv[..., 0] * s - 0.5
        y = uv[..., 1] * s - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        y0c = torch.clamp(y0, 0, s - 1)
        fy = torch.clamp(y - y0c, 0.0, 1.0)
        xi = torch.remainder(x0.to(torch.int32), s)
        yi = y0c.to(torch.int32)
        c = gather(tex.rows, idx * (s * s) + yi * s + xi, 4)
        gx, gy = 1 - fx, 1 - fy
        w = [(gx * gy)[..., None, None], (fx * gy)[..., None, None],
             (gx * fy)[..., None, None], (fx * fy)[..., None, None]]
        # The reference's order, corner by corner: c00 c10 c01 c11.
        words = (c[..., 0, :, :] * w[0] + c[..., 1, :, :] * w[1]
                 + c[..., 2, :, :] * w[2] + c[..., 3, :, :] * w[3])

    words = torch.where((set_index >= 0)[..., None, None], words, neutral)
    if w_n >= 3:
        emissive, trans = words[..., 2, :3], words[..., 2, 3]
    else:
        emissive = torch.ones(lead + (3,), dtype=torch.float32,
                              device=uv.device)
        trans = torch.ones(lead, dtype=torch.float32, device=uv.device)
    return SampledSet(base_rgb=words[..., 0, :3], alpha=words[..., 0, 3],
                      normal_xy=words[..., 1, :2] * 2.0 - 1.0,
                      metallic=words[..., 1, 2], roughness=words[..., 1, 3],
                      emissive_rgb=emissive, transmission=trans)


@dataclasses.dataclass(frozen=True)
class EvaluatedMaterial:
    """Post-texture material parameters at a hit."""
    base_color: torch.Tensor      # (..., 3)
    alpha: torch.Tensor           # (...,)
    emission: torch.Tensor        # (..., 3)
    metallic: torch.Tensor        # (...,)
    roughness: torch.Tensor       # (...,)
    ior: torch.Tensor             # (...,)
    transmission: torch.Tensor    # (...,)
    shading_normal: torch.Tensor  # (..., 3) possibly normal-mapped


def evaluate_material(mat: Materials, uv, shading_normal, tangent,
                      textures: PackedTextures | None = None,
                      filter: str = "bilinear") -> EvaluatedMaterial:
    """ShadingHelpers.hlsli:161-235 EvaluateMaterial, vectorized.

    `mat` holds per-ray gathered parameters; its map columns carry the
    material's texture-set id, so the whole texture evaluation is one
    packed-row gather. With `textures` None every slot counts as unused."""
    base_color = mat.base_color[..., :3]
    alpha = mat.base_color[..., 3]
    emission = mat.emission()
    metallic = mat.metallic
    roughness = mat.roughness
    transmission = mat.transmission
    n = shading_normal

    if textures is not None:
        # Any used slot holds the set id, unused slots -1; the channels a
        # material does not map are baked neutral in its set.
        set_idx = torch.maximum(
            torch.maximum(torch.maximum(mat.base_color_map, mat.normal_map),
                          torch.maximum(mat.metallic_map,
                                        mat.roughness_map)),
            torch.maximum(mat.emissive_color_map, mat.transmission_map))
        ts = sample_packed(textures, set_idx, uv, filter)
        base_color = base_color * ts.base_rgb
        alpha = alpha * ts.alpha
        emission = emission * ts.emissive_rgb
        metallic = metallic * ts.metallic
        roughness = roughness * ts.roughness
        transmission = transmission * ts.transmission
        # Normal perturbation (ShadingHelpers.hlsli:89-103): a 2-channel
        # tangent-space normal, z reconstructed.
        nx, ny = ts.normal_xy[..., 0], ts.normal_xy[..., 1]
        nz = torch.sqrt(torch.clamp(1.0 - nx * nx - ny * ny, min=0.0))
        t, b, nn = m.calculate_tbn(n, tangent)
        perturbed = m.normalize(nx[..., None] * t + ny[..., None] * b
                                + nz[..., None] * nn)
        n = torch.where((mat.normal_map >= 0)[..., None], perturbed, n)

    return EvaluatedMaterial(
        base_color=base_color, alpha=alpha, emission=emission,
        metallic=metallic, roughness=roughness, ior=mat.ior,
        transmission=torch.where(metallic < 1.0, transmission, 0.0),
        shading_normal=n)
