"""Packed per-material texture sets (port of ``drts_tpu/models/texpack.py``).

Every map a material uses (ShadingHelpers.hlsli:161-235, Material.ixx:
12-38) is baked at load time into one texel row of u8 channels, and each
row carries its whole 2x2 bilinear footprint (quad order c00 c10 c01
c11), so a hit's material needs one row gather (ops/shading.py).

Texel word layout (u8 x 4 per 32-bit word, low byte first, words
interleaved per corner):
  word 0: base color R, G, B, A       (sqrt-coded color, linear alpha)
  word 1: normal X, normal Y, metallic, roughness
  word 2 (only when some material uses an emissive or transmission map):
          emissive R, G, B (sqrt-coded), transmission

After `build`, every used map slot of a material holds the material's SET
id (unused slots stay -1). The baker is the reference's numpy code; the
rows are int32 tensors with the reference's uint32 bits (torch's uint32
has no shifts on CUDA).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .material import Materials


@dataclasses.dataclass(frozen=True)
class PackedTextures:
    """Quad-duplicated packed texture sets on the device."""
    rows: torch.Tensor           # (T'*S*S, 4*W) int32 (uint32 bits)
    emissive_mean: torch.Tensor  # (T', 3) emissive-map mean per set (1 = none)
    size: int
    n_words: int
    # Half-size mip (the MipmapGeneration.hlsl role): deep-bounce
    # ("nearest") fetches read it, the area-filtered value their footprint
    # wants.
    rows_half: torch.Tensor | None = None    # (T'*(S/2)^2, 4*W) int32
    half_size: int = 0
    # 32^2 float emissive mips for light preparation's per-face filtered
    # emission (ops/light._face_emissive_avg); None without emissive maps.
    emissive_small: torch.Tensor | None = None  # (T', 32, 32, 3) float32


MAP_FIELDS = ("base_color_map", "normal_map", "metallic_map",
              "roughness_map", "emissive_color_map", "transmission_map")


def _u8(x):
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint32)


def _pack_word(c0, c1, c2, c3):
    return _u8(c0) | (_u8(c1) << 8) | (_u8(c2) << 16) | (_u8(c3) << 24)


def _resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """Area-average downsample (or nearest upsample) to (size, size, C)."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    if h % size == 0 and w % size == 0:
        fy, fx = h // size, w // size
        return img.reshape(size, fy, size, fx, -1).mean(axis=(1, 3))
    yi = (np.arange(size) * (h / size)).astype(np.int64)
    xi = (np.arange(size) * (w / size)).astype(np.int64)
    return img[yi][:, xi]


def _quad(img: np.ndarray) -> np.ndarray:
    """(S, S, C) -> (S, S, 4, C): each texel's 2x2 bilinear footprint, U
    wrapping and V clamping (the lat-long convention of ops/shading.py)."""
    xp = np.concatenate([img[:, 1:], img[:, :1]], axis=1)
    yc = np.concatenate([img[1:], img[-1:]], axis=0)
    ycxp = np.concatenate([yc[:, 1:], yc[:, :1]], axis=1)
    return np.stack([img, xp, yc, ycxp], axis=2)


def build(atlas: np.ndarray | None, materials: Materials, size: int = 256
          ) -> tuple[PackedTextures | None, Materials]:
    """Bake per-material texture sets from the (T, S0, S0, 4) float atlas
    onto the materials' device. Returns (packed, materials') where
    materials' has every used map slot rewritten to the material's set id;
    (None, materials) when atlas is None or no material maps anything."""
    if atlas is None:
        return None, materials
    atlas = np.asarray(atlas, np.float32)
    t = atlas.shape[0]
    dev = materials.base_color.device
    cols = {f: getattr(materials, f).cpu().numpy() for f in MAP_FIELDS}
    k = cols["base_color_map"].shape[0]

    # Unique map combinations -> set ids.
    combos: dict[tuple, int] = {}
    set_of = np.full((k,), -1, np.int64)
    for i in range(k):
        combo = tuple(int(cols[f][i]) for f in MAP_FIELDS)
        if all(c < 0 for c in combo):
            continue
        if combo not in combos:
            combos[combo] = len(combos)
        set_of[i] = combos[combo]
    if not combos:
        return None, materials

    needs_w2 = any(c[4] >= 0 or c[5] >= 0 for c in combos)
    n_words = 3 if needs_w2 else 2

    def bake_rows(sz):
        """(T'*sz*sz, 4W) int32 rows with the reference's uint32 bits."""
        def slot(idx, neutral):
            if idx < 0 or idx >= t:
                return np.broadcast_to(np.asarray(neutral, np.float32),
                                       (sz, sz, len(neutral))).copy()
            return _resize_area(atlas[idx], sz)

        rows_all = []
        for combo in combos:
            bcm, nm, mm, rm, em, tm = combo
            base = slot(bcm, (1.0, 1.0, 1.0, 1.0))
            normal = slot(nm, (0.5, 0.5, 1.0, 1.0))
            metallic = slot(mm, (1.0,))[..., 0]
            rough = slot(rm, (1.0,))[..., 0]
            w0 = _pack_word(np.sqrt(np.clip(base[..., 0], 0, 1)),
                            np.sqrt(np.clip(base[..., 1], 0, 1)),
                            np.sqrt(np.clip(base[..., 2], 0, 1)),
                            base[..., 3])
            w1 = _pack_word(normal[..., 0], normal[..., 1], metallic, rough)
            words = [w0, w1]
            if needs_w2:
                emis = slot(em, (1.0, 1.0, 1.0, 1.0))
                trans = slot(tm, (1.0,))[..., 0]
                words.append(
                    _pack_word(np.sqrt(np.clip(emis[..., 0], 0, 1)),
                               np.sqrt(np.clip(emis[..., 1], 0, 1)),
                               np.sqrt(np.clip(emis[..., 2], 0, 1)),
                               trans))
            texel = np.stack(words, axis=-1)             # (S, S, W)
            quad = _quad(texel)                          # (S, S, 4, W)
            rows_all.append(quad.reshape(sz * sz, 4 * n_words))
        rows = np.ascontiguousarray(np.concatenate(rows_all, axis=0))
        return torch.from_numpy(rows.view(np.int32)).to(dev)

    emissive_mean = np.stack([atlas[c[4]][..., :3].mean(axis=(0, 1))
                              if c[4] >= 0 else np.ones(3, np.float32)
                              for c in combos])
    emissive_small = None
    if any(c[4] >= 0 for c in combos):
        emissive_small = torch.from_numpy(np.stack(
            [_resize_area(atlas[c[4]][..., :3], 32) if c[4] >= 0
             else np.ones((32, 32, 3), np.float32) for c in combos]
        ).astype(np.float32)).to(dev)

    half = size // 2 if size >= 8 else 0
    packed = PackedTextures(
        rows=bake_rows(size),
        emissive_mean=torch.from_numpy(emissive_mean.astype(np.float32)
                                       ).to(dev),
        size=size, n_words=n_words,
        rows_half=bake_rows(half) if half else None, half_size=half,
        emissive_small=emissive_small)
    new_cols = {f: torch.from_numpy(np.where(cols[f] >= 0, set_of, -1)
                                    .astype(np.int32)).to(dev)
                for f in MAP_FIELDS}
    return packed, dataclasses.replace(materials, **new_cols)
