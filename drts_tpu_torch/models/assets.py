"""Texture asset loading (port of ``drts_tpu/models/assets.py``): the
reference's texture files decoded host-side (PIL, where it is installed),
resized to one atlas size, sRGB-decoded where they hold colour, and
stacked into one (T, S, S, 4) float32 atlas, with a per-file fallback
(TextureHelpers.ixx:34-138, ResourceHelpers.ixx:36-114).

The files are looked up under ``Assets/Textures`` at the root of the
checkout, the reference's own layout. Where they are absent, or PIL is not
installed, every slot falls back to the material constants, as the
reference does with missing assets.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import image as image_mod

# Reference asset set (MyScene.ixx:161-165, 286-294).
TEXTURE_FILES = [
    ("Alien-Metal_Albedo.png", True),      # 0: sRGB base color
    ("Alien-Metal_Metallic.png", False),   # 1
    ("Alien-Metal_Roughness.png", False),  # 2
    ("Alien-Metal_Normal.png", False),     # 3
    ("Moon_BaseColor.jpg", True),          # 4
    ("Moon_Normal.jpg", False),            # 5
    ("Earth_BaseColor.jpg", True),         # 6
    ("Earth_Normal.jpg", False),           # 7
]

ALIEN_BASE, ALIEN_METALLIC, ALIEN_ROUGH, ALIEN_NORMAL = 0, 1, 2, 3
MOON_BASE, MOON_NORMAL, EARTH_BASE, EARTH_NORMAL = 4, 5, 6, 7

DEFAULT_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "Assets", "Textures")


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def load_texture_atlas(asset_dir: str | None = None, size: int = 512):
    """The (T, S, S, 4) atlas with a per-file fallback; `asset_dir`
    defaults to DEFAULT_ASSET_DIR (read at call time).

    Returns ``(atlas, present)``: ``present[i]`` says whether slot i
    loaded. A missing or undecodable file fills its slot with neutral
    white and its materials reference it as -1 (the constant), so one
    missing map degrades that map only (MyScene.ixx:161-165). Returns
    ``(None, [False] * T)`` when nothing loads."""
    if asset_dir is None:
        asset_dir = DEFAULT_ASSET_DIR
    textures, present = [], []
    neutral = np.ones((size, size, 4), np.float32)
    for name, is_srgb in TEXTURE_FILES:
        path = os.path.join(asset_dir, name)
        img = (image_mod.load_image(path, size=size)
               if os.path.exists(path) else None)
        if img is None:
            textures.append(neutral)
            present.append(False)
            continue
        if is_srgb:
            img = np.concatenate([_srgb_to_linear(img[..., :3]),
                                  img[..., 3:4]], axis=-1)
        textures.append(img)
        present.append(True)
    if not any(present):
        return None, present
    return np.stack(textures).astype(np.float32), present
