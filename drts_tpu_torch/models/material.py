"""PBR material parameters, structure-of-arrays (port of
``drts_tpu/models/material.py``): one tensor per field over all objects."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description (Material.ixx defaults)."""
    base_color: tuple = (0.0, 0.0, 0.0, 1.0)
    emissive_strength: float = 1.0
    emissive_color: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 0.5
    ior: float = 1.5
    transmission: float = 0.0
    alpha_cutoff: float = 0.5
    # texture-map slots (TextureMapType); -1 = none
    base_color_map: int = -1
    emissive_color_map: int = -1
    metallic_map: int = -1
    roughness_map: int = -1
    normal_map: int = -1
    transmission_map: int = -1


@dataclasses.dataclass(frozen=True)
class Materials:
    """Device-side SoA over K objects."""
    base_color: torch.Tensor         # (K, 4)
    emissive_strength: torch.Tensor  # (K,)
    emissive_color: torch.Tensor     # (K, 3)
    metallic: torch.Tensor           # (K,)
    roughness: torch.Tensor          # (K,)
    ior: torch.Tensor                # (K,)
    transmission: torch.Tensor       # (K,)
    alpha_cutoff: torch.Tensor       # (K,)
    base_color_map: torch.Tensor     # (K,) int32
    emissive_color_map: torch.Tensor  # (K,) int32
    metallic_map: torch.Tensor       # (K,) int32
    roughness_map: torch.Tensor      # (K,) int32
    normal_map: torch.Tensor         # (K,) int32
    transmission_map: torch.Tensor   # (K,) int32

    def emission(self):
        """Material::GetEmission = strength * color."""
        return self.emissive_strength[..., None] * self.emissive_color

    def gather(self, idx):
        """Per-ray material fetch by object index."""
        return Materials(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(Materials)})


INT_FIELDS = ("base_color_map", "emissive_color_map", "metallic_map",
              "roughness_map", "normal_map", "transmission_map")


def pack_materials(descs: list[MaterialDesc], device="cuda") -> Materials:
    device = backend.device(device)

    def arr(name):
        dtype = np.int32 if name in INT_FIELDS else np.float32
        values = np.array([getattr(d, name) for d in descs], dtype=dtype)
        return torch.from_numpy(values).to(device)
    return Materials(**{f.name: arr(f.name)
                        for f in dataclasses.fields(Materials)})
