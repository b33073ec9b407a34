"""Diagnostic views (port of ``drts_tpu/ops/debugviz.py``): the
reference's runtime correctness probes as image transforms.

* ReGIR cells (DIFinalShading.hlsl:69-75 ``ReGIR_VISUALIZE_CELLS``):
  primary surfaces coloured by a hash of their ReGIR grid cell.
* SHARC voxels (Raytracing.hlsl:279-284 ``SHARC_DEBUG``): primary surfaces
  coloured by a hash of their cache slot.
* NRD validation (App.cpp:1522-1524): the denoiser's history length (green
  converged, red fresh) blended over the image.
"""

from __future__ import annotations

import torch

from ..utils import rng as rng_mod
from . import post, restir as restir_mod, sharc as sharc_mod

MODES = ("None", "ReGIRCells", "SHARC", "NRDValidation")


def _hash_color(h):
    """uint32 ids (int64 tensor) -> a stable pseudo-random rgb in [0.25,
    1]."""
    r = (rng_mod.hash_u32(h) & 255).to(torch.float32)
    g = (rng_mod.hash_u32(h ^ 0x55AA55AA) & 255).to(torch.float32)
    b = (rng_mod.hash_u32(h ^ 0x33CC33CC) & 255).to(torch.float32)
    return 0.25 + 0.75 * torch.stack([r, g, b], dim=-1) / 255.0


def regir_cells(grid, position, valid, cells_per_axis: int):
    """Primary-surface ReGIR cell id -> colour; outside the grid, dim."""
    cell, inside = restir_mod._cell_of(grid, position, cells_per_axis)
    color = torch.where(inside[..., None], _hash_color(cell), 0.05)
    return torch.where(valid[..., None], color, 0.0)


def sharc_voxels(position, normal, camera_position, valid, cfg):
    """Primary-surface SHARC cache slot -> colour (the voxel levels)."""
    slot, _ = sharc_mod.cache_key(position, normal, camera_position, cfg)
    return torch.where(valid[..., None], _hash_color(slot), 0.0)


def validation_overlay(image, history_length, max_frames: float = 30.0,
                       resize=None):
    """History-length heat (red young, green converged) blended 50% over
    the image; `resize` takes the render-size heat to the image's size
    (bilinear by default, where the sizes differ)."""
    t = torch.clamp(history_length / max_frames, 0.0, 1.0)
    heat = torch.stack([1.0 - t, t, torch.zeros_like(t)], dim=-1)
    if resize is not None:
        heat = resize(heat)
    elif heat.shape[:2] != image.shape[:2]:
        heat = post.resize_bilinear(heat, image.shape[0], image.shape[1])
    return 0.5 * image + 0.5 * heat
