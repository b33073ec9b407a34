"""Morton sphere accel (port of the Morton half of
``drts_tpu/models/clusters.py``): a host-side static plan that sorts small
spheres along a Morton curve and chunks them, and a per-frame refit that
packs the Morton-ordered sphere table the closest-hit and any-hit kernels
sweep, with the chunk bounds the any-hit kernel culls by.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend

MAX_MEMBERS = 32


@dataclasses.dataclass(frozen=True)
class MortonAccel:
    """Per-frame tables of the Morton kernels: the planar Morton-ordered
    sphere table ``[cx cy cz r obj -2cx -2cy -2cz |c|^2-r^2]`` and, in the
    same chunk order, one bounding sphere per chunk of ``chunk`` slots
    ``[cx cy cz r count]``. Rows 0-3 of ``bounds`` are the reference's
    ``bounds_tbl`` (``refit``: centroid, covering radius plus the motion
    slack); row 4 is the chunk's filled-slot count (its filled slots come
    first). The any-hit kernel (B2) culls chunks with them."""
    table: torch.Tensor       # (9, C*M)
    bounds: torch.Tensor      # (5, C)
    n_chunks: int
    chunk: int


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Static clustering, built once on the host and kept on the device
    (membership never changes; bounds refit per frame)."""
    member_object: torch.Tensor  # (C, M) int64, -1 = empty slot
    num_clusters: int


@dataclasses.dataclass(frozen=True)
class ClusterBounds:
    """Per-frame refit product."""
    center: torch.Tensor   # (C, 3)
    radius: torch.Tensor   # (C,)


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton code from (N, 3) positions normalized to [0, 1024)."""
    def spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return (spread(x[:, 0]) | (spread(x[:, 1]) << 1)
            | (spread(x[:, 2]) << 2))


def build_plan_morton(positions: np.ndarray, radii: np.ndarray,
                      big_radius: float = 2.0,
                      max_members: int = MAX_MEMBERS,
                      device="cuda") -> ClusterPlan:
    """Sort small spheres along a Morton curve and chunk consecutive runs
    of `max_members`; oversized spheres become singletons so they do not
    inflate chunk bounds. The plan lives on ``device``, by default the
    card."""
    device = backend.device(device)
    big = np.nonzero(radii > big_radius)[0]
    small = np.nonzero(radii <= big_radius)[0]
    pos = positions[small]
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-6)
    quant = np.clip((pos - lo) / span * 1023.0, 0, 1023).astype(np.uint64)
    order = small[np.argsort(_morton3(quant), kind="stable")]

    clusters = [order[s:s + max_members]
                for s in range(0, len(order), max_members)]
    clusters += [[i] for i in big]
    c = len(clusters)
    table = np.full((c, max_members), -1, np.int32)
    for ci, members in enumerate(clusters):
        table[ci, :len(members)] = members
    return ClusterPlan(member_object=torch.from_numpy(table).long().to(device),
                       num_clusters=c)


def refit(plan: ClusterPlan, centers, radii, slack: float = 0.25
          ) -> ClusterBounds:
    """Per-frame bound update: centroid + covering radius with a motion
    slack margin."""
    member = plan.member_object
    valid = member >= 0
    safe = torch.clamp(member, min=0)
    pos = centers[safe]                               # (C, M, 3)
    rad = torch.where(valid, radii[safe], 0.0)        # (C, M)
    count = torch.clamp(valid.sum(dim=1), min=1)
    centroid = torch.where(valid[..., None], pos, 0.0).sum(dim=1) \
        / count[:, None]
    dist = torch.sqrt(((pos - centroid[:, None, :]) ** 2).sum(dim=-1))
    cover = torch.where(valid, dist + rad, 0.0).amax(dim=1)
    return ClusterBounds(center=centroid, radius=cover + slack)


def make_morton_accel(plan: ClusterPlan, centers, radii,
                      sort_origin=None) -> MortonAccel:
    """Per-frame tables for the Morton kernels: refit chunk bounds and
    pack the planar Morton-ordered sphere table with an object-index row.
    `sort_origin` (usually the camera position) orders chunks near-to-far
    from that point; the order does not change the closest hit (a min over
    chunks; object ids ride the table rows) or the any hit."""
    member = plan.member_object
    bounds = refit(plan, centers, radii)
    center, radius = bounds.center, bounds.radius
    if sort_origin is not None:
        key = torch.sqrt(((center - sort_origin) ** 2).sum(dim=-1)) - radius
        order = torch.argsort(key, stable=True)
        member, center, radius = member[order], center[order], radius[order]
    c, mm = member.shape
    valid = member >= 0
    safe = torch.clamp(member, min=0)
    mpos = centers[safe]
    mrad = torch.where(valid, radii[safe], 0.0)
    flat = c * mm
    cx = mpos[..., 0].reshape(flat)
    cy = mpos[..., 1].reshape(flat)
    cz = mpos[..., 2].reshape(flat)
    r = mrad.reshape(flat)
    # Rows 5-8 hold the quadratic's sphere-side constants (-2c and
    # |c|^2 - r^2); empty slots (r = 0) carry +1e30, which forces a
    # negative discriminant, so the kernel needs no radius test.
    ccrr = torch.where(r > 0.0, cx * cx + cy * cy + cz * cz - r * r, 1e30)
    obj = torch.where(valid, member, 0).reshape(flat).float()
    table = torch.stack([cx, cy, cz, r, obj,
                         -2.0 * cx, -2.0 * cy, -2.0 * cz, ccrr])
    count = valid.sum(dim=1).to(torch.float32)
    bounds_tbl = torch.cat([center.T, radius[None], count[None]])
    return MortonAccel(table=table.contiguous(),
                       bounds=bounds_tbl.contiguous(), n_chunks=c, chunk=mm)
