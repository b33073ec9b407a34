"""Sphere accels (port of ``drts_tpu/models/clusters.py``).

The Morton accel: a host-side static plan that sorts small spheres along
a Morton curve and chunks them, and a per-frame refit that packs the
Morton-ordered sphere table the closest-hit and any-hit kernels sweep,
with the chunk bounds they cull by; under the MXU opt-in (``_USE_MXU``)
also the chunk A-matrices of the tensor-core kernels
(``make_mxu_tables``), which send the accel's closest and any hits
through those kernels.

The clustered accel: a static xz binning of the spheres (``build_plan``)
and per frame the cluster bounds and member table of the cluster-culled
kernel (``make_accel``: ``refit`` + ``pack_for_kernel``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import backend

MAX_MEMBERS = 32

# The reference's opt-in to its MXU kernels (drts_tpu/ops/intersect.py:39),
# read at import as it reads it: make_morton_accel then builds the chunk
# A-matrices (MortonAccel.mxu_a), and ops.intersect sends an accel that
# carries them to the tensor-core kernels B12a and B12b. Off by default.
_USE_MXU = os.environ.get("DRTS_MXU_KERNEL", "") == "1"


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
    mxu_a: torch.Tensor | None = None   # (C*2M, 8) chunk A-matrices


@dataclasses.dataclass(frozen=True)
class ClusteredAccel:
    """Tables of the cluster-culled kernel: per cluster its bounding
    sphere, ``bounds_tbl`` (4, C_pad) [cx cy cz r], and its ``max_members``
    member slots, ``members_tbl`` (C_pad*M, 8) [cx cy cz r obj 0 0 0]
    (r = 0 for an empty slot). ``n_clusters`` is the unpadded count;
    C_pad rounds it up to a multiple of 8."""
    bounds_tbl: torch.Tensor
    members_tbl: torch.Tensor
    n_clusters: int
    max_members: int


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


def build_plan(positions: np.ndarray, radii: np.ndarray,
               cell_size: float = 4.0, device="cuda") -> ClusterPlan:
    """Greedy binning on the xz plane at rest pose: spheres larger than
    half a cell become singleton clusters, the rest bin by
    floor(xz / cell_size) in order of first appearance, and a bin of more
    than MAX_MEMBERS splits into consecutive runs of MAX_MEMBERS. The
    plan lives on ``device``, by default the card."""
    device = backend.device(device)
    big = radii > cell_size * 0.5
    bins: dict = {}
    for i in range(positions.shape[0]):
        if big[i]:
            bins[("big", i)] = [i]
            continue
        key = (int(np.floor(positions[i, 0] / cell_size)),
               int(np.floor(positions[i, 2] / cell_size)))
        bins.setdefault(key, []).append(i)
    clusters = [members[s:s + MAX_MEMBERS] for members in bins.values()
                for s in range(0, len(members), MAX_MEMBERS)]
    return _plan(clusters, MAX_MEMBERS, device)


def _plan(clusters, max_members, device) -> ClusterPlan:
    table = np.full((len(clusters), max_members), -1, np.int32)
    for ci, members in enumerate(clusters):
        table[ci, :len(members)] = members
    return ClusterPlan(member_object=torch.from_numpy(table).long().to(device),
                       num_clusters=len(clusters))


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
    return _plan(clusters, max_members, device)


def refit(plan: ClusterPlan, centers, radii, slack: float = 0.25
          ) -> ClusterBounds:
    """Per-frame bound update: centroid + covering radius with a motion
    slack margin."""
    valid, pos, rad = _members(plan.member_object, centers, radii)
    count = torch.clamp(valid.sum(dim=1), min=1)
    centroid = torch.where(valid[..., None], pos, 0.0).sum(dim=1) \
        / count[:, None]
    dist = torch.sqrt(((pos - centroid[:, None, :]) ** 2).sum(dim=-1))
    cover = torch.where(valid, dist + rad, 0.0).amax(dim=1)
    return ClusterBounds(center=centroid, radius=cover + slack)


def _members(member, centers, radii):
    """Per slot of `member` (C, M): (valid, centre (C, M, 3), radius with
    0 in empty slots)."""
    valid = member >= 0
    safe = torch.clamp(member, min=0)
    return valid, centers[safe], torch.where(valid, radii[safe], 0.0)


def _pad_to(x, total):
    """Zero-pad a 1-D tensor to `total` entries."""
    return torch.nn.functional.pad(x, (0, total - x.shape[0]))


def pack_for_kernel(plan: ClusterPlan, bounds: ClusterBounds, centers,
                    radii):
    """The cluster-culled kernel's tables: bounds (4, C_pad) [cx cy cz r]
    and members (C_pad*M, 8) [cx cy cz r obj 0 0 0], C_pad the cluster
    count rounded up to a multiple of 8; padded clusters are zero, and an
    empty slot has radius 0 and object 0 (never hit)."""
    member = plan.member_object
    valid, mpos, mrad = _members(member, centers, radii)
    c, mm = member.shape
    c_pad = -(-c // 8) * 8
    cols = torch.stack([mpos[..., 0].reshape(c * mm),
                        mpos[..., 1].reshape(c * mm),
                        mpos[..., 2].reshape(c * mm),
                        mrad.reshape(c * mm),
                        torch.where(valid, member, 0).reshape(c * mm)
                        .to(torch.float32)], dim=-1)
    members = torch.zeros((c_pad * mm, 8), dtype=torch.float32,
                          device=member.device)
    members[:c * mm, :5] = cols
    bounds_tbl = torch.stack([_pad_to(bounds.center[:, 0], c_pad),
                              _pad_to(bounds.center[:, 1], c_pad),
                              _pad_to(bounds.center[:, 2], c_pad),
                              _pad_to(bounds.radius, c_pad)])
    return bounds_tbl.contiguous(), members


def make_accel(plan: ClusterPlan, centers, radii) -> ClusteredAccel:
    """Per-frame tables of the cluster-culled kernel: refit + pack."""
    bounds_tbl, members_tbl = pack_for_kernel(
        plan, refit(plan, centers, radii), centers, radii)
    return ClusteredAccel(bounds_tbl=bounds_tbl, members_tbl=members_tbl,
                          n_clusters=plan.num_clusters,
                          max_members=plan.member_object.shape[1])


def make_mxu_tables(table, n_chunks: int, chunk: int):
    """Chunk A-matrices of the tensor-core kernels (B12a/B12b), from the
    Morton table's rows 0-3 in its chunk order: per chunk a (2*chunk, 8)
    block, so that A @ [dx dy dz ox oy oz od 1] gives the quadratic's b
    (rows [0, chunk)) and c0 - |o|^2 (rows [chunk, 2*chunk)):

        b rows:  [-cx -cy -cz  0    0    0   1  0]
        c rows:  [ 0   0   0  -2cx -2cy -2cz 0  |c|^2-r^2]

    Empty slots (r = 0) get |c|^2 - r^2 = 1e30, which forces a negative
    discriminant."""
    cx, cy, cz, r = table[0], table[1], table[2], table[3]
    ccrr = torch.where(r > 0.0, cx * cx + cy * cy + cz * cz - r * r, 1e30)
    zeros = torch.zeros_like(cx)
    ones = torch.ones_like(cx)
    top = torch.stack([-cx, -cy, -cz, zeros, zeros, zeros, ones, zeros],
                      dim=-1)
    bot = torch.stack([zeros, zeros, zeros, -2.0 * cx, -2.0 * cy,
                       -2.0 * cz, zeros, ccrr], dim=-1)
    a = torch.cat([top.reshape(n_chunks, chunk, 8),
                   bot.reshape(n_chunks, chunk, 8)], dim=1)
    return a.reshape(n_chunks * 2 * chunk, 8).contiguous()


def make_morton_accel(plan: ClusterPlan, centers, radii,
                      sort_origin=None) -> MortonAccel:
    """Per-frame tables for the Morton kernels: refit chunk bounds and
    pack the planar Morton-ordered sphere table with an object-index row.
    `sort_origin` (usually the camera position) orders chunks near-to-far
    from that point; the order does not change the closest hit (a min over
    chunks; object ids ride the table rows) or the any hit. Under the MXU
    opt-in (``_USE_MXU``) the accel also carries the tensor-core kernels'
    A-matrices (``make_mxu_tables``)."""
    member = plan.member_object
    bounds = refit(plan, centers, radii)
    center, radius = bounds.center, bounds.radius
    if sort_origin is not None:
        key = torch.sqrt(((center - sort_origin) ** 2).sum(dim=-1)) - radius
        order = torch.argsort(key, stable=True)
        member, center, radius = member[order], center[order], radius[order]
    c, mm = member.shape
    valid, mpos, mrad = _members(member, centers, radii)
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
                       bounds=bounds_tbl.contiguous(), n_chunks=c, chunk=mm,
                       mxu_a=(make_mxu_tables(table, c, mm)
                              if _USE_MXU else None))
