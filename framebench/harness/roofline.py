"""The yardstick of a kernel's roofline share: the card's published peaks
and the least bytes each measured kernel has to move, counted from the
shapes and contents of its inputs (each input byte read once, each output
byte written once; a lane with no work reads only what tells it so).
Nothing here asks the program how much work it did."""

from __future__ import annotations

import re

import torch

# Memory bandwidth, bytes a second, by the name torch.cuda.get_device_name
# gives: NVIDIA's data sheet for the H100 SXM part (at its 700 W limit).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def kernel_pattern(name: str):
    """Matches a profiler kernel name of the function `name`."""
    return re.compile(rf"(^|[^A-Za-z0-9_]){re.escape(name)}[(<]")


def closest_hit_bytes(rays, table, bounds, *_):
    """B1 (the Morton closest hit): rays (8, N) [o, d, tmin, tmax] float32,
    a (9, cols) sphere table and its (5, chunks) bounds; writes t and the
    object (8 bytes) per lane. A lane with tmax < tmin reads only tmin and
    tmax. Returns the bytes as a 0-d tensor on the rays' device."""
    n = rays.shape[1]
    live = (rays[7] >= rays[6]).sum()
    return (live * 32 + (n - live) * 8 + table.numel() * 4
            + bounds.numel() * 4 + n * 8)


def blas_sweep_bytes(rays, cand, best, binst, inst_tbl, tri_tbl,
                     tri_bounds, *_):
    """B6 (the shared BLAS sweep): rays (8, N), the candidate instance,
    the packed best and its instance (int32 each) per lane, the (9, M)
    instance table, the (F, 9) triangle table and its chunk bounds; writes
    the new best and instance (8 bytes) per lane. A lane is live where it
    has a candidate in [0, M) and min(tmax, best t) >= tmin; a dead lane
    reads tmin, tmax, its candidate and its best."""
    n, m = rays.shape[1], inst_tbl.shape[1]
    bits = max(1, (tri_tbl.shape[0] - 1).bit_length())
    best_t = (best & ~((1 << bits) - 1)).view(torch.float32)
    live = ((torch.minimum(rays[7], best_t) >= rays[6])
            & (cand >= 0) & (cand < m)).sum()
    return (live * 44 + (n - live) * 16 + inst_tbl.numel() * 4
            + tri_tbl.numel() * 4 + tri_bounds.numel() * 4 + n * 8)
