"""Row bands, the frame-state placement rule and the collectives of the
banded frame (port of ``drts_tpu/parallel/mesh.py``).

The reference builds a 1-D ``jax.sharding.Mesh`` and annotates shardings;
here a ``torch.distributed`` group stands for the mesh and the exchanges
are explicit (see the package docstring). ``frame_state_placement`` is the
reference's ``frame_state_sharding`` rule, path by path: which buffers are
per-row, per-slot or replicated. ``gather_tree`` moves every band-row
tensor of a tree to the full frame in one padded all-gather per dtype;
``all_reduce_counters`` sums the frame's counters over the ranks.

Every collective runs on the tensors' own device: NCCL on the card (one
card per rank), gloo on the CPU, and gloo on CUDA tensors too, where
several ranks share one card (PyTorch 2.11's gloo runs all_reduce and
all_gather on CUDA tensors: ``chip_smoke.py`` phase 22 (b) runs the
frame's exchanges so).
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch
import torch.distributed as dist

from ..utils.checkpoint import leaves

ROWS, SLOTS, REPLICATED = "rows", "slots", "replicated"


def make_group(n: int | None = None):
    """The group of the first `n` ranks of the default group (all of them
    by default). Every rank of the default group must call it; a rank
    outside the new group gets ``dist.GroupMember.NON_GROUP_MEMBER``."""
    world = dist.get_world_size()
    if n is None or n == world:
        return dist.group.WORLD
    if not 1 <= n <= world:
        raise ValueError(f"a group of {n} ranks from a world of {world}")
    return dist.new_group(list(range(n)))


def is_member(group) -> bool:
    return group is not None and group != dist.GroupMember.NON_GROUP_MEMBER


def group_rank(group) -> tuple[int, int]:
    """(this rank's position in `group`, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def row_band(height: int, rank: int, n: int) -> tuple[int, int]:
    """[start, end) image rows of rank `rank` of `n`: bands of H // n or
    H // n + 1 rows, in rank order, covering every row."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} of {n}")
    return rank * height // n, (rank + 1) * height // n


def group_band(height: int, group) -> tuple[int, int]:
    """This rank's band of `height` rows in `group`."""
    r, n = group_rank(group)
    return row_band(height, r, n)


def map_tensors(fn, obj):
    """`obj` rebuilt with fn(tensor) in place of each tensor leaf."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


def frame_state_placement(state, image_heights: tuple[int, ...],
                          slot_table_sizes: tuple[int, ...] = (),
                          n: int = 1) -> dict:
    """{dotted path: "rows" | "slots" | "replicated"} for every leaf of a
    FrameState, by the reference's ``frame_state_sharding`` rule on a mesh
    of `n` devices: a leaf of two or more axes whose first is an image
    height divisible by n is per-row; a leaf whose first axis is a slot
    table size divisible by n is per-slot; everything else (scene, physics,
    scalars, host numbers) is replicated. The banded frame gathers the
    per-row buffers and keeps the SHARC slots whole, so on every rank
    every leaf ends the frame replicated (``replica_checksums``) and the
    frame never reads this placement: only the tests call it, to hold the
    rule to the reference's."""
    def rule(leaf):
        if not isinstance(leaf, torch.Tensor):
            return REPLICATED
        if (leaf.ndim >= 2 and leaf.shape[0] in image_heights
                and leaf.shape[0] % n == 0):
            return ROWS
        if (leaf.ndim >= 1 and leaf.shape[0] in slot_table_sizes
                and leaf.shape[0] % n == 0):
            return SLOTS
        return REPLICATED
    return {path: rule(leaf) for path, leaf in leaves(state)}


def _wire_dtype(dtype):
    return torch.uint8 if dtype == torch.bool else dtype


def gather_tree(tree, group, height: int):
    """`tree` (a dataclass, dict, list or tuple of tensors) with every
    tensor leaf of this rank's band (first axis the band's rows of
    `height`) replaced by the full frame's (height, ...) tensor, the same
    on every rank. The leaves are packed into one (band rows, C) buffer
    per dtype (bool travels as uint8), padded to the largest band, and
    gathered in one all-gather each, in the tree's order, which is the
    same on every rank. Other leaves (None, host numbers) pass through."""
    r, n = group_rank(group)
    bands = [row_band(height, i, n) for i in range(n)]
    rows = bands[r][1] - bands[r][0]
    hmax = max(e - s for s, e in bands)
    tensors = [leaf for _, leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor)]
    for leaf in tensors:
        if leaf.ndim == 0 or leaf.shape[0] != rows:
            raise ValueError(f"a leaf of shape {tuple(leaf.shape)} is not "
                             f"a band of {rows} rows")
    by_dtype: dict = {}
    for i, leaf in enumerate(tensors):
        by_dtype.setdefault(_wire_dtype(leaf.dtype), []).append(i)
    full = [None] * len(tensors)
    for wire, idx in by_dtype.items():
        parts = [tensors[i].reshape(rows, -1).to(wire) for i in idx]
        buf = torch.cat(parts, dim=1)
        if rows < hmax:
            buf = torch.cat([buf, buf.new_zeros((hmax - rows,
                                                 buf.shape[1]))])
        got = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(got, buf, group=group)
        whole = torch.cat([g[:e - s] for g, (s, e) in zip(got, bands)])
        start = 0
        for i, p in zip(idx, parts):
            width = p.shape[1]
            full[i] = whole[:, start:start + width].to(
                tensors[i].dtype).reshape((height,) + tensors[i].shape[1:])
            start += width
    it = iter(full)
    return map_tensors(lambda _: next(it), tree)


def gather_rows(x: torch.Tensor, group, height: int) -> torch.Tensor:
    """This rank's (band rows, ...) tensor -> the full (height, ...) one,
    the same on every rank (uneven bands padded to the largest)."""
    return gather_tree([x], group, height)[0]


def all_reduce_counters(counters: dict, group) -> dict:
    """The scalar counters summed over `group` in one all-reduce (float64,
    so integer counts stay exact), each back in its own dtype."""
    keys = list(counters)
    if not keys:
        return {}
    vals = [torch.as_tensor(counters[k]) for k in keys]
    dev = vals[0].device
    flat = torch.stack([v.to(device=dev, dtype=torch.float64).reshape(())
                        for v in vals])
    dist.all_reduce(flat, group=group)
    return {k: flat[i].to(v.dtype) for i, (k, v) in enumerate(zip(keys,
                                                                  vals))}


def _digest(leaf) -> str:
    if not isinstance(leaf, torch.Tensor):
        return repr(leaf)
    t = leaf.detach().reshape(-1).contiguous().cpu()
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{t.dtype}{tuple(leaf.shape)}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replica_checksums(state, group=None) -> dict:
    """{dotted path: [digest of each rank's leaf, in rank order]} over
    every leaf of `state` (a FrameState): a 128-bit hash of the leaf's
    bytes, dtype and shape. Replicas are identical where each list holds
    one value. Without a group, one digest each (this process)."""
    local = {path: _digest(leaf) for path, leaf in leaves(state)}
    if group is None:
        return {p: [d] for p, d in local.items()}
    everyone = [None] * dist.get_world_size(group)
    dist.all_gather_object(everyone, local, group=group)
    return {p: [e[p] for e in everyone] for p in local}


def replicas_differ(checksums: dict) -> list:
    """The paths of `replica_checksums` whose ranks disagree."""
    return [p for p, v in checksums.items() if len(set(v)) > 1]
