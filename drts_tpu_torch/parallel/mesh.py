"""Row bands, the frame-state placement rule and the collectives of the
sharded frame (port of ``drts_tpu/parallel/mesh.py``).

The reference builds a 1-D ``jax.sharding.Mesh``, annotates shardings and
lets GSPMD insert the collectives; here a ``torch.distributed`` group
stands for the mesh and the exchanges are explicit (see the package
docstring). ``frame_state_placement`` is the reference's
``frame_state_sharding`` rule, path by path: which buffers are per-row,
per-slot or replicated; ``shard_state`` cuts a one-device state by it and
``gather_state`` puts it back together. A ``Band`` is one rank's rows of
a frame split over a group; it fetches halos (``Band.halo``), gathers the
whole frame (``Band.gather``) and reduce-scatters per-row sums
(``Band.reduce_scatter``). ``all_reduce_counters`` sums the frame's
counters over the ranks.

Every collective runs on the tensors' own device: NCCL on the card (one
card per rank), gloo on the CPU, and gloo on CUDA tensors too, where
several ranks share one card (``chip_smoke.py`` phase 22 (b)). Halos are
one all-gather of each rank's edge rows on every backend (gloo has no
point-to-point on CUDA tensors): ``all_gather_into_tensor`` on NCCL, which
a CUDA graph capture records (the sharded graph frame, graphs.py), the
list ``all_gather`` on gloo. No collective's size depends on a frame's
data, and every index tensor a halo takes is made by the frame before a
capture (``_halo_source``). The reduce-scatter is
``reduce_scatter_tensor`` ("native") on both backends, CPU and CUDA
tensors alike; its other form, an ``all_reduce`` followed by this rank's
slice ("all_reduce"), is there for a backend without reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math

import torch
import torch.distributed as dist

from ..utils.checkpoint import leaves

ROWS, SLOTS, REPLICATED = "rows", "slots", "replicated"
REDUCE_SCATTER_FORMS = ("native", "all_reduce")


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


def row_bands(height: int, n: int) -> tuple:
    """Every rank's ``row_band``, in rank order."""
    return tuple(row_band(height, r, n) for r in range(n))


def group_band(height: int, group) -> tuple[int, int]:
    """This rank's band of `height` rows in `group`."""
    r, n = group_rank(group)
    return row_band(height, r, n)


def map_tensors(fn, obj):
    """`obj` rebuilt with fn(tensor) in place of each tensor leaf."""
    return map_leaves(lambda _, t: fn(t), obj)


def map_leaves(fn, obj, prefix=""):
    """`obj` rebuilt with fn(dotted path, tensor) in place of each tensor
    leaf (the paths of ``checkpoint.leaves``)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_leaves(fn, getattr(obj, f.name),
                               f"{prefix}{f.name}.")
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: map_leaves(fn, v, f"{prefix}{k}.")
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_leaves(fn, v, f"{prefix}{i}.")
                         for i, v in enumerate(obj))
    if isinstance(obj, torch.Tensor):
        return fn(prefix[:-1], obj)
    return obj


def frame_state_placement(state, image_heights: tuple[int, ...],
                          slot_table_sizes: tuple[int, ...] = (),
                          n: int = 1) -> dict:
    """{dotted path: "rows" | "slots" | "replicated"} for every leaf of a
    one-device FrameState, by the reference's ``frame_state_sharding``
    rule on a mesh of `n` devices: a leaf of two or more axes whose first
    is an image height divisible by n is per-row; a leaf whose first axis
    is a slot table size divisible by n is per-slot; everything else
    (scene, physics, scalars, host numbers) is replicated. The sharded
    frame reads it (``RenderPipeline.placement``): between frames a
    per-row leaf holds the rank's ``row_band`` of its rows, a per-slot
    leaf the rank's range of slots, a replicated leaf all of it."""
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


def _packed(tensors, rows: int):
    """{wire dtype: (indices into tensors, their (rows, C) parts)}: the
    tensors grouped by dtype (bool travels as uint8), each flattened to
    `rows` rows."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(_wire_dtype(t.dtype), []).append(i)
    return {wire: (idx, [tensors[i].reshape(
        rows, math.prod(tensors[i].shape[1:])).to(wire) for i in idx])
            for wire, idx in by_dtype.items()}


def _unpacked(whole, idx, parts, tensors, out, rows: int):
    """Split the (rows, sum C) `whole` back into the tensors `idx` of
    `tensors` (their dtypes and trailing shapes), into `out`."""
    start = 0
    for i, p in zip(idx, parts):
        width = p.shape[1]
        out[i] = whole[:, start:start + width].to(tensors[i].dtype).reshape(
            (rows,) + tensors[i].shape[1:])
        start += width


def _pad_rows(buf, rows: int):
    if buf.shape[0] < rows:
        buf = torch.cat([buf, buf.new_zeros((rows - buf.shape[0],)
                                            + buf.shape[1:])])
    return buf


@dataclasses.dataclass(frozen=True)
class Band:
    """Rank `rank`'s rows of a frame of `height` rows split over `group`
    into `bands` ([start, end) per rank, in rank order, covering every
    row; a band may be empty). The exchanges are collectives: every rank
    of the group calls them in the same order with the same sizes."""
    group: object
    rank: int
    bands: tuple
    height: int

    @classmethod
    def of(cls, group, height: int) -> "Band":
        """The ``row_band`` split of `height` rows over `group`."""
        r, n = group_rank(group)
        return cls(group, r, row_bands(height, n), height)

    @property
    def n(self) -> int:
        return len(self.bands)

    @property
    def start(self) -> int:
        return self.bands[self.rank][0]

    @property
    def end(self) -> int:
        return self.bands[self.rank][1]

    @property
    def rows(self) -> int:
        return self.end - self.start

    def span(self) -> tuple[int, int]:
        return self.bands[self.rank]

    def ext_span(self, lo: int, hi: int) -> tuple[int, int]:
        """[a, b): the frame rows of this band with `lo` rows below and
        `hi` above, cut at the frame's edges (what ``halo`` returns)."""
        return max(0, self.start - lo), min(self.height, self.end + hi)

    def inner(self, x, lo: int):
        """This band's rows of `x`, a ``halo(..., lo, hi)`` result (or a
        tensor computed row for row from one)."""
        a = self.ext_span(lo, 0)[0]
        return x[self.start - a:self.end - a]

    def full(self, x):
        """`x` as the whole frame: gathered where it holds this band's rows
        (and the band is not the frame), as it is where it holds every
        row already."""
        if x.shape[0] == self.height:
            return x
        return self.gather(x)

    def gather(self, x):
        """This band's (rows, ...) tensor -> the whole (height, ...) one,
        the same on every rank."""
        return self.gather_tree([x])[0]

    def gather_tree(self, tree):
        """`tree` with every tensor leaf of this band's rows replaced by
        the whole frame's: one all-gather per dtype, padded to the largest
        band, in the tree's order. Other leaves pass through."""
        tensors = [leaf for _, leaf in leaves(tree)
                   if isinstance(leaf, torch.Tensor)]
        for leaf in tensors:
            if leaf.ndim == 0 or leaf.shape[0] != self.rows:
                raise ValueError(f"a leaf of shape {tuple(leaf.shape)} is "
                                 f"not a band of {self.rows} rows")
        if self.n == 1:
            return tree
        hmax = max(e - s for s, e in self.bands)
        full = [None] * len(tensors)
        for wire, (idx, parts) in _packed(tensors, self.rows).items():
            buf = _pad_rows(torch.cat(parts, dim=1), hmax)
            got = _all_gather(buf, self.n, self.group)
            whole = torch.cat([g[:e - s] for g, (s, e) in
                               zip(got, self.bands)])
            _unpacked(whole, idx, parts, tensors, full, self.height)
        it = iter(full)
        return map_tensors(lambda _: next(it), tree)

    def halo(self, tensors, lo: int, hi: int, cyclic: bool = False):
        """Each of `tensors` (this band's rows) extended by `lo` rows below
        the band and `hi` above, the neighbours' rows from one all-gather
        per dtype of every rank's first `hi` and last `lo` rows. Clamp
        mode stops at the frame's edges (rows ``ext_span(lo, hi)``), so a
        clamp-addressed filter of footprint <= lo, hi computes this band's
        rows as the whole frame does; cyclic mode wraps (rows start - lo
        ... end + hi - 1, modulo the height), as ``torch.roll``."""
        if not tensors:
            return []
        exchange = self.n > 1 and bool(lo or hi)
        source = _halo_source(self.bands, self.rank, self.height, lo, hi,
                              cyclic, exchange, str(tensors[0].device))
        if source is None:
            return list(tensors)
        if not exchange:
            return [t[source] for t in tensors]
        hmax = max(e - s for s, e in self.bands)
        lo_c, hi_c = min(lo, hmax), min(hi, hmax)
        rows = self.rows
        out = [None] * len(tensors)
        for wire, (idx, parts) in _packed(tensors, rows).items():
            local = torch.cat(parts, dim=1)
            edges = torch.cat([_pad_rows(local[:min(hi_c, rows)], hi_c),
                               _pad_rows(local[rows - min(lo_c, rows):],
                                         lo_c)])
            got = _all_gather(edges, self.n, self.group)
            pool = torch.cat([local, got.flatten(0, 1)])
            _unpacked(pool[source], idx, parts, tensors, out,
                      source.shape[0])
        return out

    def reduce_scatter(self, x, op=None, form: str = "native"):
        """This band's rows of the sum (or `op`) over the ranks of `x`, a
        (height, ...) tensor every rank holds: ``reduce_scatter_tensor``
        over equal chunks (uneven bands padded) in "native" form, an
        all-reduce and a slice in "all_reduce" form."""
        op = dist.ReduceOp.SUM if op is None else op
        if form not in REDUCE_SCATTER_FORMS:
            raise ValueError(f"form must be one of {REDUCE_SCATTER_FORMS}, "
                             f"got {form!r}")
        if x.shape[0] != self.height:
            raise ValueError(f"a leaf of {x.shape[0]} rows, not the frame's "
                             f"{self.height}")
        if self.n == 1:
            return x
        if form == "all_reduce":
            x = x.clone()
            dist.all_reduce(x, op=op, group=self.group)
            return x[self.start:self.end]
        chunk = max(e - s for s, e in self.bands)
        if all(e - s == chunk for s, e in self.bands):
            buf = x.contiguous()
        else:
            buf = torch.cat([_pad_rows(x[s:e], chunk)
                             for s, e in self.bands])
        out = buf.new_empty((chunk,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, buf, op=op, group=self.group)
        return out[:self.rows]

    def source_halo(self, src: "Band", need) -> tuple[int, int]:
        """(lo, hi) rows of halo around `src`'s bands that give every rank
        the rows of `src`'s frame that `need(start, end)` says its own
        rows [start, end) of this band read: need returns (first, last + 1)
        of those rows (clamped to the frame by the caller's filter), or
        None for an empty band. The same on every rank."""
        lo = hi = 0
        for (s, e), (ss, se) in zip(self.bands, src.bands):
            if e <= s:
                continue
            a, b = need(s, e)
            a, b = max(a, 0), min(b, src.height)
            lo = max(lo, ss - a)
            hi = max(hi, b - se)
        return lo, hi


def _all_gather(buf, n: int, group):
    """Every rank's `buf` stacked in rank order, (n,) + buf.shape: one
    ``all_gather_into_tensor`` on NCCL (one output buffer, which a CUDA
    graph capture holds), the list ``all_gather`` into views of the same
    buffer on any other backend."""
    out = buf.new_empty((n,) + tuple(buf.shape))
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, buf, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), buf, group=group)
    return out


@functools.lru_cache(maxsize=512)
def _halo_source(bands, rank, height, lo, hi, cyclic, exchange, device):
    """The rows of ``Band.halo``'s pool (this band's rows, then each
    rank's first min(hi, hmax) and last min(lo, hmax) rows) that make up
    the extended band, as an int64 tensor on `device`, made once per
    split, halo and device (no copy to the card each frame, and none
    inside a graph capture, whose warm-up frame makes every halo its
    frame takes: no halo's size depends on a frame's data); None where
    no rank exchanges and the extended band is the band itself. (Whether
    a rank exchanges must not depend on its own rows: every rank calls
    the collective.)"""
    s, e = bands[rank]
    if cyclic:
        want = [g % height for g in range(s - lo, e + hi)]
    else:
        want = list(range(max(0, s - lo), min(height, e + hi)))
    if not exchange and want == list(range(s, e)):
        return None
    hmax = max(ee - ss for ss, ee in bands)
    lo_c, hi_c = min(lo, hmax), min(hi, hmax)
    source = []
    for g in want:
        if s <= g < e:
            source.append(g - s)
            continue
        if not exchange:
            raise ValueError(f"row {g} is outside a band with no halo")
        j = next(k for k, (ss, ee) in enumerate(bands) if ss <= g < ee)
        sj, ej = bands[j]
        first, last = min(hi_c, ej - sj), min(lo_c, ej - sj)
        base = (e - s) + j * (lo_c + hi_c)
        if g - sj < first:
            source.append(base + g - sj)
        elif ej - g <= last:
            source.append(base + hi_c + last - (ej - g))
        else:
            raise ValueError(f"row {g} is beyond the halo of rank {j}")
    return torch.tensor(source, dtype=torch.int64, device=device)


def shard_state(state, group, placement: dict):
    """A one-device `state` cut to this rank's shards: each "rows" and
    "slots" leaf of `placement` to its ``row_band`` of its first axis,
    every other leaf as it is."""
    r, n = group_rank(group)

    def cut(path, leaf):
        if placement.get(path, REPLICATED) == REPLICATED:
            return leaf
        s, e = row_band(leaf.shape[0], r, n)
        return leaf[s:e]
    return map_leaves(cut, state)


def gather_state(state, group, placement: dict):
    """The one-device state back from each rank's shards of it
    (``shard_state``): every "rows" and "slots" leaf gathered, the same
    on every rank. Sharded leaves divide evenly (the rule), so each
    holds 1/n of its first axis."""
    _, n = group_rank(group)
    sharded = [(p, leaf) for p, leaf in leaves(state)
               if isinstance(leaf, torch.Tensor)
               and placement.get(p, REPLICATED) != REPLICATED]
    full = {}
    for rows in sorted({leaf.shape[0] for _, leaf in sharded}):
        same = [(p, leaf) for p, leaf in sharded if leaf.shape[0] == rows]
        band = Band.of(group, rows * n)
        got = band.gather_tree([leaf for _, leaf in same])
        full.update({p: g for (p, _), g in zip(same, got)})
    return map_leaves(lambda p, t: full.get(p, t), state)


def state_bytes(state) -> int:
    """Bytes of every tensor of `state` (what a rank holds between
    frames)."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in leaves(state)
               if isinstance(leaf, torch.Tensor))


def gather_rows(x: torch.Tensor, group, height: int) -> torch.Tensor:
    """This rank's (band rows, ...) tensor of its ``row_band`` of `height`
    rows -> the full (height, ...) one, the same on every rank (uneven
    bands padded to the largest)."""
    return Band.of(group, height).gather(x)


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


def replica_checksums(state, group=None, paths=None) -> dict:
    """{dotted path: [digest of each rank's leaf, in rank order]} over the
    leaves of `state` (a FrameState) whose paths are in `paths` (every
    leaf by default): a 128-bit hash of the leaf's bytes, dtype and shape.
    Replicas are identical where each list holds one value. Without a
    group, one digest each (this process)."""
    local = {path: _digest(leaf) for path, leaf in leaves(state)
             if paths is None or path in paths}
    if group is None:
        return {p: [d] for p, d in local.items()}
    everyone = [None] * dist.get_world_size(group)
    dist.all_gather_object(everyone, local, group=group)
    return {p: [e[p] for e in everyone] for p in local}


def replicas_differ(checksums: dict) -> list:
    """The paths of `replica_checksums` whose ranks disagree."""
    return [p for p, v in checksums.items() if len(set(v)) > 1]
