"""SHARC: the hash-grid radiance cache for GI (port of
``drts_tpu/ops/sharc.py``).

A fixed-capacity direct-mapped table addressed by ``hash(key) % capacity``
with a 32-bit key fingerprint: a colliding minority of updates is dropped
rather than corrupted, the degradation SHARC's bounded probe window has.
The voxel key is the position quantized at a camera-distance log level
and the normal octant (HashGridGetLevel / GetVoxelSize with sceneScale).
The update trace records (slot, fingerprint, radiance) per bounce and
``splat_levels`` scatters them all at once; ``resolve`` blends the frame's
sums into the cache with a count cap and staleness eviction, and rebuilds
the packed query mirror that ``query`` reads with one row gather.

Integers: the reference's uint32 hashes are int64 tensors holding values
in [0, 2^32) (``utils/rng.hash_u32``), so slots, fingerprints and the
query mirror's ``meta`` words equal the reference's bit for bit; ``meta``
moves as the bits of an f32 column, never through a value cast. The two
caps of ``splat_levels`` (n/3 live rows before the sort, n/6 rows after
the dedup) drop rows and count them, as the reference does; they are part
of the result. The splat's float sums are PyTorch's ``index_add_``, whose
order of additions differs from the reference's scatter (and, on a card,
from run to run): the cache's radiance is held to a tolerance, not bit for
bit.

On the sharded frame the cache lives in slot ranges (``slot_band``, a
``parallel.mesh.Band`` over the capacity): ``splat_levels`` reduce-scatters
each rank's splat into the ranges, ``resolve`` runs on a range as on the
whole table (it is per slot), and the query mirror is all-gathered once a
frame for the path trace (``query_mirror``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils import math as m
from ..utils import rng as rng_mod

LOG_BASE = 2.0       # SHARC_GRID_LOGARITHM_BASE
LEVEL_BIAS = 2.0     # SHARC_GRID_LEVEL_BIAS
MAX_LEVEL = 16
_M32 = 0xFFFFFFFF
_FP_MASK = 0xFFFFFFC0  # the fingerprint bits kept in a meta word
_DEDUP_LEVELS = 5      # _local_dedup merges runs within groups of 2^5 rows


@dataclasses.dataclass(frozen=True)
class SHARCConfig:
    """The reference's SHARC defaults (MyAppData.h, SHARC.ixx:24,48)."""
    capacity_log2: int = 22
    scene_scale: float = 50.0
    accumulation_frames: int = 10
    max_stale_frames: int = 64
    min_samples_for_query: float = 4.0
    roughness_threshold: float = 0.4
    anti_firefly: bool = True
    anti_firefly_luminance: float = 20.0


@dataclasses.dataclass(frozen=True)
class SHARCState:
    """The cache. ``packed`` is the query mirror: (C, 3) f32 rows [r|g
    (f16 pair), b|0 (f16 pair), meta], meta the bits of (fingerprint &
    0xFFFFFFC0) | min(count, 63)."""
    fingerprint: torch.Tensor   # (C,) int64 in [0, 2^32); 0 = empty
    radiance: torch.Tensor      # (C, 3) accumulated average radiance
    sample_count: torch.Tensor  # (C,) effective sample count
    stale_frames: torch.Tensor  # (C,) frames since the last touch
    packed: torch.Tensor        # (C, 3) f32 query mirror


def _pack_query_rows(fingerprint, radiance, sample_count):
    count6 = torch.clamp(sample_count, max=63.0).to(torch.int64)
    meta = (fingerprint & _FP_MASK) | count6
    return torch.stack(
        [m.pack2f16(radiance[:, 0], radiance[:, 1]),
         m.pack2f16(radiance[:, 2], torch.zeros_like(radiance[:, 2])),
         m.word_as_f32(meta)], dim=-1)


def init_state(cfg: SHARCConfig, device="cuda") -> SHARCState:
    c = 1 << cfg.capacity_log2
    zeros = torch.zeros(c, dtype=torch.float32, device=device)
    return SHARCState(
        fingerprint=torch.zeros(c, dtype=torch.int64, device=device),
        radiance=torch.zeros((c, 3), dtype=torch.float32, device=device),
        sample_count=zeros, stale_frames=zeros.clone(),
        packed=torch.zeros((c, 3), dtype=torch.float32, device=device))


# ----------------------------------------------------------------------------
# voxel keys


def grid_level(distance, cfg: SHARCConfig):
    """HashGridGetLevel: log-distance LOD, voxels grow with distance."""
    lvl = torch.floor(torch.log2(torch.clamp(distance, min=1e-3))
                      + LEVEL_BIAS)
    return torch.clamp(lvl, 0.0, MAX_LEVEL - 1).to(torch.int32)


def voxel_size(level, cfg: SHARCConfig):
    """HashGridGetVoxelSize: base^level / sceneScale."""
    return torch.exp2(level.to(torch.float32)) / cfg.scene_scale


def cache_key(position, normal, camera_position, cfg: SHARCConfig):
    """(slot int64, fingerprint int64 in [1, 2^32)) for a hit point: the
    level-quantized voxel coordinate and the normal octant, hashed."""
    dist = m.length(position - camera_position)
    level = grid_level(dist, cfg)
    vs = voxel_size(level, cfg)
    ivec = torch.floor(position / vs[..., None]).to(torch.int32)
    octant = ((normal[..., 0] >= 0).to(torch.int32)
              + 2 * (normal[..., 1] >= 0).to(torch.int32)
              + 4 * (normal[..., 2] >= 0).to(torch.int32))

    def mix(h, v):
        return rng_mod.hash_u32(h ^ ((rng_mod._u32(v) * 0x9E3779B9) & _M32))

    h = rng_mod.hash_u32(ivec[..., 0])
    h = mix(h, ivec[..., 1])
    h = mix(h, ivec[..., 2])
    h = mix(h, level + 37)
    h = mix(h, octant + 101)
    slot = h % (1 << cfg.capacity_log2)
    fingerprint = torch.clamp(rng_mod.hash_u32(h ^ 0xA511E9B3), min=1)
    return slot, fingerprint


# ----------------------------------------------------------------------------
# query (SharcGetCachedRadiance)


def query(state: SHARCState, position, normal, camera_position,
          cfg: SHARCConfig):
    """Returns (radiance (..., 3), valid (...,)) from one row gather of
    the packed mirror."""
    slot, fp = cache_key(position, normal, camera_position, cfg)
    row = state.packed[slot]
    meta = row[..., 2].view(torch.int32).to(torch.int64) & _M32
    count = (meta & 63).to(torch.float32)
    valid = (((meta & _FP_MASK) == (fp & _FP_MASK))
             & (count >= cfg.min_samples_for_query) & (meta != 0))
    r, g = m.unpack2f16(row[..., 0])
    b, _ = m.unpack2f16(row[..., 1])
    radiance = torch.where(valid[..., None], torch.stack([r, g, b], dim=-1),
                           0.0)
    return radiance, valid


def footprint_valid(hit_distance, prev_roughness, position, camera_position,
                    cfg: SHARCConfig):
    """The SHARC_QUERY validity heuristic (Raytracing.hlsl:265-274): the
    hit distance must exceed the voxel diagonal, and the accumulated
    roughness cone's footprint the voxel size."""
    dist = m.length(position - camera_position)
    vs = voxel_size(grid_level(dist, cfg), cfg)
    ok = hit_distance > vs * (3.0 ** 0.5)
    rough = torch.clamp(prev_roughness, max=0.99)
    alpha = rough * rough
    footprint = hit_distance * torch.sqrt(
        0.5 * alpha * alpha / torch.clamp(1.0 - alpha * alpha, min=1e-4))
    return ok & (footprint > vs)


# ----------------------------------------------------------------------------
# update accumulation + resolve


def splat(state_accum, slots, fingerprints, radiance, active):
    """Scatter one bounce level's vertex radiance into the frame
    accumulator (sum (C, 3), count (C,), fp (C,))."""
    return splat_levels(state_accum, [slots], [fingerprints], [radiance],
                        [active])[:3]


def _local_dedup(slots, payload, fp, capacity: int):
    """Merge rows with equal slot within groups of 32 consecutive rows by a
    pairwise tree (pairs, then pairs of pairs, ...): each level folds the
    rows of a right half-group whose slot equals the left half-group's
    leader into that leader. Merged rows get slot = capacity (dropped) and
    fingerprint 0. The rows come slot-sorted, so a voxel's run is
    adjacent."""
    n = slots.shape[0]
    g = 1 << _DEDUP_LEVELS
    m_groups = n // g
    c = payload.shape[-1]
    s = slots[:m_groups * g].reshape(m_groups, g)
    p = payload[:m_groups * g].reshape(m_groups, g, c)
    f = fp[:m_groups * g].reshape(m_groups, g)
    for level in range(_DEDUP_LEVELS):
        width = 1 << level
        k = g // (2 * width)
        s4 = s.reshape(m_groups, k, 2, width).clone()
        p4 = p.reshape(m_groups, k, 2, width, c).clone()
        leader = s4[:, :, 0, 0]
        match = ((s4[:, :, 1, :] == leader[..., None])
                 & (leader != capacity)[..., None])
        moved = torch.sum(torch.where(match[..., None], p4[:, :, 1], 0.0),
                          dim=-2)
        p4[:, :, 0, 0, :] = p4[:, :, 0, 0, :] + moved
        s4[:, :, 1, :] = torch.where(match, capacity, s4[:, :, 1, :])
        s = s4.reshape(m_groups, g)
        p = p4.reshape(m_groups, g, c)
    f = torch.where(s == capacity, 0, f)
    out_slots, out_payload, out_fp = s.reshape(-1), p.reshape(-1, c), \
        f.reshape(-1)
    if m_groups * g != n:                          # ragged tail
        out_slots = torch.cat([out_slots, slots[m_groups * g:]])
        out_payload = torch.cat([out_payload, payload[m_groups * g:]])
        out_fp = torch.cat([out_fp, fp[m_groups * g:]])
    return out_slots, out_payload, out_fp


def _compact_rows(keep, cap: int):
    """Row indices of the first `cap` rows of `keep`, in order, padded with
    n (one past the end); and how many kept rows did not fit."""
    n = keep.shape[0]
    pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    dropped = torch.clamp(keep.sum() - cap, min=0)
    dest = torch.where(keep & (pos < cap), pos, cap)
    src = torch.full((cap + 1,), n, dtype=torch.int64, device=keep.device)
    src[dest] = torch.arange(n, device=keep.device)
    return src[:cap], dropped


def splat_levels(state_accum, slots_list, fps_list, radiance_list,
                 active_list, slot_band=None):
    """Scatter every bounce level's vertex radiance in two scatters (an add
    of [rgb * w, w] and a max of the fingerprint claim). Returns (sum (C,
    3), count (C,), fp (C,), dropped rows).

    The rows of all levels are stacked, dead rows (w = 0) routed to the
    drop slot; the first n/3 live rows are kept (all of them at n <=
    16384), sorted by slot (stable), merged within groups of 32
    (_local_dedup), and the first n/6 surviving rows are scattered: live
    rows beyond either cap are dropped and counted.

    With ``slot_band`` (the sharded frame's Band over the capacity: each
    rank splats its band's rows into zeroed accumulators) the splat is
    reduce-scattered into the ranks' slot ranges: a SUM of the (C, 4)
    sums and counts and a MAX of the fingerprints, this rank's range
    returned, and the dropped rows all-reduced. The caps apply to each
    rank's rows, so a band may drop rows that one call over the whole
    frame keeps, and the reverse."""
    acc_sum, acc_count, acc_fp = state_accum
    capacity = acc_count.shape[0]
    dev = acc_count.device
    slots = torch.cat([s.reshape(-1).to(torch.int64) for s in slots_list])
    w = torch.cat([a.to(torch.float32).reshape(-1) for a in active_list])
    rad = torch.cat([r.reshape(-1, 3) for r in radiance_list])
    payload = torch.cat([rad * w[:, None], w[:, None]], dim=-1)
    fp = torch.cat([torch.where(a, f, 0).reshape(-1)
                    for a, f in zip(active_list, fps_list)])
    slots = torch.where(w > 0, slots, capacity)

    n0 = slots.shape[0]
    cap_live = n0 if n0 <= 16384 else -(-n0 // 3 // 1024) * 1024
    take, dropped_pre = _compact_rows(slots < capacity, cap_live)
    slots = torch.cat([slots, torch.full((1,), capacity, dtype=slots.dtype,
                                         device=slots.device)])[take]
    payload = torch.cat([payload, payload.new_zeros((1, 4))])[take]
    fp = torch.cat([fp, fp.new_zeros(1)])[take]

    slots, order = torch.sort(slots, stable=True)
    payload, fp = payload[order], fp[order]
    slots, payload, fp = _local_dedup(slots, payload, fp, capacity)

    n = slots.shape[0]
    cap_rows = -(-n // 6 // 1024) * 1024
    src, dropped = _compact_rows(slots < capacity, cap_rows)
    live = src < n
    safe = torch.clamp(src, max=n - 1)
    c_slots = torch.where(live, slots[safe], capacity)
    c_payload = torch.where(live[:, None], payload[safe], 0.0)
    c_fp = torch.where(live, fp[safe], 0)

    # One extra row takes the rows of the drop slot.
    acc4 = torch.cat([acc_sum, acc_count[:, None]], dim=-1)
    acc4 = torch.cat([acc4, acc4.new_zeros((1, 4))])
    acc4.index_add_(0, c_slots, c_payload)
    fp_out = torch.cat([acc_fp, acc_fp.new_zeros(1)])
    fp_out.scatter_reduce_(0, c_slots, c_fp, reduce="amax")
    dropped = (dropped + dropped_pre).to(dev)
    acc4, fp_out = acc4[:capacity], fp_out[:capacity]
    if slot_band is not None:
        acc4 = slot_band.reduce_scatter(acc4)
        fp_out = slot_band.reduce_scatter(fp_out, op=dist.ReduceOp.MAX)
        if slot_band.n > 1:
            dist.all_reduce(dropped, group=slot_band.group)
    return acc4[:, 0:3], acc4[:, 3], fp_out, dropped


def query_mirror(state: SHARCState, slots=None) -> SHARCState:
    """`state` with the whole query mirror: gathered from the ranks' slot
    ranges (one all-gather) where it holds this rank's range."""
    if slots is None:
        return state
    return dataclasses.replace(state, packed=slots.full(state.packed))


def resolve(state: SHARCState, frame_sum, frame_count, frame_fp,
            cfg: SHARCConfig) -> SHARCState:
    """SharcResolveEntry (SHARC.hlsl:30-62): blend the frame's splats into
    the cache with an accumulation cap; evict stale or fingerprint-
    conflicting entries; rebuild the query mirror."""
    touched = frame_count > 0
    new_fp_differs = touched & (frame_fp != state.fingerprint) \
        & (state.fingerprint > 0)
    # A different voxel claimed the slot: restart accumulation there.
    base_radiance = torch.where(new_fp_differs[..., None], 0.0,
                                state.radiance)
    base_count = torch.where(new_fp_differs, 0.0, state.sample_count)

    frame_avg = frame_sum / torch.clamp(frame_count, min=1.0)[..., None]
    if cfg.anti_firefly:
        lum = m.luminance(frame_avg)
        scale = torch.clamp(cfg.anti_firefly_luminance
                            / torch.clamp(lum, min=1e-6), max=1.0)
        frame_avg = frame_avg * scale[..., None]

    total = base_count + frame_count
    blended = torch.where(
        touched[..., None],
        (base_radiance * base_count[..., None]
         + frame_avg * frame_count[..., None])
        / torch.clamp(total, min=1e-6)[..., None],
        state.radiance)
    new_count = torch.where(
        touched, torch.minimum(total, cfg.accumulation_frames * 1.0
                               * torch.clamp(frame_count, min=1.0)),
        state.sample_count)
    new_count = torch.clamp(new_count, max=64.0)

    stale = torch.where(touched, 0.0, state.stale_frames + 1.0)
    evict = stale > cfg.max_stale_frames
    fingerprint = torch.where(evict, 0,
                              torch.where(touched, frame_fp,
                                          state.fingerprint))
    radiance = torch.where(evict[..., None], 0.0, blended)
    sample_count = torch.where(evict, 0.0, new_count)
    return SHARCState(
        fingerprint=fingerprint, radiance=radiance,
        sample_count=sample_count, stale_frames=stale,
        packed=_pack_query_rows(fingerprint, radiance, sample_count))
