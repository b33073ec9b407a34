"""The wavefront path tracer (port of ``drts_tpu/ops/pathtrace.py``).

Bounce-synchronous as in the reference: at each bounce every live path
intersects, shades, samples and terminates together. Bounces before
``compact_from`` run dense over the frame; from there on the survivors are
packed into a compacted buffer, sorted by (direction octant, screen tile),
and traced there, with an overflow spill wave for the paths beyond its
capacity. Same integrator semantics as the reference: per-hit emission,
three-lobe BSDF sampling, Russian roulette after bounce 3, the throughput
cutoff and the NaN guard (Raytracing.hlsl:103-415).

The compaction is the reference's ``compact_impl="scatter"`` /
``compact_gsel="direct"`` form. With ``compact_from=1`` the bounce-1
wavefront is compacted too, into ``n / compact_fraction_first`` slots, and
the deep segment cascades in that segment's slot space. Capacities of
``compact_sort_partition_min`` slots or more replace the (octant, tile)
key sort by a stable 9-bucket octant partition over a static tile-major
compaction order, which gives the same grouping. ``overflow_spill`` runs a
second wave over the paths the deep segment had to drop. Also here: the
ReSTIR DI handoff (``di_radiance``: added at the primary vertex, bounce-1
emission suppressed there), the SHARC query (from ``sharc_query_from``)
and ``sharc_update_trace``, the cache's downscaled update pass, compacted
after bounce 0 when ``compact_from=1``. Textures follow the reference's
``texture_bounces`` policy at every site: the primary hit samples them
bilinear, bounces below ``texture_bounces`` nearest from the half-size
mip, later bounces not at all, and their misses read the environment's
quarter-size mip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..models import scene as scene_mod
from ..utils import math as m
from ..utils import rng as rng_mod
from . import bxdf, camera as camera_mod, intersect, post, shading, sharc
from . import sky, trace as trace_mod


@dataclasses.dataclass(frozen=True)
class PathTraceConfig:
    """Integrator settings, with the reference's names and defaults."""
    width: int = 256
    height: int = 256
    bounces: int = 8
    samples_per_pixel: int = 1
    russian_roulette: bool = True
    throughput_threshold: float = 1e-3
    block_size: int = 16384
    # Bounces >= compact_from run on a compacted survivor buffer of
    # n_pixels / compact_fraction slots (or compact_capacity when set).
    compact_from: int = 2
    compact_fraction: int = 24
    compact_capacity: int = 0
    # A second wave re-runs the deep segment over the lanes it dropped;
    # off, those paths lose their remaining radiance (still counted in
    # wavefront_overflow_paths).
    overflow_spill: bool = True
    # Capacity divisor of the bounce-1 segment (compact_from=1).
    compact_fraction_first: int = 1
    # Sort the compacted slots by (direction octant, screen tile) of
    # compact_sort_tile pixels; from compact_sort_partition_min slots on,
    # by the stable octant partition over a tile-major compaction order.
    compact_sort: bool = True
    compact_sort_tile: int = 64
    compact_sort_partition_min: int = 500_000
    # First bounce that queries the SHARC cache (the reference's op
    # default 1; its pipeline sets 2).
    sharc_query_from: int = 1
    # Bounces below this fetch textures (the primary hit bilinear, later
    # ones "nearest" from the half-size mip); from it on, materials take
    # their constants and misses the environment's quarter-size mip (their
    # ray footprint spans many texels).
    texture_bounces: int = 2


@dataclasses.dataclass(frozen=True)
class TraceOutput:
    """Radiance + first-bounce AOVs (Raytracing.hlsl output routing)."""
    radiance: torch.Tensor          # (H, W, 3)
    is_diffuse: torch.Tensor        # (H, W) bool: first scatter was diffuse
    hit_distance: torch.Tensor      # (H, W) first secondary-hit distance
    primary_valid: torch.Tensor     # (H, W) bool
    primary_position: torch.Tensor  # (H, W, 3)
    primary_normal: torch.Tensor    # (H, W, 3) shading normal
    primary_albedo: torch.Tensor    # (H, W, 3)
    primary_f_env: torch.Tensor     # (H, W, 3)
    primary_radiance: torch.Tensor  # (H, W, 3) emission/env at bounce 0
    rays_traced: torch.Tensor       # scalar: total rays cast
    # {"wavefront_overflow_paths": scalar} and, with SHARC, per bounce b
    # "sharc_{hits,queries,gate,entry}_b{b}".
    counters: dict
    # Overflow spill waves run (the host's decision in _spill); a frame
    # captured as a CUDA graph counts its waves at replay instead.
    spill_waves: int = 0
    # The same count as a 0-d float32 device tensor (each wave's overflow
    # above 0, taken before its decision), which a captured frame holds
    # right at every replay: the sharded frame sums it over the ranks.
    spill_count: torch.Tensor | None = None


def _shade_and_scatter(surf, ray_d, rng, mat=None,
                       min_roughness: float = 0.0, textures=None):
    """One bounce's material eval + BSDF sample. Returns (emission,
    new_dir, eval/pdf weight, valid, lobe, bsdf, rng). A precomputed `mat`
    (the G-buffer's) skips the texture fetch; else `textures` (or None)
    are read "nearest". `min_roughness` floors the roughness: the
    SHARC update trace's RoughnessThreshold (Raytracing.hlsl:309), so
    cached paths diffuse out instead of following mirror chains."""
    if mat is None:
        mat = shading.evaluate_material(surf.material, surf.uv,
                                        surf.shading_normal, surf.tangent,
                                        textures, "nearest")
    if min_roughness > 0.0:
        mat = dataclasses.replace(
            mat, roughness=torch.clamp(mat.roughness, min=min_roughness))
    sv = bxdf.make_surface_vectors(surf.is_front_face, surf.geometric_normal,
                                   mat.shading_normal)
    bs = bxdf.make_bsdf(mat.base_color, mat.metallic, mat.roughness, mat.ior,
                        mat.transmission, surf.is_front_face)
    v = -ray_d
    weights = bxdf.lobe_weights(bs, sv, v)
    rand4, rng = rng_mod.next_floats(rng, 4)
    l_dir, lobe, valid = bxdf.sample(bs, sv, v, rand4)
    pdf = bxdf.eval_pdf_lobe(bs, sv, l_dir, v, weights, lobe)
    f = bxdf.eval_lobe(bs, sv, l_dir, v, weights, lobe)
    pdf_ok = pdf > 0.0
    weight = torch.where(pdf_ok[..., None],
                         f / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    valid = valid & pdf_ok & torch.any(f != 0.0, dim=-1)
    return mat.emission, l_dir, weight, valid, lobe, bs, rng


def _roulette_and_cutoff(cfg, bounce, thr, active, rng):
    """Russian roulette after bounce 3 (Raytracing.hlsl:348-356) and the
    throughput luminance cutoff (:361-364)."""
    if cfg.russian_roulette and bounce > 3:
        prob = torch.amax(thr, dim=-1)
        u, rng = rng_mod.next_float(rng)
        active = active & ~(u >= prob)
        thr = thr / torch.clamp(prob, min=1e-20)[..., None]
    active = active & (m.luminance(thr) > cfg.throughput_threshold)
    return thr, active, rng


def _front_normal(surf):
    return torch.where(surf.is_front_face[..., None], surf.geometric_normal,
                       -surf.geometric_normal)


def _sharc_lookup(sharc_state, sharc_cfg, cam_pos, surf, active, rough,
                  bounce: int, counters: dict):
    """The SHARC query at one bounce's hits (Raytracing.hlsl:261-291):
    where the footprint gate passes and the cache holds the voxel, the
    path ends into the cached radiance. Adds the bounce's hits, queries,
    gate and entry counts to `counters`; returns (use_cache, cached)."""
    fp_ok = sharc.footprint_valid(surf.distance, rough, surf.position,
                                  cam_pos, sharc_cfg)
    cached, cache_hit = sharc.query(sharc_state, surf.position,
                                    _front_normal(surf), cam_pos, sharc_cfg)
    use_cache = active & fp_ok & cache_hit
    for name, mask in (("hits", use_cache), ("queries", active),
                       ("gate", active & fp_ok),
                       ("entry", active & cache_hit)):
        key = f"sharc_{name}_b{bounce}"
        counters[key] = counters.get(key, 0.0) + mask.sum().to(torch.float32)
    return use_cache, cached


def _rough_step(rough, lobe, bs):
    """The path's accumulated roughness, the footprint gate's input."""
    return rough + torch.where(lobe == bxdf.LOBE_DIFFUSE, 1.0, bs.roughness)


def _compact_capacity(n_pixels: int, fraction: int) -> int:
    cap = max(1024, n_pixels // fraction)
    return -(-cap // 1024) * 1024


@functools.lru_cache(maxsize=None)
def _tile_order(h: int, w: int, tile: int, device: torch.device):
    """The static tile-major order of an (h, w) frame (tm: compaction
    position -> pixel) and its inverse, built once per shape and kept on
    the device for the life of the process: a frame captured as a CUDA
    graph reads these tensors at every replay, so no later shape may evict
    them (their warm-up frame builds them before the capture)."""
    pix = np.arange(h * w)
    tiles_x = -(-w // tile)
    tile_id = (pix // (w * tile)) * tiles_x + (pix % w) // tile
    tm = np.argsort(tile_id, kind="stable")
    return (torch.from_numpy(tm).to(device),
            torch.from_numpy(np.argsort(tm)).to(device))


def _compact_slots(act, l_dir_flat, pixel_ids, cfg, cap: int, h: int, w: int,
                   wave: int = 0):
    """Pack the live lanes of `act` into a (cap,) slot buffer, sort the
    slots by (direction octant, screen tile) and return slot_live, the
    overflow count, the (keep, pos, perm, cap) mapper for _slots_to_space,
    gsel (slot gather with a dead row) and the sort that ran ("partition",
    "key" or "none").

    The input is the pixel frame (`pixel_ids` None) or a previous
    segment's slots, whose true pixels `pixel_ids` gives. `wave` selects
    the window [wave*cap, (wave+1)*cap) of the live-lane sequence: wave 1
    packs the lanes wave 0 had to drop (the spill)."""
    ns = act.shape[0]
    dev = act.device
    partition = cfg.compact_sort and cap >= cfg.compact_sort_partition_min
    inv_tm = None
    if partition and pixel_ids is None:
        # Compact in tile-major pixel order: the stable octant partition
        # below then groups slots by (octant, tile, pixel in tile), the key
        # sort's grouping. Slot-space input is already tile-grouped by the
        # segment before, so it compacts in place.
        tm, inv_tm = _tile_order(h, w, cfg.compact_sort_tile, dev)
        act_src, order_ids = act[tm], tm
    else:
        act_src, order_ids = act, torch.arange(ns, device=dev)
    live_count = torch.cumsum(act_src.to(torch.int64), dim=0)
    pos = live_count - 1 - wave * cap
    keep = act_src & (pos >= 0) & (pos < cap)
    overflow = (act_src & (pos >= cap)).sum()

    # Slot -> input position table. Dropped lanes land on the extra slot
    # `cap`, which is cut off.
    src = torch.full((cap + 1,), ns, dtype=torch.int64, device=dev)
    src[torch.where(keep, pos, cap)] = order_ids
    src = src[:cap]
    if inv_tm is not None:
        keep, pos = keep[inv_tm], pos[inv_tm]

    # Coherence sort: octant-major keeps every ray block inside one
    # direction octant, tile-minor keeps its origins local; empty slots
    # sort last. Per-path results do not depend on the slot order.
    perm, sort = None, "none"
    if cfg.compact_sort:
        d = l_dir_flat
        octant = ((d[:, 0] < 0).to(torch.int64) * 4
                  + (d[:, 1] < 0).to(torch.int64) * 2
                  + (d[:, 2] < 0).to(torch.int64))
        idx = torch.clamp(src, max=ns)
        if partition:
            # Bucket 8 holds the dead slots. One masked cumsum per bucket,
            # the nine laid end to end in one flat scan: its inclusive
            # count at (bucket b, slot s) is the slots of buckets < b plus
            # the rank of s in b, so a slot's new position is the count at
            # its own bucket, less one. (A cumsum down the (cap, 9) matrix
            # instead runs the column scan of narrow tensors: 96 ms a frame
            # at 519,168 slots on an H100.)
            key = torch.cat([octant, torch.full((1,), 8, dtype=octant.dtype,
                                                device=dev)])[idx]
            masks = key[None, :] == torch.arange(9, device=dev)[:, None]
            counts = torch.cumsum(masks.reshape(-1).to(torch.int32), dim=0,
                                  dtype=torch.int32).reshape(9, cap)
            new_pos = counts.gather(0, key[None, :])[0].to(torch.int64) - 1
            perm = torch.empty_like(new_pos)
            perm[new_pos] = torch.arange(cap, device=dev)
            sort = "partition"
        else:
            ts = cfg.compact_sort_tile
            tiles_x, tiles_y = -(-w // ts), -(-h // ts)
            pix = (torch.arange(ns, device=dev) if pixel_ids is None
                   else pixel_ids)
            tile = (pix // (w * ts)) * tiles_x + (pix % w) // ts
            key = torch.cat([octant * (tiles_x * tiles_y) + tile,
                             torch.full((1,), 2 ** 30, dtype=octant.dtype,
                                        device=dev)])
            _, perm = torch.sort(key[idx], stable=True)
            sort = "key"
        src = src[perm]

    slot_live = src < ns
    idx = torch.clamp(src, max=ns)

    def gsel(x_flat, dead):
        """x_flat's rows in slot order; a dead slot takes `dead`: a number,
        or nested lists or tuples of one row's values (made once, as
        ``m.const``: nothing is copied from the host in a capture)."""
        shape = (1,) + x_flat.shape[1:]
        if isinstance(dead, (list, tuple)):
            row = m.const(_flatten(dead), x_flat.dtype, dev).reshape(shape)
        else:
            row = torch.full(shape, dead, dtype=x_flat.dtype, device=dev)
        return torch.cat([x_flat, row])[idx]

    return {"slot_live": slot_live, "overflow": overflow,
            "mapper": (keep, pos, perm, cap), "gsel": gsel, "sort": sort}


def _flatten(values) -> tuple:
    """Nested lists or tuples of numbers as one flat tuple."""
    if isinstance(values, (list, tuple)):
        return sum((_flatten(v) for v in values), ())
    return (values,)


def _slots_to_space(slot_vals, fill, mapper):
    """(cap, C) slot values -> (ns, C) input-space values: un-permute to
    the pre-sort slot order, then gather each kept element's slot."""
    keep, pos, perm, cap = mapper
    vals = slot_vals
    if perm is not None:
        vals = torch.empty_like(slot_vals)
        vals[perm] = slot_vals
    vals = torch.cat([vals, torch.full((1,) + vals.shape[1:], fill,
                                       dtype=vals.dtype, device=vals.device)])
    return vals[torch.where(keep, pos, cap)]


def _trace_deep_compact(scene, table, cfg, origin, l_dir, throughput,
                        rng, active, start_bounce: int, accel, cap: int,
                        end_bounce: int | None = None, di_valid=None,
                        want_aov: bool = False, return_state: bool = False,
                        pixel_ids=None, img_hw=None, wave: int = 0,
                        sharc_args=None, rough=None):
    """Bounces [start_bounce, end_bounce] (default cfg.bounces) on the
    compacted survivor buffer.

    The input is (H, W, ...) pixel-space state, or a previous segment's
    flat (ns, ...) slot state with `pixel_ids` (each element's true pixel)
    and `img_hw`. `sharc_args` is (state, config, camera position) where
    the cache is queried, `rough` the paths' accumulated roughness.
    `di_valid` suppresses bounce-1 emission where ReSTIR's direct light
    was added at the primary vertex; `want_aov` returns the first trace's
    hit distance; `return_state` returns the continuation state in slot
    space (with its pixel ids) for the next segment. Returns a dict with
    the radiance, the rays cast, the overflow count, the SHARC counters
    and the mapper; arrays are (H, W, ...) for pixel-space input, flat
    otherwise."""
    if end_bounce is None:
        end_bounce = cfg.bounces
    pixel_space = pixel_ids is None
    h, w = active.shape if img_hw is None else img_hw
    ns = active.numel()
    cs = _compact_slots(active.reshape(ns), l_dir.reshape(ns, 3), pixel_ids,
                        cfg, cap, h, w, wave=wave)
    gsel = cs["gsel"]
    c_origin = gsel(origin.reshape(ns, 3), 0.0)
    c_dir = gsel(l_dir.reshape(ns, 3), (0.0, 0.0, 1.0))
    c_thr = gsel(throughput.reshape(ns, 3), 0.0)
    c_rng = gsel(rng.reshape(ns), 0)
    c_rough = gsel(rough.reshape(ns), 0.0) if sharc_args else None
    c_di = (gsel(di_valid.reshape(ns), False) if di_valid is not None
            else None)
    slot_live = cs["slot_live"]
    c_active = slot_live
    c_radiance = torch.zeros((cap, 3), dtype=torch.float32,
                             device=active.device)
    c_hitdist = None
    zeros_c = torch.zeros(cap, dtype=torch.float32, device=active.device)
    rays = torch.zeros((), dtype=torch.float32, device=active.device)
    counters = {}

    for bounce in range(start_bounce, end_bounce + 1):
        rays = rays + c_active.sum()
        surf = trace_mod.trace_scene(
            scene, c_origin, c_dir, zeros_c,
            torch.where(c_active, float("inf"), -1.0), cfg.block_size,
            accel=accel, table=table, alpha_rounds=scene.alpha_test_rounds)
        if want_aov and bounce == start_bounce:
            c_hitdist = torch.where(surf.valid, surf.distance, float("inf"))
        env_color = sky.environment_color(
            scene.env, c_dir, wide=bounce >= cfg.texture_bounces)
        miss = c_active & ~surf.valid
        c_radiance = c_radiance + torch.where(miss[..., None],
                                              c_thr * env_color, 0.0)
        c_active = c_active & surf.valid

        if sharc_args and bounce >= cfg.sharc_query_from:
            use_cache, cached = _sharc_lookup(*sharc_args, surf, c_active,
                                              c_rough, bounce, counters)
            c_radiance = c_radiance + torch.where(use_cache[..., None],
                                                  c_thr * cached, 0.0)
            c_active = c_active & ~use_cache

        atlas_b = scene.textures if bounce < cfg.texture_bounces else None
        if bounce == cfg.bounces:
            emission = shading.evaluate_material(
                surf.material, surf.uv, surf.shading_normal,
                surf.tangent, atlas_b, "nearest").emission
            if c_di is not None and bounce == 1:
                emission = torch.where(c_di[..., None], 0.0, emission)
            c_radiance = c_radiance + torch.where(c_active[..., None],
                                                  c_thr * emission, 0.0)
            break

        emission, new_dir, weight, valid, lobe, bs, c_rng = \
            _shade_and_scatter(surf, c_dir, c_rng, textures=atlas_b)
        if c_di is not None and bounce == 1:
            # DI already sampled this light at the primary vertex
            # (Raytracing.hlsl:302).
            emission = torch.where(c_di[..., None], 0.0, emission)
        c_radiance = c_radiance + torch.where(c_active[..., None],
                                              c_thr * emission, 0.0)
        c_thr = c_thr * weight
        c_active = c_active & valid
        if c_rough is not None:
            c_rough = _rough_step(c_rough, lobe, bs)
        c_thr, c_active, c_rng = _roulette_and_cutoff(cfg, bounce, c_thr,
                                                      c_active, c_rng)
        c_origin = intersect.safe_spawn_point(surf.position,
                                              surf.geometric_normal, new_dir)
        c_dir = new_dir

    mapper = cs["mapper"]

    def to_space(slot_vals, fill):
        vals = _slots_to_space(slot_vals, fill, mapper)
        return vals.reshape((h, w) + vals.shape[1:]) if pixel_space else vals

    contrib = torch.where(slot_live[..., None], c_radiance, 0.0)
    out = {"radiance": to_space(contrib, 0.0), "rays": rays,
           "overflow": cs["overflow"], "counters": counters,
           "mapper": mapper}
    if c_hitdist is not None:
        out["hit_distance"] = to_space(c_hitdist[:, None],
                                       float("inf"))[..., 0]
    if return_state:
        # The next segment re-compacts straight from these slots; the
        # pixel ids keep each path's true pixel for its tile keys.
        pix = (torch.arange(ns, device=active.device) if pixel_space
               else pixel_ids)
        out["state"] = {"origin": c_origin, "dir": c_dir,
                        "throughput": c_thr, "roughness": c_rough,
                        "rng": c_rng, "active": c_active,
                        "pixel_ids": gsel(pix, h * w)}
    return out


# The spill decision's hook: None decides in _spill itself. A frame run
# as CUDA graphs (drts_tpu_torch/graphs.py) sets it, through spill_hook,
# to end the captured piece at the decision, capture the second wave as a
# piece of its own and start the next piece: the counterpart of the
# reference's lax.cond (drts_tpu/ops/pathtrace.py:640-670).
_SPILL_HOOK = None


@contextlib.contextmanager
def spill_hook(fn):
    """Route every spill decision made inside the block to
    fn(overflow, wave1) -> the waves it ran (0 or 1)."""
    global _SPILL_HOOK
    prev, _SPILL_HOOK = _SPILL_HOOK, fn
    try:
        yield
    finally:
        _SPILL_HOOK = prev


def _spill(overflow, wave1) -> int:
    """Run wave1 (the second wave, which merges into the first wave's
    outputs in place) when the 0-d device count `overflow` is above 0:
    one host read. Returns the waves run."""
    if _SPILL_HOOK is not None:
        return _SPILL_HOOK(overflow, wave1)
    if overflow.item() > 0:
        wave1()
        return 1
    return 0


def _deep_with_spill(scene, table, cfg, origin, l_dir, throughput, rng,
                     active, start_bounce, accel, cap, sharc_args=None,
                     rough=None, pixel_ids=None, img_hw=None):
    """The terminal deep segment plus, with cfg.overflow_spill and when it
    overflowed, a second wave over the dropped lanes (``_spill``); only
    paths beyond 2x capacity then drop. The second wave adds into the
    first's radiance, rays and counters and replaces its overflow count,
    in place. The result's "spill_waves" says whether it ran, its
    "spill_count" the same on the device."""
    args = (scene, table, cfg, origin, l_dir, throughput, rng, active,
            start_bounce, accel, cap)
    kw = {"sharc_args": sharc_args, "rough": rough, "pixel_ids": pixel_ids,
          "img_hw": img_hw}
    seg = _trace_deep_compact(*args, **kw)
    waves, count = 0, torch.zeros_like(seg["overflow"], dtype=torch.float32)
    if cfg.overflow_spill:
        count = (seg["overflow"] > 0).to(torch.float32)
        def wave1():
            s2 = _trace_deep_compact(*args, wave=1, **kw)
            seg["radiance"].add_(s2["radiance"])
            seg["rays"].add_(s2["rays"])
            seg["overflow"].copy_(s2["overflow"])
            for k, v in seg["counters"].items():
                v.add_(s2["counters"][k])
        waves = _spill(seg["overflow"], wave1)
    return dict(seg, spill_waves=waves, spill_count=count)


def trace_image(scene: scene_mod.SphereScene, cam: camera_mod.Camera,
                cfg: PathTraceConfig, frame_index, gbuf=None,
                sharc_state=None, sharc_cfg=None, di_radiance=None,
                di_in_radiance: bool = True, accel=None,
                rows=None) -> TraceOutput:
    """Render one frame's path-traced radiance (plus AOVs).

    With a G-buffer the primary hit is reused from it instead of re-traced
    (Raytracing.hlsl:118-163). ``di_radiance`` (H, W, 3) is ReSTIR's
    direct light at the primary vertex (Raytracing.hlsl:150-163): where it
    is positive on a primary hit, bounce-1 emission is suppressed, and with
    ``di_in_radiance`` (the denoiser-off routing, Raytracing.hlsl:379-385)
    it is added to the radiance. With ``sharc_state`` (and its
    ``sharc_cfg``), hits from bounce ``cfg.sharc_query_from`` on end into
    the cache where it holds their voxel. ``rows`` = (start, end) traces
    that band of the cfg.height-row frame: its pixels' NDC and streams
    are the whole frame's, and the outputs, the G-buffer and
    ``di_radiance`` are (end - start, W, ...); the compaction packs the
    band's pixels into the whole frame's capacity."""
    sharc_args = None
    if sharc_state is not None:
        sharc_args = (sharc_state, sharc_cfg, cam.position)
    w = cfg.width
    r0, r1 = rows if rows is not None else (0, cfg.height)
    h = r1 - r0
    dev = scene.center.device
    ndc = camera_mod.pixel_ndc(w, cfg.height, cam.jitter, rows)
    ray_o0, ray_d0, t_min0, t_max0 = camera_mod.generate_pinhole_rays(cam,
                                                                      ndc)
    t_min0 = torch.broadcast_to(t_min0, (h, w))
    t_max0 = torch.broadcast_to(t_max0, (h, w))
    py, px = torch.meshgrid(torch.arange(r0, r1, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    table = scene_mod.object_table(scene)

    if gbuf is not None:
        primary_surf = gbuf.surf
        ray_d0 = gbuf.ray_direction
        p_mat = gbuf.mat
        p_albedo, p_f_env = gbuf.diffuse_albedo, gbuf.specular_albedo
    else:
        primary_surf = trace_mod.trace_scene(
            scene, ray_o0, ray_d0, t_min0, t_max0, cfg.block_size,
            accel=accel, table=table, alpha_rounds=scene.alpha_test_rounds)
        p_mat = shading.evaluate_material(
            primary_surf.material, primary_surf.uv,
            primary_surf.shading_normal, primary_surf.tangent,
            scene.textures)
        p_sv = bxdf.make_surface_vectors(primary_surf.is_front_face,
                                         primary_surf.geometric_normal,
                                         p_mat.shading_normal)
        p_bs = bxdf.make_bsdf(p_mat.base_color, p_mat.metallic,
                              p_mat.roughness, p_mat.ior, p_mat.transmission,
                              primary_surf.is_front_face)
        p_albedo, p_f_env = bxdf.demodulation_factors(p_bs, p_sv, -ray_d0)
    primary_hit = primary_surf.valid

    radiance = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    is_diffuse = torch.ones((h, w), dtype=torch.bool, device=dev)
    hit_distance = torch.full((h, w), float("inf"), device=dev)
    rays_traced = torch.full((), float(h * w), device=dev)
    counters = {"wavefront_overflow_paths":
                torch.zeros((), dtype=torch.float32, device=dev)}
    spill_waves = 0
    spill_count = torch.zeros((), dtype=torch.float32, device=dev)

    use_compact = 1 <= cfg.compact_from <= cfg.bounces
    dense_last = cfg.compact_from - 1 if use_compact else cfg.bounces
    # The whole frame's deep-segment capacity (at most the band's pixels):
    # a band then spills only where the whole frame would.
    cap = cfg.compact_capacity or min(
        _compact_capacity(cfg.height * w, cfg.compact_fraction),
        _compact_capacity(h * w, 1))
    cap_first = _compact_capacity(h * w, cfg.compact_fraction_first)

    if di_radiance is not None:
        di_valid = primary_hit & (torch.sum(di_radiance, dim=-1) > 0.0)
    else:
        di_valid = torch.zeros((h, w), dtype=torch.bool, device=dev)

    for sample_index in range(cfg.samples_per_pixel):
        rng = rng_mod.init(px, py,
                           frame_index * cfg.samples_per_pixel + sample_index)
        sample_radiance = torch.zeros((h, w, 3), dtype=torch.float32,
                                      device=dev)
        if di_radiance is not None and di_in_radiance:
            sample_radiance = sample_radiance + torch.where(
                di_valid[..., None], di_radiance, 0.0)
        throughput = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
        active = torch.ones((h, w), dtype=torch.bool, device=dev)
        rough = torch.zeros((h, w), dtype=torch.float32, device=dev)
        ray_d = ray_d0
        surf = primary_surf
        hit_ok = primary_hit

        for bounce in range(dense_last + 1):
            if bounce > 0:
                rays_traced = rays_traced + active.sum()
                origin = intersect.safe_spawn_point(
                    surf.position, surf.geometric_normal, l_dir)
                # Dead lanes get tmax < tmin.
                surf = trace_mod.trace_scene(
                    scene, origin, l_dir,
                    torch.zeros((h, w), device=dev),
                    torch.where(active, float("inf"), -1.0), cfg.block_size,
                    accel=accel, table=table,
                    alpha_rounds=scene.alpha_test_rounds)
                ray_d = l_dir
                hit_ok = surf.valid
                if sample_index == 0 and bounce == 1:
                    is_diffuse = lobe == bxdf.LOBE_DIFFUSE
                    hit_distance = torch.where(hit_ok, surf.distance,
                                               float("inf"))

            # Miss -> environment light, terminate (Raytracing.hlsl:241-259).
            env_color = sky.environment_color(
                scene.env, ray_d, wide=bounce >= cfg.texture_bounces)
            miss = active & ~hit_ok
            sample_radiance = sample_radiance + torch.where(
                miss[..., None], throughput * env_color, 0.0)
            active = active & hit_ok

            if sharc_args and bounce >= max(cfg.sharc_query_from, 1):
                use_cache, cached = _sharc_lookup(*sharc_args, surf, active,
                                                  rough, bounce, counters)
                sample_radiance = sample_radiance + torch.where(
                    use_cache[..., None], throughput * cached, 0.0)
                active = active & ~use_cache

            atlas_b = scene.textures if bounce < cfg.texture_bounces \
                else None
            if bounce == cfg.bounces:
                # Last iteration only adds emission (no scatter needed).
                mat = p_mat if bounce == 0 else shading.evaluate_material(
                    surf.material, surf.uv, surf.shading_normal,
                    surf.tangent, atlas_b, "nearest")
                emission = mat.emission
                if bounce == 1:
                    emission = torch.where(di_valid[..., None], 0.0,
                                           emission)
                sample_radiance = sample_radiance + torch.where(
                    active[..., None], throughput * emission, 0.0)
                break

            emission, l_dir, weight, valid, lobe, bs, rng = \
                _shade_and_scatter(surf, ray_d, rng,
                                   mat=p_mat if bounce == 0 else None,
                                   textures=atlas_b)
            if bounce == 1:
                # DI already sampled this light at the primary vertex
                # (Raytracing.hlsl:302).
                emission = torch.where(di_valid[..., None], 0.0, emission)
            sample_radiance = sample_radiance + torch.where(
                active[..., None], throughput * emission, 0.0)
            throughput = throughput * weight
            active = active & valid
            if sharc_args:
                rough = _rough_step(rough, lobe, bs)
            throughput, active, rng = _roulette_and_cutoff(
                cfg, bounce, throughput, active, rng)

        if use_compact:
            origin = intersect.safe_spawn_point(
                surf.position, surf.geometric_normal, l_dir)

            def fold(seg, through=None):
                """Add a segment's outputs; `through` is the segment in
                whose slot space this one ran."""
                nonlocal sample_radiance, rays_traced, hit_distance
                nonlocal spill_waves, spill_count
                rad = seg["radiance"]
                if through is not None:
                    rad = _slots_to_space(rad, 0.0,
                                          through["mapper"]).reshape(h, w, 3)
                sample_radiance = sample_radiance + rad
                rays_traced = rays_traced + seg["rays"]
                counters["wavefront_overflow_paths"] = (
                    counters["wavefront_overflow_paths"] + seg["overflow"])
                for k, v in seg["counters"].items():
                    counters[k] = counters.get(k, 0.0) + v
                if "hit_distance" in seg:
                    hit_distance = seg["hit_distance"]
                spill_waves += seg.get("spill_waves", 0)
                if "spill_count" in seg:
                    spill_count = spill_count + seg["spill_count"]

            if cfg.compact_from == 1:
                # The bounce-1 AOVs: the first scatter's lobe is bounce-0
                # state; the hit distance comes back from the segment.
                if sample_index == 0:
                    is_diffuse = lobe == bxdf.LOBE_DIFFUSE
                two_segment = cfg.bounces >= 2
                seg = _trace_deep_compact(
                    scene, table, cfg, origin, l_dir, throughput, rng,
                    active, 1, accel, cap_first,
                    end_bounce=1 if two_segment else cfg.bounces,
                    di_valid=di_valid, want_aov=sample_index == 0,
                    return_state=two_segment, sharc_args=sharc_args,
                    rough=rough)
                fold(seg)
                if two_segment:
                    # The deep segment cascades in the bounce-1 segment's
                    # slot space.
                    st = seg["state"]
                    fold(_deep_with_spill(
                        scene, table, cfg, st["origin"], st["dir"],
                        st["throughput"], st["rng"], st["active"], 2, accel,
                        cap, sharc_args, st["roughness"],
                        pixel_ids=st["pixel_ids"], img_hw=(h, w)),
                        through=seg)
            else:
                fold(_deep_with_spill(scene, table, cfg, origin, l_dir,
                                      throughput, rng, active,
                                      cfg.compact_from, accel, cap,
                                      sharc_args, rough))

        # NaN guard (Raytracing.hlsl:377).
        finite = torch.all(torch.isfinite(sample_radiance), dim=-1,
                           keepdim=True)
        radiance = radiance + torch.where(finite, sample_radiance, 0.0)

    radiance = radiance / cfg.samples_per_pixel
    if gbuf is not None:
        primary_radiance = gbuf.radiance
    else:
        env0 = sky.environment_color(scene.env, ray_d0)
        primary_radiance = torch.where(primary_hit[..., None],
                                       p_mat.emission, env0)
    return TraceOutput(
        radiance=radiance, is_diffuse=is_diffuse, hit_distance=hit_distance,
        primary_valid=primary_hit, primary_position=primary_surf.position,
        primary_normal=p_mat.shading_normal, primary_albedo=p_albedo,
        primary_f_env=p_f_env, primary_radiance=primary_radiance,
        rays_traced=rays_traced, counters=counters, spill_waves=spill_waves,
        spill_count=spill_count)


def trace_image_graph(cfg: PathTraceConfig, plan=None,
                      accel: str = "morton", rows=None):
    """The counterpart of the reference's ``trace_image_jit``: a callable
    ``(scene, cam, frame_index) -> TraceOutput`` that runs the frame as
    CUDA graph replays, split at the spill decision (``graphs.TraceGraph``;
    with a cluster `plan`, the headline bench's frame on the `accel` it is
    a plan of, "morton" or "clustered": accel, G-buffer, trace; with
    `rows` = (start, end), that band of the frame, as ``trace_image``'s
    `rows`)."""
    from .. import graphs
    return graphs.TraceGraph(cfg, plan, accel, rows)


def sharc_update_trace(scene: scene_mod.SphereScene, cam: camera_mod.Camera,
                       sharc_state, sharc_cfg, cfg: PathTraceConfig,
                       frame_index, di_radiance=None, accel=None,
                       band=None, slots=None, di_small=None):
    """The SHARC_UPDATE pass: a trace at the downscaled size (cfg.width and
    cfg.height are already downscaled) whose path radiance is splatted into
    the cache, then resolved (Raytracing.hlsl's SHARC_UPDATE permutation,
    Raytracing.ixx:114-148).

    The shader's in-flight accumulation becomes a record per bounce of
    (slot, fingerprint, emitted radiance, segment throughput), closed by a
    backward scan L_v = E_v + T_v * L_{v+1} and one splat of every level.
    Rays take a random sub-pixel jitter (Raytracing.hlsl:111-112) and the
    BSDF roughness is floored at the config's roughness threshold. Returns
    (new SHARCState, {"sharc_splat_dropped_rows": scalar}).

    With cfg.compact_from == 1 the paths are compacted and octant-sorted
    once after bounce 0, as in the main trace; their slots then stay
    fixed, so the records of bounces >= 1 and the backward scan are in
    slot space, and only level 1 -> 0 crosses back to pixel space.

    On the sharded frame this rank traces ``band`` (a Band of the
    downscaled frame's rows; ``di_small`` is the DI resized to its rows,
    in place of ``di_radiance``) and splats its rows; ``splat_levels``
    reduce-scatters the splat into the ``slots`` ranges, and the resolve
    updates this rank's range of `sharc_state` (which holds that range),
    so the returned cache holds it too. The dropped rows are all
    ranks'."""
    w = cfg.width
    rows = band.span() if band is not None else None
    r0, r1 = rows if rows is not None else (0, cfg.height)
    h = r1 - r0
    dev = scene.center.device
    py, px = torch.meshgrid(torch.arange(r0, r1, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    rng = rng_mod.init(px + 131, py + 173, frame_index)
    jit2, rng = rng_mod.next_floats(rng, 2)
    ndc = camera_mod.pixel_ndc(w, cfg.height, torch.zeros(2, device=dev),
                               rows)
    jitter_ndc = ((jit2 - 0.5) * m.const((2.0, -2.0), device=dev)
                  / m.const((w, cfg.height), device=dev))
    ray_o, ray_d, t_min, t_max = camera_mod.generate_pinhole_rays(
        cam, ndc + jitter_ndc)
    t_min = torch.broadcast_to(t_min, (h, w))
    t_max = torch.broadcast_to(t_max, (h, w))
    table = scene_mod.object_table(scene)
    if di_small is None and di_radiance is not None:
        di_small = post.resize_bilinear(di_radiance, cfg.height, w)

    # Per bounce: emissions[b] is the radiance emitted at level b (the hit's
    # emission, or once, at the miss level, the environment);
    # seg_weights[b] is zero where the path does not go on.
    slot_ids, fps, emissions, seg_weights, actives = [], [], [], [], []
    active = torch.ones((h, w), dtype=torch.bool, device=dev)
    l_dir = ray_d
    surf = trace_mod.trace_scene(scene, ray_o, ray_d, t_min, t_max,
                                 cfg.block_size, accel=accel, table=table,
                                 alpha_rounds=scene.alpha_test_rounds)
    use_compact = cfg.compact_from == 1 and cfg.bounces >= 1
    mapper = origin = None
    for bounce in range(cfg.bounces + 1):
        if bounce > 0:
            if origin is None:
                origin = intersect.safe_spawn_point(
                    surf.position, surf.geometric_normal, l_dir)
            surf = trace_mod.trace_scene(
                scene, origin, l_dir,
                torch.zeros(active.shape, device=dev),
                torch.where(active, float("inf"), -1.0), cfg.block_size,
                accel=accel, table=table,
                alpha_rounds=scene.alpha_test_rounds)
            origin = None
        miss = active & ~surf.valid
        env_color = sky.environment_color(
            scene.env, l_dir, wide=bounce >= cfg.texture_bounces)
        live = active & surf.valid
        slot, fp = sharc.cache_key(surf.position, _front_normal(surf),
                                   cam.position, sharc_cfg)
        atlas_b = scene.textures if bounce < cfg.texture_bounces else None
        if bounce == cfg.bounces:
            mat = shading.evaluate_material(surf.material, surf.uv,
                                            surf.shading_normal,
                                            surf.tangent, atlas_b, "nearest")
            emission = mat.emission
            l_dir_new = l_dir
            weight = torch.zeros(active.shape + (3,), dtype=torch.float32,
                                 device=dev)
            valid = torch.zeros(active.shape, dtype=torch.bool, device=dev)
        else:
            emission, l_dir_new, weight, valid, _, _, rng = \
                _shade_and_scatter(surf, l_dir, rng,
                                   min_roughness=sharc_cfg.roughness_threshold,
                                   textures=atlas_b)
        if di_small is not None and bounce == 0:
            emission = emission + di_small
        emissions.append(torch.where(
            live[..., None], emission,
            torch.where(miss[..., None], env_color, 0.0)))
        slot_ids.append(slot)
        fps.append(fp)
        seg_weights.append(torch.where((live & valid)[..., None], weight,
                                       0.0))
        actives.append(live)
        active = live & valid
        l_dir = l_dir_new

        if use_compact and bounce == 0:
            ns = h * w
            origin0 = intersect.safe_spawn_point(
                surf.position, surf.geometric_normal, l_dir)
            cs = _compact_slots(active.reshape(ns), l_dir.reshape(ns, 3),
                                None, cfg, _compact_capacity(ns, 1), h, w)
            gsel, mapper = cs["gsel"], cs["mapper"]
            origin = gsel(origin0.reshape(ns, 3), 0.0)
            l_dir = gsel(l_dir.reshape(ns, 3), (0.0, 0.0, 1.0))
            rng = gsel(rng.reshape(ns), 0)
            active = cs["slot_live"]

    # Backward scan: L_v = E_v + T_v * L_{v+1}, then one splat of all
    # levels.
    radiance_next = torch.zeros_like(emissions[-1])
    level_radiance = [None] * len(slot_ids)
    for b in range(len(slot_ids) - 1, -1, -1):
        if radiance_next.shape != emissions[b].shape:
            # Slot space (level 1) -> pixel space (level 0).
            radiance_next = _slots_to_space(radiance_next, 0.0,
                                            mapper).reshape(
                emissions[b].shape)
        l_here = emissions[b] + seg_weights[b] * radiance_next
        l_here = torch.where(torch.isfinite(l_here), l_here, 0.0)
        level_radiance[b] = l_here
        radiance_next = l_here

    capacity = (slots.height if slots is not None
                else sharc_state.fingerprint.shape[0])
    acc = (torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
           torch.zeros(capacity, dtype=torch.float32, device=dev),
           torch.zeros(capacity, dtype=torch.int64, device=dev))
    frame_sum, frame_count, frame_fp, dropped = sharc.splat_levels(
        acc, slot_ids, fps, level_radiance, actives, slots)
    new_state = sharc.resolve(sharc_state, frame_sum, frame_count, frame_fp,
                              sharc_cfg)
    return new_state, {"sharc_splat_dropped_rows":
                       dropped.to(torch.float32)}
