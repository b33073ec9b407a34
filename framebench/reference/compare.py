"""The comparison that decides ``correct``: what the timed path produced
on the checked frames against the plain reference, number by number,
each against its limit in ``checks/<workload>.json``.

The numbers (each the worst over the checked frames):

- ``pose_gap_m``: the widest gap, in metres, between a body's position
  after the frame's physics and the reference's, stepped in float64 from
  the scene's start through as many steps;
- ``rotation_gap``: the same for the rotation quaternions' components;
- ``depth_gap_p999``: the 99.9th percentile over sampled pixels of the
  relative gap between the frame's primary-hit linear depth and the
  reference's closest hit of the same jittered camera ray (1e8 on a
  miss, as the frame stores it);
- ``post_gap``: the widest gap between the output image and the
  reference's display pass (sharpen, bloom, tone map) of the frame's own
  upscaled colour, the program's state that the pass reads;
- ``radiance_tile_gap``: the mean over a grid of tiles of the relative
  gap between the luminance of the frame's upscaled colour and the
  reference path tracer's converged estimate of the same frame;
- ``start_gap``: the widest relative gap between the program's scene
  start (materials, radii, bodies) and the one the reference builds from
  the demo's layout (``scene.demo_start``), which it renders and steps;
- ``replica_gap`` (sharded frames): the widest gap between a replicated
  body position on any rank and rank 0's.

``control_outputs`` computes the same outputs with the reference itself in
bfloat16, the precision below the configuration's float32, for the
control that has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

from . import physics, post, render, scene

DEPTH_MISS = 1e8


def bodies_of(inputs: dict, dtype, device) -> dict:
    b = inputs["bodies"]
    out = {}
    for k, v in b.items():
        if isinstance(v, np.ndarray):
            t = torch.as_tensor(v, device=device)
            out[k] = t.to(dtype) if t.is_floating_point() else t
        else:
            out[k] = v
    return out


def reference_bodies(inputs, steps, dtype, device):
    """{n: bodies after n steps} for each n in `steps` (the start itself
    where the configuration runs no physics)."""
    start = bodies_of(inputs, dtype, device)
    if not inputs["physics"]:
        return {n: start for n in steps}
    return physics.advance(start, max(steps), inputs["dt"], keep=set(steps))


def jitter_of(inputs: dict, frame_index: int):
    return inputs["jitter"][frame_index % len(inputs["jitter"])]


def depth_pixels(inputs, check, gen, device):
    h, w = inputs["render_size"][1], inputs["render_size"][0]
    n = min(int(check["depth_pixels"]), h * w)
    flat = torch.randperm(h * w, generator=gen, device="cpu")[:n].to(device)
    return flat // w, flat % w


def reference_depth(inputs, frame, bodies, py, px, dtype):
    """Linear depth of the closest hit of each jittered primary ray."""
    w, h = inputs["render_size"]
    scene = render.Scene(inputs, bodies["position"], bodies["rotation"],
                         dtype, py.device)
    o, d, f = render.camera_rays(frame["pose"][0], frame["pose"][1], w, h,
                                 px, py, jitter_of(inputs, frame["frame_index"]),
                                 inputs["hfov_deg"], dtype)
    t, _, _, _ = scene.hit(o, d, t_min=0.0)
    depth = t * (d * f).sum(-1)
    return torch.where(torch.isfinite(t), depth,
                       torch.full_like(depth, DEPTH_MISS))


def tile_luminance(img, tiles):
    """(ty, tx) mean luminance of an (H, W, 3) image over a tile grid."""
    tx, ty = tiles
    h, w = img.shape[0], img.shape[1]
    x = img[: h - h % ty, : w - w % tx].to(torch.float64)
    x = x.reshape(ty, h // ty, tx, w // tx, 3).mean(dim=(1, 3))
    return render.luminance(x)


def reference_tiles(inputs, frame, bodies, check, gen, dtype, device):
    """Tile-mean luminance of the reference path tracer over the output
    image: ``ref_spp`` paths per ``ref_stride``-pixel cell, each through a
    uniform point of its cell."""
    ow, oh = inputs["output_size"]
    s = int(check["ref_stride"])
    spp = int(check["ref_spp"])
    tx, ty = check["tiles"]
    scene = render.Scene(inputs, bodies["position"], bodies["rotation"],
                         dtype, device)
    gy, gx = torch.meshgrid(torch.arange(oh // s, device=device),
                            torch.arange(ow // s, device=device),
                            indexing="ij")
    acc = torch.zeros((oh // s, ow // s, 3), dtype=torch.float64,
                      device=device)
    for _ in range(spp):
        u = torch.rand((oh // s, ow // s, 2), generator=gen, device=device)
        px = (gx + u[..., 0]) * s - 0.5
        py = (gy + u[..., 1]) * s - 0.5
        o, d, _ = render.camera_rays(frame["pose"][0], frame["pose"][1], ow,
                                     oh, px.double(), py.double(), (0.0, 0.0),
                                     inputs["hfov_deg"], torch.float64)
        rad = render.trace(scene, o.reshape(-1, 3).to(dtype),
                           d.reshape(-1, 3).to(dtype),
                           int(check["ref_bounces"]), gen)
        acc += rad.reshape(oh // s, ow // s, 3).to(torch.float64)
    return tile_luminance(acc / spp, (tx, ty))


def reference_start(inputs) -> dict:
    return {k: inputs[k] for k in scene.START_KEYS}


def _bf16(x):
    if isinstance(x, dict):
        return {k: _bf16(v) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype.kind != "f":
        return x
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


def control_outputs(inputs, frames, check, seed, device):
    """The checked frames' outputs as the reference computes them in
    bfloat16, in the program's place (each frame's upscaled colour, which
    the display pass reads, stays the program's)."""
    bf = torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 17)
    steps = [f["steps"] for f in frames]
    ref = reference_bodies(inputs, steps, bf, device)
    out = []
    w, h = inputs["render_size"]
    for f in frames:
        b = ref[f["steps"]]
        py, px = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device),
                                indexing="ij")
        depth = reference_depth(inputs, f, b, py.reshape(-1), px.reshape(-1),
                                bf).reshape(h, w).float()
        image = post.display(f["hdr"].to(bf), inputs["post"]).float()
        tiles = reference_tiles(inputs, f, b, check, gen, bf, device)
        out.append(dict(f, start=_bf16(reference_start(inputs)),
                        position=b["position"].float(),
                        rotation=b["rotation"].float(), depth=depth,
                        image=image, tiles=tiles))
    return out


def numbers(inputs, frames, check, seed, device):
    """([(name, worst value, limit)], frames that failed, each frame's
    numbers) over the checked `frames` (dicts of the frame's outputs, on
    `device`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 29)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(seed)
    steps = [f["steps"] for f in frames]
    ref = reference_bodies(inputs, steps, torch.float64, device)
    limits = {k: float(v) for k, v in check["limits"].items()}
    worst, failed, each = {}, 0, []
    for f in frames:
        got = frame_numbers(inputs, f, ref[f["steps"]], check, gen, cpu_gen)
        each.append(got)
        for name, v in got.items():
            if v != v:              # NaN: no reading is a failed one
                v = float("inf")
            worst[name] = max(worst.get(name, 0.0), v)
        failed += any(not got.get(n, float("inf")) <= lim
                      for n, lim in limits.items())
    return [(n, worst.get(n, float("inf")), lim)
            for n, lim in limits.items()], failed, each


def frame_numbers(inputs, f, b, check, gen, cpu_gen) -> dict:
    """The compared numbers of one frame against the reference bodies
    `b` after as many steps."""
    out = {
        "start_gap": scene.start_gap(f.get("start", inputs["program_start"]),
                                     reference_start(inputs)),
        "pose_gap_m": (f["position"].double() - b["position"]).abs().max(),
        "rotation_gap": (f["rotation"].double() - b["rotation"]).abs().max()}
    py, px = depth_pixels(inputs, check, cpu_gen, f["depth"].device)
    want = reference_depth(inputs, f, b, py, px, torch.float64)
    got = f["depth"][py, px].double()
    rel = (got - want).abs() / torch.clamp(want.abs(), min=1e-6)
    out["depth_gap_p999"] = torch.quantile(rel.float(), 0.999)
    shown = post.display(f["hdr"].double(), inputs["post"])
    out["post_gap"] = (f["image"].double() - shown).abs().max()
    if not bool(torch.isfinite(f["image"]).all()):
        out["post_gap"] = float("inf")
    ref_tiles = reference_tiles(inputs, f, b, check, gen, torch.float32,
                                f["depth"].device)
    got_tiles = f["tiles"] if "tiles" in f else tile_luminance(
        f["hdr"], check["tiles"])
    gap = (got_tiles - ref_tiles).abs() / torch.clamp(
        ref_tiles, min=float(check["lum_floor"]))
    out["radiance_tile_gap"] = gap.mean()
    if "replica_gap" in f:
        out["replica_gap"] = f["replica_gap"]
    return {k: float(v) for k, v in out.items()}
