"""Fidelity harness of the port (``drts_tpu/fidelity.py``): SSIM of the
real-time pipeline against a high-spp accumulated reference render.

The reference render is the port's own unbiased path tracer run with
camera-jittered accumulation and no denoising or post, the ground truth
the reference's converged DXR output stands for. The candidate is the
real-time configuration (1 spp, ReSTIR, SHARC, denoise, TAA), compared
after the same tone mapping. ``load_textures=True``, the default as in
the reference, builds the scene as the reference does (models/assets.py):
textured where the reference's texture files load, untextured where they
are absent, under the same cache key. A result's ``"textures"`` says whether its scene held
textures; an untextured run is not comparable with a textured bar.

Converged references are cached as ``.npz`` in ``ref_cache_dir()``, the
port's own directory: a port run never scores itself against a reference
rendered by the JAX package.

    python -m drts_tpu_torch.fidelity [--width W --height H --spp N
        --frames F] [--motion | --mesh] [--save DIR] [--crosscheck-spp N]
        [--record FILE]

prints the result dict as its last line. Runs on the card.
"""

from __future__ import annotations

import dataclasses
import getpass
import json
import os
import sys
import tempfile
import time

import numpy as np


def ref_cache_dir() -> str:
    """The port's converged-reference directory,
    ``<tempdir>/drts_torch_fid_refs_<user>``."""
    try:
        user = getpass.getuser()
    except Exception:  # no passwd entry in minimal containers
        user = f"uid{os.getuid()}" if hasattr(os, "getuid") else "user"
    return os.path.join(tempfile.gettempdir(), f"drts_torch_fid_refs_{user}")


DEFAULT_REF_CACHE = ref_cache_dir()

# The real-time configuration scored by every run: the pipeline's
# defaults at native size without the post effects the ground truth lacks
# (bloom glow, sharpen overshoot), physics off, block 32,768.
REALTIME_OVERRIDES = dict(bounces=8, samples_per_pixel=1, upscaling=False,
                          physics_enabled=False, block_size=32768,
                          bloom_enabled=False, sharpen_enabled=False)


def _note(msg: str):
    """Progress to stderr: a fidelity run is minutes of silent device
    work."""
    print(f"fidelity[{time.strftime('%H:%M:%S')}]: {msg}", file=sys.stderr,
          flush=True)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_render(host, width: int, height: int, spp_total: int = 1024,
                     bounces: int = 8, block_size: int = 32768,
                     position=None, forward=None, device="cuda"):
    """Accumulated ground-truth render (no denoise, no physics motion):
    frame fi takes Halton jitter fi mod 64; frames run in chunks of 32, so
    spp_total rounds up to a multiple of 32, and the sum is divided by
    that count. The accumulator stays on the device in float32 and is
    divided in float64 on the host. On a CUDA device a scene with spheres
    traces through the Morton accel (built once per chunk; the scene is
    static); on the CPU, or with no spheres, through no accel."""
    import torch

    from . import backend
    from .models import clusters
    from .ops import camera as camera_mod, pathtrace
    from .utils import rng as rng_mod

    dev = backend.device(device)
    scene = host.scene
    pos = host.camera_position if position is None else tuple(position)
    fwd = host.camera_forward if forward is None else tuple(forward)
    has_spheres = scene.center.shape[0] > 0
    use_accel = dev.type == "cuda" and has_spheres
    plan = (clusters.build_plan_morton(scene.center.cpu().numpy(),
                                       scene.radius.cpu().numpy(),
                                       max_members=32, device=dev)
            if use_accel else None)
    jitter_table = torch.from_numpy(rng_mod.halton_jitter(64)).to(dev)
    cam0 = camera_mod.make_camera(pos, fwd, aspect=width / height,
                                  device=dev)
    cfg = pathtrace.PathTraceConfig(width=width, height=height,
                                    bounces=bounces, samples_per_pixel=1,
                                    block_size=block_size)
    chunk = 32
    n_chunks = -(-spp_total // chunk)
    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        accel = (clusters.make_morton_accel(plan, scene.center, scene.radius)
                 if use_accel else None)
        for i in range(chunk):
            fi = c * chunk + i
            cam = dataclasses.replace(cam0, jitter=jitter_table[fi % 64])
            acc += pathtrace.trace_image(scene, cam, cfg, fi,
                                         accel=accel).radiance
        if c == 0 or c == n_chunks - 1:
            _sync(dev)
            _note(f"reference chunk {c + 1}/{n_chunks} "
                  f"({(c + 1) * chunk} spp)")
    return (acc.cpu().numpy().astype(np.float64)
            / (n_chunks * chunk)).astype(np.float32)


def _realtime_config(width: int, height: int, pipeline_overrides=None):
    from .models import pipeline as pipeline_mod
    return pipeline_mod.PipelineConfig(
        output_width=width, output_height=height, render_width=width,
        render_height=height,
        **dict(REALTIME_OVERRIDES, **(pipeline_overrides or {})))


def realtime_render(host, width: int, height: int, frames: int = 64,
                    pipeline_overrides: dict | None = None, device="cuda"):
    """The real-time pipeline after its temporal history settles (static
    camera). Returns the last display-space frame (host array) and the
    pipeline."""
    from .models import pipeline as pipeline_mod

    pipe = pipeline_mod.RenderPipeline(
        _realtime_config(width, height, pipeline_overrides), device)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    img = None
    for _ in range(frames):
        state, img = pipe.render_frame(state, pose, 1.0 / 60.0)
    return img.cpu().numpy(), pipe


def _orbit_poses(host, n_frames: int, deg_per_frame: float = 0.75,
                 focus_dist: float = 8.0):
    """Camera positions orbiting the demo scene's focus point (the
    moving-camera sequence: temporal accumulation must hold up under
    reprojection, not just at a static pose)."""
    pos0 = np.asarray(host.camera_position, np.float64)
    fwd0 = np.asarray(host.camera_forward, np.float64)
    fwd0 = fwd0 / np.linalg.norm(fwd0)
    focus = pos0 + fwd0 * focus_dist
    poses = []
    for i in range(n_frames):
        a = np.deg2rad(deg_per_frame * i)
        rot = np.array([[np.cos(a), 0.0, np.sin(a)],
                        [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        p = focus + rot @ (pos0 - focus)
        f = focus - p
        f = f / np.linalg.norm(f)
        poses.append((p.astype(np.float32), f.astype(np.float32)))
    return poses


def _cached_reference(cache_dir, key, render):
    """A converged reference from `cache_dir` (``<key>.npz``), rendered
    and stored on a miss; with no `cache_dir`, rendered every time. The
    references depend only on (scene seed, textures, pose, size, spp), so
    an integrator change that alters the ground truth needs the directory
    cleared."""
    if not cache_dir:
        return render()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        return np.load(path)["ref"]
    ref = render()
    np.savez_compressed(path, ref=ref)
    return ref


def _display(linear) -> np.ndarray:
    import torch

    from .ops import post
    return post.tonemap(torch.from_numpy(np.asarray(linear))).numpy()


def _save(save_dir, images: dict):
    from .utils import image as image_mod
    os.makedirs(save_dir, exist_ok=True)
    for name, img in images.items():
        image_mod.write_png(os.path.join(save_dir, name), img)


def run_motion(width: int = 640, height: int = 360,
               spp_reference: int = 256, n_frames: int = 32,
               warmup: int = 24, seed: int = 0, eval_every: int = 4,
               load_textures: bool = True,
               ref_cache: str | None = DEFAULT_REF_CACHE,
               save_dir: str | None = None,
               pipeline_overrides: dict | None = None,
               device="cuda") -> dict:
    """Moving-camera fidelity: orbit the camera; SSIM of every
    `eval_every`-th frame against a converged reference at its pose.
    Reports the mean and the minimum."""
    import torch

    from . import backend
    from .models import myscene, pipeline as pipeline_mod
    from .utils import image as image_mod

    dev = backend.device(device)
    host = myscene.build(seed=seed, load_textures=load_textures, device=dev)
    poses = _orbit_poses(host, n_frames)
    pipe = pipeline_mod.RenderPipeline(
        _realtime_config(width, height, pipeline_overrides), dev)
    state = pipe.init_state(host)

    def mk_pose(p, f):
        return pipeline_mod.CameraPose(
            position=torch.from_numpy(p).to(dev),
            forward=torch.from_numpy(f).to(dev),
            up=torch.tensor((0.0, 1.0, 0.0), device=dev))

    pose0 = mk_pose(*poses[0])
    _note(f"motion: pipeline @{width}x{height}, {warmup} warmup frames...")
    for _ in range(warmup):
        state, _ = pipe.render_frame(state, pose0, 1.0 / 60.0,
                                     prev_pose=pose0)
    _note("motion: warmup done, starting orbit")

    scores = []
    prev = pose0
    for i, (p, f) in enumerate(poses):
        cur = mk_pose(p, f)
        state, img = pipe.render_frame(state, cur, 1.0 / 60.0,
                                       prev_pose=prev)
        prev = cur
        if i % eval_every != 0:
            continue
        key = (f"orbit_s{seed}_t{int(load_textures)}_{width}x{height}"
               f"_spp{spp_reference}_f{i}")
        ref_display = _display(_cached_reference(
            ref_cache, key,
            lambda: reference_render(host, width, height, spp_reference,
                                     position=p, forward=f, device=dev)))
        rt = img.cpu().numpy()
        scores.append(float(image_mod.ssim(rt, ref_display)))
        _note(f"motion: frame {i}/{n_frames} SSIM {scores[-1]:.4f}")
        if save_dir is not None:
            _save(save_dir, {f"rt_{i:03d}_{scores[-1]:.4f}.png": rt,
                             f"ref_{i:03d}.png": ref_display})

    return {
        "metric": "ssim_motion_orbit",
        "value": round(float(np.mean(scores)), 4),
        "min": round(float(np.min(scores)), 4),
        "per_frame": [round(s, 4) for s in scores],
        "unit": "SSIM",
        "frames": n_frames,
        "evaluated": len(scores),
        "reference_spp": spp_reference,
        "resolution": f"{width}x{height}",
        "textures": host.scene.textures is not None,
    }


def run_mesh(width: int = 640, height: int = 360,
             spp_reference: int = 256, frames_realtime: int = 64,
             seed: int = 0, tessellation: int = 4,
             load_textures: bool = True,
             ref_cache: str | None = DEFAULT_REF_CACHE,
             save_dir: str | None = None, device="cuda") -> dict:
    """Static fidelity of the mesh path: the demo scene as instances of
    one geosphere (``myscene.as_mesh_scene``) through the real-time
    pipeline, scored against its own converged reference."""
    from . import backend
    from .models import myscene
    from .utils import image as image_mod

    dev = backend.device(device)
    mh = myscene.as_mesh_scene(
        myscene.build(seed=seed, load_textures=load_textures, device=dev),
        tessellation=tessellation)
    key = (f"mesh{tessellation}_s{seed}_t{int(load_textures)}"
           f"_{width}x{height}_spp{spp_reference}")
    ref_display = _display(_cached_reference(
        ref_cache, key,
        lambda: reference_render(mh, width, height, spp_reference,
                                 device=dev)))
    _note(f"mesh static: reference ready; rendering {frames_realtime} "
          "real-time frames...")
    rt_display, _ = realtime_render(mh, width, height, frames_realtime,
                                    device=dev)
    if save_dir:
        _save(save_dir, {"mesh_reference.png": ref_display,
                         "mesh_realtime.png": rt_display})
    score = image_mod.ssim(rt_display, ref_display)
    return {
        "metric": "ssim_vs_reference_mesh",
        "value": round(float(score), 4),
        "unit": "SSIM",
        "vs_baseline": round(float(score) / 0.98, 4),
        "reference_spp": spp_reference,
        "realtime_frames": frames_realtime,
        "tessellation": tessellation,
        "resolution": f"{width}x{height}",
        "textures": mh.scene.textures is not None,
    }


def run(width: int = 640, height: int = 360, spp_reference: int = 1024,
        frames_realtime: int = 64, seed: int = 0,
        load_textures: bool = True, save_dir: str | None = None,
        ref_cache: str | None = DEFAULT_REF_CACHE,
        crosscheck_spp: int = 0,
        pipeline_overrides: dict | None = None, device="cuda") -> dict:
    """Static fidelity at the default pose; with `crosscheck_spp`, also
    the independent tracer's full-frame comparison at 160x90
    (``crosscheck.run``). Returns the metric dict."""
    from . import backend
    from .models import myscene
    from .utils import image as image_mod

    dev = backend.device(device)
    host = myscene.build(seed=seed, load_textures=load_textures, device=dev)
    key = (f"static_s{seed}_t{int(load_textures)}_{width}x{height}"
           f"_spp{spp_reference}")
    ref_display = _display(_cached_reference(
        ref_cache, key,
        lambda: reference_render(host, width, height, spp_reference,
                                 device=dev)))
    _note(f"static: reference ready; rendering {frames_realtime} "
          "real-time frames...")
    rt_display, _ = realtime_render(host, width, height, frames_realtime,
                                    pipeline_overrides=pipeline_overrides,
                                    device=dev)
    if save_dir:
        _save(save_dir, {"reference.png": ref_display,
                         "realtime.png": rt_display})
    score = image_mod.ssim(rt_display, ref_display)
    result = {
        "metric": "ssim_vs_reference",
        "value": round(float(score), 4),
        "unit": "SSIM",
        "vs_baseline": round(float(score) / 0.98, 4),
        "reference_spp": spp_reference,
        "realtime_frames": frames_realtime,
        "resolution": f"{width}x{height}",
        "textures": host.scene.textures is not None,
    }
    if crosscheck_spp:
        # A full frame against the independent numpy tracer, which shares
        # no transport code with the integrator: integrator-wide bias
        # cannot pass through the self-referential reference above.
        from . import crosscheck
        _note("crosscheck: independent-tracer full-frame comparison...")
        result["crosscheck"] = crosscheck.run(width=160, height=90,
                                              spp=crosscheck_spp,
                                              device=dev)
    return result


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("fidelity")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=1024)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--motion", action="store_true",
                   help="moving-camera orbit sequence (min/mean SSIM)")
    p.add_argument("--mesh", action="store_true",
                   help="static fidelity of the instanced-mesh path")
    p.add_argument("--save", default=None,
                   help="directory to write reference/realtime PNGs")
    p.add_argument("--crosscheck-spp", type=int, default=0,
                   help="also run the independent-tracer full-frame "
                        "crosscheck at 160x90 with this many spp")
    p.add_argument("--record", default=None,
                   help="merge the result into this JSON file keyed by "
                        "metric name")
    args = p.parse_args(argv)
    if args.motion:
        result = run_motion(args.width, args.height, min(args.spp, 256),
                            args.frames, save_dir=args.save)
    elif args.mesh:
        result = run_mesh(args.width, args.height, min(args.spp, 256),
                          args.frames, save_dir=args.save)
    else:
        result = run(args.width, args.height, args.spp, args.frames,
                     save_dir=args.save, crosscheck_spp=args.crosscheck_spp)
    if args.record:
        rec = {}
        if os.path.exists(args.record):
            with open(args.record) as fh:
                rec = json.load(fh)
        rec[result["metric"]] = result
        with open(args.record, "w") as fh:
            json.dump(rec, fh, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
