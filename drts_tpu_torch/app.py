"""Application shell: the CLI in place of the reference's Win32 and ImGui
loop (port of ``drts_tpu/app.py``; Main.cpp's wWinMain and message pump
and the interactive parts of App.cpp). Subcommands:

  render       render N frames of the demo scene to PNG
  bench        frame time (the StepTimer FPS analogue)
  set          edit the settings JSON (key=value ...)
  interactive  fly camera: a scripted key string, a live TTY, or an orbit

Settings come from the JSON config (``config.py``) under ``Settings/`` in
the working directory, as MyAppData's. ``--device`` picks the device
(default ``cuda``; the frame runs on the CPU only when asked to, and
``cuda`` raises where PyTorch sees no card). The Session steps through
CUDA graph replays of the frame (``Session(graph=True)``, the reference's
jitted step); ``--eager`` runs each frame eagerly instead.

    python -m drts_tpu_torch.app --width 1920 --height 1080 render --frames 8
    python -m drts_tpu_torch.app --device cpu --width 64 --height 64 \\
        render --frames 2
    python -m drts_tpu_torch.app --eager --width 1920 --height 1080 \\
        render --frames 8
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _load_settings(args):
    from . import config as config_mod

    if args.settings and os.path.exists(args.settings):
        return config_mod.load_settings(args.settings)
    return config_mod.GraphicsSettings().check()


def _build_session(args):
    from . import backend, session as session_mod
    from .models import myscene

    device = backend.device(args.device)
    settings = _load_settings(args)
    overrides = {}
    if args.bounces is not None:
        overrides["bounces"] = args.bounces
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.no_denoise:
        overrides["denoiser"] = "None"
    if args.no_physics:
        overrides["physics_enabled"] = False
    if args.debug_view != "None":
        overrides["debug_view"] = args.debug_view

    host = myscene.build(seed=args.seed, load_textures=not args.no_textures,
                         device=device)
    return session_mod.Session(settings, output_width=args.width,
                               output_height=args.height, host=host,
                               config_overrides=overrides, device=device,
                               graph=not args.eager)


def _parse_mutations(args):
    """--mutate FRAME:key=value entries -> {frame: [(key, value), ...]}."""
    sched: dict = {}
    for entry in getattr(args, "mutate", None) or []:
        at, _, kv = entry.partition(":")
        key, _, value = kv.partition("=")
        sched.setdefault(int(at), []).append((key, value))
    return sched


def _maybe_reload(sess, args, mtime_box):
    """--watch-settings: re-apply the settings file when it changes."""
    if not getattr(args, "watch_settings", False):
        return
    try:
        mtime = os.path.getmtime(args.settings)
    except OSError:
        return
    if mtime_box[0] is None:
        mtime_box[0] = mtime
    elif mtime > mtime_box[0]:
        mtime_box[0] = mtime
        changed = sess.reload_settings(args.settings)
        if changed:
            print(f"settings reloaded: {', '.join(changed)}")


def cmd_render(args):
    from .utils import checkpoint as ckpt_mod
    from .utils import image as image_mod
    from .utils import obs

    sess = _build_session(args)
    if args.resume:
        # Elastic recovery: resume the frame state from the checkpoint
        # directory if it holds one, else start fresh.
        sess.state, resumed = ckpt_mod.resume_or_init(sess.pipe, args.resume,
                                                      sess.host)
        if resumed:
            print(f"resumed at frame {int(sess.state.frame_index)}")
    pose = sess.default_pose()
    mutations = _parse_mutations(args)
    mtime_box = [None]

    os.makedirs(args.out_dir, exist_ok=True)
    # Structured per-frame metrics (the debug overlay's numbers) and
    # profiler labels.
    metrics = obs.FrameMetrics(sess.pipe.device)
    for i in range(args.frames):
        for key, value in mutations.get(i, ()):
            how = sess.set(key, value)
            print(f"frame {i}: set {key}={value} ({how})")
        _maybe_reload(sess, args, mtime_box)
        with metrics.frame() as rec:
            with obs.pass_scope("frame"):
                img = sess.step(pose)
            rec["frame_index"] = i
        if i >= args.frames - args.save_last:
            path = os.path.join(args.out_dir, f"frame_{i:04d}.png")
            image_mod.write_png(path, img.cpu().numpy())
            print(f"wrote {path}")
        if (args.resume and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0
                and i + 1 < args.frames):
            # Periodic cadence: a preemption loses at most
            # checkpoint_every frames, not the whole run.
            ckpt_mod.save_rotating(sess.state, args.resume)
            print(f"checkpointed frame {int(sess.state.frame_index)}")
    counters = getattr(sess.state, "counters", None)
    summary = metrics.summary()
    if counters:
        summary.update({k: float(v) for k, v in counters.items()})
    if args.metrics_out:
        metrics.dump(args.metrics_out)
    print("metrics: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(summary.items())}))
    if args.resume:
        ckpt_mod.save_rotating(sess.state, args.resume)
        print(f"checkpointed frame {int(sess.state.frame_index)}")


def cmd_bench(args):
    from . import bench
    from .utils.obs import synchronize

    sess = _build_session(args)
    pose = sess.default_pose()
    dev = sess.pipe.device

    sess.step(pose)  # warm: the kernels build on their first launch
    synchronize(dev)
    start = time.perf_counter()
    for _ in range(args.frames):
        sess.step(pose)
    synchronize(dev)
    elapsed = time.perf_counter() - start
    cfg = sess.pipe.cfg
    record = {
        "frames": args.frames,
        "frame_ms": round(elapsed / args.frames * 1e3, 2),
        "fps": round(args.frames / elapsed, 2),
        "resolution": f"{cfg.render_width}x{cfg.render_height}"
                      f"->{cfg.output_width}x{cfg.output_height}",
    }
    counters = getattr(sess.state, "counters", None)
    if counters:
        record["counters"] = {k: round(float(v), 1)
                              for k, v in sorted(counters.items())}
    if args.passes:
        # Each stage timed through render_frame's _run hook and averaged
        # over one SHARC cadence, starting from the session's state (which
        # these frames do not advance).
        staged = (max(cfg.sharc_update_period, 1) if cfg.sharc_enabled
                  else 1)
        state, passes = sess.state, {}
        for _ in range(staged):
            frame = {}
            state, _ = sess.pipe.render_frame(
                state, pose, prev_pose=pose, dyn=sess.dyn,
                _run=bench.stage_timer(frame, dev))
            for name, ms in frame.items():
                passes[name] = passes.get(name, 0.0) + ms / staged
        record["passes_ms"] = {k: round(v, 2) for k, v in passes.items()}
    print(json.dumps(record))


def cmd_set(args):
    """Persisted settings change: `set key=value [...]` edits the
    settings JSON (the settings window's Save path)."""
    from . import config as config_mod
    from . import session as session_mod

    settings = _load_settings(args)
    for entry in args.assignments:
        key, _, value = entry.partition("=")
        settings = session_mod.set_by_path(settings, key, value)
        print(f"set {key} = {value}")
    os.makedirs(os.path.dirname(args.settings) or ".", exist_ok=True)
    config_mod.save_settings(settings, args.settings)
    print(f"saved {args.settings}")


def _interactive_keys(args, sess, mutations, mtime_box, camera_mod,
                      image_mod):
    """Key-driven fly camera: each tick polls one key (scripted string or
    live TTY), applies it to the CameraController, renders a frame."""
    from . import config as config_mod

    default = sess.default_pose()
    dev = sess.pipe.device

    def make_controller():
        return camera_mod.CameraController(
            position=default.position.cpu().numpy().astype(np.float64),
            forward=default.forward.cpu().numpy().astype(np.float64))

    controls = config_mod.load_controls(args.controls)
    ctl = make_controller()
    scripted = args.keys is not None
    keys = iter(args.keys) if scripted else _read_keys_live()
    print(camera_mod.KEY_HELP, flush=True)
    prev = ctl.pose(dev)
    os.makedirs(args.out_dir, exist_ok=True)
    shots = 0
    t_last = time.perf_counter()
    img = None
    i = 0
    # Live mode runs until 'x' or Ctrl-C like an app window (idle ticks
    # still render and accumulate history); scripted mode ends with its
    # string.
    try:
        while True:
            for key, value in mutations.get(i, ()):
                how = sess.set(key, value)
                print(f"tick {i}: set {key}={value} ({how})", flush=True)
            _maybe_reload(sess, args, mtime_box)
            try:
                k = next(keys)
            except StopIteration:
                break
            now = time.perf_counter()
            dt = 1.0 / 60.0 if scripted else max(now - t_last, 1e-4)
            t_last = now
            # Speed x elapsed, the reference's ProcessInput scaling
            # (Controls.json, MyAppData.h:392-414); dt is clamped so that
            # a first-launch hitch does not teleport the camera.
            action = camera_mod.apply_input_key(
                ctl, k,
                move_step=controls.camera_movement_speed
                * min(max(dt, 1e-2), 0.1),
                turn_step=controls.camera_rotation_speed * np.deg2rad(10.0))
            if action == "quit":
                break
            if action == "reset":
                ctl = make_controller()
            pose = ctl.pose(dev)
            img = sess.step(pose, dt=dt, prev_pose=prev)
            prev = pose
            if action == "screenshot":
                path = os.path.join(args.out_dir, f"shot_{shots:04d}.png")
                image_mod.write_png(path, img.cpu().numpy())
                print(f"wrote {path}", flush=True)
                shots += 1
            if action:
                p = pose.position.cpu().numpy().round(2)
                print(f"tick {i}: {action} pos={p.tolist()}", flush=True)
            i += 1
    except KeyboardInterrupt:
        print("interrupted", flush=True)
    if img is not None and args.save_last:
        path = os.path.join(args.out_dir, "final.png")
        image_mod.write_png(path, img.cpu().numpy())
        print(f"wrote {path}", flush=True)


def _read_keys_live():
    """Generator of keypresses from a cbreak TTY (the reference's per-frame
    ProcessInput poll, App.cpp:812-970). Yields '' when no key is pending
    so the render loop keeps ticking."""
    import select
    import sys
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            r, _, _ = select.select([sys.stdin], [], [], 0.0)
            yield sys.stdin.read(1) if r else ""
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def cmd_interactive(args):
    """Fly-camera loop: --keys drives it with a scripted key string (space
    = a tick with no input), --wasd with a live TTY (see camera.KEY_HELP),
    otherwise a scripted orbit; every mode takes settings changes
    mid-flight."""
    import torch

    from .models.pipeline import CameraPose
    from .ops import camera as camera_mod
    from .utils import image as image_mod
    from .utils import timer as timer_mod

    if args.wasd and args.keys is None and not os.isatty(0):
        raise SystemExit("interactive --wasd needs a TTY on stdin "
                         "(use --keys STR for scripted input)")
    sess = _build_session(args)
    mutations = _parse_mutations(args)
    mtime_box = [None]
    if args.keys is not None or args.wasd:
        return _interactive_keys(args, sess, mutations, mtime_box,
                                 camera_mod, image_mod)

    os.makedirs(args.out_dir, exist_ok=True)
    dev = sess.pipe.device
    prev = sess.default_pose()

    # The reference's main loop is StepTimer::Tick(Update): the timer
    # clamps the elapsed time and counts FPS, and its dt feeds the physics
    # step.
    timer = timer_mod.StepTimer()

    for i in range(args.frames):
        for key, value in mutations.get(i, ()):
            how = sess.set(key, value)
            print(f"frame {i}: set {key}={value} ({how})")
        _maybe_reload(sess, args, mtime_box)
        angle = 2.0 * np.pi * i / max(args.frames, 1) * 0.25
        pos = np.array([15.0 * np.sin(angle), 2.0, -15.0 * np.cos(angle)],
                       np.float32)
        fwd = -pos / np.linalg.norm(pos)
        pose = CameraPose(
            position=torch.from_numpy(pos).to(dev),
            forward=torch.from_numpy(fwd.astype(np.float32)).to(dev),
            up=torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                            device=dev))

        frames_img = []
        timer.tick(lambda dt: frames_img.append(
            sess.step(pose, dt=max(dt, 1e-4), prev_pose=prev)))
        img = frames_img[-1] if frames_img else sess.step(pose,
                                                          prev_pose=prev)
        prev = pose
        if timer.frames_per_second:
            print(f"frame {i}: {timer.frames_per_second:.1f} fps")
            timer.frames_per_second = 0.0
        if args.save_last and i >= args.frames - args.save_last:
            path = os.path.join(args.out_dir, f"orbit_{i:04d}.png")
            image_mod.write_png(path, img.cpu().numpy())
            print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser("drts_tpu_torch",
                                description="PyTorch/CUDA path tracer")
    p.add_argument("--settings", default="Settings/graphics.json",
                   help="JSON settings file (MyAppData analogue)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--debug-view", default="None",
                   choices=["None", "ReGIRCells", "SHARC", "NRDValidation"],
                   help="diagnostic overlay (ReGIR cells / SHARC voxels / "
                        "denoiser history validation)")
    p.add_argument("--no-physics", action="store_true")
    p.add_argument("--no-textures", action="store_true")
    p.add_argument("--eager", action="store_true",
                   help="run each frame eagerly (default: CUDA graph "
                        "replays, the reference's jitted step)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the frame (default cuda; cpu runs "
                        "the kernels' plain versions)")
    sub = p.add_subparsers(dest="command", required=True)

    def add_runtime_flags(sp):
        sp.add_argument("--mutate", action="append", metavar="FRAME:KEY=VAL",
                        help="apply a settings change at frame N "
                             "(the settings-window analogue)")
        sp.add_argument("--watch-settings", action="store_true",
                        help="reload the settings file when it changes")

    r = sub.add_parser("render")
    r.add_argument("--frames", type=int, default=8)
    r.add_argument("--save-last", type=int, default=1)
    r.add_argument("--out-dir", default="out")
    r.add_argument("--metrics-out", default=None, metavar="JSONL",
                   help="write per-frame metric records (JSON lines)")
    r.add_argument("--resume", default=None, metavar="CKPT_DIR",
                   help="resume the frame state from / checkpoint to DIR")
    r.add_argument("--checkpoint-every", type=int, default=16,
                   metavar="N", help="with --resume: also checkpoint every "
                   "N frames (preemption loses at most N frames; 0 = only "
                   "at the end)")
    add_runtime_flags(r)
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench")
    b.add_argument("--frames", type=int, default=16)
    b.add_argument("--passes", action="store_true",
                   help="also print per-stage ms (one SHARC cadence)")
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("set", help="edit the settings JSON: key=value ...")
    st.add_argument("assignments", nargs="+", metavar="KEY=VALUE")
    st.set_defaults(fn=cmd_set)

    it = sub.add_parser("interactive")
    it.add_argument("--frames", type=int, default=32)
    it.add_argument("--save-last", type=int, default=4)
    it.add_argument("--out-dir", default="out")
    it.add_argument("--keys", default=None, metavar="STR",
                    help="scripted key string for the fly camera "
                         "(w/a/s/d/q/e move, i/j/k/l/u/o look, r reset, "
                         "p screenshot, x quit; space = idle tick)")
    it.add_argument("--wasd", action="store_true",
                    help="live keyboard fly camera (requires a TTY)")
    it.add_argument("--controls", default="Settings/controls.json",
                    help="Controls.json (camera speeds, MyAppData.h:392)")
    add_runtime_flags(it)
    it.set_defaults(fn=cmd_interactive)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
