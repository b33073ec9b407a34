"""The one generator of camera traffic, driven by a mix's parameters.

A mix (``traffic/<name>.json``) is a closed loop of frames with one in
flight: the next frame is submitted as soon as the step returns. The
camera orbits a focus point ``focus_dist`` ahead of the configuration's
start pose at ``deg_per_frame`` about the world's y axis (0 keeps it
still), starting ``start_deg`` into the orbit; the physics steps by a fixed
``dt``. ``warm_frames`` frames run before the window and fill the caches
and histories. The orbit is a copy of the arithmetic of the port's
fidelity tool (``_orbit_poses``), kept here so that a change to the
program cannot move it.
"""

from __future__ import annotations

import numpy as np

DEFAULTS = {"deg_per_frame": 0.75, "focus_dist": 8.0, "start_deg": 0.0,
            "sweep_deg": 0.0, "dt": 1.0 / 60.0, "warm_frames": 24}


def params(mix: dict) -> dict:
    out = dict(DEFAULTS)
    out.update({k: v for k, v in mix.items() if k in DEFAULTS})
    unknown = set(mix) - set(DEFAULTS) - {"why", "loop"}
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    if mix.get("loop", "closed") != "closed":
        raise ValueError("only the closed loop with one frame in flight")
    return out


def pose(mix: dict, camera: dict, frame: int):
    """(position, forward) float32 of frame `frame` (0 = the first warm
    frame) for the configuration's start pose `camera`."""
    p = params(mix)
    pos0 = np.asarray(camera["position"], np.float64)
    fwd0 = np.asarray(camera["forward"], np.float64)
    fwd0 = fwd0 / np.linalg.norm(fwd0)
    focus = pos0 + fwd0 * p["focus_dist"]
    turn = p["deg_per_frame"] * frame
    if p["sweep_deg"] > 0:
        turn = p["sweep_deg"] * np.sin(turn / p["sweep_deg"])
    a = np.deg2rad(p["start_deg"] + turn)
    rot = np.array([[np.cos(a), 0.0, np.sin(a)],
                    [0.0, 1.0, 0.0],
                    [-np.sin(a), 0.0, np.cos(a)]])
    pos = focus + rot @ (pos0 - focus)
    f = focus - pos
    f = f / np.linalg.norm(f)
    return pos.astype(np.float32), f.astype(np.float32)
