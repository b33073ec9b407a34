"""Checkpoint and resume of the whole frame state (port of
``drts_tpu/utils/checkpoint.py``).

The state that works like a checkpoint (history textures, the SHARC
cache, reservoirs, the physics world, the frame counters) is one
``FrameState``; a run resumes from it after a preemption as the
reference's device-lost recovery rebuilds (``restore() if it exists else
init_state()``).

One format: ``torch.save`` of a flat ``{dotted.path: tensor}`` dict of
every leaf of the state, written to ``<path>.pt`` (a temporary file, then
an atomic rename). Host numbers (``FrameState.frame_count``, the physics
indices) are stored as 0-d tensors and come back as the Python type of
the state they are restored into. The file loads with
``torch.load(weights_only=True)``: tensors and a dict only, no pickled
class. ``restore`` fills the structure of a ``state_like`` (a fresh
``init_state``), casting to its dtypes and moving to its devices, and
raises ``CheckpointMismatch`` on a missing or unexpected path or a shape
that differs: it never broadcasts or skips a leaf.

``save_rotating`` alternates two slots, ``s0`` and ``s1``, and moves the
fsynced ``LATEST`` marker only after a slot is complete, so a kill at any
moment leaves one whole checkpoint; ``restore_rotating`` falls back to
the other slot when the marked one cannot be read, then to the legacy
single-path layout (``save(state, dirpath)``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import torch


class CheckpointMismatch(ValueError):
    """The checkpoint's paths or shapes differ from the state's."""


def leaves(obj, prefix=""):
    """(dotted path, leaf) of every tensor and host number of `obj`, a
    tree of dataclasses, dicts, lists and tuples; None holds no leaf."""
    if obj is None:
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{prefix}{f.name}.")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from leaves(v, f"{prefix}{i}.")
    elif isinstance(obj, (torch.Tensor, bool, int, float)):
        yield prefix[:-1], obj
    else:
        raise TypeError(f"cannot checkpoint {prefix[:-1]!r} of type "
                        f"{type(obj).__name__}")


def flatten(state) -> dict:
    """The flat ``{dotted.path: tensor}`` dict that ``save`` writes."""
    flat = {}
    for path, leaf in leaves(state):
        if isinstance(leaf, torch.Tensor):
            flat[path] = leaf.detach()
        else:   # a host number: float64 keeps a Python float exact
            flat[path] = torch.tensor(
                leaf, dtype=torch.float64 if isinstance(leaf, float)
                else None)
    return flat


def _fill(like, flat, prefix, used):
    """`like` rebuilt with the leaves of `flat` (see restore)."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _fill(getattr(like, f.name), flat, f"{prefix}{f.name}.",
                          used)
            for f in dataclasses.fields(like) if f.init})
    if isinstance(like, dict):
        return {k: _fill(v, flat, f"{prefix}{k}.", used)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, flat, f"{prefix}{i}.", used)
                          for i, v in enumerate(like))
    path = prefix[:-1]
    if path not in flat:
        raise CheckpointMismatch(f"checkpoint has no {path!r}")
    used.add(path)
    saved = flat[path]
    if isinstance(like, torch.Tensor):
        if tuple(saved.shape) != tuple(like.shape):
            raise CheckpointMismatch(
                f"{path!r}: checkpoint shape {tuple(saved.shape)}, state "
                f"shape {tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)
    if saved.dim() != 0:
        raise CheckpointMismatch(f"{path!r}: a host number in the state, "
                                 f"shape {tuple(saved.shape)} in the "
                                 f"checkpoint")
    return type(like)(saved.item())


def restore_flat(state_like, flat: dict):
    """`state_like`'s structure filled from a flat dict (see the module
    docstring); raises CheckpointMismatch unless the paths and shapes
    match exactly."""
    used = set()
    restored = _fill(state_like, flat, "", used)
    extra = sorted(set(flat) - used)
    if extra:
        raise CheckpointMismatch(f"checkpoint paths not in the state: "
                                 f"{extra[:8]}")
    return restored


def save(state, path: str) -> None:
    """Write the state (any tree of tensors and host numbers) to
    ``<path>.pt``."""
    target = path + ".pt"
    tmp = target + ".tmp"
    torch.save(flatten(state), tmp)
    os.replace(tmp, target)


# What torch.load raises on a torn or foreign file.
_UNREADABLE = (OSError, EOFError, RuntimeError, KeyError,
               pickle.UnpicklingError)


def _read(path: str, map_location):
    """The flat dict saved at `path`, or None if there is none."""
    target = path + ".pt"
    if not os.path.exists(target):
        return None
    flat = torch.load(target, map_location=map_location, weights_only=True)
    if not isinstance(flat, dict):
        raise CheckpointMismatch(f"{target}: not a flat state dict")
    return flat


def restore(state_like, path: str, map_location=None):
    """The state saved at `path`, in the structure, dtypes and devices of
    `state_like`; None if there is no checkpoint there."""
    flat = _read(path, map_location)
    return None if flat is None else restore_flat(state_like, flat)


def save_rotating(state, dirpath: str) -> str:
    """Crash-safe periodic checkpoint: two slots under `dirpath`
    alternate, and the LATEST marker is replaced atomically only after
    the slot write completes. Returns the slot written."""
    os.makedirs(dirpath, exist_ok=True)
    prev = _read_latest(dirpath)
    slot = "s1" if prev == "s0" else "s0"
    save(state, os.path.join(dirpath, slot))
    tmp = os.path.join(dirpath, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(slot)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirpath, "LATEST"))
    return slot


def _read_latest(dirpath: str) -> str | None:
    try:
        with open(os.path.join(dirpath, "LATEST")) as f:
            slot = f.read().strip()
        return slot if slot in ("s0", "s1") else None
    except OSError:
        return None


def restore_rotating(state_like, dirpath: str, map_location=None):
    """Restore the newest complete rotating checkpoint; falls back to the
    other slot if the marked one cannot be read, then to the legacy
    single-path layout. Returns None if nothing restorable exists. A
    checkpoint that reads but does not fit `state_like` raises
    CheckpointMismatch (a run resumed under other settings)."""
    latest = _read_latest(dirpath)
    order = [latest, "s1" if latest == "s0" else "s0"] if latest \
        else ["s0", "s1"]
    for slot in order:
        try:
            flat = _read(os.path.join(dirpath, slot), map_location)
        except _UNREADABLE:
            continue
        if flat is not None:
            return restore_flat(state_like, flat)
    return restore(state_like, dirpath, map_location)


def resume_or_init(pipeline, path: str, host=None):
    """Elastic-recovery entry: (the restored state, True), or (a fresh
    ``pipeline.init_state(host)``, False) where `path` holds no
    checkpoint (DeviceResources::OnDeviceLost -> OnDeviceRestored,
    DeviceResources.cpp:552-602). The state lands on the pipeline's
    device, its host frame count included."""
    fresh = pipeline.init_state(host)
    restored = restore_rotating(fresh, path, map_location=pipeline.device)
    return (restored, True) if restored is not None else (fresh, False)
