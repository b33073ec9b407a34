"""Frames as CUDA graphs: the port's counterpart of the reference's
compiled frame (``RenderPipeline.render_frame_jit``,
``pathtrace.trace_image_jit``, the Session's jitted step).

The reference runs each frame as one XLA program and makes its two
data-dependent choices on the device, under ``lax.cond``: the overflow
spill wave (drts_tpu/ops/pathtrace.py:640-670) and the SHARC update
cadence (drts_tpu/models/pipeline.py:532-545). Here a frame function is
captured once into CUDA graphs, split at its spill decisions
(``pathtrace.spill_hook``):

* piece A: the frame up to the deep segment's first-wave overflow count;
* piece S: the second wave and its merge into A's buffers, in place;
* piece B: the rest of the frame (one more S and piece per further
  decision, e.g. one per sample at samples_per_pixel > 1).

A replay runs A, reads the 4-byte count (the frame's one host read),
replays S only when it is above 0, then B: a clean frame runs no spill
work, as under ``lax.cond``. The SHARC cadence stays the host's decision
(``FrameState.frame_count``): the callers capture one variant per cadence
phase. The replays launch the same hand kernels and plain torch ops as
the eager frame, from the device's graph and not one by one from the
host.

Graphs that share a memory pool are captured in the order they replay
(piece by piece, phase by phase); what a later graph may reuse is memory
an earlier one freed, so outputs that must live between replays (the next
phase's state) are kept alive by the callers.

A frame reads module globals when it runs, and a capture bakes them in:
a mesh frame (a scene with mesh instances) its closest-hit form, the
candidate rounds and B9's sparse threshold, and every frame the MXU
opt-in and precision. A callable records them at its first frame and
raises ValueError when a later call finds one changed (``Choices``). A
mesh frame builds its instance tables on every call, inside the capture.

The sharded frame (``render_frame(group=)`` on an NCCL group) is
captured the same way, its collectives recorded in the pieces beside the
kernels: every rank captures the same collectives in the same order, and
no spill wave (piece S) issues one, so that each rank replays S on its own
decision, as on one device. A gloo group on the card is refused
(``pipeline.graph_refusal``).

On CPU tensors ``run_pieces`` runs the same function eagerly with the
same read between the same pieces, so that the CPU tests walk the code the
capture records. ``PIECE_MODE`` and ``SPILL_MODE`` are the tests' seams:
factories of a context (a ``TorchDispatchMode``, e.g. an ``OpLog``)
entered around each piece, and around each spill wave, not around the
read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import backend
from .ops import intersect_kernels as ik, pathtrace, trimesh
from .ops import trimesh_kernels as tk
from .parallel import mesh as mesh_mod
from .utils.checkpoint import leaves

PIECE_MODE = None
SPILL_MODE = None

# The ops a capture cannot hold: host reads (``.item()``, ``int(t)``,
# ``bool(t)``), outputs sized by the data, host-made tensors
# (``torch.tensor``, ``torch.as_tensor`` of host data).
HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.unique", "aten._unique", "aten.lift_fresh")
# The collectives (``torch.distributed``'s ops).
COLLECTIVE_OPS = ("c10d.",)


class OpLog(TorchDispatchMode):
    """A dispatch mode that appends to `log` the name of every op that
    reaches it whose name starts with one of `prefixes` (``functools.
    partial(OpLog, log, HOST_OPS)`` is a ``PIECE_MODE``)."""

    def __init__(self, log: list, prefixes: tuple):
        super().__init__()
        self.log, self.prefixes = log, prefixes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.prefixes):
            self.log.append(name)
        return func(*args, **(kwargs or {}))


def on_card(device: torch.device) -> bool:
    """Whether a frame on `device` is captured (a CUDA device) or run as
    eager pieces (any other)."""
    return device.type == "cuda"


class CaptureError(RuntimeError):
    """A frame that cannot be captured (a host read or a host-made tensor
    inside it, or any other CUDA capture fault)."""


class Choices:
    """A callable's record of the module globals its frame reads when it
    runs, which a capture bakes into its launches: the MXU opt-in
    (``clusters._USE_MXU``, which adds the A-matrices to the Morton accel)
    and precision (``intersect_kernels.MXU_PREC``, which picks B12's
    build), and on a scene with mesh instances the closest-hit form
    (``trimesh.MESH_CAND``), the closest and any-hit candidate rounds
    (``trimesh_kernels.CAND_ROUNDS``, ``ANY_ROUNDS``) and B9's sparse-block
    threshold (``trimesh_kernels.B9_SPARSE_LIVE``). Taken at the first
    frame (the capture, on the card); a later call that finds one changed
    raises ValueError, since the graphs would replay the old choice."""

    def __init__(self):
        self.seen = None

    @staticmethod
    def now(scene) -> dict:
        from .models import clusters
        out = {"clusters._USE_MXU": clusters._USE_MXU,
               "intersect_kernels.MXU_PREC": ik.MXU_PREC}
        if scene.mesh_instances is not None:
            out.update({"trimesh.MESH_CAND": trimesh.MESH_CAND,
                        "trimesh_kernels.CAND_ROUNDS": tk.CAND_ROUNDS,
                        "trimesh_kernels.ANY_ROUNDS": tk.ANY_ROUNDS,
                        "trimesh_kernels.B9_SPARSE_LIVE": tk.B9_SPARSE_LIVE})
        return out

    def check(self, scene) -> None:
        now = self.now(scene)
        if self.seen is None:
            self.seen = now
            return
        for name, was in self.seen.items():
            if now.get(name) != was:
                raise ValueError(f"{name} is {now.get(name)!r}, the "
                                 f"captured frame's {was!r}; make a new "
                                 f"callable")


def _mode(factory):
    return factory() if factory else contextlib.nullcontext()


def run_pieces(fn):
    """fn() on CPU tensors, piece by piece as a capture splits it, with the
    spill read between the pieces. Returns (fn's result, spill waves)."""
    waves = 0
    mode = [_mode(PIECE_MODE)]
    mode[0].__enter__()

    def decide(overflow, wave1):
        nonlocal waves
        mode[0].__exit__(None, None, None)
        run = overflow.item() > 0
        if run:
            with _mode(PIECE_MODE), _mode(SPILL_MODE):
                wave1()
            waves += 1
        mode[0] = _mode(PIECE_MODE)
        mode[0].__enter__()
        return int(run)

    try:
        with pathtrace.spill_hook(decide):
            out = fn()
    finally:
        mode[0].__exit__(None, None, None)
    return out, waves


def _launch_diff(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in backend.LAUNCHES.items()
            if v != before.get(k, 0)}


@dataclasses.dataclass
class Captured:
    """One frame function captured: its pieces, its spill waves (each with
    the overflow count read before it), its outputs (static: each replay
    rewrites them), the kernel launches the pieces hold (``launches``,
    the spill waves' apart) and the capture's host seconds."""
    pieces: list
    spills: list          # (overflow tensor, CUDAGraph, launches)
    outputs: object
    launches: dict
    seconds: float

    @classmethod
    def capture(cls, fn, pool, stream) -> "Captured":
        """Capture fn() on `stream` into graphs of memory pool `pool`.
        Raises CaptureError (from the CUDA error) when fn does something a
        capture cannot hold."""
        t0 = time.perf_counter()
        pieces, spills = [], []
        start = dict(backend.LAUNCHES)
        current = None

        def begin():
            nonlocal current
            current = torch.cuda.CUDAGraph()
            current.capture_begin(pool=pool)
            return current

        def end():
            nonlocal current
            g, current = current, None
            g.capture_end()
            return g

        def decide(overflow, wave1):
            pieces.append(end())
            mark = dict(backend.LAUNCHES)
            begin()
            wave1()
            spills.append((overflow, end(), _launch_diff(mark)))
            begin()
            return 0

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        try:
            with torch.cuda.stream(stream):
                begin()
                with pathtrace.spill_hook(decide):
                    out = fn()
                pieces.append(end())
        except Exception as exc:
            if current is not None:
                with contextlib.suppress(Exception):
                    current.capture_end()
            raise CaptureError(f"the frame cannot be captured as a CUDA "
                               f"graph: {exc}") from exc
        torch.cuda.current_stream().wait_stream(stream)
        launches = _launch_diff(start)
        for _, _, spilled in spills:
            for k, v in spilled.items():
                launches[k] -= v
        return cls(pieces=pieces, spills=spills, outputs=out,
                   launches={k: v for k, v in launches.items() if v},
                   seconds=time.perf_counter() - t0)

    def replay(self, stats: "GraphStats") -> int:
        """Replay the frame; returns the spill waves it ran and adds its
        host launches and kernel launches to `stats`."""
        waves = 0
        for i, g in enumerate(self.pieces):
            g.replay()
            stats.host_launches += 1
            if i < len(self.spills):
                overflow, s, spilled = self.spills[i]
                if overflow.item() > 0:      # the frame's one host read
                    s.replay()
                    stats.host_launches += 1
                    stats.add(spilled)
                    waves += 1
        stats.add(self.launches)
        stats.spill_waves += waves
        stats.frames += 1
        return waves


@dataclasses.dataclass
class GraphStats:
    """What a graph callable did: frames replayed, their spill waves,
    host launches (graph launches and the input writes; the last frame's
    in ``last_host_launches``), the kernel launches the replays made
    (from the capture's counts), each variant's capture seconds and the
    kernel launches a frame of each holds."""
    frames: int = 0
    spill_waves: int = 0
    host_launches: int = 0
    last_host_launches: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    capture_s: dict = dataclasses.field(default_factory=dict)
    captured_launches: dict = dataclasses.field(default_factory=dict)

    def add(self, launches: dict) -> None:
        for k, v in launches.items():
            self.launches[k] = self.launches.get(k, 0) + v

    def captured(self, key, frame: "Captured") -> None:
        """Record variant `key`'s capture seconds and launches."""
        self.capture_s[key] = frame.seconds
        self.captured_launches[key] = {
            "frame": frame.launches,
            "spill_waves": [sp for _, _, sp in frame.spills]}

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def warm_up(fn, stream) -> None:
    """One eager run of fn on `stream` (lazy set-up, the constants'
    first copies), finished before a capture."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()


def write_tree(dst, src, seen: dict | None = None) -> int:
    """Write the tree `src` into the captured frame's buffers, the tree
    `dst` (the same leaf paths, or ValueError). A tensor is copied into
    dst's (the same shape and type; a 0-d tensor is cast, as a number
    is), a number at a tensor leaf is filled in, and a number at a number
    leaf must equal dst's (but for a frame count). A tensor is skipped
    where it is dst's own leaf, or, with a `seen` record (path ->
    (tensor, version), kept by the caller from call to call), where it is
    the very tensor written there last time, unchanged in place since:
    give `seen` only for buffers no replay writes. Returns the device
    writes made."""
    ld, ls = dict(leaves(dst)), dict(leaves(src))
    if set(ld) != set(ls):
        raise ValueError("the tree does not fit the captured frame's "
                         "buffers (other leaves); make a new callable")
    n = 0
    for p, d in ld.items():
        s = ls[p]
        if not isinstance(d, torch.Tensor):
            if isinstance(s, torch.Tensor) or (
                    s != d and p.split(".")[-1] != "frame_count"):
                raise ValueError(f"{p} is {s!r}, the captured frame's "
                                 f"{d!r}; make a new callable")
            continue
        if not isinstance(s, torch.Tensor):
            d.fill_(s)
            n += 1
            continue
        last = seen.get(p) if seen is not None else None
        if s is d or (last is not None and last[0] is s
                      and last[1] == s._version):
            continue
        if d.shape != s.shape or (d.dtype != s.dtype and s.dim()):
            raise ValueError(f"{p} is {tuple(s.shape)} {s.dtype}, the "
                             f"captured frame's {tuple(d.shape)} "
                             f"{d.dtype}; make a new callable")
        d.copy_(s)
        if seen is not None:
            seen[p] = (s, s._version)
        n += 1
    return n


def clone_tree(tree):
    """`tree` with every tensor leaf cloned, each into its own buffer."""
    return mesh_mod.map_tensors(torch.clone, tree)


class Inputs:
    """A captured frame's input buffers (``tree``, clones of the first
    call's), which no replay writes, and the writes into them (``write``:
    ``write_tree`` with a record of what it wrote)."""

    def __init__(self, tree):
        self.tree = clone_tree(tree)
        self._seen = {}

    def write(self, tree) -> int:
        return write_tree(self.tree, tree, self._seen)


class TraceGraph:
    """``pathtrace.trace_image`` as CUDA graphs, the counterpart of the
    reference's ``trace_image_jit``: a callable ``(scene, cam,
    frame_index) -> TraceOutput``. With a cluster `plan` the frame is the
    headline bench's (``bench.trace_frame``: the accel of `accel`, the
    Morton chunks ordered from the camera or the clustered tables, the
    G-buffer, the trace); without, ``trace_image`` alone (on an all-mesh
    scene, ``bench_mesh``'s frame); with `rows` = (start, end), that band
    of the frame (``trace_image``'s `rows`: ``graft_entry.banded_trace``'s
    frame, whose rows the caller gathers outside the graphs, as the
    reference's sharded trace gathers by its out-sharding). The globals
    the frame reads are held as ``Choices`` says. The frame index reaches
    the hash RNG as a device input, so every replay draws its own frame's
    noise.

    On CUDA tensors the first call warms up and captures the frame
    (graphs.py), and every call writes its inputs (the scene and camera
    where they are other tensors than the last call's, the frame index)
    and replays it; the returned TraceOutput's tensors are rewritten by
    the next call. On CPU tensors it runs the same pieces eagerly
    (``run_pieces``). ``stats`` counts as FrameGraph's does."""

    def __init__(self, cfg, plan=None, accel: str = "morton", rows=None):
        if accel not in ("morton", "clustered"):
            raise ValueError(f"accel must be 'morton' or 'clustered', got "
                             f"{accel!r}")
        if rows is not None and plan is not None:
            raise ValueError("a band of rows takes the trace without a "
                             "cluster plan")
        self.cfg, self.plan, self.accel, self.rows = cfg, plan, accel, rows
        self.stats = GraphStats()
        self._inputs = None
        self._frame = None
        self._choices = Choices()

    def _run(self, scene, cam, frame_index):
        if self.plan is None:
            return pathtrace.trace_image(scene, cam, self.cfg, frame_index,
                                         rows=self.rows)
        from .models import clusters
        from .ops import gbuffer
        c = self.cfg
        if self.accel == "clustered":
            accel = clusters.make_accel(self.plan, scene.center,
                                        scene.radius)
        else:
            accel = clusters.make_morton_accel(self.plan, scene.center,
                                               scene.radius,
                                               sort_origin=cam.position)
        gbuf = gbuffer.generate(scene, cam, c.width, c.height, c.block_size,
                                accel=accel)
        return pathtrace.trace_image(scene, cam, c, frame_index, gbuf=gbuf,
                                     accel=accel)

    def __call__(self, scene, cam, frame_index):
        self._choices.check(scene)
        dev = scene.center.device
        index = frame_index
        if not isinstance(index, torch.Tensor):
            index = torch.full((), index, dtype=torch.int64, device=dev)
        if not on_card(dev):
            out, waves = run_pieces(lambda: self._run(scene, cam, index))
            self.stats.frames += 1
            self.stats.spill_waves += waves
            return dataclasses.replace(out, spill_waves=waves)
        if self._frame is None:
            self._inputs = Inputs((scene, cam, index))
            stream = torch.cuda.Stream()
            warm_up(lambda: self._run(*self._inputs.tree), stream)
            self._frame = Captured.capture(
                lambda: self._run(*self._inputs.tree),
                torch.cuda.graph_pool_handle(), stream)
            self.stats.captured(0, self._frame)
        before = self.stats.host_launches
        self.stats.host_launches += self._inputs.write(
            (scene, cam, frame_index))
        waves = self._frame.replay(self.stats)
        self.stats.last_host_launches = self.stats.host_launches - before
        return dataclasses.replace(self._frame.outputs, spill_waves=waves)
