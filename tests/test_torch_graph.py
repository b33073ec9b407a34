"""The port's compiled frame on the CPU: ``RenderPipeline.render_frame_graph``
and ``pathtrace.trace_image_graph`` run their pieces eagerly here, with
the same inputs and the same spill read between them that a CUDA graph
capture records on the card (drts_tpu_torch/graphs.py).

- The capture audit: a TorchDispatchMode entered around every piece (not
  around the spill read) of a 48x32 default frame (3 bounces, the SHARC
  update and skip frames, ReBLUR, TAA), a ReSTIR frame and a spilling
  headline trace frame fails on every host read (``aten._local_scalar_
  dense``: ``.item()``, ``int(t)``, ``bool(t)``) and host-made tensor
  (``aten.lift_fresh``: ``torch.tensor``, ``torch.as_tensor`` of host
  data), and on ``nonzero``, ``masked_select`` and ``unique``, whose
  output sizes need a read. Each frame runs once eagerly first, as the
  capture's warm-up frame does, so that the cached constants exist.
- The spill: a default frame whose deep segment overflows (128 slots)
  runs the second wave in its own piece and equals ``render_frame``'s
  frame bit for bit (image and state), with one spill wave; a clean
  frame runs no second wave.
- ``physics.step`` takes a 0-d float32 ``dt`` (the graph's device input):
  bit for bit the float call's, and within tests/test_torch_physics.py's
  tolerances of the reference's step jitted with a traced dt.
- The refusals: a call with another group than the first call's raises
  (the sharded graph frame: tests/test_torch_parallel.py), and a call
  after a module global that the capture baked in changed
  (``clusters._USE_MXU`` on the frame, ``intersect_kernels.MXU_PREC`` on
  the trace) raises. Every one-device
  frame has a graph form (tests/test_torch_graph_mesh.py,
  tests/test_torch_graph_routes.py).
- The state's buffers under replay: with the capture replaced by a fake
  that re-runs the captured function on its inputs and writes its
  results into the outputs the capture made (what a replay does), the
  callable's ping-pong between the cadence phases' buffers, its copies of
  a state it did not return and a Session's new capture after a static
  change give the eager frames bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The frames here are small: one thread each keeps them quick where the
# suite's workers share the cores.
pytestmark = pytest.mark.usefixtures("one_thread")

from drts_tpu.models import myscene as jmyscene
from drts_tpu.ops import physics as jphysics
from drts_tpu_torch import convert, graphs
from drts_tpu_torch.models import clusters, myscene, pipeline
from drts_tpu_torch.ops import camera, intersect_kernels as ik, pathtrace
from drts_tpu_torch.ops import physics, sharc
from drts_tpu_torch.utils.checkpoint import leaves

HOST_OPS = graphs.HOST_OPS


class HostAudit(TorchDispatchMode):
    """Records every op of HOST_OPS that reaches the dispatcher."""
    found: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(HOST_OPS):
            HostAudit.found.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def audit(monkeypatch):
    HostAudit.found = []
    monkeypatch.setattr(graphs, "PIECE_MODE", HostAudit)
    return HostAudit.found


def small_default(**kw):
    return pipeline.PipelineConfig(
        output_width=48, output_height=32, render_width=48,
        render_height=32, bounces=3, block_size=4096,
        sharc=sharc.SHARCConfig(capacity_log2=12), **kw)


def setup(cfg, grid=3):
    pipe = pipeline.RenderPipeline(cfg, "cpu")
    host = myscene.build(oscillator_grid=grid, device="cpu")
    return pipe, pipe.init_state(host), pipe.default_camera_pose(host)


def close_pose():
    """A pose close above the scene (most rays hit), so that the deep
    segment of a small frame fills 128 slots."""
    eye = np.array((0.0, 2.5, -4.0), np.float32)
    fwd = np.array((0.0, 0.5, 0.0), np.float32) - eye
    return pipeline.CameraPose(
        position=torch.from_numpy(eye),
        forward=torch.from_numpy(fwd / np.linalg.norm(fwd)),
        up=torch.tensor((0.0, 1.0, 0.0)))


def bits(t):
    return t if t.dtype == torch.bool else t.reshape(-1).view(torch.uint8)


def tensor_leaves(tree):
    return [(p, t) for p, t in leaves(tree) if isinstance(t, torch.Tensor)]


def assert_same_bits(a, b):
    la, lb = tensor_leaves(a), tensor_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(bits(x), bits(y)), p


@pytest.mark.parametrize("probe", ["item", "int", "tensor", "as_tensor",
                                   "nonzero"])
def test_audit_sees_host_reads(audit, probe):
    """The audit is not vacuous: each kind of host traffic reaches it."""
    x = torch.arange(4.0)
    with graphs.PIECE_MODE():
        {"item": lambda: x.sum().item(), "int": lambda: int(x[1]),
         "tensor": lambda: torch.tensor([1.0, 2.0]),
         "as_tensor": lambda: torch.as_tensor(0.5),
         "nonzero": lambda: torch.nonzero(x)}[probe]()
    assert audit, probe


@pytest.mark.parametrize("frame", ["default", "restir"])
def test_pipeline_pieces_make_no_host_traffic(audit, frame):
    """Two frames (SHARC update, then skip) of the graph callable's pieces
    after one eager warm-up frame: no host read, no host-made tensor."""
    cfg = small_default() if frame == "default" else \
        pipeline.restir_frame_config(48, 32, 3)
    pipe, state, pose = setup(cfg)
    # The warm-up frame, with the inputs the callable passes (the pose as
    # the previous pose).
    pipe.render_frame(state, pose, prev_pose=pose)
    call = pipe.render_frame_graph()
    s1, img = call(state, pose)
    s2, _ = call(s1, pose, 1.0 / 90.0, reset=True)
    assert audit == []
    assert s2.frame_count == 2 and call.stats.frames == 2
    assert torch.isfinite(img).all()


def trace_setup(capacity=0):
    host = myscene.build(oscillator_grid=3, device="cpu")
    pos = np.array([0.0, 1.0, -5.0])
    cam = camera.make_camera(tuple(pos), tuple(-pos / np.linalg.norm(pos)),
                             aspect=1.0, device="cpu")
    plan = clusters.build_plan_morton(host.scene.center.numpy(),
                                      host.scene.radius.numpy(),
                                      max_members=32, device="cpu")
    cfg = pathtrace.PathTraceConfig(width=48, height=48, bounces=8,
                                    compact_capacity=capacity,
                                    block_size=4096)
    return host.scene, cam, plan, cfg


def test_trace_pieces_make_no_host_traffic(audit):
    """The headline frame (accel, G-buffer, trace) with a spilling deep
    segment: pieces A, S and B make no host traffic."""
    scene, cam, plan, cfg = trace_setup(capacity=128)
    call = pathtrace.trace_image_graph(cfg, plan)
    call(scene, cam, 2)                 # the warm-up frame
    audit.clear()
    out = call(scene, cam, 3)
    assert audit == []
    assert out.spill_waves == 1 and call.stats.spill_waves == 2


def counted_waves(monkeypatch):
    """The `wave` of every deep-segment trace."""
    waves = []
    inner = pathtrace._trace_deep_compact

    def traced(*args, **kw):
        waves.append(kw.get("wave", 0))
        return inner(*args, **kw)
    monkeypatch.setattr(pathtrace, "_trace_deep_compact", traced)
    return waves


@pytest.mark.parametrize("capacity", [128, 0])
def test_spill_frame_matches_eager(monkeypatch, capacity):
    """A default frame through the callable's pieces equals render_frame's
    bit for bit; at 128 slots it runs the second wave (spill_waves 1), at
    the default capacity none."""
    pipe, state, _ = setup(small_default())
    pose = close_pose()
    if capacity:
        base = pipe._pt_cfg
        monkeypatch.setattr(pipe, "_pt_cfg", lambda: dataclasses.replace(
            base(), compact_capacity=capacity))
    waves = counted_waves(monkeypatch)
    want_state, want = pipe.render_frame(state, pose)
    eager_waves = list(waves)
    waves.clear()
    call = pipe.render_frame_graph()
    got_state, got = call(state, pose)
    assert waves == eager_waves
    assert call.stats.spill_waves == (1 if capacity else 0)
    assert waves == ([0, 1] if capacity else [0])
    assert torch.equal(bits(got), bits(want))
    assert_same_bits(got_state, want_state)


def test_physics_takes_a_device_dt():
    """dt as a 0-d float32 tensor: bit for bit the float call; within the
    physics test's tolerances of the reference jitted with a traced dt
    (30 steps of varying dt, one above the clamp)."""
    host = jmyscene.build(oscillator_grid=4)
    jb = host.bodies
    tb = convert.rigid_bodies(jax.tree.map(np.asarray, jb), "cpu")
    fb = tb
    step = jax.jit(lambda b, dt: jphysics.step(b, dt, True, True))
    on = torch.tensor(True)
    for i in range(30):
        dt = (1.0 / 60.0, 1.0 / 120.0, 1.0 / 30.0)[i % 3]
        jb = step(jb, jnp.float32(dt))
        tb = physics.step(tb, torch.tensor(dt, dtype=torch.float32), on, on)
        fb = physics.step(fb, dt, on, on)
        for name in ("position", "velocity", "rotation"):
            assert torch.equal(getattr(tb, name), getattr(fb, name)), name
    for name, atol in (("position", 1e-5), ("velocity", 1e-4),
                       ("rotation", 1e-6)):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)),
                                   rtol=0, atol=atol, err_msg=name)


def test_refusals(monkeypatch):
    """A group other than the first call's raises; so does a call after a
    global the capture baked in changed (the MXU opt-in on the frame, its
    precision on the trace)."""
    pipe, state, pose = setup(small_default())
    call = pipe.render_frame_graph()
    call(state, pose)
    with pytest.raises(ValueError, match="group"):
        call(state, pose, group=object())
    monkeypatch.setattr(clusters, "_USE_MXU", not clusters._USE_MXU)
    with pytest.raises(ValueError, match="_USE_MXU"):
        call(state, pose)
    scene, cam, plan, cfg = trace_setup()
    trace = pathtrace.trace_image_graph(
        dataclasses.replace(cfg, width=8, height=8, bounces=2), plan)
    trace(scene, cam, 0)
    monkeypatch.setattr(ik, "MXU_PREC", "highest" if ik.MXU_PREC != "highest"
                        else "high")
    with pytest.raises(ValueError, match="MXU_PREC"):
        trace(scene, cam, 1)


class FakeCapture:
    """A capture whose replay re-runs the captured function and writes its
    results into the outputs the capture returned, as a CUDA graph
    replay writes its fixed output buffers."""

    @classmethod
    def capture(cls, fn, pool, stream):
        fake = cls()
        fake.fn, fake.outputs = fn, fn()
        fake.launches, fake.spills, fake.seconds = {}, [], 0.0
        return fake

    def replay(self, stats):
        out, waves = graphs.run_pieces(self.fn)
        graphs.write_tree(self.outputs, out)
        stats.frames += 1
        stats.spill_waves += waves
        return waves


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    monkeypatch.setattr(graphs, "Captured", FakeCapture)
    monkeypatch.setattr(graphs, "warm_up", lambda fn, stream: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: None)


@pytest.mark.parametrize("frame", ["default", "restir"])
def test_buffers_chain_as_replays(fake_card, frame):
    """Five frames at 32x16 (dt changing, a reset, a resume from a clone
    of the returned state at each cadence phase): images and every state
    leaf bit for bit the eager frames'."""
    cfg = dataclasses.replace(
        small_default() if frame == "default"
        else pipeline.restir_frame_config(48, 32, 3),
        output_width=32, output_height=16, render_width=32,
        render_height=16, bounces=2)
    pipe, state, pose = setup(cfg)
    call = pipe.render_frame_graph()
    got = want = state
    for f in range(5):
        dt, reset = (1 / 120 if f == 1 else 1 / 60), f == 2
        got, image = call(got, pose, dt, reset=reset)
        want, expect = pipe.render_frame(want, pose, dt, reset=reset)
        assert torch.equal(bits(image), bits(expect)), f
        assert_same_bits(got, want)
        assert got.frame_count == want.frame_count == f + 1
        if f in (2, 3):
            got = graphs.clone_tree(got)
    assert call.stats.frames == 5 and call.cycle == 2


def test_session_captures_again_after_a_static_change(fake_card):
    """Session(graph=True) through a static change (3 to 2 bounces, which
    also changes the counters' keys) equals the eager Session (16x16
    output, rendered at 8x8)."""
    from drts_tpu_torch import config, session
    s = config.GraphicsSettings(render_width=16, render_height=16)
    s = dataclasses.replace(
        s, raytracing=dataclasses.replace(s.raytracing, bounces=3),
        sharc=dataclasses.replace(s.sharc, capacity_log2=12)).check()
    runs = []
    for graph in (False, True):
        sess = session.Session(
            s, host=myscene.build(oscillator_grid=3, device="cpu"),
            device="cpu", graph=graph)
        images = []
        for i in range(3):
            if i == 1:
                assert sess.set("raytracing.bounces", "2") == "static"
            images.append(sess.step().clone())
        runs.append(images)
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))


def test_session_defaults_to_the_graph_frame():
    """Session() steps through the graph callable (its pieces here) and
    equals Session(graph=False) bit for bit (16x16 output, rendered at
    8x8, three frames)."""
    from drts_tpu_torch import config, session
    s = config.GraphicsSettings(render_width=16, render_height=16)
    s = dataclasses.replace(
        s, sharc=dataclasses.replace(s.sharc, capacity_log2=12)).check()
    runs = []
    for kw in ({}, {"graph": False}):
        sess = session.Session(
            s, host=myscene.build(oscillator_grid=3, device="cpu"),
            device="cpu", **kw)
        assert sess.graph == (kw == {})
        runs.append([sess.step().clone() for _ in range(3)])
        assert (sess._frame is not None) == sess.graph
    for a, b in zip(*runs):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("recipe", ["", "--default-frame", "--mesh",
                                    "--record"])
@pytest.mark.parametrize("eager", [False, True])
def test_bench_cli_runs_graph_frames_unless_eager(monkeypatch, capsys,
                                                  recipe, eager):
    """``python -m drts_tpu_torch.bench --device cpu`` hands every recipe,
    the record included, graph=True, and graph=False with --eager (the
    benches stubbed: a 1080p frame is the card's work)."""
    import json

    from drts_tpu_torch import bench
    seen = {}
    image = torch.zeros(2, 2, 3)
    out = pathtrace.TraceOutput(*([image] * 9), rays_traced=torch.ones(()),
                                counters={"wavefront_overflow_paths":
                                          torch.zeros(())})
    stats = {"frame_ms": 1.0, "mray_s": 1.0, "rays_per_frame": 1.0,
             "overflow_paths": 0.0, "frames": 2, "spill_waves": 0,
             "frame_ms_each": [1.0], "frame_ms_median": 1.0,
             "peak_memory_bytes": 0, "graph": {}}

    def stub(result):
        def fn(**kw):
            seen.update(kw)
            st = dict(stats)
            if not kw["graph"]:
                del st["graph"]
            return st, result
        return fn
    monkeypatch.setattr(bench, "bench_trace", stub(out))
    monkeypatch.setattr(bench, "bench_mesh", stub(out))
    monkeypatch.setattr(bench, "bench_frame", stub(image))

    def record(device, fast=False, fidelity_path="", graph=False):
        seen.update(device=device, graph=graph)
        return {"metric": "path_trace_1080p_1spp_8bounce"}, []
    monkeypatch.setattr(bench, "record", record)
    argv = ["--device", "cpu", "--iters", "1"] + ([recipe] if recipe else [])
    bench.main(argv + (["--eager"] if eager else []))
    text = capsys.readouterr()
    line = json.loads(text.out.strip().splitlines()[-1])
    assert seen["graph"] is not eager
    assert torch.device(seen["device"]).type == "cpu"
    # The frame and mesh lines carry a graph frame's stats; the headline
    # line keeps the reference's keys and notes them on stderr.
    assert ("graph" in line) == (not eager and recipe in ("--mesh",
                                                          "--default-frame"))
    if not recipe:
        assert ('"graph"' in text.err) == (not eager)
        assert "frame_ms_each" not in line
