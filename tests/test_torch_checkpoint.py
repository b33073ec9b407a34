"""The port's checkpoints (``utils/checkpoint.py``) and frame timer
(``utils/timer.py``), port only.

A checkpoint is a flat ``{dotted.path: tensor}`` dict of the whole
``FrameState`` (the host frame count and the counters included), written
by ``torch.save`` and read with ``weights_only=True``. The default frame
graph at 16x16 (2 bounces, a 4,096-slot SHARC cache updated every second
frame by the host frame count) on the CPU is deterministic, so a run cut
off and resumed from its rotating checkpoint must give the uninterrupted
run's images bit for bit; a resume that lost the frame count would run
the SHARC update on the other parity.
"""

import dataclasses
import os

import pytest
import torch

from drts_tpu_torch.models import myscene, pipeline
from drts_tpu_torch.ops import sharc
from drts_tpu_torch.utils import checkpoint, timer

W = H = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the same cores, and this module's small frames lose most of their
    time to the workers' OpenMP threads contending (~10x in a six-worker
    run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(width=W):
    cfg = pipeline.PipelineConfig(
        output_width=width, output_height=width, render_width=width,
        render_height=width, bounces=2, block_size=1024,
        sharc=sharc.SHARCConfig(capacity_log2=12))
    pipe = pipeline.RenderPipeline(cfg, "cpu")
    host = myscene.build(oscillator_grid=2, device="cpu")
    return pipe, host, pipe.default_camera_pose(host)


def _frames(pipe, state, pose, n):
    img = None
    for _ in range(n):
        state, img = pipe.render_frame(state, pose)
    return state, img


def _assert_states_equal(a, b):
    fa, fb = checkpoint.flatten(a), checkpoint.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def test_round_trip(tmp_path):
    pipe, host, pose = _pipeline()
    state, _ = _frames(pipe, pipe.init_state(host), pose, 3)
    path = str(tmp_path / "ckpt")
    checkpoint.save(state, path)
    restored = checkpoint.restore(pipe.init_state(host), path)
    assert restored.frame_count == 3 and isinstance(restored.frame_count,
                                                    int)
    assert int(restored.frame_index) == 3
    assert set(restored.counters) == set(state.counters)
    _assert_states_equal(restored, state)
    assert isinstance(restored.bodies.earth_index, int)
    assert restored.bodies.spring_rest_y == state.bodies.spring_rest_y


def test_file_is_a_flat_tensor_dict(tmp_path):
    pipe, host, pose = _pipeline()
    state, _ = _frames(pipe, pipe.init_state(host), pose, 1)
    checkpoint.save_rotating(state, str(tmp_path))
    flat = torch.load(str(tmp_path / "s0.pt"), weights_only=True)
    assert isinstance(flat, dict)
    assert all(isinstance(v, torch.Tensor) for v in flat.values())
    assert int(flat["frame_count"]) == 1 and "counters.lights_dropped" in flat
    assert tuple(flat["taa.history"].shape) == (H, W, 3)


@pytest.mark.parametrize("cut_after,saved_at", [(5, 4), (4, 3)])
def test_preempted_run_resumes_bit_exact(tmp_path, cut_after, saved_at):
    """Checkpoints every `saved_at` frames, the run killed after frame
    `cut_after`: the resumed run replays from frame `saved_at` through a
    SHARC update and a skip frame to the uninterrupted run's image and
    whole state, bit for bit."""
    pipe, host, pose = _pipeline()
    total = saved_at + 2
    golden_state, golden = _frames(pipe, pipe.init_state(host), pose, total)

    ckpt_dir = str(tmp_path / "ckpt")
    state = pipe.init_state(host)
    for i in range(cut_after):
        state, _ = pipe.render_frame(state, pose)
        if (i + 1) % saved_at == 0:
            checkpoint.save_rotating(state, ckpt_dir)
    del state

    pipe2, host2, pose2 = _pipeline()
    resumed, ok = checkpoint.resume_or_init(pipe2, ckpt_dir, host2)
    assert ok
    assert resumed.frame_count == saved_at == int(resumed.frame_index)
    state, img = _frames(pipe2, resumed, pose2, total - saved_at)
    assert torch.equal(img, golden)
    # At this size the cache adds nothing visible within six frames; the
    # SHARC update's parity shows in the state (a resume from frame 3 that
    # lost the frame count would update the cache on the other frames).
    _assert_states_equal(state, golden_state)


@pytest.mark.parametrize("tear", ["deleted", "truncated", "emptied",
                                  "garbage"])
def test_torn_save_leaves_the_previous_slot(tmp_path, tear):
    pipe, host, pose = _pipeline()
    ckpt_dir = str(tmp_path / "ckpt")
    state, _ = _frames(pipe, pipe.init_state(host), pose, 1)
    assert checkpoint.save_rotating(state, ckpt_dir) == "s0"
    state, _ = _frames(pipe, state, pose, 1)
    slot = checkpoint.save_rotating(state, ckpt_dir)
    assert slot == "s1"
    slot_path = os.path.join(ckpt_dir, slot + ".pt")
    if tear == "deleted":
        os.remove(slot_path)
    elif tear == "garbage":
        with open(slot_path, "wb") as f:
            f.write(b"not a checkpoint" * 64)
    else:
        keep = os.path.getsize(slot_path) // 2 if tear == "truncated" else 0
        with open(slot_path, "r+b") as f:
            f.truncate(keep)
    restored, ok = checkpoint.resume_or_init(pipe, ckpt_dir, host)
    assert ok
    assert restored.frame_count == 1 == int(restored.frame_index)


def test_missing_directory_gives_a_fresh_state(tmp_path):
    pipe, host, _ = _pipeline()
    state, ok = checkpoint.resume_or_init(pipe, str(tmp_path / "nope"), host)
    assert not ok
    assert state.frame_count == 0 and int(state.frame_index) == 0
    # The legacy single-path layout: save(state, dirpath).
    legacy = str(tmp_path / "legacy")
    checkpoint.save(dataclasses.replace(state, frame_count=7), legacy)
    restored, ok = checkpoint.resume_or_init(pipe, legacy, host)
    assert ok and restored.frame_count == 7


@pytest.mark.parametrize("fault", ["shape", "missing", "extra"])
def test_mismatch_raises(tmp_path, fault):
    pipe, host, _ = _pipeline()
    state = pipe.init_state(host)
    ckpt_dir = str(tmp_path / "ckpt")
    if fault == "shape":
        small, small_host, _ = _pipeline(width=32)
        checkpoint.save_rotating(small.init_state(small_host), ckpt_dir)
    else:
        flat = checkpoint.flatten(state)
        if fault == "missing":
            del flat["reservoirs.w_out"]
        else:
            flat["counters.unknown"] = torch.zeros(())
        os.makedirs(ckpt_dir)
        torch.save(flat, os.path.join(ckpt_dir, "s0.pt"))
    with pytest.raises(checkpoint.CheckpointMismatch):
        checkpoint.resume_or_init(pipe, ckpt_dir, host)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("fixed", [None, 0.25])
def test_step_timer(monkeypatch, fixed):
    """Variable step: one update per tick with the elapsed time, clamped
    to 1 s after a stall; fixed step: as many updates as whole steps
    elapsed, the rest carried. FPS over each second of ticks."""
    clock = _Clock()
    monkeypatch.setattr(timer.time, "perf_counter", clock)
    t = timer.StepTimer(fixed_timestep=fixed)
    calls = []
    for dt in (0.125, 0.625, 5.0, 0.375):
        clock.now += dt
        t.tick(calls.append)
    if fixed is None:
        assert calls == [0.125, 0.625, 1.0, 0.375]
        assert t.frame_count == 4 and t.total_seconds == 2.125
        # ticks 1-3 made 1.75 s: 3 frames / 1.75 s
        assert t.frames_per_second == 3 / 1.75
    else:
        # 0.125 -> no step; 0.75 -> 3; 1.0 (clamped) -> 4; 0.375 -> 1
        # (0.125 carried)
        assert calls == [0.25] * 8 and t.frame_count == 8
        assert t.total_seconds == 2.0
        assert t.frames_per_second == 7 / 1.75
