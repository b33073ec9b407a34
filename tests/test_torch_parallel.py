"""The port's sharded multi-device frame (``drts_tpu_torch/parallel``,
``drts_tpu_torch/graft_entry.py``) against the reference's sharded one.

The ranks are real processes: ``multihost.spawn`` starts them with gloo on
the CPU, each importing only the port (``graft_entry``'s workers), and
each pinned to one intra-op thread (``OMP_NUM_THREADS=1``), as this
module's own process is. The reference runs here, on its 8-device virtual
CPU mesh, on its XLA path.

- ``frame_state_placement`` gives, path by path, what the reference's
  ``frame_state_sharding`` gives the same (converted) state: "rows" where
  an image-height leaf is ``P("rows", ...)``, "slots" where a SHARC table
  is, "replicated" where the sharding is ``P()``.
- ``row_band`` gives each device the rows of the reference's row sharding
  where the height divides, and covers every row in bands one row apart
  where it does not (270 / 4, the SHARC update trace at 1080p: the
  reference replicates such buffers); ``process_local_rows`` degenerates
  to the whole frame in one process, as the reference's does.
- ``multihost.initialize()`` returns False with no coordinator.
- A 2-rank banded ``trace_image`` at 16x32 against the reference's
  2-device sharded one (the recipe of tests/test_parallel.py), within its
  1e-5.
- A band of a 96x96 trace holds the whole frame's deep-segment capacity
  (not its own rows' share), so it spills only where the whole frame
  does; its radiance is the frame's rows bit for bit.
- A 2-rank sharded ``render_frame`` at 32x32, two frames (2 bounces,
  ReSTIR, ReBLUR, TAA) from the demo scene's camera (oscillator grid 3),
  from ``RenderPipeline.shard_state`` of the one-device start state:
  each rank's image band and every per-row leaf the one-device frames'
  rows, every per-slot leaf the one-device cache's slot range, every
  replicated leaf the one-device leaf; with SHARC off bit for bit, with
  SHARC on (a 4,096-slot cache, updated on frame 0) within
  tests/test_parallel.py's ``assert_f16_close`` bound (every value within
  1.5 f16 ULP, at most 1% beyond 2e-4; integer leaves exact; the f16
  halves of packed words within one step) of the one-device frames. The
  gathered image is held within tests/test_torch_default_frame.py's
  bounds of the reference's 2-device sharded frames under one jit (frame
  0: mean <= 2e-4, off by more than 1e-3 on <= 2% of pixels; frame 1:
  mean <= 4e-3, off by more than 0.02 on <= 12% and by more than 0.05 on
  <= 3%). After the frames every leaf is shaped as
  ``frame_state_placement`` says (a band of 16 rows, a range of 2,048
  slots, or whole), the replicated leaves are equal on both ranks
  (``replica_checksums``) and each rank's band is the one
  ``process_local_rows`` gives it. (The close-up pose of
  tests/test_torch_default_frame.py does not fit those bounds here on
  the reference's XLA path: its fused multiply-adds move a few hit points,
  and at 32x32 a few pixels carry the mean: 6.6e-4 on frame 0 one device
  against one device, as banded. That test runs the reference in
  interpret mode at 64x64.)
- The same ranks' frames through ``render_frame_graph()(..., group=)``
  (the pieces a capture records, run eagerly on the CPU) from the
  one-device start state: images and final shards bit for bit the eager
  sharded frames', so also within the reference's bounds above; an
  ``OpLog`` around every piece finds no host read and no host-made
  tensor; at a deep-segment capacity of 2 slots the frame spills (piece
  S runs) and equals the eager frame at that capacity, and no spill wave
  issues a collective; a later call without the group raises, and
  ``graph_refusal`` refuses the gloo group on the card.
- 3 ranks of a frame of other options (``options_config``: upscaled,
  ReLAX, shared-offset pairwise ReSTIR with the real previous surface,
  Catmull-Rom TAA history, chromatic aberration, the NRD validation
  view; 16 render rows, so its buffers stay whole between frames): bit
  for bit the one-device frames.
- The exchanges on 2 and 3 ranks of a 13-row frame (uneven bands):
  ``Band.halo``'s clamped rows give a band the rows of ``post._shift``
  and ``denoise._shift_chw`` of the whole frame, its cyclic rows those of
  ``torch.roll``; ``Band.reduce_scatter`` in both forms gives each rank
  its rows of the sum and the max over the ranks; ``Band.gather`` the
  whole frame.
- B4's plain version with a row offset (the sharded frame's history
  fetch) gives the band's rows of the whole frame's, in both modes at 2,
  5 and 12 words.
- ``dryrun_multichip(2, device="cpu")``: the reference's dry-run recipe
  (a 64x64 frame and a 32x32 mesh trace) sharded over two spawned ranks.
"""

import os

import jax
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.ops import camera as jcamera, pathtrace as jpathtrace
from drts_tpu.ops import sharc as jsharc
from drts_tpu.parallel import mesh as jmesh, multihost as jmultihost
from drts_tpu_torch import convert, graft_entry
from drts_tpu_torch.models import myscene as tmyscene, pipeline as tpipeline
from drts_tpu_torch.ops import camera as tcamera, pathtrace as tpathtrace
from drts_tpu_torch.ops import denoise as tdenoise, post as tpost
from drts_tpu_torch.ops import reproject_kernels as trp
from drts_tpu_torch.ops import sharc as tsharc
from drts_tpu_torch.parallel import mesh, multihost
from drts_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs multiple (virtual) devices")

W = H = 32
FRAMES = 2
# The deep-segment capacity of frames_worker's spilling frame.
SPILL_CAPACITY = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the spawned ranks: the suite runs
    six workers on the same cores."""
    n = torch.get_num_threads()
    old = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if old is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = old


def small_config(cls, sharc_cls, **kw):
    return cls(output_width=W, output_height=H, render_width=W,
               render_height=H, bounces=2, block_size=4096,
               sharc=sharc_cls(capacity_log2=12), **kw)


def jax_path(path) -> str:
    """A jax key path as the port's dotted path."""
    parts = []
    for k in path:
        for attr in ("name", "key", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


@pytest.mark.parametrize("n", [2, 3])
def test_placement_matches_the_reference_sharding(n):
    cfg = dict(output_width=32, output_height=32, render_width=16,
               render_height=16, upscaling=True)
    jp = jpipeline.RenderPipeline(jpipeline.PipelineConfig(
        sharc=jsharc.SHARCConfig(capacity_log2=12), **cfg))
    jstate = jp.init_state(jmyscene.build(oscillator_grid=1))
    heights, slots = (16, 32), (1 << 12,)
    sharding = jmesh.frame_state_sharding(jstate, jmesh.make_mesh(n),
                                          image_heights=heights,
                                          slot_table_sizes=slots)
    tstate = convert.frame_state(jax.tree.map(np.asarray, jstate), "cpu")
    placed = mesh.frame_state_placement(tstate, heights, slots, n)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jstate)
    kinds = set()
    for path, leaf in leaves:
        name = jax_path(path)
        spec = jax.tree_util.tree_flatten_with_path(sharding)[0]
        sh = dict((jax_path(p), s) for p, s in spec)[name]
        if sh.spec == jax.sharding.PartitionSpec():
            want = mesh.REPLICATED
        elif leaf.shape[0] in slots:
            want = mesh.SLOTS
        else:
            want = mesh.ROWS
        assert sh.spec in (jax.sharding.PartitionSpec(),) or \
            sh.spec[0] == "rows", (name, sh.spec)
        assert placed[name] == want, (name, placed[name], want)
        kinds.add(want)
    # Both sizes divide by 2, neither by 3.
    assert kinds == ({mesh.ROWS, mesh.SLOTS, mesh.REPLICATED} if n == 2
                     else {mesh.REPLICATED})
    assert placed["frame_count"] == mesh.REPLICATED   # the port's host int


@pytest.mark.parametrize("height,n", [(16, 2), (64, 4), (1080, 8),
                                      (32, 8)])
def test_row_bands_match_the_reference_row_sharding(height, n):
    sharding = jmesh.row_sharded(jmesh.make_mesh(n), 2)
    x = jax.device_put(jax.numpy.zeros((height, 4)), sharding)
    got = {}
    for shard in x.addressable_shards:
        rows = shard.index[0]
        got[shard.device] = (rows.start or 0, rows.stop or height)
    devices = list(jmesh.make_mesh(n).devices.flat)
    for r, dev in enumerate(devices):
        assert mesh.row_band(height, r, n) == got[dev]
    assert multihost.process_local_rows(height) == \
        jmultihost.process_local_rows(height) == (0, height)


@pytest.mark.parametrize("height,n", [(270, 4), (1080, 7), (5, 3)])
def test_uneven_row_bands_cover_the_frame(height, n):
    """Where the height does not divide, the reference replicates; the
    port bands anyway, one row apart at most."""
    bands = [mesh.row_band(height, r, n) for r in range(n)]
    assert bands[0][0] == 0 and bands[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    sizes = {e - s for s, e in bands}
    assert sizes <= {height // n, height // n + 1}
    if (height, n) == (270, 4):
        assert bands == [(0, 67), (67, 135), (135, 202), (202, 270)]


def test_initialize_without_a_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert jmultihost.initialize() is False
    assert multihost.global_group() is None
    with pytest.raises(ValueError):
        multihost._device_and_backend("cpu", "nccl", 0)


def test_banded_trace_matches_the_reference_sharded_trace(tmp_path):
    host = jmyscene.build(oscillator_grid=1)
    h, w = 16, 32
    cam = jcamera.make_camera(host.camera_position, host.camera_forward,
                              aspect=w / h)
    cfg = jpathtrace.PathTraceConfig(width=w, height=h, bounces=1,
                                     block_size=512)
    sharded = jax.jit(
        lambda s, c: jpathtrace.trace_image(s, c, cfg, 0).radiance,
        out_shardings=jmesh.image_sharding(jmesh.make_mesh(2)))(
            host.scene, cam)
    assert len(sharded.sharding.device_set) == 2
    tcfg = tpathtrace.PathTraceConfig(width=w, height=h, bounces=1,
                                      block_size=512)
    multihost.spawn(graft_entry.trace_worker, 2, "cpu",
                    args=(tcfg, 1, str(tmp_path), "cpu"))
    banded = torch.load(tmp_path / "trace.pt")
    np.testing.assert_allclose(banded.numpy(), np.asarray(sharded),
                               atol=1e-5)


def test_band_holds_the_whole_frames_capacity(monkeypatch):
    """A band's deep segment gets the whole frame's capacity, so it spills
    only where the whole frame does: at 96x96 with compact_fraction 8 the
    frame's capacity is 2048 slots, where half the rows alone would give
    1024. Each band's radiance is the whole frame's rows bit for bit."""
    caps = []
    deep = tpathtrace._deep_with_spill

    def spy(*args, **kw):
        caps.append(args[10])
        return deep(*args, **kw)
    monkeypatch.setattr(tpathtrace, "_deep_with_spill", spy)
    host = tmyscene.build(oscillator_grid=3, device="cpu")
    h = w = 96
    cam = tcamera.make_camera(host.camera_position, host.camera_forward,
                              aspect=1.0, device="cpu")
    cfg = tpathtrace.PathTraceConfig(width=w, height=h, bounces=2,
                                     block_size=4096, compact_fraction=8)
    whole = tpathtrace.trace_image(host.scene, cam, cfg, 0)
    for band in mesh.row_band(h, 0, 2), mesh.row_band(h, 1, 2):
        out = tpathtrace.trace_image(host.scene, cam, cfg, 0, rows=band)
        assert out.spill_waves <= whole.spill_waves, band
        assert torch.equal(out.radiance, whole.radiance[band[0]:band[1]])
    assert caps == [2048] * 3


def assert_f16_close(a, b, name):
    """tests/test_parallel.py's bound: every value within ~1.5 f16 ULP,
    >= 99% of values within 2e-4 (relative, scale at least 1)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    rel = np.abs(a - b) / scale
    assert rel.max() <= 1.5 * 2.0 ** -11, (name, rel.max())
    assert (rel > 2e-4).mean() <= 0.01, (name, (rel > 2e-4).mean())


# Leaves of 32-bit words (f16 pairs, packed normals, SHARC's meta bits).
WORD_LEAVES = ("denoiser.packed", "denoiser.packed_spec", "taa.packed",
               "sharc.packed")


def assert_leaf_close(path, a, b):
    """A leaf of the SHARC frame against the one-device one: integers
    exact, floats within assert_f16_close, each 16-bit half of a packed
    word within one step of the other's."""
    if path in WORD_LEAVES:
        wa = a.contiguous().view(torch.int32).long() & 0xFFFFFFFF
        wb = b.contiguous().view(torch.int32).long() & 0xFFFFFFFF
        for shift in (0, 16):
            d = (((wa >> shift) & 0xFFFF) - ((wb >> shift) & 0xFFFF)).abs()
            assert int(d.max()) <= 1, (path, int(d.max()))
    elif a.dtype.is_floating_point:
        assert_f16_close(a.numpy(), b.numpy(), path)
    else:
        assert torch.equal(a, b), path


def _one_device(cfg):
    pipe, state, pose = graft_entry._setup(cfg, "cpu", 3)
    out = []
    for _ in range(FRAMES):
        state, img = pipe.render_frame(state, pose)
        out.append((state, img))
    return pipe, out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The port: 2-rank sharded and one-device frames with SHARC off and
    on; the reference: its 2-device sharded frames (SHARC on) under one
    jit."""
    cfgs = [small_config(tpipeline.PipelineConfig, tsharc.SHARCConfig,
                         sharc_enabled=on) for on in (False, True)]
    tmp = tmp_path_factory.mktemp("ranks")
    multihost.spawn(graft_entry.frames_worker, 2, "cpu",
                    args=(cfgs, FRAMES, str(tmp), 3, None, "cpu",
                          SPILL_CAPACITY))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    out_spill = [torch.load(tmp / f"spill{r}.pt", weights_only=False)
                 for r in range(2)]
    out = {on: ([runs[i] for runs in ranks], _one_device(cfg))
           for i, (on, cfg) in enumerate(zip((False, True), cfgs))}

    jcfg = small_config(jpipeline.PipelineConfig, jsharc.SHARCConfig)
    jp = jpipeline.RenderPipeline(jcfg)
    host = jmyscene.build(oscillator_grid=3)
    jstate = jp.init_state(host)
    pose = jp.default_camera_pose(host)
    jm = jmesh.make_mesh(2)
    state_sh = jmesh.frame_state_sharding(
        jstate, jm, image_heights=(H,),
        slot_table_sizes=(int(jstate.sharc.fingerprint.shape[0]),))
    pose_sh = jax.tree.map(lambda _: jmesh.replicated(jm), pose)
    step = jax.jit(lambda s, p: jp.render_frame(s, p, 1.0 / 60.0),
                   in_shardings=(state_sh, pose_sh),
                   out_shardings=(state_sh, jmesh.image_sharding(jm)))
    jstate = jax.device_put(jstate, state_sh)
    pose = jax.device_put(pose, pose_sh)
    ref = []
    for _ in range(FRAMES):
        jstate, img = step(jstate, pose)
        assert len(img.sharding.device_set) == 2
        ref.append(np.asarray(img))
    out["reference"] = ref
    out["spill"] = out_spill
    return out


def _shard_of(pipe, state, path, leaf, r, n=2):
    """Rank r's shard of the one-device `state`'s leaf at `path`."""
    placed = pipe.placement(state, n)
    if placed[path] == mesh.REPLICATED:
        return leaf
    s, e = mesh.row_band(leaf.shape[0], r, n)
    return leaf[s:e]


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_equal_one_device_without_sharc(frames, i):
    ranks, (pipe, one) = frames[False]
    for r, run in enumerate(ranks):
        s, e = mesh.row_band(H, r, 2)
        assert torch.equal(run["images"][i], one[i][1][s:e])
    if i == FRAMES - 1:
        state = one[-1][0]
        flat = dict(checkpoint.leaves(state))
        for r, run in enumerate(ranks):
            for path, leaf in checkpoint.leaves(run["state"]):
                want = flat[path]
                if isinstance(leaf, torch.Tensor):
                    want = _shard_of(pipe, state, path, want, r)
                    assert torch.equal(leaf, want), path
                else:
                    assert leaf == want, path
            for path, leaf in checkpoint.leaves(run["gathered"]):
                if isinstance(leaf, torch.Tensor):
                    assert torch.equal(leaf, flat[path]), path


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_near_one_device_with_sharc(frames, i):
    ranks, (pipe, one) = frames[True]
    state, img = one[i]
    for r, run in enumerate(ranks):
        s, e = mesh.row_band(H, r, 2)
        assert_f16_close(run["images"][i].numpy(), img[s:e].numpy(),
                         "image")
    if i == FRAMES - 1:
        flat = dict(checkpoint.leaves(state))
        for r, run in enumerate(ranks):
            for path, leaf in checkpoint.leaves(run["state"]):
                if isinstance(leaf, torch.Tensor):
                    assert_leaf_close(path, leaf, _shard_of(
                        pipe, state, path, flat[path], r))
            for k, v in state.counters.items():
                assert float(run["state"].counters[k]) == float(v), k


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_match_the_reference_sharded_frame(frames, i):
    ranks, _ = frames[True]
    jimg = frames["reference"][i]
    timg = torch.cat([run["images"][i] for run in ranks]).numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    d = np.abs(timg - jimg)
    off = d.max(-1)
    if i == 0:
        assert d.mean() <= 2e-4, d.mean()
        assert (off > 1e-3).mean() <= 0.02
    else:
        assert d.mean() <= 4e-3, d.mean()
        assert (off > 0.02).mean() <= 0.12
        assert (off > 0.05).mean() <= 0.03


@pytest.mark.parametrize("sharc_on", [False, True])
def test_replicas_and_bands(frames, sharc_on):
    """The replicated leaves are the same on both ranks, and nothing
    else is compared across them: the per-row and per-slot leaves are
    each rank's own shard. Each rank's band is process_local_rows'."""
    ranks, (pipe, one) = frames[sharc_on]
    sums = [r["checksums"] for r in ranks]
    assert sums[0] == sums[1]
    assert not mesh.replicas_differ(sums[0])
    assert all(len(v) == 2 for v in sums[0].values())
    placed = pipe.placement(one[-1][0], 2)
    assert set(sums[0]) == {p for p, k in placed.items()
                            if k == mesh.REPLICATED}
    assert [r["band"] for r in ranks] == [(0, H // 2), (H // 2, H)]


@pytest.mark.parametrize("sharc_on", [False, True])
def test_sharded_leaves_follow_the_placement(frames, sharc_on):
    """After the frames, each rank holds what frame_state_placement says
    of the one-device state: a band of 16 of the 32 rows, half of the
    4,096 SHARC slots, or the whole leaf."""
    ranks, (pipe, one) = frames[sharc_on]
    state = one[-1][0]
    placed = mesh.frame_state_placement(state, (H,), (1 << 12,), 2)
    kinds = set()
    for r, run in enumerate(ranks):
        assert run["misplaced"] == []
        flat = dict(checkpoint.leaves(run["state"]))
        for path, leaf in checkpoint.leaves(state):
            if not isinstance(leaf, torch.Tensor):
                continue
            want = tuple(leaf.shape)
            if placed[path] == mesh.ROWS:
                want = (H // 2,) + want[1:]
            elif placed[path] == mesh.SLOTS:
                want = ((1 << 12) // 2,) + want[1:]
            assert tuple(flat[path].shape) == want, path
            kinds.add(placed[path])
    assert kinds == {mesh.ROWS, mesh.SLOTS, mesh.REPLICATED}
    assert placed["taa.history"] == mesh.ROWS
    assert placed["sharc.packed"] == mesh.SLOTS
    assert placed["scene.center"] == mesh.REPLICATED


@pytest.mark.parametrize("sharc_on", [False, True])
def test_two_ranks_graph_frames_equal_the_eager_frames(frames, sharc_on):
    """The graph callable's frames (its pieces, from the one-device start
    state, which it cuts to the shards) equal the eager sharded frames bit
    for bit: every image band and every final shard."""
    ranks, _ = frames[sharc_on]
    for r, run in enumerate(ranks):
        got = run["graph"]
        assert len(got["images"]) == FRAMES
        for i, (a, b) in enumerate(zip(got["images"], run["images"])):
            assert torch.equal(a, b), (r, i)
        want = dict(checkpoint.leaves(run["state"]))
        for path, leaf in checkpoint.leaves(got["state"]):
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(leaf, want[path]), (r, path)
            else:
                assert leaf == want[path], (r, path)


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_graph_frame_matches_the_reference_sharded_frame(frames,
                                                                   i):
    """The gathered graph frame within
    test_two_ranks_match_the_reference_sharded_frame's bounds."""
    ranks, _ = frames[True]
    jimg = frames["reference"][i]
    timg = torch.cat([run["graph"]["images"][i] for run in ranks]).numpy()
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    d = np.abs(timg - jimg)
    off = d.max(-1)
    if i == 0:
        assert d.mean() <= 2e-4, d.mean()
        assert (off > 1e-3).mean() <= 0.02
    else:
        assert d.mean() <= 4e-3, d.mean()
        assert (off > 0.02).mean() <= 0.12
        assert (off > 0.05).mean() <= 0.03


@pytest.mark.parametrize("sharc_on", [False, True])
def test_sharded_graph_pieces_make_no_host_traffic(frames, sharc_on):
    """No piece of the sharded graph frame reads the card back or makes a
    tensor of host data (graphs.HOST_OPS), on either rank."""
    ranks, _ = frames[sharc_on]
    for r, run in enumerate(ranks):
        assert run["graph"]["host_ops"] == [], r


def test_no_spill_wave_issues_a_collective(frames):
    """At 2 slots the deep segment overflows: the graph frame runs its
    spill wave (piece S) where the eager frame does, on each rank by its
    own decision, equals the eager frame at that capacity bit for bit, and
    no spill wave issues a collective (a rank that spills alone would
    otherwise post collectives the other never matches)."""
    waves = []
    for r, run in enumerate(frames["spill"]):
        got = run["graph"]
        assert got["spill_waves"] == sum(run["eager_waves"]), r
        assert got["spill_collectives"] == [], r
        assert got["host_ops"] == [], r
        assert torch.equal(got["images"][0], run["eager_image"]), r
        waves.append(got["spill_waves"])
    assert sum(waves) >= 1


def test_graph_frame_keeps_its_group_and_refuses_gloo_on_the_card(frames):
    """A call without the group of the callable's first call raises; the
    gloo group has no graph form on CUDA tensors (graph_refusal)."""
    for sharc_on in (False, True):
        for run in frames[sharc_on][0]:
            assert "another group" in run["graph"]["other_group"]
            assert "gloo" in run["graph"]["refusal"]
    assert tpipeline.graph_refusal(None, torch.device("cuda")) is None


def options_config():
    """3 ranks' frame of other options: 32x16 upscaled to 48x24 (render
    bands of 5, 5 and 6 rows, replicated between frames; output bands of
    8), ReLAX, shared-offset pairwise ReSTIR with the real previous
    surface, Catmull-Rom TAA history, chromatic aberration and the NRD
    validation view. The widths are multiples of 32: PyTorch's CPU
    kernels run whole groups of 32 floats through their vector body and
    the rest through a scalar loop, which round the sky's transcendentals
    differently in the last bit, so a band of another width puts some
    pixels in the other loop than the whole frame does (an artifact of the
    CPU kernels, not of the bands: on the card each element is computed
    alike, and chip_smoke.py phase 22 (b) finds the bands' images equal
    to one rank's)."""
    from drts_tpu_torch.ops import restir as trestir
    return tpipeline.PipelineConfig(
        output_width=48, output_height=24, render_width=32,
        render_height=16, upscaling=True, bounces=2, block_size=4096,
        sharc_enabled=False, sharc=tsharc.SHARCConfig(capacity_log2=12),
        denoiser="NRDReLAX", taa_history_filter="catmull",
        chromatic_aberration_strength=0.05, debug_view="NRDValidation",
        restir=trestir.ReSTIRConfig(
            spatial_offset_mode="shared", spatial_bias_correction="pairwise",
            temporal_bias_correction="pairwise",
            temporal_prev_surface="real"))


def test_three_ranks_equal_one_device_with_other_options(tmp_path):
    """Two frames of options_config sharded over 3 ranks: each rank's
    image band the one-device frames' rows bit for bit, the gathered
    state the one-device state, every leaf where the placement puts it
    (the render-height buffers whole: 16 does not divide by 3)."""
    cfg = options_config()
    multihost.spawn(graft_entry.frames_worker, 3, "cpu",
                    args=([cfg], FRAMES, str(tmp_path), 3, None, "cpu"))
    runs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)[0]
            for r in range(3)]
    pipe, one = _one_device(cfg)
    placed = pipe.placement(one[-1][0], 3)
    assert placed["reservoirs.uv"] == mesh.REPLICATED
    assert placed["taa.history"] == mesh.ROWS
    for r, run in enumerate(runs):
        s, e = mesh.row_band(24, r, 3)
        for i in range(FRAMES):
            assert torch.equal(run["images"][i], one[i][1][s:e]), (r, i)
        assert run["misplaced"] == []
        flat = dict(checkpoint.leaves(one[-1][0]))
        for path, leaf in checkpoint.leaves(run["gathered"]):
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(leaf, flat[path]), path


EXCHANGE_H, EXCHANGE_W = 13, 6


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    """graft_entry.exchange_worker's results on 2 and 3 gloo ranks of a
    13-row frame (bands of 6 and 7 rows; 4, 4 and 5)."""
    out = {}
    for n in (2, 3):
        tmp = tmp_path_factory.mktemp(f"exchange{n}")
        multihost.spawn(graft_entry.exchange_worker, n, "cpu",
                        args=(EXCHANGE_H, EXCHANGE_W, str(tmp), "cpu"))
        out[n] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(n)]
    gen = torch.Generator().manual_seed(EXCHANGE_H * 1000 + EXCHANGE_W)
    out["image"] = torch.randn((EXCHANGE_H, EXCHANGE_W, 3), generator=gen)
    return out


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("op", ["shift", "shift_chw", "roll"])
def test_halo_matches_the_whole_frame(exchanges, n, op):
    img = exchanges["image"]
    for r, run in enumerate(exchanges[n]):
        s, e = mesh.row_band(EXCHANGE_H, r, n)
        assert run["band"] == (s, e)
        for dy in graft_entry.EXCHANGE_SHIFTS:
            if op == "shift":
                whole = tpost._shift(img, dy, 1)
            elif op == "shift_chw":
                whole = tdenoise._shift_chw(img.permute(2, 0, 1), dy,
                                            1).permute(1, 2, 0)
            else:
                whole = torch.roll(img, shifts=(-dy, -1), dims=(0, 1))
            assert torch.equal(run[op][dy], whole[s:e]), (r, dy)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("form", ["native", "all_reduce"])
def test_reduce_scatter_forms(exchanges, n, form):
    """Each rank's rows of the sum and the max over the ranks; and the
    whole image gathered back from the bands."""
    sums, words = [], []
    for r in range(n):
        local = torch.Generator().manual_seed(7 + r)
        sums.append(torch.randn((EXCHANGE_H, 4), generator=local))
        words.append(torch.randint(0, 1 << 40, (EXCHANGE_H,),
                                   generator=local))
    total = torch.stack(sums).sum(0)
    top = torch.stack(words).amax(0)
    for r, run in enumerate(exchanges[n]):
        s, e = mesh.row_band(EXCHANGE_H, r, n)
        got_sum, got_max = run["reduce_scatter"][form]
        assert torch.allclose(got_sum, total[s:e], rtol=1e-6, atol=1e-6)
        assert torch.equal(got_max, top[s:e])
        assert torch.equal(run["gathered"], exchanges["image"])


@pytest.mark.parametrize("c", [2, 5, 12])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_reproject_row_offset_equals_the_whole_frame(c, mode):
    h, w = 23, 17
    rng = np.random.RandomState(c)
    src = torch.from_numpy(np.asarray(rng.randn(h, w, c), np.float32))
    motion = torch.from_numpy(np.asarray(rng.randn(h, w, 2) * 6,
                                         np.float32))
    whole, whole_ok = trp.reproject_packed(src, motion, mode)
    for s, e in [(0, 7), (7, 15), (15, 23), (11, 12)]:
        out, ok = trp.reproject_packed(src, motion[s:e], mode, s)
        assert torch.equal(out.view(torch.int32),
                           whole[s:e].view(torch.int32)), (s, e)
        assert torch.equal(ok, whole_ok[s:e])
    with pytest.raises(ValueError):
        trp.reproject_packed(src, motion[15:], mode, 16)


def test_dryrun_multichip_two_ranks():
    graft_entry.dryrun_multichip(2, device="cpu")
