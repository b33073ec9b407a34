"""The port's multi-device frame (``drts_tpu_torch/parallel``,
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
- A 2-rank ``render_frame`` at 32x32, two frames (2 bounces, ReSTIR,
  ReBLUR, TAA) from the demo scene's camera (oscillator grid 3): with
  SHARC off, bit for bit the port's own one-device frames; with SHARC on
  (a 4,096-slot cache, updated on frame 0), within
  tests/test_parallel.py's ``assert_f16_close`` bound of the one-device
  frames (every value within 1.5 f16 ULP, at most 1% beyond 2e-4) and
  within tests/test_torch_default_frame.py's bounds of the reference's
  2-device sharded frames under one jit (frame 0: mean <= 2e-4, off by
  more than 1e-3 on <= 2% of pixels; frame 1: mean <= 4e-3, off by more
  than 0.02 on <= 12% and by more than 0.05 on <= 3%); every leaf of
  both ranks' final states equal (``replica_checksums``), and each
  rank's band ``process_local_rows`` would give it. (The close-up pose of
  tests/test_torch_default_frame.py does not fit those bounds here on
  the reference's XLA path: its fused multiply-adds move a few hit points,
  and at 32x32 a few pixels carry the mean: 6.6e-4 on frame 0 one device
  against one device, as banded. That test runs the reference in
  interpret mode at 64x64.)
- ``dryrun_multichip(2, device="cpu")``: the reference's dry-run recipe
  (a 64x64 frame and a 32x32 mesh trace) banded over two spawned ranks.
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
from drts_tpu_torch.ops import sharc as tsharc
from drts_tpu_torch.parallel import mesh, multihost
from drts_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs multiple (virtual) devices")

W = H = 32
FRAMES = 2


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


def _one_device(cfg):
    pipe, state, pose = graft_entry._setup(cfg, "cpu", 3)
    out = []
    for _ in range(FRAMES):
        state, img = pipe.render_frame(state, pose)
        out.append((state, img))
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The port: 2-rank and one-device frames with SHARC off and on; the
    reference: its 2-device sharded frames (SHARC on) under one jit."""
    cfgs = [small_config(tpipeline.PipelineConfig, tsharc.SHARCConfig,
                         sharc_enabled=on) for on in (False, True)]
    tmp = tmp_path_factory.mktemp("ranks")
    multihost.spawn(graft_entry.frames_worker, 2, "cpu",
                    args=(cfgs, FRAMES, str(tmp), 3, None, "cpu"))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
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
    return out


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_equal_one_device_without_sharc(frames, i):
    ranks, one = frames[False]
    for r in ranks:
        assert torch.equal(r["images"][i], one[i][1])
    if i == FRAMES - 1:
        flat = dict(checkpoint.leaves(one[-1][0]))
        for r in ranks:
            for path, leaf in checkpoint.leaves(r["state"]):
                if isinstance(leaf, torch.Tensor):
                    assert torch.equal(leaf, flat[path]), path
                else:
                    assert leaf == flat[path], path


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_near_one_device_with_sharc(frames, i):
    ranks, one = frames[True]
    state, img = one[i]
    for r in ranks:
        assert_f16_close(r["images"][i].numpy(), img.numpy(), "image")
    if i == FRAMES - 1:
        for r in ranks:
            assert_f16_close(r["state"].taa.history.numpy(),
                             state.taa.history.numpy(), "taa_history")
            for k, v in state.counters.items():
                assert float(r["state"].counters[k]) == float(v), k


@pytest.mark.parametrize("i", range(FRAMES))
def test_two_ranks_match_the_reference_sharded_frame(frames, i):
    ranks, _ = frames[True]
    jimg = frames["reference"][i]
    timg = ranks[0]["images"][i].numpy()
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
    ranks, _ = frames[sharc_on]
    sums = [r["checksums"] for r in ranks]
    assert sums[0] == sums[1]
    assert not mesh.replicas_differ(sums[0])
    assert all(len(v) == 2 for v in sums[0].values())
    assert [r["band"] for r in ranks] == [(0, H // 2), (H // 2, H)]


def test_dryrun_multichip_two_ranks():
    graft_entry.dryrun_multichip(2, device="cpu")
