"""The port's compaction contract against the reference: ``compact_from=1``
(the bounce-1 segment, then the deep segment cascading in its slot
space), the partition-mode sort, ``overflow_spill=False`` and the
compacted SHARC update trace, at 64x64 on the demo scene with oscillator
grid 3 seen from (0, 1, -5), no accel (both packages sweep every sphere
per ray).

Tolerances. Against JAX (XLA:CPU contracts multiply-adds into FMAs, see
tests/test_torch_intersect.py): radiance within 1e-3 on >= 99.5% of
pixels (tests/test_torch_pathtrace.py's bar), rays_traced and the overflow
counter exactly, is_diffuse exactly and the bounce-1 hit distance with
the same finite mask and within 1e-4 (relative and absolute). The SHARC
update: fingerprints and sample counts equal on >= 99% of the slots
either side fills, resolved radiance within 1e-3 (relative and absolute)
on >= 99% of the slots both fill, dropped rows exactly. Within the port,
the reference's own invariants (tests/test_render.py): the sort is a slot
permutation, so every sort mode gives radiance bit for bit equal to the
unsorted compaction, and ``compact_from=1`` equals the dense integrator to
rtol 1e-4, atol 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene
from drts_tpu.ops import camera as jcamera, pathtrace as jpathtrace
from drts_tpu.ops import sharc as jsharc
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.ops import camera as tcamera, pathtrace as tpathtrace
from drts_tpu_torch.ops import sharc as tsharc

W = H = 64
EYE = np.array([0.0, 1.0, -5.0])


@pytest.fixture(scope="module")
def scenes():
    host = jmyscene.build(oscillator_grid=3)
    cam = jcamera.make_camera(tuple(EYE), tuple(-EYE / np.linalg.norm(EYE)),
                              horizontal_fov_deg=90.0, aspect=W / H)
    tscene = convert.scene(jax.tree.map(np.asarray, host.scene), "cpu")
    tcam = convert.camera(jax.tree.map(np.asarray, cam), "cpu")
    return (host.scene, cam), (tscene, tcam)


@functools.partial(jax.jit, static_argnums=2)
def jax_trace(scene, cam, cfg, frame, di):
    """The reference's trace_image under one jit (as its trace_image_jit,
    with the DI handoff)."""
    return jpathtrace.trace_image(scene, cam, cfg, frame, di_radiance=di)


def run_both(scenes, frame, di=None, **kw):
    (jscene, jcam), (tscene, tcam) = scenes
    jcfg = jpathtrace.PathTraceConfig(width=W, height=H, block_size=4096,
                                      **kw)
    tcfg = tpathtrace.PathTraceConfig(width=W, height=H, block_size=4096,
                                      **kw)
    jout = jax_trace(jscene, jcam, jcfg, frame,
                     None if di is None else jnp.asarray(di))
    tout = tpathtrace.trace_image(
        tscene, tcam, tcfg, frame,
        di_radiance=None if di is None else torch.from_numpy(di))
    return jout, tout


def assert_radiance_close(jout, tout):
    diff = np.abs(tout.radiance.numpy() - np.asarray(jout.radiance)).max(-1)
    assert np.isfinite(tout.radiance.numpy()).all()
    assert (diff <= 1e-3).mean() >= 0.995, (diff <= 1e-3).mean()
    assert float(tout.rays_traced) == float(jout.rays_traced)


def assert_aovs_equal(jout, tout):
    np.testing.assert_array_equal(tout.is_diffuse.numpy(),
                                  np.asarray(jout.is_diffuse))
    hd_j, hd_t = np.asarray(jout.hit_distance), tout.hit_distance.numpy()
    np.testing.assert_array_equal(np.isfinite(hd_t), np.isfinite(hd_j))
    both = np.isfinite(hd_j)
    assert both.any()
    np.testing.assert_allclose(hd_t[both], hd_j[both], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("partition_min", [500_000, 0])
def test_compact_first_matches_jax(scenes, partition_min):
    """6 bounces, deep segment at n/4 slots, frame 3: the key sort (the
    bounce-1 segment holds 4,096 slots) and partition mode everywhere."""
    jout, tout = run_both(scenes, 3, bounces=6, compact_from=1,
                          compact_fraction=4,
                          compact_sort_partition_min=partition_min)
    assert_radiance_close(jout, tout)
    assert_aovs_equal(jout, tout)
    assert float(tout.counters["wavefront_overflow_paths"]) == 0.0


def test_compact_first_single_bounce_matches_jax(scenes):
    """bounces=1: the bounce-1 segment is the last one (no continuation
    state), so it adds the final emission itself."""
    jout, tout = run_both(scenes, 5, bounces=1, compact_from=1)
    assert_radiance_close(jout, tout)
    assert_aovs_equal(jout, tout)


def test_compact_first_di_handoff_matches_jax(scenes):
    """di_valid rides the bounce-1 slot gather: bounce-1 emission is
    suppressed where DI was added at the primary vertex."""
    di = np.full((H, W, 3), 0.25, np.float32)
    jout, tout = run_both(scenes, 7, di=di, bounces=4, compact_from=1,
                          compact_fraction=4)
    assert_radiance_close(jout, tout)


def test_no_spill_drops_and_counts_like_jax(scenes):
    """overflow_spill=False at a deep capacity of 128 slots: the dropped
    paths lose their radiance, and both count the same paths."""
    jout, tout = run_both(scenes, 3, bounces=6, compact_from=1,
                          compact_capacity=128, overflow_spill=False)
    j_over = float(jout.counters["wavefront_overflow_paths"])
    assert j_over > 0, "the capacity must be small enough to drop paths"
    assert float(tout.counters["wavefront_overflow_paths"]) == j_over
    assert_radiance_close(jout, tout)
    spilled = tpathtrace.trace_image(
        scenes[1][0], scenes[1][1],
        tpathtrace.PathTraceConfig(width=W, height=H, block_size=4096,
                                   bounces=6, compact_from=1,
                                   compact_capacity=128), 3)
    assert (float(spilled.counters["wavefront_overflow_paths"])
            < float(tout.counters["wavefront_overflow_paths"]))
    assert float(spilled.rays_traced) > float(tout.rays_traced)
    # The deep segment's spill wave ran once, and only with the spill on.
    assert (spilled.spill_waves, tout.spill_waves) == (1, 0)


def test_compacted_sharc_update_matches_jax(scenes):
    """sharc_update_trace with compact_from=1 (compacted and sorted after
    bounce 0, records in slot space) from an empty 4,096-slot cache."""
    (jscene, jcam), (tscene, tcam) = scenes
    jscfg = jsharc.SHARCConfig(capacity_log2=12)
    tscfg = tsharc.SHARCConfig(capacity_log2=12)
    kw = dict(width=32, height=32, bounces=4, block_size=4096,
              compact_from=1, compact_sort_partition_min=0)
    jstate, jc = jax.jit(functools.partial(
        jpathtrace.sharc_update_trace, sharc_cfg=jscfg,
        cfg=jpathtrace.PathTraceConfig(**kw)))(
        jscene, jcam, jsharc.init_state(jscfg), frame_index=2)
    tstate, tc = tpathtrace.sharc_update_trace(
        tscene, tcam, tsharc.init_state(tscfg, "cpu"), tscfg,
        tpathtrace.PathTraceConfig(**kw), 2)
    fp_j = np.asarray(jstate.fingerprint).astype(np.int64)
    fp_t = tstate.fingerprint.numpy()
    filled = (fp_j > 0) | (fp_t > 0)
    assert filled.sum() > 100
    assert (fp_j == fp_t)[filled].mean() >= 0.99
    assert (np.asarray(jstate.sample_count)
            == tstate.sample_count.numpy())[filled].mean() >= 0.99
    both = (fp_j > 0) & (fp_j == fp_t)
    close = np.isclose(tstate.radiance.numpy()[both],
                       np.asarray(jstate.radiance)[both],
                       rtol=1e-3, atol=1e-3).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert (float(tc["sharc_splat_dropped_rows"])
            == float(jc["sharc_splat_dropped_rows"]))


@pytest.fixture(scope="module")
def port_scene():
    host = tmyscene.build(oscillator_grid=3, device="cpu")
    cam = tcamera.make_camera(tuple(EYE), tuple(-EYE / np.linalg.norm(EYE)),
                              horizontal_fov_deg=90.0, aspect=W / H,
                              device="cpu")
    return host.scene, cam


@pytest.mark.parametrize("compact_from", [1, 2])
def test_every_sort_mode_is_invisible(port_scene, compact_from):
    """Key sort and partition (at both segments' capacities) give radiance
    and ray counts bit for bit equal to the unsorted compaction."""
    scene, cam = port_scene
    off = tpathtrace.PathTraceConfig(width=W, height=H, bounces=6,
                                     block_size=4096,
                                     compact_from=compact_from,
                                     compact_fraction=4, compact_sort=False)
    ref = tpathtrace.trace_image(scene, cam, off, 3)
    for kw in ({"compact_sort_tile": 16},
               {"compact_sort_partition_min": 0}):
        out = tpathtrace.trace_image(
            scene, cam, dataclasses.replace(off, compact_sort=True, **kw), 3)
        assert torch.equal(out.radiance, ref.radiance), kw
        assert float(out.rays_traced) == float(ref.rays_traced)


@pytest.mark.parametrize("bounces,frame", [(6, 3), (1, 5)])
def test_compact_first_equals_dense(port_scene, bounces, frame):
    """compact_from=1 reproduces the dense integrator: radiance to rtol
    1e-4, atol 1e-5, the rays, is_diffuse and the hit distance."""
    scene, cam = port_scene
    dense = tpathtrace.PathTraceConfig(width=W, height=H, bounces=bounces,
                                       block_size=4096, compact_from=99)
    out_d = tpathtrace.trace_image(scene, cam, dense, frame)
    out_c = tpathtrace.trace_image(
        scene, cam, dataclasses.replace(dense, compact_from=1,
                                        compact_fraction=4), frame)
    np.testing.assert_allclose(out_c.radiance.numpy(),
                               out_d.radiance.numpy(), rtol=1e-4, atol=1e-5)
    assert float(out_c.rays_traced) == float(out_d.rays_traced)
    assert torch.equal(out_c.is_diffuse, out_d.is_diffuse)
    assert torch.equal(out_c.hit_distance, out_d.hit_distance)


def _slot_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    act = rng.random(h * w) < 0.6
    d = rng.normal(size=(h * w, 3)).astype(np.float32)
    return act, d


@pytest.mark.parametrize("cfg_kw,space,sort", [
    ({}, "pixels", "partition"), ({}, "slots", "partition"),
    ({"compact_sort_partition_min": 2049}, "pixels", "key"),
    ({"compact_sort_partition_min": 2049}, "slots", "key"),
    ({"compact_sort": False}, "pixels", "none")],
    ids=["partition-pixels", "partition-slots", "key-pixels", "key-slots",
         "none"])
def test_compact_slots_reports_the_sort_it_ran(cfg_kw, space, sort):
    """_compact_slots says which sort it ran: the partition from
    compact_sort_partition_min slots on (2048 here, in pixel and in slot
    space), the key sort below it, none with compact_sort off."""
    h, w, cap = 40, 54, 2048
    act, d = _slot_inputs(h, w, 3)
    pix = (None if space == "pixels"
           else torch.from_numpy(np.random.default_rng(4).permutation(h * w)))
    cfg = tpathtrace.PathTraceConfig(
        **dict({"compact_sort_partition_min": 2048}, **cfg_kw))
    cs = tpathtrace._compact_slots(torch.from_numpy(act),
                                   torch.from_numpy(d), pix, cfg, cap, h, w)
    assert cs["sort"] == sort
    assert (cs["mapper"][2] is None) == (sort == "none")


@pytest.mark.parametrize("wave", [0, 1])
def test_partition_order_matches_jax_on_ragged_tiles(wave):
    """A 40x54 frame in tiles of 16 (ragged in both axes): the port's
    partition gives the reference's slot order, mapper and overflow, and
    in pixel space the same order as the (octant, tile) key sort."""
    h, w, cap = 40, 54, 1024
    act, d = _slot_inputs(h, w, 1)
    jcfg = jpathtrace.PathTraceConfig(compact_sort_tile=16,
                                      compact_sort_partition_min=0)
    tcfg = tpathtrace.PathTraceConfig(compact_sort_tile=16,
                                      compact_sort_partition_min=0)
    ids = np.arange(h * w, dtype=np.float32)[:, None]
    j = jpathtrace._compact_slots(jnp.asarray(act), jnp.asarray(d), None,
                                  jcfg, cap, h, w, wave=wave)
    t = tpathtrace._compact_slots(torch.from_numpy(act),
                                  torch.from_numpy(d), None, tcfg, cap, h,
                                  w, wave=wave)
    j_src = np.asarray(j["gsel"](jnp.asarray(ids), [[-1.0]]))
    t_src = t["gsel"](torch.from_numpy(ids), [[-1.0]]).numpy()
    np.testing.assert_array_equal(t_src, j_src)
    assert int(t["overflow"]) == int(j["overflow"])
    assert (int(t["overflow"]) > 0) == (wave == 0)
    np.testing.assert_array_equal(t["mapper"][0].numpy(),
                                  np.asarray(j["keep"]))
    vals = np.arange(cap, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(
        tpathtrace._slots_to_space(torch.from_numpy(vals), -1.0,
                                   t["mapper"]).numpy(),
        np.asarray(jpathtrace._slots_to_space(
            jnp.asarray(vals), -1.0,
            (j["keep"], j["pos"], j["perm"], cap))))
    if wave == 0:
        # Without overflow both modes keep every live lane, and the
        # partition over the tile-major order yields the key sort's
        # (octant, tile, pixel in tile) order.
        big = 2048
        part, key = (tpathtrace._compact_slots(
            torch.from_numpy(act), torch.from_numpy(d), None,
            dataclasses.replace(tcfg, compact_sort_partition_min=pmin),
            big, h, w) for pmin in (0, 10 ** 9))
        assert int(part["overflow"]) == 0
        np.testing.assert_array_equal(
            part["gsel"](torch.from_numpy(ids), [[-1.0]]).numpy(),
            key["gsel"](torch.from_numpy(ids), [[-1.0]]).numpy())


def test_partition_order_in_slot_space_matches_jax():
    """Slot-space input (pixel_ids given) compacts in place: the port's
    partition and key sort give the reference's slot orders."""
    h, w, ns, cap = 40, 54, 1500, 1024
    rng = np.random.default_rng(2)
    act = rng.random(ns) < 0.8
    d = rng.normal(size=(ns, 3)).astype(np.float32)
    pix = rng.permutation(h * w)[:ns]
    ids = np.arange(ns, dtype=np.float32)[:, None]
    for pmin in (0, 10 ** 9):
        jcfg = jpathtrace.PathTraceConfig(compact_sort_tile=16,
                                          compact_sort_partition_min=pmin)
        tcfg = tpathtrace.PathTraceConfig(compact_sort_tile=16,
                                          compact_sort_partition_min=pmin)
        j = jpathtrace._compact_slots(jnp.asarray(act), jnp.asarray(d),
                                      jnp.asarray(pix, jnp.int32), jcfg,
                                      cap, h, w)
        t = tpathtrace._compact_slots(torch.from_numpy(act),
                                      torch.from_numpy(d),
                                      torch.from_numpy(pix), tcfg, cap, h,
                                      w)
        np.testing.assert_array_equal(
            t["gsel"](torch.from_numpy(ids), [[-1.0]]).numpy(),
            np.asarray(j["gsel"](jnp.asarray(ids), [[-1.0]])))
