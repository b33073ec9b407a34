"""The port's ReSTIR DI against the reference's, stage by stage, on the
5-sphere scene of tests/test_restir_kernel.py at 48x48 (floor, two
emitters, a metal and a glass sphere: all three BSDF lobes).

The reference runs its Pallas kernels in interpret mode
(``intersect.BACKEND = "interpret"``): the candidate kernel (B3), the
any-hit kernel (B2) and the window reprojection (B4). Each stage of the
port starts from the reference's converted inputs, so a stage's
differences are its own.

Tolerances. Picks (light ids) are compared as the share of pixels whose
pick differs: identical draws give identical winners except where
float32 rounding (XLA:CPU contracts multiply-adds into FMAs and has its
own sin/cos; the port rounds each operation) flips a ``u * w_sum < w``
comparison on a knife's edge. Weights are compared where the picks
agree. Bounds and measured values (this data):

- B3 plain vs Pallas: pick mismatch <= 0.5% (measured 0 of 2,304);
  each output row rtol 1e-4 plus 1e-5 of the row's largest value
  (measured: w_sum, phat 3.1e-6 relative; direction 7.7e-7 absolute;
  distance 8.6e-5 relative, 4.9e-4 absolute).
- build_regir_grid: slot mismatch <= 0.5%, weights rtol 1e-4 (measured
  0 mismatches, weights bit-equal).
- initial_sampling: pick mismatch <= 1%; w_sum, phat, w_out, M rtol 1e-3
  (measured 0 mismatches, 2.8e-6 relative).
- temporal_resampling: the same bounds (measured 0 mismatches, 7.1e-7);
  spatial_resampling: the same (measured 0 mismatches, 1.6e-7).
- final_shading: diffuse and specular within 1e-3 of the image maximum
  on >= 99.5% of pixels (measured all pixels, largest 8.4e-8 of it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import clusters as jclusters, scene as jscene_mod
from drts_tpu.models.material import MaterialDesc, pack_materials
from drts_tpu.ops import (camera as jcamera, gbuffer as jgbuffer,
                          intersect as jintersect, light as jlight,
                          restir as jrestir, restir_pallas)
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.ops import bxdf as tbxdf, restir as trestir
from drts_tpu_torch.ops import restir_kernels as rk
from drts_tpu_torch.utils import math as tm

H = W = 48
FRAME = 3


def _scene():
    mats = pack_materials([
        MaterialDesc(base_color=(0.8, 0.8, 0.8, 1), roughness=0.6),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=8.0,
                     emissive_color=(1.0, 0.6, 0.3)),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=20.0,
                     emissive_color=(0.2, 0.2, 1.0)),
        MaterialDesc(base_color=(0.9, 0.7, 0.4, 1), metallic=1.0,
                     roughness=0.15),
        MaterialDesc(base_color=(1.0, 1.0, 1.0, 1), roughness=0.05,
                     transmission=0.9, ior=1.5),
    ])
    center = jnp.array([[0.0, -100.0, 0.0], [-2.0, 2.0, 0.0],
                        [2.0, 2.0, 0.0], [0.8, 0.5, -1.0],
                        [-0.9, 0.6, 1.0]])
    rot = jnp.tile(jm.QUAT_IDENTITY, (5, 1))
    from drts_tpu.ops import sky as jsky
    return jscene_mod.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3, 0.3, 0.5, 0.55]), materials=mats,
        env=jsky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def port_surface(js) -> trestir.Surface:
    """The reference's Surface, field by field, as the port's."""
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    bs = js.bsdf
    return trestir.Surface(
        valid=t(js.valid), position=t(js.position), view=t(js.view),
        bsdf=tbxdf.BSDF(**{f.name: t(getattr(bs, f.name))
                           for f in dataclasses.fields(tbxdf.BSDF)}),
        sv=tbxdf.SurfaceVectors(**{
            f.name: t(getattr(js.sv, f.name))
            for f in dataclasses.fields(tbxdf.SurfaceVectors)}),
        lobe_weights=t(js.lobe_weights), depth=t(js.depth),
        normal=t(js.normal))


@pytest.fixture(scope="module")
def ref():
    """The reference's stages at 48x48, each output kept for the port."""
    scene = _scene()
    cam = jcamera.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                              aspect=1.0)
    plan = jclusters.build_plan_morton(np.asarray(scene.center),
                                       np.asarray(scene.radius),
                                       max_members=8)
    acc = jclusters.make_morton_accel(plan, scene.center, scene.radius,
                                      sort_origin=cam.position)
    cfg = jrestir.ReSTIRConfig()
    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        gbuf = jgbuffer.generate(scene, cam, W, H, 4096, accel=acc)
        lights = jlight.prepare(scene)
        surface = jrestir.make_surface(gbuf)
        grid = jrestir.build_regir_grid(lights, cam.position, cfg, FRAME)
        cur = jrestir.initial_sampling(surface, scene, lights, grid, cfg,
                                       FRAME, 4096, accel=acc)
        # History: the previous frame's reservoirs, depth and normal, seen
        # through a smooth motion field (within the window kernel's reach,
        # so its ok mask is the in-frame test) with no exact half-pixel
        # offsets: the window kernel's nearest tap rounds ties up, the
        # exact gather (jnp.round, the reference's XLA path) to even.
        prev = jrestir.initial_sampling(surface, scene, lights, grid, cfg,
                                        FRAME - 1, 4096, accel=acc)
        yy, xx = np.mgrid[0:H, 0:W]
        motion = jnp.asarray(np.stack([0.6 + 0.4 * np.sin(yy / 5.0),
                                       -0.8 + 0.3 * np.cos(xx / 4.0 + 0.3)], -1),
                             jnp.float32)
        prev_depth = jnp.where(jnp.isfinite(gbuf.linear_depth),
                               gbuf.linear_depth * 1.01, 1e8)
        prev_normal = gbuf.mat.shading_normal
        temporal = jrestir.temporal_resampling(
            cur, prev, surface, lights, motion, prev_depth, prev_normal,
            cfg, FRAME, scene=scene, accel=acc, block_size=4096)
        spatial = jrestir.spatial_resampling(temporal, surface, lights, cfg,
                                             FRAME, scene=scene, accel=acc,
                                             block_size=4096)
        diffuse, specular = jrestir.final_shading(spatial, surface, scene,
                                                  lights, 4096, accel=acc)
    finally:
        jintersect.BACKEND = old
    return dict(scene=scene, cam=cam, acc=acc, cfg=cfg, gbuf=gbuf,
                lights=lights, surface=surface, grid=grid, cur=cur,
                prev=prev, motion=motion, prev_depth=prev_depth,
                prev_normal=prev_normal, temporal=temporal, spatial=spatial,
                diffuse=diffuse, specular=specular)


@pytest.fixture(scope="module")
def port(ref):
    """The same inputs as the port's objects."""
    return dict(
        scene=convert.scene(np_tree(ref["scene"]), "cpu"),
        accel=convert.morton_accel(np_tree(ref["acc"]), "cpu"),
        lights=convert.lights(np_tree(ref["lights"]), "cpu"),
        surface=port_surface(np_tree(ref["surface"])),
        grid=convert.regir_grid(np_tree(ref["grid"]), "cpu"),
        cur=convert.reservoirs(np_tree(ref["cur"]), "cpu"),
        prev=convert.reservoirs(np_tree(ref["prev"]), "cpu"),
        temporal=convert.reservoirs(np_tree(ref["temporal"]), "cpu"),
        spatial=convert.reservoirs(np_tree(ref["spatial"]), "cpu"))


def assert_reservoirs_match(got, want, max_mismatch, rtol):
    want = np_tree(want)
    idx_w = np.asarray(want.light_index)
    same = got.light_index.numpy() == idx_w
    assert 1.0 - same.mean() <= max_mismatch, 1.0 - same.mean()
    for name in ("w_sum", "phat", "w_out", "m_count"):
        a = getattr(got, name).numpy()[same]
        b = np.asarray(getattr(want, name))[same]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * 1e-3
                                   * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)
    np.testing.assert_allclose(got.uv.numpy()[same],
                               np.asarray(want.uv)[same], atol=1e-6)
    assert (np.asarray(want.w_out) > 0).mean() > 0.2


def test_candidate_kernel_plain_matches_pallas(ref):
    """B3's plain version and the Pallas kernel on the same planar rows:
    the frame's surface stream, uniforms and slot rows from a numpy
    seed."""
    surf_p, n, n_pad = jrestir._pack_surface_planar(ref["surface"])
    rng = np.random.RandomState(5)
    n_l, s, n_b = 8, 8, 1
    uni = rng.rand(4 * n_l, n_pad).astype(np.float32)
    cells = rng.randint(0, ref["grid"].packed.shape[0], n_pad)
    ids, wts = jm.unpack2f16(ref["grid"].packed[cells])      # (n_pad, s)
    slots = np.concatenate([np.asarray(ids).T, np.asarray(wts).T])
    out_f, out_i = restir_pallas.initial_light_candidates(
        surf_p, jnp.asarray(uni), jnp.asarray(slots), ref["lights"].compact,
        n_l, s, n_b, interpret=True)
    out_f, out_i = np.asarray(out_f)[:, :n], np.asarray(out_i)[:, :n]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.asarray(x)[:, :n]))
    got_f, got_i = rk.initial_light_candidates(
        t(surf_p), t(uni), t(slots),
        torch.from_numpy(np.array(ref["lights"].compact)), n_l, s, n_b)
    got_f, got_i = got_f.numpy(), got_i.numpy()
    same = (got_i == out_i).all(axis=0)
    assert 1.0 - same.mean() <= 0.005, 1.0 - same.mean()
    assert (out_f[3] > 0).mean() > 0.2
    for row in range(8):
        b = out_f[row][same]
        np.testing.assert_allclose(got_f[row][same], b, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0),
                                   err_msg=f"row {row}")


def test_regir_grid(ref):
    cfg = trestir.ReSTIRConfig()
    lights = convert.lights(np_tree(ref["lights"]), "cpu")
    pos = torch.from_numpy(np.array(ref["cam"].position))
    grid = trestir.build_regir_grid(lights, pos, cfg, FRAME)
    want = np_tree(ref["grid"])
    same = grid.light_index.numpy() == want.light_index
    assert 1.0 - same.mean() <= 0.005
    np.testing.assert_allclose(grid.weight.numpy()[same],
                               want.weight[same], rtol=1e-4)
    np.testing.assert_allclose(grid.origin.numpy(), want.origin)
    # The packed rows are the pair (id, weight) in f16.
    ids, wts = (x.numpy() for x in tm.unpack2f16(grid.packed))
    np.testing.assert_array_equal(ids, grid.light_index.numpy())
    np.testing.assert_allclose(wts, grid.weight.numpy(), rtol=1e-3,
                               atol=1e-30)


def test_initial_sampling(ref, port):
    got = trestir.initial_sampling(port["surface"], port["scene"],
                                   port["lights"], port["grid"],
                                   trestir.ReSTIRConfig(), FRAME, 4096,
                                   accel=port["accel"])
    assert_reservoirs_match(got, ref["cur"], 0.01, 1e-3)


def test_temporal_resampling(ref, port):
    """Basic-mode temporal reuse through the exact nearest reprojection.
    The reference's window kernel keeps every in-frame pixel here (its ok
    mask equals the in-frame test), so both take the same history."""
    from drts_tpu.ops import reproject_pallas as rp
    motion = ref["motion"]
    _, ok = rp.reproject_packed(jnp.zeros((H, W, 4)), motion, "nearest",
                                interpret=True)
    py = jnp.arange(H, dtype=jnp.float32)[:, None] + motion[..., 1]
    px = jnp.arange(W, dtype=jnp.float32)[None, :] + motion[..., 0]
    in_frame = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(in_frame))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = trestir.temporal_resampling(
        port["cur"], port["prev"], port["surface"], port["lights"],
        t(motion), t(ref["prev_depth"]), t(ref["prev_normal"]),
        trestir.ReSTIRConfig(), FRAME)
    assert_reservoirs_match(got, ref["temporal"], 0.01, 1e-3)
    assert (np.asarray(ref["temporal"].m_count) > 9).mean() > 0.3


def test_spatial_resampling(ref, port):
    got = trestir.spatial_resampling(port["temporal"], port["surface"],
                                     port["lights"], trestir.ReSTIRConfig(),
                                     FRAME)
    assert_reservoirs_match(got, ref["spatial"], 0.01, 1e-3)


def test_final_shading(ref, port):
    diff, spec = trestir.final_shading(port["spatial"], port["surface"],
                                       port["scene"], port["lights"], 4096,
                                       accel=port["accel"])
    for got, want in ((diff, ref["diffuse"]), (spec, ref["specular"])):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max(-1)
        assert (err <= 1e-3 * want.max()).mean() >= 0.995
        assert want.max() > 0


def test_options_that_wait_raise(port):
    """No ReSTIR option waits any more: every mode name the reference
    knows runs (tests/test_torch_restir_modes.py holds each against the
    reference), and only a name it does not know raises ValueError."""
    for kw in (dict(spatial_bias_correction="pairwise"),
               dict(temporal_bias_correction="raytraced"),
               dict(temporal_prev_surface="real"),
               dict(local_light_mode="Power_RIS"),
               dict(local_light_mode="Uniform"),
               dict(candidate_batch=True),
               dict(spatial_offset_mode="shared")):
        out = trestir.spatial_resampling(
            port["temporal"], port["surface"], port["lights"],
            trestir.ReSTIRConfig(**kw), FRAME, scene=port["scene"],
            accel=port["accel"], block_size=4096)
        assert bool(torch.isfinite(out.w_out).all())
    for kw in (dict(spatial_bias_correction="exact"),
               dict(temporal_bias_correction="none"),
               dict(temporal_prev_surface="true"),
               dict(local_light_mode="ReGIR"),
               dict(spatial_offset_mode="global")):
        with pytest.raises(ValueError):
            trestir.spatial_resampling(port["temporal"], port["surface"],
                                       port["lights"],
                                       trestir.ReSTIRConfig(**kw), FRAME)
