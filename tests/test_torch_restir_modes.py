"""The port's ReSTIR options against the reference's, stage by stage, on
the 5-sphere scene of tests/test_torch_restir.py at 32x32: every
initial-sampling mode (ReGIR_RIS, Power_RIS, Uniform, no local-light
candidates), the candidate batch, temporal reuse in the basic, pairwise
and raytraced bias modes with the pseudo and the real previous surface,
spatial reuse in those modes with per-pixel and shared offsets, and the
shared offsets themselves.

The reference runs on its XLA path (no Pallas kernel: none of these
options changes a kernel's semantics), so its visibility rays sweep every
sphere and its reprojection gathers exactly; the port's raytraced batches
go through B2's plain version over the Morton table the reference
built. Every stage starts from the reference's converted inputs.

Tolerances (as tests/test_torch_restir.py, for the same reasons: the
reference's XLA:CPU contracts multiply-adds into FMAs, the port rounds
each operation):

- picks (light ids) differ on <= 1% of pixels; where they agree, w_sum,
  phat, w_out and M within rtol 1e-3 (plus 1e-6 of the largest value)
  and uv within 1e-6;
- the candidate batch equals the port's own sequential loop bit for bit
  (same draws, same update order);
- the shared offsets (dx, dy) equal the reference's exactly for frames
  0-255 at 1-3 spatial samples;
- pack_prev_material's rows equal the reference's bit for bit.
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
                          light as jlight, restir as jrestir, sky as jsky)
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.ops import bxdf as tbxdf, restir as trestir

H = W = 32
FRAME = 5
BLOCK = 4096


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
    return jscene_mod.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3, 0.3, 0.5, 0.55]), materials=mats,
        env=jsky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t(x):
    return torch.from_numpy(np.array(x))


def port_surface(js) -> trestir.Surface:
    """The reference's Surface, field by field, as the port's."""
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
    """The reference's inputs at 32x32: G-buffer, surface, lights, grid,
    two frames' reservoirs (current and history), a smooth motion field
    with no half-pixel ties, the history's depth and normal, the previous
    G-buffer's material rows (a camera 0.1 to the left) and a pairwise
    temporal result to feed the spatial stage."""
    scene = _scene()
    cam = jcamera.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                              aspect=1.0)
    prev_cam = jcamera.make_camera((-0.1, 1.0, -6.0), (0.0, -0.15, 1.0),
                                   aspect=1.0)
    plan = jclusters.build_plan_morton(np.asarray(scene.center),
                                       np.asarray(scene.radius),
                                       max_members=8)
    acc = jclusters.make_morton_accel(plan, scene.center, scene.radius,
                                      sort_origin=cam.position)
    cfg = jrestir.ReSTIRConfig()
    yy, xx = np.mgrid[0:H, 0:W]
    motion = jnp.asarray(np.stack([0.6 + 0.4 * np.sin(yy / 5.0),
                                   -0.8 + 0.3 * np.cos(xx / 4.0 + 0.3)], -1),
                         jnp.float32)

    @jax.jit
    def inputs(frame):
        gbuf = jgbuffer.generate(scene, cam, W, H, BLOCK)
        prev_gbuf = jgbuffer.generate(scene, prev_cam, W, H, BLOCK)
        lights = jlight.prepare(scene)
        surface = jrestir.make_surface(gbuf)
        grid = jrestir.build_regir_grid(lights, cam.position, cfg, frame)
        cur = jrestir.initial_sampling(surface, scene, lights, grid, cfg,
                                       frame, BLOCK)
        prev = jrestir.initial_sampling(surface, scene, lights, grid, cfg,
                                        frame - 1, BLOCK)
        prev_depth = jnp.where(jnp.isfinite(gbuf.linear_depth),
                               gbuf.linear_depth * 1.01, 1e8)
        temporal = jrestir.temporal_resampling(
            cur, prev, surface, lights, motion, prev_depth,
            gbuf.mat.shading_normal, dataclasses.replace(
                cfg, temporal_bias_correction="pairwise"), frame)
        return (gbuf, prev_gbuf, lights, surface, grid, cur, prev,
                prev_depth, jrestir.pack_prev_material(prev_gbuf), temporal)
    (gbuf, prev_gbuf, lights, surface, grid, cur, prev, prev_depth,
     prev_material, temporal) = inputs(jnp.int32(FRAME))
    return dict(scene=scene, cam=cam, prev_cam=prev_cam, acc=acc, cfg=cfg,
                gbuf=gbuf, prev_gbuf=prev_gbuf, lights=lights,
                surface=surface, grid=grid, cur=cur, prev=prev,
                motion=motion, prev_depth=prev_depth,
                prev_material=prev_material, temporal=temporal)


@pytest.fixture(scope="module")
def port(ref):
    return dict(
        scene=convert.scene(np_tree(ref["scene"]), "cpu"),
        accel=convert.morton_accel(np_tree(ref["acc"]), "cpu"),
        lights=convert.lights(np_tree(ref["lights"]), "cpu"),
        surface=port_surface(np_tree(ref["surface"])),
        grid=convert.regir_grid(np_tree(ref["grid"]), "cpu"),
        cur=convert.reservoirs(np_tree(ref["cur"]), "cpu"),
        prev=convert.reservoirs(np_tree(ref["prev"]), "cpu"),
        temporal=convert.reservoirs(np_tree(ref["temporal"]), "cpu"))


def assert_reservoirs_match(got, want, max_mismatch=0.01, rtol=1e-3,
                            lit=0.2):
    want = np_tree(want)
    same = got.light_index.numpy() == np.asarray(want.light_index)
    assert 1.0 - same.mean() <= max_mismatch, 1.0 - same.mean()
    for name in ("w_sum", "phat", "w_out", "m_count"):
        a = getattr(got, name).numpy()[same]
        b = np.asarray(getattr(want, name))[same]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * 1e-3
                                   * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)
    np.testing.assert_allclose(got.uv.numpy()[same],
                               np.asarray(want.uv)[same], atol=1e-6)
    assert (np.asarray(want.w_out) > 0).mean() > lit


INITIAL_MODES = {
    "ReGIR_RIS": dict(),
    "Power_RIS": dict(local_light_mode="Power_RIS"),
    "Uniform": dict(local_light_mode="Uniform"),
    "no_local": dict(local_light_samples=0),
}


@pytest.mark.parametrize("mode", list(INITIAL_MODES))
def test_initial_sampling_modes(ref, port, mode):
    """Each light mode (and none) against the reference's loop; Power_RIS
    and Uniform build no grid in the pipeline, so none is passed."""
    kw = INITIAL_MODES[mode]
    grid_j = ref["grid"] if "local_light_mode" not in kw else None
    grid_t = port["grid"] if grid_j is not None else None
    want = jrestir.initial_sampling(
        ref["surface"], ref["scene"], ref["lights"], grid_j,
        jrestir.ReSTIRConfig(**kw), FRAME, BLOCK)
    got = trestir.initial_sampling(
        port["surface"], port["scene"], port["lights"], grid_t,
        trestir.ReSTIRConfig(**kw), FRAME, BLOCK, accel=port["accel"])
    # With no local-light candidate only the BRDF rays find lights.
    assert_reservoirs_match(got, want, lit=0.001 if mode == "no_local"
                            else 0.1)


@pytest.mark.parametrize("mode", ["ReGIR_RIS", "Power_RIS", "Uniform"])
def test_candidate_batch(ref, port, mode):
    """The batch equals the port's sequential loop bit for bit (the loop
    is the reference's path with initial_kernel off), and the reference's
    loop within the tolerances."""
    kw = dict(INITIAL_MODES[mode], initial_kernel=False)
    grid = port["grid"] if mode == "ReGIR_RIS" else None
    args = (port["surface"], port["scene"], port["lights"], grid)
    loop = trestir.initial_sampling(*args, trestir.ReSTIRConfig(**kw),
                                    FRAME, BLOCK, accel=port["accel"])
    batch = trestir.initial_sampling(
        *args, trestir.ReSTIRConfig(candidate_batch=True, **kw), FRAME,
        BLOCK, accel=port["accel"])
    for f in dataclasses.fields(trestir.Reservoirs):
        assert torch.equal(getattr(batch, f.name), getattr(loop, f.name)), \
            f.name
    want = jrestir.initial_sampling(
        ref["surface"], ref["scene"], ref["lights"],
        ref["grid"] if mode == "ReGIR_RIS" else None,
        jrestir.ReSTIRConfig(**kw), FRAME, BLOCK)
    assert_reservoirs_match(batch, want, lit=0.1)


def test_prev_material_rows(ref):
    """pack_prev_material: position and f16 pairs, bit for bit."""
    g = np_tree(ref["prev_gbuf"])
    from drts_tpu_torch.ops import shading
    gbuf = type("G", (), {})()
    gbuf.surf = type("S", (), {"position": t(g.surf.position),
                               "valid": t(g.surf.valid)})()
    gbuf.mat = shading.EvaluatedMaterial(**{
        f.name: t(getattr(g.mat, f.name))
        for f in dataclasses.fields(shading.EvaluatedMaterial)})
    got = trestir.pack_prev_material(gbuf).numpy()
    want = np.asarray(ref["prev_material"])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (want[..., 3:] != 0).any()


@pytest.mark.parametrize("prev_surface", ["pseudo", "real"])
@pytest.mark.parametrize("bias", ["basic", "pairwise", "raytraced"])
def test_temporal_modes(ref, port, bias, prev_surface):
    """Temporal reuse in each bias mode with each previous surface (the
    real one from the previous G-buffer's rows and camera position; basic
    reads neither). The pairwise rows are 5 words, the real-surface rows
    12, both through B4's plain nearest gather."""
    kw = dict(temporal_bias_correction=bias,
              temporal_prev_surface=prev_surface)
    real = prev_surface == "real"
    want = jrestir.temporal_resampling(
        ref["cur"], ref["prev"], ref["surface"], ref["lights"],
        ref["motion"], ref["prev_depth"], ref["gbuf"].mat.shading_normal,
        jrestir.ReSTIRConfig(**kw), FRAME, scene=ref["scene"],
        accel=ref["acc"], block_size=BLOCK,
        prev_material=ref["prev_material"] if real else None,
        prev_camera_position=ref["prev_cam"].position if real else None)
    got = trestir.temporal_resampling(
        port["cur"], port["prev"], port["surface"], port["lights"],
        t(ref["motion"]), t(ref["prev_depth"]),
        t(ref["gbuf"].mat.shading_normal), trestir.ReSTIRConfig(**kw),
        FRAME, scene=port["scene"], accel=port["accel"], block_size=BLOCK,
        prev_material=t(ref["prev_material"]) if real else None,
        prev_camera_position=t(ref["prev_cam"].position) if real else None)
    assert_reservoirs_match(got, want)
    # The history is taken on a good share of the pixels.
    assert (np.asarray(want.m_count) > 9).mean() > 0.15


@pytest.mark.parametrize("offsets", ["per_pixel", "shared"])
@pytest.mark.parametrize("bias", ["basic", "pairwise", "raytraced"])
def test_spatial_modes(ref, port, bias, offsets):
    """Spatial reuse, 2 neighbours, in each bias mode with each offset
    mode; the reference's frame index is an int32 array, as in its
    pipeline, so its shared offsets are float32."""
    kw = dict(spatial_bias_correction=bias, spatial_offset_mode=offsets,
              spatial_samples=2)
    want = jrestir.spatial_resampling(
        ref["temporal"], ref["surface"], ref["lights"],
        jrestir.ReSTIRConfig(**kw), jnp.int32(FRAME), scene=ref["scene"],
        accel=ref["acc"], block_size=BLOCK)
    got = trestir.spatial_resampling(
        port["temporal"], port["surface"], port["lights"],
        trestir.ReSTIRConfig(**kw), torch.tensor(FRAME), scene=port["scene"],
        accel=port["accel"], block_size=BLOCK, frame_count=FRAME)
    assert_reservoirs_match(got, want)


def test_shared_offsets_match_the_reference():
    """shared_offsets against the reference's own neighbour fetch, frames
    0-255 at 1-3 spatial samples. The reference's rolled rows carry, in
    place of the light id and M, the source pixel's x and y, so the roll
    it took reads off pixel (0, 0)."""
    n = 64
    yy, xx = np.mgrid[0:n, 0:n]
    res = jrestir.Reservoirs(
        light_index=jnp.asarray(xx, jnp.int32),
        uv=jnp.zeros((n, n, 2)), w_sum=jnp.zeros((n, n)),
        m_count=jnp.asarray(yy, jnp.float32), w_out=jnp.zeros((n, n)),
        phat=jnp.zeros((n, n)))
    surf = type("Surf", (), {})()
    surf.depth = jnp.ones((n, n))
    surf.normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (n, n, 3))
    surf.valid = jnp.ones((n, n), bool)
    for k in (1, 2, 3):
        cfg = jrestir.ReSTIRConfig(spatial_offset_mode="shared",
                                   spatial_samples=k)

        @jax.jit
        def fetch(fi, cfg=cfg):
            nbrs = jrestir._spatial_neighbors(res, surf, cfg, fi, False)
            return jnp.stack([jnp.stack([nb["idx"][0, 0],
                                         nb["m"][0, 0].astype(jnp.int32)])
                              for nb in nbrs])
        tcfg = trestir.ReSTIRConfig(spatial_offset_mode="shared",
                                    spatial_samples=k)
        for frame in range(256):
            src = np.asarray(fetch(jnp.int32(frame)))
            got = trestir.shared_offsets(frame, tcfg)
            for (sx, sy), (dx, dy) in zip(src, got):
                assert (sx, sy) == (dx % n, dy % n), (frame, k, dx, dy)
            assert all(abs(dx) <= 31 and abs(dy) <= 31 for dx, dy in got)
