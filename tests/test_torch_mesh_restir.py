"""The port's ReSTIR DI on scenes with mesh instances, and its sequential
candidate loop, against the reference's, on the CPU.

- ``initial_sampling`` with ``initial_kernel=False`` (the sequential
  candidate loop instead of the fused candidate kernel) on the 5-sphere
  scene of tests/test_torch_restir.py at 48x48;
- ``initial_sampling`` and ``final_shading`` on the mixed scene of
  tests/test_torch_trilight.py (a floor sphere, an emissive sphere, an
  emissive quad of two triangle lights) with no sphere accel, so the
  visibility rays take the closest-hit-then-exclude sphere test and the
  mesh any-hit loop;
- ``trace.occluded_scene`` on that scene and on the all-mesh demo scene
  (``as_mesh_scene(build(oscillator_grid=2), tessellation=2)``);
- two consecutive ``RenderPipeline.render_frame``s of the all-mesh demo
  scene at 32x32, 2 bounces, physics on, both packages started from the
  same converted ``FrameState``.

The reference runs its Pallas kernels in interpret mode
(``intersect.BACKEND = "interpret"``), each stage or frame under one jit;
the port takes its plain versions.
Inputs of the ray tests come from numpy seeds.

Tolerances (measured on this data in brackets), those of
tests/test_torch_restir.py and tests/test_torch_pipeline.py:

- reservoirs of a stage: picks differ on <= 1% of pixels (0 of 2,304 on
  both scenes); w_sum, phat, w_out and M within rtol 1e-3 where the picks
  agree (5.1e-7 of the largest value);
- final shading: within 1e-3 of the image maximum on >= 99.5% of pixels
  (all pixels, largest 7.4e-7 of it);
- ``occluded_scene``: the same bit on > 99.9% of rays, never a
  blocked dead ray;
- the frames: picks differ on <= 1% of pixels (0 and 0.49%), M on <= 5%
  (0 and 0.68%); where both agree w_out within 5e-3 relative on >= 99.5%
  of pixels and within 2e-2 anywhere (largest 1.5e-4 and 5.3e-3, on one
  pixel: a triangle light's solid-angle pdf divides by the cosine at the
  light, which amplifies rounding at grazing angles; XLA:CPU contracts
  multiply-adds into FMAs, the port rounds each operation); the
  tone-mapped images differ by <= 1e-6 on average (5.2e-8 and 6.6e-8) and
  by <= 1e-4 anywhere (largest 1.9e-5); counters within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import myscene as jmyscene, pipeline as jpipeline
from drts_tpu.models import scene as jscene
from drts_tpu.models.material import MaterialDesc, pack_materials
from drts_tpu.ops import (camera as jcamera, gbuffer as jgbuffer,
                          intersect as jintersect, light as jlight,
                          restir as jrestir, sky as jsky, trace as jtrace,
                          trimesh as jtrimesh)
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.models import pipeline as tpipeline
from drts_tpu_torch.ops import bxdf as tbxdf, restir as trestir
from drts_tpu_torch.ops import trace as ttrace

H = W = 48
FRAME = 3
T = torch.from_numpy


def np_tree(x):
    return jax.tree.map(np.asarray, x)


class interpret_mode:
    """The reference's Pallas kernels in interpret mode."""

    def __enter__(self):
        self.old = jintersect.BACKEND
        jintersect.BACKEND = "interpret"

    def __exit__(self, *exc):
        jintersect.BACKEND = self.old


def sphere_scene():
    """tests/test_torch_restir.py's scene: floor, two emitters, a metal and
    a glass sphere."""
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
    return jscene.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3, 0.3, 0.5, 0.55]), materials=mats,
        env=jsky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)))


def mixed_scene():
    """tests/test_torch_trilight.py's mixed-kind scene: a diffuse floor
    sphere, an emissive sphere and an emissive quad mesh instance."""
    pos = np.array([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5],
                    [0.5, 0.0, 0.5], [-0.5, 0.0, 0.5]], np.float32)
    nrm = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tan = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    mesh = jtrimesh.make_mesh(pos, nrm, uv, faces, tangents=tan)
    mats = pack_materials([
        MaterialDesc(base_color=(0.8, 0.8, 0.8, 1), roughness=0.6),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=5.0,
                     emissive_color=(1.0, 0.2, 0.2)),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=15.0,
                     emissive_color=(0.9, 0.9, 0.7)),
    ])
    center = jnp.array([[0.0, -100.0, 0.0], [-2.0, 2.0, 0.0]])
    rot = jnp.tile(jm.QUAT_IDENTITY, (2, 1))
    quad = jnp.array([[1.5, 2.5, 0.0]])
    mi = jscene.MeshInstances(
        center=quad, rotation=jnp.tile(jm.QUAT_IDENTITY, (1, 1)),
        prev_center=quad, prev_rotation=jnp.tile(jm.QUAT_IDENTITY, (1, 1)),
        scale=jnp.array([1.2]))
    return jscene.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3]), materials=mats,
        env=jsky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)),
        mesh=mesh, mesh_instances=mi)


def port_surface(js) -> trestir.Surface:
    """The reference's Surface, field by field, as the port's."""
    t = lambda x: T(np.array(x))  # noqa: E731
    return trestir.Surface(
        valid=t(js.valid), position=t(js.position), view=t(js.view),
        bsdf=tbxdf.BSDF(**{f.name: t(getattr(js.bsdf, f.name))
                           for f in dataclasses.fields(tbxdf.BSDF)}),
        sv=tbxdf.SurfaceVectors(**{
            f.name: t(getattr(js.sv, f.name))
            for f in dataclasses.fields(tbxdf.SurfaceVectors)}),
        lobe_weights=t(js.lobe_weights), depth=t(js.depth),
        normal=t(js.normal))


_STAGE_CASES = {}


def stage_case(name):
    """The reference's initial sampling and final shading on one scene, and
    the same inputs as the port's objects, computed once per scene. No
    sphere accel: every sphere ray is a brute-force sweep."""
    if name not in _STAGE_CASES:
        _STAGE_CASES[name] = make_stage_case(name)
    return _STAGE_CASES[name]


def make_stage_case(name):
    if name == "mixed":
        scene, cfg_kw = mixed_scene(), {}
    else:
        scene, cfg_kw = sphere_scene(), dict(initial_kernel=False)
    cam = jcamera.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                              aspect=1.0)
    cfg = jrestir.ReSTIRConfig(**cfg_kw)

    @jax.jit
    def stages(scene, cam):
        gbuf = jgbuffer.generate(scene, cam, W, H, 4096)
        lights = jlight.prepare(scene)
        surface = jrestir.make_surface(gbuf)
        grid = jrestir.build_regir_grid(lights, cam.position, cfg, FRAME)
        cur = jrestir.initial_sampling(surface, scene, lights, grid, cfg,
                                       FRAME, 4096)
        diffuse, specular = jrestir.final_shading(cur, surface, scene,
                                                  lights, 4096)
        return lights, surface, grid, cur, diffuse, specular

    with interpret_mode():
        lights, surface, grid, cur, diffuse, specular = stages(scene, cam)
    ref = dict(cur=np_tree(cur), diffuse=np.asarray(diffuse),
               specular=np.asarray(specular), lights=np_tree(lights))
    port = dict(scene=convert.scene(np_tree(scene), "cpu"),
                lights=convert.lights(np_tree(lights), "cpu"),
                surface=port_surface(np_tree(surface)),
                grid=convert.regir_grid(np_tree(grid), "cpu"),
                cur=convert.reservoirs(np_tree(cur), "cpu"),
                cfg=trestir.ReSTIRConfig(**cfg_kw))
    return ref, port


def assert_reservoirs_match(got, want, max_mismatch, rtol):
    same = got.light_index.numpy() == want.light_index
    assert 1.0 - same.mean() <= max_mismatch, 1.0 - same.mean()
    for name in ("w_sum", "phat", "w_out", "m_count"):
        a = getattr(got, name).numpy()[same]
        b = getattr(want, name)[same]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * 1e-3
                                   * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)
    np.testing.assert_allclose(got.uv.numpy()[same], want.uv[same], atol=1e-5)
    assert (want.w_out > 0).mean() > 0.2


@pytest.mark.parametrize("name", ["spheres-loop", "mixed"])
def test_initial_sampling_through_the_loop(name):
    ref, port = stage_case(name)
    got = trestir.initial_sampling(port["surface"], port["scene"],
                                   port["lights"], port["grid"], port["cfg"],
                                   FRAME, 4096)
    assert_reservoirs_match(got, ref["cur"], 0.01, 1e-3)
    picked = np.unique(ref["cur"].light_index[ref["cur"].w_out > 0])
    assert len(picked) > 1
    if name == "mixed":
        # Both kinds of light win pixels.
        kinds = ref["lights"].compact[picked, 15]
        assert (kinds == 1).any() and (kinds == 0).any()
        assert port["lights"].has_triangles


@pytest.mark.parametrize("name", ["spheres-loop", "mixed"])
def test_final_shading_with_mesh_visibility(name):
    ref, port = stage_case(name)
    diff, spec = trestir.final_shading(port["cur"], port["surface"],
                                       port["scene"], port["lights"], 4096)
    for got, want in ((diff, ref["diffuse"]), (spec, ref["specular"])):
        err = np.abs(got.numpy() - want).max(-1)
        assert (err <= 1e-3 * want.max()).mean() >= 0.995
        assert want.max() > 0


def test_loop_equals_the_candidate_kernels_plain_version():
    """On a sphere-only scene the sequential loop and the fused candidate
    kernel's plain version draw the same candidates: the same picks on
    >= 99.5% of pixels (measured: all) and the same weights there."""
    _, port = stage_case("spheres-loop")
    args = (port["surface"], port["scene"], port["lights"], port["grid"])
    loop = trestir.initial_sampling(*args, port["cfg"], FRAME, 4096)
    fused = trestir.initial_sampling(*args, trestir.ReSTIRConfig(), FRAME,
                                     4096)
    same = (loop.light_index == fused.light_index).numpy()
    assert same.mean() >= 0.995
    np.testing.assert_allclose(loop.w_out.numpy()[same],
                               fused.w_out.numpy()[same], rtol=1e-3,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# occluded_scene


@pytest.mark.parametrize("name", ["mixed", "allmesh"])
def test_occluded_scene_matches(name):
    """Shadow rays of random length (a fifth dead) from around the scene,
    half of them aimed at an object, each excluding a sphere id or none."""
    if name == "mixed":
        jsc = mixed_scene()
        targets = np.concatenate([np.asarray(jsc.center[1:]),
                                  np.asarray(jsc.mesh_instances.center)])
        spread = 4.0
    else:
        jsc = jmyscene.as_mesh_scene(jmyscene.build(oscillator_grid=2),
                                     tessellation=2).scene
        targets = np.asarray(jsc.mesh_instances.center)[2:]
        spread = 8.0
    tsc = convert.scene(np_tree(jsc), "cpu")
    rng = np.random.RandomState(29)
    lead = (40, 50)
    n = lead[0] * lead[1]
    o = (targets[rng.randint(0, len(targets), n)]
         + rng.randn(n, 3) * spread).astype(np.float32)
    aim = targets[rng.randint(0, len(targets), n)] + 0.3 * rng.randn(n, 3) - o
    d = rng.randn(n, 3)
    d = np.where((np.arange(n) % 2 == 0)[:, None], aim, d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dist = np.where(rng.rand(n) < 0.2, -1.0,
                    2.0 + 20.0 * rng.rand(n)).astype(np.float32)
    k = max(int(jsc.center.shape[0]), 1)
    excl = rng.randint(-1, k, n).astype(np.int32)
    o, d = o.reshape(lead + (3,)), d.reshape(lead + (3,))
    dist, excl = dist.reshape(lead), excl.reshape(lead)
    with interpret_mode():
        want = np.asarray(jax.jit(jtrace.occluded_scene, static_argnums=5)(
            jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
            jnp.asarray(excl), 4096))
    got = ttrace.occluded_scene(tsc, T(o), T(d), T(dist), T(excl).long(),
                                4096)
    assert got.dtype == torch.bool and got.shape == lead
    got = got.numpy()
    assert (got == want).mean() > 0.999, (got != want).sum()
    assert not got[dist < 0].any()
    assert 0.05 < got.mean() < 0.95


# ----------------------------------------------------------------------------
# The all-mesh frame

FW = FH = 32
FRAMES = 2
# Above the scene's one emissive instance (24 instances at oscillator grid
# 2; its 32 faces are the triangle lights), so that a good share of pixels
# is lit.
POSE_EYE = (-1.455, 1.6, 0.6)
POSE_TARGET = (-1.455, 0.2, 1.6)


@pytest.fixture(scope="module")
def frames():
    return make_frames()


def make_frames():
    """Both packages' frames of the all-mesh demo scene from one start
    state."""
    jcfg = jpipeline.PipelineConfig(
        output_width=FW, output_height=FH, render_width=FW, render_height=FH,
        upscaling=False, bounces=2, denoiser="None", sharc_enabled=False,
        block_size=4096, compact_from=2)
    jp = jpipeline.RenderPipeline(jcfg)
    jstate = jp.init_state(jmyscene.as_mesh_scene(
        jmyscene.build(oscillator_grid=2), tessellation=2))
    assert jp.cluster_plan is None
    fwd = np.array(POSE_TARGET, np.float32) - np.array(POSE_EYE, np.float32)
    pose = jpipeline.CameraPose(
        position=jnp.asarray(POSE_EYE, jnp.float32),
        forward=jnp.asarray(fwd / np.linalg.norm(fwd)),
        up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))

    tcfg = dataclasses.replace(tpipeline.restir_frame_config(FW, FH, 2),
                               block_size=4096)
    tp = tpipeline.RenderPipeline(tcfg, device="cpu")
    tp.build_plan(tmyscene.as_mesh_scene(
        tmyscene.build(oscillator_grid=2, device="cpu"), tessellation=2))
    assert tp.cluster_plan is None
    tstate = convert.frame_state(np_tree(jstate), "cpu")
    tpose = tpipeline.CameraPose(*(T(np.array(x)) for x in
                                   (pose.position, pose.forward, pose.up)))

    ref = []
    with interpret_mode():
        step = jax.jit(jp.render_frame)
        for _ in range(FRAMES):
            jstate, img = step(jstate, pose)
            ref.append((np_tree(jstate), np.asarray(img)))

    port = []
    for _ in range(FRAMES):
        di = {}

        def run(name, fn, *args):
            out = fn(*args)
            if name == "restir_final":
                di["total"] = out[0] + out[1]
            return out
        tstate, img = tp.render_frame(tstate, tpose, _run=run)
        port.append((tstate, img.numpy(), di["total"].numpy()))
    return ref, port


@pytest.mark.parametrize("i", range(FRAMES))
def test_mesh_frame_reservoirs_match(frames, i):
    ref, port = frames
    jr, tr = ref[i][0].reservoirs, port[i][0].reservoirs
    same = tr.light_index.numpy() == jr.light_index
    assert 1.0 - same.mean() <= 0.01
    same_m = tr.m_count.numpy() == jr.m_count
    assert 1.0 - same_m.mean() <= 0.05
    both = same & same_m
    rel = (np.abs(tr.w_out.numpy() - jr.w_out)
           / np.maximum(np.abs(jr.w_out), 1e-3))[both]
    assert (rel <= 5e-3).mean() >= 0.995 and rel.max() <= 2e-2, rel.max()
    assert len(np.unique(jr.light_index)) > 1
    assert (jr.w_out > 0).mean() > 0.2


@pytest.mark.parametrize("i", range(FRAMES))
def test_mesh_frame_images_match(frames, i):
    ref, port = frames
    jimg, timg = ref[i][1], port[i][1]
    assert timg.shape == (FH, FW, 3) and np.isfinite(timg).all()
    assert timg.min() >= 0.0 and timg.max() <= 1.0
    d = np.abs(timg - jimg)
    assert d.mean() <= 1e-6, d.mean()
    assert d.max() <= 1e-4, d.max()
    # Direct light from the triangle lights reaches a good share of the
    # frame.
    assert (port[i][2].sum(-1) > 0).mean() > 0.2


def test_mesh_frame_state_and_counters_match(frames):
    ref, port = frames
    for (js, _), (ts, *_) in zip(ref, port):
        assert int(ts.frame_index) == int(js.frame_index)
        for k, v in js.counters.items():
            assert float(ts.counters[k]) == pytest.approx(float(v), abs=1e-6)
        assert ts.scene.center.shape[0] == 0
        # Physics moved the instances, and both packages moved them alike.
        mi = ts.scene.mesh_instances
        np.testing.assert_allclose(mi.center.numpy(),
                                   js.scene.mesh_instances.center, atol=1e-5)
        assert float((mi.center - mi.prev_center).abs().max()) > 0.0
        np.testing.assert_allclose(ts.prev_depth.numpy(), js.prev_depth,
                                   rtol=1e-4)
