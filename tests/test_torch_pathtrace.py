"""The port's G-buffer and wavefront integrator against the reference at
64x64 on a small demo scene, the golden recipe through the port, and the
port's independence from JAX.

The reference runs its Pallas closest-hit kernels in interpret mode
(intersect.BACKEND = "interpret"), so both packages take the Morton
kernel's packed, truncated t and the Newton refinement. Per-path results
differ only by float32 rounding (XLA:CPU contracts multiply-adds into
FMAs; see tests/test_torch_intersect.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from drts_tpu.models import clusters as jclusters, myscene as jmyscene
from drts_tpu.ops import camera as jcamera, gbuffer as jgbuffer
from drts_tpu.ops import intersect as jintersect, pathtrace as jpathtrace
from drts_tpu.ops import post as jpost
from drts_tpu_torch import convert
from drts_tpu_torch.models import clusters as tclusters
from drts_tpu_torch.models import myscene as tmyscene
from drts_tpu_torch.ops import camera as tcamera, gbuffer as tgbuffer
from drts_tpu_torch.ops import pathtrace as tpathtrace, post as tpost
from drts_tpu_torch.utils import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "demo_64.png")
W = H = 64


@pytest.fixture(scope="module")
def setup():
    host = jmyscene.build(oscillator_grid=3)
    pos = np.array([0.0, 1.0, -5.0])
    cam = jcamera.make_camera(tuple(pos), tuple(-pos / np.linalg.norm(pos)),
                              horizontal_fov_deg=90.0, aspect=1.0)
    plan = jclusters.build_plan_morton(np.asarray(host.scene.center),
                                       np.asarray(host.scene.radius),
                                       max_members=8)
    port = (convert.scene(jax.tree.map(np.asarray, host.scene), "cpu"),
            convert.camera(jax.tree.map(np.asarray, cam), "cpu"),
            convert.cluster_plan(plan, "cpu"))
    return (host.scene, cam, plan), port


def run_both(setup, **cfg_kw):
    """One frame (accel, G-buffer, trace_image) through each package."""
    (jscene, jcam, jplan), (tscene, tcam, tplan) = setup
    jcfg = jpathtrace.PathTraceConfig(width=W, height=H, block_size=4096,
                                      **cfg_kw)
    tcfg = tpathtrace.PathTraceConfig(width=W, height=H, block_size=4096,
                                      **cfg_kw)

    @jax.jit
    def frame(scene, cam):
        acc = jclusters.make_morton_accel(jplan, scene.center, scene.radius,
                                          sort_origin=cam.position)
        g = jgbuffer.generate(scene, cam, W, H, 4096, accel=acc)
        return g, jpathtrace.trace_image(scene, cam, jcfg, 0, gbuf=g,
                                         accel=acc)

    old = jintersect.BACKEND
    jintersect.BACKEND = "interpret"
    try:
        jg, jout = jax.block_until_ready(frame(jscene, jcam))
    finally:
        jintersect.BACKEND = old
    acc = tclusters.make_morton_accel(tplan, tscene.center, tscene.radius,
                                      sort_origin=tcam.position)
    tg = tgbuffer.generate(tscene, tcam, W, H, 4096, accel=acc)
    tout = tpathtrace.trace_image(tscene, tcam, tcfg, 0, gbuf=tg, accel=acc)
    return (jg, jout), (tg, tout)


def test_gbuffer_and_one_bounce_match(setup):
    """G-buffer channels, and radiance at 1 bounce on >= 99.5% of pixels
    within 1e-3 (the remainder may take another branch on a last-bit
    difference)."""
    (jg, jout), (tg, tout) = run_both(setup, bounces=1)
    np.testing.assert_array_equal(tg.surf.valid.numpy(),
                                  np.asarray(jg.surf.valid))
    valid = np.asarray(jg.surf.valid)
    assert 0.2 < valid.mean() < 0.95
    np.testing.assert_array_equal(tg.surf.object_index.numpy(),
                                  np.asarray(jg.surf.object_index))
    for name in ("position", "geometric_normal"):
        np.testing.assert_allclose(getattr(tg.surf, name).numpy()[valid],
                                   np.asarray(getattr(jg.surf, name))[valid],
                                   rtol=1e-4, atol=1e-4)
    for name in ("motion", "radiance", "diffuse_albedo", "specular_albedo"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   rtol=1e-4, atol=1e-4)
    diff = np.abs(tout.radiance.numpy() - np.asarray(jout.radiance)).max(-1)
    assert (diff <= 1e-3).mean() >= 0.995, (diff <= 1e-3).mean()
    assert float(tout.rays_traced) == float(jout.rays_traced)


def test_eight_bounces_with_spill_match(setup):
    """8 bounces, Russian roulette, compaction from bounce 2 into 128
    slots, so the deep segment and its spill wave both overflow: SSIM >
    0.97 and the same wavefront_overflow_paths."""
    (_, jout), (_, tout) = run_both(setup, bounces=8, compact_capacity=128)
    j_over = float(jout.counters["wavefront_overflow_paths"])
    t_over = float(tout.counters["wavefront_overflow_paths"])
    assert t_over == j_over
    assert j_over > 0, "the capacity must be small enough to drop paths"
    a = np.asarray(jpost.tonemap(jout.radiance))
    b = tpost.tonemap(tout.radiance).numpy()
    assert np.isfinite(b).all()
    assert timage.ssim(b, a) > 0.97


def test_golden_recipe_through_port():
    """tests/test_golden.py's recipe (no accel: the brute-force kernel)
    rendered by the port passes the golden test's bars."""
    host = tmyscene.build(oscillator_grid=8, device="cpu")
    pos = np.array([0.0, 1.0, -5.0])
    cam = tcamera.make_camera(tuple(pos), tuple(-pos / np.linalg.norm(pos)),
                              horizontal_fov_deg=90.0, aspect=1.0,
                              device="cpu")
    cfg = tpathtrace.PathTraceConfig(width=64, height=64, bounces=3,
                                     samples_per_pixel=4, block_size=4096)
    out = tpathtrace.trace_image(host.scene, cam, cfg, 0)
    img = tpost.tonemap(out.radiance).numpy()
    golden = timage.read_png(GOLDEN)[..., :3]
    assert golden.shape == img.shape
    assert timage.ssim(img, golden) > 0.97
    assert abs(float(img.mean()) - float(golden.mean())) < 0.01


def test_port_renders_without_jax():
    """A fresh interpreter renders a 16x16 sphere frame and a 16x16
    instanced-mesh frame through the port, with every module of the port
    loaded, and never imports jax or the reference package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import drts_tpu_torch\n"
        "from drts_tpu_torch import bench\n"
        "for m in pkgutil.walk_packages(drts_tpu_torch.__path__,"
        " 'drts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'drts_tpu_torch.ops.trimesh_kernels' in sys.modules\n"
        "assert 'drts_tpu_torch.models.geometry' in sys.modules\n"
        "stats, out = bench.bench_trace(16, 16, bounces=3, iters=1,"
        " device='cpu')\n"
        "assert out.radiance.shape == (16, 16, 3)\n"
        "assert bool(out.radiance.isfinite().all())\n"
        "stats, out = bench.bench_mesh(16, 16, tess=2, bounces=3, iters=1,"
        " oscillator_grid=2, device='cpu')\n"
        "assert out.radiance.shape == (16, 16, 3)\n"
        "assert bool(out.radiance.isfinite().all())\n"
        "assert bool(out.primary_valid.any())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'drts_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
