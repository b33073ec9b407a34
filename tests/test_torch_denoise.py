"""The port's denoisers (``drts_tpu_torch/ops/denoise.py``: ReBLUR, ReLAX,
DLSS-RR's lighter ReLAX core, compose and demodulate) against the
reference's ``drts_tpu/ops/denoise.py`` on the CPU.

Inputs from a numpy seed at 24x40: demodulated signals with NaN and inf
entries, hit distances, depths with misses (inf), normals, roughness, and
motion up to 1.5 px with some taps off the frame edge, a second frame's
motion for the virtual-point specular fetch. Two consecutive steps from a
fresh state, so the second reads the first's history through B4 (nearest
on the f16-packed mirror; the "bilinear" case the f32 concatenation). The
reference runs its XLA gather path (the port's B4 is that exact gather).

Tolerances: the history lengths (decided by compares) and the packed
mirror's words exact on > 99.9% of them, the other words within one f16
step; filtered outputs and accumulated signals rtol 1e-4 / atol 1e-5
(XLA:CPU contracts multiply-adds into FMAs; the a-trous sums carry that
through 27-36 taps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.ops import denoise as jden
from drts_tpu_torch.ops import denoise as tden

H, W = 24, 40
T = torch.from_numpy


def step_inputs(seed):
    rng = np.random.RandomState(seed)
    diff = (rng.rand(H, W, 4) * 2.0).astype(np.float32)
    spec = (rng.rand(H, W, 4) * 3.0).astype(np.float32)
    diff[3, 5, 1] = np.nan
    spec[7, 9, 0] = np.inf
    n = rng.randn(H, W, 3).astype(np.float32) * 0.2
    n[..., 2] += 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = (5.0 + rng.rand(H, W) * 0.2).astype(np.float32)
    depth[:2, :] = np.inf                    # sky rows
    motion = ((rng.rand(H, W, 2) - 0.5) * 3.0).astype(np.float32)
    motion_spec = ((rng.rand(H, W, 2) - 0.5) * 3.0).astype(np.float32)
    valid = rng.rand(H, W) > 0.1
    rough = rng.rand(H, W).astype(np.float32)
    return diff, spec, motion, n, depth, valid, rough, motion_spec


_jitted = {name: jax.jit(getattr(jden, name), static_argnums=9)
           for name in ("denoise", "denoise_relax")}


def run_both(kind, history_filter, virtual):
    names = {"reblur": "denoise", "relax": "denoise_relax",
             "dlss_rr": "denoise_relax"}
    extra = {"relax_atrous_iterations": 3} if kind == "dlss_rr" else {}
    jcfg = jden.DenoiseConfig(history_filter=history_filter, **extra)
    tcfg = tden.DenoiseConfig(history_filter=history_filter, **extra)
    js = jden.init_state(H, W)
    ts = tden.init_state(H, W, "cpu")
    outs = []
    for seed in (1, 2):
        diff, spec, motion, n, depth, valid, rough, mspec = step_inputs(seed)
        js, jd, jsp = _jitted[names[kind]](
            js, jnp.asarray(diff), jnp.asarray(spec), jnp.asarray(motion),
            jnp.asarray(n), jnp.asarray(depth), jnp.asarray(valid),
            jnp.asarray(rough), jnp.asarray(False), jcfg,
            motion_specular=jnp.asarray(mspec) if virtual else None)
        ts, td, tsp = getattr(tden, names[kind])(
            ts, T(diff), T(spec), T(motion), T(n), T(depth), T(valid),
            T(rough), False, tcfg,
            motion_specular=T(mspec) if virtual else None)
        outs.append((js, np.asarray(jd), np.asarray(jsp), ts, td.numpy(),
                     tsp.numpy()))
    return outs


@pytest.mark.parametrize("kind,history_filter,virtual", [
    ("reblur", "nearest", True), ("reblur", "bilinear", False),
    ("relax", "nearest", True), ("dlss_rr", "nearest", True)])
def test_denoisers_match(kind, history_filter, virtual):
    outs = run_both(kind, history_filter, virtual)
    for js, jd, jsp, ts, td, tsp in outs:
        assert np.isfinite(td).all() and np.isfinite(tsp).all()
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tsp, jsp, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(ts.history_length.numpy(),
                                      np.asarray(js.history_length))
        for name in ("diffuse", "specular", "moments", "depth", "normal"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       rtol=1e-4, atol=1e-5)
        for name in ("packed", "packed_spec"):
            tw = getattr(ts, name).numpy().view(np.uint32)
            jw = np.asarray(getattr(js, name)).view(np.uint32)
            assert (tw == jw).mean() > 0.999
            for shift in (0, 16):       # each f16 half within one step
                a = ((tw >> shift) & 0xFFFF).astype(np.int64)
                b = ((jw >> shift) & 0xFFFF).astype(np.int64)
                assert np.abs(a - b).max() <= 1
    # The second step took history somewhere, and not everywhere.
    hist = outs[1][3].history_length.numpy()
    assert (hist == 2).mean() > 0.2 and (hist == 1).any()


def test_compose_and_demodulate_match():
    rng = np.random.RandomState(5)
    args = [rng.rand(H, W, 3).astype(np.float32) for _ in range(5)]
    valid = rng.rand(H, W) > 0.3
    j = jden.compose(*map(jnp.asarray, args), jnp.asarray(valid))
    t = tden.compose(*map(T, args), T(valid))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    albedo = args[2] * 0.01                 # some below the 1e-3 floor
    jd = jden.demodulate(*map(jnp.asarray, (args[0], args[1], albedo,
                                            args[3])))
    td = tden.demodulate(*map(T, (args[0], args[1], albedo, args[3])))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
