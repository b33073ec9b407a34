"""The port's TAA upscaler (``drts_tpu_torch/ops/taa.py``) against the
reference's ``drts_tpu/ops/taa.py`` on the CPU.

Inputs from a numpy seed: a jittered render-size colour (24x40), motion up
to 1.5 render px with taps off the edges, a reset-free sequence of three
steps from a fresh history, native (24x40) and 2x upscaled (48x80)
output, with and without DLSS-RR's confidence coupling.

- "bilinear": the port samples the f32 history through B4, as the
  reference's Pallas path does; the reference runs that path in interpret
  mode (its tile windows keep every tap at these motions). rtol 1e-4 /
  atol 1e-5 (XLA:CPU's fused multiply-adds, exp; 1.2e-5 relative measured).
- its XLA path reads the f16-packed mirror instead: held to the f16 step,
  rtol 2e-3 / atol 1e-3.
- "catmull" (XLA on both sides): rtol 1e-4 / atol 1e-5.
- the packed mirror's words: equal on > 99% of them (99.9% measured),
  each f16 half within one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.ops import intersect as jintersect, taa as jtaa
from drts_tpu_torch.ops import taa as ttaa

RH, RW = 24, 40
T = torch.from_numpy


def inputs(seed):
    rng = np.random.RandomState(seed)
    color = (rng.rand(RH, RW, 3) * 2.0).astype(np.float32)
    motion = ((rng.rand(RH, RW, 2) - 0.5) * 3.0).astype(np.float32)
    jitter = ((rng.rand(2) - 0.5)).astype(np.float32)
    conf = rng.rand(RH, RW).astype(np.float32)
    return color, motion, jitter, conf


_j_upscale = jax.jit(jtaa.upscale, static_argnums=(4, 5, 7))


def run_both(scale, history_filter, confidence, backend):
    oh, ow = RH * scale, RW * scale
    cfg_kw = dict(history_filter=history_filter, clip_gamma_motion=0.2,
                  clip_motion_px=0.25)
    jcfg, tcfg = jtaa.TAAConfig(**cfg_kw), ttaa.TAAConfig(**cfg_kw)
    js, ts = jtaa.init_state(oh, ow), ttaa.init_state(oh, ow, "cpu")
    old = jintersect.BACKEND
    jintersect.BACKEND = backend
    outs = []
    try:
        for seed in range(3):
            color, motion, jitter, conf = inputs(seed)
            js, jo = _j_upscale(js, jnp.asarray(color), jnp.asarray(motion),
                                jnp.asarray(jitter), oh, ow,
                                jnp.asarray(False), jcfg,
                                jnp.asarray(conf) if confidence else None)
            ts, to = ttaa.upscale(ts, T(color), T(motion), T(jitter), oh, ow,
                                  False, cfg=tcfg,
                                  confidence=T(conf) if confidence else None)
            outs.append((js, np.asarray(jo), ts, to.numpy()))
    finally:
        jintersect.BACKEND = old
    return outs


@pytest.mark.parametrize("scale,history_filter,confidence,backend", [
    (1, "bilinear", False, "interpret"), (2, "bilinear", True, "interpret"),
    (2, "bilinear", False, "xla"), (2, "catmull", False, "xla"),
    (1, "catmull", True, "xla")])
def test_upscale_matches(scale, history_filter, confidence, backend):
    outs = run_both(scale, history_filter, confidence, backend)
    packed_mirror = history_filter == "bilinear" and backend == "xla"
    rtol, atol = (2e-3, 1e-3) if packed_mirror else (1e-4, 1e-5)
    for js, jo, ts, to in outs:
        assert to.shape == (RH * scale, RW * scale, 3)
        assert np.isfinite(to).all()
        np.testing.assert_allclose(to, jo, rtol=rtol, atol=atol)
        np.testing.assert_allclose(ts.history.numpy(),
                                   np.asarray(js.history), rtol=rtol,
                                   atol=atol)
        if not packed_mirror:
            tw = ts.packed.numpy().view(np.uint32)
            jw = np.asarray(js.packed).view(np.uint32)
            assert (tw == jw).mean() > 0.99
            for shift in (0, 16):       # each f16 half within one step
                a = ((tw >> shift) & 0xFFFF).astype(np.int64)
                b = ((jw >> shift) & 0xFFFF).astype(np.int64)
                assert np.abs(a - b).max() <= 1


def test_render_size_and_reset():
    for mode in ttaa.SCALE_FACTORS:
        assert ttaa.render_size_for(1920, 1080, mode) == \
            jtaa.render_size_for(1920, 1080, mode)
    # A reset (or a fresh history) takes the current frame as it is.
    color, motion, jitter, _ = inputs(4)
    cfg = ttaa.TAAConfig(jitter_aware=False)
    state = ttaa.init_state(RH, RW, "cpu")
    state = ttaa.TAAState(history=state.history + 5.0, packed=state.packed)
    _, out = ttaa.upscale(state, T(color), T(motion), T(jitter), RH, RW,
                          True, cfg=cfg)
    np.testing.assert_allclose(out.numpy(), color, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        ttaa.upscale(state, T(color), T(motion), T(jitter), RH, RW, False,
                     cfg=ttaa.TAAConfig(history_filter="lanczos"))
