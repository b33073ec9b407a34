"""The port's independent-tracer cross-check (``drts_tpu_torch/
crosscheck.py``) against the reference's ``drts_tpu/crosscheck.py``.

- ``extract_scene`` on the port's demo scene equals the reference's on
  its own, and the numpy ``trace`` gives the reference's radiance bit for
  bit on the same rays, bounces, spp and seed (both are the same float64
  numpy code);
- ``run(32, 18, 48, 3, device="cpu")`` (the port's integrator against
  the numpy tracer) meets tests/test_crosscheck.py's bounds: 0.97 <
  energy_ratio < 1.03 and mean_rel_err < 0.15; its dict has the
  reference's keys.
"""

import numpy as np

from drts_tpu import crosscheck as jcrosscheck
from drts_tpu.models import myscene as jmyscene
from drts_tpu_torch import crosscheck as tcrosscheck
from drts_tpu_torch.models import myscene as tmyscene


def test_extract_scene_and_trace_match_the_reference():
    jsc = jcrosscheck.extract_scene(
        jmyscene.build(seed=0, load_textures=False).scene)
    tsc = tcrosscheck.extract_scene(tmyscene.build(seed=0,
                                                   device="cpu").scene)
    assert set(tsc) == set(jsc)
    for k, v in jsc.items():
        assert tsc[k].dtype == np.float64
        np.testing.assert_array_equal(tsc[k], v, err_msg=k)
    rng = np.random.default_rng(3)
    n = 96
    ray_o = np.tile([0.0, 0.0, -15.0], (n, 1))
    ray_d = rng.normal([0.0, 0.0, 1.0], 0.3, (n, 3))
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    got = tcrosscheck.trace(tsc, ray_o, ray_d, bounces=3, spp=4, seed=5)
    want = jcrosscheck.trace(jsc, ray_o, ray_d, bounces=3, spp=4, seed=5)
    assert got.shape == (n, 3) and got.mean() > 0.0
    np.testing.assert_array_equal(got, want)


def test_full_scene_energy_matches_independent_tracer():
    r = tcrosscheck.run(width=32, height=18, spp=48, bounces=3,
                        device="cpu")
    assert set(r) == {"metric", "resolution", "spp", "bounces",
                      "mean_ours", "mean_independent", "energy_ratio",
                      "mean_rel_err", "p95_rel_err"}
    assert 0.97 < r["energy_ratio"] < 1.03, r
    assert r["mean_rel_err"] < 0.15, r
