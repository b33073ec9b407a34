"""The least bytes of B1 and B6, counted from their inputs' shapes."""

import pytest
import torch

from framebench.harness import roofline


def _rays(n, dead):
    rays = torch.zeros(8, n)
    rays[6] = 1e-3
    rays[7] = 1e8
    rays[7, :dead] = -1.0            # tmax < tmin: no work
    return rays


def test_closest_hit_bytes():
    n, dead, cols, chunks = 1000, 250, 448, 28
    got = roofline.closest_hit_bytes(_rays(n, dead), torch.zeros(9, cols),
                                     torch.zeros(5, chunks))
    want = 750 * 32 + 250 * 8 + 9 * cols * 4 + 5 * chunks * 4 + n * 8
    assert int(got) == want


def test_blas_sweep_bytes():
    n, m, faces = 100, 438, 512
    rays = _rays(n, 10)
    cand = torch.full((n,), 3, dtype=torch.int32)
    cand[10:30] = -1                 # no candidate instance
    best = torch.full((n,), 0x7F7FFFFF, dtype=torch.int32)   # far best
    best[30:40] = 0                  # a best at t = 0 ends the lane
    inst_tbl = torch.zeros(9, m)
    tri_tbl = torch.zeros(faces, 9)
    bounds = torch.zeros(12, faces // 8)
    got = roofline.blas_sweep_bytes(rays, cand, best, best.clone(), inst_tbl,
                                    tri_tbl, bounds)
    live = 100 - 10 - 20 - 10
    want = (live * 44 + (n - live) * 16 + 9 * m * 4 + faces * 9 * 4
            + bounds.numel() * 4 + n * 8)
    assert int(got) == want


def test_kernel_pattern_matches_profiler_names():
    pat = roofline.kernel_pattern("shared_blas_sweep")
    assert pat.search("shared_blas_sweep(float const*, int, ...)")
    assert pat.search("void shared_blas_sweep<8>(float const*)")
    assert not pat.search("shared_blas_sweep_any(float const*)")
    assert not pat.search("my_shared_blas_sweep(float const*)")


def test_roofline_reads_nothing_without_a_known_peak():
    from framebench.harness import spec, trace
    read = spec.metric_reader("morton_closest_hit_roofline").read
    kw = dict(graph_frames=2, eager_frames=2,
              kernels=[("morton_closest_hit(float*)", 0.0, 10.0)],
              bytes={"morton_closest_hit_roofline": 2e6})
    on_h100 = trace.Reading(device_name="NVIDIA H100 80GB HBM3", **kw)
    assert read(on_h100) == pytest.approx(100 * (1e6 / 3.35e12) / 5e-6)
    assert read(trace.Reading(device_name="cpu", **kw)) is None
    assert read(trace.Reading(device_name="NVIDIA H100 80GB HBM3")) is None
