"""A cell of BENCHMARK.json cut to a size a CPU test can run: a 64x36
frame of the demo's field at oscillator_grid 2, two warm frames, a window
of one second, and a check at that size (its own limits: a sound run at
this size reads pose and post gaps near 1e-7, depth near 1e-5 and a
radiance tile gap of 0.05-0.15 with its few reference paths)."""

import dataclasses

from framebench.harness import spec

TINY_LIMITS = {"start_gap": 1e-5, "pose_gap_m": 1e-5, "rotation_gap": 1e-5,
               "depth_gap_p999": 1e-4, "post_gap": 1e-5,
               "radiance_tile_gap": 0.3}


def tiny_cell(workload="demo_spheres.sweep", tess=None, ranks=1,
              size=(64, 36)):
    cell = spec.load_cell(workload)
    cfg = dict(cell.config, output=list(size), ranks=ranks,
               scene={"layout_seed": 0, "oscillator_grid": 2,
                      "geosphere_tessellation": tess})
    limits = dict(TINY_LIMITS)
    if ranks > 1:
        limits["replica_gap"] = 0.0
    chk = dict(cell.check, ref_spp=4, ref_stride=2, tiles=[4, 2 if ranks > 1
                                                           else 3],
               depth_pixels=500, first_frames=2, limits=limits)
    return dataclasses.replace(cell, config=cfg, check=chk, chips=ranks,
                               traffic=dict(cell.traffic, warm_frames=2))
