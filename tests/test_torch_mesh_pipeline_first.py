"""The all-mesh default frame graph of tests/test_torch_mesh_pipeline.py,
port against reference, with ``compact_from=1``: the reference's
``bench_mesh_pipeline`` integrator (the bounce-1 wavefront compacted and
octant-sorted, the deep segment cascading in its slot space, the SHARC
update trace compacted after bounce 0). Same scene, size, frames and
tolerances as that file (mean image difference <= 1e-3, every counting
counter equal, lights_dropped_power_frac within 1e-6); a file of its own
so that each file compiles one frame graph under jit."""

import pytest

import test_torch_mesh_pipeline as base


@pytest.mark.parametrize("compact_from", [1],
                         ids=lambda c: f"compact_from={c}")
def test_mesh_pipeline_frames_match(compact_from):
    base.assert_frames_match(*base.render_both(compact_from))
