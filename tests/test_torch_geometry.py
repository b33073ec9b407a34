"""The port's geosphere and tangent frames against the reference's.

The reference's ``create_geosphere`` may return a mesh built by its native
helper library, whose vertex and face order need not be the numpy
construction's; the port keeps the numpy construction. So the two meshes
are compared as sets: vertices snapped to a 1e-5 grid (float32 positions
of a sphere of radius 1 resolve 6e-8), faces as cyclic triples of such
vertices. ``compute_tangent_frame`` is the same numpy code on the same
arrays: tolerance 0.
"""

import numpy as np
import pytest

from drts_tpu.models import geometry as jgeometry
from drts_tpu_torch.models import geometry as tgeometry


def _snap(x):
    return tuple(int(v) for v in np.round(np.asarray(x, np.float64) * 1e5))


def _face_set(positions, faces):
    out = set()
    for f in faces:
        corners = [_snap(positions[i]) for i in f]
        turns = [tuple(corners[i:] + corners[:i]) for i in range(3)]
        out.add(min(turns))       # winding kept, the start corner not
    return out


@pytest.mark.parametrize("tess", [1, 2, 3, 4])
def test_geosphere_equals_reference_as_sets(tess):
    jp, jn, ju, jf = jgeometry.create_geosphere(2.0, tess)
    tp, tn, tu, tf = tgeometry.create_geosphere(2.0, tess)
    assert tf.shape == (8 * 4 ** (tess - 1), 3) == jf.shape
    assert tp.dtype == np.float32 and tf.dtype == np.int32
    j_attr = {_snap(p): (_snap(n), _snap(u)) for p, n, u in zip(jp, jn, ju)}
    t_attr = {_snap(p): (_snap(n), _snap(u)) for p, n, u in zip(tp, tn, tu)}
    assert len(t_attr) == tp.shape[0] == jp.shape[0]
    assert t_attr == j_attr
    assert _face_set(tp, tf) == _face_set(jp, jf)


def test_geosphere_diameter_and_unit_normals():
    pos, nrm, uv, _ = tgeometry.create_geosphere(3.0, 3)
    np.testing.assert_allclose(np.linalg.norm(pos, axis=1), 1.5, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, rtol=1e-6)
    assert uv.min() >= 0.0 and uv.max() <= 1.0


@pytest.mark.parametrize("tess", [2, 4])
def test_tangent_frame_equals_reference(tess):
    pos, nrm, uv, faces = jgeometry.create_geosphere(2.0, tess)
    expect = jgeometry.compute_tangent_frame(faces, pos, nrm, uv)
    got = tgeometry.compute_tangent_frame(faces, pos, nrm, uv)
    np.testing.assert_array_equal(got, expect)
    # Orthogonal to the normal, unit length.
    assert np.abs((got * nrm).sum(-1)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
