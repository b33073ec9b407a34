"""Mesh generators and tangent frames (port of
``drts_tpu/models/geometry.py``; host-side numpy), and the analytic
sphere's lat-long tangent (a tensor function).

The geosphere is built the way DirectXTK12's ``CreateGeoSphere`` builds it:
octahedron base, edge-midpoint subdivision, projection to the sphere,
lat-long texture coordinates. The reference may take the same mesh from its
native helper library, whose vertex and face order can differ; this is the
numpy construction only, and the two agree as sets of vertices and faces.
"""

from __future__ import annotations

import numpy as np
import torch


def create_geosphere(diameter: float = 1.0, tessellation: int = 3):
    """Returns (positions (V, 3) f32, normals (V, 3), uvs (V, 2), indices
    (F, 3) i32) of a geodesic sphere: an octahedron subdivided
    `tessellation - 1` times (8 * 4**(tessellation - 1) faces), projected
    to the sphere of the given diameter."""
    t = max(1, int(tessellation))
    verts = np.array([
        [0, 1, 0], [0, 0, -1], [1, 0, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
    ], np.float64)
    faces = np.array([
        [0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],
        [5, 2, 1], [5, 3, 2], [5, 4, 3], [5, 1, 4],
    ], np.int64)

    for _ in range(t - 1):
        edge_cache: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = [v for v in verts]

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            idx = edge_cache.get(key)
            if idx is None:
                mid = verts_list[a] + verts_list[b]
                mid /= np.linalg.norm(mid)
                idx = len(verts_list)
                verts_list.append(mid)
                edge_cache[key] = idx
            return idx

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, np.int64)

    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    normals = verts.copy()

    # Lat-long UVs (Math::ToLatLongCoordinate convention).
    u = (1.0 + np.arctan2(verts[:, 0], verts[:, 2]) / np.pi) / 2.0
    v = np.arccos(np.clip(verts[:, 1], -1, 1)) / np.pi
    uvs = np.stack([u, v], axis=-1)

    positions = verts * (diameter * 0.5)
    return (positions.astype(np.float32), normals.astype(np.float32),
            uvs.astype(np.float32), faces.astype(np.int32))


def compute_tangent_frame(indices: np.ndarray, positions: np.ndarray,
                          normals: np.ndarray, uvs: np.ndarray) -> np.ndarray:
    """Per-vertex tangents from UV gradients (Lengyel's method, the
    algorithm of DirectXMesh's ComputeTangentFrame). Returns (V, 3) float32
    tangents, orthogonalized against the normals."""
    v_count = positions.shape[0]
    tan = np.zeros((v_count, 3), np.float64)

    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    p0, p1, p2 = positions[i0], positions[i1], positions[i2]
    w0, w1, w2 = uvs[i0], uvs[i1], uvs[i2]
    e1, e2 = p1 - p0, p2 - p0
    duv1, duv2 = w1 - w0, w2 - w0
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
    t_face = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
    np.add.at(tan, i0, t_face)
    np.add.at(tan, i1, t_face)
    np.add.at(tan, i2, t_face)

    # Gram-Schmidt against the normal; fall back to any perpendicular.
    n = normals.astype(np.float64)
    tan -= n * np.sum(tan * n, axis=-1, keepdims=True)
    lens = np.linalg.norm(tan, axis=-1, keepdims=True)
    fallback = np.cross(n, np.where(np.abs(n[:, 1:2]) < 0.99,
                                    [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]))
    fallback /= np.maximum(np.linalg.norm(fallback, axis=-1, keepdims=True),
                           1e-12)
    tan = np.where(lens > 1e-8, tan / np.maximum(lens, 1e-12), fallback)
    return tan.astype(np.float32)


def sphere_tangent(normal):
    """Analytic lat-long tangent (d position / d u) of unit-sphere normals
    (..., 3) tensors, consistent with the geosphere UVs: the analytic
    sphere path's normal-mapping tangent."""
    x, z = normal[..., 0], normal[..., 2]
    sin_theta = torch.sqrt(torch.clamp(x * x + z * z, min=1e-12))
    return torch.stack([z / sin_theta, torch.zeros_like(x), -x / sin_theta],
                       dim=-1)
