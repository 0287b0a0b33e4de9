"""Procedural test meshes: the port's own copy of `surfjax/meshgen.py`."""

from __future__ import annotations

import numpy as np


def octasphere(subdivisions: int = 2):
    """Subdivided octahedron projected to the unit sphere.

    8 * 4**subdivisions triangles (128 at the default 2).
    Returns (vertices (V,3) f32, faces (F,3) i32).
    """
    verts = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
             (0, 0, -1)]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    verts = [np.array(v, np.float64) for v in verts]
    for _ in range(subdivisions):
        new_faces = []
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (verts[i] + verts[j]) * 0.5
                m = m / np.sqrt(np.dot(m, m))
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    return (np.stack(verts).astype(np.float32),
            np.asarray(faces, np.int32))
