"""Procedural triangle meshes that scene files name by generator.

The upstream viewer's lat-long sphere and torus (easycppogl/mesh.cpp:431
and :602), with area-weighted vertex normals (:125-141). The benchmark
makes the geometry once and hands the same arrays to the program and to
the reference.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def vertex_normals(vertices, triangles) -> np.ndarray:
    """Sum the faces' unnormalized cross products at each corner, then
    normalize."""
    v = vertices.astype(np.float64)
    t = triangles
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, t[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens[lens == 0] = 1.0
    return (normals / lens).astype(F32)


def _mesh(verts, tris) -> dict:
    verts = np.asarray(verts, F32)
    tris = np.asarray(tris, np.int32)
    return {"vertices": verts, "normals": vertex_normals(verts, tris),
            "triangles": tris}


def sphere(res: int = 24) -> dict:
    verts = [(0.0, 0.0, -1.0)]
    for j in range(1, res):
        theta = np.pi * j / res - np.pi / 2
        for i in range(res * 2):
            phi = 2 * np.pi * i / (res * 2)
            verts.append((np.cos(theta) * np.cos(phi),
                          np.cos(theta) * np.sin(phi), np.sin(theta)))
    verts.append((0.0, 0.0, 1.0))
    w = res * 2
    tris = [(0, 1 + (i + 1) % w, 1 + i) for i in range(w)]
    for j in range(res - 2):
        r0 = 1 + j * w
        r1 = r0 + w
        for i in range(w):
            a, b = r0 + i, r0 + (i + 1) % w
            c, d = r1 + (i + 1) % w, r1 + i
            tris += [(a, b, c), (a, c, d)]
    top = len(verts) - 1
    rl = 1 + (res - 2) * w
    tris += [(top, rl + i, rl + (i + 1) % w) for i in range(w)]
    return _mesh(verts, tris)


def torus(major: float = 1.0, minor: float = 0.35, n1: int = 32,
          n2: int = 16) -> dict:
    verts = []
    for i in range(n1):
        a = 2 * np.pi * i / n1
        for j in range(n2):
            b = 2 * np.pi * j / n2
            r = major + minor * np.cos(b)
            verts.append((r * np.cos(a), r * np.sin(a), minor * np.sin(b)))
    tris = []
    for i in range(n1):
        for j in range(n2):
            a = i * n2 + j
            b = i * n2 + (j + 1) % n2
            c = ((i + 1) % n1) * n2 + (j + 1) % n2
            d = ((i + 1) % n1) * n2 + j
            tris += [(a, b, c), (a, c, d)]
    return _mesh(verts, tris)


GENERATORS = {"sphere": sphere, "torus": torus}
