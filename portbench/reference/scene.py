"""The reference's scene tables, worked out from the scene description.

The description is the benchmark's own (`portbench/harness/scenes.py`
makes it from `portbench/scenes/<name>.json`): a list of primitives,
each a shape code, a 4x4 float32 placement, an RGBA colour and the
material scalars, and the triangle meshes the mesh primitives place.
From it this module builds, in plain NumPy and then as torch tensors of
the requested float type:

  - the emissives-first order of the primitives (the swap partition of
    the upstream viewer's `ScenePrimitives::sort_emissive`);
  - the per-primitive tables: colour, material, placement, inverse;
  - one group per analytic shape, in the fold order sphere, cube,
    cylinder, cone, quad, primitives in index order;
  - one record per mesh instance: its triangles' corners and vertex
    normals in the mesh's own frame.

Nothing here comes from the program under test.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

F32 = np.float32

CODE_MESH = 0
CODE_SPHERE = 1
CODE_CUBE = 2
CODE_CYLINDER = 3
CODE_CONE = 4
CODE_QUAD = 5
ANALYTIC_ORDER = (CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE,
                  CODE_QUAD)


@dataclass
class Group:
    code: int
    transfo: torch.Tensor   # [C, 4, 4]
    inv: torch.Tensor       # [C, 4, 4]
    prim: torch.Tensor      # [C] int64 primitive ids


@dataclass
class Instance:
    prim: int               # primitive id of the instance
    tri_offset: int         # first triangle in the scene's triangle pool
    va: torch.Tensor        # [T, 3] mesh-local corners
    vb: torch.Tensor
    vc: torch.Tensor


@dataclass
class RefScene:
    color: torch.Tensor         # [P, 4]
    mat: torch.Tensor           # [P, 3] shininess, roughness, emissivity
    transfo: torch.Tensor       # [P, 4, 4]
    mesh_transfo: torch.Tensor  # [P, 4, 4]
    inv: torch.Tensor           # [P, 4, 4]
    groups: list
    instances: list
    tri: tuple                  # (va, vb, vc, na, nb, nc), each [T, 3]
    nb_prims: int
    has_transparent: bool


def emissive_first(prims: list) -> list:
    """The upstream swap partition: emissive primitives to the front, in
    their order; the others permuted by the swaps."""
    prims = list(prims)
    nxt = 0
    while nxt < len(prims) and prims[nxt]["emissivity"] > 0.0:
        nxt += 1
    for it in range(nxt, len(prims)):
        if prims[it]["emissivity"] > 0.0:
            prims[nxt], prims[it] = prims[it], prims[nxt]
            nxt += 1
    return prims


def _inverse(m) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, np.float64)).astype(F32)


def compile_reference(desc: dict, device, dtype=torch.float32) -> RefScene:
    """desc: {"prims": [...], "meshes": [...]} as the harness makes it."""
    prims = emissive_first(desc["prims"])
    n = len(prims)

    def t(a):
        return torch.as_tensor(np.asarray(a, F32), device=device).to(dtype)

    color = np.stack([p["color"] for p in prims]).astype(F32)
    mat = np.array([[p["shininess"], p["roughness"], p["emissivity"]]
                    for p in prims], F32)
    trf = np.stack([p["matrix"] for p in prims]).astype(F32)
    inv = np.stack([_inverse(p["matrix"]) for p in prims])
    groups = []
    for code in ANALYTIC_ORDER:
        ids = [i for i, p in enumerate(prims) if p["shape"] == code]
        if ids:
            groups.append(Group(code, t(trf[ids]), t(inv[ids]),
                                torch.as_tensor(ids, device=device)))
    instances, pool = [], [[] for _ in range(6)]
    offset = 0
    for i, p in enumerate(prims):
        if p["shape"] != CODE_MESH:
            continue
        m = desc["meshes"][p["mesh"]]
        tri = np.asarray(m["triangles"])
        corners = [np.asarray(m["vertices"], F32)[tri[:, k]]
                   for k in range(3)]
        normals = [np.asarray(m["normals"], F32)[tri[:, k]]
                   for k in range(3)]
        for k, a in enumerate(corners + normals):
            pool[k].append(a)
        instances.append(Instance(i, offset, *(t(c) for c in corners)))
        offset += tri.shape[0]
    tri_pool = tuple(t(np.concatenate(a) if a else np.zeros((0, 3), F32))
                     for a in pool)
    return RefScene(color=t(color), mat=t(mat), transfo=t(trf),
                    mesh_transfo=t(trf), inv=t(inv), groups=groups,
                    instances=instances, tri=tri_pool, nb_prims=n,
                    has_transparent=bool(np.any(color[:, 3] < 1.0)))
