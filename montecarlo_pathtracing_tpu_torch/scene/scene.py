"""Host-side scene container (numpy).

Reimplements the reference's Material / ScenePrimitives
(bvh_gpu/scene.{h,cpp}): a flat table of primitive records for 6 analytic
primitive types plus instanced triangle meshes, per-prim world AABBs
(padded x1.005, quads flattened, scene.cpp:18-42), and the
emissives-to-the-front stable partition (scene.cpp:70-88).

Instead of serializing to float textures (gpu_bvh_scene.cpp), the device
layout is a dataclass of torch tensors produced by
scene.device.compile_scene.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils import transforms as tf

F32 = np.float32

# primitive type codes (shared with ops.intersect)
CODE_MESH = 0
CODE_SPHERE = 1
CODE_CUBE = 2
CODE_CYLINDER = 3
CODE_CONE = 4
CODE_ORIENTED_QUAD = 5


@dataclass
class Material:
    """Material (scene.h:30-49): RGBA color; mat vector is
    (shininess, roughness, emissivity, area)."""
    color: np.ndarray
    shininess: float = 0.0
    roughness: float = 0.0
    emissivity: float = 0.0

    def __post_init__(self):
        self.color = np.asarray(self.color, dtype=F32)
        if self.color.shape != (4,):
            raise ValueError(f"Material color must be RGBA, got shape "
                             f"{self.color.shape}")

    @staticmethod
    def light(color, emissivity: float) -> "Material":
        return Material(color, 0.0, 0.0, emissivity)


@dataclass
class PrimRecord:
    """One primitive (PrimData analog, scene.h:64-73)."""
    type: int
    transfo: np.ndarray        # world placement (mesh: trf * bb.matrix())
    inv_transfo: np.ndarray    # world -> local (mesh: world -> mesh-local)
    mesh_transfo: np.ndarray   # mesh-local -> world (= transfo for analytics)
    color: np.ndarray          # RGBA
    mat: np.ndarray            # (shininess, roughness, emissivity, area)
    mesh_id: int = -1          # geometry handle for CODE_MESH


@dataclass
class MeshGeometry:
    """Triangle geometry shared by mesh instances."""
    vertices: np.ndarray   # [V,3] f32
    normals: np.ndarray    # [V,3] f32
    triangles: np.ndarray  # [T,3] i32

    @property
    def nb_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def bb(self):
        return (
            self.vertices.min(axis=0).astype(F32),
            self.vertices.max(axis=0).astype(F32),
        )

    def bb_matrix(self) -> np.ndarray:
        """BoundingBox::matrix() (mesh.h:67-71): translate(center)*scale(half)."""
        mn, mx = self.bb()
        center = (mn + mx) / 2.0
        half = (mx - mn) / 2.0
        return tf.translate(center) @ tf.scale(half)


class ScenePrimitives:
    """Scene builder with the reference's add_* API (scene.h:128-173)."""

    def __init__(self):
        self.prims: List[PrimRecord] = []
        self.meshes: List[MeshGeometry] = []

    def clear(self):
        self.prims = []
        self.meshes = []

    @property
    def nb(self) -> int:
        return len(self.prims)

    # -- analytic primitives ------------------------------------------------

    def _add_prim(self, code: int, trf, mat: Material, area: float) -> int:
        trf = np.asarray(trf, dtype=F32)
        rec = PrimRecord(
            type=code,
            transfo=trf,
            inv_transfo=tf.inverse(trf),
            mesh_transfo=trf,
            color=mat.color.copy(),
            mat=np.array(
                [mat.shininess, mat.roughness, mat.emissivity, area], dtype=F32
            ),
        )
        self.prims.append(rec)
        return len(self.prims) - 1

    def add_sphere(self, trf, mat: Material) -> int:
        r = float(np.linalg.norm(np.asarray(trf, F32)[:3, 0]))
        area = float(2.0 * np.pi) * r * r  # scene.h:128-133
        return self._add_prim(CODE_SPHERE, trf, mat, area)

    def _corner_edges(self, trf, z0=-1.0):
        trf = np.asarray(trf, F32)
        o = tf.apply(trf, (-1, -1, z0))
        u = tf.apply(trf, (1, -1, z0)) - o
        v = tf.apply(trf, (-1, 1, z0)) - o
        w = tf.apply(trf, (-1, -1, -z0 if z0 else 1)) - o
        return u, v, w

    def add_cube(self, trf, mat: Material) -> int:
        u, v, w = self._corner_edges(trf)
        area = 2.0 * (
            np.linalg.norm(np.cross(u, v))
            + np.linalg.norm(np.cross(u, w))
            + np.linalg.norm(np.cross(w, v))
        )
        return self._add_prim(CODE_CUBE, trf, mat, float(area))

    def add_cylinder(self, trf, mat: Material) -> int:
        u, v, w = self._corner_edges(trf)
        area = (
            (float(u @ u) + float(v @ v)) / 4.0
            * float(np.sqrt(2.0)) * float(np.pi) * float(np.linalg.norm(w))
        )  # scene.h:144-151
        return self._add_prim(CODE_CYLINDER, trf, mat, area)

    def add_cone(self, trf, mat: Material) -> int:
        return self._add_prim(CODE_CONE, trf, mat, 0.0)  # area TODO in ref too

    def add_oriented_quad(self, trf, mat: Material) -> int:
        trf = np.asarray(trf, F32)
        o = tf.apply(trf, (-1, -1, 0))
        u = tf.apply(trf, (1, -1, 0)) - o
        v = tf.apply(trf, (-1, 1, 0)) - o
        area = float(np.linalg.norm(np.cross(u, v)))
        return self._add_prim(CODE_ORIENTED_QUAD, trf, mat, area)

    # -- meshes --------------------------------------------------------------

    def add_mesh_geometry(self, geom: MeshGeometry) -> int:
        """Register shared triangle geometry (BVH_GPU_Scene::add_mesh analog,
        gpu_bvh_scene.cpp:51-74). Returns a mesh handle."""
        self.meshes.append(geom)
        return len(self.meshes) - 1

    def place_mesh(self, mesh_id: int, trf, mat: Material) -> int:
        """Instance a registered mesh (ScenePrimitives::add_mesh analog,
        scene.cpp:56-67): transfo_ = trf * bb.matrix() (world-AABB proxy),
        inv = trf^-1 (world -> mesh-local), mesh_transfo = trf."""
        trf = np.asarray(trf, dtype=F32)
        geom = self.meshes[mesh_id]
        rec = PrimRecord(
            type=CODE_MESH,
            transfo=(trf @ geom.bb_matrix()).astype(F32),
            inv_transfo=tf.inverse(trf),
            mesh_transfo=trf,
            color=mat.color.copy(),
            mat=np.array(
                [mat.shininess, mat.roughness, mat.emissivity, 0.0], dtype=F32
            ),
            mesh_id=mesh_id,
        )
        self.prims.append(rec)
        return len(self.prims) - 1

    # -- AABBs & emissive sort ------------------------------------------------

    def prim_bb(self, p: int):
        """World AABB of prim p (scene.cpp:18-42): the 8 corners of the
        +-1.005 cube through transfo_; quads flattened to +-0.001005.
        Returns (center, bbmin, bbmax)."""
        rec = self.prims[p]
        mn = np.full(3, np.finfo(F32).max, dtype=F32)
        mx = np.full(3, -np.finfo(F32).max, dtype=F32)
        for v in range(8):
            x = F32(v & 1) * F32(2.01) - F32(1.005)
            y = F32((v >> 1) & 1) * F32(2.01) - F32(1.005)
            z = F32((v >> 2) & 1) * F32(2.01) - F32(1.005)
            if rec.type == CODE_ORIENTED_QUAD:
                z = z / (abs(z) * F32(1000.0))
            b = tf.apply(rec.transfo, (x, y, z))
            mn = np.minimum(mn, b)
            mx = np.maximum(mx, b)
        return ((mn + mx) / 2.0).astype(F32), mn, mx

    def all_prim_bbs(self):
        n = self.nb
        centers = np.zeros((n, 3), F32)
        bbmin = np.zeros((n, 3), F32)
        bbmax = np.zeros((n, 3), F32)
        for i in range(n):
            centers[i], bbmin[i], bbmax[i] = self.prim_bb(i)
        return centers, bbmin, bbmax

    def sort_emissive_first(self) -> int:
        """Swap-based partition: emissive prims first (scene.cpp:70-88).
        Mirrors the reference's exact swap order (emissives keep relative
        order; non-emissives are permuted by the swaps). Returns the number
        of emissives."""
        prims = self.prims
        next_emi = 0
        while next_emi < len(prims) and prims[next_emi].mat[2] > 0.0:
            next_emi += 1
        it = next_emi
        while it < len(prims):
            if prims[it].mat[2] > 0.0:
                prims[next_emi], prims[it] = prims[it], prims[next_emi]
                next_emi += 1
            it += 1
        return next_emi
