"""Scene compile: host ScenePrimitives -> dataclass of device tensors.

Port of montecarlo_pathtracing_tpu/scene/device.py (the replacement for
BVH_GPU_Scene::finalize, bvh_gpu/gpu_bvh_scene.cpp:121-187). The same
fields, layouts and static metadata as the JAX `DeviceScene`:

  - per-prim tables indexed by global primitive id (after the reference's
    emissives-first sort, scene.cpp:70-88): color [N,4], mat [N,4]
    (shininess, roughness, emissivity, area), transfo / inv_transfo /
    mesh_transfo [N,4,4]
  - per-shape-type homogeneous groups (transfo/inv/prim-id, padded to a
    chunk multiple), Morton-ordered by world-AABB center
  - per-mesh-instance triangle corner/normal pools, chunk-major triangle
    and analytic pools, and Morton chunk/super AABB tables

Everything is computed in numpy; the last step moves each array to the
requested device with `torch.as_tensor`. The device is the card ("cuda")
unless the caller names another. `from_jax_scene` takes the JAX
package's compiled scene (as numpy arrays) to the same dataclass, so a
scene compiled by the reference can be carried across unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .scene import (
    ScenePrimitives, CODE_MESH, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER,
    CODE_CONE, CODE_ORIENTED_QUAD,
)

F32 = np.float32

ANALYTIC_CODES = (CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE,
                  CODE_ORIENTED_QUAD)

TRI_SUPER = 16    # leaf chunks per super-chunk (16 x 128 = 2048 tris)
GROUP_SUP = 8     # prims per analytic worklist block
# Scenes whose padded analytic total exceeds ANA_SCENE_MIN (the
# megakernel's prim-table cap) move every group above ANA_GROUP_MIN prims
# into the chunked analytic pool of the fused route.
ANA_SCENE_MIN = 4096
ANA_GROUP_MIN = 128


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_group_size(count: int, analytic_chunk: int = 64) -> int:
    """Prims in a typed group after padding to its chunk: the one rule
    both the device layout and megakernel eligibility count with."""
    return _round_up(count, min(analytic_chunk, _round_up(count, 8)))


def _morton3(center, lo, hi) -> int:
    """30-bit Morton code of a point within the scene bounds."""
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip((center - lo) / span, 0.0, 1.0)
    q = (q * 1023.0).astype(np.int64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return int(spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2))


def _static():
    return dataclasses.field(metadata=dict(static=True))


@dataclass(frozen=True)
class DeviceScene:
    # --- per-prim tables (global prim id) ---
    color: torch.Tensor          # [N,4] f32
    mat: torch.Tensor            # [N,4] f32
    transfo: torch.Tensor        # [N,4,4]
    inv_transfo: torch.Tensor    # [N,4,4]
    mesh_transfo: torch.Tensor   # [N,4,4]
    # --- typed analytic groups (tuple aligned with group_codes) ---
    group_transfo: Tuple[torch.Tensor, ...]   # each [P,4,4]
    group_inv: Tuple[torch.Tensor, ...]       # each [P,4,4]
    group_prim: Tuple[torch.Tensor, ...]      # each [P] i32, -1 pad
    group_chunk_bb: Tuple[torch.Tensor, ...]  # each [6, n_kernel_chunks]
    # world AABBs over GROUP_SUP-prim Morton windows; padding windows get
    # empty boxes
    group_super_bb: Tuple[torch.Tensor, ...]  # each [6, P/GROUP_SUP]
    # --- mesh triangle pools (concatenated across instances) ---
    tri_va: torch.Tensor         # [T,3] mesh-local corner A
    tri_vb: torch.Tensor
    tri_vc: torch.Tensor
    tri_na: torch.Tensor         # [T,3] vertex normals
    tri_nb: torch.Tensor
    tri_nc: torch.Tensor
    tri_pos_rows: torch.Tensor   # [9, T] (ax ay az bx .. cz)
    tri_norm_rows: torch.Tensor  # [9, T]
    # per-mesh-instance chunk AABBs (mesh-local, 128-triangle chunks,
    # padded to a TRI_SUPER multiple with empty boxes) and their supers
    mesh_chunk_bb: Tuple[torch.Tensor, ...]
    mesh_super_bb: Tuple[torch.Tensor, ...]
    # chunk-major triangle pool: one [18, 128] block per 128-triangle chunk
    # (rows 0-8 corners, 9-17 vertex normals)
    tri_chunks: torch.Tensor     # [C_total, 18, 128]
    # chunk-major analytic pool of the groups above ANA_GROUP_MIN prims in
    # scenes above ANA_SCENE_MIN: one [32, 128] block per 128-prim chunk
    # (rows 0-11 inverse affine, 12-23 forward affine, 24 shin, 25 rough,
    # 26 emis, 27-30 rgba, 31 ok flag), with chunk/super world AABBs
    ana_chunks: torch.Tensor     # [Ca_total, 32, 128]
    ana_chunk_bb: torch.Tensor   # [6, Ca_total]
    ana_super_bb: torch.Tensor   # [6, Ca_total/16]
    # per-prim world AABBs (x1.005 padding, scene.cpp:18-42)
    prim_bb_min: torch.Tensor    # [N,3]
    prim_bb_max: torch.Tensor    # [N,3]
    # --- static metadata ---
    # ((code, chunk_start, n_chunks, super_start), ...) for ana_chunks
    ana_groups: Tuple[Tuple[int, int, int, int], ...] = _static()
    group_codes: Tuple[int, ...] = _static()
    group_chunk: Tuple[int, ...] = _static()
    mesh_prim_index: Tuple[int, ...] = _static()
    mesh_tri_offset: Tuple[int, ...] = _static()
    mesh_tri_padded: Tuple[int, ...] = _static()
    tri_chunk: int = _static()
    nb_prims: int = _static()
    nb_emissives: int = _static()
    flat_face: bool = _static()
    has_transparent: bool = _static()

    @property
    def nb_meshes(self) -> int:
        return len(self.mesh_prim_index)

    @property
    def device(self) -> torch.device:
        return self.color.device


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:   # e.g. a view of another framework's buffer
        a = a.copy()
    return torch.as_tensor(a, device=device)


def from_numpy(fields: dict, device="cuda") -> DeviceScene:
    """Build a DeviceScene from numpy arrays (tuples of arrays for the
    group fields) and the static metadata, moving every array to
    `device`."""
    kw = {}
    for f in dataclasses.fields(DeviceScene):
        v = fields[f.name]
        if f.metadata.get("static"):
            kw[f.name] = v
        elif isinstance(v, (tuple, list)):
            kw[f.name] = tuple(_tensor(a, device) for a in v)
        else:
            kw[f.name] = _tensor(v, device)
    return DeviceScene(**kw)


def to_device(scene: DeviceScene, device) -> DeviceScene:
    """A copy of the scene with every tensor on `device` (the scene
    itself when it already lies there): the replica a shard renders
    against."""
    device = torch.device(device)
    if scene.device == device:
        return scene
    kw = {}
    for f in dataclasses.fields(DeviceScene):
        v = getattr(scene, f.name)
        if f.metadata.get("static"):
            kw[f.name] = v
        elif isinstance(v, tuple):
            kw[f.name] = tuple(t.to(device) for t in v)
        else:
            kw[f.name] = v.to(device)
    return DeviceScene(**kw)


def from_jax_scene(fields: dict, device="cuda") -> DeviceScene:
    """The JAX package's compiled DeviceScene, given as a dict of its
    fields with every array converted to numpy (tuples of arrays for the
    group fields) plus its static metadata, as this package's
    DeviceScene on `device`. Static tuples are normalised to python
    ints so they compare equal to `compile_scene`'s."""
    norm = dict(fields)
    norm["ana_groups"] = tuple(tuple(int(x) for x in g)
                               for g in fields["ana_groups"])
    for k in ("group_codes", "group_chunk", "mesh_prim_index",
              "mesh_tri_offset", "mesh_tri_padded"):
        norm[k] = tuple(int(x) for x in fields[k])
    for k in ("tri_chunk", "nb_prims", "nb_emissives"):
        norm[k] = int(fields[k])
    for k in ("flat_face", "has_transparent"):
        norm[k] = bool(fields[k])
    return from_numpy(norm, device=device)


def compile_scene(scene: ScenePrimitives, *, analytic_chunk: int = 64,
                  tri_chunk: int = 256, flat_face: bool = False,
                  device="cuda") -> DeviceScene:
    """finalize() analog: emissive sort -> dense arrays on `device` (the
    card unless the caller names the CPU)."""
    nb_emissives = scene.sort_emissive_first()
    n = scene.nb
    if n == 0:
        raise ValueError("empty scene")

    color = np.stack([p.color for p in scene.prims]).astype(F32)
    mat = np.stack([p.mat for p in scene.prims]).astype(F32)
    transfo = np.stack([p.transfo for p in scene.prims]).astype(F32)
    inv_transfo = np.stack([p.inv_transfo for p in scene.prims]).astype(F32)
    mesh_transfo = np.stack([p.mesh_transfo for p in scene.prims]).astype(F32)

    # world AABBs (prim_bb padding x1.005, scene.cpp:18-42)
    centers, bbmin, bbmax = scene.all_prim_bbs()

    # typed analytic groups, MORTON-ORDERED by world-AABB center so that
    # contiguous chunks are spatially coherent and their boxes cull
    group_codes, g_trf, g_inv, g_prim, g_chunk, g_cbb = [], [], [], [], [], []
    g_sbb = []
    ana_meta, ana_pool, ana_cbb_l, ana_sbb_l = [], [], [], []
    ana_coff = ana_soff = 0
    # the padded total is what megakernel eligibility counts, so no scene
    # falls between the prim table and the chunk pools
    _counts = {}
    for p in scene.prims:
        if p.type != CODE_MESH:
            _counts[p.type] = _counts.get(p.type, 0) + 1
    total_analytic = sum(padded_group_size(c, analytic_chunk)
                         for c in _counts.values())
    # the scene box of the Morton keys, once: inside the sort key it made
    # the sort quadratic in the group size
    scene_lo, scene_hi = bbmin.min(0), bbmax.max(0)
    for code in ANALYTIC_CODES:
        idx = [i for i, p in enumerate(scene.prims) if p.type == code]
        if not idx:
            continue
        idx = sorted(idx, key=lambda i: _morton3(centers[i], scene_lo,
                                                 scene_hi))
        chunk = min(analytic_chunk, _round_up(len(idx), 8))
        pad = padded_group_size(len(idx), analytic_chunk)
        trf = np.zeros((pad, 4, 4), F32)
        inv = np.zeros((pad, 4, 4), F32)
        trf[:] = np.eye(4, dtype=F32)
        inv[:] = np.eye(4, dtype=F32)
        pid = np.full(pad, -1, np.int32)
        for k, i in enumerate(idx):
            trf[k] = scene.prims[i].transfo
            inv[k] = scene.prims[i].inv_transfo
            pid[k] = i
        # per-128-prim-chunk world AABBs (trace kernels' culling granularity)
        kchunk = 128
        kpad = _round_up(pad, kchunk)
        nkc = kpad // kchunk
        cbb = np.zeros((6, nkc), F32)
        for c in range(nkc):
            ids = idx[c * kchunk:(c + 1) * kchunk]
            if ids:
                cbb[0:3, c] = bbmin[ids].min(axis=0)
                cbb[3:6, c] = bbmax[ids].max(axis=0)
            else:   # padding-only chunk: empty box that nothing hits
                cbb[0:3, c] = 1.0
                cbb[3:6, c] = -1.0
        # world AABBs over GROUP_SUP-prim Morton windows at 128 padding
        spad = _round_up(pad, 128)
        nsb = spad // GROUP_SUP
        sbbg = np.zeros((6, nsb), F32)
        for sc in range(nsb):
            ids = idx[sc * GROUP_SUP:(sc + 1) * GROUP_SUP]
            if ids:
                sbbg[0:3, sc] = bbmin[ids].min(axis=0)
                sbbg[3:6, sc] = bbmax[ids].max(axis=0)
            else:       # padding-only window: empty box
                sbbg[0:3, sc] = 1.0
                sbbg[3:6, sc] = -1.0
        group_codes.append(code)
        g_trf.append(trf)
        g_inv.append(inv)
        g_prim.append(pid)
        g_chunk.append(chunk)
        g_cbb.append(cbb)
        g_sbb.append(sbbg)

        if total_analytic > ANA_SCENE_MIN and len(idx) > ANA_GROUP_MIN:
            # chunk-major pool blocks: [nkc16, 32, 128] per-prim scalar
            # rows (zeros = pad prims whose ok row stays 0), chunk/super
            # world boxes padded to TRI_SUPER multiples with empty boxes
            nkc16 = _round_up(nkc, TRI_SUPER)
            rows = np.zeros((nkc16 * kchunk, 32), F32)
            ni = len(idx)
            rows[:ni, 0:12] = inv[:ni, :3, :4].reshape(ni, 12)
            rows[:ni, 12:24] = trf[:ni, :3, :4].reshape(ni, 12)
            rows[:ni, 24:27] = mat[idx, 0:3]
            rows[:ni, 27:31] = color[idx]
            rows[:ni, 31] = 1.0
            acbb = np.concatenate(
                [cbb, np.tile([[1.0]] * 3 + [[-1.0]] * 3,
                              (1, nkc16 - nkc)).astype(F32)], axis=1)
            asbb = np.zeros((6, nkc16 // TRI_SUPER), F32)
            for sc in range(nkc16 // TRI_SUPER):
                real = list(range(sc * TRI_SUPER,
                                  min((sc + 1) * TRI_SUPER, nkc)))
                if real:
                    asbb[0:3, sc] = acbb[0:3, real].min(axis=1)
                    asbb[3:6, sc] = acbb[3:6, real].max(axis=1)
                else:
                    asbb[0:3, sc] = 1.0
                    asbb[3:6, sc] = -1.0
            ana_meta.append((int(code), ana_coff, nkc16, ana_soff))
            ana_pool.append(
                rows.reshape(nkc16, kchunk, 32).transpose(0, 2, 1))
            ana_cbb_l.append(acbb)
            ana_sbb_l.append(asbb)
            ana_coff += nkc16
            ana_soff += nkc16 // TRI_SUPER

    # mesh instances: triangle corners/normals in mesh-local space,
    # MORTON-ORDERED by centroid, with per-chunk mesh-local AABBs
    mesh_prim_index, mesh_tri_offset, mesh_tri_padded = [], [], []
    va_l, vb_l, vc_l, na_l, nb_l, nc_l = [], [], [], [], [], []
    mesh_cbb, mesh_sbb = [], []
    tri_chunks_l = []
    offset = 0
    for i, p in enumerate(scene.prims):
        if p.type != CODE_MESH:
            continue
        geom = scene.meshes[p.mesh_id]
        t = geom.triangles
        ntris = t.shape[0]
        cent = (geom.vertices[t[:, 0]] + geom.vertices[t[:, 1]]
                + geom.vertices[t[:, 2]]) / 3.0
        lo, hi = cent.min(axis=0), cent.max(axis=0)
        order = sorted(range(ntris), key=lambda k: _morton3(cent[k], lo, hi))
        t = t[order]
        chunk = min(tri_chunk, _round_up(ntris, 8))
        pad = _round_up(ntris, chunk)
        va = np.zeros((pad, 3), F32)
        vb = np.zeros((pad, 3), F32)
        vc = np.zeros((pad, 3), F32)
        na = np.zeros((pad, 3), F32)
        nb_ = np.zeros((pad, 3), F32)
        nc = np.zeros((pad, 3), F32)
        va[:ntris] = geom.vertices[t[:, 0]]
        vb[:ntris] = geom.vertices[t[:, 1]]
        vc[:ntris] = geom.vertices[t[:, 2]]
        na[:ntris] = geom.normals[t[:, 0]]
        nb_[:ntris] = geom.normals[t[:, 1]]
        nc[:ntris] = geom.normals[t[:, 2]]
        # chunk AABBs at 128-triangle granularity, padded to a TRI_SUPER
        # multiple with EMPTY boxes; supers union their real chunks' boxes
        kchunk = 128
        nkc = _round_up(pad, kchunk) // kchunk
        nkc_pad = _round_up(nkc, TRI_SUPER)
        cbb = np.zeros((6, nkc_pad), F32)
        for c in range(nkc_pad):
            s, e = c * kchunk, min((c + 1) * kchunk, ntris)
            if s < ntris:
                corners = np.concatenate([va[s:e], vb[s:e], vc[s:e]])
                cbb[0:3, c] = corners.min(axis=0)
                cbb[3:6, c] = corners.max(axis=0)
            else:   # padding-only chunk: empty box that nothing enters
                cbb[0:3, c] = 1.0
                cbb[3:6, c] = -1.0
        nsuper = nkc_pad // TRI_SUPER
        sbb = np.zeros((6, nsuper), F32)
        for sc in range(nsuper):
            lo, hi = sc * TRI_SUPER, (sc + 1) * TRI_SUPER
            real = [c for c in range(lo, min(hi, nkc))
                    if c * kchunk < ntris]
            if real:
                sbb[0:3, sc] = cbb[0:3, real].min(axis=1)
                sbb[3:6, sc] = cbb[3:6, real].max(axis=1)
            else:
                sbb[0:3, sc] = 1.0
                sbb[3:6, sc] = -1.0
        mesh_prim_index.append(i)
        mesh_tri_offset.append(offset)
        mesh_tri_padded.append(pad)
        mesh_cbb.append(cbb)
        mesh_sbb.append(sbb)
        # chunk-major [nkc_pad, 18, 128] block pool (zeros = degenerate
        # triangles that never hit)
        tri18 = np.zeros((nkc_pad * kchunk, 18), F32)
        tri18[:ntris] = np.concatenate(
            [va[:ntris], vb[:ntris], vc[:ntris],
             na[:ntris], nb_[:ntris], nc[:ntris]], axis=1)
        tri_chunks_l.append(
            tri18.reshape(nkc_pad, kchunk, 18).transpose(0, 2, 1))
        va_l.append(va); vb_l.append(vb); vc_l.append(vc)
        na_l.append(na); nb_l.append(nb_); nc_l.append(nc)
        offset += pad

    def cat(parts, empty_shape, axis=0):
        if not parts:
            return np.zeros(empty_shape, F32)
        return np.ascontiguousarray(np.concatenate(parts, axis=axis))

    def rows9(a_parts, b_parts, c_parts):
        """[T,3] pools -> [9, T] rows (ax ay az bx .. cz)."""
        if not a_parts:
            return np.zeros((9, 0), F32)
        a = np.concatenate(a_parts, axis=0)
        b = np.concatenate(b_parts, axis=0)
        c = np.concatenate(c_parts, axis=0)
        return np.concatenate([a.T, b.T, c.T], axis=0)

    fields = dict(
        color=color,
        mat=mat,
        transfo=transfo,
        inv_transfo=inv_transfo,
        mesh_transfo=mesh_transfo,
        group_transfo=tuple(g_trf),
        group_inv=tuple(g_inv),
        group_prim=tuple(g_prim),
        group_chunk_bb=tuple(g_cbb),
        group_super_bb=tuple(g_sbb),
        tri_va=cat(va_l, (0, 3)), tri_vb=cat(vb_l, (0, 3)),
        tri_vc=cat(vc_l, (0, 3)), tri_na=cat(na_l, (0, 3)),
        tri_nb=cat(nb_l, (0, 3)), tri_nc=cat(nc_l, (0, 3)),
        tri_pos_rows=rows9(va_l, vb_l, vc_l),
        tri_norm_rows=rows9(na_l, nb_l, nc_l),
        mesh_chunk_bb=tuple(mesh_cbb),
        mesh_super_bb=tuple(mesh_sbb),
        tri_chunks=cat(tri_chunks_l, (0, 18, 128)),
        ana_chunks=cat(ana_pool, (0, 32, 128)),
        ana_chunk_bb=cat(ana_cbb_l, (6, 0), axis=1),
        ana_super_bb=cat(ana_sbb_l, (6, 0), axis=1),
        ana_groups=tuple(ana_meta),
        prim_bb_min=bbmin.astype(F32),
        prim_bb_max=bbmax.astype(F32),
        group_codes=tuple(group_codes),
        group_chunk=tuple(g_chunk),
        mesh_prim_index=tuple(mesh_prim_index),
        mesh_tri_offset=tuple(mesh_tri_offset),
        mesh_tri_padded=tuple(mesh_tri_padded),
        tri_chunk=tri_chunk,
        nb_prims=n,
        nb_emissives=nb_emissives,
        flat_face=flat_face,
        has_transparent=bool(np.any(color[:, 3] < 1.0)),
    )
    return from_numpy(fields, device=device)
