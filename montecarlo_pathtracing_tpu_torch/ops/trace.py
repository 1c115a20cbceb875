"""Scene-level trace: fold every primitive group into a closest hit.

Port of montecarlo_pathtracing_tpu/ops/trace.py. Two forms:

`trace` (:27-83) is the AoS form over [N, 3] rays, the dense route's and
the AoS integrator's: every analytic group folds through the dense
[N, C] intersectors of ops/intersect.py, and every mesh instance through
their triangle fold. With `use_kernels` (the reference's use_pallas) a
group of at least PRIM_CHUNK (128) padded prims takes K3a and every mesh
instance K4a instead, through the AoS wrappers of ops/pallas_trace.py;
the same winners up to exact distance ties.

`trace_soa` (:100-296) folds every analytic group and mesh instance of
the scene into one `HitS` record through the trace kernels, choosing per
group or instance the same kernel as the reference:

  - groups of at most SMALL_GROUP_MAX prims: `_small_group_soa`, a
    Python loop over the prims with scalar coefficients (plain torch ops,
    as the reference's are XLA ops);
  - larger groups: K5 (`sparse_trace.group_best_rows_sparse`) when
    culling is on, M is a multiple of AN_TILE and the padded group has at
    most SPARSE_GROUP_MAX prims; otherwise `pallas_trace.group_best_rows`
    with the group's chunk boxes (K3b) when culling is on and the group
    spans more than one 128-prim chunk, without them (K3a) when not.
    M is always a multiple of AN_TILE on the route, so K3b runs for the
    groups past SPARSE_GROUP_MAX, e.g. the 150,016-prim sphere group of
    `scenes.scene_stress(n_prims=200_000)`;
  - mesh instances: K6 (`sparse_trace.mesh_best_rows_sparse`) when
    culling is on, the instance spans more than one 128-triangle chunk
    and M is a multiple of MESH_TILE; otherwise
    `pallas_trace.mesh_best_rows`, with the instance's leaf and super
    boxes (K4b) when culling is on and it spans more than one chunk. A
    multiple of AN_TILE is a multiple of MESH_TILE, so no route of the
    renderer reaches K4b (the reference's :223 alike); the op does.

Tie rule: a candidate replaces the best only if strictly closer in world
distance, groups in scene order, then instances.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import vec
from .intersect import (
    CODE_MESH, FLT_MAX, Hit, miss_hit, trace_analytic_group,
    trace_mesh_instance)
from .pallas_trace import (
    PRIM_CHUNK, _pad_group, group_best_rows, mesh_best_rows, pad_tris,
    trace_analytic_group_pallas, trace_mesh_instance_pallas)
from .shapes import SOA_FNS
from .sparse_trace import (
    AN_TILE, MESH_TILE, group_best_rows_sparse, mesh_best_rows_sparse)

_FMAX = float(FLT_MAX)

# Groups of at most this many (padded) prims take the plain scalar fold
# instead of a kernel, as in the reference
SMALL_GROUP_MAX = 96
# K5's gate: groups of at most this many padded prims take the walk, as
# in the reference (montecarlo_pathtracing_tpu/ops/trace.py:169-170,
# where it bounds the XLA-side [tiles, blocks] entry matrix); larger ones
# take K3b with the cull on
SPARSE_GROUP_MAX = 1 << 17


def trace(scene, O, D, *, use_kernels: bool = False) -> Hit:
    """Closest hit of world rays O, D: [N,3] against the whole scene.

    use_kernels folds the groups of at least PRIM_CHUNK prims through K3a
    and every mesh instance through K4a (the kernels' plain versions on
    CPU tensors); the dense fold remains the default and the reference
    semantics."""
    best = miss_hit(O.shape[:-1], O.device)
    for gi, code in enumerate(scene.group_codes):
        # K3a pads a group to PRIM_CHUNK lanes: a win only when the group
        # fills them
        if use_kernels and scene.group_prim[gi].shape[0] >= PRIM_CHUNK:
            best = trace_analytic_group_pallas(
                best, O, D, code, scene.group_transfo[gi],
                scene.group_inv[gi], scene.group_prim[gi])
            continue
        best = trace_analytic_group(
            best, O, D, code, scene.group_transfo[gi], scene.group_inv[gi],
            scene.group_prim[gi], scene.group_chunk[gi])
    for mi, prim_index in enumerate(scene.mesh_prim_index):
        off = scene.mesh_tri_offset[mi]
        cnt = scene.mesh_tri_padded[mi]
        tris = (scene.tri_va[off:off + cnt], scene.tri_vb[off:off + cnt],
                scene.tri_vc[off:off + cnt])
        if use_kernels:
            best = trace_mesh_instance_pallas(
                best, O, D, scene.inv_transfo[prim_index],
                scene.mesh_transfo[prim_index], prim_index, *tris,
                tri_offset=off)
            continue
        best = trace_mesh_instance(
            best, O, D, scene.inv_transfo[prim_index],
            scene.mesh_transfo[prim_index], prim_index, *tris,
            tri_offset=off, chunk=min(scene.tri_chunk, cnt))
    return best


def hit_any(scene, O, D):
    """Occlusion query (just_hit_bvh analog): True where any prim is hit."""
    return trace(scene, O, D).shape >= 0


class HitS(NamedTuple):
    """SoA closest-intersection record."""
    dist: torch.Tensor
    prim: torch.Tensor
    shape: torch.Tensor
    dircode: torch.Tensor
    tri: torch.Tensor
    pl: tuple       # vec3, local frame
    pg: tuple       # vec3, world frame

    @property
    def is_hit(self):
        return self.shape >= 0


def _miss_soa(m, device):
    z = torch.zeros((m,), dtype=torch.float32, device=device)
    mi = torch.full((m,), -1, dtype=torch.int32, device=device)
    return HitS(torch.full((m,), _FMAX, dtype=torch.float32, device=device),
                mi, mi, mi, mi, (z, z, z), (z, z, z))


def _better_soa(best: HitS, cand: HitS) -> HitS:
    take = cand.dist < best.dist
    return HitS(torch.where(take, cand.dist, best.dist),
                torch.where(take, cand.prim, best.prim),
                torch.where(take, cand.shape, best.shape),
                torch.where(take, cand.dircode, best.dircode),
                torch.where(take, cand.tri, best.tri),
                vec.where(take, cand.pl, best.pl),
                vec.where(take, cand.pg, best.pg))


def _full_i32(m, value, device):
    return torch.full((m,), value, dtype=torch.int32, device=device)


def trace_soa(scene, o, d, *, cull_chunks: bool | None = None) -> HitS:
    """Closest hit of rays o, d (vec3s of [M], M a multiple of RAY_TILE,
    unit directions; pad with unit-z dummy rays). cull_chunks: None
    (auto) or True takes the pruned walks K5 and K6 where the gates
    allow and the culled folds K3b and K4b where they do not; False
    forces the brute folds K3a and K4a. Winners are equal either way up
    to exact distance ties."""
    m = o[0].shape[0]
    dev = o[0].device
    o_rows = torch.stack(o)
    d_rows = torch.stack(d)
    best = _miss_soa(m, dev)
    cull = cull_chunks is not False

    for gi, code in enumerate(scene.group_codes):
        if scene.group_prim[gi].shape[0] <= SMALL_GROUP_MAX:
            best = _small_group_soa(
                best, o, d, code, scene.group_transfo[gi],
                scene.group_inv[gi], scene.group_prim[gi])
            continue
        inv_r, trf_r, pid = _pad_group(
            scene.group_transfo[gi], scene.group_inv[gi],
            scene.group_prim[gi])
        sparse = (cull and m % AN_TILE == 0
                  and inv_r.shape[1] <= SPARSE_GROUP_MAX)
        if sparse:
            dist, row, a, dircode = group_best_rows_sparse(
                o_rows, d_rows, code, inv_r, trf_r, pid,
                scene.group_super_bb[gi])
        else:
            multi = inv_r.shape[1] > PRIM_CHUNK
            dist, row, a, dircode = group_best_rows(
                o_rows, d_rows, code, inv_r, trf_r, pid,
                cbb=scene.group_chunk_bb[gi] if (cull and multi) else None)
        ok = row >= 0
        r = torch.where(ok, row, 0).long()
        tabg = torch.cat([inv_r, trf_r, pid.to(torch.float32)],
                         dim=0)[:, r]                       # [25, M]
        inv_g = tabg[0:12]
        trf_g = tabg[12:24]
        pid_g = torch.where(ok, tabg[24].to(torch.int32), -1)
        oi = vec.apply_affine(inv_g, o)
        di = vec.normalize(vec.apply_linear(inv_g, d), eps=1e-30)
        pl = vec.axpy(a, di, oi)
        pg = vec.apply_affine(trf_g, pl)
        cand = HitS(torch.where(ok, dist, _FMAX), pid_g,
                    torch.where(ok, code, -1).to(torch.int32), dircode,
                    _full_i32(m, -1, dev), pl, pg)
        best = _better_soa(best, cand)

    for mi_, prim_index in enumerate(scene.mesh_prim_index):
        off = scene.mesh_tri_offset[mi_]
        cnt = scene.mesh_tri_padded[mi_]
        inv = scene.inv_transfo[prim_index]
        mtrf = scene.mesh_transfo[prim_index]
        # one matrix for the whole instance: scalar coefficients over [M]
        oi = (inv[0, 0] * o[0] + inv[0, 1] * o[1] + inv[0, 2] * o[2]
              + inv[0, 3],
              inv[1, 0] * o[0] + inv[1, 1] * o[1] + inv[1, 2] * o[2]
              + inv[1, 3],
              inv[2, 0] * o[0] + inv[2, 1] * o[1] + inv[2, 2] * o[2]
              + inv[2, 3])
        di = vec.normalize(
            (inv[0, 0] * d[0] + inv[0, 1] * d[1] + inv[0, 2] * d[2],
             inv[1, 0] * d[0] + inv[1, 1] * d[1] + inv[1, 2] * d[2],
             inv[2, 0] * d[0] + inv[2, 1] * d[1] + inv[2, 2] * d[2]),
            eps=1e-30)
        tri = pad_tris(scene.tri_va[off:off + cnt],
                       scene.tri_vb[off:off + cnt],
                       scene.tri_vc[off:off + cnt])
        multi = tri.shape[1] > PRIM_CHUNK
        if cull and multi and m % MESH_TILE == 0:
            a, row = mesh_best_rows_sparse(
                torch.stack(oi), torch.stack(di), tri,
                scene.mesh_chunk_bb[mi_])
        else:
            a, row = mesh_best_rows(
                torch.stack(oi), torch.stack(di), tri,
                cbb=scene.mesh_chunk_bb[mi_] if (cull and multi) else None,
                sbb=scene.mesh_super_bb[mi_] if (cull and multi) else None)
        ok = row >= 0
        pl = vec.axpy(a, di, oi)
        pg = (mtrf[0, 0] * pl[0] + mtrf[0, 1] * pl[1] + mtrf[0, 2] * pl[2]
              + mtrf[0, 3],
              mtrf[1, 0] * pl[0] + mtrf[1, 1] * pl[1] + mtrf[1, 2] * pl[2]
              + mtrf[1, 3],
              mtrf[2, 0] * pl[0] + mtrf[2, 1] * pl[1] + mtrf[2, 2] * pl[2]
              + mtrf[2, 3])
        dist = vec.length(vec.sub(o, pg))
        cand = HitS(torch.where(ok, dist, _FMAX),
                    torch.where(ok, prim_index, -1).to(torch.int32),
                    torch.where(ok, CODE_MESH, -1).to(torch.int32),
                    _full_i32(m, 0, dev),
                    torch.where(ok, off + row, -1).to(torch.int32),
                    pl, pg)
        best = _better_soa(best, cand)
    return best


def _small_group_soa(best: HitS, o, d, code, trf, inv, pid) -> HitS:
    """Fold a small analytic group: a loop over its prims, each prim's
    matrix coefficients broadcast over the [M] ray rows. Same winners and
    order as the kernels (strictly closer, group order)."""
    fn = SOA_FNS[code]
    m = o[0].shape[0]
    dev = o[0].device
    for i in range(trf.shape[0]):
        iv = inv[i]
        tf_ = trf[i]
        oi = (iv[0, 0] * o[0] + iv[0, 1] * o[1] + iv[0, 2] * o[2] + iv[0, 3],
              iv[1, 0] * o[0] + iv[1, 1] * o[1] + iv[1, 2] * o[2] + iv[1, 3],
              iv[2, 0] * o[0] + iv[2, 1] * o[1] + iv[2, 2] * o[2] + iv[2, 3])
        di = vec.normalize(
            (iv[0, 0] * d[0] + iv[0, 1] * d[1] + iv[0, 2] * d[2],
             iv[1, 0] * d[0] + iv[1, 1] * d[1] + iv[1, 2] * d[2],
             iv[2, 0] * d[0] + iv[2, 1] * d[1] + iv[2, 2] * d[2]),
            eps=1e-30)
        a, valid, dircode = fn(oi[0], oi[1], oi[2], di[0], di[1], di[2])
        valid = valid & (pid[i] >= 0)
        pl = vec.axpy(a, di, oi)
        pg = (tf_[0, 0] * pl[0] + tf_[0, 1] * pl[1] + tf_[0, 2] * pl[2]
              + tf_[0, 3],
              tf_[1, 0] * pl[0] + tf_[1, 1] * pl[1] + tf_[1, 2] * pl[2]
              + tf_[1, 3],
              tf_[2, 0] * pl[0] + tf_[2, 1] * pl[1] + tf_[2, 2] * pl[2]
              + tf_[2, 3])
        dist = torch.where(valid, vec.length(vec.sub(o, pg)), _FMAX)
        cand = HitS(dist, torch.where(valid, pid[i], -1).to(torch.int32),
                    torch.where(valid, code, -1).to(torch.int32), dircode,
                    _full_i32(m, -1, dev), pl, pg)
        best = _better_soa(best, cand)
    return best
