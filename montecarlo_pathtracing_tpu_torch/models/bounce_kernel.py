"""Fused per-bounce route: mesh and large analytic scenes on kernel K2.

Port of montecarlo_pathtracing_tpu/models/bounce_kernel.py. One launch of
kernel K2 (csrc/bounce_kernel.cu) runs one bounce of the wavefront, or
in whole-path mode the whole path: the closest hit over the small
analytic prim table (the megakernel's fold), a front-to-back walk of
every mesh instance's 16-chunk supers in the mesh-local frame with
Moller-Trumbore over 128-triangle chunks, the same walk in world distance
over the 128-prim chunks of every large analytic group, and then the
megakernel's bounce step.

The host builds the tables once per call (`fused_inputs`). Before each
launch `with_schedule` builds the per-tile nearest-first super schedule:
for each 1024-ray tile and each instance or group, its supers sorted by
the tile's conservative entry bound. On a CUDA device one launch of a
second kernel of csrc/bounce_kernel.cu builds it (`k2_schedule_launch`),
on the CPU `_schedules`' torch ops, its plain version. Mesh scenes run in
wavefront mode:
one launch per bounce; finished lanes are parked outside every box, and
from bounce 1 on the wavefront is re-sorted by direction octant and
origin Morton code (ops/sort_rays) so that each tile is a tight bundle.
Scenes with no mesh (large analytic only) run the whole path in one
launch; its tables, schedule and wavefront but for the pass's seed word
depend on the tile's rays alone, so a pass function's `MegaMemo` keeps
them across passes.

Three functions compute one K2 call from the same `FusedInputs` and
wavefront state (with its schedule):
  - `fused_call_reference`: the plain PyTorch version over flat [M]
    tensors. It folds every chunk of a mesh instance or group brute force
    in pool order ([M, 128] per chunk) where the kernel walks the
    schedule, so winners are equal up to exact distance ties;
  - `k2_launch`: the wrapper that launches K2 on CUDA tensors;
  - `fused_call`: the plain version for tensors on the CPU, K2 for CUDA
    tensors; it raises otherwise.

Wavefront state: stf [15, M] f32 rows (o, d, attenu, total, result) and
sti [4, M] rows (done, RNG s0 s1 s2). On the card sti is int32 holding
the uint32 bit patterns the kernel reads; on the CPU it is int64 holding
values in [0, 2**32), as ops/rng.py computes them. Both are updated in
place.

Deliberate difference from the reference: the large-group merge takes a
winner only where its recomputed hit is valid (the reference discards
that flag, bounce_kernel.py:734). With nb_bounces = 0 the whole-path mode
launches nothing and returns black, as the wavefront mode does.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops import rng as _rng
from ..ops.intersect import EPSILON
from ..ops.pallas_trace import _slab_enters
from ..ops.shapes import SOA_FNS
from ..ops.sort_rays import PARK_Z, ray_sort_key
from ..ops.vec import apply_affine, apply_linear, safe_rcp
from ..ops.worklist import INF, bundle_box_entry, tile_bundles
from ..utils.profiling import span
from .megakernel import (
    MEGA_CULL_MIN_PRIMS, MEGA_MAX_PRIMS, MEGA_SUPER, _FMAX, _bounce_step,
    _fold_table, _mega_meta, _mega_super_boxes, _mega_table, _new_win,
    _scene_tensors, _shading_normal, _win_result,
)

TILE = 1024        # rays per row of the super schedule (8 x 128 on the TPU)
LANES = 128        # triangles or prims per chunk
TRI_SUPER = 16     # chunks per super (scene/device.TRI_SUPER)
SF = 15            # f32 state rows: o3 d3 attenu3 total3 result3
SU = 4             # integer state rows: done, rng s0 s1 s2
# K2's shape rule, a mirror of csrc/bounce_kernel.cu's LANES_MANY,
# LANES_FEW and MANY_RAYS (the kernel chooses on the device; _lib checks
# this copy against the build): lanes per ray, SHAPES[0] in whole-path
# mode and for a wavefront launch with at least MANY_RAYS rays to scan,
# SHAPES[1] below
SHAPES = (8, 16)
MANY_RAYS = 32768
M32 = 0xFFFFFFFF
_EPS = float(EPSILON)
_F32 = torch.float32


class FusedInputs(NamedTuple):
    """Everything one K2 call reads besides the wavefront state.

    The small analytic groups: tab [38,P] prim table, gsbb [6,Sg] its
    super boxes (read with cull), group_desc [G,4] i32 and `groups` the
    same on the host. Meshes: msc [37,n_mesh] f32 (inverse and forward
    affine rows, shin, rough, emis, rgba, mesh-local root box), msi
    [4,n_mesh] i32 (chunk start, supers, super start, 0) and `meshes` the
    first three on the host; cbb [6,Cm] / sbb [6,Sm] chunk and super
    boxes; tpool [C,18,128] triangle chunks. Large groups: acbb [6,Ca],
    asbb [6,Sa], apool [Ca,32,128], agr [6,A] root boxes, ana_desc [A,4]
    i32 and `ana_groups` on the host. Schedule: ordr [M/TILE,1,Stot] i32
    and entr f32 of the same shape, None until `with_schedule`; mesh
    supers first, then large groups' (mesh_stot on), then the small
    groups' (sched_base on). Empty tables are [.., 1] zeros."""
    tab: torch.Tensor
    gsbb: torch.Tensor
    group_desc: torch.Tensor
    groups: Tuple[Tuple[int, int, int, int], ...]
    msc: torch.Tensor
    msi: torch.Tensor
    meshes: Tuple[Tuple[int, int, int], ...]
    cbb: torch.Tensor
    sbb: torch.Tensor
    tpool: torch.Tensor
    acbb: torch.Tensor
    asbb: torch.Tensor
    apool: torch.Tensor
    agr: torch.Tensor
    ana_desc: torch.Tensor
    ana_groups: Tuple[Tuple[int, int, int, int], ...]
    ordr: Optional[torch.Tensor]
    entr: Optional[torch.Tensor]
    ior: float
    mesh_stot: int
    sched_base: int
    has_transparent: bool
    flat_face: bool
    cull: bool


# --------------------------------------------------------------------------
# host side: routing predicate, tables, schedules
# --------------------------------------------------------------------------

def _small_group_ids(scene):
    """Indices of the analytic groups that stay in the prim table
    (everything compile_scene did NOT move into the chunked pool)."""
    large = {g[0] for g in scene.ana_groups}
    return [gi for gi, c in enumerate(scene.group_codes) if c not in large]


def _small_count(scene) -> int:
    return sum(int(scene.group_prim[gi].shape[0])
               for gi in _small_group_ids(scene))


def fused_eligible(scene) -> bool:
    """Static routing predicate: scenes with meshes and/or large analytic
    groups (compile_scene's chunked pools) whose small analytic remainder
    fits the prim table. Small analytic-only scenes take the megakernel."""
    if not scene.mesh_prim_index and not scene.ana_groups:
        return False
    return _small_count(scene) <= MEGA_MAX_PRIMS


def _small_meta(scene):
    """((code, start, count, super_start), ...) over the small groups and
    the table width: the megakernel's layout restricted to them."""
    return _mega_meta(scene, _small_group_ids(scene))


def cull_small(scene) -> bool:
    """The small-table fold uses the megakernel's two-level cull when the
    table is big enough to pay for it (MEGA_CULL_MIN_PRIMS)."""
    return _small_count(scene) >= MEGA_CULL_MIN_PRIMS


def _small_super_boxes(scene):
    """[6, S_small] world AABBs over MEGA_SUPER-prim windows of the small
    groups, the outer level of the culled fold."""
    ids = _small_group_ids(scene)
    if not ids:
        return torch.zeros((6, 1), dtype=_F32, device=scene.device)
    return _mega_super_boxes(scene, ids)


def _small_table(scene):
    """[38, P_small] prim table over the small groups only."""
    ids = _small_group_ids(scene)
    if not ids:
        return torch.zeros((38, 1), dtype=_F32, device=scene.device)
    return _mega_table(scene, ids)


def _mesh_tables(scene):
    """(msc, msi, meshes, cbb, sbb) for the mesh walk.

    msc [37, n_mesh] f32: rows 0-11 inverse affine, 12-23 mesh_transfo
    affine, 24 shin, 25 rough, 26 emis, 27-29 rgb, 30 alpha, 31-36 root
    AABB (mesh-local, union of the real chunk boxes). msi [4, n_mesh] i32:
    chunk_start, n_supers, super_start, 0; `meshes` holds its first three
    rows on the host. cbb/sbb: the instances' chunk/super AABBs side by
    side, [6, *]."""
    dev = scene.device
    if not scene.mesh_prim_index:
        z6 = torch.zeros((6, 1), dtype=_F32, device=dev)
        return (torch.zeros((37, 1), dtype=_F32, device=dev),
                torch.zeros((4, 1), dtype=torch.int32, device=dev), (),
                z6, z6)
    cols = []
    for prim_index, cbb_i in zip(scene.mesh_prim_index, scene.mesh_chunk_bb):
        inv = scene.inv_transfo[prim_index][:3, :4].reshape(12)
        mtr = scene.mesh_transfo[prim_index][:3, :4].reshape(12)
        m = scene.mat[prim_index]
        c = scene.color[prim_index]
        real = (cbb_i[0] <= cbb_i[3])[None, :]
        rlo = torch.where(real, cbb_i[0:3], INF).amin(dim=1)
        rhi = torch.where(real, cbb_i[3:6], -INF).amax(dim=1)
        cols.append(torch.cat([inv, mtr, m[0:3], c[0:3], c[3:4], rlo, rhi]))
    msc = torch.stack(cols, dim=1)                       # [37, n_mesh]

    msi = np.zeros((4, len(scene.mesh_prim_index)), np.int32)
    cstart = sstart = 0
    for i, cbb_i in enumerate(scene.mesh_chunk_bb):
        nkc = int(cbb_i.shape[1])
        msi[0:3, i] = (cstart, nkc // TRI_SUPER, sstart)
        cstart += nkc
        sstart += nkc // TRI_SUPER
    meshes = tuple(tuple(int(x) for x in msi[0:3, i])
                   for i in range(msi.shape[1]))
    return (msc, kernels.host_tensor(msi, torch.int32, dev), meshes,
            torch.cat(scene.mesh_chunk_bb, dim=1),
            torch.cat(scene.mesh_super_bb, dim=1))


def _ana_tables(scene):
    """[6, n_ana_groups] per-group world root AABBs (union of the real
    chunk boxes), the large-group walk's per-ray exit cap."""
    if not scene.ana_groups:
        return torch.zeros((6, 1), dtype=_F32, device=scene.device)
    cols = []
    for _code, cstart, nchunks, _sstart in scene.ana_groups:
        cb = scene.ana_chunk_bb[:, cstart:cstart + nchunks]
        real = (cb[0] <= cb[3])[None, :]
        rlo = torch.where(real, cb[0:3], INF).amin(dim=1)
        rhi = torch.where(real, cb[3:6], -INF).amax(dim=1)
        cols.append(torch.cat([rlo, rhi]))
    return torch.stack(cols, dim=1)


def _sorted_segment(ent):
    """(ent sorted ascending per tile, the stable permutation as i32)."""
    ent_s, order = torch.sort(ent, dim=1, stable=True)
    return order.to(torch.int32), ent_s


def _schedules(scene, o_rows, d_rows):
    """Per-(tile, instance or group) nearest-first super schedules of the
    outer trace, from the (sorted) wavefront o_rows, d_rows [3, M].

    The tile bundles are computed once in world space; each instance's
    local-frame bundle is derived by interval arithmetic over the inverse
    affine map (centre +- radius form). Entry distances come out in
    unnormalised local-direction units, so each tile's entry bound is
    scaled by the least |d_local| over its direction interval (0 where
    that interval spans 0 on every axis): a lower bound of every
    contained ray's unit-parameter entry. Returns (ordr [nt,1,Stot] i32,
    entr [nt,1,Stot] f32)."""
    olo, ohi, dlo, dhi = tile_bundles(o_rows, d_rows, TILE)   # [3, nt]
    nt = olo.shape[1]
    shrink = float(np.float32(1.0 - 1e-4))
    margin = float(np.float32(1e-4))
    ords, ents = [], []
    for prim_index, sbb_i in zip(scene.mesh_prim_index, scene.mesh_super_bb):
        inv = scene.inv_transfo[prim_index]
        lin = inv[:3, :3]
        absl = lin.abs()
        oc = (olo + ohi) * 0.5
        orad = (ohi - olo) * 0.5
        oc_l = lin @ oc + inv[:3, 3:4]
        orad_l = absl @ orad
        dc = (dlo + dhi) * 0.5
        drad = (dhi - dlo) * 0.5
        dc_l = lin @ dc
        drad_l = absl @ drad
        dl = dc_l - drad_l
        dh = dc_l + drad_l
        cmin = torch.where((dl <= 0.0) & (dh >= 0.0), 0.0,
                           torch.minimum(dl.abs(), dh.abs()))
        dmin = torch.sqrt((cmin * cmin).sum(dim=0))               # [nt]
        raw = bundle_box_entry((oc_l - orad_l, oc_l + orad_l, dl, dh), sbb_i)
        # scale before the INF test: INF * 0 would be NaN
        ent = torch.where(raw >= INF, INF,
                          raw * dmin[:, None] * shrink - margin)
        order, ent_s = _sorted_segment(ent)
        ords.append(order)
        ents.append(ent_s)

    def world_segment(boxes):
        raw = bundle_box_entry((olo, ohi, dlo, dhi), boxes)
        order, ent_s = _sorted_segment(
            torch.where(raw >= INF, INF, raw * shrink - margin))
        ords.append(order)
        ents.append(ent_s)

    for _code, _cstart, nchunks, sstart in scene.ana_groups:
        world_segment(scene.ana_super_bb[:, sstart:sstart + nchunks // 16])
    if cull_small(scene):
        gsbb = _small_super_boxes(scene)
        groups, _total = _small_meta(scene)
        for _code, _start, count, sstart in groups:
            nsup = -(-count // MEGA_SUPER)
            world_segment(gsbb[:, sstart:sstart + nsup])
    dev = o_rows.device
    if not ords:
        return (torch.zeros((nt, 1, 1), dtype=torch.int32, device=dev),
                torch.full((nt, 1, 1), INF, dtype=_F32, device=dev))
    return (torch.cat(ords, dim=1)[:, None, :].contiguous(),
            torch.cat(ents, dim=1)[:, None, :].contiguous())


def fused_inputs(scene, refract_ind) -> FusedInputs:
    """The scene tables of a K2 call (no schedule yet)."""
    dev = scene.device
    groups, _total = _small_meta(scene)
    csm = cull_small(scene)
    msc, msi, meshes, cbb, sbb = _mesh_tables(scene)
    mesh_stot = sum(int(c.shape[1]) // TRI_SUPER for c in scene.mesh_chunk_bb)
    ana_stot = sum(nc // TRI_SUPER for _c, _s, nc, _ss in scene.ana_groups)
    z6 = torch.zeros((6, 1), dtype=_F32, device=dev)
    has_ana = bool(scene.ana_groups)
    return FusedInputs(
        tab=_small_table(scene),
        gsbb=_small_super_boxes(scene) if csm else z6,
        group_desc=kernels.host_tensor(groups, torch.int32,
                                       dev).reshape(-1, 4),
        groups=groups,
        msc=msc, msi=msi, meshes=meshes, cbb=cbb, sbb=sbb,
        tpool=(scene.tri_chunks if meshes else
               torch.zeros((1, 18, LANES), dtype=_F32, device=dev)),
        acbb=scene.ana_chunk_bb if has_ana else z6,
        asbb=scene.ana_super_bb if has_ana else z6,
        apool=(scene.ana_chunks if has_ana else
               torch.zeros((1, 32, LANES), dtype=_F32, device=dev)),
        agr=_ana_tables(scene),
        ana_desc=kernels.host_tensor(scene.ana_groups, torch.int32,
                                     dev).reshape(-1, 4),
        ana_groups=tuple(scene.ana_groups),
        ordr=None, entr=None,
        ior=float(np.float32(refract_ind)),
        mesh_stot=mesh_stot, sched_base=mesh_stot + ana_stot,
        has_transparent=bool(scene.has_transparent),
        flat_face=bool(scene.flat_face), cull=csm)


def with_schedule(inp: FusedInputs, scene, stf) -> FusedInputs:
    """inp with the schedule of the wavefront state stf [15, M]: built by
    `_schedules`' torch ops for tensors on the CPU, by one launch of the
    schedule kernel (`k2_schedule_launch`, from inp's tables) for CUDA
    tensors; it raises otherwise."""
    if stf.device.type == "cpu":
        ordr, entr = _schedules(scene, stf[0:3], stf[3:6])
    else:
        ordr, entr = k2_schedule_launch(inp, stf)
    return inp._replace(ordr=ordr, entr=entr)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def _mesh_fold(inp: FusedInputs, mi, o, d, win):
    """Fold mesh instance mi into the winner list `win` (reference
    `_mesh_instance`): Moller-Trumbore on the local unit ray over every
    chunk, the first minimum inside a chunk and strictly closer across
    chunks against the seed best * nrm, then the merge by world
    distance."""
    col = inp.msc[:, mi]
    iv, tf = col[0:12], col[12:24]
    oi = (iv[0] * o[0] + iv[1] * o[1] + iv[2] * o[2] + iv[3],
          iv[4] * o[0] + iv[5] * o[1] + iv[6] * o[2] + iv[7],
          iv[8] * o[0] + iv[9] * o[1] + iv[10] * o[2] + iv[11])
    dn = (iv[0] * d[0] + iv[1] * d[1] + iv[2] * d[2],
          iv[4] * d[0] + iv[5] * d[1] + iv[6] * d[2],
          iv[8] * d[0] + iv[9] * d[1] + iv[10] * d[2])
    nrm = torch.clamp(torch.sqrt(dn[0] * dn[0] + dn[1] * dn[1]
                                 + dn[2] * dn[2]), min=1e-30)
    di = (dn[0] / nrm, dn[1] / nrm, dn[2] / nrm)
    abest = win[0] * nrm
    found = torch.zeros_like(abest, dtype=torch.bool)
    wtri = torch.zeros_like(abest, dtype=torch.int64)
    oc = [x[:, None] for x in oi]
    dc = [x[:, None] for x in di]
    cstart, nsup, _sstart = inp.meshes[mi]
    for c in range(cstart, cstart + nsup * TRI_SUPER):
        blk = inp.tpool[c]
        a_ = [blk[k][None, :] for k in range(9)]
        e1 = (a_[3] - a_[0], a_[4] - a_[1], a_[5] - a_[2])
        e2 = (a_[6] - a_[0], a_[7] - a_[1], a_[8] - a_[2])
        hx = dc[1] * e2[2] - dc[2] * e2[1]                 # [M, 128]
        hy = dc[2] * e2[0] - dc[0] * e2[2]
        hz = dc[0] * e2[1] - dc[1] * e2[0]
        det = e1[0] * hx + e1[1] * hy + e1[2] * hz
        invd = 1.0 / det
        sx, sy, sz = oc[0] - a_[0], oc[1] - a_[1], oc[2] - a_[2]
        u = (sx * hx + sy * hy + sz * hz) * invd
        qx = sy * e1[2] - sz * e1[1]
        qy = sz * e1[0] - sx * e1[2]
        qz = sx * e1[1] - sy * e1[0]
        vv = (dc[0] * qx + dc[1] * qy + dc[2] * qz) * invd
        a = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * invd
        valid = ((torch.abs(det) >= _EPS) & (u >= 0.0) & (u <= 1.0)
                 & (vv >= 0.0) & (u + vv <= 1.0) & (a > _EPS))
        a = torch.where(valid, a, _FMAX)
        first = a.argmin(dim=1, keepdim=True)
        a_w = a.gather(1, first)[:, 0]
        take = valid.gather(1, first)[:, 0] & (a_w < abest)
        abest = torch.where(take, a_w, abest)
        found = found | take
        wtri = torch.where(take, c * LANES + first[:, 0], wtri)

    # merge the instance's winner by world distance
    att = inp.tpool[wtri // LANES, :, wtri % LANES]          # [M, 18]
    wa = (att[:, 0], att[:, 1], att[:, 2])
    wb = (att[:, 3], att[:, 4], att[:, 5])
    wc = (att[:, 6], att[:, 7], att[:, 8])
    plh = (oi[0] + abest * di[0], oi[1] + abest * di[1],
           oi[2] + abest * di[2])
    pg = (tf[0] * plh[0] + tf[1] * plh[1] + tf[2] * plh[2] + tf[3],
          tf[4] * plh[0] + tf[5] * plh[1] + tf[6] * plh[2] + tf[7],
          tf[8] * plh[0] + tf[9] * plh[1] + tf[10] * plh[2] + tf[11])
    ex, ey, ez = o[0] - pg[0], o[1] - pg[1], o[2] - pg[2]
    wd = torch.sqrt(ex * ex + ey * ey + ez * ez)
    take2 = found & (wd < win[0])

    def cross(p, q):
        return (p[1] * q[2] - p[2] * q[1],
                p[2] * q[0] - p[0] * q[2],
                p[0] * q[1] - p[1] * q[0])

    if inp.flat_face:
        no = cross((wb[0] - wa[0], wb[1] - wa[1], wb[2] - wa[2]),
                   (wc[0] - wa[0], wc[1] - wa[1], wc[2] - wa[2]))
    else:
        na = (att[:, 9], att[:, 10], att[:, 11])
        nb = (att[:, 12], att[:, 13], att[:, 14])
        nc = (att[:, 15], att[:, 16], att[:, 17])
        PA = (wa[0] - plh[0], wa[1] - plh[1], wa[2] - plh[2])
        PB = (wb[0] - plh[0], wb[1] - plh[1], wb[2] - plh[2])
        PC = (wc[0] - plh[0], wc[1] - plh[1], wc[2] - plh[2])

        def clen(p, q):
            cx, cy, cz = cross(p, q)
            return torch.sqrt(cx * cx + cy * cy + cz * cz)

        tA, tB, tC = clen(PB, PC), clen(PA, PC), clen(PA, PB)
        no = tuple(na[k] * tA + nb[k] * tB + nc[k] * tC for k in range(3))
    pn = (plh[0] + no[0], plh[1] + no[1], plh[2] + no[2])
    nmx = tf[0] * pn[0] + tf[1] * pn[1] + tf[2] * pn[2] + tf[3] - pg[0]
    nmy = tf[4] * pn[0] + tf[5] * pn[1] + tf[6] * pn[2] + tf[7] - pg[1]
    nmz = tf[8] * pn[0] + tf[9] * pn[1] + tf[10] * pn[2] + tf[11] - pg[2]
    nl = torch.clamp(torch.sqrt(nmx * nmx + nmy * nmy + nmz * nmz),
                     min=1e-30)
    new = (wd, nmx / nl, nmy / nl, nmz / nl, *pg, *col[24:31])
    for k, x in enumerate(new):
        win[k] = torch.where(take2, x, win[k])


def _ana_hit(fn, iv, tf, o, d):
    """World-space hit of rays o, d against prims with inverse rows iv and
    forward rows tf (12 each), broadcast together (reference
    `_ana_candidates`). Returns (valid, dist, dircode, plv, pg)."""
    oi = (iv[0] * o[0] + iv[1] * o[1] + iv[2] * o[2] + iv[3],
          iv[4] * o[0] + iv[5] * o[1] + iv[6] * o[2] + iv[7],
          iv[8] * o[0] + iv[9] * o[1] + iv[10] * o[2] + iv[11])
    dnx = iv[0] * d[0] + iv[1] * d[1] + iv[2] * d[2]
    dny = iv[4] * d[0] + iv[5] * d[1] + iv[6] * d[2]
    dnz = iv[8] * d[0] + iv[9] * d[1] + iv[10] * d[2]
    rn = 1.0 / torch.clamp(torch.sqrt(dnx * dnx + dny * dny + dnz * dnz),
                           min=1e-30)
    di = (dnx * rn, dny * rn, dnz * rn)
    a, valid, dircode = fn(oi[0], oi[1], oi[2], di[0], di[1], di[2])
    plv = (oi[0] + a * di[0], oi[1] + a * di[1], oi[2] + a * di[2])
    pg = (tf[0] * plv[0] + tf[1] * plv[1] + tf[2] * plv[2] + tf[3],
          tf[4] * plv[0] + tf[5] * plv[1] + tf[6] * plv[2] + tf[7],
          tf[8] * plv[0] + tf[9] * plv[1] + tf[10] * plv[2] + tf[11])
    ex, ey, ez = o[0] - pg[0], o[1] - pg[1], o[2] - pg[2]
    return valid, torch.sqrt(ex * ex + ey * ey + ez * ez), dircode, plv, pg


def _ana_fold(inp: FusedInputs, g, o, d, win):
    """Fold large group g into `win` (reference `_ana_group`): world
    distance over every 128-prim chunk, first minimum inside a chunk and
    strictly closer across chunks, then the merge, which recomputes the
    winner's hit and takes it only where that is valid."""
    code, cstart, nchunks, _sstart = inp.ana_groups[g]
    fn = SOA_FNS[code]
    abest = win[0]
    found = torch.zeros_like(abest, dtype=torch.bool)
    wprim = torch.zeros_like(abest, dtype=torch.int64)
    oc = [x[:, None] for x in o]
    dc = [x[:, None] for x in d]
    for c in range(cstart, cstart + nchunks):
        blk = inp.apool[c]
        valid, dist, _, _, _ = _ana_hit(fn, blk[0:12, None, :].unbind(0),
                                        blk[12:24, None, :].unbind(0), oc, dc)
        dist = torch.where(valid & (blk[31][None, :] > 0.0), dist, _FMAX)
        first = dist.argmin(dim=1, keepdim=True)
        dist_w = dist.gather(1, first)[:, 0]
        take = dist_w < abest
        abest = torch.where(take, dist_w, abest)
        found = found | take
        wprim = torch.where(take, c * LANES + first[:, 0], wprim)

    att = inp.apool[wprim // LANES, :, wprim % LANES]        # [M, 32]
    tf = att[:, 12:24].unbind(1)
    valid, _, dircode, plv, pg = _ana_hit(fn, att[:, 0:12].unbind(1), tf,
                                          o, d)
    nv = _shading_normal(code, tf, plv, pg, dircode)
    take2 = found & valid & (abest < win[0])
    new = (abest, *nv, *pg, *att[:, 24:31].unbind(1))
    for k, x in enumerate(new):
        win[k] = torch.where(take2, x, win[k])


def _to_u32(x):
    """Integer state rows (int32 bits or int64 values) -> int64 values in
    [0, 2**32)."""
    return x.long() & M32


def _from_u32(x, dtype):
    """int64 values in [0, 2**32) -> `dtype` (int32: the same bits)."""
    if dtype == torch.int32:
        x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    return x.to(dtype)


class K2Need:
    """The work the inputs of K2 calls need, counted by
    `fused_call_reference` from each trace's final best, not from any
    walk (so no design of K2 can come in under it). Per trace, for each
    ray whose trace is real (a ray in flight; a refracting ray in the
    re-trace), against its final best world distance `best`:
      - each mesh instance, in its local frame on the unit ray against
        best * |d_local| (K2's own gate): a slab test of every super box,
        a slab test of the real leaf boxes of each super it enters, and
        the real triangles of each leaf it enters (`tri`);
      - each large group, in world space against best: the same two
        levels over its super and chunk boxes, and the real prims of each
        chunk it enters (`prim`, one count per group);
      - `box`, the slab tests of both;
      - one fold of the small table (`traced`), and one hit point and
        normal where it hits (`hits`);
    and one bounce step per ray in flight (`steps`). Counts are int64
    scalars on the state's device. With keep=True, `traces` also keeps
    each trace's (o, d, lanes, best) rows."""

    def __init__(self, inp: FusedInputs, device, keep: bool = False):
        z = torch.zeros((), dtype=torch.int64, device=device)
        self.tri, self.box, self.traced, self.hits, self.steps = (
            z.clone() for _ in range(5))
        self.prim = torch.zeros(len(inp.ana_groups), dtype=torch.int64,
                                device=device)
        self.traces = [] if keep else None
        # real triangles or prims per chunk of the pools
        self._tri_real = (inp.tpool[:, 0:9] != 0).any(dim=1).sum(dim=1)
        self._prim_real = (inp.apool[:, 31] > 0).sum(dim=1)

    def _two_level(self, o, rd, cap, lanes, sbb, cbb, per_chunk):
        """(slab tests, entered leaves' items) of rays o, rd [3, M] over
        supers sbb [6, S] and their TRI_SUPER leaves cbb [6, S*16] with
        per_chunk [S*16] items each; leaves without items are never
        tested."""
        sup = _slab_enters(o[:, :, None], rd[:, :, None], sbb[:, None, :],
                           cap[:, None]) & lanes[:, None]       # [M, S]
        real = per_chunk > 0
        leaf_sup = sup.repeat_interleave(TRI_SUPER, dim=1)[:, real]
        leaf = _slab_enters(o[:, :, None], rd[:, :, None],
                            cbb[:, None, real], cap[:, None]) & leaf_sup
        boxes = lanes.sum() * sbb.shape[1] + leaf_sup.sum()
        return boxes, (leaf.to(torch.int64) * per_chunk[real]).sum()

    def add_trace(self, inp: FusedInputs, o, d, lanes, best):
        if self.traces is not None:
            # copies: o and d may be views of the state rows, which the
            # call overwrites at its end
            self.traces.append((tuple(x.clone() for x in o),
                                tuple(x.clone() for x in d), lanes, best))
        self.traced += lanes.sum()
        self.hits += (lanes & (best < _FMAX)).sum()
        for mi, (cstart, nsup, sstart) in enumerate(inp.meshes):
            col = inp.msc[:, mi]
            oi = torch.stack(apply_affine(col[0:12], o))
            dn = apply_linear(col[0:12], d)
            nrm = torch.clamp(torch.sqrt(dn[0] * dn[0] + dn[1] * dn[1]
                                         + dn[2] * dn[2]), min=1e-30)
            di = torch.stack(dn) / nrm
            nch = nsup * TRI_SUPER
            boxes, tests = self._two_level(
                oi, safe_rcp(di), best * nrm, lanes,
                inp.sbb[:, sstart:sstart + nsup],
                inp.cbb[:, cstart:cstart + nch],
                self._tri_real[cstart:cstart + nch])
            self.box += boxes
            self.tri += tests
        rd = safe_rcp(torch.stack(d))
        for g, (_code, cstart, nchunks, sstart) in enumerate(inp.ana_groups):
            boxes, tests = self._two_level(
                torch.stack(o), rd, best, lanes,
                inp.asbb[:, sstart:sstart + nchunks // TRI_SUPER],
                inp.acbb[:, cstart:cstart + nchunks],
                self._prim_real[cstart:cstart + nchunks])
            self.box += boxes
            self.prim[g] += tests


def fused_call_reference(inp: FusedInputs, stf, sti, whole_path: int,
                         need: Optional[K2Need] = None):
    """Plain PyTorch version of one K2 call (reference `_fused_kernel`,
    bounce_kernel.py:776-896) on any device: one bounce (whole_path = 0)
    or whole_path bounces of the wavefront state stf [15, M], sti [4, M],
    which are updated in place. `need`, if given, gets the work the call's
    inputs need added to it (`K2Need`)."""
    o = (stf[0], stf[1], stf[2])
    d = (stf[3], stf[4], stf[5])
    attenu = (stf[6], stf[7], stf[8])
    total = (stf[9], stf[10], stf[11])
    result = (stf[12], stf[13], stf[14])
    done = sti[0] != 0
    state = (_to_u32(sti[1]), _to_u32(sti[2]), _to_u32(sti[3]))
    ior = torch.tensor(inp.ior, dtype=_F32, device=stf.device)
    ordr_small = None
    if inp.cull:   # each ray's row of the small groups' super order
        ordr_small = inp.ordr[:, 0, inp.sched_base:].long().repeat_interleave(
            TILE, dim=0)

    def trace_fn(o, d, n_prev, p_prev, lanes):
        win = _new_win(o, n_prev, p_prev)
        _fold_table(inp.tab, inp.gsbb, inp.groups, inp.cull, ordr_small,
                    o, d, win)
        for mi in range(len(inp.meshes)):
            _mesh_fold(inp, mi, o, d, win)
        for g in range(len(inp.ana_groups)):
            _ana_fold(inp, g, o, d, win)
        if need is not None:
            need.add_trace(inp, o, d, lanes, win[0])
        return _win_result(win)

    for _ in range(max(1, whole_path)):
        if need is not None:
            need.steps += (~done).sum()
        o, d, attenu, total, result, done, state = _bounce_step(
            trace_fn, inp.has_transparent, ior,
            o, d, attenu, total, result, done, state)
    stf.copy_(torch.stack([*o, *d, *attenu, *total, *result]))
    sti.copy_(torch.stack([_from_u32(done.long(), sti.dtype),
                           *(_from_u32(s, sti.dtype) for s in state)]))


# --------------------------------------------------------------------------
# the kernel wrapper and the route
# --------------------------------------------------------------------------

def _cols(t, rows):
    """The shape a [rows, *] table should have: (rows, its width)."""
    return (rows, t.shape[1] if t.dim() == 2 else -1)


def _check_tensors(kernel: str, dev, want):
    """Raise unless each tensor of want {name: (tensor, dtype, shape)}
    lies on dev with that dtype and shape, contiguous."""
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel} input {name}: {t.device} {t.dtype} "
                f"{tuple(t.shape)}, want {dev} {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} input {name} is not contiguous")


def _state_width(kernel: str, stf) -> int:
    """M of a wavefront state stf [15, M] on a CUDA device; raises unless
    it has that device and M is a positive multiple of TILE."""
    if stf.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {stf.device}")
    m = stf.shape[1] if stf.dim() == 2 else -1
    if m <= 0 or m % TILE:
        raise ValueError(f"{kernel} needs a [15, M] state with M % {TILE} "
                         f"== 0, got {tuple(stf.shape)}")
    return m


def _check_inputs(inp: FusedInputs, stf, sti):
    """Raise unless every tensor K2 reads has the device, dtype, shape
    and layout the kernel assumes."""
    m = _state_width("K2", stf)
    if inp.ordr is None or inp.entr is None:
        raise ValueError("K2 input has no schedule (with_schedule)")
    stot = inp.ordr.shape[2]
    f32, i32 = torch.float32, torch.int32
    want = {"stf": (stf, f32, (SF, m)), "sti": (sti, i32, (SU, m)),
            "tab": (inp.tab, f32, _cols(inp.tab, 38)),
            "gsbb": (inp.gsbb, f32, _cols(inp.gsbb, 6)),
            "group_desc": (inp.group_desc, i32, (len(inp.groups), 4)),
            "msc": (inp.msc, f32, (37, max(1, len(inp.meshes)))),
            "msi": (inp.msi, i32, (4, max(1, len(inp.meshes)))),
            "cbb": (inp.cbb, f32, _cols(inp.cbb, 6)),
            "sbb": (inp.sbb, f32, _cols(inp.sbb, 6)),
            "tpool": (inp.tpool, f32, (inp.tpool.shape[0], 18, LANES)),
            "acbb": (inp.acbb, f32, _cols(inp.acbb, 6)),
            "asbb": (inp.asbb, f32, _cols(inp.asbb, 6)),
            "apool": (inp.apool, f32, (inp.apool.shape[0], 32, LANES)),
            "agr": (inp.agr, f32, (6, max(1, len(inp.ana_groups)))),
            "ana_desc": (inp.ana_desc, i32, (len(inp.ana_groups), 4)),
            "ordr": (inp.ordr, i32, (m // TILE, 1, stot)),
            "entr": (inp.entr, f32, (m // TILE, 1, stot))}
    _check_tensors("K2", stf.device, want)
    if not 0 < inp.tab.shape[1] <= MEGA_MAX_PRIMS:
        raise ValueError(f"K2 prim table width {inp.tab.shape[1]}")


def _n_scan(sti):
    """[1] i32 device scalar: the index of the last live ray + 1 (0 when
    every ray is done). No host sync."""
    m = sti.shape[1]
    idx = torch.arange(1, m + 1, dtype=torch.int32, device=sti.device)
    return torch.where(sti[0] == 0, idx, 0).amax().reshape(1)


def k2_shape(n_scan: int, whole_path: int) -> int:
    """The shape K2 takes by itself (fused_kernel chooses on the device):
    SHAPES[0] lanes per ray in whole-path mode and from MANY_RAYS rays to
    scan, SHAPES[1] below."""
    return SHAPES[0] if whole_path > 0 or n_scan >= MANY_RAYS else SHAPES[1]


def _lib(counts: bool):
    """K2's library (its counting build with `counts`), its shape rule
    checked against SHAPES and MANY_RAYS once per load."""
    lib = kernels.bounce_kernel_lib(counts)
    if not getattr(lib, "shape_rule_checked", False):
        rule = (ctypes.c_int * 3)()
        lib.fused_shape_rule(rule)
        if tuple(rule) != SHAPES + (MANY_RAYS,):
            raise RuntimeError(f"K2's build takes shapes {tuple(rule[:2])} "
                               f"with MANY_RAYS {rule[2]}; bounce_kernel.py "
                               f"mirrors {SHAPES} with {MANY_RAYS}")
        lib.shape_rule_checked = True
    return lib


def k2_launch(inp: FusedInputs, stf, sti, whole_path: int, work=None,
              shape: Optional[int] = None):
    """Launch K2 on the current CUDA stream; it updates stf and sti in
    place. Raises on bad inputs and on a refused launch; counts each
    launch in `k2_launch.launches`, and those of whole-path mode
    (whole_path > 0) also in `k2_launch.whole_path_launches`. `shape`
    forces the lanes per ray (one of SHAPES) or, with None, lets the
    kernel choose from the rays to scan (k2_shape), a device scalar
    computed here with no host sync.
    `work`, an int64 [5] CUDA tensor, if given, gets the launch's
    ray-triangle tests, ray-box tests, large-group ray-prim tests, traces
    and the lane slots its warps spent on chunk folds added to it, from
    K2's counting build (kernels.K2_COUNTS: the same kernel with the
    counters compiled in)."""
    if shape not in (None,) + SHAPES:
        raise ValueError(f"K2 shape {shape!r}: lanes per ray, one of "
                         f"{SHAPES}, or None")
    _check_inputs(inp, stf, sti)
    if whole_path < 0:
        raise ValueError(f"whole_path={whole_path}")
    if work is not None and (work.device != stf.device
                             or work.dtype != torch.int64
                             or tuple(work.shape) != (5,)):
        raise ValueError("K2 work counters: want an int64 [5] tensor on "
                         f"{stf.device}")
    lib = _lib(work is not None)
    n_scan = _n_scan(sti)
    with kernels.on_device(stf.device):
        err = lib.fused_call(
            stf.data_ptr(), sti.data_ptr(), stf.shape[1],
            ctypes.c_float(inp.ior),
            inp.tab.data_ptr(), inp.tab.shape[1],
            inp.gsbb.data_ptr(), inp.gsbb.shape[1],
            inp.group_desc.data_ptr(), len(inp.groups),
            inp.msc.data_ptr(), inp.msi.data_ptr(), len(inp.meshes),
            inp.cbb.data_ptr(), inp.cbb.shape[1],
            inp.sbb.data_ptr(), inp.sbb.shape[1], inp.tpool.data_ptr(),
            inp.acbb.data_ptr(), inp.acbb.shape[1],
            inp.asbb.data_ptr(), inp.asbb.shape[1], inp.apool.data_ptr(),
            inp.agr.data_ptr(), inp.ana_desc.data_ptr(), len(inp.ana_groups),
            inp.ordr.data_ptr(), inp.entr.data_ptr(), inp.ordr.shape[2],
            inp.mesh_stot, inp.sched_base, int(whole_path),
            int(inp.has_transparent), int(inp.flat_face), int(inp.cull),
            n_scan.data_ptr(), shape or 0,
            work.data_ptr() if work is not None else ctypes.c_void_p(0),
            torch.cuda.current_stream(stf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"K2 launch failed: {lib.fused_error_string(err).decode()}")
    kernels.count_launch(k2_launch, stf.device)
    if whole_path:
        k2_launch.whole_path_launches += 1


k2_launch.launches = 0
k2_launch.launches_on = collections.Counter()
k2_launch.whole_path_launches = 0


def _schedule_len(inp: FusedInputs) -> int:
    """Stot: the supers of every mesh instance and large group, and with
    the small table's cull those of every small group."""
    small = (sum(-(-g[2] // MEGA_SUPER) for g in inp.groups) if inp.cull
             else 0)
    return inp.sched_base + small


def k2_schedule_launch(inp: FusedInputs, stf):
    """The nearest-first super schedule of the wavefront state stf [15, M]
    from inp's tables: one launch of csrc/bounce_kernel.cu's
    schedule_kernel, a block a 1024-ray tile, on the current CUDA stream,
    with no sync. Returns (ordr [M/TILE, 1, Stot] i32, entr f32), what
    `_schedules` gives, entry bounds to an ulp (the 3x3 products may sum
    in another order) and orders equal but for near-ties; [.., 1] of 0 and
    INF when there is no segment. Raises on bad inputs and on a refused
    launch; counts each launch in `k2_schedule_launch.launches` and by
    card, apart from `k2_launch`'s (`launches_per_pass` counts K1's and
    K2's launches alone)."""
    m = _state_width("K2's schedule", stf)
    dev = stf.device
    f32, i32 = torch.float32, torch.int32
    n_mesh = max(1, len(inp.meshes))
    _check_tensors("K2's schedule", dev, {
        "stf": (stf, f32, (SF, m)),
        "msc": (inp.msc, f32, (37, n_mesh)),
        "msi": (inp.msi, i32, (4, n_mesh)),
        "sbb": (inp.sbb, f32, _cols(inp.sbb, 6)),
        "ana_desc": (inp.ana_desc, i32, (len(inp.ana_groups), 4)),
        "asbb": (inp.asbb, f32, _cols(inp.asbb, 6)),
        "group_desc": (inp.group_desc, i32, (len(inp.groups), 4)),
        "gsbb": (inp.gsbb, f32, _cols(inp.gsbb, 6))})
    stot = _schedule_len(inp)
    shape = (m // TILE, 1, max(stot, 1))
    ordr = torch.empty(shape, dtype=i32, device=dev)
    entr = torch.empty(shape, dtype=f32, device=dev)
    scratch = torch.empty(shape, dtype=f32, device=dev)
    lib = _lib(False)
    with kernels.on_device(dev):
        err = lib.fused_schedule(
            stf.data_ptr(), m, inp.msc.data_ptr(), inp.msi.data_ptr(),
            len(inp.meshes), inp.sbb.data_ptr(), inp.sbb.shape[1],
            inp.ana_desc.data_ptr(), len(inp.ana_groups),
            inp.asbb.data_ptr(), inp.asbb.shape[1],
            inp.group_desc.data_ptr(), len(inp.groups),
            inp.gsbb.data_ptr(), inp.gsbb.shape[1], int(inp.cull),
            inp.mesh_stot, inp.sched_base, stot, ordr.data_ptr(),
            entr.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2's schedule launch failed: "
                           f"{lib.fused_error_string(err).decode()}")
    kernels.count_launch(k2_schedule_launch, dev)
    return ordr, entr


k2_schedule_launch.launches = 0
k2_schedule_launch.launches_on = collections.Counter()


def fused_call(inp: FusedInputs, stf, sti, whole_path: int):
    """One K2 call: the plain version on the CPU, K2 on a CUDA device."""
    if stf.device.type == "cpu":
        fused_call_reference(inp, stf, sti, whole_path)
    else:
        k2_launch(inp, stf, sti, whole_path)


def _fused_scene_tensors(scene):
    """The scene tensors that `fused_inputs` and `_schedules` read."""
    return (*_scene_tensors(scene), scene.inv_transfo, scene.mesh_transfo,
            *scene.mesh_chunk_bb, *scene.mesh_super_bb, scene.tri_chunks,
            scene.ana_chunks, scene.ana_chunk_bb, scene.ana_super_bb)


def _wavefront(O, D, screen_tc):
    """A tile call's wavefront before its pass: (stf [15, M] at the
    camera; sti [4, M]: not done, the seed words bits(u) and bits(v) of
    rng.srand_soa, and 0 where `_set_pass` writes the pass's word; the
    lanes' order; n)."""
    dev = D.device
    n = D.shape[0]
    m = -(-n // TILE) * TILE
    dn = D / torch.linalg.vector_norm(D, dim=-1, keepdim=True)
    z = torch.zeros((m,), dtype=_F32, device=dev)
    dx, dy, dz = z.clone(), z.clone(), z + 1.0
    u, v = z.clone(), z.clone()
    dx[:n], dy[:n], dz[:n] = dn[:, 0], dn[:, 1], dn[:, 2]
    u[:n], v[:n] = screen_tc[:, 0], screen_tc[:, 1]
    o3 = torch.as_tensor(O, dtype=_F32, device=dev).reshape(3)
    stf = torch.stack([z + o3[0], z + o3[1], z + o3[2], dx, dy, dz,
                       z + 0.8, z + 0.8, z + 0.8,   # attenu (:106-107)
                       z, z, z, z, z, z])
    int_t = torch.int64 if dev.type == "cpu" else torch.int32
    bu = _from_u32(_rng.float_bits(u), int_t)
    zi = torch.zeros_like(bu)
    sti = torch.stack([zi, bu, zi, _from_u32(_rng.float_bits(v), int_t)])
    return stf, sti, torch.arange(m, device=dev), n


def _set_pass(sti, pass_index, date):
    """Write the pass's seed word (rng.seed_y, in sti's dtype) into sti."""
    y = _rng.seed_y(pass_index, date)
    if sti.dtype == torch.int32 and y >= 2 ** 31:
        y -= 2 ** 32
    sti[2].fill_(y)


def _whole_path_inputs(scene, O, D, screen_tc, refract_ind, bounces):
    """(`_wavefront`'s stf, sti, lanes and n, the inputs with their
    schedule): what a whole-path tile call needs besides its pass."""
    with span("k2.wavefront"):
        stf, sti, lane, n = _wavefront(O, D, screen_tc)
    inp = fused_inputs(scene, refract_ind)
    with span("k2.schedule", whole_path=bounces):
        inp = with_schedule(inp, scene, stf)
    return stf, sti, lane, n, inp


def raytrace_fused(scene, O, D, screen_tc, pass_index: int, *,
                   nb_bounces: int, refract_ind, date=0.0,
                   sort_rays: bool = True, whole_path: bool | None = None,
                   call=None, mega_memo=None):
    """Fused per-bounce route of models.montecarlo.raytrace, for mesh and
    large analytic scenes. O: [3] camera origin, D: [N,3] ray directions
    (normalized here), screen_tc: [N,2]. Returns rgb [N,3]. The RNG
    schedule is bit-identical to the reference's; float results match to
    a few ulp, winners up to exact distance ties. `call` runs one K2 call
    (default `fused_call`; the parity checks pass `fused_call_reference`
    to run the plain version on the card). mega_memo (a
    megakernel.MegaMemo), if given, keeps a whole-path call's tables,
    schedule and wavefront (all but the pass's seed word) across calls
    (the `k2.inputs` span covers the lookup or build, with attr
    `built`); the wavefront mode builds every call."""
    call = fused_call if call is None else call
    dev = D.device
    if whole_path is None:
        # mesh scenes want the inter-bounce re-sort; large analytic scenes
        # keep the whole path in one launch
        whole_path = not scene.mesh_prim_index
    bounces = int(nb_bounces) if whole_path else 0
    if bounces > 0:
        def build():
            return _whole_path_inputs(scene, O, D, screen_tc, refract_ind,
                                      bounces)

        with span("k2.inputs") as sp:
            if mega_memo is None:
                (stf, sti, lane, n, inp), built = build(), True
            else:
                (stf, sti, lane, n, inp), built = mega_memo.whole_path(
                    scene, O, D, screen_tc, refract_ind,
                    _fused_scene_tensors(scene), build)
            sp.set(built=built)
        with span("k2.wavefront"):
            # K2 updates the wavefront in place: a kept one stays
            stf, sti = stf.clone(), sti.clone()
            _set_pass(sti, pass_index, date)
    else:
        with span("k2.wavefront"):
            stf, sti, lane, n = _wavefront(O, D, screen_tc)
            _set_pass(sti, pass_index, date)
        with span("k2.inputs"):
            inp = fused_inputs(scene, refract_ind)

    if bounces > 0:
        with span("k2.launch", whole_path=bounces, device=dev):
            call(inp, stf, sti, bounces)
    elif not whole_path:
        sort_lo = scene.prim_bb_min.amin(dim=0)
        sort_hi = scene.prim_bb_max.amax(dim=0)
        park = kernels.host_tensor([0.0, 0.0, PARK_Z, 0.0, 0.0, 1.0], _F32,
                                   dev)[:, None]
        for i in range(nb_bounces):
            with span("k2.sort", bounce=i):
                done = sti[0] != 0
                # park finished lanes outside every box, pointing away
                stf[0:6] = torch.where(done[None, :], park, stf[0:6])
                # primaries arrive pixel-coherent from the renderer's 32x32
                # blocks, so the re-sort starts at bounce 1
                if sort_rays and i >= 1:
                    key = ray_sort_key((stf[0], stf[1], stf[2]),
                                       (stf[3], stf[4], stf[5]), done,
                                       sort_lo, sort_hi)
                    perm = torch.argsort(key, stable=True)
                    stf, sti, lane = stf[:, perm], sti[:, perm], lane[perm]
            with span("k2.schedule", bounce=i):
                inp_i = with_schedule(inp, scene, stf)
            # the launch on the card, K2's plain version on the CPU
            with span("k2.launch", bounce=i, device=dev):
                call(inp_i, stf, sti, 0)
    with span("k2.gather"):
        # bounce-cap exhaustion returns black (:178)
        done = sti[0] != 0
        out = torch.zeros((3, stf.shape[1]), dtype=_F32, device=dev)
        out[:, lane] = torch.where(done[None, :], stf[12:15], 0.0)
        return out.T[:n]
