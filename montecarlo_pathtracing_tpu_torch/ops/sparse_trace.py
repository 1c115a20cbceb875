"""Occlusion-pruned trace kernels: the nearest-first walks K5 and K6.

Port of the host side of montecarlo_pathtracing_tpu/ops/sparse_trace.py,
the twins of the brute folds of ops/pallas_trace.py:

  - `group_best_rows_sparse` (K5, the TPU kernel `_an_kernel` :139):
    world rays against one analytic group in SUP = 8-prim blocks;
  - `mesh_best_rows_sparse` (K6, `_mesh_kernel` :374): mesh-local rays
    against one mesh instance in 128-triangle chunks.

The host computes, as torch ops (they were XLA ops outside the TPU
kernels): each ray tile's bundle and its conservative entry distance
`tlo` into every block's or chunk's box, with the float32 margins of the
reference (sparse_trace.py:282-283, :498-499); each ray's exit `bound`
from the root box, the union of the real boxes (:288-298, :506-518), so
that rays missing the whole group stop holding the prune open; and the
ranked schedule, each tile's blocks sorted by `tlo` (`_ranked_schedule`,
a stable sort as the reference's lax.sort).

The walk: per tile, blocks in ranked order, front to back; a block is
folded only while its `tlo` is below max over the tile's rays of min(best,
bound), and the walk ends at the first block that is not (the list is
sorted and the prune only tightens). Inside a block, prims or triangles
fold in ascending order under the strictly-closer rule. Skipped blocks
cannot hold a strictly closer hit, so winners are the brute fold's, up
to exact distance ties between blocks (the ranked order may then pick
another, equally close winner; tests/test_sparse_trace.py:27-54).

The reference runs that walk as repeated Pallas calls over a compacted
worklist under a budget (`_budget_worklist`, the lax.while_loop
refinement of :93-136, :313-348, :523-551), carrying the best in and out
between calls; the budget exists to bound the TPU's scalar-prefetch
SMEM. Here one kernel launch walks every tile's whole ranked list
(csrc/trace_kernels.cu), so none of that has a counterpart and nothing
reads a count back to the host between launches.

Each wrapper runs its plain version (`*_plain`: the same ranked walk,
vectorised over tiles, with the tile-wide prune of the reference) on CPU
tensors and its kernel on CUDA tensors, counting launches in
`.launches`; it raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .intersect import FLT_MAX
from .pallas_trace import (
    PRIM_CHUNK, check_tensors, check_work, mt_chunk, raise_on_error,
    _first_min)
from .shapes import SOA_FNS
from .vec import safe_rcp
from .worklist import INF, bundle_box_entry, tile_bundles

SUP = 8             # prims per analytic block
AN_TILE = 1024      # rays per analytic tile
MESH_TILE = 128     # rays per mesh tile

_FMAX = float(FLT_MAX)
_F32 = torch.float32
_I32 = torch.int32
# the float32 margins of the reference: entry bounds shrink, exit bounds
# grow, so round-to-nearest in the bounds never prunes a real hit
_TLO_SCALE = float(np.float32(1.0 - 1e-4))
_TLO_MARGIN = float(np.float32(1e-4))
_BOUND_SCALE = float(np.float32(1.0001))
_BOUND_MARGIN = float(np.float32(1e-4))


def _ranked_schedule(tlo_all):
    """Each tile's blocks nearest-first: tlo_all [nt, S] conservative
    entry distances (INF = unreachable). Returns (order_in_tile [nt, S]
    i32 block ids by ascending entry, tlo_sorted [nt, S]); the sort is
    stable, as the reference's."""
    tlo_sorted, order = torch.sort(tlo_all, dim=1, stable=True)
    return order.to(_I32), tlo_sorted


def _entry(o, d, boxes, tile):
    """[nt, S] entry bounds of each tile's bundle into each box, with the
    downward margin (INF stays INF)."""
    tlo = bundle_box_entry(tile_bundles(o, d, tile), boxes)
    return torch.where(tlo >= INF, INF, tlo * _TLO_SCALE - _TLO_MARGIN)


def _root_bound(o, d, root_lo, root_hi):
    """[M] per-ray exit from the root box [root_lo, root_hi] (each [3])
    with the upward margin, 0 where the ray misses the box."""
    rd = safe_rcp(d)
    t0b = (root_lo[:, None] - o) * rd
    t1b = (root_hi[:, None] - o) * rd
    tent = torch.clamp(torch.minimum(t0b, t1b).amax(dim=0), min=0.0)
    texi = torch.maximum(t0b, t1b).amin(dim=0)
    return torch.where(texi >= tent, texi * _BOUND_SCALE + _BOUND_MARGIN,
                       0.0)


# --------------------------------------------------------------------------
# K5: analytic groups over 8-prim blocks
# --------------------------------------------------------------------------

def an_inputs(o, d, inv_r, trf_r, pid, sup_bb):
    """The host side of K5: (tab [nblk, 25, SUP] block table: inverse
    rows, forward rows, ok flag; order [nt, S] i32; tlo_sorted [nt, S];
    bound [M])."""
    tlo_all = _entry(o, d, sup_bb, AN_TILE)
    real = torch.all(sup_bb[0:3] <= sup_bb[3:6], dim=0)[None, :]
    root_lo = torch.where(real, sup_bb[0:3], INF).amin(dim=1)
    root_hi = torch.where(real, sup_bb[3:6], -INF).amax(dim=1)
    bound = _root_bound(o, d, root_lo, root_hi)
    tab = torch.cat([inv_r, trf_r, (pid >= 0).to(_F32)], dim=0)
    tab = tab.reshape(25, tab.shape[1] // SUP, SUP).permute(1, 0, 2)
    order, tlo_sorted = _ranked_schedule(tlo_all)
    return tab.contiguous(), order, tlo_sorted, bound


def an_fold_plain(o, d, tab, order, tlo_sorted, bound, shape_code):
    """Plain PyTorch version of K5: the ranked walk of every tile at once
    (step k visits each tile's k-th block), with the reference's
    tile-wide prune. Returns (dist, row, a, dircode), each [M]."""
    fn = SOA_FNS[shape_code]
    nt, s = order.shape
    shp = (nt, AN_TILE)
    o3 = tuple(o[c].reshape(shp) for c in range(3))
    d3 = tuple(d[c].reshape(shp) for c in range(3))
    bnd = bound.reshape(shp)
    dist = torch.full(shp, _FMAX, dtype=_F32, device=o.device)
    row = torch.full(shp, -1, dtype=_I32, device=o.device)
    a_best = torch.zeros(shp, dtype=_F32, device=o.device)
    dir_best = torch.full(shp, -1, dtype=_I32, device=o.device)
    for k in range(s):
        tlo = tlo_sorted[:, k]
        act = (tlo < INF) & (tlo < torch.minimum(dist, bnd).amax(dim=1))
        if not bool(act.any()):
            break                       # every tile's walk has ended
        bid = order[:, k].long()
        blk = tab[bid]                                   # [nt, 25, SUP]
        for j in range(SUP):
            iv = [blk[:, r, j][:, None] for r in range(12)]   # [nt, 1]
            tf = [blk[:, 12 + r, j][:, None] for r in range(12)]
            ok = act[:, None] & (blk[:, 24, j][:, None] > 0.0)
            oi = (iv[0] * o3[0] + iv[1] * o3[1] + iv[2] * o3[2] + iv[3],
                  iv[4] * o3[0] + iv[5] * o3[1] + iv[6] * o3[2] + iv[7],
                  iv[8] * o3[0] + iv[9] * o3[1] + iv[10] * o3[2] + iv[11])
            tdx = iv[0] * d3[0] + iv[1] * d3[1] + iv[2] * d3[2]
            tdy = iv[4] * d3[0] + iv[5] * d3[1] + iv[6] * d3[2]
            tdz = iv[8] * d3[0] + iv[9] * d3[1] + iv[10] * d3[2]
            nrm = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy + tdz * tdz),
                              min=1e-30)
            di = (tdx / nrm, tdy / nrm, tdz / nrm)
            a, valid, dircode = fn(oi[0], oi[1], oi[2], di[0], di[1], di[2])
            plx = oi[0] + a * di[0]
            ply = oi[1] + a * di[1]
            plz = oi[2] + a * di[2]
            pgx = tf[0] * plx + tf[1] * ply + tf[2] * plz + tf[3]
            pgy = tf[4] * plx + tf[5] * ply + tf[6] * plz + tf[7]
            pgz = tf[8] * plx + tf[9] * ply + tf[10] * plz + tf[11]
            ex, ey, ez = o3[0] - pgx, o3[1] - pgy, o3[2] - pgz
            dj = torch.where(valid, torch.sqrt(ex * ex + ey * ey + ez * ez),
                             _FMAX)
            # the ok flag gates the take before the compare; NaNs of the
            # padding columns never land
            take = ok & (dj < dist)
            dist = torch.where(take, dj, dist)
            row = torch.where(take, (bid * SUP + j).to(_I32)[:, None], row)
            a_best = torch.where(take, a, a_best)
            dir_best = torch.where(take, dircode, dir_best)
    m = nt * AN_TILE
    return (dist.reshape(m), row.reshape(m), a_best.reshape(m),
            dir_best.reshape(m))


def group_best_rows_sparse(o, d, shape_code, inv_r, trf_r, pid, sup_bb,
                           work=None):
    """K5: o, d [3, M] world ray rows (M a multiple of AN_TILE, unit
    directions: the slab parameter is world distance), the padded tables
    of `_pad_group`, sup_bb [6, ppad / SUP] world boxes of the SUP-prim
    Morton windows. Returns (dist, row, a, dircode), each [M], as
    `group_best_rows`. `work`, an int64 [3] CUDA tensor, gets the
    launch's ray-prim tests, blocks visited and tests whose shape test
    passed added to it."""
    m, ppad = o.shape[1], inv_r.shape[1]
    if m % AN_TILE or ppad % PRIM_CHUNK or sup_bb.shape[1] * SUP != ppad:
        raise ValueError(f"K5: M={m}, ppad={ppad}, boxes "
                         f"{tuple(sup_bb.shape)}")
    tab, order, tlo_sorted, bound = an_inputs(o, d, inv_r, trf_r, pid, sup_bb)
    if o.device.type == "cpu":
        return an_fold_plain(o, d, tab, order, tlo_sorted, bound, shape_code)
    return an_fold(o, d, tab, order, tlo_sorted, bound, shape_code, sup_bb,
                   work=work)


def an_fold(o, d, tab, order, tlo_sorted, bound, shape_code, sup_bb,
            work=None, per_ray=False):
    """Launch K5 on the inputs of `an_inputs` and the blocks' boxes
    sup_bb [6, nblk]. For spheres, cubes and cylinders each warp walks on
    its own and tests each block's box per ray (exact: their hits lie in
    front of the ray's origin); for cones and quads a 1024-ray tile walks
    as one, every ray testing every block the tile-wide prune admits, as
    the plain version does. `per_ray` forces the per-ray gate on cones and
    quads too, which may miss a hit behind the origin (chip_smoke.py
    prints how many rows it differs on)."""
    dev = o.device
    m = o.shape[1]
    nt, s = order.shape
    nblk = tab.shape[0]
    if shape_code not in SOA_FNS or nt * AN_TILE != m:
        raise ValueError(f"K5: shape {shape_code}, {nt} tiles for M={m}")
    check_tensors("K5", dev, {
        "o": (o, _F32, (3, m)), "d": (d, _F32, (3, m)),
        "tab": (tab, _F32, (nblk, 25, SUP)), "order": (order, _I32, (nt, s)),
        "tlo_sorted": (tlo_sorted, _F32, (nt, s)),
        "bound": (bound, _F32, (m,)), "sup_bb": (sup_bb, _F32, (6, nblk))})
    counts = check_work("K5", work, dev)
    dist = torch.empty((m,), dtype=_F32, device=dev)
    row = torch.empty((m,), dtype=_I32, device=dev)
    a = torch.empty((m,), dtype=_F32, device=dev)
    dircode = torch.empty((m,), dtype=_I32, device=dev)
    lib = kernels.trace_kernels_lib()
    with kernels.on_device(dev):
        err = lib.an_fold(
            o.data_ptr(), d.data_ptr(), m, tab.data_ptr(), sup_bb.data_ptr(),
            nblk, order.data_ptr(), tlo_sorted.data_ptr(), s, bound.data_ptr(),
            int(shape_code), dist.data_ptr(), row.data_ptr(), a.data_ptr(),
            dircode.data_ptr(), counts, int(per_ray),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K5", lib, err)
    group_best_rows_sparse.launches += 1
    return dist, row, a, dircode


group_best_rows_sparse.launches = 0


# --------------------------------------------------------------------------
# K6: mesh instances over 128-triangle chunks
# --------------------------------------------------------------------------

def mesh_inputs(o, d, tri, cbb):
    """The host side of K6: (order [nt, S] i32, tlo_sorted [nt, S], bound
    [M]) over the instance's nchunks = ppad / 128 chunk boxes (cbb is
    padded to a super multiple: only its first nchunks columns count)."""
    nchunks = tri.shape[1] // PRIM_CHUNK
    boxes = cbb[:, :nchunks]
    tlo = _entry(o, d, boxes, MESH_TILE)
    real = (boxes[0] <= boxes[3])[None, :]
    root_lo = torch.where(real, boxes[0:3], INF).amin(dim=1)
    root_hi = torch.where(real, boxes[3:6], -INF).amax(dim=1)
    bound = _root_bound(o, d, root_lo, root_hi)
    order, tlo_sorted = _ranked_schedule(tlo)
    return order, tlo_sorted, bound


def mesh_fold_plain(o, d, tri, order, tlo_sorted, bound):
    """Plain PyTorch version of K6: the ranked walk of every tile at once
    with the reference's tile-wide prune, [nt, 128 rays, 128 triangles]
    per step. Returns (a, row), each [M]."""
    nt, s = order.shape
    shp = (nt, MESH_TILE)
    oc = tuple(o[c].reshape(shp)[:, :, None] for c in range(3))
    dc = tuple(d[c].reshape(shp)[:, :, None] for c in range(3))
    bnd = bound.reshape(shp)
    a_best = torch.full(shp, _FMAX, dtype=_F32, device=o.device)
    row = torch.full(shp, -1, dtype=_I32, device=o.device)
    chunks = tri.reshape(9, -1, PRIM_CHUNK)                 # [9, C, 128]
    for k in range(s):
        tlo = tlo_sorted[:, k]
        act = (tlo < INF) & (tlo < torch.minimum(a_best, bnd).amax(dim=1))
        if not bool(act.any()):
            break                       # every tile's walk has ended
        bid = order[:, k].long()
        v = [chunks[r][bid][:, None, :] for r in range(9)]  # [nt, 1, 128]
        a = mt_chunk(oc, dc, v)                             # [nt, 128, 128]
        cmin, first = _first_min(a.reshape(nt * MESH_TILE, PRIM_CHUNK))
        cmin, first = cmin.reshape(shp), first.reshape(shp)
        take = act[:, None] & (cmin < a_best)
        a_best = torch.where(take, cmin, a_best)
        row = torch.where(take, (first + bid[:, None] * PRIM_CHUNK).to(_I32),
                          row)
    m = nt * MESH_TILE
    return a_best.reshape(m), row.reshape(m)


def mesh_best_rows_sparse(o, d, tri, cbb, work=None):
    """K6: o, d [3, M] mesh-local unit ray rows (M a multiple of
    MESH_TILE), tri [9, ppad], cbb [6, >= ppad / 128] mesh-local chunk
    boxes. Returns (a, row), each [M], as `mesh_best_rows`. `work` as for
    `group_best_rows_sparse` (ray-triangle tests, chunks visited by the
    kernel's blocks, triangles hit)."""
    m, ppad = o.shape[1], tri.shape[1]
    if m % MESH_TILE or ppad % PRIM_CHUNK or cbb.shape[1] * PRIM_CHUNK < ppad:
        raise ValueError(f"K6: M={m}, ppad={ppad}, boxes {tuple(cbb.shape)}")
    order, tlo_sorted, bound = mesh_inputs(o, d, tri, cbb)
    if o.device.type == "cpu":
        return mesh_fold_plain(o, d, tri, order, tlo_sorted, bound)
    return mesh_fold(o, d, tri, order, tlo_sorted, bound, work=work)


def mesh_fold(o, d, tri, order, tlo_sorted, bound, work=None):
    """Launch K6 on the inputs of `mesh_inputs`."""
    dev = o.device
    m, ppad = o.shape[1], tri.shape[1]
    nt, s = order.shape
    if nt * MESH_TILE != m or s * PRIM_CHUNK != ppad:
        raise ValueError(f"K6: {nt} tiles x {s} chunks for M={m}, "
                         f"ppad={ppad}")
    check_tensors("K6", dev, {
        "o": (o, _F32, (3, m)), "d": (d, _F32, (3, m)),
        "tri": (tri, _F32, (9, ppad)), "order": (order, _I32, (nt, s)),
        "tlo_sorted": (tlo_sorted, _F32, (nt, s)),
        "bound": (bound, _F32, (m,))})
    counts = check_work("K6", work, dev)
    a = torch.empty((m,), dtype=_F32, device=dev)
    row = torch.empty((m,), dtype=_I32, device=dev)
    lib = kernels.trace_kernels_lib()
    with kernels.on_device(dev):
        err = lib.mesh_fold(
            o.data_ptr(), d.data_ptr(), m, tri.data_ptr(), ppad,
            order.data_ptr(), tlo_sorted.data_ptr(), s, bound.data_ptr(),
            a.data_ptr(), row.data_ptr(), counts,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K6", lib, err)
    mesh_best_rows_sparse.launches += 1
    return a, row


mesh_best_rows_sparse.launches = 0
