"""The order of the culled group fold K3b (group_culled_kernel) and the
mesh walk K6 (mesh_walk) in csrc/trace_kernels.cu, mirrored in plain
PyTorch and held against their plain versions
(`group_best_rows_culled_plain`, `mesh_fold_plain`) and against the JAX
package's Pallas kernels in interpret mode.

The mirrors below do what the kernels do, in their order, with the
kernels' lanes a ray (read from the source):
- K6: a 128-ray tile's ranked chunks walked by each block of 128 / L rays
  of the tile with the prune over its own rays; each chunk staged as K4a
  stages it (the corner A and the edges B - A and C - A, cut at its last
  nonzero triangle) with its box (the bounds of its real triangles); a
  warp folds the chunk only where one of its rays enters that box within
  min(best, bound), less the entry bounds' margin; lane j of a ray folds
  triangles j, j + L, ... with the strict `<` behind the warp-wide gate on
  u; the ray's L lanes reduce (a, index) to its lexicographic minimum by a
  butterfly of shuffles; the result merges into the ray's best under the
  strictly-closer rule.
- K3b (spheres, cubes, cylinders: group_culled_kernel): each ray tests
  the boxes of supers g .. g + L - 1 (16 chunks each, the exact union of
  their boxes) once, one a lane (its entry te, +inf where it misses), and
  takes the ones with te <= its best, ascending; in each it tests the
  super's chunk boxes L at a time and walks the chunks it enters so, each
  gate reading the best its walk has reached; lane j folds prims j,
  j + L, ... of an entered chunk with K3a's masked shape tests behind the
  warp-wide gate on a hit, a prim with scene id < 0 or a lane whose ray
  walks nothing now testing an identity frame it drops; the lanes reduce
  (dist, row, a, dircode) to the lexicographic minimum on (dist, row);
  the result merges under the strictly-closer rule.
- K3b (cones and quads, whose tests take hits behind the ray's origin:
  group_tile_kernel): a 1024-ray tile enters a chunk where some ray of it
  enters the box within its best, and every ray of the tile folds the
  chunk as K3a does (brute.group_fold_mirror).
The walk lengths chip_smoke.py prints (`_k6_walks`, `_k3b_walks`) are
held against the mirrors' own counts.

Inputs come from numpy with fixed seeds, with exact ties (duplicated
triangles and prims, in one chunk across lanes and across chunks), scene
ids < 0, degenerate padding triangles and rays that hit nothing.
Tolerances: against the plain versions every output bit for bit (the
kernels are held to the same on the card by chip_smoke.py); against JAX
the trace protocol of testing/parity.py with distances within JAX_RTOL =
5e-4 relative, the reference's own tolerance between its folds
(tests/test_pallas_trace.py:72), since XLA rounds the same float32
formulas differently.
"""
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import pallas_trace as jpt
from montecarlo_pathtracing_tpu.ops import sparse_trace as jsp
from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as pt
from montecarlo_pathtracing_tpu_torch.ops import sparse_trace as sp
from montecarlo_pathtracing_tpu_torch.ops.shapes import SOA_FNS
from montecarlo_pathtracing_tpu_torch.ops.vec import safe_rcp
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_trace_protocol, group_chunk_boxes, random_group, random_rays)
from montecarlo_pathtracing_tpu_torch.utils import transforms

import chip_smoke
import test_torch_brute_trace as brute

M = 2 * pt.RAY_TILE
CHUNK = pt.PRIM_CHUNK
TILE = sp.MESH_TILE
WARP = 32
JAX_RTOL = 5e-4
EPS = pt._EPS
FMAX = pt._FMAX
INF = float("inf")
TLO_SCALE = torch.tensor(1.0 - 1e-4, dtype=torch.float32)   # the .cu's
TLO_MARGIN = torch.tensor(1e-4, dtype=torch.float32)
CODES = [1, 2, 3, 4, 5]   # sphere, cube, cylinder, cone, oriented quad
BEHIND = (4, 5)           # cones and quads take hits behind the origin
GROUP_SUPER = pt.GROUP_SUPER


def _lanes(name):
    """A lanes-a-ray constant of csrc/trace_kernels.cu."""
    with open(os.path.join(kernels.CSRC, "trace_kernels.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read())[1])


WALK_LANES = _lanes("WALK_LANES")
CULL_LANES = _lanes("CULL_LANES")
TRI_LANES = _lanes("TRI_LANES")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _warp_any(flag):
    """flag [M, L] (ray i's lane j on thread i * L + j) -> whether some
    thread of the same warp has it, per thread."""
    m, lanes = flag.shape
    return flag.reshape(-1, WARP).any(dim=1, keepdim=True).expand(
        -1, WARP).reshape(m, lanes)


def _butterfly(key, row, *payload):
    """The kernels' lane_min: (key, row) [M, L] and payload reduced over
    each ray's L lanes by xor shuffles, L / 2 first, to the lexicographic
    minimum on (key, row); every lane gets it. Returns lane 0's values."""
    lanes = key.shape[1]
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:
        k2, r2 = key[:, idx ^ off], row[:, idx ^ off]
        take = (k2 < key) | ((k2 == key) & (r2 < row))
        key, row = torch.where(take, k2, key), torch.where(take, r2, row)
        payload = [torch.where(take, p[:, idx ^ off], p) for p in payload]
        off //= 2
    return (key[:, 0], row[:, 0], *(p[:, 0] for p in payload))


def _entry(o, rd, box):
    """Each ray's entry into its box (common.cuh slab_interval, fminf and
    fmaxf), clamped at 0, +inf where it misses: o, rd [3, M, 1] and box
    [6, M, K] -> [M, K]."""
    t0 = [(box[k] - o[k]) * rd[k] for k in range(3)]
    t1 = [(box[3 + k] - o[k]) * rd[k] for k in range(3)]
    tmin = torch.fmax(torch.fmax(torch.fmin(t0[0], t1[0]),
                                 torch.fmin(t0[1], t1[1])),
                      torch.fmin(t0[2], t1[2]))
    tmax = torch.fmin(torch.fmin(torch.fmax(t0[0], t1[0]),
                                 torch.fmax(t0[1], t1[1])),
                      torch.fmax(t0[2], t1[2]))
    tmin = torch.fmax(tmin, torch.zeros(()))
    return torch.where(tmax >= tmin, tmin, INF)


# --------------------------------------------------------------------------
# K6
# --------------------------------------------------------------------------

def mesh_walk_mirror(o, d, tri, order, tlo_sorted, bound, stats=None):
    """K6's walk: (a, row) per ray. `stats`, a dict, gets the chunks each
    block walked ([blocks]), the (warp, chunk) folds the box gate skipped
    and the (warp, step) folds the gate on u skipped."""
    lanes = WALK_LANES
    A, E1, E2, ends = brute.stage_tris(tri)
    boxes = chip_smoke._tri_chunk_boxes(tri, (tri != 0).any(dim=0))
    rd = safe_rcp(d)[:, :, None]
    m = o.shape[1]
    rays = TILE // lanes                  # rays a block
    nb = m // rays
    tile = torch.arange(nb) // lanes      # each block's tile
    lane = torch.arange(lanes)
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    abest = torch.full((m,), FMAX, dtype=torch.float32)
    best = torch.full((m,), -1, dtype=torch.int64)
    on = torch.ones((nb,), dtype=torch.bool)
    walks = torch.zeros((nb,), dtype=torch.int64)
    skipped = boxed = 0
    for k in range(order.shape[1]):
        e = tlo_sorted[tile, k]
        cap = torch.minimum(abest, bound).reshape(nb, rays)
        on &= (e < sp.INF) & (e[:, None] < cap).any(dim=1)
        if not on.any():
            break
        walks += on
        c = order[tile, k].long().repeat_interleave(rays)         # [M]
        te = _entry(o[:, :, None], rd, boxes[:, c, None])[:, 0]
        enter = te * TLO_SCALE - TLO_MARGIN < torch.minimum(abest, bound)
        warp = enter.reshape(-1, WARP // lanes).any(dim=1).repeat_interleave(
            WARP // lanes)
        ray_on = (on.repeat_interleave(rays) & warp)[:, None]      # [M, 1]
        boxed += int((on.repeat_interleave(rays) & ~warp).sum()) * lanes \
            // WARP
        end = ends[c][:, None]
        ca = torch.full((m, lanes), FMAX, dtype=torch.float32)
        ct = torch.full((m, lanes), CHUNK, dtype=torch.int64)
        for i in range(CHUNK // lanes):
            t = lane[None, :] + i * lanes                          # [1, L]
            col = c[:, None] * CHUNK + t                           # [M, L]
            ax, ay, az = A[:, col]
            e1x, e1y, e1z = E1[:, col]
            e2x, e2y, e2z = E2[:, col]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            det = e1x * hx + e1y * hy + e1z * hz
            ok = torch.abs(det) >= EPS
            invd = 1.0 / torch.where(ok, det, 1.0)
            sx, sy, sz = ox - ax, oy - ay, oz - az
            u = (sx * hx + sy * hy + sz * hz) * invd
            pas = ray_on & (t < end) & ok & (u >= 0.0) & (u <= 1.0)
            gate = _warp_any(pas)
            skipped += int((ray_on & ~gate).sum()) // WARP
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (dx * qx + dy * qy + dz * qz) * invd
            a = (e2x * qx + e2y * qy + e2z * qz) * invd
            take = (gate & pas & (v >= 0.0) & (u + v <= 1.0) & (a > EPS)
                    & (a < ca))
            ca = torch.where(take, a, ca)
            ct = torch.where(take, t, ct)
        cmin, first = _butterfly(ca, ct)
        take = ray_on[:, 0] & (cmin < abest)
        abest = torch.where(take, cmin, abest)
        best = torch.where(take, c * CHUNK + first, best)
    if stats is not None:
        stats.update(walks=walks, skipped=skipped, boxed=boxed)
    return abest, best.to(torch.int32)


def _k6_inputs(o, d, tri):
    """The launch's args of K6 as mesh_best_rows_sparse makes them, from
    chunk boxes that bound each chunk's real triangles (compile_scene's)."""
    real = (tri != 0).any(dim=0)
    cbb = chip_smoke._tri_chunk_boxes(tri, real)
    return (o, d, tri, *sp.mesh_inputs(o, d, tri, cbb)), cbb


def _tie_case():
    """_tie_tris' 300 triangles (duplicates: 7 repeats 3 in chunk 0, on
    another lane; 150-189 repeat 0-39, in chunk 1; a zero triangle at 100)
    and M rays aimed at the duplicates, a quarter of them turned away (they
    hit nothing)."""
    va, vb, vc, o, d = brute._tie_tris()
    d[:, ::4] = -d[:, ::4]
    tri = pt.pad_tris(*(torch.as_tensor(v) for v in (va, vb, vc)))
    jtri = jpt.pad_tris(*(jnp.asarray(v) for v in (va, vb, vc)))
    return tri, jtri, torch.as_tensor(o), torch.as_tensor(d)


def _mesh_case(mesh_demo, case):
    if case == "ties":
        return _tie_case()
    return brute._instance(mesh_demo, int(case[-1]))


mesh_demo = brute.mesh_demo


@pytest.mark.parametrize("case", ["instance0", "instance1", "instance2",
                                  "ties"])
def test_mesh_walk_mirror_equals_plain(mesh_demo, case):
    """K6's walk on each mesh_demo instance (18, 8 and 18 chunks, the last
    one partial) and on the tie case: (a, row) bit-equal to
    mesh_fold_plain; the prune ends walks and the gate on u skips folds."""
    tri, _, o, d = _mesh_case(mesh_demo, case)
    args, _ = _k6_inputs(o, d, tri)
    stats = {}
    got = mesh_walk_mirror(*args, stats=stats)
    ref = sp.mesh_fold_plain(*args)
    brute._assert_bits(got, ref, f"K6 {case}")
    row = ref[1].numpy()
    assert 0.002 < (row >= 0).mean() < 0.9       # hits and misses
    assert stats["skipped"] > 0
    assert stats["walks"].max() > 0
    if case != "ties":
        assert stats["boxed"] > 0
        assert stats["walks"].sum() < (args[3].shape[1]
                                       * stats["walks"].numel())
    else:
        # the lower triangle of a tie in one chunk, across lanes; the
        # earlier-ranked chunk's across chunks; never the zero triangle
        assert not np.isin(row, [7, 100]).any()
        order = args[3].numpy()
        first0 = (np.argmax(order == 0, axis=1) < np.argmax(order == 1,
                                                            axis=1))
        tiles = np.arange(M) // TILE
        twin = (row >= 150) & (row < 190)
        assert not (twin & first0[tiles]).any()
        assert ((row < 40) & (row >= 0)).any()


@pytest.mark.parametrize("case", ["instance0", "ties"])
def test_mesh_walk_mirror_matches_jax(mesh_demo, case):
    """K6's walk against the JAX mesh_best_rows_sparse in interpret mode,
    on the chunk boxes of the port's inputs."""
    tri, jtri, o, d = _mesh_case(mesh_demo, case)
    args, cbb = _k6_inputs(o, d, tri)
    ref = [np.asarray(x) for x in jsp.mesh_best_rows_sparse(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jtri,
        jnp.asarray(cbb.numpy()), interpret=True)]
    got = [x.numpy() for x in mesh_walk_mirror(*args)]
    assert (ref[1] >= 0).any() and (ref[1] < 0).any()
    assert_trace_protocol(ref, got, f"K6 {case}", JAX_RTOL)
    np.testing.assert_array_equal(got[0][ref[1] < 0], FMAX)


def test_k6_walk_lengths_match_the_mirror(mesh_demo):
    """chip_smoke._k6_walks replays the walk once and counts, per block,
    the chunks this kernel's blocks walk (the mirror's) and, per tile, the
    chunks a tile walks with the prune over all its rays (a block of the
    one-thread-a-ray walk):
    a tile passes a step exactly when one of its blocks does (the list is
    sorted and the bests only shrink), so its walk is its longest
    block's."""
    tri, _, o, d = brute._instance(mesh_demo, 0)
    args, _ = _k6_inputs(o, d, tri)
    tiles, blocks = chip_smoke._k6_walks(args, WALK_LANES)
    stats = {}
    mesh_walk_mirror(*args, stats=stats)
    np.testing.assert_array_equal(blocks.numpy(), stats["walks"].numpy())
    np.testing.assert_array_equal(
        tiles.numpy(), stats["walks"].reshape(-1, WALK_LANES).amax(dim=1))
    assert 0 < blocks.sum() < WALK_LANES * tiles.sum()


# --------------------------------------------------------------------------
# K3b
# --------------------------------------------------------------------------

def _identity(real, x, r):
    """Row r of an affine frame: x where real, the identity's elsewhere."""
    return torch.where(real, x, 1.0 if r % 5 == 0 else 0.0)


def _fold_chunk(fn, o, d, inv_r, trf_r, pid, c, on, lanes, best):
    """K3b's fold of chunk c [M] for the rays `on` [M] (lane j prims j,
    j + L, ... behind the warp gate on a hit), its lane reduce and the
    strictly-closer merge into best = (dist, row, a, dircode)."""
    m = o.shape[1]
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    lane = torch.arange(lanes)
    c = torch.where(on, c, 0)        # a ray off the walk reads nothing
    cd = torch.full((m, lanes), FMAX, dtype=torch.float32)
    crow = torch.full((m, lanes), -1, dtype=torch.int64)
    ca = torch.zeros((m, lanes), dtype=torch.float32)
    cdir = torch.full((m, lanes), -1, dtype=torch.int32)
    for i in range(CHUNK // lanes):
        p = c[:, None] * CHUNK + lane[None, :] + i * lanes        # [M, L]
        real = on[:, None] & (pid[0, p] >= 0)
        iv = [_identity(real, inv_r[r, p], r) for r in range(12)]
        tf = trf_r[:, p]
        lox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
        loy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
        loz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
        tdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
        tdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
        tdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        nrm = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy + tdz * tdz),
                          min=1e-30)
        ldx, ldy, ldz = tdx / nrm, tdy / nrm, tdz / nrm
        a, ok, code_ = fn(lox, loy, loz, ldx, ldy, ldz)
        ok = ok & real
        gate = _warp_any(ok)
        plx, ply, plz = lox + a * ldx, loy + a * ldy, loz + a * ldz
        ex = ox - (tf[0] * plx + tf[1] * ply + tf[2] * plz + tf[3])
        ey = oy - (tf[4] * plx + tf[5] * ply + tf[6] * plz + tf[7])
        ez = oz - (tf[8] * plx + tf[9] * ply + tf[10] * plz + tf[11])
        dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
        take = gate & ok & (dist < cd)
        cd = torch.where(take, dist, cd)
        crow = torch.where(take, p, crow)
        ca = torch.where(take, a, ca)
        cdir = torch.where(take, code_, cdir)
    cd, crow, ca, cdir = _butterfly(cd, crow, ca, cdir)
    take = cd < best[0]
    return tuple(torch.where(take, x, b)
                 for x, b in zip((cd, crow, ca, cdir), best))


def group_tile_mirror(o, d, code, inv_r, trf_r, pid, cbb):
    """K3b's fold of a cone or quad group: (dist, row, a, dircode) per
    ray."""
    rd = safe_rcp(d)
    m = o.shape[1]
    bd = torch.full((m,), FMAX, dtype=torch.float32)
    ba = torch.zeros((m,), dtype=torch.float32)
    brow = torch.full((m,), -1, dtype=torch.int64)
    bdir = torch.full((m,), -1, dtype=torch.int32)
    for c in range(cbb.shape[1]):
        rays = pt._tile_rays(pt._slab_enters(o, rd, cbb[:, c], bd))
        if rays is None:
            continue
        cs = slice(c * CHUNK, (c + 1) * CHUNK)
        cd, crow, ca, cdir = brute.group_fold_mirror(
            o[:, rays], d[:, rays], code, inv_r[:, cs], trf_r[:, cs],
            pid[:, cs])
        take = cd < bd[rays]
        bd[rays] = torch.where(take, cd, bd[rays])
        brow[rays] = torch.where(take, crow.long() + c * CHUNK, brow[rays])
        ba[rays] = torch.where(take, ca, ba[rays])
        bdir[rays] = torch.where(take, cdir, bdir[rays])
    return bd, torch.where(bd < FMAX, brow, -1).to(torch.int32), ba, bdir


def group_culled_mirror(o, d, code, inv_r, trf_r, pid, cbb, stats=None):
    """K3b's fold: (dist, row, a, dircode) per ray. For a sphere, cube or
    cylinder group `stats`, a dict, gets the chunks each ray entered ([M,
    nchunks] bool) and the steps each warp took ([warps])."""
    if code in BEHIND:
        return group_tile_mirror(o, d, code, inv_r, trf_r, pid, cbb)
    lanes = CULL_LANES
    fn = brute.G_FNS[code]
    m = o.shape[1]
    nch = inv_r.shape[1] // CHUNK
    sbb = chip_smoke._group_super_boxes(cbb)
    nsup = sbb.shape[1]
    o3, rd = o[:, :, None], safe_rcp(d)[:, :, None]
    lane = torch.arange(lanes)
    bd = torch.full((m,), FMAX, dtype=torch.float32)
    ba = torch.zeros((m,), dtype=torch.float32)
    brow = torch.full((m,), -1, dtype=torch.int64)
    bdir = torch.full((m,), -1, dtype=torch.int32)
    entered = torch.zeros((m, nch), dtype=torch.bool)
    steps = torch.zeros((m * lanes // WARP,), dtype=torch.int64)

    def first(want):
        """(rays with a wanted lane, its lowest wanted lane)."""
        on = want.any(dim=1)
        return on, torch.where(on, want.int().argmax(dim=1), 0)

    for g in range(0, nsup, lanes):
        cols = (g + lane).expand(m, lanes)
        ts = torch.where(cols < nsup, _entry(
            o3, rd, sbb[:, cols.clamp(max=nsup - 1)]), INF)
        sleft = torch.ones((m, lanes), dtype=torch.bool)
        while True:
            want = (ts <= bd[:, None]) & sleft
            if not want.any():
                break
            son, sj = first(want)
            sleft = son[:, None] & sleft & (lane[None, :] > sj[:, None])
            for h in range(0, GROUP_SUPER, lanes):
                # the super's chunks c0 .. c0 + L - 1, one a lane
                c0 = (g + sj) * GROUP_SUPER + h
                cols = c0[:, None] + lane[None, :]
                te = torch.where(son[:, None] & (cols < nch), _entry(
                    o3, rd, cbb[:, cols.clamp(max=nch - 1)]), INF)
                left = torch.ones((m, lanes), dtype=torch.bool)
                while True:
                    want = (te <= bd[:, None]) & left
                    if not want.any():
                        break
                    on, j = first(want)
                    steps += on.reshape(-1, WARP // lanes).any(dim=1)
                    left = on[:, None] & left & (lane[None, :] > j[:, None])
                    entered[on, (c0 + j)[on]] = True
                    bd, brow, ba, bdir = _fold_chunk(
                        fn, o, d, inv_r, trf_r, pid, c0 + j, on, lanes,
                        (bd, brow, ba, bdir))
    if stats is not None:
        stats.update(entered=entered, steps=steps)
    return bd, torch.where(bd < FMAX, brow, -1).to(torch.int32), ba, bdir


def _sorted_group(code, n_prims=300, seed=None):
    """A random group (numpy) with its prims sorted along x, so that each
    chunk's box is a slab of the field and a ray enters only some of
    them."""
    trf, inv, pid = random_group(transforms, code, n_prims,
                                 100 * code + 11 if seed is None else seed)
    by_x = np.argsort(trf[:, 0, 3], kind="stable")
    return trf[by_x], inv[by_x], pid


def _group_case(code, ties=False, n_prims=300, m=M):
    """(port tables, JAX tables, cbb [6, nchunks] torch, rays [3, M] numpy
    x 2): a sorted 300-prim group; with `ties`, prim 9 repeats prim 4 (one
    chunk, another lane), 140-179 repeat 0-39 (another chunk) and scene
    ids 20, 21 and 150 are < 0, and the rays aim at prims 0-39. A quarter
    of the rays start outside the field and point away from it: they hit
    nothing."""
    trf, inv, pid = _sorted_group(code, n_prims)
    if ties:
        trf[9], inv[9] = trf[4], inv[4]
        trf[140:180], inv[140:180] = trf[0:40], inv[0:40]
        pid[[20, 21, 150]] = -1
    tabs = pt._pad_group(torch.as_tensor(trf), torch.as_tensor(inv),
                         torch.as_tensor(pid))
    jtabs = jpt._pad_group(jnp.asarray(trf), jnp.asarray(inv),
                           jnp.asarray(pid))
    cbb = torch.as_tensor(group_chunk_boxes(trf, tabs[0].shape[1]))
    o, d = random_rays(m, code)
    if ties:
        g = np.random.RandomState(code)
        aim = trf[g.randint(0, 40, m), :3, 3].T - o
        d = (aim / np.linalg.norm(aim, axis=0)).astype(np.float32)
    o[:, ::4] = np.where(o[:, ::4] < 0, -200.0, 200.0)
    d[:, ::4] = np.sign(o[:, ::4]) * np.abs(d[:, ::4])    # outward
    return tabs, jtabs, cbb, o, d


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("code", CODES)
def test_group_culled_mirror_equals_plain(code, ties):
    """K3b's fold: every output bit-equal to group_best_rows_culled_plain
    (and to the brute group_best_rows_plain); rays skip chunks; with ties
    the lower row wins in a chunk and across chunks and scene ids < 0
    never hit."""
    tabs, _, cbb, o, d = _group_case(code, ties)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    stats = {}
    got = group_culled_mirror(o, d, code, *tabs, cbb, stats=stats)
    ref = pt.group_best_rows_culled_plain(o, d, code, *tabs, cbb)
    brute._assert_bits(got, ref, f"K3b shape {code}")
    brute._assert_bits(got, pt.group_best_rows_plain(o, d, code, *tabs),
                       f"K3b shape {code} vs brute")
    row = ref[1].numpy()
    assert 0.02 < (row >= 0).mean() < 0.9
    assert code in BEHIND or (row[::4] < 0).all()   # the outward rays
    if code not in BEHIND:
        assert 0 < stats["entered"].sum() < stats["entered"].numel()
    if ties:
        assert not np.isin(row, [9, 20, 21, 150]).any()
        twins = row[(row >= 140) & (row < 180)]
        assert np.isin(twins, [160, 161]).all()


@pytest.mark.parametrize("code", [1, 3, 4])
def test_group_culled_mirror_matches_jax(code):
    """K3b's fold against the JAX culled group_best_rows in interpret
    mode, with ties and holes, on one 1024-ray tile: spheres and cylinders
    (16 lanes a ray), cones (a tile). Every shape's mirror equals the plain
    version above, which tests/test_torch_culled_trace.py holds against
    JAX for every shape."""
    tabs, jtabs, cbb, o, d = _group_case(code, ties=True, m=pt.RAY_TILE)
    ref = [np.asarray(x) for x in jpt.group_best_rows(
        jnp.asarray(o), jnp.asarray(d), code, *jtabs,
        cbb=jnp.asarray(cbb.numpy()), interpret=True)]
    got = [x.numpy() for x in group_culled_mirror(
        torch.as_tensor(o), torch.as_tensor(d), code, *tabs, cbb)]
    assert_trace_protocol(ref[:2], got[:2], f"K3b shape {code}", JAX_RTOL)
    same = (ref[1] == got[1]) & (ref[1] >= 0)
    np.testing.assert_allclose(got[2][same], ref[2][same], rtol=JAX_RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(got[3][same], ref[3][same])
    np.testing.assert_array_equal(got[1][ref[1] < 0], -1)


def _warp_walks(o, d, code, inv_r, trf_r, pid, cbb):
    """K3b one thread a ray, gated per warp: the chunks each warp of 32 rays
    entered, gating each chunk on whether some ray of the warp enters its
    box within its running best, folding it for all 32."""
    rd = safe_rcp(d)
    m = o.shape[1]
    bd = torch.full((m,), FMAX, dtype=torch.float32)
    walks = torch.zeros((m // WARP,), dtype=torch.int64)
    for c in range(cbb.shape[1]):
        warp = pt._slab_enters(o, rd, cbb[:, c], bd).reshape(
            -1, WARP).any(dim=1)
        walks += warp
        rays = torch.nonzero(warp.repeat_interleave(WARP)).squeeze(1)
        if rays.numel():
            cmin = pt._group_chunk(SOA_FNS[code], o[:, rays], d[:, rays],
                                   inv_r, trf_r, pid, c)[0]
            bd[rays] = torch.minimum(bd[rays], cmin)
    return walks


@pytest.mark.parametrize("code, n_prims", [(1, 2200), (3, 300)])
def test_k3b_walk_lengths_match_the_mirror(code, n_prims):
    """chip_smoke._k3b_walks replays the per-ray walk once and counts the
    chunks each ray enters and each warp of this kernel enters (the union
    of its rays'), both the mirror's, and each warp of 32 rays entered
    when gated as one (_warp_walks); a warp takes at least as many steps
    as its busiest ray. The 2200-prim group has 18 chunks under 2 supers; the
    mirror's outputs are bit-equal to the plain version's there too."""
    tabs, _, cbb, o, d = _group_case(code, n_prims=n_prims, m=pt.RAY_TILE)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    old, new, per_ray = chip_smoke._k3b_walks((o, d, code, *tabs, cbb),
                                              CULL_LANES)
    stats = {}
    got = group_culled_mirror(o, d, code, *tabs, cbb, stats=stats)
    brute._assert_bits(got, pt.group_best_rows_culled_plain(
        o, d, code, *tabs, cbb), f"K3b {n_prims} prims")
    seen = stats["entered"]                                 # [M, nchunks]
    np.testing.assert_array_equal(per_ray.numpy(), seen.sum(dim=1).numpy())
    np.testing.assert_array_equal(new.numpy(), seen.reshape(
        -1, WARP // CULL_LANES, seen.shape[1]).any(dim=1).sum(dim=1).numpy())
    np.testing.assert_array_equal(
        old.numpy(), _warp_walks(o, d, code, *tabs, cbb).numpy())
    rays = per_ray.reshape(-1, WARP // CULL_LANES)
    assert (rays.amax(dim=1) <= stats["steps"]).all()
    assert (stats["steps"] <= rays.sum(dim=1)).all()
    assert new.sum() < old.sum() * CULL_LANES and per_ray.max() > 1


def test_super_boxes_are_the_union_of_their_chunks():
    """The K3b super boxes chip_smoke.py counts the bound with (as the
    kernel builds them): box s is numpy's min of the minima and max of the
    maxima of chunk boxes 16 s .. 16 s + 15, the last super short."""
    g = np.random.RandomState(3)
    lo = g.uniform(-50, 50, (3, 37)).astype(np.float32)
    cbb = np.concatenate([lo, lo + g.uniform(0, 9, (3, 37))]).astype(
        np.float32)
    cbb[:, 36] = [1, 1, 1, -1, -1, -1]             # an empty padding box
    got = chip_smoke._group_super_boxes(torch.as_tensor(cbb)).numpy()
    assert got.shape == (6, 3)
    for s_ in range(3):
        cols = cbb[:, 16 * s_:16 * s_ + 16]
        np.testing.assert_array_equal(got[:3, s_], cols[:3].min(axis=1))
        np.testing.assert_array_equal(got[3:, s_], cols[3:].max(axis=1))


def _enters_np(o, rd, box, best):
    """numpy float32 slab test of rays o, rd [3, M] against box [6]
    within best [M] (the reference's, entry clamped at 0)."""
    t0 = (box[:3, None] - o) * rd
    t1 = (box[3:, None] - o) * rd
    tmin = np.maximum(np.minimum(t0, t1).max(axis=0), np.float32(0.0))
    tmax = np.maximum(t0, t1).min(axis=0)
    return (tmax >= tmin) & (tmin <= best)


def test_k3b_bound_counts_supers_from_the_inputs():
    """The work chip_smoke.py counts for K3b's bound, from the launch's
    inputs and final best, against a count in numpy: every super box
    holding a real chunk for every ray, the chunk boxes of each super a ray
    enters within its final best, and the real prims of the chunks it
    enters so; the hits once per ray with a winner."""
    tabs, _, cbb, o, d = _group_case(1, n_prims=2200)
    pid = tabs[2].numpy()[0]
    pid[[5, 1700]] = -1                                 # holes
    tabs = (tabs[0], tabs[1], torch.as_tensor(pid[None, :]))
    args = (torch.as_tensor(o), torch.as_tensor(d), 1, *tabs, cbb)
    out = pt.group_best_rows_culled_plain(*args)
    got = [int(x) for x in chip_smoke._needed("K3b", args, out)]
    best = out[0].numpy()
    rd = (np.where(d < 0, -1.0, 1.0)
          / np.maximum(np.abs(d), 1e-30)).astype(np.float32)
    box = cbb.numpy()
    per_chunk = (pid >= 0).reshape(-1, CHUNK).sum(axis=1)
    tests = boxes = 0
    for s_ in range(-(-box.shape[1] // GROUP_SUPER)):
        cols = range(GROUP_SUPER * s_,
                     min(GROUP_SUPER * (s_ + 1), box.shape[1]))
        real = [c for c in cols if per_chunk[c] > 0]
        if not real:
            continue
        sup = np.concatenate([box[:3, list(cols)].min(axis=1),
                              box[3:, list(cols)].max(axis=1)])
        inside = _enters_np(o, rd, sup, best)
        boxes += M + int(inside.sum()) * len(real)
        for c in real:
            enter = inside & _enters_np(o, rd, box[:, c], best)
            tests += int(enter.sum()) * int(per_chunk[c])
    assert got == [tests, int((out[1] >= 0).sum()), boxes]
    assert 0 < tests < M * int(per_chunk.sum()) and boxes < M * box.shape[1]


# --------------------------------------------------------------------------
# K4b
# --------------------------------------------------------------------------

def _first(want):
    """(rays with a wanted lane, its lowest wanted lane)."""
    on = want.any(dim=1)
    return on, torch.where(on, want.int().argmax(dim=1), 0)


def _fold_tris(o, d, staged, c, on, lanes, abest, best):
    """K4b's fold of leaf chunk c [M] for the rays `on` [M]: lane j folds
    triangles j, j + L, ... of the staged chunk (the corner and the edges)
    behind the warp-wide gate on u; a ray off the walk tests chunk 0 and
    drops it. Its L lanes reduce (a, index) to the lexicographic minimum;
    the result merges strictly closer into (abest, best)."""
    A, E1, E2 = staged
    m = o.shape[1]
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    lane = torch.arange(lanes)
    ray_on = on[:, None]
    ca = torch.full((m, lanes), FMAX, dtype=torch.float32)
    ct = torch.full((m, lanes), CHUNK, dtype=torch.int64)
    for i in range(CHUNK // lanes):
        t = lane[None, :] + i * lanes                              # [1, L]
        col = c[:, None] * CHUNK + t                               # [M, L]
        ax, ay, az = A[:, col]
        e1x, e1y, e1z = E1[:, col]
        e2x, e2y, e2z = E2[:, col]
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        det = e1x * hx + e1y * hy + e1z * hz
        ok = torch.abs(det) >= EPS
        invd = 1.0 / torch.where(ok, det, 1.0)
        sx, sy, sz = ox - ax, oy - ay, oz - az
        u = (sx * hx + sy * hy + sz * hz) * invd
        pas = ray_on & ok & (u >= 0.0) & (u <= 1.0)
        gate = _warp_any(pas)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (dx * qx + dy * qy + dz * qz) * invd
        a = (e2x * qx + e2y * qy + e2z * qz) * invd
        take = (gate & pas & (v >= 0.0) & (u + v <= 1.0) & (a > EPS)
                & (a < ca))
        ca = torch.where(take, a, ca)
        ct = torch.where(take, t, ct)
    cmin, first = _butterfly(ca, ct)
    take = on & (cmin < abest)
    return (torch.where(take, cmin, abest),
            torch.where(take, c * CHUNK + first, best))


def tri_culled_mirror(o, d, tri, cbb, sbb, stats=None):
    """K4b's fold: (a, row) per ray. Each ray tests the super boxes g .. g
    + L - 1 once, one a lane (its entry te, +inf where it misses), and
    takes those with te <= its best a, ascending; in each it tests the
    super's leaf boxes L at a time (a padding leaf, past the last real
    chunk, is never tested) and walks the leaves it enters so, each gate
    reading the best its walk has reached. `stats`, a dict, gets the
    (ray, leaf) pairs folded and the (ray, super) pairs entered."""
    lanes = TRI_LANES
    A, E1, E2, _ = brute.stage_tris(tri)
    m = o.shape[1]
    nreal = tri.shape[1] // CHUNK
    nsup, nleaf = sbb.shape[1], cbb.shape[1]
    o3, rd = o[:, :, None], safe_rcp(d)[:, :, None]
    lane = torch.arange(lanes)
    abest = torch.full((m,), FMAX, dtype=torch.float32)
    best = torch.full((m,), -1, dtype=torch.int64)
    folded = supers = 0
    for g in range(0, nsup, lanes):
        cols = (g + lane).expand(m, lanes)
        ts = torch.where(cols < nsup, _entry(
            o3, rd, sbb[:, cols.clamp(max=nsup - 1)]), INF)
        sleft = torch.ones((m, lanes), dtype=torch.bool)
        while True:
            want = (ts <= abest[:, None]) & sleft
            if not want.any():
                break
            son, sj = _first(want)
            supers += int(son.sum())
            sleft = son[:, None] & sleft & (lane[None, :] > sj[:, None])
            for h in range(0, pt.TRI_SUPER, lanes):
                c0 = (g + sj) * pt.TRI_SUPER + h
                cols = c0[:, None] + lane[None, :]
                te = torch.where(son[:, None] & (cols < nreal), _entry(
                    o3, rd, cbb[:, cols.clamp(max=nleaf - 1)]), INF)
                left = torch.ones((m, lanes), dtype=torch.bool)
                while True:
                    want = (te <= abest[:, None]) & left
                    if not want.any():
                        break
                    on, j = _first(want)
                    folded += int(on.sum())
                    left = on[:, None] & left & (lane[None, :] > j[:, None])
                    abest, best = _fold_tris(
                        o, d, (A, E1, E2), torch.where(on, c0 + j, 0), on,
                        lanes, abest, best)
    if stats is not None:
        stats.update(folded=folded, supers=supers)
    return abest, torch.where(abest < FMAX, best, -1).to(torch.int32)


def _k4b_case(mesh_demo, case):
    """(o, d, tri, cbb, sbb): a mesh_demo instance with compile_scene's
    leaf and super boxes (or, with "_none", sbb=None's always-pass supers
    over the leaves padded to a super), or the tie case (duplicates in a
    chunk and across chunks, a zero triangle, rays that hit nothing) under
    sbb=None, whose 3 real chunks sit under 13 padding leaves."""
    if case == "ties":
        tri, _, o, d = _tie_case()
        cbb = chip_smoke._tri_chunk_boxes(tri, (tri != 0).any(dim=0))
        return (o, d, tri, *pt.super_boxes(cbb))
    i = int(case[len("instance")])
    tri, _, o, d = brute._instance(mesh_demo, i)
    dev = mesh_demo[0]
    cbb, sbb = dev.mesh_chunk_bb[i], dev.mesh_super_bb[i]
    return (o, d, tri, *(pt.super_boxes(cbb) if case.endswith("_none")
                         else (cbb, sbb)))


@pytest.mark.parametrize("case", ["instance0", "instance1", "instance2",
                                  "instance0_none", "ties"])
def test_tri_culled_mirror_equals_plain(mesh_demo, case):
    """K4b's fold on each mesh_demo instance, with sbb=None and on the tie
    case: (a, row) bit-equal to mesh_best_rows_culled_plain (and to the
    brute mesh_best_rows_plain); rays skip leaves and supers; with ties the
    lower triangle wins in a chunk and across chunks, and the zero
    triangle never does."""
    o, d, tri, cbb, sbb = _k4b_case(mesh_demo, case)
    stats = {}
    got = tri_culled_mirror(o, d, tri, cbb, sbb, stats=stats)
    ref = pt.mesh_best_rows_culled_plain(o, d, tri, cbb, sbb)
    brute._assert_bits(got, ref, f"K4b {case}")
    brute._assert_bits(got, pt.mesh_best_rows_plain(o, d, tri),
                       f"K4b {case} vs brute")
    row = ref[1].numpy()
    assert 0.002 < (row >= 0).mean() < 0.95
    nreal = tri.shape[1] // CHUNK
    assert 0 < stats["folded"] < o.shape[1] * nreal
    if case == "ties":
        assert not np.isin(row, [7, 100]).any()
        assert not ((row >= 150) & (row < 190)).any()
        assert ((row < 40) & (row >= 0)).any()
