"""Brute and culled trace kernels: closest hit of a ray set against one
analytic group (K3a, K3b) or one mesh instance (K4a, K4b).

Port of the host side of montecarlo_pathtracing_tpu/ops/pallas_trace.py:
the padded tables (`_pad_group`, `pad_tris`) and the wrappers
`group_best_rows` and `mesh_best_rows` of the TPU kernels
`_group_kernel_plain` (:162), `_group_kernel_culled` (:251),
`_tri_kernel` (:497) and `_tri_kernel_culled` (:543). Their CUDA
counterparts are in csrc/trace_kernels.cu.

  - `group_best_rows` (K3a): world rays o, d [3, M] (unit directions)
    against a homogeneous analytic group given as [12, ppad] inverse and
    forward affine rows and [1, ppad] scene ids (-1 = padding, never
    hits). Returns (dist, group row, local a, dircode), each [M]: the
    strictly-closer fold on world distance in ascending prim order, row
    -1, a 0 and dircode -1 where nothing is hit. With chunk boxes
    (`cbb`, [6, ppad / 128] world AABBs) it hands over to
    `group_best_rows_culled` (K3b): the same fold, but a 128-prim chunk
    is skipped for a set of rays none of which enters its box closer than
    its best so far (a 1024-ray tile in the plain version, as on the TPU;
    on the card one ray for spheres, cubes and cylinders, and the tile
    for cones and quads, whose tests take hits behind the ray's origin).
  - `mesh_best_rows` (K4a): mesh-local unit rays against [9, ppad]
    triangle corner rows, Moller-Trumbore folded on the local parameter
    `a` (monotone in world distance inside one instance). Returns (a,
    row), a = FLT_MAX and row -1 on a miss. With leaf boxes (`cbb`, [6,
    16 * nsuper]) and optionally super boxes (`sbb`, [6, nsuper]) it hands
    over to `mesh_best_rows_culled` (K4b): two-level gating, a super of
    16 leaf chunks and then each leaf, against the running best `a`.

The AoS wrappers `trace_analytic_group_pallas` (K3a) and
`trace_mesh_instance_pallas` (K4a) fold one group or instance into the
dense trace's `Hit` record (ops/trace.trace with use_kernels): they pad
[N, 3] rays to RAY_TILE rows, launch the brute kernel, slice the padding
off and rebuild the winner's hit points from its row.

The cull is conservative, so the culled folds return the brute folds'
winners. Each wrapper runs its plain PyTorch version (`*_plain`: the
chunked fold of the TPU kernel, [M, 128] per chunk, first minimum inside
a chunk, strictly closer across chunks, the culled ones gated per
1024-ray tile) on CPU tensors, and launches its kernel on CUDA tensors,
counting the launch in its own `.launches` (K3a and K4a on
`group_best_rows` and `mesh_best_rows`, K3b and K4b on the `*_culled`
wrappers, whose launch functions are `group_best_culled` and
`mesh_best_culled`); it raises otherwise, and never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .intersect import CODE_MESH, EPSILON, FLT_MAX, Hit, _better
from .shapes import SOA_FNS
from .vec import affine_rows, safe_rcp
from ..utils.transforms import (
    length3, normalize, transform_dir, transform_point)

RAY_TILE = 1024     # rays per tile (the TPU kernels' grid step)
PRIM_CHUNK = 128    # prims or triangles per chunk
TRI_SUPER = 16      # leaf chunks per K4b super (scene/device.TRI_SUPER)
GROUP_SUPER = 16    # chunks per K3b super box (csrc/trace_kernels.cu)

_FMAX = float(FLT_MAX)
_EPS = float(EPSILON)
_F32 = torch.float32
_I32 = torch.int32


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _pad_group(transfo, inv, prim_idx):
    """A group's tables padded to PRIM_CHUNK columns: [12, ppad] inverse
    and forward affine rows (zeros in the padding) and [1, ppad] scene
    ids (-1 in the padding)."""
    p = transfo.shape[0]
    ppad = _round_up(p, PRIM_CHUNK)
    dev = transfo.device
    inv_r = torch.zeros((12, ppad), dtype=_F32, device=dev)
    trf_r = torch.zeros((12, ppad), dtype=_F32, device=dev)
    inv_r[:, :p] = affine_rows(inv)
    trf_r[:, :p] = affine_rows(transfo)
    pid = torch.full((1, ppad), -1, dtype=_I32, device=dev)
    pid[0, :p] = prim_idx
    return inv_r, trf_r, pid


def pad_tris(va, vb, vc):
    """[P,3] corners -> [9, ppad] rows (ax ay az bx .. cz); the zero
    padding is degenerate triangles that never hit."""
    p = va.shape[0]
    ppad = _round_up(p, PRIM_CHUNK)
    tri = torch.zeros((9, ppad), dtype=_F32, device=va.device)
    tri[0:3, :p] = va.T
    tri[3:6, :p] = vb.T
    tri[6:9, :p] = vc.T
    return tri


def check_tensors(kernel: str, dev, want: dict):
    """Raise unless every named tensor is on `dev` with the dtype and
    shape given and contiguous: want = {name: (tensor, dtype, shape)}."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {dev}")
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel} input {name}: {t.device} {t.dtype} "
                f"{tuple(t.shape)}, want {dev} {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} input {name} is not contiguous")


def check_work(kernel: str, work, dev, n: int = 3):
    """The optional work counters: an int64 [n] tensor on `dev` (tests
    done, chunks or blocks visited, tests that hit; the culled kernels
    add box tests and, K4b, supers entered), or None."""
    if work is None:
        return ctypes.c_void_p(0)
    if work.device != dev or work.dtype != torch.int64 \
            or tuple(work.shape) != (n,):
        raise ValueError(f"{kernel} work counters: want an int64 [{n}] "
                         f"tensor on {dev}")
    return work.data_ptr()


def raise_on_error(kernel: str, lib, err: int):
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {lib.trace_error_string(err).decode()}")


# --------------------------------------------------------------------------
# K3a: one analytic group
# --------------------------------------------------------------------------

def _first_min(x):
    """Per row of x [M, C]: (min, index of its first occurrence, C where
    the minimum is NaN), the one-hot first-min of the TPU kernels."""
    cmin = x.amin(dim=1)
    iota = torch.arange(x.shape[1], device=x.device)
    first = torch.where(x == cmin[:, None], iota, x.shape[1]).amin(dim=1)
    return cmin, first


def _pick(x, first, fill):
    """x [M, C] at column `first` per row, `fill` where first == C."""
    c = x.shape[1]
    got = x.gather(1, first.clamp(max=c - 1)[:, None])[:, 0]
    return torch.where(first < c, got, fill)


def _group_chunk(fn, o, d, inv_r, trf_r, pid, c):
    """Chunk c of a group against rays o, d ([3, m] rows): the chunk's
    first-min winner per ray (cmin, first, a, dircode), each [m]; cmin is
    FLT_MAX and `first` 128 where nothing in the chunk is hit."""
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    s = slice(c * PRIM_CHUNK, (c + 1) * PRIM_CHUNK)
    inv = [inv_r[r, s][None, :] for r in range(12)]     # [1, C] each
    trf = [trf_r[r, s][None, :] for r in range(12)]
    lox = inv[0] * ox + inv[1] * oy + inv[2] * oz + inv[3]
    loy = inv[4] * ox + inv[5] * oy + inv[6] * oz + inv[7]
    loz = inv[8] * ox + inv[9] * oy + inv[10] * oz + inv[11]
    tdx = inv[0] * dx + inv[1] * dy + inv[2] * dz
    tdy = inv[4] * dx + inv[5] * dy + inv[6] * dz
    tdz = inv[8] * dx + inv[9] * dy + inv[10] * dz
    nrm = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy + tdz * tdz),
                      min=1e-30)
    ldx, ldy, ldz = tdx / nrm, tdy / nrm, tdz / nrm
    a, valid, dircode = fn(lox, loy, loz, ldx, ldy, ldz)  # [m, C]
    valid = valid & (pid[0, s][None, :] >= 0)
    plx, ply, plz = lox + a * ldx, loy + a * ldy, loz + a * ldz
    pgx = trf[0] * plx + trf[1] * ply + trf[2] * plz + trf[3]
    pgy = trf[4] * plx + trf[5] * ply + trf[6] * plz + trf[7]
    pgz = trf[8] * plx + trf[9] * ply + trf[10] * plz + trf[11]
    ex, ey, ez = ox - pgx, oy - pgy, oz - pgz
    dist = torch.where(valid, torch.sqrt(ex * ex + ey * ey + ez * ez), _FMAX)
    cmin, first = _first_min(dist)
    return cmin, first, _pick(a, first, 0.0), _pick(dircode, first, 0)


def _miss_group(m, device):
    """(dist, row, a, dircode) of rays that hit nothing yet."""
    return (torch.full((m,), _FMAX, dtype=_F32, device=device),
            torch.full((m,), -1, dtype=torch.int64, device=device),
            torch.zeros((m,), dtype=_F32, device=device),
            torch.full((m,), -1, dtype=_I32, device=device))


def group_best_rows_plain(o, d, shape_code, inv_r, trf_r, pid):
    """Plain PyTorch version of K3a (reference `_group_kernel_plain`):
    the chunked brute fold, [M, 128] per chunk."""
    fn = SOA_FNS[shape_code]
    bd, brow, ba, bdir = _miss_group(o.shape[1], o.device)
    for c in range(inv_r.shape[1] // PRIM_CHUNK):
        cmin, first, wa, wdir = _group_chunk(fn, o, d, inv_r, trf_r, pid, c)
        take = cmin < bd
        bd = torch.where(take, cmin, bd)
        brow = torch.where(take, first + c * PRIM_CHUNK, brow)
        ba = torch.where(take, wa, ba)
        bdir = torch.where(take, wdir, bdir)
    row = torch.where(bd < _FMAX, brow, -1).to(_I32)
    return bd, row, ba, bdir


def _slab_enters(o, rd, box, bound):
    """Rays o [3, m] with safe reciprocal directions rd against one box
    column (6 values: min xyz, max xyz): whether each ray's segment [0,
    bound] enters the box (the reference's slab test, pallas_trace.py:
    280-292 and :565-578)."""
    t0x = (box[0] - o[0]) * rd[0]
    t1x = (box[3] - o[0]) * rd[0]
    t0y = (box[1] - o[1]) * rd[1]
    t1y = (box[4] - o[1]) * rd[1]
    t0z = (box[2] - o[2]) * rd[2]
    t1z = (box[5] - o[2]) * rd[2]
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp(torch.minimum(t0z, t1z), min=0.0))
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z))
    return (tmax >= tmin) & (tmin <= bound)


def _tile_rays(gate):
    """Ray indices [k * RAY_TILE] of the tiles in which some ray passes
    `gate` [M], None where no tile does: the TPU kernels' per-tile
    predicate (`pl.when(jnp.any(...))`)."""
    on = gate.reshape(-1, RAY_TILE).any(dim=1)
    tiles = torch.nonzero(on).squeeze(1)
    if tiles.numel() == 0:
        return None
    lanes = torch.arange(RAY_TILE, device=gate.device)
    return (tiles[:, None] * RAY_TILE + lanes[None, :]).reshape(-1)


def group_best_rows_culled_plain(o, d, shape_code, inv_r, trf_r, pid, cbb):
    """Plain PyTorch version of K3b (reference `_group_kernel_culled`):
    K3a's chunked fold in which chunk c runs only for the 1024-ray tiles
    in which some ray enters cbb[:, c] no farther than its best before the
    chunk; the chunk's body runs for all rays of those tiles."""
    fn = SOA_FNS[shape_code]
    rd = safe_rcp(d)
    bd, brow, ba, bdir = _miss_group(o.shape[1], o.device)
    for c in range(inv_r.shape[1] // PRIM_CHUNK):
        rays = _tile_rays(_slab_enters(o, rd, cbb[:, c], bd))
        if rays is None:
            continue
        cmin, first, wa, wdir = _group_chunk(
            fn, o[:, rays], d[:, rays], inv_r, trf_r, pid, c)
        take = cmin < bd[rays]
        bd[rays] = torch.where(take, cmin, bd[rays])
        brow[rays] = torch.where(take, first + c * PRIM_CHUNK, brow[rays])
        ba[rays] = torch.where(take, wa, ba[rays])
        bdir[rays] = torch.where(take, wdir, bdir[rays])
    row = torch.where(bd < _FMAX, brow, -1).to(_I32)
    return bd, row, ba, bdir


def group_best_rows(o, d, shape_code, inv_r, trf_r, pid, cbb=None,
                    work=None):
    """K3a: o, d [3, M] world ray rows (M a multiple of RAY_TILE, unit
    directions), the padded tables of `_pad_group`. Returns (dist, row,
    a, dircode), each [M]. `work`, an int64 [3] CUDA tensor, gets the
    launch's ray-prim tests, 128-prim chunks visited per block and tests
    whose shape test passed added to it. With chunk boxes `cbb` this is
    `group_best_rows_culled` (K3b)."""
    if cbb is not None:
        return group_best_rows_culled(o, d, shape_code, inv_r, trf_r, pid,
                                      cbb, work=work)
    if o.device.type == "cpu":
        return group_best_rows_plain(o, d, shape_code, inv_r, trf_r, pid)
    m, ppad = o.shape[1], inv_r.shape[1]
    if m % RAY_TILE or ppad % PRIM_CHUNK or shape_code not in SOA_FNS:
        raise ValueError(f"K3a: M={m}, ppad={ppad}, shape {shape_code}")
    dev = o.device
    check_tensors("K3a", dev, {
        "o": (o, _F32, (3, m)), "d": (d, _F32, (3, m)),
        "inv_r": (inv_r, _F32, (12, ppad)), "trf_r": (trf_r, _F32, (12, ppad)),
        "pid": (pid, _I32, (1, ppad))})
    counts = check_work("K3a", work, dev)
    dist, row, a, dircode = _group_outputs(m, dev)
    lib = kernels.trace_kernels_lib()
    with kernels.on_device(dev):
        err = lib.group_best(
            o.data_ptr(), d.data_ptr(), m, inv_r.data_ptr(), trf_r.data_ptr(),
            pid.data_ptr(), ppad, int(shape_code), dist.data_ptr(),
            row.data_ptr(), a.data_ptr(), dircode.data_ptr(), counts,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K3a", lib, err)
    group_best_rows.launches += 1
    return dist, row, a, dircode


def _group_outputs(m, dev):
    return (torch.empty((m,), dtype=_F32, device=dev),
            torch.empty((m,), dtype=_I32, device=dev),
            torch.empty((m,), dtype=_F32, device=dev),
            torch.empty((m,), dtype=_I32, device=dev))


group_best_rows.launches = 0


def group_best_rows_culled(o, d, shape_code, inv_r, trf_r, pid, cbb,
                           work=None):
    """K3b: `group_best_rows` with cbb [6, ppad / 128] world boxes of the
    group's 128-prim chunks (empty boxes, min > max, for padding chunks).
    Returns (dist, row, a, dircode), each [M], the brute fold's winners.
    `work`, an int64 [4] CUDA tensor, gets the launch's ray-prim tests,
    (ray, chunk) pairs folded, tests whose shape test passed and ray-box
    tests added to it."""
    m, ppad = o.shape[1], inv_r.shape[1]
    nchunks = ppad // PRIM_CHUNK
    if m % RAY_TILE or ppad % PRIM_CHUNK or shape_code not in SOA_FNS \
            or tuple(cbb.shape) != (6, nchunks):
        raise ValueError(f"K3b: M={m}, ppad={ppad}, shape {shape_code}, "
                         f"boxes {tuple(cbb.shape)}")
    if o.device.type == "cpu":
        return group_best_rows_culled_plain(o, d, shape_code, inv_r, trf_r,
                                            pid, cbb)
    return group_best_culled(o, d, shape_code, inv_r, trf_r, pid, cbb,
                             work=work)


group_best_rows_culled.launches = 0


def group_best_culled(o, d, shape_code, inv_r, trf_r, pid, cbb, work=None):
    """Launch K3b on the inputs of `group_best_rows_culled`, counting the
    launch on that wrapper."""
    m, ppad = o.shape[1], inv_r.shape[1]
    nchunks = ppad // PRIM_CHUNK
    dev = o.device
    check_tensors("K3b", dev, {
        "o": (o, _F32, (3, m)), "d": (d, _F32, (3, m)),
        "inv_r": (inv_r, _F32, (12, ppad)), "trf_r": (trf_r, _F32, (12, ppad)),
        "pid": (pid, _I32, (1, ppad)), "cbb": (cbb, _F32, (6, nchunks))})
    counts = check_work("K3b", work, dev, 4)
    dist, row, a, dircode = _group_outputs(m, dev)
    nsuper = -(-nchunks // GROUP_SUPER)
    sbb = torch.empty((6, nsuper), dtype=_F32, device=dev)
    lib = kernels.trace_kernels_lib()
    with kernels.on_device(dev):
        err = lib.group_best_culled(
            o.data_ptr(), d.data_ptr(), m, inv_r.data_ptr(), trf_r.data_ptr(),
            pid.data_ptr(), ppad, cbb.data_ptr(), sbb.data_ptr(), nsuper,
            int(shape_code), dist.data_ptr(), row.data_ptr(), a.data_ptr(),
            dircode.data_ptr(), counts,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K3b", lib, err)
    group_best_rows_culled.launches += 1
    return dist, row, a, dircode


# --------------------------------------------------------------------------
# K4a: one mesh instance
# --------------------------------------------------------------------------

def mt_chunk(o, d, v):
    """Moller-Trumbore of rays o, d (vec3s of [..., 1]-shaped tensors)
    against triangle rows v (9 tensors broadcasting along the last axis):
    the local parameter a, FLT_MAX where the triangle is not hit."""
    ox, oy, oz = o
    dx, dy, dz = d
    e1x, e1y, e1z = v[3] - v[0], v[4] - v[1], v[5] - v[2]
    e2x, e2y, e2z = v[6] - v[0], v[7] - v[1], v[8] - v[2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    invd = 1.0 / det
    sx, sy, sz = ox - v[0], oy - v[1], oz - v[2]
    u = (sx * hx + sy * hy + sz * hz) * invd
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * invd
    a = (e2x * qx + e2y * qy + e2z * qz) * invd
    valid = ((torch.abs(det) >= _EPS) & (u >= 0.0) & (u <= 1.0)
             & (vv >= 0.0) & (u + vv <= 1.0) & (a > _EPS))
    return torch.where(valid, a, _FMAX)


def _tri_chunk(o, d, tri, c):
    """Chunk c of [9, ppad] triangle rows against rays o, d ([3, m]
    rows): the chunk's first-min (a, index in the chunk) per ray."""
    s = slice(c * PRIM_CHUNK, (c + 1) * PRIM_CHUNK)
    a = mt_chunk(tuple(o[k][:, None] for k in range(3)),
                 tuple(d[k][:, None] for k in range(3)),
                 [tri[r, s][None, :] for r in range(9)])
    return _first_min(a)


def mesh_best_rows_plain(o, d, tri):
    """Plain PyTorch version of K4a (reference `_tri_kernel`): the
    chunked brute fold on `a`, [M, 128] per chunk."""
    m = o.shape[1]
    ba = torch.full((m,), _FMAX, dtype=_F32, device=o.device)
    brow = torch.full((m,), -1, dtype=torch.int64, device=o.device)
    for c in range(tri.shape[1] // PRIM_CHUNK):
        cmin, first = _tri_chunk(o, d, tri, c)
        take = cmin < ba
        ba = torch.where(take, cmin, ba)
        brow = torch.where(take, first + c * PRIM_CHUNK, brow)
    return ba, torch.where(ba < _FMAX, brow, -1).to(_I32)


def super_boxes(cbb):
    """The `sbb=None` case of the reference (pallas_trace.py:665-674):
    cbb padded to a TRI_SUPER multiple with empty boxes, and supers that
    every ray passes. Returns (cbb, sbb)."""
    ncb = cbb.shape[1]
    pad_to = _round_up(ncb, TRI_SUPER)

    def boxes(lo, hi, n):
        col = torch.tensor([lo] * 3 + [hi] * 3, dtype=_F32, device=cbb.device)
        return col[:, None].expand(6, n)

    if pad_to != ncb:
        cbb = torch.cat([cbb, boxes(1.0, -1.0, pad_to - ncb)], dim=1)
    return cbb, boxes(-3e38, 3e38, pad_to // TRI_SUPER).contiguous()


def mesh_best_rows_culled_plain(o, d, tri, cbb, sbb):
    """Plain PyTorch version of K4b (reference `_tri_kernel_culled`): per
    1024-ray tile, super sc runs when some ray of the tile enters
    sbb[:, sc] no farther than its best `a`, and inside it leaf c when
    some ray enters cbb[:, c] so; the leaf's body runs for all rays of the
    tile. A padding leaf (c past the last real chunk) re-tests the last
    real chunk, as the reference's clamp does (:580-590): its box is
    empty, and an equal candidate never replaces the strictly-closer
    winner."""
    m = o.shape[1]
    nreal = tri.shape[1] // PRIM_CHUNK
    super_k = cbb.shape[1] // sbb.shape[1]
    rd = safe_rcp(d)
    ba = torch.full((m,), _FMAX, dtype=_F32, device=o.device)
    brow = torch.full((m,), -1, dtype=torch.int64, device=o.device)
    for sc in range(sbb.shape[1]):
        srays = _tile_rays(_slab_enters(o, rd, sbb[:, sc], ba))
        if srays is None:
            continue
        for j in range(super_k):
            c = sc * super_k + j
            leaf = torch.zeros((m,), dtype=torch.bool, device=o.device)
            leaf[srays] = _slab_enters(o[:, srays], rd[:, srays], cbb[:, c],
                                       ba[srays])
            rays = _tile_rays(leaf)
            if rays is None:
                continue
            cc = min(c, nreal - 1)
            cmin, first = _tri_chunk(o[:, rays], d[:, rays], tri, cc)
            take = cmin < ba[rays]
            ba[rays] = torch.where(take, cmin, ba[rays])
            brow[rays] = torch.where(take, first + cc * PRIM_CHUNK,
                                     brow[rays])
    return ba, torch.where(ba < _FMAX, brow, -1).to(_I32)


def mesh_best_rows(o, d, tri, cbb=None, sbb=None, work=None):
    """K4a: o, d [3, M] mesh-local ray rows (M a multiple of RAY_TILE,
    unit directions), tri [9, ppad] from `pad_tris`. Returns (a, row),
    each [M]. `work` as for `group_best_rows`. With leaf boxes `cbb` (and
    super boxes `sbb`, or None) this is `mesh_best_rows_culled` (K4b);
    without them `sbb` is not read, as in the reference."""
    if cbb is not None:
        return mesh_best_rows_culled(o, d, tri, cbb, sbb, work=work)
    if o.device.type == "cpu":
        return mesh_best_rows_plain(o, d, tri)
    m, ppad = o.shape[1], tri.shape[1]
    if m % RAY_TILE or ppad % PRIM_CHUNK:
        raise ValueError(f"K4a: M={m}, ppad={ppad}")
    dev = o.device
    check_tensors("K4a", dev, {
        "o": (o, _F32, (3, m)), "d": (d, _F32, (3, m)),
        "tri": (tri, _F32, (9, ppad))})
    counts = check_work("K4a", work, dev)
    a = torch.empty((m,), dtype=_F32, device=dev)
    row = torch.empty((m,), dtype=_I32, device=dev)
    lib = kernels.trace_kernels_lib()
    with kernels.on_device(dev):
        err = lib.mesh_best(
            o.data_ptr(), d.data_ptr(), m, tri.data_ptr(), ppad, a.data_ptr(),
            row.data_ptr(), counts, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K4a", lib, err)
    mesh_best_rows.launches += 1
    return a, row


mesh_best_rows.launches = 0


def trace_kernel_info(kernel: str, shape_code: int = 1) -> dict:
    """The compiled K3a, K3b or K5 (of `shape_code`), K4a, K4b or K6, from
    the CUDA runtime: registers and local memory (spill) bytes a thread,
    static shared memory a block, resident blocks per SM, threads a block
    and lanes a ray. Needs the card."""
    lib = kernels.trace_kernels_lib()
    out = (ctypes.c_int * 6)()
    kid = {"K3a": 0, "K4a": 1, "K3b": 2, "K6": 3, "K4b": 4, "K5": 5}[kernel]
    err = lib.trace_kernel_info(kid, int(shape_code), out)
    raise_on_error(kernel, lib, err)
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "threads", "lanes"), out))


def mesh_best_rows_culled(o, d, tri, cbb, sbb=None, work=None):
    """K4b: `mesh_best_rows` with cbb [6, TRI_SUPER * nsuper] mesh-local
    leaf boxes of the instance's 128-triangle chunks (empty boxes past
    the last real chunk) and sbb [6, nsuper] super boxes; sbb None makes
    `super_boxes`. Returns (a, row), each [M], the brute fold's winners.
    `work`, an int64 [5] CUDA tensor, gets the launch's ray-triangle
    tests (over a ray's lanes), (ray, leaf chunk) pairs folded, triangles
    hit, ray-box tests and (ray, super) pairs entered added to it."""
    if sbb is None:
        cbb, sbb = super_boxes(cbb)
    m, ppad = o.shape[1], tri.shape[1]
    nsuper = sbb.shape[1]
    if m % RAY_TILE or ppad % PRIM_CHUNK or sbb.shape[0] != 6 \
            or tuple(cbb.shape) != (6, TRI_SUPER * nsuper) \
            or ppad // PRIM_CHUNK > cbb.shape[1]:
        raise ValueError(f"K4b: M={m}, ppad={ppad}, leaf boxes "
                         f"{tuple(cbb.shape)}, super boxes "
                         f"{tuple(sbb.shape)}")
    if o.device.type == "cpu":
        return mesh_best_rows_culled_plain(o, d, tri, cbb, sbb)
    return mesh_best_culled(o, d, tri, cbb, sbb, work=work)


mesh_best_rows_culled.launches = 0


def mesh_best_culled(o, d, tri, cbb, sbb, work=None, lanes=None):
    """Launch K4b on the inputs of `mesh_best_rows_culled` (super boxes
    made), counting the launch on that wrapper: each ray gated on its own
    best through the supers and leaves, `lanes` (4, 8 or 16; None: the
    kernel's TRI_LANES) lanes a ray. The kernel first stages the
    triangles (corner and edges) into a scratch buffer allocated here."""
    m, ppad = o.shape[1], tri.shape[1]
    nsuper = sbb.shape[1]
    dev = o.device
    check_tensors("K4b", dev, {
        "o": (o, _F32, (3, m)), "d": (d, _F32, (3, m)),
        "tri": (tri, _F32, (9, ppad)),
        "cbb": (cbb, _F32, (6, TRI_SUPER * nsuper)),
        "sbb": (sbb, _F32, (6, nsuper))})
    counts = check_work("K4b", work, dev, 5)
    if lanes not in (None, 4, 8, 16):
        raise ValueError(f"K4b: {lanes} lanes a ray")
    a = torch.empty((m,), dtype=_F32, device=dev)
    row = torch.empty((m,), dtype=_I32, device=dev)
    staged = torch.empty((ppad, 12), dtype=_F32, device=dev)
    lib = kernels.trace_kernels_lib()
    with kernels.on_device(dev):
        err = lib.mesh_best_culled(
            o.data_ptr(), d.data_ptr(), m, tri.data_ptr(), ppad,
            cbb.data_ptr(), sbb.data_ptr(), nsuper, staged.data_ptr(),
            lanes or 0, a.data_ptr(), row.data_ptr(), counts,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K4b", lib, err)
    mesh_best_rows_culled.launches += 1
    return a, row


# --------------------------------------------------------------------------
# AoS wrappers: K3a and K4a folded into the dense trace's Hit record
# (ops/trace.trace with use_kernels), the reference's :440-495, :717-749
# --------------------------------------------------------------------------

def _ray_rows(O, D):
    """[N, 3] rays -> contiguous [3, npad] rows, npad a RAY_TILE multiple;
    the padding rays (origin 0, direction unit z) are sliced off after
    the launch."""
    n = O.shape[0]
    npad = _round_up(n, RAY_TILE)
    o = torch.zeros((3, npad), dtype=_F32, device=O.device)
    d = torch.zeros((3, npad), dtype=_F32, device=O.device)
    d[2] = 1.0
    o[:, :n] = O.T
    d[:, :n] = D.T
    return o, d


def _group_best(O, D, shape_code, transfo, inv, prim_idx):
    """K3a's (dist, row, a, dircode), each [N], of world rays O, D [N, 3]
    against one group's [P, 4, 4] tables. The kernel is reached through
    the ops/trace module's `group_best_rows`, as trace_soa reaches it, so
    that a caller who replaces that attribute sees these launches too."""
    from . import trace as trace_mod
    n = O.shape[0]
    o, d = _ray_rows(O, D)
    inv_r, trf_r, pid = _pad_group(transfo, inv, prim_idx)
    dist, row, a, dircode = trace_mod.group_best_rows(
        o, d, shape_code, inv_r, trf_r, pid)
    return dist[:n], row[:n], a[:n], dircode[:n]


def trace_analytic_group_pallas(best, O, D, shape_code, transfo, inv,
                                prim_idx):
    """intersect.trace_analytic_group through K3a: fold one group into
    the running best Hit. The winner's local and world hit points are
    rebuilt outside the kernel from its group row ([N] gathers instead
    of [N, C, 3] blocks)."""
    dist, row, a, dircode = _group_best(O, D, shape_code, transfo, inv,
                                        prim_idx)
    ok = row >= 0
    r = torch.where(ok, row, 0).long()
    inv_w = inv[r]                                   # [N,4,4]
    trf_w = transfo[r]
    pid_w = torch.where(ok, prim_idx[r], -1).to(_I32)
    oi = transform_point(inv_w, O)
    di = normalize(transform_dir(inv_w, D))
    plh = oi + a[:, None] * di
    pgh = transform_point(trf_w, plh)
    cand = Hit(dist=torch.where(ok, dist, _FMAX), pl=plh, pg=pgh,
               prim=pid_w, shape=torch.where(ok, shape_code, -1).to(_I32),
               dircode=dircode,
               tri=torch.full(dist.shape, -1, dtype=_I32, device=O.device))
    return _better(best, cand)


def _mesh_best(Oi, Di, va, vb, vc):
    """K4a's (a, row), each [N], of mesh-local rays Oi, Di [N, 3] (Di
    unit) against one instance's [P, 3] corners; reached through the
    ops/trace module as `_group_best` reaches K3a."""
    from . import trace as trace_mod
    n = Oi.shape[0]
    o, d = _ray_rows(Oi, Di)
    a, row = trace_mod.mesh_best_rows(o, d, pad_tris(va, vb, vc))
    return a[:n], row[:n]


def trace_mesh_instance_pallas(best, O, D, inv, mesh_transfo,
                               prim_index: int, va, vb, vc,
                               tri_offset: int):
    """intersect.trace_mesh_instance through K4a."""
    Oi = transform_point(inv, O)
    Di = normalize(transform_dir(inv, D))
    a, row = _mesh_best(Oi, Di, va, vb, vc)
    ok = row >= 0
    plh = Oi + a[:, None] * Di
    pgh = transform_point(mesh_transfo, plh)
    dist = length3(O - pgh)
    cand = Hit(dist=torch.where(ok, dist, _FMAX), pl=plh, pg=pgh,
               prim=torch.where(ok, prim_index, -1).to(_I32),
               shape=torch.where(ok, CODE_MESH, -1).to(_I32),
               dircode=torch.zeros(a.shape, dtype=_I32, device=O.device),
               tri=torch.where(ok, tri_offset + row, -1).to(_I32))
    return _better(best, cand)
