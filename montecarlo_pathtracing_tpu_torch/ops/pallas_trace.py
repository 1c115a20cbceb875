"""Brute-force trace kernels: closest hit of a ray set against one
analytic group (K3a) or one mesh instance (K4a).

Port of the host side of montecarlo_pathtracing_tpu/ops/pallas_trace.py:
the padded tables (`_pad_group`, `pad_tris`) and the wrappers
`group_best_rows` and `mesh_best_rows` of the TPU kernels
`_group_kernel_plain` (:162) and `_tri_kernel` (:497). Their CUDA
counterparts are in csrc/trace_kernels.cu.

  - `group_best_rows` (K3a): world rays o, d [3, M] (unit directions)
    against a homogeneous analytic group given as [12, ppad] inverse and
    forward affine rows and [1, ppad] scene ids (-1 = padding, never
    hits). Returns (dist, group row, local a, dircode), each [M]: the
    strictly-closer fold on world distance in ascending prim order, row
    -1, a 0 and dircode -1 where nothing is hit.
  - `mesh_best_rows` (K4a): mesh-local unit rays against [9, ppad]
    triangle corner rows, Moller-Trumbore folded on the local parameter
    `a` (monotone in world distance inside one instance). Returns (a,
    row), a = FLT_MAX and row -1 on a miss.

Each wrapper runs its plain PyTorch version (`*_plain`, the chunked
brute fold of the TPU kernel: [M, 128] per chunk, first minimum inside a
chunk, strictly closer across chunks) on CPU tensors, and launches its
kernel on CUDA tensors, counting the launch in `.launches`; it raises
otherwise, and never falls back. The culled variants of the TPU kernels
(`_group_kernel_culled`, `_tri_kernel_culled`: K3b and K4b) are not
ported yet: a caller that passes chunk boxes gets NotImplementedError
naming their ROADMAP items.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .intersect import EPSILON, FLT_MAX
from .shapes import SOA_FNS
from .vec import affine_rows

RAY_TILE = 1024     # rays per tile (the TPU kernels' grid step)
PRIM_CHUNK = 128    # prims or triangles per chunk

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


def check_work(kernel: str, work, dev):
    """The optional work counters: an int64 [3] tensor on `dev` (tests
    done, chunks or blocks visited, tests that hit), or None."""
    if work is None:
        return ctypes.c_void_p(0)
    if work.device != dev or work.dtype != torch.int64 \
            or tuple(work.shape) != (3,):
        raise ValueError(f"{kernel} work counters: want an int64 [3] "
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


def group_best_rows_plain(o, d, shape_code, inv_r, trf_r, pid):
    """Plain PyTorch version of K3a (reference `_group_kernel_plain`):
    the chunked brute fold, [M, 128] per chunk."""
    fn = SOA_FNS[shape_code]
    m = o.shape[1]
    ox, oy, oz = (o[c][:, None] for c in range(3))
    dx, dy, dz = (d[c][:, None] for c in range(3))
    bd = torch.full((m,), _FMAX, dtype=_F32, device=o.device)
    brow = torch.full((m,), -1, dtype=torch.int64, device=o.device)
    ba = torch.zeros((m,), dtype=_F32, device=o.device)
    bdir = torch.full((m,), -1, dtype=_I32, device=o.device)
    for c in range(inv_r.shape[1] // PRIM_CHUNK):
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
        a, valid, dircode = fn(lox, loy, loz, ldx, ldy, ldz)  # [M, C]
        valid = valid & (pid[0, s][None, :] >= 0)
        plx, ply, plz = lox + a * ldx, loy + a * ldy, loz + a * ldz
        pgx = trf[0] * plx + trf[1] * ply + trf[2] * plz + trf[3]
        pgy = trf[4] * plx + trf[5] * ply + trf[6] * plz + trf[7]
        pgz = trf[8] * plx + trf[9] * ply + trf[10] * plz + trf[11]
        ex, ey, ez = ox - pgx, oy - pgy, oz - pgz
        dist = torch.where(valid, torch.sqrt(ex * ex + ey * ey + ez * ez),
                           _FMAX)
        cmin, first = _first_min(dist)
        take = cmin < bd
        bd = torch.where(take, cmin, bd)
        brow = torch.where(take, first + c * PRIM_CHUNK, brow)
        ba = torch.where(take, _pick(a, first, 0.0), ba)
        bdir = torch.where(take, _pick(dircode, first, 0), bdir)
    row = torch.where(bd < _FMAX, brow, -1).to(_I32)
    return bd, row, ba, bdir


def group_best_rows(o, d, shape_code, inv_r, trf_r, pid, cbb=None,
                    work=None):
    """K3a: o, d [3, M] world ray rows (M a multiple of RAY_TILE, unit
    directions), the padded tables of `_pad_group`. Returns (dist, row,
    a, dircode), each [M]. `work`, an int64 [3] CUDA tensor, gets the
    launch's ray-prim tests, 128-prim chunks visited per block and tests
    whose shape test passed added to it."""
    if cbb is not None:
        raise NotImplementedError(
            "the culled group kernel (K3b, pallas_trace._group_kernel_culled)"
            " is not ported yet: ROADMAP B.K3b")
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
    dist = torch.empty((m,), dtype=_F32, device=dev)
    row = torch.empty((m,), dtype=_I32, device=dev)
    a = torch.empty((m,), dtype=_F32, device=dev)
    dircode = torch.empty((m,), dtype=_I32, device=dev)
    lib = kernels.trace_kernels_lib()
    err = lib.group_best(
        o.data_ptr(), d.data_ptr(), m, inv_r.data_ptr(), trf_r.data_ptr(),
        pid.data_ptr(), ppad, int(shape_code), dist.data_ptr(),
        row.data_ptr(), a.data_ptr(), dircode.data_ptr(), counts,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K3a", lib, err)
    group_best_rows.launches += 1
    return dist, row, a, dircode


group_best_rows.launches = 0


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


def mesh_best_rows_plain(o, d, tri):
    """Plain PyTorch version of K4a (reference `_tri_kernel`): the
    chunked brute fold on `a`, [M, 128] per chunk."""
    m = o.shape[1]
    oc = tuple(o[c][:, None] for c in range(3))
    dc = tuple(d[c][:, None] for c in range(3))
    ba = torch.full((m,), _FMAX, dtype=_F32, device=o.device)
    brow = torch.full((m,), -1, dtype=torch.int64, device=o.device)
    for c in range(tri.shape[1] // PRIM_CHUNK):
        s = slice(c * PRIM_CHUNK, (c + 1) * PRIM_CHUNK)
        a = mt_chunk(oc, dc, [tri[r, s][None, :] for r in range(9)])
        cmin, first = _first_min(a)
        take = cmin < ba
        ba = torch.where(take, cmin, ba)
        brow = torch.where(take, first + c * PRIM_CHUNK, brow)
    return ba, torch.where(ba < _FMAX, brow, -1).to(_I32)


def mesh_best_rows(o, d, tri, cbb=None, sbb=None, work=None):
    """K4a: o, d [3, M] mesh-local ray rows (M a multiple of RAY_TILE,
    unit directions), tri [9, ppad] from `pad_tris`. Returns (a, row),
    each [M]. `work` as for `group_best_rows`."""
    if cbb is not None or sbb is not None:
        raise NotImplementedError(
            "the culled triangle kernel (K4b, pallas_trace._tri_kernel_culled)"
            " is not ported yet: ROADMAP B.K4b")
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
    err = lib.mesh_best(
        o.data_ptr(), d.data_ptr(), m, tri.data_ptr(), ppad, a.data_ptr(),
        row.data_ptr(), counts, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("K4a", lib, err)
    mesh_best_rows.launches += 1
    return a, row


mesh_best_rows.launches = 0
