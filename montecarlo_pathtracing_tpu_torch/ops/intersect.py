"""Ray/primitive intersection: the dense formulation (the dense route).

Port of montecarlo_pathtracing_tpu/ops/intersect.py. Semantics match the
reference GLSL intersectors (shaders/raytracer_func.frag:354-705): every
primitive is intersected in its canonical local frame (ray mapped by the
inverse transform, direction re-normalized), and the winning hit is
chosen by WORLD-space distance |O_world - P_world| because local scales
differ per primitive.

Rays are [N, 3] tensors. A homogeneous type group is folded chunk by
chunk: each chunk intersects every ray with every prim of the chunk as
[N, C] blocks, takes the per-ray arg-min (`torch.argmin`, the first
minimum, as `jnp.argmin`), and folds it into the running best with a
strictly-closer compare, chunks in ascending order (a Python loop where
the reference has `lax.scan`). The trace kernels' wrappers
(ops/pallas_trace.trace_*_pallas) fold into the same `Hit` record.

Reference quirks preserved on purpose (the quirks are the spec):
  - OrientedQuad is one-sided (rejects D.z > -EPS) and has NO a>0 check
    (raytracer_func.frag:443-470).
  - Cylinder side uses only the near quadratic root (:549).
  - Cone has the fixed 0.8 half-angle factor and no t>EPS check on the
    side roots (:599-621).
  - EPSILON = 1e-10, strict/nonstrict comparisons as in the GLSL.

The dense trace is differentiated (the IOR gradient's geometric term
flows through refraction exit points into these tests), so every sqrt
and division whose untaken branch could be infinite is where-guarded
twice (`_safe_sqrt`, `_safe_div`): `torch.where`, like `jnp.where`, lets
an untaken branch's inf turn into a NaN gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.transforms import (
    cross3, dot3, length3, normalize, transform_dir, transform_point)

EPSILON = np.float32(1e-10)
FLT_MAX = np.float32(3.402823e38)

_EPS = float(EPSILON)
_FMAX = float(FLT_MAX)

# primitive type codes (raytracer_func.frag:38-43)
CODE_MESH = 0
CODE_SPHERE = 1
CODE_CUBE = 2
CODE_CYLINDER = 3
CODE_CONE = 4
CODE_ORIENTED_QUAD = 5


def _safe_sqrt(x, pos):
    """sqrt guarded for reverse mode: d(sqrt)/dx is infinite at x == 0.
    `pos` is the mask under which the value is consumed; guarded lanes
    return 0, what sqrt(max(x, 0)) gives there."""
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _safe_div(num, den, ok):
    """num/den with the denominator guarded to 1 outside `ok` (the mask
    that already excludes den ~ 0): forward-identical where consumed,
    and 1/0 = inf stays out of the backward pass."""
    return num / torch.where(ok, den, 1.0)


class Hit(NamedTuple):
    """Closest-intersection record, one per ray (sInter analog,
    raytracer_func.frag:257-267). All tensors share leading ray dims."""
    dist: torch.Tensor      # world distance, FLT_MAX if miss
    pl: torch.Tensor        # local-frame hit point [..., 3]
    pg: torch.Tensor        # world-frame hit point [..., 3]
    prim: torch.Tensor      # primitive index, -1 if miss (int32)
    shape: torch.Tensor     # type code, -1 if miss (int32)
    dircode: torch.Tensor   # face code for cube/cyl/cone (int32)
    tri: torch.Tensor       # global triangle index for mesh hits (int32)

    @property
    def is_hit(self):
        return self.shape >= 0


def miss_hit(shape_prefix, device):
    z3 = torch.zeros(tuple(shape_prefix) + (3,), dtype=torch.float32,
                     device=device)
    mi = torch.full(tuple(shape_prefix), -1, dtype=torch.int32,
                    device=device)
    return Hit(dist=torch.full(tuple(shape_prefix), _FMAX,
                               dtype=torch.float32, device=device),
               pl=z3, pg=z3, prim=mi, shape=mi, dircode=mi, tri=mi)


def _codes(like, value):
    return torch.full(like.shape, value, dtype=torch.int32,
                      device=like.device)


# ---------------------------------------------------------------------------
# Local-frame shape tests. Each takes local O, D ([..., 3], D normalized)
# and returns (a, valid, dircode): ray parameter along D, hit mask, face code.
# ---------------------------------------------------------------------------

def sphere_local(O, D):
    """Unit sphere, both roots (raytracer_func.frag:398-441)."""
    OO = dot3(O, O)
    OD = dot3(O, D)
    D2 = dot3(D, D)
    delta4 = OD * OD - D2 * (OO - 1.0)
    ok = delta4 > 0.0
    sq = _safe_sqrt(delta4, ok)
    a1 = -(OD + sq) / D2
    a2 = -(OD - sq) / D2
    v1 = ok & (a1 > _EPS)
    v2 = ok & (a2 > _EPS)
    a = torch.where(v1, a1, torch.where(v2, a2, _FMAX))
    return a, v1 | v2, _codes(a, 0)


def quad_local(O, D):
    """One-sided unit quad at z=0 (raytracer_func.frag:443-470).
    Quirk: no positivity check on a."""
    facing = D[..., 2] <= -_EPS
    a = _safe_div(-O[..., 2], D[..., 2], facing)
    px = O[..., 0] + a * D[..., 0]
    py = O[..., 1] + a * D[..., 1]
    inside = (torch.abs(px) <= 1.0) & (torch.abs(py) <= 1.0)
    valid = facing & inside
    return torch.where(valid, a, _FMAX), valid, _codes(a, 0)


def _slab6(O, D):
    """Shared 6-face slab test for the unit cube (also used by the BV test).
    Returns (a_min, face, any_valid)."""
    al = torch.full(O.shape[:-1], _FMAX, dtype=torch.float32,
                    device=O.device)
    face = _codes(al, 0)
    for c in range(6):
        c0 = c // 2
        c1 = (c0 + 1) % 3
        c2 = (c0 + 2) % 3
        cd = -1.0 + 2.0 * (c % 2)
        dc = D[..., c0]
        dc_ok = torch.abs(dc) > _EPS
        a = _safe_div(cd - O[..., c0], dc, dc_ok)
        v = (dc_ok
             & (a > _EPS)
             & (torch.abs(O[..., c1] + a * D[..., c1]) <= 1.0)
             & (torch.abs(O[..., c2] + a * D[..., c2]) <= 1.0)
             & (a < al))
        al = torch.where(v, a, al)
        face = torch.where(v, c, face)
    return al, face, al < _FMAX


def cube_local(O, D):
    """Unit cube via 6 slabs (raytracer_func.frag:472-512)."""
    al, face, valid = _slab6(O, D)
    return al, valid, face


def cylinder_local(O, D):
    """Unit z-cylinder: caps then side, near root only
    (raytracer_func.frag:515-577)."""
    al = torch.full(O.shape[:-1], _FMAX, dtype=torch.float32,
                    device=O.device)
    cl = _codes(al, -1)
    dz_ok = torch.abs(D[..., 2]) > _EPS
    for code, zplane in ((0, -1.0), (1, 1.0)):
        a = _safe_div(zplane - O[..., 2], D[..., 2], dz_ok)
        rx = O[..., 0] + a * D[..., 0]
        ry = O[..., 1] + a * D[..., 1]
        v = dz_ok & (a > _EPS) & (rx * rx + ry * ry < 1.0) & (a < al)
        al = torch.where(v, a, al)
        cl = torch.where(v, code, cl)
    O2 = O[..., 0] ** 2 + O[..., 1] ** 2
    OD = O[..., 0] * D[..., 0] + O[..., 1] * D[..., 1]
    D2 = D[..., 0] ** 2 + D[..., 1] ** 2
    delta4 = OD * OD - D2 * (O2 - 1.0)
    pos = delta4 > 0.0
    a = _safe_div(-(OD + _safe_sqrt(delta4, pos)), D2, pos)
    z = O[..., 2] + a * D[..., 2]
    v = pos & (a > _EPS) & (a < al) & (torch.abs(z) < 1.0)
    al = torch.where(v, a, al)
    cl = torch.where(v, 2, cl)
    return al, al < _FMAX, cl


def cone_local(O, D):
    """Unit cone, apex at z=1, 0.8 slope factor
    (raytracer_func.frag:579-640). Quirk: side roots have no t>EPS check."""
    tl = torch.full(O.shape[:-1], _FMAX, dtype=torch.float32,
                    device=O.device)
    cl = _codes(tl, -1)
    # bottom cap
    dz_ok = torch.abs(D[..., 2]) > _EPS
    t0 = _safe_div(-1.0 - O[..., 2], D[..., 2], dz_ok)
    rx = O[..., 0] + t0 * D[..., 0]
    ry = O[..., 1] + t0 * D[..., 1]
    v = dz_ok & (t0 > _EPS) & (rx * rx + ry * ry < 1.0) & (t0 < tl)
    tl = torch.where(v, t0, tl)
    cl = torch.where(v, 0, cl)
    # side
    coz = O[..., 2] - 1.0
    dco = D[..., 0] * O[..., 0] + D[..., 1] * O[..., 1] + D[..., 2] * coz
    coco = O[..., 0] ** 2 + O[..., 1] ** 2 + coz * coz
    k = float(np.float32(0.8))
    a = D[..., 2] * D[..., 2] - k
    b = 2.0 * (D[..., 2] * coz - dco * k)
    c = coz * coz - coco * k
    det = b * b - 4.0 * a * c
    pos = det > 0.0
    sq = _safe_sqrt(det, pos)
    # guard only on det > 0: the reference divides by 2a unguarded (a == 0
    # means dz^2 == 0.8 exactly), so keep that forward behavior bit-exact
    t1 = _safe_div(-b - sq, 2.0 * a, pos)
    t2 = _safe_div(-b + sq, 2.0 * a, pos)
    t1 = torch.where(torch.abs(O[..., 2] + t1 * D[..., 2]) > 1.0, _FMAX, t1)
    t2 = torch.where(torch.abs(O[..., 2] + t2 * D[..., 2]) > 1.0, _FMAX, t2)
    t = torch.minimum(t1, t2)
    v = pos & (t < tl)
    tl = torch.where(v, t, tl)
    cl = torch.where(v, 2, cl)
    return tl, tl < _FMAX, cl


SHAPE_FNS = {
    CODE_SPHERE: sphere_local,
    CODE_CUBE: cube_local,
    CODE_CYLINDER: cylinder_local,
    CODE_CONE: cone_local,
    CODE_ORIENTED_QUAD: quad_local,
}


def triangle_batch(O, D, va, vb, vc):
    """Moller-Trumbore over a triangle chunk
    (raytracer_func.frag:354-396). O, D: [N, 3] mesh-local (D normalized);
    va/vb/vc: [C, 3]. Returns (a [N, C], valid [N, C])."""
    edge1 = vb - va                                      # [C,3]
    edge2 = vc - va
    h = cross3(D[:, None, :], edge2[None, :, :])         # [N,C,3]
    det = dot3(edge1[None], h)                           # [N,C]
    det_ok = torch.abs(det) >= _EPS
    inv_det = _safe_div(torch.ones_like(det), det, det_ok)
    s = O[:, None, :] - va[None]                         # [N,C,3]
    u = dot3(s, h) * inv_det
    del h
    q = cross3(s, edge1[None, :, :])
    del s
    v = dot3(D[:, None, :], q) * inv_det
    a = dot3(edge2[None], q) * inv_det
    del q
    valid = (det_ok
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (a > _EPS))
    return torch.where(valid, a, _FMAX), valid


# ---------------------------------------------------------------------------
# Dense typed-batch trace
# ---------------------------------------------------------------------------

def _local_rays(inv_c, O, D):
    """Map world rays into each primitive's local frame.

    inv_c: [C,4,4]; O, D: [N,3]. Returns Oi, Di (normalized): [N,C,3]
    (intersect_prim analog, raytracer_func.frag:686-688)."""
    Oi = transform_point(inv_c, O[:, None, :])
    Di = transform_dir(inv_c, D[:, None, :])
    return Oi, normalize(Di)


def _better(best: Hit, cand: Hit) -> Hit:
    take = cand.dist < best.dist
    t3 = take[..., None]
    return Hit(
        dist=torch.where(take, cand.dist, best.dist),
        pl=torch.where(t3, cand.pl, best.pl),
        pg=torch.where(t3, cand.pg, best.pg),
        prim=torch.where(take, cand.prim, best.prim),
        shape=torch.where(take, cand.shape, best.shape),
        dircode=torch.where(take, cand.dircode, best.dircode),
        tri=torch.where(take, cand.tri, best.tri),
    )


def _safe_dist(O, pg, valid):
    """World distance |O - pg| of rays O [N,3] to the hit points pg
    [N,C,3], FLT_MAX where not `valid`. The difference is where-guarded
    before the norm: an invalid candidate's pg comes from a = FLT_MAX and
    may overflow to inf, and the norm's backward would turn its zero
    cotangent into 0 * inf = NaN (the reference's jnp.linalg.norm does,
    so its hit distance has no finite gradient). Forward-identical."""
    diff = torch.where(valid[..., None], O[:, None, :] - pg, 1.0)
    return torch.where(valid, length3(diff), _FMAX)


def _chunk_winner(dist):
    """Per-ray first arg-min of a [N, C] block: (ray index, column)."""
    j = torch.argmin(dist, dim=1)
    return torch.arange(dist.shape[0], device=dist.device), j


def trace_analytic_group(best: Hit, O, D, shape_code: int,
                         transfo, inv, prim_idx, chunk: int) -> Hit:
    """Fold one homogeneous type group into the running best hit.

    transfo/inv: [P,4,4] (P a multiple of `chunk`), prim_idx: [P] int32
    with -1 padding. O, D: [N,3] world rays.
    """
    fn = SHAPE_FNS[shape_code]
    n = O.shape[0]
    for k in range(transfo.shape[0] // chunk):
        s = slice(k * chunk, (k + 1) * chunk)
        trf_c, idx_c = transfo[s], prim_idx[s]
        Oi, Di = _local_rays(inv[s], O, D)             # [N,C,3]
        a, valid, dircode = fn(Oi, Di)                 # [N,C]
        valid = valid & (idx_c >= 0)[None, :]
        pl = Oi + a[..., None] * Di
        del Oi, Di
        pg = transform_point(trf_c, pl)
        dist = _safe_dist(O, pg, valid)
        n_ix, j = _chunk_winner(dist)
        cand = Hit(
            dist=dist[n_ix, j],
            pl=pl[n_ix, j],
            pg=pg[n_ix, j],
            prim=idx_c[j],
            shape=torch.full((n,), shape_code, dtype=torch.int32,
                             device=O.device),
            dircode=dircode[n_ix, j],
            tri=torch.full((n,), -1, dtype=torch.int32, device=O.device),
        )
        del pl, pg, dist, a, valid, dircode
        best = _better(best, cand)
    return best


def trace_mesh_instance(best: Hit, O, D, inv, mesh_transfo, prim_index: int,
                        va, vb, vc, tri_offset: int, chunk: int) -> Hit:
    """Fold one mesh instance (all its triangles) into the running best.

    inv / mesh_transfo: [4,4] single matrices for this instance
    (Mesh_intersect analog, raytracer_func.frag:642-678 — rays move to
    mesh-local space once, hits map back through the mesh transform, and
    the distance compare stays in world space).
    va/vb/vc: [T,3] padded to chunk multiple (padding = degenerate tris).
    """
    Oi = transform_point(inv, O)
    Di = normalize(transform_dir(inv, D))
    n = O.shape[0]
    for k in range(va.shape[0] // chunk):
        s = slice(k * chunk, (k + 1) * chunk)
        a, valid = triangle_batch(Oi, Di, va[s], vb[s], vc[s])   # [N,C]
        pl = Oi[:, None, :] + a[..., None] * Di[:, None, :]
        pg = transform_point(mesh_transfo, pl)
        dist = _safe_dist(O, pg, valid)
        n_ix, j = _chunk_winner(dist)
        cand = Hit(
            dist=dist[n_ix, j],
            pl=pl[n_ix, j],
            pg=pg[n_ix, j],
            prim=torch.full((n,), prim_index, dtype=torch.int32,
                            device=O.device),
            shape=torch.full((n,), CODE_MESH, dtype=torch.int32,
                             device=O.device),
            dircode=torch.zeros((n,), dtype=torch.int32, device=O.device),
            tri=(tri_offset + k * chunk + j).to(torch.int32),
        )
        del pl, pg, dist, a, valid
        best = _better(best, cand)
    return best
