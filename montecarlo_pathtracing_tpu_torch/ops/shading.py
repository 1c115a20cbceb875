"""Shading-normal reconstruction of a hit record (intersection_info).

Port of montecarlo_pathtracing_tpu/ops/shading.py: the AoS form
(`intersection_info`, the dense route and the AoS integrator) and the SoA
form (`intersection_info_soa`, the SoA integrator). The reference's
construction is kept literally (raytracer_func.frag:783-897):

    N = normalize( (transfo * (pl + No_local)).xyz - Pg )

with the local offset No pushed through the prim's affine transform by
point differencing; the cone's top "cap" (face code 1) gives N = 0; mesh
normals are the area-weighted blend of the vertex normals, or with
`flat_face` the face normal cross(B - A, C - A); on a miss the previous
N, P are kept (the refraction re-trace relies on that,
tp/montecarlo.frag:150-152).

The SoA form keeps the row-matrix math in [k, M] form as in the
reference (one gather of a [24, P] or [18, T] table per call, then 2-D
ops).
"""
from __future__ import annotations

import torch

from . import vec
from .intersect import CODE_MESH, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, \
    CODE_CONE
from ..utils.transforms import cross3, length3, normalize, transform_point


def _axis_offset(dircode):
    """No for cube faces: unit vector along axis dir/2, sign from dir%2
    (raytracer_func.frag:820-827)."""
    ax = dircode // 2
    sg = torch.where(dircode % 2 != 0, 1.0, -1.0)
    return torch.stack([torch.where(ax == c, sg, 0.0) for c in range(3)],
                       dim=-1)


def intersection_info(scene, hit, prev_n=None, prev_p=None):
    """Returns (N [*,3], P [*,3]) world shading normal and hit point of
    an ops.intersect.Hit.

    prev_n/prev_p: values to keep where hit.shape < 0 (stale-output GLSL
    semantics); default zero-vectors.
    """
    prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1).long()
    trf = scene.transfo[prim]                            # [*,4,4]
    pl = hit.pl
    pg = hit.pg
    zero = torch.zeros_like(pl[..., 0])
    dircode = hit.dircode

    # --- analytic local offsets -----------------------------------------
    no_cube = _axis_offset(dircode)
    # cylinder: caps -> +-z by dir%2; side -> (pl.xy, 0)
    cap = dircode < 2
    no_cyl = torch.where(
        cap[..., None],
        torch.stack([zero, zero,
                     torch.where(dircode % 2 != 0, 1.0, -1.0)], -1),
        torch.stack([pl[..., 0], pl[..., 1], zero], -1))
    # cone: dir 0 bottom cap -> pl + (0,0,-1); dir 2 side -> (pl.xy, len/2)
    rxy = torch.sqrt(pl[..., 0] ** 2 + pl[..., 1] ** 2)
    no_cone = torch.where(
        (dircode == 0)[..., None],
        torch.stack([zero, zero, torch.full_like(rxy, -1.0)], -1),
        torch.stack([pl[..., 0], pl[..., 1], rxy / 2.0], -1))
    no_quad = torch.stack([zero, zero, torch.ones_like(zero)], -1)

    shape = hit.shape
    # sphere uses trf*(2*pl) - Pg; the others use trf*(pl + No) - Pg
    point = torch.where(
        (shape == CODE_SPHERE)[..., None], 2.0 * pl,
        pl + torch.where(
            (shape == CODE_CUBE)[..., None], no_cube,
            torch.where(
                (shape == CODE_CYLINDER)[..., None], no_cyl,
                torch.where((shape == CODE_CONE)[..., None], no_cone,
                            no_quad))))
    n_analytic = normalize(transform_point(trf, point) - pg)
    # cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
    cone_zero = (shape == CODE_CONE) & (dircode == 1)
    n_analytic = torch.where(cone_zero[..., None], 0.0, n_analytic)

    # --- mesh normals ----------------------------------------------------
    if scene.tri_va.shape[0] > 0:
        tri = torch.clamp(hit.tri, 0, scene.tri_va.shape[0] - 1).long()
        A, B, C = scene.tri_va[tri], scene.tri_vb[tri], scene.tri_vc[tri]
        mtrf = scene.mesh_transfo[prim]
        if scene.flat_face:
            no_mesh = cross3(B - A, C - A)
        else:
            PA, PB, PC = A - pl, B - pl, C - pl
            tA = length3(cross3(PB, PC))[..., None]
            tB = length3(cross3(PA, PC))[..., None]
            tC = length3(cross3(PA, PB))[..., None]
            no_mesh = (scene.tri_na[tri] * tA + scene.tri_nb[tri] * tB
                       + scene.tri_nc[tri] * tC)
        n_mesh = normalize(transform_point(mtrf, pl + no_mesh) - pg)
        n = torch.where((shape == CODE_MESH)[..., None], n_mesh, n_analytic)
    else:
        n = n_analytic

    # --- stale-on-miss ---------------------------------------------------
    is_hit = (shape >= 0)[..., None]
    if prev_n is None:
        prev_n = torch.zeros_like(n)
    if prev_p is None:
        prev_p = torch.zeros_like(pg)
    return torch.where(is_hit, n, prev_n), torch.where(is_hit, pg, prev_p)


# ---------------------------------------------------------------------------
# SoA form (vec3 = tuple of [M] tensors): the same formulas
# ---------------------------------------------------------------------------

def _affine2d(rows, v):
    """Affine transform of points by per-ray gathered rows: rows [12, M]
    (affine_rows gathered per ray), v [3, M]. Returns [3, M]."""
    r = rows.reshape(3, 4, rows.shape[1])
    return (r[:, :3, :] * v[None]).sum(dim=1) + r[:, 3, :]


def _norm2d(v, eps=1e-30):
    """Normalize [3, M] columns."""
    n = torch.sqrt((v * v).sum(dim=0, keepdim=True))
    return v / torch.clamp(n, min=eps)


def _cross2d(a, b):
    """Cross product of [3, M] columns via a row roll."""
    a1 = torch.roll(a, -1, dims=0)
    a2 = torch.roll(a, -2, dims=0)
    b1 = torch.roll(b, -1, dims=0)
    b2 = torch.roll(b, -2, dims=0)
    return a1 * b2 - a2 * b1


def intersection_info_soa(scene, hit, prev=None):
    """hit: ops.trace.HitS. Returns (n vec3, p vec3); keeps `prev` (a
    pair of vec3s, zeros when None) where the ray missed."""
    prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1).long()
    has_mesh = scene.tri_va.shape[0] > 0
    if has_mesh:
        both = torch.cat([vec.affine_rows(scene.transfo),
                          vec.affine_rows(scene.mesh_transfo)], dim=0)
        rows24 = both[:, prim]                               # [24, M]
        trf_rows, mrows = rows24[0:12], rows24[12:24]
    else:
        trf_rows = vec.affine_rows(scene.transfo)[:, prim]
    shape = hit.shape
    dircode = hit.dircode
    m = hit.pl[0].shape[0]
    pl2 = torch.stack(hit.pl)                                # [3, M]
    pg2 = torch.stack(hit.pg)
    rowi = torch.arange(3, device=pl2.device)[:, None]       # [3, 1]
    e_z = (rowi == 2).to(torch.float32)
    mask_xy = (rowi < 2).to(torch.float32)

    # cube: axis = dir//2, sign from dir%2 -> sg on row ax, 0 elsewhere
    sg = torch.where(dircode % 2 != 0, 1.0, -1.0)[None, :]  # [1, M]
    no_cube = torch.where((dircode // 2)[None, :] == rowi, sg, 0.0)
    # cylinder: caps (0, 0, +-1); side (pl.xy, 0)
    cap = (dircode < 2)[None, :]
    no_cyl = torch.where(cap, e_z * sg, pl2 * mask_xy)
    # cone: bottom cap (0,0,-1); side (pl.xy, |pl.xy|/2)
    rxy = torch.sqrt(((pl2 * mask_xy) ** 2).sum(dim=0, keepdim=True))
    bot = (dircode == 0)[None, :]
    no_cone = torch.where(bot, -e_z, pl2 * mask_xy + e_z * (rxy / 2.0))
    no_quad = e_z

    sh = shape[None, :]
    no = torch.where(sh == CODE_CUBE, no_cube,
                     torch.where(sh == CODE_CYLINDER, no_cyl,
                                 torch.where(sh == CODE_CONE, no_cone,
                                             no_quad)))
    point = torch.where(sh == CODE_SPHERE, 2.0 * pl2, pl2 + no)
    n2 = _norm2d(_affine2d(trf_rows, point) - pg2)
    cone_zero = (shape == CODE_CONE) & (dircode == 1)
    n2 = torch.where(cone_zero[None, :], 0.0, n2)

    if has_mesh:
        tri = torch.clamp(hit.tri, 0, scene.tri_va.shape[0] - 1).long()
        if scene.flat_face:
            pr = scene.tri_pos_rows[:, tri]                  # [9, M]
            A, B, C = pr[0:3], pr[3:6], pr[6:9]
            no_mesh = _cross2d(B - A, C - A)
        else:
            pn = torch.cat([scene.tri_pos_rows, scene.tri_norm_rows],
                           dim=0)[:, tri]                    # [18, M]
            A, B, C = pn[0:3], pn[3:6], pn[6:9]
            PA, PB, PC = A - pl2, B - pl2, C - pl2

            def _len(v):
                return torch.sqrt((v * v).sum(dim=0, keepdim=True))

            tA = _len(_cross2d(PB, PC))
            tB = _len(_cross2d(PA, PC))
            tC = _len(_cross2d(PA, PB))
            no_mesh = pn[9:12] * tA + pn[12:15] * tB + pn[15:18] * tC
        n_mesh2 = _norm2d(_affine2d(mrows, pl2 + no_mesh) - pg2)
        n2 = torch.where((shape == CODE_MESH)[None, :], n_mesh2, n2)

    n = (n2[0], n2[1], n2[2])
    is_hit = shape >= 0
    if prev is None:
        z = torch.zeros((m,), dtype=torch.float32, device=pl2.device)
        prev = ((z, z, z), (z, z, z))
    return vec.where(is_hit, n, prev[0]), vec.where(is_hit, hit.pg, prev[1])
