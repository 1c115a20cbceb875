"""The five analytic shape tests in SoA form, as plain torch functions.

Port of montecarlo_pathtracing_tpu/ops/pallas_trace.py:53-159
(`_SOA_FNS`). Each test takes local-frame ray components (tensors that
broadcast together) and returns (a, valid, dircode): the local ray
parameter of the nearest valid hit (FLT_MAX where none), the hit mask,
and the face/part code the shading normal needs. Same formulas and
EPSILON comparisons as the reference intersectors
(shaders/raytracer_func.frag:354-705); the plain megakernel
(models/megakernel.mega_pass_reference) folds them, and
csrc/megakernel.cu carries the same arithmetic per thread.

Divisions by zero are deliberate (e.g. the quad's a = -oz/dz): the
result is masked by the validity test afterwards, so IEEE inf/nan must
be produced, not trapped.
"""
from __future__ import annotations

import torch

from .intersect import (
    EPSILON, FLT_MAX, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE,
    CODE_ORIENTED_QUAD,
)

_EPS = float(EPSILON)
_FMAX = float(FLT_MAX)


def _full(x, value):
    return torch.full_like(x, value)


def _codes(x, value):
    return torch.full_like(x, value, dtype=torch.int32)


def sphere_soa(ox, oy, oz, dx, dy, dz):
    OO = ox * ox + oy * oy + oz * oz
    OD = ox * dx + oy * dy + oz * dz
    D2 = dx * dx + dy * dy + dz * dz
    delta4 = OD * OD - D2 * (OO - 1.0)
    sq = torch.sqrt(torch.clamp(delta4, min=0.0))
    a1 = -(OD + sq) / D2
    a2 = -(OD - sq) / D2
    ok = delta4 > 0.0
    v1 = ok & (a1 > _EPS)
    v2 = ok & (a2 > _EPS)
    a = torch.where(v1, a1, torch.where(v2, a2, _FMAX))
    return a, v1 | v2, _codes(a, 0)


def quad_soa(ox, oy, oz, dx, dy, dz):
    facing = dz <= -_EPS
    a = -oz / dz
    px = ox + a * dx
    py = oy + a * dy
    inside = (torch.abs(px) <= 1.0) & (torch.abs(py) <= 1.0)
    valid = facing & inside
    return torch.where(valid, a, _FMAX), valid, _codes(a, 0)


def cube_soa(ox, oy, oz, dx, dy, dz):
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    al = _full(ox, _FMAX)
    face = _codes(al, 0)
    for c in range(6):
        c0 = c // 2
        c1 = (c0 + 1) % 3
        c2 = (c0 + 2) % 3
        cd = -1.0 + 2.0 * (c % 2)
        a = (cd - o[c0]) / d[c0]
        v = (
            (torch.abs(d[c0]) > _EPS)
            & (a > _EPS)
            & (torch.abs(o[c1] + a * d[c1]) <= 1.0)
            & (torch.abs(o[c2] + a * d[c2]) <= 1.0)
            & (a < al)
        )
        al = torch.where(v, a, al)
        face = torch.where(v, c, face)
    return al, al < _FMAX, face


def cylinder_soa(ox, oy, oz, dx, dy, dz):
    al = _full(ox, _FMAX)
    cl = _codes(al, -1)
    dz_ok = torch.abs(dz) > _EPS
    for code, zplane in ((0, -1.0), (1, 1.0)):
        a = (zplane - oz) / dz
        rx = ox + a * dx
        ry = oy + a * dy
        v = dz_ok & (a > _EPS) & (rx * rx + ry * ry < 1.0) & (a < al)
        al = torch.where(v, a, al)
        cl = torch.where(v, code, cl)
    O2 = ox * ox + oy * oy
    OD = ox * dx + oy * dy
    D2 = dx * dx + dy * dy
    delta4 = OD * OD - D2 * (O2 - 1.0)
    a = -(OD + torch.sqrt(torch.clamp(delta4, min=0.0))) / D2
    z = oz + a * dz
    v = (delta4 > 0.0) & (a > _EPS) & (a < al) & (torch.abs(z) < 1.0)
    al = torch.where(v, a, al)
    cl = torch.where(v, 2, cl)
    return al, al < _FMAX, cl


def cone_soa(ox, oy, oz, dx, dy, dz):
    tl = _full(ox, _FMAX)
    cl = _codes(tl, -1)
    t0 = (-1.0 - oz) / dz
    rx = ox + t0 * dx
    ry = oy + t0 * dy
    v = ((torch.abs(dz) > _EPS) & (t0 > _EPS)
         & (rx * rx + ry * ry < 1.0) & (t0 < tl))
    tl = torch.where(v, t0, tl)
    cl = torch.where(v, 0, cl)
    coz = oz - 1.0
    dco = dx * ox + dy * oy + dz * coz
    coco = ox * ox + oy * oy + coz * coz
    k = 0.8   # cos^2 of the cone's half-angle (apex z=1, base r=1 at z=-1)
    a_ = dz * dz - k
    b_ = 2.0 * (dz * coz - dco * k)
    c_ = coz * coz - coco * k
    det = b_ * b_ - 4.0 * a_ * c_
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t1 = (-b_ - sq) / (2.0 * a_)
    t2 = (-b_ + sq) / (2.0 * a_)
    t1 = torch.where(torch.abs(oz + t1 * dz) > 1.0, _FMAX, t1)
    t2 = torch.where(torch.abs(oz + t2 * dz) > 1.0, _FMAX, t2)
    t = torch.minimum(t1, t2)
    v = (det > 0.0) & (t < tl)
    tl = torch.where(v, t, tl)
    cl = torch.where(v, 2, cl)
    return tl, tl < _FMAX, cl


SOA_FNS = {
    CODE_SPHERE: sphere_soa,
    CODE_CUBE: cube_soa,
    CODE_CYLINDER: cylinder_soa,
    CODE_CONE: cone_soa,
    CODE_ORIENTED_QUAD: quad_soa,
}
