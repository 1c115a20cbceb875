"""The plain reference path tracer: dense closest-hit folds and the
Monte Carlo integrator, in plain PyTorch.

This is the yardstick that decides `correct`. It follows the upstream
GLSL program (tp/montecarlo.frag:100-188, shaders/raytracer_func.frag)
as the JAX package's dense route does, op for op: the xxhash32 counter
RNG with its 2 + 1 + 2 masked draws per bounce, every primitive tested
in its local frame and the winner chosen by world distance, strictly
closer wins, groups in the fold order of `scene.ANALYTIC_ORDER` and then
mesh instances; the shading normal rebuilt from the local hit point; the
4-case material logic, the refraction re-trace and the sky.

Rays are independent lanes: lane k carries its own pixel coordinates and
pass index, so a sample of pixels over many passes is one batch.

`dtype` is the float type of every geometric and shading quantity. The
check runs it in float32, the configuration's precision; the control of
the check runs it in bfloat16. The RNG is integer in both.
"""
from __future__ import annotations

import numpy as np
import torch

from .scene import (CODE_CONE, CODE_CUBE, CODE_CYLINDER, CODE_MESH,
                    CODE_QUAD, CODE_SPHERE, RefScene)

M32 = 0xFFFFFFFF
_P2, _P3, _P4, _P5 = 2246822519, 3266489917, 668265263, 374761393
ADVANCE = (11, 43, 67)
GOLDEN = 0x9E3779B9
EPS = float(np.float32(1e-10))
FMAX = float(np.float32(3.402823e38))
BIAS = float(np.float32(1e-2))
PI = float(np.float32(2.0 * np.arccos(0.0)))
SKY_LOW = (0.5, 0.5, 0.9)
SKY_HIGH = (1.0, 1.0, 0.8)
CHUNK = 128          # primitives or triangles per dense [N, C] block


# --------------------------------------------------------------------------
# RNG (shaders/raytracer_func.frag:90-135): int64 lanes holding uint32
# --------------------------------------------------------------------------

def _rotl17(h):
    return ((h << 17) | (h >> 15)) & M32


def _xxhash32(s0, s1, s2):
    h = (s2 + _P5 + ((s0 * _P3) & M32)) & M32
    h = (_P4 * _rotl17(h)) & M32
    h = (h + ((s1 * _P3) & M32)) & M32
    h = (_P4 * _rotl17(h)) & M32
    h = (_P2 * (h ^ (h >> 15))) & M32
    h = (_P3 * (h ^ (h >> 13))) & M32
    return h ^ (h >> 16)


def _bits(x):
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & M32


def seed_state(u, v, pass_index, date: float):
    """(bits(u), pass * GOLDEN + bits(date), bits(v)); pass_index is an
    int64 tensor, one pass per lane."""
    db = int(np.float32(date).view(np.uint32))
    y = (pass_index.to(torch.int64) * GOLDEN + db) & M32
    return (_bits(u), y, _bits(v))


def _uniform(state, mask, dtype):
    """A draw for every lane; the counter advances where `mask`."""
    s0, s1, s2 = state
    m = (_xxhash32(s0, s1, s2) & 0x007FFFFF) | 0x3F800000
    f = (m.to(torch.int32).view(torch.float32) - 1.0).to(dtype)
    new = ((s0 + ADVANCE[0]) & M32, (s1 + ADVANCE[1]) & M32,
           (s2 + ADVANCE[2]) & M32)
    return f, tuple(torch.where(mask, a, b) for a, b in zip(new, state))


# --------------------------------------------------------------------------
# vec3 helpers on (x, y, z) tuples of [N] tensors
# --------------------------------------------------------------------------

def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _scale(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _normalize(v, eps=0.0):
    n = torch.sqrt(_dot(v, v))
    if eps:
        n = torch.clamp(n, min=eps)
    return (v[0] / n, v[1] / n, v[2] / n)


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _reflect(i, n):
    k = 2.0 * _dot(n, i)
    return (i[0] - k * n[0], i[1] - k * n[1], i[2] - k * n[2])


def _refract(i, n, eta):
    """GLSL refract: vec3(0) on total internal reflection."""
    ndi = _dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = k > 0.0
    c = eta * ndi + torch.where(refr, torch.sqrt(torch.where(refr, k, 1.0)),
                                0.0)
    out = (eta * i[0] - c * n[0], eta * i[1] - c * n[1],
           eta * i[2] - c * n[2])
    z = torch.zeros_like(out[0])
    return _where(k < 0.0, (z, z, z), out)


def _mix(a, b, k):
    return tuple((1.0 - k) * x + k * y for x, y in zip(a, b))


# --------------------------------------------------------------------------
# [N, C] local-frame shape tests (shaders/raytracer_func.frag:354-640)
# --------------------------------------------------------------------------

def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross3(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _normalize3(v, eps=0.0):
    n = torch.sqrt(_dot3(v, v))[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def _dir(m, v):
    return (m[..., :3, 0] * v[..., 0:1] + m[..., :3, 1] * v[..., 1:2]
            + m[..., :3, 2] * v[..., 2:3])


def _point(m, p):
    return _dir(m, p) + m[..., :3, 3]


def _full(like, value):
    return torch.full(like.shape, value, device=like.device).to(like.dtype)


def _big(like):
    """FLT_MAX, the mark of a miss; bfloat16's largest finite value in the
    control, where FLT_MAX does not fit."""
    if like.dtype == torch.float32:
        return FMAX
    return float(torch.finfo(like.dtype).max)


def _codes(like, value):
    return torch.full(like.shape, value, dtype=torch.int64,
                      device=like.device)


def _div(num, den, ok):
    return num / torch.where(ok, den, 1.0)


def _sqrt(x, pos):
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def sphere(O, D):
    OO, OD, D2 = _dot3(O, O), _dot3(O, D), _dot3(D, D)
    delta4 = OD * OD - D2 * (OO - 1.0)
    ok = delta4 > 0.0
    sq = _sqrt(delta4, ok)
    a1 = -(OD + sq) / D2
    a2 = -(OD - sq) / D2
    v1 = ok & (a1 > EPS)
    v2 = ok & (a2 > EPS)
    a = torch.where(v1, a1, torch.where(v2, a2, _big(a1)))
    return a, v1 | v2, _codes(a, 0)


def quad(O, D):
    """One-sided, no a > 0 check (the upstream quirk)."""
    facing = D[..., 2] <= -EPS
    a = _div(-O[..., 2], D[..., 2], facing)
    px = O[..., 0] + a * D[..., 0]
    py = O[..., 1] + a * D[..., 1]
    valid = facing & (torch.abs(px) <= 1.0) & (torch.abs(py) <= 1.0)
    return torch.where(valid, a, _big(a)), valid, _codes(a, 0)


def cube(O, D):
    al = _full(O[..., 0], _big(O))
    face = _codes(al, 0)
    for c in range(6):
        c0 = c // 2
        c1, c2 = (c0 + 1) % 3, (c0 + 2) % 3
        cd = -1.0 + 2.0 * (c % 2)
        dc = D[..., c0]
        dc_ok = torch.abs(dc) > EPS
        a = _div(cd - O[..., c0], dc, dc_ok)
        v = (dc_ok & (a > EPS)
             & (torch.abs(O[..., c1] + a * D[..., c1]) <= 1.0)
             & (torch.abs(O[..., c2] + a * D[..., c2]) <= 1.0)
             & (a < al))
        al = torch.where(v, a, al)
        face = torch.where(v, c, face)
    return al, al < _big(al), face


def cylinder(O, D):
    """Caps, then the side's near root only."""
    al = _full(O[..., 0], _big(O))
    cl = _codes(al, -1)
    dz_ok = torch.abs(D[..., 2]) > EPS
    for code, zplane in ((0, -1.0), (1, 1.0)):
        a = _div(zplane - O[..., 2], D[..., 2], dz_ok)
        rx = O[..., 0] + a * D[..., 0]
        ry = O[..., 1] + a * D[..., 1]
        v = dz_ok & (a > EPS) & (rx * rx + ry * ry < 1.0) & (a < al)
        al = torch.where(v, a, al)
        cl = torch.where(v, code, cl)
    O2 = O[..., 0] ** 2 + O[..., 1] ** 2
    OD = O[..., 0] * D[..., 0] + O[..., 1] * D[..., 1]
    D2 = D[..., 0] ** 2 + D[..., 1] ** 2
    delta4 = OD * OD - D2 * (O2 - 1.0)
    pos = delta4 > 0.0
    a = _div(-(OD + _sqrt(delta4, pos)), D2, pos)
    z = O[..., 2] + a * D[..., 2]
    v = pos & (a > EPS) & (a < al) & (torch.abs(z) < 1.0)
    al = torch.where(v, a, al)
    cl = torch.where(v, 2, cl)
    return al, al < _big(al), cl


def cone(O, D):
    """Apex at z = 1, slope factor 0.8, no a > EPS check on the side."""
    tl = _full(O[..., 0], _big(O))
    cl = _codes(tl, -1)
    dz_ok = torch.abs(D[..., 2]) > EPS
    t0 = _div(-1.0 - O[..., 2], D[..., 2], dz_ok)
    rx = O[..., 0] + t0 * D[..., 0]
    ry = O[..., 1] + t0 * D[..., 1]
    v = dz_ok & (t0 > EPS) & (rx * rx + ry * ry < 1.0) & (t0 < tl)
    tl = torch.where(v, t0, tl)
    cl = torch.where(v, 0, cl)
    coz = O[..., 2] - 1.0
    dco = D[..., 0] * O[..., 0] + D[..., 1] * O[..., 1] + D[..., 2] * coz
    coco = O[..., 0] ** 2 + O[..., 1] ** 2 + coz * coz
    k = float(np.float32(0.8))
    a = D[..., 2] * D[..., 2] - k
    b = 2.0 * (D[..., 2] * coz - dco * k)
    c = coz * coz - coco * k
    det = b * b - 4.0 * a * c
    pos = det > 0.0
    sq = _sqrt(det, pos)
    t1 = _div(-b - sq, 2.0 * a, pos)
    t2 = _div(-b + sq, 2.0 * a, pos)
    t1 = torch.where(torch.abs(O[..., 2] + t1 * D[..., 2]) > 1.0, _big(t1),
                     t1)
    t2 = torch.where(torch.abs(O[..., 2] + t2 * D[..., 2]) > 1.0, _big(t2),
                     t2)
    t = torch.minimum(t1, t2)
    v = pos & (t < tl)
    tl = torch.where(v, t, tl)
    cl = torch.where(v, 2, cl)
    return tl, tl < _big(tl), cl


SHAPES = {CODE_SPHERE: sphere, CODE_CUBE: cube, CODE_CYLINDER: cylinder,
          CODE_CONE: cone, CODE_QUAD: quad}


def triangles(O, D, va, vb, vc):
    """Moller-Trumbore, [N, C] (shaders/raytracer_func.frag:354-396)."""
    e1, e2 = vb - va, vc - va
    h = _cross3(D[:, None, :], e2[None])
    det = _dot3(e1[None], h)
    det_ok = torch.abs(det) >= EPS
    inv_det = _div(torch.ones_like(det), det, det_ok)
    s = O[:, None, :] - va[None]
    u = _dot3(s, h) * inv_det
    q = _cross3(s, e1[None])
    v = _dot3(D[:, None, :], q) * inv_det
    a = _dot3(e2[None], q) * inv_det
    valid = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (a > EPS))
    return torch.where(valid, a, _big(a)), valid


# --------------------------------------------------------------------------
# the fold: closest hit by world distance, strictly closer wins
# --------------------------------------------------------------------------

class Best:
    """Running closest hit of N rays: dist, local and world hit points,
    primitive, shape code, face code, global triangle id."""

    def __init__(self, n, device, dtype):
        self.dist = torch.full((n,), _big(torch.empty(0, dtype=dtype)),
                               dtype=dtype, device=device)
        self.pl = torch.zeros((n, 3), dtype=dtype, device=device)
        self.pg = torch.zeros((n, 3), dtype=dtype, device=device)
        self.prim = torch.full((n,), -1, dtype=torch.int64, device=device)
        self.shape = self.prim.clone()
        self.face = self.prim.clone()
        self.tri = self.prim.clone()

    def fold(self, dist, pl, pg, prim, shape, face, tri):
        take = dist < self.dist
        t3 = take[:, None]
        self.dist = torch.where(take, dist, self.dist)
        self.pl = torch.where(t3, pl, self.pl)
        self.pg = torch.where(t3, pg, self.pg)
        self.prim = torch.where(take, prim, self.prim)
        self.shape = torch.where(take, shape, self.shape)
        self.face = torch.where(take, face, self.face)
        self.tri = torch.where(take, tri, self.tri)


def _world_dist(O, pg, valid):
    diff = torch.where(valid[..., None], O[:, None, :] - pg, 1.0)
    return torch.where(valid, torch.sqrt(_dot3(diff, diff)), _big(diff))


def trace(scene: RefScene, O, D) -> Best:
    """Closest hit of rays O, D: [N, 3] against every primitive."""
    n = O.shape[0]
    best = Best(n, O.device, O.dtype)
    rows = torch.arange(n, device=O.device)
    for g in scene.groups:
        fn = SHAPES[g.code]
        for lo in range(0, g.prim.shape[0], CHUNK):
            trf, inv = g.transfo[lo:lo + CHUNK], g.inv[lo:lo + CHUNK]
            Oi = _point(inv, O[:, None, :])
            Di = _normalize3(_dir(inv, D[:, None, :]))
            a, valid, face = fn(Oi, Di)
            pl = Oi + a[..., None] * Di
            pg = _point(trf, pl)
            dist = _world_dist(O, pg, valid)
            j = torch.argmin(dist, dim=1)
            best.fold(dist[rows, j], pl[rows, j], pg[rows, j],
                      g.prim[lo:lo + CHUNK][j], _codes(j, g.code),
                      face[rows, j], _codes(j, -1))
    for ins in scene.instances:
        inv = scene.inv[ins.prim]
        mtrf = scene.mesh_transfo[ins.prim]
        Oi = _point(inv, O)
        Di = _normalize3(_dir(inv, D))
        for lo in range(0, ins.va.shape[0], CHUNK):
            a, valid = triangles(Oi, Di, ins.va[lo:lo + CHUNK],
                                 ins.vb[lo:lo + CHUNK],
                                 ins.vc[lo:lo + CHUNK])
            pl = Oi[:, None, :] + a[..., None] * Di[:, None, :]
            pg = _point(mtrf, pl)
            dist = _world_dist(O, pg, valid)
            j = torch.argmin(dist, dim=1)
            best.fold(dist[rows, j], pl[rows, j], pg[rows, j],
                      _codes(j, ins.prim), _codes(j, CODE_MESH),
                      _codes(j, 0), ins.tri_offset + lo + j)
    return best


def shading(scene: RefScene, hit: Best, prev_n, prev_p):
    """World shading normal and hit point (raytracer_func.frag:783-897):
    N = normalize(transfo * (pl + No) - Pg); a sphere's point is 2 pl;
    the cone's top face gives N = 0; mesh normals blend the vertex
    normals by the opposite sub-triangle areas. A miss keeps prev."""
    prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1)
    trf = scene.transfo[prim]
    pl, pg, face, shape = hit.pl, hit.pg, hit.face, hit.shape
    zero = torch.zeros_like(pl[:, 0])
    one = torch.ones_like(zero)
    sg = torch.where(face % 2 != 0, 1.0, -1.0).to(pl.dtype)
    ax = face // 2
    no_cube = torch.stack([torch.where(ax == c, sg, zero)
                           for c in range(3)], -1)
    no_cyl = torch.where((face < 2)[:, None],
                         torch.stack([zero, zero, sg], -1),
                         torch.stack([pl[:, 0], pl[:, 1], zero], -1))
    rxy = torch.sqrt(pl[:, 0] ** 2 + pl[:, 1] ** 2)
    no_cone = torch.where((face == 0)[:, None],
                          torch.stack([zero, zero, -one], -1),
                          torch.stack([pl[:, 0], pl[:, 1], rxy / 2.0], -1))
    no_quad = torch.stack([zero, zero, one], -1)
    no = torch.where((shape == CODE_CUBE)[:, None], no_cube,
                     torch.where((shape == CODE_CYLINDER)[:, None], no_cyl,
                                 torch.where((shape == CODE_CONE)[:, None],
                                             no_cone, no_quad)))
    point = torch.where((shape == CODE_SPHERE)[:, None], 2.0 * pl, pl + no)
    n = _normalize3(_point(trf, point) - pg, eps=1e-30)
    n = torch.where(((shape == CODE_CONE) & (face == 1))[:, None], 0.0, n)
    if scene.tri[0].shape[0] > 0:
        tri = torch.clamp(hit.tri, 0, scene.tri[0].shape[0] - 1)
        A, B, C, NA, NB, NC = (a[tri] for a in scene.tri)
        PA, PB, PC = A - pl, B - pl, C - pl

        def area(x, y):
            c = _cross3(x, y)
            return torch.sqrt(_dot3(c, c))[:, None]

        no_mesh = (NA * area(PB, PC) + NB * area(PA, PC)
                   + NC * area(PA, PB))
        n_mesh = _normalize3(_point(scene.mesh_transfo[prim], pl + no_mesh)
                             - pg, eps=1e-30)
        n = torch.where((shape == CODE_MESH)[:, None], n_mesh, n)
    hit_ = (shape >= 0)[:, None]
    n = torch.where(hit_, n, torch.stack(prev_n, -1))
    p = torch.where(hit_, pg, torch.stack(prev_p, -1))
    return (n[:, 0], n[:, 1], n[:, 2]), (p[:, 0], p[:, 1], p[:, 2])


# --------------------------------------------------------------------------
# sampling and the integrator (tp/montecarlo.frag:49-188)
# --------------------------------------------------------------------------

def _random_ray(state, d, roughness, mask, dtype):
    """A direction about d: two masked draws, the Beckmann-like lobe in
    the frame of W = normalize(d + (0, 5, 3))."""
    w = _normalize((d[0], d[1] + 5.0, d[2] + 3.0))
    u = _normalize(_cross(d, w))
    v = _normalize(_cross(d, u))
    u1, state = _uniform(state, mask, dtype)
    u2, state = _uniform(state, mask, dtype)
    alpha = roughness * roughness
    beta = 2.0 * PI * u1
    tan2 = -(alpha * alpha) * torch.log(1.0 - u2)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = _normalize((torch.cos(beta) * sin_t, torch.sin(beta) * sin_t,
                        cos_t))
    out = (u[0] * local[0] + v[0] * local[1] + d[0] * local[2],
           u[1] * local[0] + v[1] * local[1] + d[1] * local[2],
           u[2] * local[0] + v[2] * local[1] + d[2] * local[2])
    return _normalize(out), state


def _schlick(i, n, ior):
    r0 = (ior - 1.0) / (ior + 1.0)
    r0 = r0 * r0
    x = 1.0 - _dot(n, i)
    return torch.clamp(r0 + (1.0 - r0) * x * x * x * x * x, 0.0, 1.0)


def _trace_soa(scene, o, d):
    return trace(scene, torch.stack(o, -1), torch.stack(d, -1))


def radiance(scene: RefScene, origin, dirs, u, v, pass_index, *,
             nb_bounces: int, ior: float, date: float):
    """One path per lane. origin: [3]; dirs: [N, 3] normalized; u, v:
    [N] float32 screen coordinates; pass_index: [N] int64. Returns the
    lanes' radiance [N, 3] in the scene's float type."""
    dt = scene.color.dtype
    n = dirs.shape[0]
    dev = dirs.device
    z = torch.zeros((n,), dtype=dt, device=dev)
    one = torch.ones((n,), dtype=dt, device=dev)
    unit_z = (z, z, one)
    iort = torch.full((), ior, dtype=dt, device=dev)
    o3 = origin.to(dt)
    o = (z + o3[0], z + o3[1], z + o3[2])
    dd = dirs.to(dt)
    d = (dd[:, 0], dd[:, 1], dd[:, 2])
    state = seed_state(u, v, pass_index, date)
    matcol = torch.cat([scene.mat, scene.color], dim=1)     # [P, 7]
    attenu = (torch.full((n,), 0.8, dtype=dt, device=dev),) * 3
    total = (z, z, z)
    result = (z, z, z)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(nb_bounces):
        hit = _trace_soa(scene, o, d)
        active = ~done
        is_hit = hit.shape >= 0
        miss_now = active & ~is_hit
        live = active & is_hit
        k = torch.clamp(d[2], min=0.0)
        sky = tuple((1.0 - k) * lo + k * hi
                    for lo, hi in zip(SKY_LOW, SKY_HIGH))
        result = _where(miss_now, _add(total, _mul(attenu, sky)), result)
        done = done | miss_now
        n_raw, p_raw = shading(scene, hit, (z, z, z), (z, z, z))
        N = _where(live, n_raw, unit_z)
        P = _where(live, p_raw, _add(o, d))
        mc = matcol[torch.clamp(hit.prim, 0, scene.nb_prims - 1)]
        shin, rough, emis = mc[:, 0], mc[:, 1], mc[:, 2]
        col3 = (mc[:, 3], mc[:, 4], mc[:, 5])
        alpha = mc[:, 6]

        ray, state = _random_ray(state, N, 1.0 - rough, live, dt)
        rs = _schlick(d, N, iort)
        R = _reflect((-ray[0], -ray[1], -ray[2]), N)
        E = _normalize(_sub(o, P), eps=1e-30)
        se = (1.0 - rough) * 100.0 + rough * 2.0
        er = torch.clamp(_dot(E, R), min=0.0)
        spec = torch.where(er > 0.0,
                           torch.pow(torch.where(er > 0.0, er, 1.0), se),
                           0.0)
        emit = emis * (1.0 - shin) * alpha
        total = _where(live, _add(total, _add(_scale(col3, 0.1),
                                              _scale(attenu, emit))), total)
        emissive = emis > 0.5
        result = _where(live & emissive, total, result)
        done = done | (live & emissive)
        cont = live & ~emissive

        refl_case = (shin > 0.0) & (alpha == 1.0)
        refr_case = (alpha < 1.0) & (shin == 0.0)
        mixed_case = (alpha < 1.0) & (shin > 0.0)
        r, state = _uniform(state, cont & mixed_case, dt)
        choose_refl = refl_case | (mixed_case & (r > 0.5))
        refr_lane = cont & (refr_case | (mixed_case & ~(r > 0.5)))
        rray, state = _random_ray(state, _reflect(d, N), 1.0 - shin * rough,
                                  cont & choose_refl, dt)
        if scene.has_transparent:
            d_in = _where(cont & refr_case, _refract(d, N, iort), d)
            d_in = _where(refr_lane, d_in, unit_z)
            o_in = _where(refr_lane, _sub(P, _scale(N, BIAS)), o)
            hit2 = _trace_soa(scene, o_in, d_in)
            n2_raw, p2_raw = shading(scene, hit2, N, P)
            N2 = _where(refr_lane, n2_raw, unit_z)
            P2 = _where(refr_lane, p2_raw, P)
            d_exit = _refract(d_in, (-N2[0], -N2[1], -N2[2]), 1.0 / iort)
        else:
            N2, P2, d_exit = N, P, unit_z

        base = _mul(col3, attenu)
        spec_mix = _mix(attenu, col3, shin)
        att_refl = _add(base, _mul(_scale(attenu, alpha * rs * spec),
                                   spec_mix))
        att_refr = _add(base, _mul(_scale(attenu, (1.0 - alpha)
                                          * (1.0 - rs) * spec), spec_mix))
        att_diff = _add(base, _mul(_scale(attenu, spec), spec_mix))
        new_att = _where(refr_lane, att_refr,
                         _where(choose_refl, att_refl, att_diff))
        new_o = _where(refr_lane, _add(P2, _scale(N2, BIAS)),
                       _add(P, _scale(N, BIAS)))
        new_d = _where(refr_lane, d_exit, _where(choose_refl, rray, ray))
        o = _where(cont, new_o, o)
        d = _where(cont, new_d, d)
        attenu = _where(cont, new_att, attenu)
    rgb = _where(done, result, (z, z, z))
    return torch.stack(rgb, dim=-1)
