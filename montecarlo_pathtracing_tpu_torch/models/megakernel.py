"""Whole-pass megakernel route: the full bounce loop in one CUDA launch.

Port of montecarlo_pathtracing_tpu/models/megakernel.py. One launch of
kernel K1 (csrc/megakernel.cu) runs a whole progressive pass per ray:
xxhash32 counters, the per-bounce closest-hit fold over the prim table,
normal reconstruction, the 4-case material logic with its masked draws,
and the refraction re-trace on transparent scenes. Device traffic is
rays in (5 f32/ray) and rgb out (3 f32/ray).

Scene representation, as in the reference: a [38, P] f32 table of
per-prim scalars (12 inverse-transform rows, 12 forward rows, shin/rough/
emis, rgba, an ok flag masking group-padding columns, and the prim's
world AABB) with a static (shape_code, start, count, super_start)
descriptor per homogeneous group. On scenes with >= MEGA_CULL_MIN_PRIMS
prims the fold is culled in two levels: 16-prim super boxes visited in a
per-tile nearest-first order (`_mega_super_order`), then per-prim boxes,
each against the ray's running best. The fold carries the winner's
attributes (normal, hit point, material, colour), not its index.

Semantics are tp/montecarlo.frag:100-188 exactly, with the reference's
masked-counter draw schedule (2 + 1 + 2 draws per bounce).

Three functions compute a pass from the same `MegaInputs`:
  - `mega_pass_reference`: the plain PyTorch version, a direct
    transcription of the reference's `_mega_kernel`, `_trace_fold` and
    `_bounce_step` over flat [N] ray tensors;
  - `k1_launch`: the wrapper that launches K1 on CUDA tensors;
  - `mega_pass`: the route, which takes the plain version for tensors on
    the CPU and K1 for tensors on a CUDA device, and raises otherwise.

The cull differs from the TPU's in grain: the TPU skipped a prim for a
whole 4096-ray tile when no ray of the tile could reach its box; here
each ray skips it on its own, so the test must be conservative for every
ray by itself. A prim is skipped only when its box lies farther from the
origin than the ray's best world distance: the slab parameter is scaled
by |d| (some rays are not unit: the cone top's N = 0 refracts into a
shorter vector), and for quads and cones, whose reference tests accept
hits behind the origin, the box is measured along the whole line, not
the forward ray. Skipped prims could not have won the strictly-closer
fold, so the winners are the brute fold's (up to exact distance ties).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops import rng as _rng
from ..ops.intersect import (
    FLT_MAX, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER, CODE_CONE,
    CODE_ORIENTED_QUAD,
)
from ..ops.shapes import SOA_FNS
from ..ops.vec import safe_rcp
from ..ops.worklist import bundle_box_entry

TILE = 32 * 128           # rays per tile of the super visit order (the
                           # reference's 32 x 128 ray tile)
MEGA_MAX_PRIMS = 4096      # prim-table cap, kept to route like the reference
MEGA_CULL_MIN_PRIMS = 64   # per-prim AABB culling pays for itself above this
MEGA_SUPER = 16            # prims per super-box (the outer culling level)
# shapes whose reference tests accept hits behind the ray origin (the quad
# and the cone's side check no a > EPSILON); their cull tests the line
HITS_BEHIND = (CODE_ORIENTED_QUAD, CODE_CONE)

_FMAX = float(FLT_MAX)
_SENTINEL = float(np.float32(3e38))
PI = float(np.float32(2.0 * np.arccos(0.0)))
BIAS = float(np.float32(1e-2))     # raytracer_func.frag:14
SKY_LOW = (0.5, 0.5, 0.9)          # tp/montecarlo.frag:119
SKY_HIGH = (1.0, 1.0, 0.8)


class MegaInputs(NamedTuple):
    """Everything one pass of K1 reads besides the pass's seed.

    dirs [Np,3] f32 unit directions and tc [Np,2] f32 screen coords, Np a
    multiple of TILE (padding rays: d=(0,0,1), uv=0); n <= Np real rays.
    fpar [4] f32: camera origin, IOR. tab [38,P] f32 prim table; group_desc
    [G,4] i32 on the device and `groups` the same on the host. With cull:
    sbb [6,S] f32 super boxes and ordr [Np/TILE,1,S] i32 visit order;
    without cull both are None and nothing reads them."""
    dirs: torch.Tensor
    tc: torch.Tensor
    fpar: torch.Tensor
    tab: torch.Tensor
    sbb: Optional[torch.Tensor]
    ordr: Optional[torch.Tensor]
    group_desc: torch.Tensor
    groups: Tuple[Tuple[int, int, int, int], ...]
    n: int
    has_transparent: bool
    cull: bool


# --------------------------------------------------------------------------
# vec3 helpers (vec3 = tuple of [N] tensors)
# --------------------------------------------------------------------------

def _vwhere(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _vnorm(v, eps=0.0):
    n = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    if eps:
        n = torch.clamp(n, min=eps)
    return (v[0] / n, v[1] / n, v[2] / n)


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _reflect(i, n):
    d2 = 2.0 * _vdot(n, i)
    return (i[0] - d2 * n[0], i[1] - d2 * n[1], i[2] - d2 * n[2])


def _refract_glsl(i, n, eta):
    ndi = _vdot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    c = eta * ndi + torch.sqrt(torch.clamp(k, min=0.0))
    out = (eta * i[0] - c * n[0], eta * i[1] - c * n[1],
           eta * i[2] - c * n[2])
    z = torch.zeros_like(out[0])
    return _vwhere(k < 0.0, (z, z, z), out)


def _random_ray(state, d, roughness, mask):
    """random_ray (tp/montecarlo.frag:49-89): ONB about d + Beckmann-ish
    hemisphere sample; exactly 2 masked draws."""
    w = _vnorm((d[0], d[1] + 5.0, d[2] + 3.0))
    u = _vnorm(_vcross(d, w))
    v = _vnorm(_vcross(d, u))
    alpha = roughness * roughness
    u1, state = _rng.uniform_masked_soa(state, mask)
    beta = (2.0 * PI) * u1
    u2, state = _rng.uniform_masked_soa(state, mask)
    tan_theta2 = -(alpha * alpha) * torch.log(1.0 - u2)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    lx = torch.cos(beta) * sin_theta
    ly = torch.sin(beta) * sin_theta
    lz = cos_theta
    ln = torch.sqrt(lx * lx + ly * ly + lz * lz)
    lx, ly, lz = lx / ln, ly / ln, lz / ln
    out = (u[0] * lx + v[0] * ly + d[0] * lz,
           u[1] * lx + v[1] * ly + d[1] * lz,
           u[2] * lx + v[2] * ly + d[2] * lz)
    return _vnorm(out), state


# --------------------------------------------------------------------------
# the closest-hit fold (plain version of the kernel's trace_fold)
# --------------------------------------------------------------------------

def _slab(box, o, rd, dl, best, behind):
    """Ray-vs-AABB slab test against the running best world distance;
    box rows are (min x, min y, min z, max x, max y, max z). The nearest
    distance from the origin to the box along the ray (or, when `behind`,
    along the whole line) is the slab parameter scaled by |d| (dl), so the
    test stays conservative on non-unit rays too."""
    t0x = (box[0] - o[0]) * rd[0]
    t1x = (box[3] - o[0]) * rd[0]
    t0y = (box[1] - o[1]) * rd[1]
    t1y = (box[4] - o[1]) * rd[1]
    t0z = (box[2] - o[2]) * rd[2]
    t1z = (box[5] - o[2]) * rd[2]
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z))
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z))
    if behind:
        near = torch.clamp(torch.maximum(tmin, -tmax), min=0.0)
        return (tmax >= tmin) & (near * dl <= best)
    tmin = torch.clamp(tmin, min=0.0)
    return (tmax >= tmin) & (tmin * dl <= best)


def _shading_normal(code, tf, plv, pg, dircode):
    """World shading normal of a hit at local point plv, world point pg
    (intersection_info, raytracer_func.frag:783-897): normalize(transfo @
    point - pg) with the shape's local offset point."""
    if code == CODE_SPHERE:
        point = (2.0 * plv[0], 2.0 * plv[1], 2.0 * plv[2])
    elif code == CODE_CUBE:
        ax = dircode // 2
        sg = torch.where(dircode % 2 != 0, 1.0, -1.0)
        point = (plv[0] + torch.where(ax == 0, sg, 0.0),
                 plv[1] + torch.where(ax == 1, sg, 0.0),
                 plv[2] + torch.where(ax == 2, sg, 0.0))
    elif code == CODE_CYLINDER:
        cap = dircode < 2
        zsg = torch.where(dircode % 2 != 0, 1.0, -1.0)
        point = (plv[0] + torch.where(cap, 0.0, plv[0]),
                 plv[1] + torch.where(cap, 0.0, plv[1]),
                 plv[2] + torch.where(cap, zsg, 0.0))
    elif code == CODE_CONE:
        rxy = torch.sqrt(plv[0] * plv[0] + plv[1] * plv[1])
        bot = dircode == 0
        point = (plv[0] + torch.where(bot, 0.0, plv[0]),
                 plv[1] + torch.where(bot, 0.0, plv[1]),
                 plv[2] + torch.where(bot, -1.0, rxy / 2.0))
    else:  # oriented quad
        point = (plv[0], plv[1], plv[2] + 1.0)
    tp = (tf[0] * point[0] + tf[1] * point[1] + tf[2] * point[2]
          + tf[3] - pg[0],
          tf[4] * point[0] + tf[5] * point[1] + tf[6] * point[2]
          + tf[7] - pg[1],
          tf[8] * point[0] + tf[9] * point[1] + tf[10] * point[2]
          + tf[11] - pg[2])
    nv = _vnorm(tp, eps=1e-30)
    if code == CODE_CONE:
        # cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
        z = torch.zeros_like(nv[0])
        nv = _vwhere(dircode == 1, (z, z, z), nv)
    return nv


def _prim_work(code, col, o, d, win, gate):
    """Test one prim column per ray and fold it into the winner `win`
    (list of 14 tensors: best dist, N, P, shin, rough, emis, rgba).
    col: [38, 1] (one prim for every ray) or [38, N] (one per ray)."""
    iv, tf = col[0:12], col[12:24]
    oi = (iv[0] * o[0] + iv[1] * o[1] + iv[2] * o[2] + iv[3],
          iv[4] * o[0] + iv[5] * o[1] + iv[6] * o[2] + iv[7],
          iv[8] * o[0] + iv[9] * o[1] + iv[10] * o[2] + iv[11])
    di = _vnorm((iv[0] * d[0] + iv[1] * d[1] + iv[2] * d[2],
                 iv[4] * d[0] + iv[5] * d[1] + iv[6] * d[2],
                 iv[8] * d[0] + iv[9] * d[1] + iv[10] * d[2]), eps=1e-30)
    a, valid, dircode = SOA_FNS[code](oi[0], oi[1], oi[2],
                                      di[0], di[1], di[2])
    plv = (oi[0] + a * di[0], oi[1] + a * di[1], oi[2] + a * di[2])
    pg = (tf[0] * plv[0] + tf[1] * plv[1] + tf[2] * plv[2] + tf[3],
          tf[4] * plv[0] + tf[5] * plv[1] + tf[6] * plv[2] + tf[7],
          tf[8] * plv[0] + tf[9] * plv[1] + tf[10] * plv[2] + tf[11])
    ex, ey, ez = o[0] - pg[0], o[1] - pg[1], o[2] - pg[2]
    dist = torch.where(valid, torch.sqrt(ex * ex + ey * ey + ez * ez), _FMAX)
    nv = _shading_normal(code, tf, plv, pg, dircode)

    # a group-padding column (ok = 0) never wins
    take = (col[31] > 0.0) & (dist < win[0])
    if gate is not None:
        take = take & gate
    new = (dist, *nv, *pg, col[24], col[25], col[26],
           col[27], col[28], col[29], col[30])
    for k, x in enumerate(new):
        win[k] = torch.where(take, x, win[k])


def _new_win(o, n_prev, p_prev):
    """The winner before any hit: best distance FLT_MAX, N and P the
    stale (n_prev, p_prev), no material, alpha 1."""
    z = torch.zeros_like(o[0])
    return [z + _FMAX, z + n_prev[0], z + n_prev[1], z + n_prev[2],
            z + p_prev[0], z + p_prev[1], z + p_prev[2],
            z, z, z, z, z, z, z + 1.0]


def _win_result(win):
    """(is_hit, N, P, shin, rough, emis, col3, alpha) of a winner list."""
    return (win[0] < _FMAX, tuple(win[1:4]), tuple(win[4:7]),
            win[7], win[8], win[9], tuple(win[10:13]), win[13])


def _fold_table(tab, sbb, groups, cull, ordr_ray, o, d, win):
    """Fold every prim of a [38, P] table into the winner list `win`.
    With cull, ordr_ray [N, S] is each ray's row of the super visit
    order."""
    if cull:
        rd = (safe_rcp(d[0]), safe_rcp(d[1]), safe_rcp(d[2]))
        dl = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    for code, start, count, sstart in groups:
        behind = code in HITS_BEHIND
        if not cull:
            for c in range(start, start + count):
                _prim_work(code, tab[:, c:c + 1], o, d, win, None)
            continue
        # two-level frontier: a super box gates its 16 prims' box tests,
        # supers visited in the tile's nearest-first order
        for spi in range(-(-count // MEGA_SUPER)):
            sp = ordr_ray[:, sstart + spi]
            shit = _slab(sbb[:, sstart + sp], o, rd, dl, win[0], behind)
            for j in range(MEGA_SUPER):
                # the clamp re-tests the group's last prim at the edge;
                # an equal candidate never replaces the winner
                c = start + torch.clamp(sp * MEGA_SUPER + j, max=count - 1)
                col = tab[:, c]
                gate = shit & _slab(col[32:38], o, rd, dl, win[0], behind)
                _prim_work(code, col, o, d, win, gate)


def _bounce_step(trace_fn, has_transparent, ior,
                 o, d, attenu, total, result, done, state):
    """One bounce of tp/montecarlo.frag:109-176 (reference
    `_bounce_step`, megakernel.py:415-534). trace_fn(o, d, n_prev,
    p_prev, lanes) is called for every ray; `lanes` marks the rays whose
    trace is real (in flight, or refracting for the re-trace); the
    others' results are discarded."""
    z = torch.zeros_like(d[0])
    one = torch.ones_like(d[0])
    unit_z = (z, z, one)
    active = ~done
    is_hit, N, P, shin, rough, emis, col3, alpha = trace_fn(
        o, d, unit_z, (o[0] + d[0], o[1] + d[1], o[2] + d[2]), active)

    miss_now = active & ~is_hit
    live = active & is_hit

    # sky fallback (:117-119)
    k = torch.clamp(d[2], min=0.0)
    sky = tuple((1.0 - k) * lo + k * hi for lo, hi in zip(SKY_LOW, SKY_HIGH))
    result = _vwhere(
        miss_now,
        (total[0] + attenu[0] * sky[0], total[1] + attenu[1] * sky[1],
         total[2] + attenu[2] * sky[2]),
        result)
    done = done | miss_now

    # draws 1-2: the diffuse sample, every hit lane (:127)
    ray, state = _random_ray(state, N, 1.0 - rough, live)

    # Schlick from the IOR slider (:129)
    r0 = (ior - 1.0) / (ior + 1.0)
    r0 = r0 * r0
    xs = 1.0 - _vdot(N, d)
    x5 = xs * xs * xs * xs * xs
    rs = torch.clamp(r0 + (1.0 - r0) * x5, 0.0, 1.0)

    R = _reflect((-ray[0], -ray[1], -ray[2]), N)        # (:131)
    E = _vnorm((o[0] - P[0], o[1] - P[1], o[2] - P[2]), eps=1e-30)
    se = (1.0 - rough) * 100.0 + rough * 2.0            # (:133)
    spec = torch.pow(torch.clamp(_vdot(E, R), min=0.0), se)

    # ambient leak + emissive gather (:136)
    emit = emis * (1.0 - shin) * alpha
    total = _vwhere(
        live,
        (total[0] + col3[0] * 0.1 + attenu[0] * emit,
         total[1] + col3[1] * 0.1 + attenu[1] * emit,
         total[2] + col3[2] * 0.1 + attenu[2] * emit),
        total)

    # emissive termination (:139,174-175)
    emissive = emis > 0.5
    result = _vwhere(live & emissive, total, result)
    done = done | (live & emissive)
    cont = live & ~emissive

    refl_case = (shin > 0.0) & (alpha == 1.0)
    refr_case = (alpha < 1.0) & (shin == 0.0)
    mixed_case = (alpha < 1.0) & (shin > 0.0)

    # draw 3: the mixed-case coin (:155)
    coin, state = _rng.uniform_masked_soa(state, cont & mixed_case)
    choose_refl = refl_case | (mixed_case & (coin > 0.5))
    refr_lane = cont & (refr_case | (mixed_case & ~(coin > 0.5)))

    # draws 4-5: the reflect-branch sample (:143,158)
    rray, state = _random_ray(state, _reflect(d, N),
                              1.0 - shin * rough, cont & choose_refl)

    if has_transparent:
        # refraction march-through (:146-153); mixed keeps un-refracted D;
        # non-refracting lanes are parked far above every prim box
        d_in = _vwhere(cont & refr_case, _refract_glsl(d, N, ior), d)
        d_in = _vwhere(refr_lane, d_in, unit_z)
        o_in = _vwhere(refr_lane,
                       (P[0] - BIAS * N[0], P[1] - BIAS * N[1],
                        P[2] - BIAS * N[2]),
                       (o[0], o[1], z + 2.0e8))
        _, N2r, P2r, *_unused = trace_fn(o_in, d_in, N, P, refr_lane)
        N2 = _vwhere(refr_lane, N2r, unit_z)
        P2 = _vwhere(refr_lane, P2r, P)
        d_exit = _refract_glsl(d_in, (-N2[0], -N2[1], -N2[2]), 1.0 / ior)
    else:
        N2, P2 = N, P
        d_exit = unit_z

    # attenuation updates (:142,147,161,170)
    base = (col3[0] * attenu[0], col3[1] * attenu[1], col3[2] * attenu[2])
    sm = tuple((1.0 - shin) * a_ + shin * c_ for a_, c_ in zip(attenu, col3))
    arefl = tuple(b_ + (a_ * (alpha * rs * spec)) * m_
                  for b_, a_, m_ in zip(base, attenu, sm))
    arefr = tuple(b_ + (a_ * ((1.0 - alpha) * (1.0 - rs) * spec)) * m_
                  for b_, a_, m_ in zip(base, attenu, sm))
    adiff = tuple(b_ + (a_ * spec) * m_
                  for b_, a_, m_ in zip(base, attenu, sm))

    new_attenu = _vwhere(refr_lane, arefr,
                         _vwhere(choose_refl, arefl, adiff))
    new_o = _vwhere(
        refr_lane,
        (P2[0] + BIAS * N2[0], P2[1] + BIAS * N2[1], P2[2] + BIAS * N2[2]),
        (P[0] + BIAS * N[0], P[1] + BIAS * N[1], P[2] + BIAS * N[2]))
    new_d = _vwhere(refr_lane, d_exit, _vwhere(choose_refl, rray, ray))

    o = _vwhere(cont, new_o, o)
    d = _vwhere(cont, new_d, d)
    attenu = _vwhere(cont, new_attenu, attenu)
    return o, d, attenu, total, result, done, state


# --------------------------------------------------------------------------
# one pass: plain version, kernel wrapper, route
# --------------------------------------------------------------------------

class K1Need:
    """The work the inputs of one K1 pass need, counted by
    `mega_pass_reference` from each trace's final best world distance, not
    from any walk (so no design of K1 can come in under it). Over the n
    real rays:
      - `steps`: bounce steps (shading), one per ray in flight and bounce;
        `path` [n] the steps of each ray;
      - `traced`: traces (the bounce's own and, on transparent scenes, the
        refraction re-trace of each refracting ray); `hits`: those that
        hit, one hit point and normal each;
      - `prim` {shape code: ray-prim tests}: without the cull every real
        prim of the table per trace; with it, the real prims whose box the
        ray enters within its final best, inside a super box it enters so;
      - `box` (cull only): slab tests, every super box per trace and the
        real prims' boxes of each super entered.
    The slab test is the fold's (`_slab`: |d|-scaled, along the whole
    line for quads and cones). Counts are int64 scalars on the rays'
    device. With keep=True, `traces` also keeps each trace's (o, d, lanes,
    best) rows of the real rays."""

    def __init__(self, inp: MegaInputs, keep: bool = False, step: int = 64):
        dev = inp.dirs.device
        z = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps, self.traced, self.hits, self.box = (
            z.clone() for _ in range(4))
        self.prim = {code: z.clone() for code, *_ in inp.groups}
        self.path = torch.zeros(inp.n, dtype=torch.int64, device=dev)
        self.traces = [] if keep else None
        self._step = step

    def add_step(self, inp: MegaInputs, active):
        a = active[:inp.n]
        self.steps += a.sum()
        self.path += a

    def add_trace(self, inp: MegaInputs, o, d, lanes, best):
        n = inp.n
        lanes, best = lanes[:n], best[:n]
        o = tuple(x[:n] for x in o)
        d = tuple(x[:n] for x in d)
        if self.traces is not None:
            self.traces.append((tuple(x.clone() for x in o),
                                tuple(x.clone() for x in d), lanes, best))
        self.traced += lanes.sum()
        self.hits += (lanes & (best < _FMAX)).sum()
        real = inp.tab[31] > 0
        if not inp.cull:
            for code, start, count, _ in inp.groups:
                self.prim[code] += lanes.sum() * real[start:start + count].sum()
            return
        rd = (safe_rcp(d[0]), safe_rcp(d[1]), safe_rcp(d[2]))
        dl = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        o1, rd1 = [x[:, None] for x in o], [x[:, None] for x in rd]
        dl1, best1 = dl[:, None], best[:, None]
        for code, start, count, sstart in inp.groups:
            behind = code in HITS_BEHIND
            nsup = -(-count // MEGA_SUPER)
            sup = torch.cat([
                _slab(inp.sbb[:, None, c:min(c + self._step, sstart + nsup)],
                      o1, rd1, dl1, best1, behind)
                for c in range(sstart, sstart + nsup, self._step)], dim=1)
            sup &= lanes[:, None]                           # [n, nsup]
            self.box += lanes.sum() * nsup
            cols = torch.arange(count, device=best.device)[real[start:
                                                                start + count]]
            for c in range(0, cols.numel(), self._step):
                cc = cols[c:c + self._step]
                inside = sup[:, cc // MEGA_SUPER]
                self.box += inside.sum()
                enter = _slab(inp.tab[32:38, None, start + cc], o1, rd1, dl1,
                              best1, behind) & inside
                self.prim[code] += enter.sum()


def mega_pass_reference(inp: MegaInputs, seed: int, nb_bounces: int,
                        alive=None, need: Optional[K1Need] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of K1 (reference `_mega_kernel`,
    megakernel.py:541-582) on any device. Returns rgb [n, 3]. `alive`, a
    list if given, gets the number of real rays still in flight at the
    start of each bounce appended (a device sync each); `need`, a K1Need,
    gets the pass's work counted into it."""
    d = (inp.dirs[:, 0], inp.dirs[:, 1], inp.dirs[:, 2])
    z = torch.zeros_like(d[0])
    o = (z + inp.fpar[0], z + inp.fpar[1], z + inp.fpar[2])
    ior = inp.fpar[3]
    # srand (integer-exact seed; ops/rng.srand_soa)
    state = (_rng.float_bits(inp.tc[:, 0]),
             torch.full_like(d[0], seed, dtype=torch.int64),
             _rng.float_bits(inp.tc[:, 1]))
    ordr_ray = None
    if inp.cull:
        ordr_ray = inp.ordr[:, 0, :].long().repeat_interleave(TILE, dim=0)

    def trace_fn(o, d, n_prev, p_prev, lanes):
        # the closest hit: on a miss N, P keep (n_prev, p_prev), the GLSL
        # stale-output semantics the refraction re-trace relies on
        # (tp/montecarlo.frag:150-152)
        win = _new_win(o, n_prev, p_prev)
        _fold_table(inp.tab, inp.sbb, inp.groups, inp.cull, ordr_ray, o, d,
                    win)
        if need is not None:
            need.add_trace(inp, o, d, lanes, win[0])
        return _win_result(win)

    attenu = (z + 0.8, z + 0.8, z + 0.8)   # vec3(0.8) (:106-107)
    total = (z, z, z)
    result = (z, z, z)
    done = torch.zeros_like(d[0], dtype=torch.bool)
    for _ in range(nb_bounces):
        if alive is not None:
            alive.append(int((~done[:inp.n]).sum()))
        if need is not None:
            need.add_step(inp, ~done)
        o, d, attenu, total, result, done, state = _bounce_step(
            trace_fn, inp.has_transparent, ior,
            o, d, attenu, total, result, done, state)
    # bounce-cap exhaustion returns black (:178)
    rgb = torch.stack([torch.where(done, c, 0.0) for c in result], dim=-1)
    return rgb[:inp.n]


def _check_inputs(inp: MegaInputs):
    """Raise unless every tensor K1 reads has the device, dtype, shape
    and layout the kernel assumes."""
    dev = inp.dirs.device
    if dev.type != "cuda":
        raise ValueError(f"K1 needs CUDA tensors, got {dev}")
    np_ = inp.dirs.shape[0]
    want = {"dirs": (inp.dirs, torch.float32, (np_, 3)),
            "tc": (inp.tc, torch.float32, (np_, 2)),
            "fpar": (inp.fpar, torch.float32, (4,)),
            "tab": (inp.tab, torch.float32, (38, inp.tab.shape[1])),
            "group_desc": (inp.group_desc, torch.int32,
                           (len(inp.groups), 4))}
    if inp.cull:
        s = inp.sbb.shape[1] if inp.sbb is not None else -1
        want["sbb"] = (inp.sbb, torch.float32, (6, s))
        want["ordr"] = (inp.ordr, torch.int32, (np_ // TILE, 1, s))
    for name, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"K1 input {name} is missing")
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"K1 input {name}: {t.device} {t.dtype} {tuple(t.shape)}, "
                f"want {dev} {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"K1 input {name} is not contiguous")
    if np_ == 0 or np_ % TILE or not 0 < inp.n <= np_:
        raise ValueError(f"K1 needs 0 < n={inp.n} <= Np={np_}, Np % {TILE}")
    if not 0 < inp.tab.shape[1] <= MEGA_MAX_PRIMS:
        raise ValueError(f"K1 prim table width {inp.tab.shape[1]}")


def k1_launch(inp: MegaInputs, seed: int, nb_bounces: int) -> torch.Tensor:
    """Launch K1 on the current CUDA stream of the inputs' card. Returns
    rgb [n, 3]. Raises on bad inputs and on a refused launch; counts each
    launch in `k1_launch.launches`.

    K1's blocks take rays from one `next_ray` counter per device, reset
    before each launch on the same stream: two launches on one card must
    not run on two streams at once (parallel/sharding.py runs the shards
    that share a card one after another on its current stream)."""
    _check_inputs(inp)
    if nb_bounces < 0:
        raise ValueError(f"nb_bounces={nb_bounces}")
    lib = kernels.megakernel_lib()
    out = torch.empty((inp.n, 3), dtype=torch.float32, device=inp.dirs.device)
    null = ctypes.c_void_p(0)
    with kernels.on_device(out.device):
        err = lib.mega_pass(
            inp.dirs.data_ptr(), inp.tc.data_ptr(), inp.fpar.data_ptr(),
            ctypes.c_uint32(seed),
            inp.tab.data_ptr(), inp.tab.shape[1],
            inp.sbb.data_ptr() if inp.cull else null,
            inp.sbb.shape[1] if inp.cull else 0,
            inp.ordr.data_ptr() if inp.cull else null,
            inp.group_desc.data_ptr(), len(inp.groups),
            nb_bounces, int(inp.has_transparent), int(inp.cull), inp.n,
            out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.mega_error_string(err).decode()}")
    k1_launch.launches += 1
    return out


k1_launch.launches = 0


def k1_kernel_info(inp: MegaInputs) -> dict:
    """The compiled K1 variant that `k1_launch` runs on these inputs, from
    the CUDA runtime: registers and local memory (spill) bytes a thread,
    static and dynamic shared memory a block, resident blocks per SM and
    threads a block. Needs the card."""
    lib = kernels.megakernel_lib()
    out = (ctypes.c_int * 6)()
    err = lib.mega_kernel_info(int(inp.has_transparent), int(inp.cull),
                               inp.tab.shape[1],
                               inp.sbb.shape[1] if inp.cull else 0, out)
    if err != 0:
        raise RuntimeError(
            f"K1 kernel info failed: {lib.mega_error_string(err).decode()}")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "threads", "dynamic_shared_bytes"),
                    out))


def mega_pass(inp: MegaInputs, seed: int, nb_bounces: int) -> torch.Tensor:
    """One pass: the plain version on the CPU, K1 on a CUDA device."""
    if inp.dirs.device.type == "cpu":
        return mega_pass_reference(inp, seed, nb_bounces)
    return k1_launch(inp, seed, nb_bounces)


# --------------------------------------------------------------------------
# host side: routing predicate, tables, visit order
# --------------------------------------------------------------------------

def mega_eligible(scene) -> bool:
    """Static routing predicate: analytic-only scenes small enough for the
    prim table. Mesh scenes and larger scenes take other routes."""
    if scene.mesh_prim_index:
        return False
    total = sum(int(g.shape[0]) for g in scene.group_prim)
    return 0 < total <= MEGA_MAX_PRIMS


def _mega_meta(scene, group_ids=None):
    """Static ((code, start, count, super_start), ...) over the scene's
    typed groups (or those of `group_ids`), and the table width;
    super_start indexes the per-group 16-prim super-box table
    (`_mega_super_boxes`)."""
    if group_ids is None:
        group_ids = range(len(scene.group_codes))
    groups = []
    start = 0
    sstart = 0
    for gi in group_ids:
        count = int(scene.group_prim[gi].shape[0])
        groups.append((int(scene.group_codes[gi]), start, count, sstart))
        start += count
        sstart += -(-count // MEGA_SUPER)
    return tuple(groups), start


def _mega_super_boxes(scene, group_ids=None):
    """[6, n_supers] world AABBs over MEGA_SUPER-prim windows of each
    (Morton-ordered) group of `group_ids` (default: all) — the outer
    level of the cull. Padding prims contribute empty boxes."""
    if group_ids is None:
        group_ids = range(len(scene.group_codes))
    cols = []
    for gi in group_ids:
        pid = scene.group_prim[gi].long()
        ok = (pid >= 0)[:, None]
        bmn = torch.where(ok, scene.prim_bb_min[pid], _SENTINEL)
        bmx = torch.where(ok, scene.prim_bb_max[pid], -_SENTINEL)
        n = bmn.shape[0]
        pad = -(-n // MEGA_SUPER) * MEGA_SUPER
        fill = bmn.new_full((pad - n, 3), _SENTINEL)
        bmn = torch.cat([bmn, fill])
        bmx = torch.cat([bmx, -fill])
        smn = bmn.reshape(-1, MEGA_SUPER, 3).amin(dim=1)   # [S,3]
        smx = bmx.reshape(-1, MEGA_SUPER, 3).amax(dim=1)
        cols.append(torch.cat([smn, smx], dim=1))          # [S,6]
    return torch.cat(cols, dim=0).T.contiguous()           # [6, S_total]


def _mega_super_order(d_rows, o3, sbb, groups):
    """[ntiles, 1, n_supers] i32: per ray-tile visit order of each group's
    supers, nearest-first by the tile's conservative bundle entry distance
    into the super box (primary rays share the pinhole origin). The order
    is group-relative within each group's slice, and stable on ties.
    Heuristic only: every super is still slab-tested, so winners do not
    depend on it. d_rows: [3, M] unit directions, M a multiple of TILE."""
    nt = d_rows.shape[1] // TILE
    dt = d_rows.reshape(3, nt, TILE)
    olo = o3[:, None].expand(3, nt)
    entry = bundle_box_entry((olo, olo, dt.amin(dim=2), dt.amax(dim=2)), sbb)
    cols = []
    for _, _, count, sstart in groups:
        nsup = -(-count // MEGA_SUPER)
        cols.append(torch.argsort(entry[:, sstart:sstart + nsup], dim=1,
                                  stable=True))
    return torch.cat(cols, dim=1).to(torch.int32)[:, None, :].contiguous()


def _mega_table(scene, group_ids=None):
    """[38, P] f32 prim-scalar table over the groups of `group_ids`
    (default: all). Rows 0-11 inverse affine, 12-23 forward affine, 24
    shin, 25 rough, 26 emis, 27-30 rgba, 31 ok (0 = group-padding column,
    never hit), 32-34 world AABB min, 35-37 max (empty box for padding);
    materials per GLOBAL prim id."""
    if group_ids is None:
        group_ids = range(len(scene.group_codes))
    cols = []
    for gi in group_ids:
        pid = scene.group_prim[gi].long()
        inv = scene.group_inv[gi][:, :3, :4].reshape(-1, 12)
        trf = scene.group_transfo[gi][:, :3, :4].reshape(-1, 12)
        m = scene.mat[pid]                         # [P,4]
        c = scene.color[pid]                       # [P,4]
        okr = (pid >= 0).to(torch.float32)[:, None]
        bmn = torch.where(okr > 0, scene.prim_bb_min[pid], 1.0)
        bmx = torch.where(okr > 0, scene.prim_bb_max[pid], -1.0)
        cols.append(torch.cat([inv, trf, m[:, 0:3], c, okr, bmn, bmx], dim=1))
    return torch.cat(cols, dim=0).T.contiguous()   # [38, P]


def mega_inputs(scene, O, D, screen_tc, refract_ind) -> MegaInputs:
    """Pad and lay out one batch of camera rays for K1 (the pass-
    independent part of `raytrace_mega`). O: [3] origin, D: [n,3]
    directions (normalized here), screen_tc: [n,2]."""
    dev = D.device
    n = D.shape[0]
    np_ = -(-n // TILE) * TILE
    d = D / torch.linalg.vector_norm(D, dim=-1, keepdim=True)
    tc = screen_tc.to(torch.float32)
    if np_ != n:
        d = torch.cat([d, d.new_tensor([0.0, 0.0, 1.0]).expand(np_ - n, 3)])
        tc = torch.cat([tc, tc.new_zeros((np_ - n, 2))])
    d = d.contiguous()
    tc = tc.contiguous()
    o3 = torch.as_tensor(O, dtype=torch.float32, device=dev).reshape(3)
    fpar = torch.cat([o3, torch.full((1,), float(refract_ind),
                                     dtype=torch.float32, device=dev)])
    groups, total = _mega_meta(scene)
    cull = total >= MEGA_CULL_MIN_PRIMS
    sbb = ordr = None
    if cull:   # only the culled fold reads the super boxes and order
        sbb = _mega_super_boxes(scene)
        ordr = _mega_super_order(d.T, o3, sbb, groups)
    return MegaInputs(
        dirs=d, tc=tc, fpar=fpar, tab=_mega_table(scene), sbb=sbb, ordr=ordr,
        group_desc=torch.tensor(groups, dtype=torch.int32, device=dev),
        groups=groups, n=n, has_transparent=bool(scene.has_transparent),
        cull=cull)


def raytrace_mega(scene, O, D, screen_tc, pass_index: int, *,
                  nb_bounces: int, refract_ind, date=0.0):
    """Whole-pass megakernel route of models.montecarlo.raytrace.

    O: [3] camera origin (pinhole model), D: [N,3] ray dirs (normalized
    inside), screen_tc: [N,2]. Returns rgb [N,3]. The RNG schedule is
    bit-identical to the reference; float results match it to a few ulp.
    """
    inp = mega_inputs(scene, O, D, screen_tc, refract_ind)
    return mega_pass(inp, _rng.seed_y(pass_index, date), int(nb_bounces))
