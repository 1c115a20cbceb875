"""Scalar CPU oracle: literal re-execution of the shader logic.

The port's own copy of montecarlo_pathtracing_tpu/testing/cpu_ref.py,
with the port's RNG, scene codes and camera, so that it runs where JAX is
absent. It is the parity reference demanded by BASELINE.json ("allclose
image + gradient parity vs a CPU re-execution of the shader logic"): a
slow, pure numpy-float32, PER-PIXEL transcription of the GLSL program
flow — sequential RNG draws (rng.uniform_py), scalar while-loop path
state, the exact 4-case material branches of tp/montecarlo.frag:100-179
and the strict `dist < closest` brute-force closest-hit of the
intersectors (raytracer_func.frag:354-705).

It deliberately shares NO code with the port's vectorized torch routes or
its kernels — validating the masked-SIMD transformation, the per-lane RNG
counter schedule, and the sharding all at once. Primitive iteration order
matches the routes' fold order (groups by ANALYTIC_CODES, then mesh
instances; in-group by prim index; strictly-closer wins), so parity is
exact up to f32 reassociation noise.
"""
from __future__ import annotations

import numpy as np

from ..ops.rng import srand_py, uniform_py
from ..scene.scene import (
    ScenePrimitives, CODE_MESH, CODE_SPHERE, CODE_CUBE, CODE_CYLINDER,
    CODE_CONE, CODE_ORIENTED_QUAD,
)
from ..scene.device import ANALYTIC_CODES
from ..render.camera import camera_rays_np

F32 = np.float32
EPSILON = F32(1e-10)
BIAS = F32(1e-2)
FLT_MAX = F32(3.402823e38)
PI = F32(2.0 * np.arccos(0.0))


def _norm(v):
    return (v / np.sqrt(np.dot(v, v).astype(F32))).astype(F32)


def _reflect(i, n):
    return (i - F32(2.0) * np.dot(n, i).astype(F32) * n).astype(F32)


def _refract(i, n, eta):
    """GLSL built-in refract: vec3(0) on TIR."""
    eta = F32(eta)
    ndi = np.dot(n, i).astype(F32)
    k = F32(1.0) - eta * eta * (F32(1.0) - ndi * ndi)
    if k < 0.0:
        return np.zeros(3, F32)
    return (eta * i - (eta * ndi + np.sqrt(k).astype(F32)) * n).astype(F32)


def _mix(a, b, k):
    return ((F32(1.0) - F32(k)) * a + F32(k) * b).astype(F32)


def _apply(m, p):
    return (m[:3, :3] @ p + m[:3, 3]).astype(F32)


class Hit:
    __slots__ = ("dist", "pl", "pg", "prim", "shape", "dircode", "tri",
                 "mesh_inst")

    def __init__(self):
        self.dist = FLT_MAX
        self.pl = np.zeros(3, F32)
        self.pg = np.zeros(3, F32)
        self.prim = -1
        self.shape = -1
        self.dircode = -1
        self.tri = -1
        self.mesh_inst = -1


class CPUReference:
    """Oracle renderer over a (post-emissive-sort) ScenePrimitives."""

    def __init__(self, scene: ScenePrimitives, flat_face: bool = False):
        self.scene = scene
        self.flat_face = flat_face
        # fold order identical to ops/trace.trace
        self.order = []
        for code in ANALYTIC_CODES:
            for i, p in enumerate(scene.prims):
                if p.type == code:
                    self.order.append(i)
        self.mesh_insts = [i for i, p in enumerate(scene.prims)
                           if p.type == CODE_MESH]
        # pre-gather triangle data per instance (mesh-local)
        self.tris = {}
        for i in self.mesh_insts:
            g = scene.meshes[scene.prims[i].mesh_id]
            t = g.triangles
            self.tris[i] = (
                g.vertices[t[:, 0]].astype(F32),
                g.vertices[t[:, 1]].astype(F32),
                g.vertices[t[:, 2]].astype(F32),
                g.normals[t[:, 0]].astype(F32),
                g.normals[t[:, 1]].astype(F32),
                g.normals[t[:, 2]].astype(F32),
            )

    # -- shape tests in local frame (mirror ops/intersect semantics) ------

    def _shape_test(self, code, O, D):
        """Returns (a, dircode) local ray param or None."""
        if code == CODE_SPHERE:
            OO = np.dot(O, O).astype(F32)
            OD = np.dot(O, D).astype(F32)
            D2 = np.dot(D, D).astype(F32)
            delta4 = OD * OD - D2 * (OO - F32(1.0))
            if not delta4 > 0.0:
                return None
            sq = np.sqrt(delta4).astype(F32)
            a1 = -(OD + sq) / D2
            a2 = -(OD - sq) / D2
            if a1 > EPSILON:
                return F32(a1), 0
            if a2 > EPSILON:
                return F32(a2), 0
            return None
        if code == CODE_ORIENTED_QUAD:
            if D[2] > -EPSILON:
                return None
            a = -O[2] / D[2]
            px, py = O[0] + a * D[0], O[1] + a * D[1]
            if abs(px) > 1.0 or abs(py) > 1.0:
                return None
            return F32(a), 0
        if code == CODE_CUBE:
            al, face = FLT_MAX, -1
            for c in range(6):
                c0 = c // 2
                c1, c2 = (c0 + 1) % 3, (c0 + 2) % 3
                cd = F32(-1.0 + 2.0 * (c % 2))
                if abs(D[c0]) > EPSILON:
                    a = (cd - O[c0]) / D[c0]
                    if (a > EPSILON and abs(O[c1] + a * D[c1]) <= 1.0
                            and abs(O[c2] + a * D[c2]) <= 1.0 and a < al):
                        al, face = F32(a), c
            return (al, face) if face >= 0 else None
        if code == CODE_CYLINDER:
            al, cl = FLT_MAX, -1
            if abs(D[2]) > EPSILON:
                for codez, zp in ((0, F32(-1.0)), (1, F32(1.0))):
                    a = (zp - O[2]) / D[2]
                    rx, ry = O[0] + a * D[0], O[1] + a * D[1]
                    if a > EPSILON and rx * rx + ry * ry < 1.0 and a < al:
                        al, cl = F32(a), codez
            O2 = O[0] * O[0] + O[1] * O[1]
            OD = O[0] * D[0] + O[1] * D[1]
            D2 = D[0] * D[0] + D[1] * D[1]
            delta4 = OD * OD - D2 * (O2 - F32(1.0))
            if delta4 > 0.0:
                a = -(OD + np.sqrt(delta4).astype(F32)) / D2
                z = O[2] + a * D[2]
                if a > EPSILON and a < al and abs(z) < 1.0:
                    al, cl = F32(a), 2
            return (al, cl) if cl >= 0 else None
        if code == CODE_CONE:
            tl, cl = FLT_MAX, -1
            if abs(D[2]) > EPSILON:
                t0 = (F32(-1.0) - O[2]) / D[2]
                rx, ry = O[0] + t0 * D[0], O[1] + t0 * D[1]
                if t0 > EPSILON and rx * rx + ry * ry < 1.0 and t0 < tl:
                    tl, cl = F32(t0), 0
            coz = O[2] - F32(1.0)
            dco = D[0] * O[0] + D[1] * O[1] + D[2] * coz
            coco = O[0] * O[0] + O[1] * O[1] + coz * coz
            a_ = D[2] * D[2] - F32(0.8)
            b_ = F32(2.0) * (D[2] * coz - dco * F32(0.8))
            c_ = coz * coz - coco * F32(0.8)
            det = b_ * b_ - F32(4.0) * a_ * c_
            if det > 0.0:
                sq = np.sqrt(det).astype(F32)
                t1 = (-b_ - sq) / (F32(2.0) * a_)
                t2 = (-b_ + sq) / (F32(2.0) * a_)
                if abs(O[2] + t1 * D[2]) > 1.0:
                    t1 = FLT_MAX
                if abs(O[2] + t2 * D[2]) > 1.0:
                    t2 = FLT_MAX
                t = min(t1, t2)
                if t < tl:
                    tl, cl = F32(t), 2
            return (tl, cl) if cl >= 0 else None
        raise ValueError(code)

    # -- closest hit -------------------------------------------------------

    def trace(self, O, D):
        best = Hit()
        for i in self.order:
            p = self.scene.prims[i]
            inv = p.inv_transfo
            Oi = _apply(inv, O)
            Di = _norm(inv[:3, :3] @ D)
            r = self._shape_test(p.type, Oi, Di)
            if r is None:
                continue
            a, dircode = r
            pl = (Oi + a * Di).astype(F32)
            pg = _apply(p.transfo, pl)
            dist = np.sqrt(np.dot(O - pg, O - pg).astype(F32))
            if dist < best.dist:
                best.dist = F32(dist)
                best.pl, best.pg = pl, pg
                best.prim, best.shape, best.dircode = i, p.type, dircode
                best.tri = -1
        for i in self.mesh_insts:
            p = self.scene.prims[i]
            inv = p.inv_transfo
            Oi = _apply(inv, O)
            Di = _norm(inv[:3, :3] @ D)
            va, vb, vc = self.tris[i][:3]
            # vectorized Moller-Trumbore over this instance's triangles
            edge1 = vb - va
            edge2 = vc - va
            h = np.cross(Di[None], edge2)
            det = np.sum(edge1 * h, -1)
            with np.errstate(divide="ignore", invalid="ignore"):
                invd = F32(1.0) / det
                s = (Oi[None] - va).astype(F32)
                u = np.sum(s * h, -1) * invd
                q = np.cross(s, edge1)
                v = np.sum(Di[None] * q, -1) * invd
                a = np.sum(edge2 * q, -1) * invd
            ok = ((np.abs(det) >= EPSILON) & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0) & (a > EPSILON))
            if not ok.any():
                continue
            pl = Oi[None] + a[:, None] * Di[None]
            pg = pl @ p.mesh_transfo[:3, :3].T + p.mesh_transfo[:3, 3]
            dist = np.sqrt(np.sum((O[None] - pg) ** 2, -1).astype(F32))
            dist = np.where(ok, dist, FLT_MAX).astype(F32)
            j = int(np.argmin(dist))
            if dist[j] < best.dist:
                best.dist = F32(dist[j])
                best.pl = pl[j].astype(F32)
                best.pg = pg[j].astype(F32)
                best.prim, best.shape, best.dircode = i, CODE_MESH, 0
                best.tri = j
        return best

    # -- shading normal (raytracer_func.frag:783-897) ---------------------

    def intersection_info(self, hit, prev=(np.zeros(3, F32), np.zeros(3, F32))):
        if hit.shape < 0:
            return prev
        p = self.scene.prims[hit.prim]
        pl, pg = hit.pl, hit.pg
        if hit.shape == CODE_SPHERE:
            pt = F32(2.0) * pl
        elif hit.shape == CODE_CUBE:
            no = np.zeros(3, F32)
            no[hit.dircode // 2] = F32(1.0 if hit.dircode % 2 != 0 else -1.0)
            pt = pl + no
        elif hit.shape == CODE_CYLINDER:
            no = np.zeros(3, F32)
            if hit.dircode < 2:
                no[2] = F32(1.0 if hit.dircode % 2 != 0 else -1.0)
            else:
                no[:2] = pl[:2]
            pt = pl + no
        elif hit.shape == CODE_CONE:
            if hit.dircode == 1:
                return np.zeros(3, F32), pg
            if hit.dircode == 0:
                pt = pl + np.array([0, 0, -1], F32)
            else:
                rxy = np.sqrt(pl[0] * pl[0] + pl[1] * pl[1]).astype(F32)
                pt = pl + np.array([pl[0], pl[1], rxy / F32(2.0)], F32)
        elif hit.shape == CODE_ORIENTED_QUAD:
            pt = pl + np.array([0, 0, 1], F32)
        else:  # mesh
            va, vb, vc, na, nb, nc = self.tris[hit.prim]
            A, B, C = va[hit.tri], vb[hit.tri], vc[hit.tri]
            if self.flat_face:
                no = np.cross(B - A, C - A).astype(F32)
            else:
                PA, PB, PC = A - pl, B - pl, C - pl
                tA = np.linalg.norm(np.cross(PB, PC)).astype(F32)
                tB = np.linalg.norm(np.cross(PA, PC)).astype(F32)
                tC = np.linalg.norm(np.cross(PA, PB)).astype(F32)
                no = (na[hit.tri] * tA + nb[hit.tri] * tB
                      + nc[hit.tri] * tC).astype(F32)
            n = _norm(_apply(p.mesh_transfo, pl + no) - pg)
            return n, pg
        n = _norm(_apply(p.transfo, pt) - pg)
        return n, pg

    # -- sampling (tp/montecarlo.frag:49-98) ------------------------------

    def _sample_hemisphere(self, state, roughness):
        alpha = F32(roughness) * F32(roughness)
        u1, state = uniform_py(state)
        beta = F32(2.0) * PI * u1
        u2, state = uniform_py(state)
        tan2 = -(alpha * alpha) * np.log(F32(1.0) - u2).astype(F32)
        ct = F32(1.0) / np.sqrt(F32(1.0) + tan2).astype(F32)
        st = np.sqrt(max(F32(0.0), F32(1.0) - ct * ct)).astype(F32)
        local = np.array(
            [np.cos(beta) * st, np.sin(beta) * st, ct], F32)
        return _norm(local), state

    def _random_ray(self, state, d, roughness):
        w = _norm(np.array([d[0], d[1] + F32(5.0), d[2] + F32(3.0)], F32))
        u = _norm(np.cross(d, w))
        v = _norm(np.cross(d, u))
        m = np.stack([u, v, d], axis=1).astype(F32)
        local, state = self._sample_hemisphere(state, roughness)
        return _norm(m @ local), state

    def _schlick(self, i, n, ior):
        r0 = F32((ior - 1.0) / (ior + 1.0)) ** 2
        x = F32(1.0) - np.dot(n, i).astype(F32)
        return F32(np.clip(r0 + (F32(1.0) - r0) * x ** 5, 0.0, 1.0))

    # -- the path loop (tp/montecarlo.frag:100-188) -----------------------

    def random_path(self, D, O, state, nb_bounces, refract_ind):
        total = np.zeros(3, F32)
        attenu = np.full(3, 0.8, F32)
        N = np.zeros(3, F32)
        P = np.zeros(3, F32)
        for _ in range(nb_bounces):
            hit = self.trace(O, D)
            if hit.shape < 0:
                k = max(F32(0.0), D[2])
                sky = _mix(np.array([0.5, 0.5, 0.9], F32),
                           np.array([1.0, 1.0, 0.8], F32), k)
                return (total + attenu * sky).astype(F32)
            N, P = self.intersection_info(hit, prev=(N, P))
            p = self.scene.prims[hit.prim]
            mat, col = p.mat, p.color
            shin, rough, emis = F32(mat[0]), F32(mat[1]), F32(mat[2])
            alpha = F32(col[3])
            col3 = col[:3].astype(F32)
            ray, state = self._random_ray(state, N, F32(1.0) - rough)
            rs = self._schlick(D, N, refract_ind)
            R = _reflect(-ray, N)
            E = _norm(O - P)
            se = _mix(F32(100.0), F32(2.0), rough)
            spec = F32(max(F32(0.0), np.dot(E, R)) ** se)
            total = (total + col3 * F32(0.1)
                     + attenu * emis * (F32(1.0) - shin) * alpha).astype(F32)
            if emis > 0.5:
                return total
            if shin > 0.0 and alpha == 1.0:  # reflection
                attenu = (col3 * attenu + attenu * alpha * rs * spec
                          * _mix(attenu, col3, shin)).astype(F32)
                d2, state = self._random_ray(
                    state, _reflect(D, N), F32(1.0) - shin * rough)
                O, D = (P + BIAS * N).astype(F32), d2
            elif alpha < 1.0 and shin == 0.0:  # refraction
                attenu = (col3 * attenu
                          + attenu * (F32(1.0) - alpha) * (F32(1.0) - rs)
                          * spec * _mix(attenu, col3, shin)).astype(F32)
                O = (P - BIAS * N).astype(F32)
                D = _refract(D, N, refract_ind)
                hit2 = self.trace(O, D)
                N, P = self.intersection_info(hit2, prev=(N, P))
                O = (P + BIAS * N).astype(F32)
                D = _refract(D, -N, F32(1.0 / refract_ind))
            elif alpha < 1.0 and shin > 0.0:  # mixed
                r, state = uniform_py(state)
                if r > 0.5:
                    attenu = (col3 * attenu + attenu * alpha * rs * spec
                              * _mix(attenu, col3, shin)).astype(F32)
                    d2, state = self._random_ray(
                        state, _reflect(D, N), F32(1.0) - shin * rough)
                    O, D = (P + BIAS * N).astype(F32), d2
                else:
                    attenu = (col3 * attenu
                              + attenu * (F32(1.0) - alpha) * (F32(1.0) - rs)
                              * spec * _mix(attenu, col3, shin)).astype(F32)
                    O = (P - BIAS * N).astype(F32)
                    # reference quirk: D is NOT refracted before the inner
                    # trace in the mixed case (tp/montecarlo.frag:160-166)
                    hit2 = self.trace(O, D)
                    N, P = self.intersection_info(hit2, prev=(N, P))
                    O = (P + BIAS * N).astype(F32)
                    D = _refract(D, -N, F32(1.0 / refract_ind))
            else:  # diffuse
                attenu = (col3 * attenu + attenu * spec
                          * _mix(attenu, col3, shin)).astype(F32)
                O, D = (P + BIAS * N).astype(F32), ray
        return np.zeros(3, F32)  # bounce-cap: black (:178)

    def raytrace(self, D, O, u, v, pass_index, nb_bounces, refract_ind,
                 date=0.0):
        state = srand_py(u, v, pass_index, date)
        return self.random_path(_norm(D), O.astype(F32), list(state),
                                nb_bounces, refract_ind)

    def render(self, proj, view, width, height, spp, nb_bounces,
               refract_ind=1.0, date=0.0):
        """Full progressive render, row 0 = bottom. SLOW — use tiny sizes."""
        origin, dirs, tc = camera_rays_np(proj, view, width, height)
        acc = np.zeros((height, width, 3), F32)
        for p in range(spp):
            for y in range(height):
                for x in range(width):
                    acc[y, x] += self.raytrace(
                        dirs[y, x], origin, tc[y, x, 0], tc[y, x, 1],
                        p, nb_bounces, refract_ind, date)
        return acc / F32(spp)
