"""AoS form of the Monte Carlo integrator ("montecarlo_aos").

Port of montecarlo_pathtracing_tpu/models/montecarlo_aos.py, the readable
[N, 3]-layout twin of models/montecarlo.py, kept in the carousel for
cross-checking and CPU debugging; both render the same images.

The reference's integrator (tp/montecarlo.frag:100-188) as one batched
bounce loop: the GLSL path "stack" pops one entry and pushes at most one
per iteration (:109-177), so it is plain iterative path state (O, D,
attenuation, total, result, done mask, RNG counters) for every lane, with
divergence mapped to masks. The reference's quirks are the spec, notably:
  - initial attenuation vec3(0.8) (:107)
  - sky miss: total + attenu * mix((.5,.5,.9),(1,1,.8), max(0,D.z)) (:119)
  - `total += col*0.1 + attenu*emissivity*(1-shininess)*alpha` ambient leak
    (:136); emissive threshold 0.5 terminates the path returning total
    (:139,174-175)
  - the Phong spec lobe is built from the DIFFUSE sample `ray` in every
    material case (:131-134)
  - refraction marches through the object: refract in, re-trace from
    P - BIAS*N to find the exit, refract out with 1/IOR (:146-153); on an
    inner-trace miss (N, P) keep their outer values. The re-trace runs on
    every lane, masked, whatever the scene's materials
  - the MIXED case's refract sub-branch re-traces with the UN-refracted D
    (:160-166)
  - bounce-cap exhaustion returns BLACK, discarding the accumulated total
    (:178)
  - `col.a == 1` / `mat.r == 0` exact float compares select the cases

RNG draw parity: masked draws advance only lanes that would reach the
corresponding random_float() in the scalar program: 2 draws per hit
(`ray`), +1 for the mixed-case coin, +2 for the reflect-branch
`random_ray`.

use_kernels is passed on to both traces of a bounce (ops/trace.trace):
groups of at least 128 prims take K3a, mesh instances K4a.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import rng
from ..ops.sampling import random_ray_masked, schlick
from ..ops.shading import intersection_info
from ..ops.trace import trace
from ..utils.transforms import dot3, mix, normalize, reflect, refract_glsl

BIAS = float(np.float32(1e-2))  # raytracer_func.frag:14

SKY_LOW = (0.5, 0.5, 0.9)    # tp/montecarlo.frag:119
SKY_HIGH = (1.0, 1.0, 0.8)


def sky_color(d):
    k = torch.clamp(d[..., 2], min=0.0)[..., None]
    lo = d.new_tensor(SKY_LOW)
    hi = d.new_tensor(SKY_HIGH)
    return (1.0 - k) * lo + k * hi


def random_path(scene, O, D, state, *, nb_bounces: int, refract_ind,
                detach_sampling: bool = False, use_kernels: bool = False):
    """One path per lane. O, D: [N,3] world rays (D normalized; O may be
    one [3] origin), state: int64 [N,3] RNG counters. Returns (rgb [N,3],
    state)."""
    n = D.shape[0]
    dev = D.device
    O = torch.broadcast_to(torch.as_tensor(O, dtype=torch.float32,
                                           device=dev), D.shape)
    unit_z = D.new_tensor([0.0, 0.0, 1.0]).expand(D.shape)
    ior = torch.as_tensor(refract_ind, dtype=torch.float32, device=dev)

    def maybe_detach(x):
        return x.detach() if detach_sampling else x

    attenu = torch.full_like(D, 0.8)                 # initial attenuation
    total = torch.zeros_like(D)
    result = torch.zeros_like(D)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(nb_bounces):
        hit = trace(scene, O, D, use_kernels=use_kernels)

        active = ~done
        is_hit = hit.shape >= 0
        miss_now = active & ~is_hit
        live = active & is_hit
        live3 = live[..., None]

        # sky fallback (:117-119)
        result = torch.where(miss_now[..., None],
                             total + attenu * sky_color(D), result)
        done = done | miss_now

        n_raw, p_raw = intersection_info(scene, hit)
        # sanitize non-live lanes so no NaNs enter the masked math
        N = torch.where(live3, n_raw, unit_z)
        P = torch.where(live3, p_raw, O + D)

        prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1).long()
        mat = scene.mat[prim]      # [N,4] (shin, rough, emis, area)
        col = scene.color[prim]    # [N,4]
        col3 = col[..., :3]
        shin, rough, emis, alpha = (mat[..., 0], mat[..., 1], mat[..., 2],
                                    col[..., 3])

        # draws 1-2: the diffuse sample, for every hit lane (:127)
        ray, state = random_ray_masked(state, N, 1.0 - rough, live)
        ray = maybe_detach(ray)

        rs = schlick(D, N, ior)                              # (:129)
        R = reflect(-ray, N)                                 # (:131)
        E = normalize(O - P)                     # safe: P != O on live
        se = mix(100.0, 2.0, rough)                          # (:133)
        spec = torch.pow(torch.clamp(dot3(E, R), min=0.0), se)

        # ambient leak + emissive gather (:136)
        total = torch.where(
            live3,
            total + col3 * 0.1
            + attenu * (emis * (1.0 - shin) * alpha)[..., None],
            total)

        # emissive termination (:139,174-175)
        emissive = emis > 0.5
        result = torch.where((live & emissive)[..., None], total, result)
        done = done | (live & emissive)
        cont = live & ~emissive

        # 4-case material logic (:141-172); exact float compares are the spec
        refl_case = (shin > 0.0) & (alpha == 1.0)
        refr_case = (alpha < 1.0) & (shin == 0.0)
        mixed_case = (alpha < 1.0) & (shin > 0.0)

        # draw 3: the mixed-case coin (:155)
        r, state = rng.uniform_masked(state, cont & mixed_case)
        choose_refl = refl_case | (mixed_case & (r > 0.5))
        refr_lane = cont & (refr_case | (mixed_case & ~(r > 0.5)))

        # draws 4-5: the reflect-branch sample (:143,158)
        rray, state = random_ray_masked(
            state, reflect(D, N), 1.0 - shin * rough, cont & choose_refl)
        rray = maybe_detach(rray)

        # refraction inner re-trace (:146-153; mixed sub-branch keeps the
        # un-refracted D, :160-166)
        refr3 = refr_lane[..., None]
        d_inner = torch.where((cont & refr_case)[..., None],
                              refract_glsl(D, N, ior), D)
        d_inner = torch.where(refr3, d_inner, unit_z)
        o_inner = torch.where(refr3, P - BIAS * N, O)
        hit2 = trace(scene, o_inner, d_inner, use_kernels=use_kernels)
        n2_raw, p2_raw = intersection_info(scene, hit2, prev_n=N, prev_p=P)
        N2 = torch.where(refr3, n2_raw, unit_z)
        P2 = torch.where(refr3, p2_raw, P)
        d_exit = refract_glsl(d_inner, -N2, 1.0 / ior)

        # attenuation updates (:142,147,161,170)
        base = col3 * attenu
        spec_mix = mix(attenu, col3, shin[..., None])
        att_refl = base + attenu * (alpha * rs * spec)[..., None] * spec_mix
        att_refr = base + attenu * (
            (1.0 - alpha) * (1.0 - rs) * spec)[..., None] * spec_mix
        att_diff = base + attenu * spec[..., None] * spec_mix

        choose3 = choose_refl[..., None]
        new_attenu = torch.where(refr3, att_refr,
                                 torch.where(choose3, att_refl, att_diff))
        new_O = torch.where(refr3, P2 + BIAS * N2, P + BIAS * N)
        new_D = torch.where(refr3, d_exit,
                            torch.where(choose3, rray, ray))

        cont3 = cont[..., None]
        O = torch.where(cont3, new_O, O)
        D = torch.where(cont3, new_D, D)
        attenu = torch.where(cont3, new_attenu, attenu)

    # bounce-cap exhaustion returns black (:178)
    return torch.where(done[..., None], result, 0.0), state


def raytrace(scene, O, D, screen_tc, pass_index: int, *, nb_bounces: int,
             refract_ind, date=0.0, detach_sampling: bool = False,
             use_kernels: bool = False):
    """tp/montecarlo.frag:182-188: srand + one random path per lane.

    O: [3] camera origin; D: [N,3] ray dirs; screen_tc: [N,2].
    Returns rgb [N,3], one 1-spp pass, to be accumulated progressively.
    use_kernels folds large groups through K3a and mesh instances through
    K4a (ops/trace.trace); the renderer passes it from its route.
    """
    state = rng.srand(screen_tc, pass_index, date)
    rgb, _ = random_path(
        scene, O, normalize(D), state,
        nb_bounces=nb_bounces, refract_ind=refract_ind,
        detach_sampling=detach_sampling, use_kernels=use_kernels)
    return rgb
