"""The Monte Carlo path-tracing integrator: routing and the SoA wavefront.

Port of montecarlo_pathtracing_tpu/models/montecarlo.py (`raytrace`,
:280-354, and `random_path_soa`, :78-277). Semantics are the reference
integrator verbatim (tp/montecarlo.frag:100-188); see the JAX module for
the quirk list: the vec3(0.8) initial attenuation, the sky mix, the
ambient leak, the Phong spec from the diffuse sample, the refraction
march-through with stale (N, P) on an inner miss, emissive termination
and bounce-cap exhaustion returning black, with the 2+1+2 masked draw
schedule.

Four routes, chosen as the reference chooses them:
  - the whole-pass megakernel (models/megakernel.py, kernel K1) for
    analytic scenes of up to 4096 prims;
  - the fused per-bounce route (models/bounce_kernel.py, kernel K2) for
    mesh scenes and analytic scenes past the prim-table cap;
  - the pallas-trace route, `random_path_soa` over `ops/trace.trace_soa`
    (kernels K3a, K3b, K4a, K5, K6), when the other two are turned off or
    gradients are asked for (detach_sampling);
  - the dense route (use_kernels=False), `random_path_soa` over the
    dense AoS fold `ops/trace.trace`: the reference semantics, and the
    route whose trace is differentiated (the IOR gradient's geometric
    term flows through the refraction exit points).
"""
from __future__ import annotations

import torch

from ..ops import rng, vec
from ..ops.pallas_trace import RAY_TILE
from ..ops.sampling import random_ray_soa, schlick_soa
from ..ops.shading import intersection_info_soa
from ..ops.sort_rays import PARK_Z, ray_sort_key, sort_wavefront
from ..ops.trace import HitS, trace, trace_soa
from .bounce_kernel import fused_eligible, raytrace_fused
from .megakernel import (
    BIAS, SKY_HIGH, SKY_LOW, mega_eligible, raytrace_mega)


def sky_color_soa(d):
    k = torch.clamp(d[2], min=0.0)
    return tuple((1.0 - k) * lo + k * hi for lo, hi in zip(SKY_LOW, SKY_HIGH))


def _trace(scene, o, d, use_kernels, cull_chunks, nondiff):
    """SoA closest hit: through the trace kernels (trace_soa) with
    use_kernels, else through the dense AoS fold (ops/trace.trace).
    nondiff detaches the rays in and every hit field out (the kernels
    have no backward, and need none: hit geometry does not depend on the
    differentiable material leaves)."""
    if nondiff:
        o = tuple(c.detach() for c in o)
        d = tuple(c.detach() for c in d)
    if use_kernels:
        hit = trace_soa(scene, o, d, cull_chunks=cull_chunks)
    else:
        h = trace(scene, vec.to_aos(o), vec.to_aos(d))
        hit = HitS(h.dist, h.prim, h.shape, h.dircode, h.tri,
                   vec.from_aos(h.pl), vec.from_aos(h.pg))
    if nondiff:
        hit = HitS(*(tuple(c.detach() for c in f) if isinstance(f, tuple)
                     else f.detach() for f in hit))
    return hit


def random_path_soa(scene, o, d, state, *, nb_bounces: int, refract_ind,
                    detach_sampling: bool = False,
                    use_kernels: bool = False,
                    cull_chunks: bool | None = None,
                    nondiff_trace: bool = False, sort_rays: bool = False):
    """One path per lane. o, d: vec3 of [N] (d normalized; with
    use_kernels N a multiple of RAY_TILE), state: (s0, s1, s2) int64 [N]
    RNG counters in [0, 2**32). Returns (rgb vec3, state). use_kernels
    traces through the trace kernels, else through the dense fold.

    sort_rays: re-sort the wavefront before each bounce by direction
    octant and origin Morton code (ops/sort_rays), parking finished rays
    where every box test fails, and undo the permutation at the end. The
    per-lane arithmetic does not depend on the order."""
    n = d[0].shape[0]
    dev = d[0].device
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    unit_z = (z, z, one)
    # a number is filled in on the device (torch.as_tensor of a number
    # copies it through a synchronous cudaMemcpy); a tensor, the IOR leaf
    # of render/diff.py, keeps its graph
    ior = (torch.as_tensor(refract_ind, dtype=torch.float32, device=dev)
           if isinstance(refract_ind, torch.Tensor) else
           torch.full((), refract_ind, dtype=torch.float32, device=dev))
    if sort_rays:
        sort_lo = scene.prim_bb_min.amin(dim=0)
        sort_hi = scene.prim_bb_max.amax(dim=0)
    # one [8, nb_prims] material + colour table: one gather per bounce
    matcol_t = torch.cat([scene.mat.T, scene.color.T], dim=0)

    def maybe_detach(v):
        return tuple(c.detach() for c in v) if detach_sampling else v

    attenu = (torch.full((n,), 0.8, dtype=torch.float32, device=dev),) * 3
    total = (z, z, z)
    result = (z, z, z)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane = torch.arange(n, device=dev)
    for _ in range(nb_bounces):
        if sort_rays:
            # park finished rays outside every box, pointing away, then
            # compact the wavefront into coherent bundles
            o = vec.where(done, (z, z, torch.full_like(z, PARK_Z)), o)
            d = vec.where(done, unit_z, d)
            key = ray_sort_key(o, d, done, sort_lo, sort_hi)
            flat = [*o, *d, *attenu, *total, *result, done, *state, lane]
            _, flat = sort_wavefront(key, flat)
            o, d = tuple(flat[0:3]), tuple(flat[3:6])
            attenu, total = tuple(flat[6:9]), tuple(flat[9:12])
            result = tuple(flat[12:15])
            done = flat[15]
            state = tuple(flat[16:19])
            lane = flat[19]
        hit = _trace(scene, o, d, use_kernels, cull_chunks, nondiff_trace)

        active = ~done
        is_hit = hit.shape >= 0
        miss_now = active & ~is_hit
        live = active & is_hit

        # sky fallback (:117-119)
        result = vec.where(miss_now,
                           vec.add(total, vec.mul(attenu, sky_color_soa(d))),
                           result)
        done = done | miss_now

        n_raw, p_raw = intersection_info_soa(scene, hit)
        # sanitize non-live lanes so no NaNs enter the masked math
        N = vec.where(live, n_raw, unit_z)
        P = vec.where(live, p_raw, vec.add(o, d))

        prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1).long()
        mcrow = matcol_t[:, prim]                      # [8, N]
        shin, rough, emis = mcrow[0], mcrow[1], mcrow[2]
        col3 = (mcrow[4], mcrow[5], mcrow[6])
        alpha = mcrow[7]

        # draws 1-2: the diffuse sample, for every hit lane (:127)
        ray, state = random_ray_soa(state, N, 1.0 - rough, live)
        ray = maybe_detach(ray)

        rs = schlick_soa(d, N, ior)                    # (:129)
        R = vec.reflect(vec.neg(ray), N)               # (:131)
        E = vec.normalize(vec.sub(o, P), eps=1e-30)
        se = (1.0 - rough) * 100.0 + rough * 2.0       # (:133)
        # pow with a zero-base guard (the gradient of x**se in se is NaN
        # at x == 0); forward-identical to pow(max(0, dot), se)
        er = torch.clamp(vec.dot(E, R), min=0.0)
        er_safe = torch.where(er > 0.0, er, 1.0)
        spec = torch.where(er > 0.0, torch.pow(er_safe, se), 0.0)

        # ambient leak + emissive gather (:136)
        emit = emis * (1.0 - shin) * alpha
        total = vec.where(live, vec.add(total, vec.add(
            vec.scale(col3, 0.1), vec.scale(attenu, emit))), total)

        # emissive termination (:139,174-175)
        emissive = emis > 0.5
        result = vec.where(live & emissive, total, result)
        done = done | (live & emissive)
        cont = live & ~emissive

        # 4-case material logic (:141-172); exact float compares are spec
        refl_case = (shin > 0.0) & (alpha == 1.0)
        refr_case = (alpha < 1.0) & (shin == 0.0)
        mixed_case = (alpha < 1.0) & (shin > 0.0)

        # draw 3: the mixed-case coin (:155)
        r, state = rng.uniform_masked_soa(state, cont & mixed_case)
        choose_refl = refl_case | (mixed_case & (r > 0.5))
        refr_lane = cont & (refr_case | (mixed_case & ~(r > 0.5)))

        # draws 4-5: the reflect-branch sample (:143,158)
        rray, state = random_ray_soa(state, vec.reflect(d, N),
                                     1.0 - shin * rough, cont & choose_refl)
        rray = maybe_detach(rray)

        # refraction re-trace (:146-153; mixed keeps the un-refracted D);
        # a scene with no transparent material never runs it
        if scene.has_transparent:
            d_inner = vec.where(cont & refr_case,
                                vec.refract_glsl(d, N, ior), d)
            d_inner = vec.where(refr_lane, d_inner, unit_z)
            if sort_rays:
                # park non-refracting lanes high above the scene, keeping
                # x/y so mixed tiles' bundles stay laterally tight
                park = (o[0], o[1], torch.full_like(z, PARK_Z))
            else:
                park = o
            o_inner = vec.where(refr_lane, vec.sub(P, vec.scale(N, BIAS)),
                                park)
            hit2 = _trace(scene, o_inner, d_inner, use_kernels, cull_chunks,
                          nondiff_trace)
            n2_raw, p2_raw = intersection_info_soa(scene, hit2, prev=(N, P))
            N2 = vec.where(refr_lane, n2_raw, unit_z)
            P2 = vec.where(refr_lane, p2_raw, P)
            d_exit = vec.refract_glsl(d_inner, vec.neg(N2), 1.0 / ior)
        else:
            N2, P2 = N, P
            d_exit = unit_z

        # attenuation updates (:142,147,161,170)
        base = vec.mul(col3, attenu)
        spec_mix = vec.mix(attenu, col3, shin)
        att_refl = vec.add(base, vec.mul(
            vec.scale(attenu, alpha * rs * spec), spec_mix))
        att_refr = vec.add(base, vec.mul(
            vec.scale(attenu, (1.0 - alpha) * (1.0 - rs) * spec), spec_mix))
        att_diff = vec.add(base, vec.mul(vec.scale(attenu, spec), spec_mix))

        new_attenu = vec.where(refr_lane, att_refr,
                               vec.where(choose_refl, att_refl, att_diff))
        new_o = vec.where(refr_lane, vec.add(P2, vec.scale(N2, BIAS)),
                          vec.add(P, vec.scale(N, BIAS)))
        new_d = vec.where(refr_lane, d_exit,
                          vec.where(choose_refl, rray, ray))

        o = vec.where(cont, new_o, o)
        d = vec.where(cont, new_d, d)
        attenu = vec.where(cont, new_attenu, attenu)

    # bounce-cap exhaustion returns black (:178)
    rgb = vec.where(done, result, (z, z, z))
    if sort_rays:
        # undo the accumulated permutations
        rgb_s = torch.zeros((3, n), dtype=torch.float32, device=dev)
        rgb_s[:, lane] = torch.stack(rgb)
        rgb = (rgb_s[0], rgb_s[1], rgb_s[2])
        st_s = torch.zeros((3, n), dtype=state[0].dtype, device=dev)
        st_s[:, lane] = torch.stack(state)
        state = (st_s[0], st_s[1], st_s[2])
    return rgb, state


def raytrace(scene, O, D, screen_tc, pass_index: int, *, nb_bounces: int,
             refract_ind, date=0.0, detach_sampling: bool = False,
             use_kernels: bool = False,
             use_megakernel: bool | None = None,
             use_fused: bool | None = None,
             cull_chunks: bool | None = None,
             nondiff_trace: bool | None = None,
             sort_rays: bool | None = None,
             mega_memo=None):
    """tp/montecarlo.frag:182-188: srand + one random path per lane.

    O [3], D [N,3], screen_tc [N,2] in; rgb [N,3] out, on the tensors'
    device. use_kernels (the reference's use_pallas) asks for the kernel
    routes. use_megakernel=None routes to the megakernel when kernels are
    on, gradients are not (detach_sampling off), and the scene is
    analytic and small enough for the prim table; otherwise use_fused=None
    routes to the fused per-bounce kernel under the same conditions when
    the scene has meshes or large analytic groups. A forced megakernel
    wins over the fused route, as in the reference renderer's levels.
    Everything else with kernels on takes the pallas-trace route:
    cull_chunks (None = auto) chooses its kernels (ops/trace.trace_soa),
    nondiff_trace (None = detach_sampling) detaches its traces, and
    sort_rays (None = auto: on for multi-bounce renders without
    gradients) re-sorts its wavefront between bounces. With kernels off
    the dense route runs: no padding, and nondiff_trace and sort_rays
    resolve to False (the rays stay in their order, the trace in the
    backward pass). mega_memo (a megakernel.MegaMemo) keeps the
    megakernel's inputs across calls, and the fused route's in
    whole-path mode; the other routes ignore it.
    """
    if nondiff_trace is None:
        nondiff_trace = use_kernels and detach_sampling
    if use_megakernel is None:
        use_megakernel = (use_kernels and not detach_sampling
                          and mega_eligible(scene))
    if use_megakernel:
        return raytrace_mega(
            scene, O, D, screen_tc, pass_index, nb_bounces=nb_bounces,
            refract_ind=refract_ind, date=date, mega_memo=mega_memo)
    if use_fused is None:
        use_fused = (use_kernels and not detach_sampling
                     and fused_eligible(scene))
    if use_fused:
        return raytrace_fused(
            scene, O, D, screen_tc, pass_index, nb_bounces=nb_bounces,
            refract_ind=refract_ind, date=date, mega_memo=mega_memo)
    if sort_rays is None:
        sort_rays = (bool(use_kernels) and not detach_sampling
                     and nb_bounces > 1)

    # the pallas-trace route pads to RAY_TILE with unit-z dummy rays; the
    # dense route takes the rays as they are
    dev = D.device
    n = D.shape[0]
    pad = -(-n // RAY_TILE) * RAY_TILE if use_kernels else n
    dn = D / torch.sqrt((D * D).sum(dim=-1, keepdim=True))
    z = torch.zeros((pad,), dtype=torch.float32, device=dev)
    dx, dy, dz = z.clone(), z.clone(), z + 1.0
    u, v = z.clone(), z.clone()
    dx[:n], dy[:n], dz[:n] = dn[:, 0], dn[:, 1], dn[:, 2]
    u[:n], v[:n] = screen_tc[:, 0], screen_tc[:, 1]
    o3 = torch.as_tensor(O, dtype=torch.float32, device=dev).reshape(3)
    o = (z + o3[0], z + o3[1], z + o3[2])
    state = rng.srand_soa(u, v, pass_index, date)
    rgb, _ = random_path_soa(
        scene, o, (dx, dy, dz), state, nb_bounces=nb_bounces,
        refract_ind=refract_ind, detach_sampling=detach_sampling,
        use_kernels=use_kernels, cull_chunks=cull_chunks,
        nondiff_trace=nondiff_trace, sort_rays=sort_rays)
    return torch.stack(rgb, dim=-1)[:n]
