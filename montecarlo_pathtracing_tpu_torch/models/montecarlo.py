"""The Monte Carlo path-tracing integrator: routing.

Port of the routing of montecarlo_pathtracing_tpu/models/montecarlo.py
(`raytrace`, :280-323). Semantics are the reference integrator verbatim
(tp/montecarlo.frag:100-188); see the JAX module for the quirk list. Two
routes are ported: the whole-pass megakernel (models/megakernel.py,
kernel K1), which serves every analytic scene of up to 4096 prims, and
the fused per-bounce route (models/bounce_kernel.py, kernel K2), which
serves mesh scenes and analytic scenes past the prim-table cap. The
other routes raise NotImplementedError naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

from .bounce_kernel import fused_eligible, raytrace_fused
from .megakernel import mega_eligible, raytrace_mega


def raytrace(scene, O, D, screen_tc, pass_index: int, *, nb_bounces: int,
             refract_ind, date=0.0, detach_sampling: bool = False,
             use_kernels: bool = False,
             use_megakernel: bool | None = None,
             use_fused: bool | None = None):
    """tp/montecarlo.frag:182-188: srand + one random path per lane.

    O [3], D [N,3], screen_tc [N,2] in; rgb [N,3] out, on the tensors'
    device. use_kernels (the reference's use_pallas) asks for the kernel
    routes. use_megakernel=None routes to the megakernel when kernels are
    on, gradients are not (detach_sampling off), and the scene is
    analytic and small enough for the prim table; otherwise use_fused=None
    routes to the fused per-bounce kernel under the same conditions when
    the scene has meshes or large analytic groups. A forced megakernel
    wins over the fused route, as in the reference renderer's levels.
    """
    if use_megakernel is None:
        use_megakernel = (use_kernels and not detach_sampling
                          and mega_eligible(scene))
    if use_megakernel:
        return raytrace_mega(
            scene, O, D, screen_tc, pass_index, nb_bounces=nb_bounces,
            refract_ind=refract_ind, date=date)
    if use_fused is None:
        use_fused = (use_kernels and not detach_sampling
                     and fused_eligible(scene))
    if use_fused:
        return raytrace_fused(
            scene, O, D, screen_tc, pass_index, nb_bounces=nb_bounces,
            refract_ind=refract_ind, date=date)
    if use_kernels:
        raise NotImplementedError(
            "the pallas-trace route (kernels K3-K6; ROADMAP item A.9) is "
            "not ported yet")
    raise NotImplementedError(
        "the dense route is not ported yet: ROADMAP item A.7")
