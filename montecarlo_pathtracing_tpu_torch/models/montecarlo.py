"""The Monte Carlo path-tracing integrator: routing.

Port of the routing of montecarlo_pathtracing_tpu/models/montecarlo.py
(`raytrace`, :280-312). Semantics are the reference integrator verbatim
(tp/montecarlo.frag:100-188); see the JAX module for the quirk list. So
far one route is ported: the whole-pass megakernel (models/megakernel.py,
kernel K1), which serves every analytic scene of up to 4096 prims. The
other routes raise NotImplementedError naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

from .megakernel import mega_eligible, raytrace_mega


def raytrace(scene, O, D, screen_tc, pass_index: int, *, nb_bounces: int,
             refract_ind, date=0.0, detach_sampling: bool = False,
             use_kernels: bool = False,
             use_megakernel: bool | None = None):
    """tp/montecarlo.frag:182-188: srand + one random path per lane.

    O [3], D [N,3], screen_tc [N,2] in; rgb [N,3] out, on the tensors'
    device. use_kernels (the reference's use_pallas) asks for the kernel
    routes; use_megakernel=None routes to the megakernel when kernels are
    on, gradients are not (detach_sampling off), and the scene is
    analytic and small enough for the prim table.
    """
    if use_megakernel is None:
        use_megakernel = (use_kernels and not detach_sampling
                          and mega_eligible(scene))
    if use_megakernel:
        return raytrace_mega(
            scene, O, D, screen_tc, pass_index, nb_bounces=nb_bounces,
            refract_ind=refract_ind, date=date)
    if use_kernels:
        raise NotImplementedError(
            "the fused per-bounce route (kernel K2, mesh and >4096-prim "
            "scenes; ROADMAP item A.8) and the pallas-trace route (kernels "
            "K3-K6; item A.9) are not ported yet")
    raise NotImplementedError(
        "the dense route is not ported yet: ROADMAP item A.7")
