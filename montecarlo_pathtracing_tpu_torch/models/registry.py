"""Integrator registry — the SrcLoader carousel.

The reference cycles GLSL integrator sources with O/P keys
(gl_viewer.h:148-220, montecarlo.cpp:292-304). Here the registry maps
names to integrator functions, the four of the reference's carousel
(montecarlo_pathtracing_tpu/models/registry.py): the SoA integrator with
its routes, the two single-intersection stubs, and the AoS twin.
"""
from __future__ import annotations

from .montecarlo import raytrace as montecarlo
from .montecarlo_aos import raytrace as montecarlo_aos
from .stubs import raytrace_mat as montecarlo_mat
from .stubs import raytrace_mat_tr as montecarlo_mat_tr

# order matches the reference's carousel list (montecarlo.cpp:27);
# montecarlo_aos is the readable AoS twin of the SoA integrator
INTEGRATORS = {
    "montecarlo": montecarlo,
    "montecarlo_mat": montecarlo_mat,
    "montecarlo_mat_tr": montecarlo_mat_tr,
    "montecarlo_aos": montecarlo_aos,
}


def get_integrator(name: str):
    if name not in INTEGRATORS:
        raise KeyError(
            f"unknown integrator {name!r}; have {sorted(INTEGRATORS)}")
    return INTEGRATORS[name]
