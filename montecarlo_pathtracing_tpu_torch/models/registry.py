"""Integrator registry — the SrcLoader carousel.

The reference cycles GLSL integrator sources with O/P keys
(gl_viewer.h:148-220, montecarlo.cpp:292-304). Here the registry maps
names to integrator functions. Only `montecarlo` is ported; the other
names of the reference's carousel raise NotImplementedError naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

from .montecarlo import raytrace as montecarlo

_NOT_PORTED = ("montecarlo_mat", "montecarlo_mat_tr", "montecarlo_aos")

INTEGRATORS = {
    "montecarlo": montecarlo,
}


def get_integrator(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"integrator {name!r} is not ported yet: ROADMAP item A.10")
    if name not in INTEGRATORS:
        raise KeyError(
            f"unknown integrator {name!r}; have {sorted(INTEGRATORS)}")
    return INTEGRATORS[name]
