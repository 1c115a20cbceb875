"""Hemisphere sampling, ONB orientation, Schlick reflectance (SoA).

Port of the SoA half of montecarlo_pathtracing_tpu/ops/sampling.py
(:112-148), which the pallas-trace route's integrator uses
(tp/montecarlo.frag:49-98). Draws go through ops/rng.uniform_masked_soa
in the scalar GLSL's order, so the RNG counters stay bit-identical to
the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng, vec

PI = float(np.float32(2.0 * np.arccos(0.0)))  # raytracer_func.frag:9


def sample_hemisphere_soa(state, roughness, mask):
    """Masked hemisphere sample (tp/montecarlo.frag:49-70): exactly 2
    draws, the counters advanced only where `mask`. Returns (vec3,
    state)."""
    alpha = roughness * roughness
    u1, state = rng.uniform_masked_soa(state, mask)
    beta = 2.0 * PI * u1
    u2, state = rng.uniform_masked_soa(state, mask)
    tan_theta2 = -(alpha * alpha) * torch.log(1.0 - u2)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = (torch.cos(beta) * sin_theta, torch.sin(beta) * sin_theta,
             cos_theta)
    return vec.normalize(local), state


def random_ray_soa(state, d, roughness, mask):
    """Masked random_ray: the sample in an ONB about d
    (tp/montecarlo.frag:72-89)."""
    w = vec.normalize((d[0], d[1] + 5.0, d[2] + 3.0))
    u = vec.normalize(vec.cross(d, w))
    v = vec.normalize(vec.cross(d, u))
    local, state = sample_hemisphere_soa(state, roughness, mask)
    out = (u[0] * local[0] + v[0] * local[1] + d[0] * local[2],
           u[1] * local[0] + v[1] * local[1] + d[1] * local[2],
           u[2] * local[0] + v[2] * local[1] + d[2] * local[2])
    return vec.normalize(out), state


def schlick_soa(i, n, refract_ind):
    """Schlick's reflectance from the IOR slider, with the reference's
    rSchlick quirk (tp/montecarlo.frag:91-98)."""
    r0 = (refract_ind - 1.0) / (refract_ind + 1.0)
    r0 = r0 * r0
    x = 1.0 - vec.dot(n, i)
    x5 = x * x * x * x * x
    return torch.clamp(r0 + (1.0 - r0) * x5, 0.0, 1.0)
