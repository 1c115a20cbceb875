"""Hemisphere sampling, ONB orientation, Schlick reflectance.

Port of montecarlo_pathtracing_tpu/ops/sampling.py: the integrator's
sampling routines (tp/montecarlo.frag:49-98, tp/hsphere.vert) over
explicit RNG counter state, in AoS form ([..., 3] directions, [..., 3]
int64 state; the AoS integrator and the stubs) and in SoA form (vec3
tuples; the SoA integrator). Draws go through ops/rng in the scalar
GLSL's order, so the RNG counters stay bit-identical to the reference's,
and the two forms give the same directions bit for bit. Also the two
deliberately wrong samplers (tp/hsphere_wrong_sampling.vert,
tp/hsphere_wrong2_sampling.vert), the negative controls of the
statistics tests.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng, vec
from ..utils.transforms import cross3, dot3, normalize

PI = float(np.float32(2.0 * np.arccos(0.0)))  # raytracer_func.frag:9


def _hemisphere(u1, u2, roughness):
    """The sample of draws u1, u2 in the local frame, unnormalized
    (tp/montecarlo.frag:49-70): alpha = roughness^2, beta = 2*pi*u1,
    tan^2(theta) = -alpha^2 * ln(1 - u2)."""
    alpha = roughness * roughness
    beta = 2.0 * PI * u1
    tan_theta2 = -(alpha * alpha) * torch.log(1.0 - u2)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return (torch.cos(beta) * sin_theta, torch.sin(beta) * sin_theta,
            cos_theta)


def sample_hemisphere(state, roughness):
    """Beckmann-like roughness-driven hemisphere sample
    (tp/montecarlo.frag:49-70). Draws exactly 2 randoms, in this order.
    Returns (dir [..., 3], state)."""
    u1, state = rng.uniform(state)
    u2, state = rng.uniform(state)
    return normalize(torch.stack(_hemisphere(u1, u2, roughness), dim=-1)), \
        state


def orient_frame(d):
    """ONB around direction d via the fixed non-collinear
    W = normalize((D.x, D.y+5, D.z+3)) (tp/montecarlo.frag:82-86).

    Returns the 3x3 change-of-basis matrix M = [U V D] as [..., 3, 3]
    (columns U, V, D), so world = M @ local."""
    w = normalize(torch.stack([d[..., 0], d[..., 1] + 5.0, d[..., 2] + 3.0],
                              dim=-1))
    u = normalize(cross3(d, w))
    v = normalize(cross3(d, u))
    return torch.stack([u, v, d], dim=-1)


def _to_world(m, local):
    """M @ local as a sum of elementwise products, in the order of the
    SoA form (random_ray_soa)."""
    return (m[..., :, 0] * local[..., 0:1] + m[..., :, 1] * local[..., 1:2]
            + m[..., :, 2] * local[..., 2:3])


def random_ray(state, d, roughness):
    """Sample a direction about d with the given roughness param
    (tp/montecarlo.frag:72-89). Draws exactly 2 randoms."""
    m = orient_frame(d)
    local, state = sample_hemisphere(state, roughness)
    return normalize(_to_world(m, local)), state


def schlick(i, n, refract_ind):
    """rSchlick(I, N) (tp/montecarlo.frag:91-98): r0 from the IOR slider,
    x = 1 - dot(N, I), clamp(r0 + (1-r0)*x^5, 0, 1)."""
    r0 = (refract_ind - 1.0) / (refract_ind + 1.0)
    r0 = r0 * r0
    x = 1.0 - dot3(n, i)
    x5 = x * x * x * x * x
    return torch.clamp(r0 + (1.0 - r0) * x5, 0.0, 1.0)


def sample_hemisphere_masked(state, roughness, mask):
    """Masked-lane variant: draws for every lane, advances counters only
    where `mask`, as the scalar GLSL draw schedule (a lane that would not
    reach this call keeps its counter)."""
    u1, state = rng.uniform_masked(state, mask)
    u2, state = rng.uniform_masked(state, mask)
    return normalize(torch.stack(_hemisphere(u1, u2, roughness), dim=-1)), \
        state


def random_ray_masked(state, d, roughness, mask):
    """Masked-lane random_ray: 2 draws, advanced only where `mask`."""
    m = orient_frame(d)
    local, state = sample_hemisphere_masked(state, roughness, mask)
    return normalize(_to_world(m, local)), state


# ---------------------------------------------------------------------------
# SoA forms (vec3 = tuple of [N] tensors): the same draw schedule
# ---------------------------------------------------------------------------

def sample_hemisphere_soa(state, roughness, mask):
    """Masked hemisphere sample (tp/montecarlo.frag:49-70): exactly 2
    draws, the counters advanced only where `mask`. Returns (vec3,
    state)."""
    u1, state = rng.uniform_masked_soa(state, mask)
    u2, state = rng.uniform_masked_soa(state, mask)
    return vec.normalize(_hemisphere(u1, u2, roughness)), state


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


# ---------------------------------------------------------------------------
# Wrong-sampler foils (negative controls for the statistics tests)
# ---------------------------------------------------------------------------

def sample_hemisphere_wrong(state, roughness=None):
    """normalize(rand^3 in [0,1]^3) — tp/hsphere_wrong_sampling.vert:11."""
    v, state = rng.uniform3(state)
    return normalize(v), state


def sample_hemisphere_wrong2(state, roughness=None):
    """normalize(2*rand^3 - 1) — tp/hsphere_wrong2_sampling.vert:11."""
    v, state = rng.uniform3(state)
    return normalize(2.0 * v - 1.0), state


def random_ray_wrong(state, d, roughness=None, which=1):
    """Foil variants skip the ONB (they return the raw sample), matching
    tp/hsphere_wrong*_sampling.vert random_ray which ignores D."""
    fn = sample_hemisphere_wrong if which == 1 else sample_hemisphere_wrong2
    return fn(state)
