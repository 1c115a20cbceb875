"""SoA vec3 math: vectors as (x, y, z) tuples of [N] tensors.

Port of montecarlo_pathtracing_tpu/ops/vec.py, the helpers the SoA
integrator (ops/trace.py, ops/shading.py, ops/sampling.py,
models/montecarlo.random_path_soa) needs, and the AoS bridge
(`from_aos`, `to_aos`) at the boundary to the dense [N, 3] trace. Same
formulas and operation order as the reference, so results agree to float
rounding. All helpers broadcast over their components.
"""
from __future__ import annotations

import torch


def v3(x, y, z):
    return (x, y, z)


def splat(c, like):
    """Constant vec3 broadcast to the shape of `like`'s components."""
    return tuple(torch.full_like(like[0], ci) for ci in c)


def from_aos(a):
    """[N, 3] -> ((N,), (N,), (N,)). Boundary-only."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_aos(v):
    """((N,),)*3 -> [N, 3]. Boundary-only."""
    return torch.stack(v, dim=-1)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Hadamard product of two vec3s."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(v, s):
    """v * s with s a scalar or [N] tensor."""
    return (v[0] * s, v[1] * s, v[2] * s)


def axpy(s, a, b):
    """s*a + b."""
    return (s * a[0] + b[0], s * a[1] + b[1], s * a[2] + b[2])


def neg(v):
    return (-v[0], -v[1], -v[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v, eps=0.0):
    n = length(v)
    if eps:
        n = torch.clamp(n, min=eps)
    return (v[0] / n, v[1] / n, v[2] / n)


def where(m, a, b):
    """Per-lane select; m is an [N] bool tensor."""
    return (torch.where(m, a[0], b[0]),
            torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def mix(a, b, k):
    """GLSL mix over vec3s; k scalar or [N]."""
    return ((1.0 - k) * a[0] + k * b[0],
            (1.0 - k) * a[1] + k * b[1],
            (1.0 - k) * a[2] + k * b[2])


def reflect(i, n):
    """GLSL reflect(I, N) = I - 2 dot(N, I) N."""
    d2 = 2.0 * dot(n, i)
    return (i[0] - d2 * n[0], i[1] - d2 * n[1], i[2] - d2 * n[2])


def refract_glsl(i, n, eta):
    """GLSL built-in refract: vec3(0) on total internal reflection. The
    sqrt operand is guarded on non-refracting lanes, as in the reference
    (its gradient would be infinite there)."""
    ndi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = k > 0.0
    c = eta * ndi + torch.where(refr, torch.sqrt(torch.where(refr, k, 1.0)),
                                0.0)
    out = (eta * i[0] - c * n[0], eta * i[1] - c * n[1],
           eta * i[2] - c * n[2])
    z = torch.zeros_like(out[0])
    return where(k < 0.0, (z, z, z), out)


def safe_rcp(x):
    """1/x with exact zeros clamped to a huge finite value, so a slab
    test never computes inf * 0 = NaN (the reference's
    ops/pallas_trace._safe_rcp)."""
    sgn = torch.where(x < 0.0, -1.0, 1.0)
    return sgn / torch.clamp(torch.abs(x), min=1e-30)


def affine_rows(m):
    """[P,4,4] -> [12,P] affine rows (r00 r01 r02 tx r10 ... tz), the SoA
    transform-table layout the trace kernels read."""
    return m[:, :3, :4].reshape(m.shape[0], 12).T


def apply_affine(rows, v):
    """Affine point transform by gathered rows: rows [12, N], v vec3."""
    return (rows[0] * v[0] + rows[1] * v[1] + rows[2] * v[2] + rows[3],
            rows[4] * v[0] + rows[5] * v[1] + rows[6] * v[2] + rows[7],
            rows[8] * v[0] + rows[9] * v[1] + rows[10] * v[2] + rows[11])


def apply_linear(rows, v):
    """Linear (direction) transform by gathered rows."""
    return (rows[0] * v[0] + rows[1] * v[1] + rows[2] * v[2],
            rows[4] * v[0] + rows[5] * v[1] + rows[6] * v[2],
            rows[8] * v[0] + rows[9] * v[1] + rows[10] * v[2])
