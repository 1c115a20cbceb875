"""GL-style affine transforms and vector math.

Port of montecarlo_pathtracing_tpu/utils/transforms.py. The host side
(numpy, float32) mirrors the reference's Eigen layer
(easycppogl/gl_eigen.{h,cpp}; angles in degrees, gl_eigen.cpp:83-125) and
serves the scene builders; the device side (torch) mirrors the GLSL
built-ins the dense trace and the AoS integrator use.

All matrices are 4x4 float32, column-vector convention (M @ [p, 1]).
"""
from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def translate(x, y=None, z=None) -> np.ndarray:
    if y is None:  # vector form
        x, y, z = x
    m = np.eye(4, dtype=F32)
    m[0, 3] = F32(x)
    m[1, 3] = F32(y)
    m[2, 3] = F32(z)
    return m


def scale(sx, sy=None, sz=None) -> np.ndarray:
    if sy is None:
        if np.ndim(sx) == 1:
            sx, sy, sz = sx
        else:
            sy = sz = sx
    m = np.eye(4, dtype=F32)
    m[0, 0] = F32(sx)
    m[1, 1] = F32(sy)
    m[2, 2] = F32(sz)
    return m


def rotate_x(deg: float) -> np.ndarray:
    """Rotation around X, angle in degrees (gl_eigen.cpp:83)."""
    a = F32(np.pi / 180) * F32(deg)
    c, s = F32(np.cos(a)), F32(np.sin(a))
    m = np.eye(4, dtype=F32)
    m[1, 1] = c
    m[2, 1] = s
    m[1, 2] = -s
    m[2, 2] = c
    return m


def rotate_y(deg: float) -> np.ndarray:
    a = F32(np.pi / 180) * F32(deg)
    c, s = F32(np.cos(a)), F32(np.sin(a))
    m = np.eye(4, dtype=F32)
    m[0, 0] = c
    m[2, 0] = -s
    m[0, 2] = s
    m[2, 2] = c
    return m


def rotate_z(deg: float) -> np.ndarray:
    a = F32(np.pi / 180) * F32(deg)
    c, s = F32(np.cos(a)), F32(np.sin(a))
    m = np.eye(4, dtype=F32)
    m[0, 0] = c
    m[1, 0] = s
    m[0, 1] = -s
    m[1, 1] = c
    return m


def rotate(deg: float, axis) -> np.ndarray:
    """Rotation around arbitrary (unit) axis, degrees (gl_eigen.cpp:124)."""
    a = F32(np.pi / 180) * F32(deg)
    axis = np.asarray(axis, dtype=F32)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = F32(np.cos(a)), F32(np.sin(a))
    C = F32(1) - c
    r = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        dtype=F32,
    )
    m = np.eye(4, dtype=F32)
    m[:3, :3] = r
    return m


def apply(m: np.ndarray, p) -> np.ndarray:
    """Affine point transform: (m @ [p,1]).xyz — reference Transfo::apply."""
    p = np.asarray(p, dtype=F32)
    return (m[:3, :3] @ p + m[:3, 3]).astype(F32)


def apply_vector(m: np.ndarray, v) -> np.ndarray:
    """Linear vector transform: (m @ [v,0]).xyz."""
    v = np.asarray(v, dtype=F32)
    return (m[:3, :3] @ v).astype(F32)


def inverse(m: np.ndarray) -> np.ndarray:
    """float32 4x4 inverse (Eigen GLMat4::inverse analog)."""
    return np.linalg.inv(m.astype(np.float64)).astype(F32)


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    return inverse(m).T.copy()


def mix_host(a, b, k):
    return (1.0 - k) * a + k * b


def reflect_host(i, n):
    i = np.asarray(i, dtype=F32)
    n = np.asarray(n, dtype=F32)
    return i - 2.0 * np.dot(n, i) * n


def refract_host(i, n, ratio):
    """Host refract with reference's nonstandard semantics
    (gl_eigen.h:149-162): `ratio` IS eta; falls back to reflect on TIR;
    output normalized; handles both orientations of N."""
    i = np.asarray(i, dtype=F32)
    n = np.asarray(n, dtype=F32)
    r2 = ratio * ratio
    k = np.dot(n, -i)
    kk2 = 1.0 - r2 * (1.0 - k * k)
    if kk2 < 0:
        return reflect_host(i, n)
    kk = np.sqrt(kk2)
    if k >= 0:
        out = ratio * i + (ratio * k - kk) * n
    else:
        out = ratio * i - (ratio * k + kk) * n
    return (out / np.linalg.norm(out)).astype(F32)


# ---------------------------------------------------------------------------
# Device math (torch) — GLSL built-in semantics, the device half of
# montecarlo_pathtracing_tpu/utils/transforms.py (:160-203). Vectors are
# [..., 3] tensors. The 3x3 products are sums of elementwise products in
# f32 (the reference runs its einsums at Precision.HIGHEST): a matmul
# would reach cuBLAS, whose TF32 mode follows a caller's global
# set_float32_matmul_precision.
# ---------------------------------------------------------------------------


def mix(a, b, k):
    """GLSL mix(a, b, k) = (1-k)*a + k*b."""
    return (1.0 - k) * a + k * b


def dot3(a, b):
    """Dot product over the last axis, in the order of ops/vec.dot."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    """Cross product over the last axis (broadcasting), jnp.cross's
    formula."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length3(v):
    """Euclidean length over the last axis, sqrt(sum(v * v)) as the
    reference's jnp.linalg.norm (so its gradient behaves alike)."""
    return torch.sqrt(dot3(v, v))


def normalize(v, eps=0.0):
    """GLSL normalize: v / length(v). No epsilon guard by default
    (GLSL normalize of a zero vector is undefined; this gives nan/inf
    like hardware, matching the reference megakernel's behavior)."""
    n = length3(v)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def reflect(i, n):
    """GLSL reflect(I, N) = I - 2*dot(N,I)*N. Broadcasts over leading dims."""
    return i - 2.0 * dot3(n, i)[..., None] * n


def refract_glsl(i, n, eta):
    """GLSL *built-in* refract(I, N, eta): returns vec3(0) on total internal
    reflection. This is what the device integrator uses
    (reference tp/montecarlo.frag:149,152 calls the GLSL built-in)."""
    ndi = dot3(n, i)[..., None]
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    out = eta * i - (eta * ndi + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, 0.0, out)


def transform_dir(m, v):
    """(m @ [v,0]).xyz; m [...,4,4], v [...,3] with broadcasting."""
    return (m[..., :3, 0] * v[..., 0:1] + m[..., :3, 1] * v[..., 1:2]
            + m[..., :3, 2] * v[..., 2:3])


def transform_point(m, p):
    """(m @ [p,1]).xyz; m [...,4,4], p [...,3] with broadcasting."""
    return transform_dir(m, p) + m[..., :3, 3]
