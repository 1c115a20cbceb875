"""GL-style affine transforms (host side, numpy float32).

The numpy half of montecarlo_pathtracing_tpu/utils/transforms.py, which
mirrors the reference's Eigen layer (easycppogl/gl_eigen.{h,cpp}; angles
in degrees, gl_eigen.cpp:83-125). The scene builders use it; nothing here
touches a device.

All matrices are 4x4 float32, column-vector convention (M @ [p, 1]).
"""
from __future__ import annotations

import numpy as np

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
