"""The camera: the viewer's pose as GL matrices, and primary rays.

`pose_matrices` gives the path-tracer viewer's camera (scene centre at
the origin, radius 145, the view post-rotated by rotateX(-80 + pitch) and
rotateZ(yaw), the radius scaled by zoom; MontecarloGPU/montecarlo.cpp:
388-405 and easycppogl/camera.cpp:52-95) as float32 proj and view
matrices. The benchmark makes them once and hands the same two matrices
to the program and to `rays`.

`rays` evaluates raytracer.vert's unprojection for chosen pixels:
O = invV (0, 0, 0, 1), D = normalize(invPV (c, 1, 1) / w - O) with
c = 2 ((x + 0.5) / W, (y + 0.5) / H) - 1, row 0 at the bottom.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def _rot(deg: float, a: int, b: int) -> np.ndarray:
    ang = F32(np.pi / 180) * F32(deg)
    c, s = F32(np.cos(ang)), F32(np.sin(ang))
    m = np.eye(4, dtype=F32)
    m[a, a], m[b, a], m[a, b], m[b, b] = c, s, -s, c
    return m


def _translate(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=F32)
    m[:3, 3] = (F32(x), F32(y), F32(z))
    return m


def pose_matrices(width: int, height: int, yaw: float = 0.0,
                  pitch: float = 0.0, zoom: float = 1.0,
                  radius: float = 145.0, fov: float = 0.78):
    """(proj, view), float32 4x4."""
    r = radius * zoom
    focal = float(r / np.tan(fov / 2.0))
    znear, zfar = max(0.01, focal - r), focal + r
    aspect = width / height
    f = 1.0 / np.tan(fov / 2.0)
    m00, m11 = (f / aspect, f) if aspect > 1 else (f, f * aspect)
    proj = np.zeros((4, 4), F32)
    proj[0, 0], proj[1, 1] = m00, m11
    range_inv = 1.0 / (znear - zfar)
    proj[2, 2] = (znear + zfar) * range_inv
    proj[2, 3] = 2.0 * znear * zfar * range_inv
    proj[3, 2] = -1.0
    view = (_translate(0, 0, -focal) @ np.eye(4, dtype=F32)
            @ _translate(0, 0, 0))
    view = (view @ (_rot(-80.0 + pitch, 1, 2) @ _rot(yaw, 0, 1))).astype(F32)
    return proj, view


def rays(proj, view, width: int, height: int, xs, ys, device):
    """origin [3], dirs [S, 3] and screen coordinates u, v [S] (float32)
    of the pixels (xs[k], ys[k])."""
    pv = np.asarray(proj, np.float64) @ np.asarray(view, np.float64)
    inv_pv = torch.as_tensor(np.linalg.inv(pv).astype(F32), device=device)
    inv_v = np.linalg.inv(np.asarray(view, np.float64)).astype(F32)
    o = torch.as_tensor(inv_v[:3, 3].copy(), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    u = (torch.as_tensor(xs, **f32) + 0.5) / width
    v = (torch.as_tensor(ys, **f32) + 0.5) / height
    cx, cy = 2.0 * u - 1.0, 2.0 * v - 1.0
    q = (cx[:, None] * inv_pv[:, 0] + cy[:, None] * inv_pv[:, 1]
         + (inv_pv[:, 2] + inv_pv[:, 3]))
    d = q[:, :3] / q[:, 3:4] - o
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o, d, u, v
