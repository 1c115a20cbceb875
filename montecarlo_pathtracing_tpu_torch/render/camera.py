"""Camera: GL-style projection/view matrices + per-pixel ray generation.

Port of montecarlo_pathtracing_tpu/render/camera.py, which reimplements
the reference camera math:
  - perspective/ortho projection with auto z-near/far from scene radius and
    focal distance (easycppogl/camera.cpp:52-87; aspect handling via the
    m05 pair, fov default 0.78 rad, camera.h:64)
  - modelview = translate(0,0,-focal) * frame * translate(-pivot)
    (camera.cpp:89-95); the path-tracer app post-multiplies rotateX(-80 deg)
    (MontecarloGPU/montecarlo.cpp:405)
  - camera-ray generation from invPV / invV (shaders/raytracer.vert:9-22):
    O = invV*(0,0,0,1); Dir = normalize((invPV*(c,1,1)).xyz/w - O)

The matrices are numpy on the host; `camera_rays` evaluates the
unprojection per pixel as float32 tensors on the given device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import transforms as tf

F32 = np.float32


def perspective(fov: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """GL clip-space perspective (camera.cpp:52-65 perspective_d)."""
    range_inv = 1.0 / (znear - zfar)
    f = 1.0 / np.tan(fov / 2.0)
    if aspect > 1:
        m00, m11 = f / aspect, f
    else:
        m00, m11 = f, f * aspect
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = m00
    m[1, 1] = m11
    m[2, 2] = (znear + zfar) * range_inv
    m[2, 3] = 2.0 * znear * zfar * range_inv
    m[3, 2] = -1.0
    return m


def ortho(aspect: float, znear: float, zfar: float) -> np.ndarray:
    """GL orthographic projection (camera.cpp:67-77 ortho_d)."""
    range_inv = 1.0 / (znear - zfar)
    if aspect < 1:
        m00, m11 = 1.0 / aspect, 1.0
    else:
        m00, m11 = 1.0, 1.0 / aspect
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = m00
    m[1, 1] = m11
    m[2, 2] = 2.0 * range_inv
    m[2, 3] = (znear + zfar) * range_inv
    m[3, 3] = 1.0
    return m


@dataclass
class Camera:
    """Orbit camera with the reference's auto-focal model (camera.h:75-93):
    focal_dist = scene_radius / tan(fov/2); znear/zfar derived per frame."""
    scene_center: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=F32))
    scene_radius: float = 1.0
    fov: float = 0.78
    aspect: float = 1.0
    frame: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=F32))
    perspective_mode: bool = True

    def __post_init__(self):
        self.scene_center = np.asarray(self.scene_center, dtype=F32)

    @property
    def focal_dist(self) -> float:
        return float(self.scene_radius / np.tan(self.fov / 2.0))

    def projection_matrix(self) -> np.ndarray:
        """camera.cpp:79-87: znear/zfar from focal distance + radius."""
        d = self.focal_dist - float(self.frame[2, 3])
        znear = max(0.01, d - self.scene_radius)
        zfar = d + self.scene_radius
        if self.perspective_mode:
            return perspective(self.fov, self.aspect, znear, zfar)
        return ortho(self.aspect, znear, zfar)

    def view_matrix(self, extra: np.ndarray | None = None) -> np.ndarray:
        """camera.cpp:89-95; `extra` is the app's post-rotation
        (rotateX(-80) in MontecarloGPU/montecarlo.cpp:405)."""
        v = (
            tf.translate(0, 0, -self.focal_dist)
            @ self.frame
            @ tf.translate(-self.scene_center)
        )
        if extra is not None:
            v = v @ extra
        return v.astype(F32)


def default_rt_camera(width: int, height: int,
                      center=(0.0, 0.0, 0.0), radius: float = 145.0,
                      frame: np.ndarray | None = None,
                      yaw: float = 0.0, pitch: float = 0.0,
                      zoom: float = 1.0):
    """The path-tracer app's default camera (montecarlo.cpp:388-389,405):
    scene center origin, radius 145, view post-rotated by rotateX(-80).
    yaw/pitch (degrees) and zoom orbit about the pivot — the headless
    replacement for the GLViewer trackball (gl_viewer.cpp:241-330).
    Returns (proj, view) float32 4x4."""
    cam = Camera(
        scene_center=np.asarray(center, F32),
        scene_radius=radius * zoom,
        aspect=width / height,
        frame=np.eye(4, dtype=F32) if frame is None else frame,
    )
    proj = cam.projection_matrix()
    view = cam.view_matrix(
        extra=tf.rotate_x(-80.0 + pitch) @ tf.rotate_z(yaw))
    return proj, view


def camera_rays(proj: np.ndarray, view: np.ndarray, width: int, height: int,
                device="cuda"):
    """Per-pixel primary rays (raytracer.vert semantics, evaluated densely).

    Returns (origin [3], dirs [H, W, 3], screen_tc [H, W, 2]) as float32
    tensors on `device`. Row 0 is the BOTTOM of the image (GL raster
    convention); flip on write. Pixel centers sample
    screen_tc = ((x+.5)/W, (y+.5)/H).
    """
    pv = (np.asarray(proj, np.float64) @ np.asarray(view, np.float64))
    inv_pv = torch.as_tensor(np.linalg.inv(pv).astype(F32), device=device)
    inv_v = np.linalg.inv(np.asarray(view, np.float64)).astype(F32)

    o = torch.as_tensor(inv_v[:3, 3].copy(), device=device)  # invV*(0,0,0,1)
    f32 = dict(dtype=torch.float32, device=device)
    tx = (torch.arange(width, **f32) + 0.5) / width
    ty = (torch.arange(height, **f32) + 0.5) / height
    tc = torch.stack(torch.meshgrid(tx, ty, indexing="xy"), dim=-1)  # [H,W,2]
    c = 2.0 * tc - 1.0
    q = (
        c[..., 0:1] * inv_pv[:, 0]
        + c[..., 1:2] * inv_pv[:, 1]
        + (inv_pv[:, 2] + inv_pv[:, 3])
    )  # invPV @ (cx, cy, 1, 1) -> [H,W,4]
    p = q[..., :3] / q[..., 3:4]
    d = p - o
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o, d, tc


def camera_rays_np(proj, view, width, height):
    """NumPy twin of camera_rays for the CPU oracle (float32)."""
    pv = np.asarray(proj, np.float64) @ np.asarray(view, np.float64)
    inv_pv = np.linalg.inv(pv).astype(F32)
    inv_v = np.linalg.inv(np.asarray(view, np.float64)).astype(F32)
    o = inv_v[:3, 3].copy()
    tx = (np.arange(width, dtype=F32) + F32(0.5)) / F32(width)
    ty = (np.arange(height, dtype=F32) + F32(0.5)) / F32(height)
    tc = np.stack(np.meshgrid(tx, ty, indexing="xy"), axis=-1).astype(F32)
    c = (2.0 * tc - 1.0).astype(F32)
    q = (
        c[..., 0:1] * inv_pv[:, 0]
        + c[..., 1:2] * inv_pv[:, 1]
        + (inv_pv[:, 2] + inv_pv[:, 3])
    ).astype(F32)
    p = (q[..., :3] / q[..., 3:4]).astype(F32)
    d = (p - o).astype(F32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True).astype(F32)
    return o, d.astype(F32), tc
