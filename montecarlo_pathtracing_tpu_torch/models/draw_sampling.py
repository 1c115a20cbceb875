"""Hemisphere-sampling visualizer — the DrawSampling app, headless.

Port of montecarlo_pathtracing_tpu/models/draw_sampling.py.

Reimplements DrawSampling/draw_sampling.cpp (SamplingViewer, :64-175): the
reference draws 1000 x NB sampled directions as GL_POINTS around a chosen
normal N, with sliders for sample count / N / roughness and the O/P keys
cycling correct vs. two deliberately-wrong samplers. Here the kernel is a
vectorized sampler producing the direction cloud (the vertex shader WAS
the kernel, tp/hsphere.vert:43-49), and the viewer is an orthographic
point-splat to PNG with the same RGB axis triad + normal ray.

Seeding matches the reference's per-vertex scheme (srand(vec3(id*nb), ...)
in tp/sampling_base.vert:23-26 — each point gets its own counter derived
from its index).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import rng, sampling
from ..utils.transforms import normalize
from ..utils.image import write_png

SAMPLERS = {
    "hsphere": sampling.random_ray,                       # tp/hsphere.vert
    "hsphere_wrong": lambda st, d, r: sampling.random_ray_wrong(
        st, d, r, which=1),                               # wrong_sampling
    "hsphere_wrong2": lambda st, d, r: sampling.random_ray_wrong(
        st, d, r, which=2),                               # wrong2_sampling
}


def sample_cloud(n_samples: int, normal, roughness: float,
                 sampler: str = "hsphere", seed_pass: int = 0,
                 device="cuda"):
    """Generate the direction cloud: [n_samples, 3] float32 on `device`
    (the card unless the caller names the CPU)."""
    d = normalize(torch.as_tensor(np.asarray(normal, np.float32),
                                  device=device))
    ids = (torch.arange(n_samples, dtype=torch.float32, device=device)
           + 1.0) / n_samples
    tc = torch.stack([ids, ids * 0.5], dim=-1)
    state = rng.srand(tc, seed_pass)
    dcast = torch.broadcast_to(d, (n_samples, 3))
    rough = torch.tensor(roughness, dtype=torch.float32, device=device)
    out, _ = SAMPLERS[sampler](state, dcast, rough)
    return out


def _project(points, width, height, scale=0.42):
    """Orthographic projection (x right, z up, y into the screen) to pixel
    coords — the fixed camera of the visualizer."""
    px = (points[:, 0] * scale + 0.5) * (width - 1)
    py = (points[:, 2] * scale + 0.5) * (height - 1)
    depth = points[:, 1]
    return px.astype(np.int32), py.astype(np.int32), depth


def render_cloud(points, width=512, height=512, color=(1.0, 1.0, 0.0),
                 normal=None):
    """Splat the direction cloud to an image; draws the RGB axis triad and
    the normal ray like draw_ogl (draw_sampling.cpp:122-152).
    Returns [H, W, 3] float32, row 0 = bottom."""
    img = np.zeros((height, width, 3), np.float32)

    def line(p0, p1, col, n=256):
        t = np.linspace(0.0, 1.0, n)[:, None]
        pts = np.asarray(p0) * (1 - t) + np.asarray(p1) * t
        x, y, _ = _project(pts.astype(np.float32), width, height)
        ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
        img[y[ok], x[ok]] = col

    o = np.zeros(3)
    line(o, (1, 0, 0), (1.0, 0.2, 0.2))   # X axis red
    line(o, (0, 1, 0), (0.2, 1.0, 0.2))   # Y axis green
    line(o, (0, 0, 1), (0.3, 0.4, 1.0))   # Z axis blue
    if normal is not None:
        nrm = np.asarray(normal, np.float32)
        nrm = nrm / np.linalg.norm(nrm)
        line(o, nrm * 1.1, (1.0, 1.0, 1.0))

    pts = np.asarray(points, np.float32)
    x, y, _ = _project(pts, width, height)
    ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    img[y[ok], x[ok]] = np.asarray(color, np.float32)
    return img


def save_sampling_png(path, n_samples=4000, normal=(0.0, 0.0, 1.0),
                      roughness=1.0, sampler="hsphere", width=512,
                      height=512, device="cuda"):
    """One-shot: the reference's screenshot artifacts (captures/sampling*
    at roughness 1 / 0.5 / 0.1) as PNGs. The cloud is sampled on
    `device`; returns it as numpy."""
    pts = sample_cloud(n_samples, normal, roughness, sampler,
                       device=device).cpu().numpy()
    img = render_cloud(pts, width, height, normal=normal)
    write_png(path, img)
    return pts
