"""The benchmark's plain reference renderer (plain PyTorch).

It imports nothing of the program under test, nor JAX: it works out
the scene tables, the camera rays and every path again from the
benchmark's own scene description and camera matrices.
"""
from __future__ import annotations

import torch

from . import camera
from .pathtrace import radiance
from .scene import compile_reference


def render_samples(desc: dict, proj, view, width: int, height: int, xs, ys,
                   passes, *, nb_bounces: int, ior: float, date: float,
                   device, dtype=torch.float32, block: int = 1 << 16):
    """Radiance of pixels (xs[k], ys[k]) in each pass of `passes`:
    float32 [len(passes), S, 3]. Lanes are (pass, pixel) pairs, traced
    `block` at a time."""
    scene = compile_reference(desc, device, dtype)
    o, d, u, v = camera.rays(proj, view, width, height, xs, ys, device)
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    s = d.shape[0]
    p = torch.as_tensor(list(passes), dtype=torch.int64, device=device)
    total = p.shape[0] * s
    out = torch.empty((total, 3), dtype=torch.float32, device=device)
    for lo in range(0, total, block):
        lane = torch.arange(lo, min(total, lo + block), device=device)
        pix = lane % s
        out[lo:lo + lane.shape[0]] = radiance(
            scene, o, d[pix], u[pix], v[pix], p[lane // s],
            nb_bounces=nb_bounces, ior=ior, date=date).float()
    return out.reshape(p.shape[0], s, 3)
