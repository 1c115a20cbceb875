"""Debug rasterization analogs — the reference's raster mode rebuilt.

The reference's `draw_rt_ = false` mode renders the same scene data
through an independent path (phong-lit analytic prims, instanced mesh
triangles pulled from the scene textures, BVH wire boxes at a selectable
level — MontecarloGPU/montecarlo.cpp:478-561, shaders/{phong,mesh_phong,
bb}.*) to validate the encoding against the ray-traced result. Port of
montecarlo_pathtracing_tpu/models/debug_views.py; its analogs validate the
same things headlessly, on the scene's device (no kernel: the trace is the
dense fold):

  - first_hit_views: albedo / shading-normal / depth / prim-id images
    from one trace + intersection_info — independent of the integrator's
    bounce loop, so a wrong image isolates scene-encoding vs integrator
    bugs (the phong-preview analog)
  - bvh_level_image: the scene BVH's boxes at one heap level splatted as
    wireframe outlines over a depth image (the bb.vert/frag analog);
    validates the builder's heap layout visually
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..ops.trace import trace
from ..ops.shading import intersection_info
from ..utils.image import write_png


def first_hit_views(scene, origin, dirs):
    """dirs: [N,3] normalized, on the scene's device. Returns dict of
    [N,...] debug channels (tensors)."""
    o = torch.broadcast_to(torch.as_tensor(origin, dtype=torch.float32,
                                           device=dirs.device), dirs.shape)
    hit = trace(scene, o, dirs)
    n, p = intersection_info(scene, hit)
    prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1).long()
    col = scene.color[prim]
    is_hit = (hit.shape >= 0)[..., None]
    return {
        "albedo": torch.where(is_hit, col[..., :3], 0.0),
        "normal": torch.where(is_hit, 0.5 * (n + 1.0), 0.0),
        "depth": torch.where(is_hit[..., 0], hit.dist, torch.inf),
        "prim_id": hit.prim,
        "shape": hit.shape,
    }


def render_debug_png(scene, proj, view, width, height, path,
                     channel="normal"):
    """Raster-mode screenshot: one debug channel to PNG (none written
    when path is None). Returns the [H, W, 3] image, row 0 = bottom."""
    from ..render.camera import camera_rays

    origin, dirs, _tc = camera_rays(proj, view, width, height,
                                    device=scene.device)
    views = {k: v.cpu().numpy() for k, v in first_hit_views(
        scene, origin, dirs.reshape(-1, 3)).items()}
    if channel == "depth":
        d = np.asarray(views["depth"]).reshape(height, width)
        finite = np.isfinite(d)
        if finite.any():
            lo, hi = d[finite].min(), d[finite].max()
            img = np.where(finite, 1.0 - (d - lo) / max(hi - lo, 1e-6), 0.0)
        else:
            img = np.zeros_like(d)
        img = np.repeat(img[..., None], 3, -1)
    elif channel == "prim_id":
        ids = np.asarray(views["prim_id"]).reshape(height, width)
        rng = np.random.RandomState(0)
        palette = rng.uniform(0.2, 1.0, (scene.nb_prims + 1, 3))
        img = palette[np.clip(ids, -1, scene.nb_prims - 1) + 1]
        img[ids < 0] = 0.0
    else:
        img = np.asarray(views[channel]).reshape(height, width, 3)
    if path:
        write_png(path, img.astype(np.float32))
    return img


_BVH_CACHE: dict = {}


def _cache_bvh(scene, bvh):
    """Cache keyed by id(scene) with a weakref finalizer evicting the
    entry when the DeviceScene dies — id() reuse after GC can otherwise
    serve a different scene's BVH, and dead scenes would pin their BVHs
    forever. DeviceScene's dataclass equality compares tensors, which
    has no truth value, so it cannot key a WeakKeyDictionary; id +
    finalizer gives the same semantics."""
    key = id(scene)
    _BVH_CACHE[key] = bvh
    weakref.finalize(scene, _BVH_CACHE.pop, key, None)
    return bvh


def scene_bvh(scene):
    """Heap-format scene BVH (exact bvh.cpp:34-93 layout) built on demand
    from the DeviceScene's padded world AABBs. Debug-only: no trace path
    consumes the heap BVH (the frontier culls use Morton chunk/super
    boxes — ops/worklist.py, ops/sparse_trace.py), so DeviceScene does
    not carry it. Centers reproduce compile_scene's exactly:
    prim_bb returns ((mn + mx) / 2, mn, mx) (scene/scene.py:190-206)."""
    key = id(scene)
    if key not in _BVH_CACHE:
        from ..scene.bvh_builder import build_bvh
        mn = scene.prim_bb_min.cpu().numpy()
        mx = scene.prim_bb_max.cpu().numpy()
        return _cache_bvh(scene, build_bvh(
            ((mn + mx) / 2.0).astype(np.float32), mn, mx))
    return _BVH_CACHE[key]


def bvh_level_boxes(scene, level: int):
    """AABBs of the scene BVH at heap `level` (root = 0): [2^level, 2, 3].
    Mirrors the wire-cube instancing source (shaders/bb.vert:11-28)."""
    bvh = scene_bvh(scene)
    lo = (1 << level) - 1
    hi = (1 << (level + 1)) - 1
    mn = np.asarray(bvh.bb_min[lo:hi])
    mx = np.asarray(bvh.bb_max[lo:hi])
    return np.stack([mn, mx], axis=1)


def bvh_level_image(scene, proj, view, width, height, level, path=None):
    """Wireframe overlay of one BVH level over the depth view — the
    debug-raster BVH visualization, headless."""
    img = render_debug_png(scene, proj, view, width, height,
                           path=None, channel="depth") * 0.4
    pv = np.asarray(proj, np.float64) @ np.asarray(view, np.float64)
    boxes = bvh_level_boxes(scene, level)

    def project(p):
        q = pv @ np.array([p[0], p[1], p[2], 1.0])
        if q[3] <= 1e-6:
            return None
        x = (q[0] / q[3] * 0.5 + 0.5) * (width - 1)
        y = (q[1] / q[3] * 0.5 + 0.5) * (height - 1)
        return x, y

    def line(p0, p1, col):
        a, b = project(p0), project(p1)
        if a is None or b is None:
            return
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1])) + 1)
        for t in np.linspace(0.0, 1.0, min(n, 512)):
            x = int(a[0] * (1 - t) + b[0] * t)
            y = int(a[1] * (1 - t) + b[1] * t)
            if 0 <= x < width and 0 <= y < height:
                img[y, x] = col
    col = np.array([1.0, 0.9, 0.1], np.float32)
    for mn, mx in boxes:
        c = [mn, mx]
        corners = [np.array([c[i][0], c[j][1], c[k][2]])
                   for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
                 (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
        for e0, e1 in edges:
            line(corners[e0], corners[e1], col)
    if path:
        write_png(path, img)
    return img
