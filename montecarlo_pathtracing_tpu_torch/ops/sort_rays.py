"""Inter-bounce ray re-sorting: restore tile coherence for secondary rays.

Port of montecarlo_pathtracing_tpu/ops/sort_rays.py. Between bounces the
fused route (models/bounce_kernel.raytrace_fused) sorts the wavefront by

    key = direction_octant (3 bits) << 27 | morton9(origin) (27 bits)

so that each 1024-ray tile of the schedule holds rays leaving one region
of space in one direction octant: a tight bundle whose nearest-first
super schedule (`bounce_kernel._schedules`) is short. Finished rays get
DEAD_KEY and sort to the tail; they are parked at PARK_Z, above every
scene box, pointing further up, so every box test fails for them.

Sorting only permutes lanes: every per-ray carry rides the same
permutation, so results do not depend on it (the walks are conservative
per ray).

Integer layout: PyTorch on the CPU has no uint32 shift, so a key is an
int64 tensor holding a value in [0, 2**32), as in ops/rng.py.
"""
from __future__ import annotations

import numpy as np
import torch

# Parking spot for finished rays: far above every scene (scene radii are
# O(100)), pointing further up, so every slab test gives tmax < 0 <= tmin
PARK_Z = float(np.float32(2.0e8))
DEAD_KEY = 0xFFFFFFFF


def _spread3(x):
    """Interleave the low 9 bits of x (int64) with two zero bits each
    (Morton spread; the masks are the standard 10-bit pattern)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_key(o, d, done, lo, hi):
    """int64 sort key in [0, 2**32) per lane. o, d: vec3 of [N] tensors (d
    need not be unit), done: [N] bool, lo/hi: [3] f32 world bounds of the
    scene's prim AABBs. Dead lanes get DEAD_KEY (sort to the tail)."""
    octant = ((d[0] > 0).long() * 4 + (d[1] > 0).long() * 2
              + (d[2] > 0).long())
    span = torch.clamp(hi - lo, min=float(np.float32(1e-12)))
    key = octant << 27
    for c in range(3):
        q = torch.clamp((o[c] - lo[c]) / span[c], 0.0, 1.0)
        qi = (q * 511.0).to(torch.int32).long()
        key = key | (_spread3(qi) << c)
    return torch.where(done, DEAD_KEY, key)


def sort_wavefront(key, arrays):
    """Stable argsort by key (the reference's jnp.argsort is stable, and
    every dead lane has the same key) and every [N] tensor of `arrays`
    gathered by the permutation. Returns (perm, gathered list)."""
    perm = torch.argsort(key, stable=True)
    return perm, [a[perm] for a in arrays]
