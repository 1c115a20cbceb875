"""Exercise-template integrator stubs kept in the carousel.

Port of montecarlo_pathtracing_tpu/models/stubs.py. The reference ships
two single-intersection fakes alongside the real integrator and cycles
them with O/P (MontecarloGPU/montecarlo.cpp:27): tp/montecarlo_mat.frag
returns abs(N) * random_vec3() and tp/montecarlo_mat_tr.frag returns
col.rgb * random_float(); both return (0, 0, 0.2) on a miss. They double
as debug views (normal / albedo visualization with noise) and as carousel
parity fixtures. Their one trace takes the dense fold whatever
use_kernels says, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import rng
from ..ops.shading import intersection_info
from ..ops.trace import trace
from ..utils.transforms import normalize

MISS_COLOR = np.array([0.0, 0.0, 0.2], np.float32)


def _first_hit(scene, O, D):
    D = normalize(D)
    O = torch.broadcast_to(torch.as_tensor(O, dtype=torch.float32,
                                           device=D.device), D.shape)
    hit = trace(scene, O, D)
    n, _p = intersection_info(scene, hit)
    prim = torch.clamp(hit.prim, 0, scene.nb_prims - 1).long()
    return hit, n, scene.color[prim]


def _miss(hit, out):
    miss = out.new_tensor(MISS_COLOR)
    return torch.where((hit.shape >= 0)[..., None], out, miss)


def raytrace_mat(scene, O, D, screen_tc, pass_index: int, *, nb_bounces=0,
                 refract_ind=1.0, date=0.0, detach_sampling=False,
                 use_kernels=False):
    """tp/montecarlo_mat.frag: abs(N) * random_vec3()."""
    state = rng.srand(screen_tc, pass_index, date)
    hit, n, _col = _first_hit(scene, O, D)
    rv, _state = rng.uniform3(state)
    return _miss(hit, torch.abs(n) * rv)


def raytrace_mat_tr(scene, O, D, screen_tc, pass_index: int, *,
                    nb_bounces=0, refract_ind=1.0, date=0.0,
                    detach_sampling=False, use_kernels=False):
    """tp/montecarlo_mat_tr.frag: col.rgb * random_float()."""
    state = rng.srand(screen_tc, pass_index, date)
    hit, _n, col = _first_hit(scene, O, D)
    rf, _state = rng.uniform(state)
    return _miss(hit, col[..., :3] * rf[..., None])
