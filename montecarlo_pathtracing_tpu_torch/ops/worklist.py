"""Conservative ray-bundle vs box tests (host-side scheduling helpers).

Port of montecarlo_pathtracing_tpu/ops/worklist.py:44-91: per-tile
componentwise ray bundles and the conservative entry distance of each
bundle into each AABB. The megakernel route uses the entry distance to
order a tile's super boxes nearest-first (models/megakernel.
_mega_super_order), the fused route its super schedules, and the pruned
walks K5 and K6 their ranked schedules (ops/sparse_trace.py). The
reference's worklist builders and votes (`bundle_box_votes`,
`build_worklist`) have no caller in the port: its walks need no
worklist.
"""
from __future__ import annotations

import numpy as np
import torch

INF = float(np.float32(3e38))


def tile_bundles(o_rows, d_rows, tile: int):
    """Per-tile componentwise ray bundles.

    o_rows, d_rows: [3, M] ray rows (M a multiple of `tile`). Returns
    (olo, ohi, dlo, dhi), each [3, ntiles]."""
    m = o_rows.shape[1]
    nt = m // tile
    ot = o_rows.reshape(3, nt, tile)
    dt = d_rows.reshape(3, nt, tile)
    return (ot.amin(dim=2), ot.amax(dim=2), dt.amin(dim=2), dt.amax(dim=2))


def _cond_interval(a, b):
    """Feasible t >= 0 interval of a*t <= b (a, b broadcastable tensors):
    returns (lo, hi); empty encoded as lo > hi."""
    pos = a > 0
    neg = a < 0
    zer = ~(pos | neg)
    ratio = b / torch.where(zer, 1.0, a)
    lo = torch.where(neg, torch.clamp(ratio, min=0.0), 0.0)
    hi = torch.where(pos, ratio, INF)
    # a == 0: all t if b >= 0 else empty
    hi = torch.where(zer & (b < 0), -1.0, hi)
    return lo, hi


def bundle_box_entry(bundles, boxes):
    """Conservative ENTRY distance t_lo [ntiles, S] of each bundle into
    each box, INF where the bundle cannot reach the box. t_lo lower-bounds
    every contained ray's slab entry. Degenerate (padding) boxes with
    min > max are forced to INF: the interval test alone can admit them
    for wide bundles whose origin interval spans the sentinels."""
    olo, ohi, dlo, dhi = bundles
    t_lo = torch.zeros((olo.shape[1], boxes.shape[1]), dtype=torch.float32,
                       device=boxes.device)
    t_hi = torch.full_like(t_lo, INF)
    for c in range(3):
        blo = boxes[c][None, :]
        bhi = boxes[3 + c][None, :]
        lo1, hi1 = _cond_interval(dlo[c][:, None], bhi - olo[c][:, None])
        lo2, hi2 = _cond_interval(-dhi[c][:, None], ohi[c][:, None] - blo)
        t_lo = torch.maximum(t_lo, torch.maximum(lo1, lo2))
        t_hi = torch.minimum(t_hi, torch.minimum(hi1, hi2))
    real = torch.all(boxes[0:3] <= boxes[3:6], dim=0)[None, :]
    return torch.where((t_hi >= t_lo) & real, t_lo, INF)
