"""Conservative ray-bundle vs box tests (host-side scheduling helpers).

Port of montecarlo_pathtracing_tpu/ops/worklist.py: per-tile
componentwise ray bundles, the conservative entry distance of each
bundle into each AABB, the bundle-box votes and the tile-sorted worklist
built from them. The megakernel route uses the entry distance to order a
tile's super boxes nearest-first (models/megakernel._mega_super_order),
the fused route its super schedules, and the pruned walks K5 and K6
their ranked schedules (ops/sparse_trace.py). No route of the port calls
`bundle_box_votes` or `build_worklist` (its walks need no worklist); they
are kept with the reference's semantics for the tools that inspect the
culling.
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


def _bundle_interval(bundles, boxes):
    """Per (bundle, box): the feasible t-interval [t_lo, t_hi] of the
    bundle's rays in the box, [ntiles, S] each, and whether the box is
    real (min <= max), [1, S]."""
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
    return t_lo, t_hi, real


def bundle_box_entry(bundles, boxes):
    """Conservative ENTRY distance t_lo [ntiles, S] of each bundle into
    each box, INF where the bundle cannot reach the box. t_lo lower-bounds
    every contained ray's slab entry. Degenerate (padding) boxes with
    min > max are forced to INF: the interval test alone can admit them
    for wide bundles whose origin interval spans the sentinels."""
    t_lo, t_hi, real = _bundle_interval(bundles, boxes)
    return torch.where((t_hi >= t_lo) & real, t_lo, INF)


def bundle_box_votes(bundles, boxes):
    """Conservative bundle-vs-AABB test.

    bundles: (olo, ohi, dlo, dhi) each [3, ntiles]; boxes: [6, S] (rows
    0-2 min, 3-5 max; empty boxes min > max never vote). Returns votes
    [ntiles, S] bool: a contained ray's position interval at t >= 0 on
    axis c is [olo_c + t*dlo_c, ohi_c + t*dhi_c], which can overlap
    [blo_c, bhi_c] iff dlo_c * t <= bhi_c - olo_c and -dhi_c * t <=
    ohi_c - blo_c; the six t-intervals must intersect. Degenerate boxes
    are masked explicitly, as in `bundle_box_entry`."""
    t_lo, t_hi, real = _bundle_interval(bundles, boxes)
    return (t_hi >= t_lo) & real


def build_worklist(votes, budget: int):
    """Flatten votes into a tile-sorted worklist.

    votes: [ntiles, S] bool. Returns (tile_id, block_id, n, overflow):
    tile_id/block_id [Wmax] int32 with Wmax = ntiles * budget, block_id
    -1 for the per-tile sentinel entries (every tile has one) and for
    the tail padding; n: the real worklist length (sentinels + votes),
    at most Wmax; overflow: whether it exceeded Wmax. The tail past n is
    the last tile's sentinel, so tile ids stay monotone. The sort keys
    are unique (a voted entry keeps its flat index, an unvoted one sorts
    after every voted one), so the result is exact."""
    nt, s = votes.shape
    dev = votes.device
    wmax = nt * budget
    full = torch.cat([torch.ones((nt, 1), dtype=torch.bool, device=dev),
                      votes], dim=1)                    # sentinel col 0
    flat = full.reshape(-1)
    count = flat.to(torch.int32).sum()                  # includes sentinels
    n = flat.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    order = torch.argsort(torch.where(flat, iota, iota + n))
    fill = (nt - 1) * (s + 1)
    take = min(wmax, n)
    order_p = torch.full((wmax,), fill, dtype=torch.int64, device=dev)
    order_p[:take] = order[:take]
    idx = torch.where(torch.arange(wmax, device=dev) < count, order_p, fill)
    tile_id = (idx // (s + 1)).to(torch.int32)
    block_id = (idx % (s + 1)).to(torch.int32) - 1
    return tile_id, block_id, torch.clamp(count, max=wmax), count > wmax
