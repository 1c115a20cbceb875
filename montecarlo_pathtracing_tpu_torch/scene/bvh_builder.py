"""Complete-binary-tree BVH builder (median split, cyclic axes).

Produces the exact output format of the reference's BVH_KDtree
(bvh_gpu/bvh.cpp:34-93):
  - bb: [2^(depth+1) - 1, 2, 3] heap-ordered boxes (node i -> children
    2i+1, 2i+2), bottom-up merged
  - leaf: [2^depth] primitive ids, -1 = empty slot
  - depth = ceil(log2 n)

The reference partitions each segment around its median with
std::nth_element per level (bvh.cpp:18-31); sorting each segment by the
level's axis yields identical segment contents at every level and the same
final size-<=2 segment order (ascending by the last level's axis), which is
what the leaf-fill step (bvh.cpp:59-83) consumes.

Port of montecarlo_pathtracing_tpu/scene/bvh_builder.py, host code (numpy).
Two backends: a vectorized numpy implementation and the native C++ builder
(native/bvh_builder.cpp, built with g++ into the package's _build/ at first
use); both produce identical arrays (asserted in tests).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

F32 = np.float32


class BVH(NamedTuple):
    bb_min: np.ndarray   # [2^(d+1)-1, 3] f32
    bb_max: np.ndarray   # [2^(d+1)-1, 3] f32
    leaf: np.ndarray     # [2^d] int32, -1 = empty
    depth: int


def build_bvh(centers: np.ndarray, bbmin: np.ndarray, bbmax: np.ndarray,
              use_native: Optional[bool] = None) -> BVH:
    """centers/bbmin/bbmax: [n,3] float32 per-primitive AABBs.
    use_native: None = the native builder where it builds and loads, else
    numpy; True = the native builder or RuntimeError; False = numpy."""
    if use_native is not False:
        from ..native import bvh_native
        out = bvh_native.build(centers, bbmin, bbmax)
        if out is not None:
            return out
        if use_native is True:
            raise RuntimeError("native BVH builder requested but unavailable")
    return _build_numpy(centers, bbmin, bbmax)


def _build_numpy(centers, bbmin, bbmax) -> BVH:
    n = centers.shape[0]
    centers = np.asarray(centers, F32)
    bbmin = np.asarray(bbmin, F32)
    bbmax = np.asarray(bbmax, F32)
    if n == 0:
        raise ValueError("empty scene")
    if n == 1:
        return BVH(bbmin.copy(), bbmax.copy(), np.array([0], np.int32), 0)

    depth = int(np.ceil(np.log2(n)))
    ids = np.arange(n, dtype=np.int64)
    # segment id per element; segments are contiguous. Start: one segment.
    # We track per-element segment ids and split every level at each
    # segment's median index (bvh.cpp:18-31 semantics via per-segment sort).
    seg_start = np.array([0, n], dtype=np.int64)  # boundaries (splt array)
    axis = 0
    for _ in range(1, depth):
        # sort elements by (segment, axis-value): lexsort, last key primary
        seg_of = np.repeat(
            np.arange(len(seg_start) - 1),
            np.diff(seg_start),
        )
        order = np.lexsort((centers[ids, axis], seg_of))
        ids = ids[order]
        # split each segment at its median index
        j0 = seg_start[:-1]
        j2 = seg_start[1:]
        j1 = (j0 + j2) // 2
        new_bounds = np.concatenate([seg_start, j1])
        seg_start = np.unique(new_bounds)
        # median index splits never duplicate a boundary before the last
        # level (segments stay size >= 2), so the segment count is exactly
        # doubled — the leaf-fill alignment below relies on this.
        assert len(seg_start) == len(new_bounds), "degenerate split"
        axis = (axis + 1) % 3

    # final per-segment sort by the last axis is already done above for the
    # last level; segments now have size 1 or 2.
    sz_leaf = 1 << depth
    sz = 2 * sz_leaf - 1
    leaf = np.empty(sz_leaf, np.int32)
    bb_min = np.zeros((sz, 3), F32)
    bb_max = np.zeros((sz, 3), F32)

    # leaf fill, back-to-front (bvh.cpp:59-83)
    nseg = len(seg_start) - 1
    assert nseg * 2 == sz_leaf, (nseg, sz_leaf)
    j0 = seg_start[:-1]
    j2 = seg_start[1:]
    sizes = j2 - j0
    # slots: segment s (0-based from the front) occupies leaf slots
    # [2s, 2s+1] and BB heap slots [leaf_row + 2s, leaf_row + 2s + 1]
    leaf_row = sz_leaf - 1
    single = sizes == 1
    first_id = ids[j0]
    second_id = ids[np.minimum(j0 + 1, n - 1)]
    leaf[0::2] = first_id.astype(np.int32)
    leaf[1::2] = np.where(single, -1, second_id).astype(np.int32)
    bb_min[leaf_row + 0::2] = bbmin[first_id]
    bb_max[leaf_row + 0::2] = bbmax[first_id]
    dup = np.where(single, first_id, second_id)
    bb_min[leaf_row + 1::2] = bbmin[dup]
    bb_max[leaf_row + 1::2] = bbmax[dup]

    # bottom-up merge (bvh.cpp:85-91)
    for level in range(depth - 1, -1, -1):
        lo = (1 << level) - 1
        hi = (1 << (level + 1)) - 1
        c0 = 2 * np.arange(lo, hi) + 1
        bb_min[lo:hi] = np.minimum(bb_min[c0], bb_min[c0 + 1])
        bb_max[lo:hi] = np.maximum(bb_max[c0], bb_max[c0 + 1])

    return BVH(bb_min, bb_max, leaf, depth)


def check_invariants(bvh: BVH, n_prims: int) -> None:
    """BVH invariants (test support): every prim in exactly one leaf;
    every parent box contains its children."""
    used = bvh.leaf[bvh.leaf >= 0]
    assert len(used) == n_prims, (len(used), n_prims)
    assert len(np.unique(used)) == n_prims
    internal = (1 << bvh.depth) - 1
    for i in range(internal):
        for c in (2 * i + 1, 2 * i + 2):
            assert np.all(bvh.bb_min[i] <= bvh.bb_min[c] + 1e-5)
            assert np.all(bvh.bb_max[i] >= bvh.bb_max[c] - 1e-5)
