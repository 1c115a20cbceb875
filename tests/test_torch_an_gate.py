"""Which rays gate K5 together (ROADMAP C.11): the walk of csrc/
trace_kernels.cu mirrored in plain PyTorch, held against its plain
version `an_fold_plain` and, through `group_best_rows_sparse`, against the
JAX package's Pallas kernel in interpret mode.

K5 walks a 1024-ray tile's ranked 8-prim blocks. Spheres, cubes and
cylinders take only hits in front of the ray's origin, so a block that a
ray's segment [0, min(best, bound)] misses holds no closer hit for it, and
the kernel may gate per ray: each warp walks on its own with the prune
over its own 32 rays, and a ray tests a block only where it enters the
block's box within min(best, bound) (an_walk). Cones and quads take hits
behind the origin, which such a block may hold, so there the winners
depend on which rays decide together: the kernel walks a whole tile as
one, the prune over its 1024 rays, every ray testing every block the
prune admits (an_tile_walk), as the plain version and the TPU kernel do.

The mirrors: `tile_walk_mirror` is an_tile_walk (K3a's masked shape tests,
which keep common.cuh's floats); `per_ray_mirror` is an_walk, the per-ray
gate that K5 had for every shape. The per-ray gate differs from the plain
version on a random cone group, which is the fault this walk repairs.

Inputs come from numpy with fixed seeds: random groups of ~300 prims as
chip_smoke.py's phase 7 makes them (testing/parity.random_group, 8-prim
block boxes by group_chunk_boxes) and 2048 random rays whose origins lie
in and around the field. Tolerances: every output bit for bit against the
plain version; against JAX rows exactly and distances within JAX_RTOL =
5e-4 relative, the reference's own tolerance between its folds
(tests/test_pallas_trace.py:72): XLA rounds the same float32 formulas
differently, by a few ulp on these inputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import pallas_trace as jpt
from montecarlo_pathtracing_tpu.ops import sparse_trace as jsp
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as pt
from montecarlo_pathtracing_tpu_torch.ops import sparse_trace as sp
from montecarlo_pathtracing_tpu_torch.ops.shapes import SOA_FNS
from montecarlo_pathtracing_tpu_torch.ops.vec import safe_rcp
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    group_chunk_boxes, random_group, random_rays)
from montecarlo_pathtracing_tpu_torch.utils import transforms

import test_torch_brute_trace as brute

M = 2 * sp.AN_TILE
N_PRIMS = 300
JAX_RTOL = 5e-4
WARP = 32
FMAX = pt._FMAX
INF = sp.INF
BEHIND = (4, 5)           # cones and quads take hits behind the origin


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(code):
    """(trf numpy, port tables, block boxes [6, ppad / 8], rays o, d
    numpy [3, M]) of chip_smoke.py phase 7's random group of this shape
    (its seed) and rays."""
    trf, inv, pid = random_group(transforms, code, N_PRIMS,
                                 100 * code + N_PRIMS)
    tabs = pt._pad_group(torch.as_tensor(trf), torch.as_tensor(inv),
                         torch.as_tensor(pid))
    sup = torch.as_tensor(group_chunk_boxes(trf, tabs[0].shape[1], sp.SUP))
    o, d = random_rays(M, 7)
    return trf, inv, pid, tabs, sup, o, d


def _prim_step(fn, o, d, blk, j, on, best):
    """Prim j of each ray's block rows blk [25, M, SUP] tested by the
    rays `on` [M], folded strictly closer into best = (dist, row, a,
    dircode) with row `rowj` [M]."""
    iv = [blk[r, :, j] for r in range(12)]
    tf = [blk[12 + r, :, j] for r in range(12)]
    on = on & (blk[24, :, j] > 0.0)
    ox, oy, oz = o
    dx, dy, dz = d
    lox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
    loy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
    loz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
    tdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
    tdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
    tdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
    nrm = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy + tdz * tdz),
                      min=1e-30)
    ldx, ldy, ldz = tdx / nrm, tdy / nrm, tdz / nrm
    a, ok, code = fn(lox, loy, loz, ldx, ldy, ldz)
    plx, ply, plz = lox + a * ldx, loy + a * ldy, loz + a * ldz
    ex = ox - (tf[0] * plx + tf[1] * ply + tf[2] * plz + tf[3])
    ey = oy - (tf[4] * plx + tf[5] * ply + tf[6] * plz + tf[7])
    ez = oz - (tf[8] * plx + tf[9] * ply + tf[10] * plz + tf[11])
    dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
    return on & ok & (dist < best[0]), (dist, a, code)


def _walk(o, d, code, tab, order, tlo, bound, sup_bb, per_ray):
    """K5's walk over the ranked blocks: with per_ray, an_walk (each warp
    of 32 rays walks with its own prune and each ray tests a block only
    where it enters the block's box within min(best, bound)); without it,
    an_tile_walk (a tile walks as one, every ray testing every block its
    prune admits). (dist, row, a, dircode) per ray."""
    fn = brute.G_FNS[code] if not per_ray else SOA_FNS[code]
    m = o.shape[1]
    tile = torch.arange(m) // sp.AN_TILE
    group = WARP if per_ray else sp.AN_TILE
    rd = safe_rcp(d)
    o3 = tuple(o[k] for k in range(3))
    d3 = tuple(d[k] for k in range(3))
    best = (torch.full((m,), FMAX), torch.full((m,), -1, dtype=torch.int32),
            torch.zeros((m,)), torch.full((m,), -1, dtype=torch.int32))
    walking = torch.ones((m // group,), dtype=torch.bool)
    for k in range(order.shape[1]):
        e = tlo[tile, k]
        cap = torch.minimum(best[0], bound)
        pruned = ((e < INF) & (e < cap)).reshape(-1, group).any(dim=1)
        walking &= pruned               # a walk ends at its first prune
        if not walking.any():
            break
        on = walking.repeat_interleave(group)
        b = order[tile, k].long()
        if per_ray:
            on &= pt._slab_enters(o, rd, sup_bb[:, b], cap)
        blk = tab[b].permute(1, 0, 2)                     # [25, M, SUP]
        for j in range(sp.SUP):
            take, (dist, a, dircode) = _prim_step(fn, o3, d3, blk, j, on,
                                                  best)
            rowj = (b * sp.SUP + j).to(torch.int32)
            best = tuple(torch.where(take, x, y) for x, y in
                         zip((dist, rowj, a, dircode), best))
    return best


def tile_walk_mirror(o, d, code, tab, order, tlo, bound, sup_bb):
    return _walk(o, d, code, tab, order, tlo, bound, sup_bb, per_ray=False)


def per_ray_mirror(o, d, code, tab, order, tlo, bound, sup_bb):
    return _walk(o, d, code, tab, order, tlo, bound, sup_bb, per_ray=True)


def _inputs(code):
    _, _, _, tabs, sup, o, d = _case(code)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tab, order, tlo, bound = sp.an_inputs(o, d, *tabs, sup)
    return o, d, tab, order, tlo, bound, sup


@pytest.mark.parametrize("code", BEHIND)
def test_plain_k5_matches_jax_on_hits_behind(code):
    """(a) The plain group_best_rows_sparse against the JAX package's, in
    interpret mode, on a random cone or quad group: rows equal exactly,
    distances within JAX_RTOL (XLA rounds the same float32 formulas
    differently, by a few ulp here)."""
    trf, inv, pid, tabs, sup, o, d = _case(code)
    jtabs = jpt._pad_group(jnp.asarray(trf), jnp.asarray(inv),
                           jnp.asarray(pid))
    ref = [np.asarray(x) for x in jsp.group_best_rows_sparse(
        jnp.asarray(o), jnp.asarray(d), code, *jtabs,
        jnp.asarray(sup.numpy()), interpret=True)]
    got = [x.numpy() for x in sp.group_best_rows_sparse(
        torch.as_tensor(o), torch.as_tensor(d), code, *tabs, sup)]
    assert 0.01 < (ref[1] >= 0).mean() < 0.9
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=JAX_RTOL)


@pytest.mark.parametrize("code", BEHIND)
def test_tile_walk_mirror_equals_plain(code):
    """(b) K5's tile walk on a random cone or quad group: every output bit
    for bit equal to an_fold_plain."""
    o, d, tab, order, tlo, bound, sup = _inputs(code)
    got = tile_walk_mirror(o, d, code, tab, order, tlo, bound, sup)
    ref = sp.an_fold_plain(o, d, tab, order, tlo, bound, code)
    brute._assert_bits(got, ref, f"K5 tile walk, shape {code}")


def test_per_ray_gate_misses_hits_behind_the_origin():
    """(c) The per-ray gate K5 had for cones (an_walk) differs from the
    plain version on some rays of a random cone group: a block whose box
    a ray's segment misses held that ray's closest hit, behind its origin.
    Each such ray's plain winner is at least as close, and the plain
    version equals the tile walk."""
    o, d, tab, order, tlo, bound, sup = _inputs(4)
    ref = sp.an_fold_plain(o, d, tab, order, tlo, bound, 4)
    got = per_ray_mirror(o, d, 4, tab, order, tlo, bound, sup)
    differ = got[1] != ref[1]
    assert differ.sum() >= 1
    assert (ref[0][differ] <= got[0][differ]).all()


@pytest.mark.parametrize("code", [1, 2, 3])
def test_per_ray_gate_equals_plain_in_front(code):
    """(d) The per-ray gate (an_walk) on sphere, cube and cylinder groups,
    whose hits lie in front of the origin: every output bit for bit equal
    to an_fold_plain."""
    o, d, tab, order, tlo, bound, sup = _inputs(code)
    got = per_ray_mirror(o, d, code, tab, order, tlo, bound, sup)
    ref = sp.an_fold_plain(o, d, tab, order, tlo, bound, code)
    brute._assert_bits(got, ref, f"K5 per-ray gate, shape {code}")
    assert 0.01 < (ref[1] >= 0).float().mean() < 0.9
