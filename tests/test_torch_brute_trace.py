"""The fold order of the brute trace kernels K3a (group_kernel) and K4a
(tri_kernel) in csrc/trace_kernels.cu, mirrored in plain PyTorch and held
against their plain versions (`group_best_rows_plain`,
`mesh_best_rows_plain`) and against the JAX package's Pallas kernels in
interpret mode.

The mirrors below do what the kernels do, in their order: each 128-wide
chunk staged as the kernel stages it (K4a: the corner A and the edges
B - A and C - A; K3a: the inverse and forward rows of each prim, a NaN
inverse frame where the scene id is < 0), the chunk cut at its end (one
past the last triangle with a nonzero corner, or the last prim with a
scene id >= 0), one ray a thread, and per triangle or prim a gate over
each warp's 32 threads (K4a: some ray has |det| >= EPS
and u in [0, 1]; K3a: some ray passes the shape test) before the rest of
the test runs, folded ascending with a strict `<`. K3a's shape tests are
its select forms with the masked square roots and divisions given 1.
The work that chip_smoke.py counts for K3a's bound is held against the
mirror's counts.

Inputs come from numpy with fixed seeds, with exact ties (duplicated
triangles and prims), scene ids < 0 between prims and groups and
instances off the chunk grid. Tolerances: against the plain versions
every output bit for bit (the kernels are held to the same on the card by
chip_smoke.py); against JAX the trace protocol of testing/parity.py with
distances within JAX_RTOL = 5e-4 relative, the reference's own tolerance
between its folds (tests/test_pallas_trace.py:72), since XLA rounds the
same float32 formulas differently. Integers are compared exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import pallas_trace as jpt
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as pt
from montecarlo_pathtracing_tpu_torch.ops.shapes import SOA_FNS
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_trace_protocol, random_group, random_rays)
from montecarlo_pathtracing_tpu_torch.utils import transforms

import chip_smoke

CODES = [1, 2, 3, 4, 5]   # sphere, cube, cylinder, cone, oriented quad
M = 2 * pt.RAY_TILE
CHUNK = pt.PRIM_CHUNK
WARP = 32
JAX_RTOL = 5e-4
EPS = pt._EPS
FMAX = pt._FMAX


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(x):
    """The bits of a float32 array (as int32), or an integer array."""
    x = np.ascontiguousarray(x.numpy() if torch.is_tensor(x) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int32)


def _assert_bits(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(_bits(g), _bits(r),
                                      err_msg=f"{what}: output {i}")


# --------------------------------------------------------------------------
# the staging
# --------------------------------------------------------------------------

def _ends(real):
    """Per 128-wide chunk: one past the last column whose flag is set (0
    for a chunk without one), the kernels' chunk end."""
    local = torch.arange(real.shape[0]) % CHUNK + 1
    return torch.where(real, local, 0).reshape(-1, CHUNK).amax(dim=1)


def stage_tris(tri):
    """K4a's staging of [9, ppad] corner rows: (A, e1 = B - A, e2 = C - A),
    each [3, ppad], and the chunk ends [ppad / 128]."""
    a = tri[0:3]
    real = (tri != 0).any(dim=0)
    return a, tri[3:6] - a, tri[6:9] - a, _ends(real)


def stage_prims(inv_r, trf_r, pid):
    """K3a's staging of a group's padded tables: the inverse rows with a
    NaN frame where the scene id is < 0, the forward rows, and the chunk
    ends [ppad / 128]."""
    real = pid[0] >= 0
    inv = torch.where(real[None, :], inv_r, float("nan"))
    return inv, trf_r, _ends(real)


def _warp_any(flag):
    """flag [M] -> [M]: whether some ray of the same warp has it (ray i on
    thread i, 32 consecutive rays a warp)."""
    return flag.reshape(-1, WARP).any(dim=1).repeat_interleave(WARP)


# --------------------------------------------------------------------------
# K4a's fold
# --------------------------------------------------------------------------

def mesh_fold_mirror(o, d, tri, stats=None):
    """K4a's fold: (a, row) per ray. `stats`, a dict, gets the triangles
    tested and the (triangle, warp) tests the gate on u skipped."""
    A, E1, E2, ends = stage_tris(tri)
    m = o.shape[1]
    ox, oy, oz = o
    dx, dy, dz = d
    abest = torch.full((m,), FMAX, dtype=torch.float32)
    best = torch.full((m,), -1, dtype=torch.int64)
    tested = skipped = 0
    for c, end in enumerate(ends.tolist()):
        for t in range(c * CHUNK, c * CHUNK + end):
            tested += 1
            e1x, e1y, e1z = E1[:, t]
            e2x, e2y, e2z = E2[:, t]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            det = e1x * hx + e1y * hy + e1z * hz
            ok = torch.abs(det) >= EPS
            invd = 1.0 / torch.where(ok, det, 1.0)
            sx, sy, sz = ox - A[0, t], oy - A[1, t], oz - A[2, t]
            u = (sx * hx + sy * hy + sz * hz) * invd
            pas = ok & (u >= 0.0) & (u <= 1.0)
            gate = _warp_any(pas)
            skipped += int((~gate).sum()) // WARP
            if not gate.any():
                continue
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (dx * qx + dy * qy + dz * qz) * invd
            a = (e2x * qx + e2y * qy + e2z * qz) * invd
            hit = gate & pas & (v >= 0.0) & (u + v <= 1.0) & (a > EPS)
            take = hit & (a < abest)
            abest = torch.where(take, a, abest)
            best = torch.where(take, t, best)
    if stats is not None:
        stats.update(tested=tested, skipped=skipped)
    return abest, torch.where(abest < FMAX, best, -1).to(torch.int32)


# --------------------------------------------------------------------------
# K3a's fold and shape tests
# --------------------------------------------------------------------------

def _w(ok, x):
    """x where ok, 1 elsewhere: a masked argument."""
    return torch.where(ok, x, 1.0)


def g_sphere(ox, oy, oz, dx, dy, dz):
    OO = ox * ox + oy * oy + oz * oz
    OD = ox * dx + oy * dy + oz * dz
    D2 = dx * dx + dy * dy + dz * dz
    delta4 = OD * OD - D2 * (OO - 1.0)
    ok = delta4 > 0.0
    sq = torch.sqrt(_w(ok, delta4))
    a1 = -(OD + sq) / _w(ok, D2)
    a2 = -(OD - sq) / _w(ok, D2)
    v1 = ok & (a1 > EPS)
    v2 = ok & (a2 > EPS)
    a = torch.where(v1, a1, torch.where(v2, a2, FMAX))
    return a, v1 | v2, torch.zeros_like(a, dtype=torch.int32)


def g_quad(ox, oy, oz, dx, dy, dz):
    facing = dz <= -EPS
    t = -oz / torch.where(facing, dz, -1.0)
    px = ox + t * dx
    py = oy + t * dy
    valid = facing & (torch.abs(px) <= 1.0) & (torch.abs(py) <= 1.0)
    return (torch.where(valid, t, FMAX), valid,
            torch.zeros_like(t, dtype=torch.int32))


def g_cube(ox, oy, oz, dx, dy, dz):
    o, d = (ox, oy, oz), (dx, dy, dz)
    al = torch.full_like(ox, FMAX)
    face = torch.zeros_like(ox, dtype=torch.int32)
    for c in range(6):
        c0 = c // 2
        c1, c2 = (c0 + 1) % 3, (c0 + 2) % 3
        cd = -1.0 + 2.0 * (c % 2)
        dok = torch.abs(d[c0]) > EPS
        t = (cd - o[c0]) / _w(dok, d[c0])
        v = (dok & (t > EPS) & (torch.abs(o[c1] + t * d[c1]) <= 1.0)
             & (torch.abs(o[c2] + t * d[c2]) <= 1.0) & (t < al))
        al = torch.where(v, t, al)
        face = torch.where(v, c, face)
    return al, al < FMAX, face


def g_cylinder(ox, oy, oz, dx, dy, dz):
    al = torch.full_like(ox, FMAX)
    cl = torch.full_like(ox, -1, dtype=torch.int32)
    dz_ok = torch.abs(dz) > EPS
    for cap, zplane in ((0, -1.0), (1, 1.0)):
        t = (zplane - oz) / _w(dz_ok, dz)
        rx, ry = ox + t * dx, oy + t * dy
        v = dz_ok & (t > EPS) & (rx * rx + ry * ry < 1.0) & (t < al)
        al = torch.where(v, t, al)
        cl = torch.where(v, cap, cl)
    O2 = ox * ox + oy * oy
    OD = ox * dx + oy * dy
    D2 = dx * dx + dy * dy
    delta4 = OD * OD - D2 * (O2 - 1.0)
    ok = delta4 > 0.0
    t = -(OD + torch.sqrt(_w(ok, delta4))) / _w(ok, D2)
    v = ok & (t > EPS) & (t < al) & (torch.abs(oz + t * dz) < 1.0)
    a = torch.where(v, t, al)
    return a, a < FMAX, torch.where(v, 2, cl)


def g_cone(ox, oy, oz, dx, dy, dz):
    dz_ok = torch.abs(dz) > EPS
    t0 = (-1.0 - oz) / _w(dz_ok, dz)
    rx, ry = ox + t0 * dx, oy + t0 * dy
    v0 = dz_ok & (t0 > EPS) & (rx * rx + ry * ry < 1.0) & (t0 < FMAX)
    tl = torch.where(v0, t0, FMAX)
    cl = torch.where(v0, 0, torch.full_like(ox, -1, dtype=torch.int32))
    coz = oz - 1.0
    dco = dx * ox + dy * oy + dz * coz
    coco = ox * ox + oy * oy + coz * coz
    k = 0.8
    a_ = dz * dz - k
    b_ = 2.0 * (dz * coz - dco * k)
    c_ = coz * coz - coco * k
    det = b_ * b_ - 4.0 * a_ * c_
    ok = det > 0.0
    sq = torch.sqrt(_w(ok, det))
    t1 = (-b_ - sq) / (2.0 * a_)
    t2 = (-b_ + sq) / (2.0 * a_)
    t1 = torch.where(torch.abs(oz + t1 * dz) > 1.0, FMAX, t1)
    t2 = torch.where(torch.abs(oz + t2 * dz) > 1.0, FMAX, t2)
    nan = torch.isnan(t1) | torch.isnan(t2)
    v = ~nan & ok & (torch.fmin(t1, t2) < tl)
    a = torch.where(v, torch.fmin(t1, t2), tl)
    return a, a < FMAX, torch.where(v, 2, cl)


G_FNS = {1: g_sphere, 2: g_cube, 3: g_cylinder, 4: g_cone, 5: g_quad}


def group_fold_mirror(o, d, code, inv_r, trf_r, pid, stats=None):
    """K3a's fold: (dist, row, a, dircode) per ray. `stats`, a dict, gets
    the prims tested, the (prim, warp) hit paths the gate skipped and the
    (ray, prim) pairs whose shape test passed."""
    inv, trf, ends = stage_prims(inv_r, trf_r, pid)
    fn = G_FNS[code]
    m = o.shape[1]
    ox, oy, oz = o
    dx, dy, dz = d
    bd = torch.full((m,), FMAX, dtype=torch.float32)
    ba = torch.zeros((m,), dtype=torch.float32)
    brow = torch.full((m,), -1, dtype=torch.int64)
    bdir = torch.full((m,), -1, dtype=torch.int32)
    tested = skipped = passes = 0
    for c, end in enumerate(ends.tolist()):
        for j in range(c * CHUNK, c * CHUNK + end):
            tested += 1
            iv, tf = inv[:, j], trf[:, j]
            lox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
            loy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
            loz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
            tdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
            tdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
            tdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
            nrm = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy + tdz * tdz),
                              min=1e-30)
            ldx, ldy, ldz = tdx / nrm, tdy / nrm, tdz / nrm
            a, ok, dircode = fn(lox, loy, loz, ldx, ldy, ldz)
            passes += int(ok.sum())
            gate = _warp_any(ok)
            skipped += int((~gate).sum()) // WARP
            if not gate.any():
                continue
            plx, ply, plz = lox + a * ldx, loy + a * ldy, loz + a * ldz
            ex = ox - (tf[0] * plx + tf[1] * ply + tf[2] * plz + tf[3])
            ey = oy - (tf[4] * plx + tf[5] * ply + tf[6] * plz + tf[7])
            ez = oz - (tf[8] * plx + tf[9] * ply + tf[10] * plz + tf[11])
            dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
            take = gate & ok & (dist < bd)
            bd = torch.where(take, dist, bd)
            ba = torch.where(take, a, ba)
            brow = torch.where(take, j, brow)
            bdir = torch.where(take, dircode, bdir)
    if stats is not None:
        stats.update(tested=tested, skipped=skipped, passes=passes)
    return bd, torch.where(bd < FMAX, brow, -1).to(torch.int32), ba, bdir


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def _group(code, n_prims=200, seed=None):
    """A random group (numpy) padded by both packages' _pad_group."""
    trf, inv, pid = random_group(transforms, code, n_prims,
                                 100 * code + 7 if seed is None else seed)
    return trf, inv, pid


def _pad_both(trf, inv, pid):
    got = pt._pad_group(torch.as_tensor(trf), torch.as_tensor(inv),
                        torch.as_tensor(pid))
    ref = jpt._pad_group(jnp.asarray(trf), jnp.asarray(inv), jnp.asarray(pid))
    return got, ref


@pytest.fixture(scope="module")
def mesh_demo():
    """mesh_demo compiled by both packages."""
    return (compile_scene(scenes.build("mesh_demo"), device="cpu"),
            jcompile(jscenes.build("mesh_demo")))


def _instance(mesh_demo, i):
    """mesh_demo instance i's padded triangle rows (both packages) and M
    rays in its local frame: half from the camera's eye point towards the
    scene, half random."""
    dev, jdev = mesh_demo
    off, cnt = dev.mesh_tri_offset[i], dev.mesh_tri_padded[i]
    tri = pt.pad_tris(dev.tri_va[off:off + cnt], dev.tri_vb[off:off + cnt],
                      dev.tri_vc[off:off + cnt])
    jtri = jpt.pad_tris(jdev.tri_va[off:off + cnt],
                        jdev.tri_vb[off:off + cnt],
                        jdev.tri_vc[off:off + cnt])
    inv = dev.inv_transfo[dev.mesh_prim_index[i]].numpy()
    o, d = random_rays(M, 23, lo=-150.0, hi=150.0)
    o[:, :M // 2] = np.array([[0.0], [-250.0], [60.0]], np.float32)
    g = np.random.RandomState(5)
    aim = g.uniform(-60, 60, (3, M // 2)).astype(np.float32) - o[:, :M // 2]
    d[:, :M // 2] = aim / np.linalg.norm(aim, axis=0)
    oi = (inv[:3, :3] @ o + inv[:3, 3:4]).astype(np.float32)
    di = inv[:3, :3] @ d
    di = (di / np.linalg.norm(di, axis=0)).astype(np.float32)
    return tri, jtri, torch.as_tensor(oi), torch.as_tensor(di)


@pytest.fixture(scope="module")
def mesh0(mesh_demo):
    return _instance(mesh_demo, 0)


def _tie_tris(n=300, seed=9):
    """n random triangles [P, 3] x 3 (numpy) in a 10-unit box with exact
    duplicates (7 repeats 3 in the same chunk, and triangle i + 150
    repeats triangle i for i < 40, in another chunk) and a zero triangle between
    real ones; and M rays aimed at the duplicated triangles' centroids."""
    g = np.random.RandomState(seed)
    va = g.uniform(-5, 5, (n, 3)).astype(np.float32)
    vb = (va + g.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
    vc = (va + g.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
    for v in (va, vb, vc):
        v[7] = v[3]
        v[150:190] = v[0:40]
        v[100] = 0.0
    o = g.uniform(-20, 20, (3, M)).astype(np.float32)
    target = ((va + vb + vc) / 3.0)[g.randint(0, 40, M)].T
    d = target - o
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return va, vb, vc, o, d


# --------------------------------------------------------------------------
# staging against the JAX package's tables
# --------------------------------------------------------------------------

def test_staged_tris_match_jax_pad_tris(mesh0):
    """K4a's staged A and edges are the JAX pad_tris rows and their
    float32 differences (mt_chunk's and _tri_kernel's e1, e2), and each
    chunk ends one past its last real triangle."""
    tri, jtri, _, _ = mesh0
    jrows = np.asarray(jtri)
    a, e1, e2, ends = stage_tris(tri)
    np.testing.assert_array_equal(_bits(a), _bits(jrows[0:3]))
    np.testing.assert_array_equal(_bits(e1), _bits(jrows[3:6] - jrows[0:3]))
    np.testing.assert_array_equal(_bits(e2), _bits(jrows[6:9] - jrows[0:3]))
    real = int((jrows != 0).any(axis=0).sum())
    full, rest = divmod(real, CHUNK)
    want = [CHUNK] * full + ([rest] if rest else [])
    want += [0] * (tri.shape[1] // CHUNK - len(want))
    assert ends.tolist() == want and rest > 0   # a partial last chunk


def test_staged_prims_match_jax_pad_group():
    """K3a's staged rows are the JAX _pad_group rows, with a NaN inverse
    frame exactly where the scene id is < 0 (the padding and any hole),
    and each chunk ends one past its last prim with a scene id >= 0."""
    trf, inv, pid = _group(3, n_prims=300)
    pid[[5, 130, 131]] = -1                      # holes between prims
    (inv_r, trf_r, pid_t), (jinv, jtrf, jpid) = _pad_both(trf, inv, pid)
    sinv, strf, ends = stage_prims(inv_r, trf_r, pid_t)
    jinv, jtrf, jpid = (np.asarray(x) for x in (jinv, jtrf, jpid))
    real = jpid[0] >= 0
    np.testing.assert_array_equal(_bits(sinv[:, real]), _bits(jinv[:, real]))
    assert torch.isnan(sinv[:, ~real]).all()
    np.testing.assert_array_equal(_bits(strf), _bits(jtrf))
    assert ends.tolist() == [128, 128, 300 - 256]


# --------------------------------------------------------------------------
# K3a's shape tests
# --------------------------------------------------------------------------

def _local_rays(seed, m=4096):
    """Local-frame rays: origins in [-3, 3]^3 and unit directions, with
    the cases the masks meet: directions along an axis (zero components),
    origins on the unit faces and in the shapes' planes."""
    o, d = random_rays(m, seed, lo=-3.0, hi=3.0)
    d[:, 0:300] = 0.0
    d[np.arange(300) % 3, np.arange(300)] = np.where(
        np.arange(300) % 2, 1.0, -1.0)
    d[2, 300:600] = 0.0
    d[:, 300:600] /= np.linalg.norm(d[:, 300:600], axis=0)
    o[0, 600:700] = 1.0
    o[2, 700:800] = -1.0
    o[:, 800:900] = 0.0
    return [torch.as_tensor(x) for x in (*o, *d)]


@pytest.mark.parametrize("code", CODES)
def test_masked_shape_tests_equal_plain(code):
    """K3a's select-form shape tests give the plain SOA tests' a, valid and
    code bit for bit: a masked argument changes only values the test
    drops."""
    rays = _local_rays(code)
    got = G_FNS[code](*rays)
    ref = SOA_FNS[code](*rays)
    assert ref[1].float().mean() > 0.02          # the rays hit something
    _assert_bits(got, ref, f"shape {code}")


# --------------------------------------------------------------------------
# K3a's fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_prims", [128, 200, 300])
@pytest.mark.parametrize("code", CODES)
def test_group_mirror_equals_plain(code, n_prims):
    """K3a's fold: every output bit-equal to group_best_rows_plain on a
    group of one full chunk, of two (the second cut at its real count)
    and of three."""
    (inv_r, trf_r, pid), _ = _pad_both(*_group(code, n_prims=n_prims))
    o, d = (torch.as_tensor(x) for x in random_rays(M, code))
    stats = {}
    got = group_fold_mirror(o, d, code, inv_r, trf_r, pid, stats)
    ref = pt.group_best_rows_plain(o, d, code, inv_r, trf_r, pid)
    assert (ref[1] >= 0).float().mean() > 0.05
    assert stats["tested"] == n_prims and stats["skipped"] > 0
    _assert_bits(got, ref, f"K3a shape {code}, {n_prims} prims")


@pytest.mark.parametrize("code", CODES)
def test_group_mirror_matches_jax(code):
    """K3a's fold against the JAX Pallas kernel in interpret mode."""
    (inv_r, trf_r, pid), jtab = _pad_both(*_group(code))
    o, d = random_rays(M, code)
    ref = [np.asarray(x) for x in jpt.group_best_rows(
        jnp.asarray(o), jnp.asarray(d), code, *jtab, interpret=True)]
    got = [x.numpy() for x in group_fold_mirror(
        torch.as_tensor(o), torch.as_tensor(d), code, inv_r, trf_r, pid)]
    assert_trace_protocol(ref[:2], got[:2], f"K3a shape {code}", JAX_RTOL)
    same = (ref[1] == got[1]) & (ref[1] >= 0)
    np.testing.assert_allclose(got[2][same], ref[2][same], rtol=JAX_RTOL)
    np.testing.assert_array_equal(got[3][same], ref[3][same])
    np.testing.assert_array_equal(got[1][ref[1] < 0], -1)


@pytest.mark.parametrize("code", [2, 3])
def test_group_mirror_ties_and_holes(code):
    """Duplicated prims (exact distance ties, inside a chunk and across
    chunks) go to the lower row, and prims with a scene id < 0 between
    real ones never hit: bit-equal to the plain version."""
    trf, inv, pid = _group(code, n_prims=200, seed=code)
    trf[9], inv[9] = trf[4], inv[4]                     # a tie in a chunk
    trf[140:180], inv[140:180] = trf[0:40], inv[0:40]   # ties across chunks
    pid[[20, 21, 150]] = -1
    (inv_r, trf_r, pid_t), _ = _pad_both(trf, inv, pid)
    centers = torch.as_tensor(trf[:40, :3, 3])
    g = np.random.RandomState(code)
    o = torch.as_tensor(g.uniform(-80, 80, (3, M)).astype(np.float32))
    d = centers[torch.as_tensor(g.randint(0, 40, M))].T - o
    d = d / torch.linalg.vector_norm(d, dim=0)
    ref = pt.group_best_rows_plain(o, d, code, inv_r, trf_r, pid_t)
    got = group_fold_mirror(o, d, code, inv_r, trf_r, pid_t)
    _assert_bits(got, ref, "K3a ties")
    row = ref[1].numpy()
    assert (row >= 0).mean() > 0.5
    assert not np.isin(row, [9, 20, 21, 150]).any()
    # a duplicate wins only where its twin is a hole (20 and 21)
    twins = row[(row >= 140) & (row < 180)]
    assert np.isin(twins, [160, 161]).all()


@pytest.mark.parametrize("code", [2, 3])
def test_group_needed_work_from_inputs(code):
    """The work chip_smoke.py counts for K3a's bound comes from the
    launch's inputs, not from the kernel: every ray against every prim
    with a scene id >= 0, and the pairs whose shape test passes. Holes
    before a chunk's last real prim are tested by the fold (NaN frames)
    but not needed."""
    trf, inv, pid = _group(code, n_prims=200)
    pid[[20, 21, 150]] = -1
    (inv_r, trf_r, pid_t), _ = _pad_both(trf, inv, pid)
    o, d = (torch.as_tensor(x) for x in random_rays(M, code))
    args = (o, d, code, inv_r, trf_r, pid_t)
    stats = {}
    group_fold_mirror(*args, stats)
    needed = chip_smoke._needed("K3a", args, pt.group_best_rows_plain(*args))
    assert int(needed[0]) == M * 197 < M * stats["tested"]
    assert int(needed[1]) == stats["passes"] > 0
    assert int(needed[2]) == 0


# --------------------------------------------------------------------------
# K4a's fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("instance", [0, 1, 2])
def test_mesh_mirror_equals_plain(mesh_demo, instance):
    """K4a's fold on each of mesh_demo's instances (18, 8 and 18 chunks,
    the last one partial): (a, row) bit-equal to mesh_best_rows_plain;
    the gate on u skips part of the tests."""
    tri, _, oi, di = _instance(mesh_demo, instance)
    stats = {}
    got = mesh_fold_mirror(oi, di, tri, stats)
    ref = pt.mesh_best_rows_plain(oi, di, tri)
    assert (ref[1] >= 0).float().mean() > 0.05
    assert stats["skipped"] > 0
    assert stats["tested"] == int((tri != 0).any(dim=0).sum())
    _assert_bits(got, ref, f"K4a instance {instance}")


def test_mesh_mirror_matches_jax(mesh0):
    """K4a's fold against the JAX Pallas kernel in interpret mode."""
    tri, jtri, oi, di = mesh0
    ref = [np.asarray(x) for x in jpt.mesh_best_rows(
        jnp.asarray(oi.numpy()), jnp.asarray(di.numpy()), jtri,
        interpret=True)]
    got = [x.numpy() for x in mesh_fold_mirror(oi, di, tri)]
    assert_trace_protocol(ref, got, "K4a mesh_demo instance 0", JAX_RTOL)
    np.testing.assert_array_equal(got[0][ref[1] < 0], ref[0][ref[1] < 0])


def test_mesh_mirror_ties_and_padding():
    """Duplicated triangles (exact ties, in a chunk and across chunks) go
    to the lower row; a zero triangle between real ones and the padding
    past 300 never hit: bit-equal to the plain version, and to JAX's
    rows."""
    va, vb, vc, o, d = _tie_tris()
    tri = pt.pad_tris(*(torch.as_tensor(v) for v in (va, vb, vc)))
    jtri = jpt.pad_tris(*(jnp.asarray(v) for v in (va, vb, vc)))
    o_t, d_t = torch.as_tensor(o), torch.as_tensor(d)
    ref = pt.mesh_best_rows_plain(o_t, d_t, tri)
    got = mesh_fold_mirror(o_t, d_t, tri)
    _assert_bits(got, ref, "K4a ties")
    row = ref[1].numpy()
    assert (row >= 0).mean() > 0.5
    assert not np.isin(row, [7, 100]).any()
    assert not ((row >= 150) & (row < 190)).any()
    jref = [np.asarray(x) for x in jpt.mesh_best_rows(
        jnp.asarray(o), jnp.asarray(d), jtri, interpret=True)]
    assert_trace_protocol(jref, [x.numpy() for x in got], "K4a ties",
                          JAX_RTOL)
