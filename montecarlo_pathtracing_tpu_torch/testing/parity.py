"""Parity protocols shared by the CPU tests and chip_smoke.py.

The megakernel protocol is the reference's own for its kernel route
(tests/test_megakernel.py:43-46): more than 98% of lanes within 1e-3 abs
+ 1e-3 rel, and image means within 2e-3. The RNG streams are
bit-identical, so most lanes agree to float rounding; the rest are paths
that a last-ulp difference (FMA contraction, another libm) sent down
another branch of the material logic, which then differ by O(1).

The fused protocol is the reference's for its fused per-bounce route
(tests/test_bounce_kernel.py:36-45): at most 0.5% of pixels more than
1e-3 off in any channel (1.5% on the large analytic stress scene, whose
grazing sphere hits amplify ulps through the Phong exponent,
tests/test_bounce_kernel.py:116-119). The walks are conservative, so
winners differ only on exact distance ties and ulp-level flips at an
edge or a shape test's threshold.
"""
from __future__ import annotations

import numpy as np

MIN_CLOSE = 0.98
ATOL = RTOL = 1e-3
MEAN_TOL = 2e-3


def megakernel_match(ref, got):
    """(share of lanes within tolerance, |mean difference|, max abs
    error) of two rgb arrays of the same shape."""
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    got = np.asarray(got, np.float64).reshape(-1, 3)
    if ref.shape != got.shape:
        raise ValueError(f"shapes differ: {ref.shape} vs {got.shape}")
    err = np.abs(ref - got)
    close = np.all(err <= ATOL + RTOL * np.abs(ref), axis=-1)
    return (float(close.mean()), float(abs(ref.mean() - got.mean())),
            float(err.max()) if err.size else 0.0)


def assert_megakernel_protocol(ref, got, what: str = ""):
    frac, dmean, _ = megakernel_match(ref, got)
    if not (frac > MIN_CLOSE and dmean < MEAN_TOL):
        raise AssertionError(
            f"{what}: {frac:.4f} of lanes close (need > {MIN_CLOSE}), "
            f"|mean diff| {dmean:.2e} (need < {MEAN_TOL})")


FUSED_TOL = 1e-3
FUSED_FRAC = 0.005
FUSED_FRAC_STRESS = 0.015


def fused_match(ref, got, tol: float = FUSED_TOL):
    """(share of pixels with some channel more than tol off, max abs
    error) of two rgb arrays of the same shape."""
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    got = np.asarray(got, np.float64).reshape(-1, 3)
    if ref.shape != got.shape:
        raise ValueError(f"shapes differ: {ref.shape} vs {got.shape}")
    err = np.abs(ref - got).max(axis=1)
    return float((err > tol).mean()), float(err.max()) if err.size else 0.0


def assert_fused_protocol(ref, got, what: str = "",
                          frac: float = FUSED_FRAC):
    off, err = fused_match(ref, got)
    if off > frac:
        raise AssertionError(
            f"{what}: {off:.4f} of pixels more than {FUSED_TOL} off (allowed "
            f"{frac}), max abs error {err:.3e}")


TRACE_RTOL = 1e-5
TRACE_MIN_EQUAL = 0.99


def trace_match(ref_dist, ref_row, got_dist, got_row, rtol=TRACE_RTOL):
    """Winners of two closest-hit folds over the same rays: (share of
    rays with the same winner row, rays whose rows differ although their
    distances do not agree to rtol, max relative and max absolute
    difference of the distances where both hit). Distances are world
    distances (K3a, K5) or local ray parameters (K4a, K6); a miss is
    row -1."""
    rd = np.asarray(ref_dist, np.float64)
    gd = np.asarray(got_dist, np.float64)
    rr = np.asarray(ref_row)
    gr = np.asarray(got_row)
    same = rr == gr
    both = (rr >= 0) & (gr >= 0)
    diff = np.abs(rd - gd)
    rel = np.where(both, diff / np.maximum(np.abs(rd), 1e-30), 0.0)
    # a differing winner is a tie or a last-ulp flip only if both hit at
    # the same distance
    bad = ~same & ~(both & (rel <= rtol))
    return (float(same.mean()), int(bad.sum()),
            float(rel.max()) if rel.size else 0.0,
            float(np.where(both, diff, 0.0).max()) if diff.size else 0.0)


def assert_trace_protocol(ref, got, what: str = "", rtol=TRACE_RTOL):
    """ref, got: (dist, row) pairs. Winner rows equal on at least
    TRACE_MIN_EQUAL of the rays, distances within rtol relative wherever
    both hit, and a differing row only where both distances agree (exact
    ties and last-ulp flips between neighbours)."""
    frac, bad, rel, _ = trace_match(ref[0], ref[1], got[0], got[1], rtol)
    if frac < TRACE_MIN_EQUAL or bad or rel > rtol:
        raise AssertionError(
            f"{what}: rows equal on {frac:.5f} of rays (need "
            f">= {TRACE_MIN_EQUAL}), {bad} differing rows without equal "
            f"distances, max relative distance error {rel:.2e} (allowed "
            f"{rtol})")


def random_group(tf, code, n_prims, seed):
    """A random homogeneous group as the reference's trace tests build it
    (tests/test_pallas_trace.py:14-25), from the given package's
    `utils.transforms`: (transfo [n,4,4], inverse [n,4,4], sparse scene
    ids [n]) as numpy. `code` only seeds the draw, as there."""
    rs = np.random.RandomState(seed)
    trf = np.zeros((n_prims, 4, 4), np.float32)
    inv = np.zeros((n_prims, 4, 4), np.float32)
    for i in range(n_prims):
        m = (tf.translate(*rs.uniform(-50, 50, 3))
             @ tf.rotate(rs.uniform(0, 360), rs.uniform(0.1, 1, 3))
             @ tf.scale(*rs.uniform(0.5, 8.0, 3)))
        trf[i] = m
        inv[i] = tf.inverse(m)
    return trf, inv, np.arange(n_prims, dtype=np.int32) * 3 + 1


def group_chunk_boxes(trf, ppad, chunk=128):
    """World boxes [6, ppad / chunk] of a random group's chunks, as the
    reference's culled-kernel test makes them (tests/test_pallas_trace.py:
    146-158): each prim a cube about its center of twice its largest
    row's absolute sum, each chunk the union of its prims' cubes, and an
    empty box (min 1, max -1) for a chunk past the last prim. trf [n, 4, 4]
    numpy; float32 numpy out."""
    centers = trf[:, :3, 3]
    rad = np.abs(trf[:, :3, :3]).sum(2).max(1) * 2.0
    cbb = np.zeros((6, ppad // chunk), np.float32)
    for c in range(cbb.shape[1]):
        lo, hi = c * chunk, min((c + 1) * chunk, len(centers))
        if lo < len(centers):
            cbb[0:3, c] = (centers[lo:hi] - rad[lo:hi, None]).min(0)
            cbb[3:6, c] = (centers[lo:hi] + rad[lo:hi, None]).max(0)
        else:
            cbb[0:3, c] = 1.0
            cbb[3:6, c] = -1.0
    return cbb


def random_rays(m, seed, lo=-80.0, hi=80.0):
    """m rays with uniform origins in [lo, hi]^3 and unit directions, as
    [3, m] float32 numpy rows (o, d)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (3, m)).astype(np.float32)
    d = rs.normal(size=(3, m)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


def all_shapes_scene(scene_mod, tf):
    """A scene that drives every branch of the megakernel: all five shape
    codes, transparent and mixed materials (the refraction re-trace) and,
    at 70 prims, the two-level cull. Built with the given package's
    `scene.scene` module and `utils.transforms`, so the JAX reference and
    the port compile the same prims."""
    M = scene_mod.Material
    s = scene_mod.ScenePrimitives()
    T, S, RX = tf.translate, tf.scale, tf.rotate_x
    white = np.array([0.9, 0.9, 0.9, 1.0], np.float32)
    s.add_oriented_quad(T(0, 0, -100) @ S(100, 100, 1), M(white))
    s.add_oriented_quad(T(0, 100, 0) @ RX(90) @ S(100, 100, 1),
                        M(np.array([0.0, 0.9, 0.9, 1.0], np.float32)))
    s.add_cube(T(60, 40, -70) @ S(15, 15, 30), M(white, 0.6, 0.9))
    s.add_sphere(T(0, -20, -60) @ S(25),
                 M(np.array([0.9, 0.9, 0.0, 0.5], np.float32), 0.65, 1.0))
    s.add_sphere(T(-60, 30, -70) @ S(20),
                 M(np.array([0.9, 0.0, 0.0, 0.3], np.float32)))
    for i in range(8):
        for j in range(8):
            m = T(-84 + 24 * i, -84 + 24 * j, -90) @ S(6, 6, 10)
            a = 0.4 if (i + j) % 5 == 0 else 1.0
            mat = M(np.array([0.2 + 0.1 * i, 0.9 - 0.1 * j, 0.5, a],
                             np.float32), 0.1 * (j % 3), 0.8)
            if (i + j) % 2:
                s.add_cylinder(m, mat)
            else:
                s.add_cone(m, mat)
    s.add_oriented_quad(T(0, 0, 99) @ RX(180) @ S(40, 40, 1),
                        M.light(white, 12.0))
    return s


def cull_mesh_scene(scene_mod, mesh_mod, tf):
    """A mesh scene whose small analytic table has more than 64 prims, so
    the fused route's small-table fold runs culled (cull_small): the
    all-shapes scene with a sphere mesh instance added."""
    s = all_shapes_scene(scene_mod, tf)
    sph = s.add_mesh_geometry(mesh_mod.sphere(12))
    s.place_mesh(sph, tf.translate(-30, -60, -50) @ tf.scale(22),
                 scene_mod.Material(np.array([0.2, 0.9, 0.2, 1.0],
                                             np.float32), 0.3, 0.9))
    return s


def opaque_mesh_scene(scene_mod, mesh_mod, tf):
    """The reference's opaque mesh fixture (tests/test_bounce_kernel.py:
    68-75): a floor, a sphere mesh and an area light."""
    M = scene_mod.Material
    T, S = tf.translate, tf.scale
    s = scene_mod.ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -60) @ S(400, 400, 1), M((1, 1, 1, 1)))
    sph = s.add_mesh_geometry(mesh_mod.sphere(12))
    s.place_mesh(sph, T(0, 0, -20) @ S(35), M((1, 0.2, 0.2, 1), 0.3, 0.9))
    s.add_oriented_quad(T(0, 0, 150) @ S(60, 60, 1),
                        M.light((1, 1, 1, 1), 12.0))
    return s
