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
