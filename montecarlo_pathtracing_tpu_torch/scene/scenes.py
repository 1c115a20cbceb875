"""The 8 built-in demo scenes + Menger fractal generators.

Faithful re-creations of the reference viewer's scene constructors
(MontecarloGPU/montecarlo.cpp:629-795) and the menger/menger_sphere
recursions (:143-218). In the reference these are bound to keyboard keys
Q W E R T Y U I; here they are a name->constructor registry for the CLI.

`light_intensity` is baked into emissive materials at scene build time,
exactly as the reference does (the shader's light_intensity uniform is
unused — montecarlo.cpp:649,675-679).
"""
from __future__ import annotations

import numpy as np

from ..utils import transforms as tf
from .scene import Material, ScenePrimitives
from . import mesh as meshlib

# color constants (montecarlo.cpp:33-44)
ROUGE = np.array([0.9, 0, 0, 1], np.float32)
VERT = np.array([0, 0.9, 0, 1], np.float32)
BLEU = np.array([0, 0, 0.9, 1], np.float32)
JAUNE = np.array([0.9, 0.9, 0, 1], np.float32)
CYAN = np.array([0, 0.9, 0.9, 1], np.float32)
MAGENTA = np.array([0.9, 0, 0.9, 1], np.float32)
BLANC = np.array([0.9, 0.9, 0.9, 1], np.float32)
GRIS = np.array([0.45, 0.45, 0.45, 1], np.float32)
NOIR = np.array([0, 0, 0, 1], np.float32)
ORANGE = np.array([0.9, 0.45, 0, 1], np.float32)

T, S, RX, RY, RZ = tf.translate, tf.scale, tf.rotate_x, tf.rotate_y, tf.rotate_z


def opa(c, o):
    c = c.copy()
    c[3] = o
    return c


def menger(scene, m, d, sc, mater, shape="cube"):
    """Menger-sponge recursion (montecarlo.cpp:143-218)."""
    x = 2.0 / 3.0
    y = sc / 3.0
    offsets = [
        (x, x, 0), (-x, x, 0), (-x, -x, 0), (x, -x, 0),
        (x, 0, x), (-x, 0, x), (-x, 0, -x), (x, 0, -x),
        (0, x, x), (0, -x, x), (0, -x, -x), (0, x, -x),
        (x, x, x), (-x, x, x), (-x, -x, x), (x, -x, x),
        (x, x, -x), (-x, x, -x), (-x, -x, -x), (x, -x, -x),
    ]
    for off in offsets:
        mm = m @ T(*off) @ S(y)
        if d > 0:
            menger(scene, mm, d - 1, sc, mater, shape)
        elif shape == "cube":
            scene.add_cube(mm, mater)
        else:
            scene.add_sphere(mm, mater)


def scene_box_diffuse(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:701-717 — key Q. Closed box, 2 cubes, 1 area light."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -100) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(0, 0, 100) @ RX(180) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(0, 100, 0) @ RX(90) @ S(100, 100, 1), Material(CYAN))
    s.add_oriented_quad(T(0, -100, 0) @ RX(-90) @ S(100, 100, 1), Material(JAUNE))
    s.add_oriented_quad(T(-100, 0, 0) @ RY(90) @ S(100, 100, 1), Material(ROUGE))
    s.add_oriented_quad(T(100, 0, 0) @ RY(-90) @ S(100, 100, 1), Material(VERT))
    s.add_cube(T(70, 20, -40) @ RZ(20) @ S(20, 20, 60), Material(BLANC))
    s.add_cube(T(-70, 40, -40) @ RZ(-20) @ S(20, 20, 60), Material(BLANC))
    s.add_oriented_quad(T(0, 0, 99) @ RX(180) @ S(40, 40, 1),
                        Material.light(BLANC, 10 * light_intensity))
    return s


def scene_box_balls(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:720-741 — key W."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -100) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(0, 0, 100) @ RX(180) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(0, 100, 0) @ RX(90) @ S(100, 100, 1), Material(CYAN))
    s.add_oriented_quad(T(0, 99, 0) @ RX(90) @ S(40, 60, 1), Material(BLANC, 1, 1))
    s.add_oriented_quad(T(0, -100, 0) @ RX(-90) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(-100, 0, 0) @ RY(90) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(100, 0, 0) @ RY(-90) @ S(100, 100, 1), Material(BLANC))
    s.add_cube(T(70, 20, -60) @ RZ(20) @ S(20, 20, 40), Material(ROUGE))
    s.add_cube(T(-70, 40, -60) @ RZ(-20) @ S(20, 20, 40), Material(VERT))
    s.add_sphere(T(0, 50, -80) @ S(20), Material(MAGENTA, 0.8, 0.995))
    s.add_sphere(T(0, -30, 0) @ S(40), Material(opa(JAUNE, 0.5), 0.65, 1))
    s.add_sphere(T(70, 20, 5) @ S(20), Material(opa(ROUGE, 0.2), 0.8, 0.95))
    s.add_sphere(T(-70, 40, 5) @ S(20), Material(VERT, 0.7, 0.9))
    s.add_oriented_quad(T(0, 0, 99) @ RX(180) @ S(40, 40, 1),
                        Material.light(BLANC, 12.0 * light_intensity))
    return s


def scene_menger(light_intensity=1.2, depth: int = 1) -> ScenePrimitives:
    """montecarlo.cpp:683-699 — key E, its sponge `depth` levels deep
    (key E's 1: 400 cubes, 410 prims; 2: 8,000 cubes, 8,010 prims)."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -100) @ S(9000, 9000, 1),
                        Material(BLANC, 0.8, 0.999))
    menger(s, T(0, 0, -50) @ RZ(15) @ S(50), depth, 0.9, Material(MAGENTA))
    s.add_cylinder(T(80, 80, -75) @ S(15, 15, 25), Material(BLEU))
    s.add_cylinder(T(-80, 80, -75) @ S(15, 15, 25), Material(VERT))
    s.add_cylinder(T(-80, -80, -75) @ S(15, 15, 25), Material(ROUGE))
    s.add_cylinder(T(80, -80, -75) @ S(15, 15, 25), Material(JAUNE))
    s.add_sphere(T(80, 80, -30) @ S(20), Material(CYAN, 0.6, 0.998))
    s.add_sphere(T(-80, 80, -30) @ S(20), Material(opa(VERT, 0.1), 0.7, 0.5))
    s.add_sphere(T(-80, -80, -30) @ S(20), Material(ROUGE, 0.95, 0.97))
    s.add_sphere(T(80, -80, -30) @ S(20), Material(opa(JAUNE, 0.25), 0.5, 0.999))
    s.add_sphere(T(0, 0, -50) @ S(20), Material(BLANC, 1, 1))
    return s


def scene_menger_d2(light_intensity=1.2) -> ScenePrimitives:
    """Key E with its sponge one level deeper: 8,010 prims, past the
    megakernel's prim table, so it renders on the fused route's analytic
    pool, the whole path in one K2 launch a tile call."""
    return scene_menger(light_intensity, depth=2)


def scene_box_no_top(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:629-652 — key R."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -100) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(0, 100, 0) @ RX(90) @ S(100, 100, 1), Material(CYAN))
    s.add_oriented_quad(T(0, 99, 0) @ RX(90) @ S(40, 60, 1), Material(BLANC, 1, 1))
    s.add_oriented_quad(T(0, -100, 0) @ RX(-90) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(-100, 0, 0) @ RY(90) @ S(100, 100, 1), Material(BLANC))
    s.add_oriented_quad(T(100, 0, 0) @ RY(-90) @ S(100, 100, 1), Material(BLANC))
    s.add_cube(T(70, 20, -60) @ RZ(20) @ S(20, 20, 40), Material(ROUGE))
    s.add_cube(T(-70, 40, -60) @ RZ(-20) @ S(20, 20, 40), Material(VERT))
    s.add_sphere(T(0, 50, -80) @ S(20), Material(MAGENTA, 0.8, 0.995))
    s.add_sphere(T(0, -30, 0) @ S(40), Material(opa(JAUNE, 0.1), 0.65, 1))
    s.add_sphere(T(70, 20, 5) @ S(20), Material(ROUGE, 0.8, 0.95))
    s.add_sphere(T(-70, 40, 5) @ S(20), Material(VERT, 0.7, 0.9))
    s.add_oriented_quad(T(99, -10, -40) @ RY(-90) @ S(60, 5, 1),
                        Material.light(BLANC, 10 * light_intensity))
    return s


def scene_materials(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:743-753 — key T. 11x11 shininess/roughness sweep."""
    s = ScenePrimitives()
    s.add_cube(T(0, 0, -50) @ S(9000, 9000, 1), Material(BLANC))
    for j in range(-5, 6):
        for i in range(-5, 6):
            s.add_sphere(
                T(30 * i, 30 * j, -41) @ S(8),
                Material(ROUGE, 1.0 - 0.075 * (i + 5), 1.0 - 0.01 * (j + 5)),
            )
    return s


def scene_4boules(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:756-770 — key Y."""
    s = ScenePrimitives()
    s.add_cube(T(0, 0, -51) @ S(9000, 9000, 1), Material(BLANC, 0.2, 0.99999))
    s.add_sphere(T(110, 0, 0) @ S(50), Material(opa(MAGENTA, 0.01), 0.7, 0.99))
    s.add_sphere(T(-110, 0, 0) @ S(50), Material(opa(ROUGE, 0.15), 0.5, 0.5))
    s.add_sphere(T(0, 110, 0) @ S(50), Material(opa(CYAN, 0.05), 0.8, 0.7))
    s.add_sphere(T(0, -110, 0) @ S(50), Material(opa(VERT, 0.25), 0.7, 0.9))
    s.add_oriented_quad(T(200, 0, 100) @ RY(-110) @ S(20, 20, 1),
                        Material.light(BLANC, 20 * light_intensity))
    return s


def scene_menger_lights(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:655-681 — key U."""
    s = ScenePrimitives()
    s.add_cube(T(0, 0, -10) @ S(9975, 9975, 1), Material(BLANC, 0.5, 0.9))
    menger(s, T(0, 0, 42) @ RZ(15) @ S(50.0), 1, 0.9, Material(ROUGE))
    menger(s, T(-105, 0, 11) @ S(20.0), 0, 0.7, Material(BLEU))
    menger(s, T(0, -105, 11) @ S(20.0), 0, 0.7, Material(CYAN))
    menger(s, T(0, 105, 11) @ S(20.0), 0, 0.7, Material(MAGENTA))
    menger(s, T(105, 0, 11) @ S(20.0), 0, 0.7, Material(JAUNE))
    s.add_sphere(T(-100, -100, 5) @ S(15),
                 Material(np.array([1, 1, 1, 0.3], np.float32), 0.99, 0.6))
    s.add_sphere(T(-100, 100, 5) @ S(15),
                 Material(np.array([1, 0, 1, 0.2], np.float32), 0.8, 0.4))
    s.add_sphere(T(100, 100, 5) @ S(15),
                 Material(np.array([1, 1, 0, 0.4], np.float32), 0.6, 0.2))
    s.add_sphere(T(100, -100, 5) @ S(15),
                 Material(np.array([0, 1, 0, 0.1], np.float32), 0.4, 0.1))
    s.add_cube(T(0, 0, 500) @ S(1000, 1000, 1), Material(NOIR))
    s.add_sphere(T(0, 0, 42) @ S(10), Material.light(BLANC, 10 * light_intensity))
    s.add_sphere(T(-105, 0, 11) @ S(5), Material.light(BLANC, 10 * light_intensity))
    s.add_sphere(T(105, 0, 11) @ S(5), Material.light(BLANC, 10 * light_intensity))
    s.add_sphere(T(0, 105, 11) @ S(5), Material.light(BLANC, 10 * light_intensity))
    s.add_sphere(T(0, -105, 11) @ S(5), Material.light(BLANC, 10 * light_intensity))
    return s


def scene_colonnes(light_intensity=1.2) -> ScenePrimitives:
    """montecarlo.cpp:772-795 — key I. ~900-prim colonnade (the 'manyrays'
    stress scene)."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -100) @ S(90000, 90000, 1),
                        Material(0.6 * BLANC + 0.4 * VERT, 0.7, 0.9999))
    for i in range(-1000, 1001, 250):
        for j in range(-1000, 1001, 250):
            s.add_cylinder(T(i, j, -98) @ S(60, 60, 2), Material(BLANC))
            s.add_cylinder(T(i, j, -93) @ S(50, 50, 3), Material(BLANC))
            s.add_cylinder(T(i, j, -85) @ S(30, 30, 5), Material(BLANC))
            s.add_cylinder(T(i, j, 0) @ S(20, 20, 80), Material(BLANC))
            s.add_cube(T(i, j, 90) @ S(30, 30, 10), Material(BLANC))
            for ang in (45, 135, 225, 315):
                s.add_cube(T(i, j, 105) @ RZ(ang) @ T(90, 0, 0) @ S(80, 10, 5),
                           Material(BLANC))
            s.add_cylinder(T(i + 125, j + 125, 115) @ S(75, 75, 5), Material(BLANC))
            s.add_cylinder(T(i, j, 115) @ S(65, 65, 5), Material(BLANC))
    s.add_sphere(T(150, 375, -70) @ S(30), Material(JAUNE, 0.5, 0.999))
    s.add_sphere(T(100, 125, -70) @ S(30), Material(opa(CYAN, 0.2), 0.5, 0.9))
    s.add_cube(T(125, -125, -80) @ RZ(45) @ S(20), Material(ROUGE, 0.1, 0.2))
    return s


def scene_mesh_demo(light_intensity=1.2) -> ScenePrimitives:
    """Triangle-mesh showcase (BASELINE config 3): instanced procedural
    meshes traced through the two-level BVH path. New-framework fixture —
    the reference has the mesh machinery (scene.cpp:56-67,
    gpu_bvh_scene.cpp:51-118) but no built-in mesh scene."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -60) @ S(500, 500, 1), Material(BLANC))
    sph = s.add_mesh_geometry(meshlib.sphere(24))
    tor = s.add_mesh_geometry(meshlib.torus())
    s.place_mesh(sph, T(-60, 0, -20) @ S(35), Material(ROUGE, 0.4, 0.9))
    s.place_mesh(tor, T(60, 0, -35) @ RX(90) @ S(30), Material(CYAN, 0.2, 0.5))
    s.place_mesh(sph, T(0, 80, -25) @ S(30), Material(opa(JAUNE, 0.5), 0.65, 1))
    s.add_cube(T(0, -90, -40) @ RZ(30) @ S(20, 20, 20), Material(VERT))
    s.add_oriented_quad(T(0, 0, 150) @ RX(180) @ S(60, 60, 1),
                        Material.light(BLANC, 10 * light_intensity))
    return s


def scene_mesh_hires(light_intensity=1.2) -> ScenePrimitives:
    """Large-mesh stress fixture: a 101,760-triangle lat-long sphere
    (sphere(160)) plus a 20k-tri torus — the >=50k-tri benchmark scene
    for the per-mesh chunk-culling path (the scale the reference demos
    via Assimp imports, README.md 'Exemples de scenes')."""
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -60) @ S(500, 500, 1), Material(BLANC))
    big = s.add_mesh_geometry(meshlib.sphere(160))            # ~102k tris
    tor = s.add_mesh_geometry(meshlib.torus(n1=100, n2=100))  # 20k tris
    s.place_mesh(big, T(-45, 0, -15) @ S(42), Material(ROUGE, 0.35, 0.85))
    s.place_mesh(tor, T(70, 20, -35) @ RX(90) @ S(28),
                 Material(CYAN, 0.2, 0.5))
    s.add_cube(T(20, -95, -42) @ RZ(25) @ S(18), Material(VERT))
    s.add_oriented_quad(T(0, 0, 150) @ RX(180) @ S(60, 60, 1),
                        Material.light(BLANC, 10 * light_intensity))
    return s


def scene_stress(light_intensity=1.2, n_prims: int = 10240,
                 seed: int = 7) -> ScenePrimitives:
    """Procedural large-scene stress fixture: a jittered grid of ~n_prims
    spheres/cubes over a ground plane under one area light. New-framework
    fixture (the reference's traversal bound is ~2^27 prims via 29-deep
    BVH stacks, shaders/raytracer_func.frag:644,736, but it ships no
    large scene) — used by benchmarks/stress_curve.py to demonstrate the
    fused/worklist paths' scaling beyond the megakernel's SMEM cap."""
    rng = np.random.default_rng(seed)
    s = ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -12) @ S(4000, 4000, 1), Material(GRIS))
    side = int(np.ceil(np.sqrt(n_prims - 2)))
    pitch = 24.0
    ext = side * pitch / 2.0
    count = 0
    cols = [ROUGE, VERT, BLEU, JAUNE, CYAN, MAGENTA, BLANC, ORANGE]
    for i in range(side):
        for j in range(side):
            if count >= n_prims - 2:
                break
            x = (i + 0.5) * pitch - ext + rng.uniform(-6, 6)
            y = (j + 0.5) * pitch - ext + rng.uniform(-6, 6)
            r = rng.uniform(3.0, 8.0)
            mat = Material(cols[(i * 7 + j) % 8],
                           float(rng.uniform(0, 0.6)) if (count % 3) else 0.0,
                           float(rng.uniform(0, 1)))
            m = T(x, y, -12 + r) @ S(r)
            if count % 4 == 0:
                s.add_cube(m @ RZ(float(rng.uniform(0, 90))), mat)
            else:
                s.add_sphere(m, mat)
            count += 1
    s.add_oriented_quad(T(0, 0, 600) @ RX(180) @ S(300, 300, 1),
                        Material.light(BLANC, 10 * light_intensity))
    return s


SCENES = {
    "box_diffuse": scene_box_diffuse,    # Q
    "box_balls": scene_box_balls,        # W
    "menger": scene_menger,              # E
    "menger_d2": scene_menger_d2,        # E, sponge depth 2
    "box_no_top": scene_box_no_top,      # R
    "materials": scene_materials,        # T
    "4boules": scene_4boules,            # Y
    "menger_lights": scene_menger_lights,  # U
    "colonnes": scene_colonnes,          # I
    "mesh_demo": scene_mesh_demo,        # new
    "mesh_hires": scene_mesh_hires,      # new, >=50k-tri stress
    "stress_10k": scene_stress,          # new, 10k-prim analytic stress
}


def build(name: str, light_intensity: float = 1.2) -> ScenePrimitives:
    return SCENES[name](light_intensity)
