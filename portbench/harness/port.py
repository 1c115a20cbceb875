"""The program under test, as the benchmark drives it.

Everything the benchmark takes from montecarlo_pathtracing_tpu_torch
goes through here: the scene builder and compile, the renderer
and the kernel launch counters.
"""
from __future__ import annotations

import numpy as np

ADDERS = {1: "add_sphere", 2: "add_cube", 3: "add_cylinder", 4: "add_cone",
          5: "add_oriented_quad"}


def build_scene(desc: dict):
    """The program's ScenePrimitives of a scene description."""
    from montecarlo_pathtracing_tpu_torch.scene.scene import (
        Material, MeshGeometry, ScenePrimitives)

    s = ScenePrimitives()
    ids = [s.add_mesh_geometry(MeshGeometry(m["vertices"].copy(),
                                            m["normals"].copy(),
                                            m["triangles"].copy()))
           for m in desc["meshes"]]
    for p in desc["prims"]:
        mat = Material(p["color"].copy(), p["shininess"], p["roughness"],
                       p["emissivity"])
        trf = np.array(p["matrix"], np.float32)
        if p["shape"] == 0:
            s.place_mesh(ids[p["mesh"]], trf, mat)
        else:
            getattr(s, ADDERS[p["shape"]])(trf, mat)
    return s


def compile_scene(desc: dict, device):
    from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
    return compile_scene(build_scene(desc), device=device)


def render_config(cfg: dict, date: float, device):
    """The program's RenderConfig of a configuration file: what a user
    sets (size, bounces, IOR, light), the rest at the program's
    defaults."""
    from montecarlo_pathtracing_tpu_torch.render.renderer import RenderConfig
    return RenderConfig(width=cfg["width"], height=cfg["height"],
                        nb_bounces=cfg["bounces"], refract_ind=cfg["ior"],
                        light_intensity=cfg["light"], date=date,
                        device=str(device))


def renderer(scene, rcfg, proj, view):
    from montecarlo_pathtracing_tpu_torch.render.renderer import Renderer
    return Renderer(scene, rcfg, proj, view)


def launches() -> int:
    """K1 and K2 launches so far in this process."""
    from montecarlo_pathtracing_tpu_torch.models.bounce_kernel import (
        k2_launch)
    from montecarlo_pathtracing_tpu_torch.models.megakernel import k1_launch
    return int(k1_launch.launches) + int(k2_launch.launches)
