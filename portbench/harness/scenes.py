"""Scene descriptions: `portbench/scenes/<name>.json` made into arrays.

A scene file lists its primitives, each with its shape, its 4x4 float32
placement, its RGBA colour and material scalars (an emissive one gives
its emissivity per unit of the configuration's light), and the meshes
its mesh primitives place, each by generator and arguments
(`harness/meshes.py`). `load_scene` returns the description that the
program's scene builder (`harness/port.py`) and the reference
(`reference/scene.py`) both take.
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import meshes

F32 = np.float32
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPE_CODES = {"mesh": 0, "sphere": 1, "cube": 2, "cylinder": 3, "cone": 4,
               "quad": 5}


def load_scene(name: str, light: float, root: str = ROOT) -> dict:
    """The description of portbench/scenes/<name>.json under `root`."""
    with open(os.path.join(root, "portbench", "scenes", f"{name}.json")) as f:
        raw = json.load(f)
    prims = []
    for p in raw["prims"]:
        emis = F32(p.get("emissivity_per_light", 0.0)) * F32(light)
        prims.append({
            "shape": SHAPE_CODES[p["shape"]],
            "matrix": np.asarray(p["matrix"], F32),
            "color": np.asarray(p["color"], F32),
            "shininess": float(F32(p["shininess"])),
            "roughness": float(F32(p["roughness"])),
            "emissivity": float(F32(emis)),
            "mesh": p.get("mesh", -1)})
    built = []
    for m in raw["meshes"]:
        args = {k: v for k, v in m.items() if k != "generator"}
        built.append(meshes.GENERATORS[m["generator"]](**args))
    return {"name": raw["name"], "prims": prims, "meshes": built}
