"""A copy of the benchmark at a size the CPU runs in seconds, for the
harness's tests: the same BENCHMARK.json, traffic, limits and metric
readers, with each configuration cut to a few hundred pixels, and the
interactive cell, whose files are there and which BENCHMARK.json does
not run yet, with its metrics."""
from __future__ import annotations

import json
import os
import shutil

from portbench.harness import spec

SIZES = {"c5_colonnes": (16, 9), "c3_mesh_demo": (16, 12)}
INTERACTIVE = "c5_colonnes_interactive"
FRAME_METRICS = (("idle_pct.frame", "%", "device_trace", "device"),
                 ("pass_ms.frame", "ms", "program_span", "entry"),
                 ("resolve_ms.frame", "ms", "program_span", "resolve"))
# each scene cut to a few primitives and small meshes, on the same routes
# (K1's plain version for colonnes, K2's for mesh_demo)
PRIMS = {"colonnes": 12}
MESHES = {"sphere": {"res": 4}, "torus": {"n1": 6, "n2": 4}}


def make_root(tmp) -> str:
    root = str(tmp)
    pb = os.path.join(root, "portbench")
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, sub), os.path.join(pb, sub))
    os.makedirs(os.path.join(pb, "configs"))
    os.makedirs(os.path.join(pb, "scenes"))
    for name in os.listdir(os.path.join(spec.HERE, "scenes")):
        scene = spec.load_json(os.path.join(spec.HERE, "scenes", name))
        keep = PRIMS.get(scene["name"])
        if keep:
            scene["prims"] = scene["prims"][:keep] + scene["prims"][-3:]
        for m in scene["meshes"]:
            m.update(MESHES[m["generator"]])
        with open(os.path.join(pb, "scenes", name), "w") as f:
            json.dump(scene, f)
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        cfg["width"], cfg["height"] = SIZES.get(c["name"], (32, 18))
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for t in os.listdir(os.path.join(pb, "traffic")):
        path = os.path.join(pb, "traffic", t)
        traffic = spec.load_json(path)
        if traffic["step"] == "advance":
            traffic["passes_per_step"] = 1
        with open(path, "w") as f:
            json.dump(traffic, f)
    for lim in os.listdir(os.path.join(pb, "limits")):
        path = os.path.join(pb, "limits", lim)
        data = spec.load_json(path)
        data["pixels"] = 64
        with open(path, "w") as f:
            json.dump(data, f)
    bench["workloads"].append({"name": INTERACTIVE, "config": "c5_colonnes",
                               "traffic": "interactive", "chips": 1,
                               "why": "tests"})
    bench["end_to_end"].append({"name": "frame_ms_p95", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [INTERACTIVE]})
    bench["per_layer"] += [{"name": n, "unit": u, "better": "lower",
                            "source": src, "layer": layer,
                            "moves": "frame_ms_p95",
                            "workloads": [INTERACTIVE]}
                           for n, u, src, layer in FRAME_METRICS]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
