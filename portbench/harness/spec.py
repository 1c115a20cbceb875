"""BENCHMARK.json and the files it names, found by name.

A workload names its configuration and its traffic mix; each is a file
under `portbench/` (`configs/<config>.json` as BENCHMARK.json's
`configs[].file` gives it, `traffic/<traffic>.json`,
`limits/<workload>.json`), and each per-layer metric is read by
`metrics/<metric>.py`. Adding a cell, a configuration, a traffic mix or
a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """Everything one workload runs with: its BENCHMARK.json entry, its
    configuration, traffic and limits, and the metrics it reports
    (end to end with `trace` 0, per layer with 1)."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    pb = os.path.join(root, "portbench")
    return {
        "workload": work,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(pb, "traffic",
                                          f"{work['traffic']}.json")),
        "limits": load_json(os.path.join(pb, "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
        "run_seconds": bench["run_seconds"],
    }


def metric_reader(name: str, root: str = ROOT):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
