"""The harness finds a cell's files by name: a configuration, a traffic
mix, a scene, limits or a per-layer metric added under a new name needs
new files and new BENCHMARK.json entries, and no edit of a file that is
there. Also the shape of the result line."""
import json
import os
import shutil

import pytest

from portbench.harness import cell as cells, spec


def _add_cell(root):
    """A new configuration, traffic mix, limits file and metric, and the
    entries that name them; returns the files that were there before."""
    before = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            before[p] = open(p, "rb").read()
    pb = os.path.join(root, "portbench")
    cfg = spec.load_json(os.path.join(pb, "configs", "c3_mesh_demo.json"))
    cfg.update(name="c9_mesh_small", bounces=2)
    with open(os.path.join(pb, "configs", "c9_mesh_small.json"), "w") as f:
        json.dump(cfg, f)
    traffic = spec.load_json(os.path.join(pb, "traffic", "batch.json"))
    traffic["passes_per_step"] = 2
    with open(os.path.join(pb, "traffic", "batch2.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(pb, "limits", "c3_mesh_batch.json"),
                os.path.join(pb, "limits", "c9_mesh_small_batch2.json"))
    with open(os.path.join(pb, "metrics", "steps_per_window.py"), "w") as f:
        f.write("def read(run):\n    return run['cards'][0]['frames']\n")
    bench = spec.benchmark(root)
    bench["configs"].append({"name": "c9_mesh_small", "source": "test",
                             "file": "portbench/configs/c9_mesh_small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "c9_mesh_small_batch2",
                               "config": "c9_mesh_small",
                               "traffic": "batch2", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("c9_mesh_small_batch2")
    bench["per_layer"].append({"name": "steps_per_window", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry", "moves": "rays_per_s",
                               "workloads": ["c9_mesh_small_batch2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return before


def test_a_new_cell_is_found_by_name(tmp_path):
    from portbench.tests.tiny import make_root
    root = make_root(tmp_path)
    before = _add_cell(root)
    for p, data in before.items():
        if not p.endswith("BENCHMARK.json"):
            assert open(p, "rb").read() == data, p
    cell = spec.cell("c9_mesh_small_batch2", root)
    assert cell["config"]["bounces"] == 2
    assert cell["traffic"]["passes_per_step"] == 2
    assert [m["name"] for m in cell["per_layer"]] == [
        "scene_compile_s", "steps_per_window"]
    assert {m["name"] for m in cell["end_to_end"]} == {"rays_per_s",
                                                        "setup_s"}
    record = {"cards": [{"frames": 7, "passes": 14, "launches": 0,
                         "spans": {"scene_compile": [0.5]},
                         "trace": None}]}
    assert cells.per_layer(cell, record, root) == {
        "scene_compile_s": {"value": 0.5, "unit": "s"},
        "steps_per_window": {"value": 7, "unit": "steps"}}
    res = cells.run_cell("c9_mesh_small_batch2", 5, 0.2, False,
                         device="cpu", root=root)
    assert res["correct"] and set(res["metrics"]) == {"rays_per_s",
                                                       "setup_s"}


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tiny_root):
    cell = spec.cell("c5_colonnes_batch", tiny_root)
    record = {"cards": [{"frames": 3, "passes": 24, "launches": 0,
                         "spans": {"scene_compile": [0.25]},
                         "trace": None}]}
    assert cells.per_layer(cell, record, tiny_root) == {
        "scene_compile_s": {"value": 0.25, "unit": "s"}}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_has_the_keys_its_readers_need(tiny_root, trace):
    res = cells.run_cell("c3_mesh_batch", 2 ** 31 + 7, 0.2, bool(trace),
                         device="cpu", root=tiny_root)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "scene_compile_s" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"rays_per_s", "setup_s"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
