"""The program's spans as the benchmark reads them
(`harness/program_spans.py`, `tools/spans.py`, `tools/span_cost.py`):
summaries, the readers of host ms a pass, the join of leaf spans to the
device's idle time on a synthetic timeline, a tiny traced run of each
cell on the CPU that prints the metrics its spans give, and the cost
tool's steps with spans off and on."""
from types import SimpleNamespace

import pytest

from portbench.harness import loop, program_spans, trace
from portbench.tools import spans as tool


def _span(name, start, end, parent=-1):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           request=1, attrs={})


# one advance of 100 us: two tiles, each with two leaves, and a sync
TIMELINE = [
    _span("advance", 0, 100_000),
    _span("tile", 0, 40_000, 0),
    _span("k1.inputs", 0, 30_000, 1),
    _span("k1.launch", 30_000, 38_000, 1),
    _span("tile", 40_000, 80_000, 0),
    _span("k1.inputs", 40_000, 70_000, 4),
    _span("k1.launch", 70_000, 78_000, 4),
    _span("advance.sync", 80_000, 100_000, 0),
]


def test_a_part_sums_each_name_and_its_self_time():
    p = program_spans.part(TIMELINE, passes=2, raw=True)
    assert p["passes"] == 2
    s = p["spans"]
    assert s["advance"] == pytest.approx({"count": 1, "s": 100e-6,
                                          "self_s": 0.0})
    assert s["tile"] == pytest.approx({"count": 2, "s": 80e-6,
                                       "self_s": 4e-6})
    assert s["k1.inputs"] == pytest.approx({"count": 2, "s": 60e-6,
                                            "self_s": 60e-6})
    # the leaves cover all of advance but the tiles' own 4 us
    assert p["advance_s"] == pytest.approx(100e-6)
    assert p["advance_leaf_s"] == pytest.approx(96e-6)
    assert [n for n, _, _ in p["leaves"]] == [
        "k1.inputs", "k1.launch", "k1.inputs", "k1.launch", "advance.sync"]
    assert p["advance"] == [(0.0, 100.0)]


def test_idle_by_span_joins_leaves_to_the_device_idle_time():
    p = program_spans.part(TIMELINE, passes=2, raw=True)
    # the device: busy [35, 45] and [75, 95] us, and [120, 130] outside
    busy = [[35.0, 45.0], [75.0, 95.0], [120.0, 130.0]]
    got = program_spans.idle_by_span(p["leaves"], p["advance"], busy,
                                     p["passes"])
    # idle inside advance: [0, 35], [45, 75], [95, 100] = 70 us
    assert got["advance_idle_ms_per_pass"] == pytest.approx(70e-3 / 2)
    by = dict(got["ms_per_pass"])
    # k1.inputs: [0, 30] + [45, 70]; k1.launch: [30, 35] + [70, 75];
    # advance.sync: [95, 100]; the tiles' own [38, 40] and [78, 80]
    # are in no leaf, and [38, 40] lies in busy
    assert by == pytest.approx({"k1.inputs": 55e-3 / 2,
                                "k1.launch": 10e-3 / 2,
                                "advance.sync": 5e-3 / 2})
    assert got["uncovered_share"] == pytest.approx(0.0)
    assert got["busy_inside_share"] == pytest.approx(30.0 / 40.0)
    assert program_spans.idle_by_span([], [], busy, 2) is None


def test_host_ms_per_pass_reads_the_first_half():
    card = {"program_spans": {
        "untraced": program_spans.part(TIMELINE, passes=2),
        "setup": program_spans.part(TIMELINE[:3], passes=0)}}
    run = {"cards": [card]}
    assert program_spans.host_ms_per_pass(run, "k1.inputs") == \
        pytest.approx(60e-3 / 2)
    assert program_spans.host_ms_per_pass(run, "k2.sort") is None
    assert program_spans.host_ms_per_pass({"cards": [{}]}, "tile") is None
    assert program_spans.host_ms_per_pass(run, "tile", "setup") is None


@pytest.mark.parametrize("name, metrics", [
    ("c5_colonnes_batch", {"k1_inputs_ms_per_pass", "renderer_init_s"}),
    ("c3_mesh_batch", {"k2_inputs_ms_per_pass", "k2_schedule_ms_per_pass",
                       "k2_sort_ms_per_pass", "renderer_init_s"})])
def test_a_tiny_traced_run_prints_its_span_metrics(tiny_root, name,
                                                   metrics):
    saved = (loop.closed_loop, trace.Tracer.after_step,
             trace.device_digest)
    res = tool.run(name, 2 ** 31 + 11, 0.2, device="cpu", root=tiny_root)
    assert (loop.closed_loop, trace.Tracer.after_step,
            trace.device_digest) == saved
    assert program_spans.take() == []
    assert res["correct"] is True
    got = res["program_spans"]
    assert set(got["metrics"]) == metrics
    assert all(v > 0 for v in got["metrics"].values())
    assert 0 < got["advance_leaf_pct"] <= 100
    assert set(got["parts"]) == {"setup", "untraced", "device"}
    for part in ("untraced", "device"):
        assert got["parts"][part]["passes"] >= 1
        assert got["parts"][part]["spans"]["advance"]["count"] >= 1
    assert "scene.compile" in got["parts"]["setup"]["spans"]
    idle = got["idle_by_span"]
    # the CPU build traces no device: all of advance is idle
    assert idle["busy_inside_share"] is None
    assert 0.0 <= idle["uncovered_share"] < 0.5
    assert list(res)[-1] == "checks"


def test_span_cost_alternates_steps_off_and_on(tiny_root):
    from portbench.tools import span_cost
    got = span_cost.measure("c5_colonnes_batch", 2 ** 31 + 13, 2,
                            device="cpu", root=tiny_root)
    assert len(got["off_s"]) == len(got["on_s"]) == 2
    assert got["spans_per_pass"] > 0
    assert got["cost_quartiles"][0] <= got["cost_median"] <= \
        got["cost_quartiles"][1]
    assert got["site_ns"]["on"] > got["site_ns"]["off"] > 0
    assert program_spans.take() == []
