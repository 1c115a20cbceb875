"""The port's host spans (utils/profiling.span, enable_spans, take_spans)
on the CPU.

  - off (the default), `span` hands out one shared no-op and records
    nothing;
  - a tiny `box_diffuse` render on the megakernel route and a tiny
    `mesh_demo` render on the fused route record the span tree of a
    request: `advance` > `tile` > the route's leaves, each span's parent
    the span it ran inside, one request number per `advance`, a `tile`
    a pass and tile, a `k2.sort`, `k2.schedule` and `k2.launch` a tile
    and bounce; set-up records `scene.compile` and `renderer.init`;
  - `k1.inputs` says whether the call built K1's inputs: the first
    pass builds each tile's, later passes reuse them;
  - the image is bit for bit the same with spans on and off;
  - spans are on torch.profiler's clock: a span around a matmul lies
    within 200 us of the `aten::mm` event's bounds.
"""
import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.utils import profiling

# route: (scene, width, height, bounces, tile rays, passes); K1 renders 3
# tiles of 512 rays, K2 2 tiles of 128
RENDERS = {"K1": ("box_diffuse", 48, 32, 3, 512, 2),
           "K2": ("mesh_demo", 16, 12, 2, 128, 1)}
# the spans a tile call opens on each route
LEAVES = {"K1": {"k1.inputs", "k1.launch", "accumulate"},
          "K2": {"k2.wavefront", "k2.inputs", "k2.sort", "k2.schedule",
                 "k2.launch", "k2.gather", "accumulate"}}


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with spans off and none kept."""
    profiling.enable_spans(False)
    profiling.take_spans()
    yield
    profiling.enable_spans(False)
    profiling.take_spans()


def _render(route):
    name, w, h, bounces, tile, passes = RENDERS[route]
    dev = compile_scene(scenes.build(name), device="cpu")
    r = Renderer(dev, RenderConfig(width=w, height=h, nb_bounces=bounces,
                                   tile_rays=tile, passes_per_call=passes,
                                   device="cpu"))
    r.advance(passes)
    return r, r.image()


@pytest.fixture(scope="module")
def traced():
    """Each route's render with spans on: (renderer, image, spans)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for route in RENDERS:
            profiling.enable_spans()
            r, img = _render(route)
            out[route] = (r, img, profiling.take_spans())
    finally:
        profiling.enable_spans(False)
        profiling.take_spans()
        torch.set_num_threads(prev)
    return out


def test_spans_off_record_nothing():
    a = profiling.span("advance", passes=8)
    b = profiling.span("tile", pass_index=0, tile=3)
    assert a is b
    with a:
        with b:
            torch.ones(4).sum()
    assert profiling.take_spans() == []


@pytest.mark.parametrize("route", list(RENDERS))
def test_a_render_records_the_span_tree(traced, route):
    r, _, spans = traced[route]
    name, _, _, bounces, _, passes = RENDERS[route]
    names = [s.name for s in spans]
    assert names[:2] == ["scene.compile", "renderer.init"]
    count = collections.Counter(names)
    assert count["advance"] == 1 and count["resolve"] == 1
    tiles = passes * r._ntiles
    assert r._ntiles > 1 and count["tile"] == tiles
    for s in spans:
        assert s.start <= s.end
        if s.parent < 0:
            assert s.name in ("scene.compile", "renderer.init", "advance",
                              "resolve")
            continue
        up = spans[s.parent]
        # a span lies inside its parent, and shares its request
        assert up.start <= s.start and s.end <= up.end
        assert s.request == up.request
        want = {"tile": "advance", "advance.sync": "advance"}.get(
            s.name, "tile")
        assert up.name == want, (s, up)
    # one request a root span
    roots = [s for s in spans if s.parent < 0]
    assert len({s.request for s in roots}) == len(roots)
    assert {s.name for s in spans if s.name not in (
        "scene.compile", "renderer.init", "advance", "resolve",
        "tile")} == LEAVES[route]
    assert sorted((s.attrs["pass_index"], s.attrs["tile"]) for s in spans
                  if s.name == "tile") == [
        (p, t) for p in range(passes) for t in range(r._ntiles)]
    if route == "K1":
        assert count["k1.inputs"] == count["k1.launch"] == tiles
    else:
        for leaf in ("k2.sort", "k2.schedule", "k2.launch"):
            assert count[leaf] == tiles * bounces
            assert sorted(s.attrs["bounce"] for s in spans
                          if s.name == leaf) == sorted(
                list(range(bounces)) * tiles)
        for leaf in ("k2.wavefront", "k2.inputs", "k2.gather"):
            assert count[leaf] == tiles
    assert count["accumulate"] == tiles


def test_k1_inputs_span_says_whether_built(traced):
    """The renderer's first pass builds each tile's K1 inputs; its later
    passes reuse them (models/megakernel.MegaMemo)."""
    r, _, spans = traced["K1"]
    built = [s.attrs["built"] for s in spans if s.name == "k1.inputs"]
    assert built == [True] * r._ntiles + [False] * r._ntiles


@pytest.mark.parametrize("route", list(RENDERS))
def test_spans_leave_the_image_unchanged(traced, route):
    _, img_on, _ = traced[route]
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, img_off = _render(route)
    finally:
        torch.set_num_threads(prev)
    assert profiling.take_spans() == []
    np.testing.assert_array_equal(img_on, img_off)
    assert img_on.max() > 0


def test_spans_are_on_the_profiler_clock():
    a = torch.randn(128, 128)
    profiling.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            torch.mm(a, a)
    (s,) = profiling.take_spans()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert abs(s.start - mm[0].start_ns()) < 200_000
    assert abs(s.end - mm[0].end_ns()) < 200_000
    assert abs(s.start - time.time_ns()) < 10 ** 9


def test_take_clears_and_requests_count_on():
    profiling.enable_spans()
    with profiling.span("advance"):
        with profiling.span("tile", tile=0):
            pass
    first = profiling.take_spans()
    with profiling.span("advance"):
        pass
    second = profiling.take_spans()
    assert [s.name for s in first] == ["advance", "tile"]
    assert [s.parent for s in first] == [-1, 0]
    assert first[1].attrs == {"tile": 0}
    assert [s.name for s in second] == ["advance"]
    assert second[0].request == first[0].request + 1
    assert profiling.take_spans() == []


def test_a_span_open_across_a_take():
    profiling.enable_spans()
    with profiling.span("advance"):
        with profiling.span("tile", tile=0):
            pass
        first = profiling.take_spans()
        with profiling.span("tile", tile=1):
            pass
    second = profiling.take_spans()
    assert [(s.name, s.end is None) for s in first] == [
        ("advance", True), ("tile", False)]
    assert [(s.name, s.parent) for s in second] == [("tile", -1)]
    assert second[0].request == first[0].request
