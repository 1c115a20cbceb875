"""Scene E with its Menger sponge at depth 2 (`menger_d2`, 8,010 prims) on
the CPU: the port's scene builder against the JAX package's `menger()`
generator, the route it takes (K2's whole-path mode over the analytic
pool), the port against the benchmark's plain reference, the spans and
the counter of whole-path launches, and key E itself unchanged.

  - `scenes.SCENES["menger_d2"]` builds, bit for bit, the prims of the
    JAX package's `scene_menger` with its `menger()` call at depth 2, and
    the benchmark's scene file `portbench/scenes/menger_d2.json` holds
    them;
  - compiled, the scene is past the megakernel's table and on the fused
    route, its 8,000 cubes one group of the analytic pool, the small
    table uncut;
  - at 16x12, 3 bounces, the dense route equals the reference bit for
    bit at passes 5 and 900, and the kernel route (K2's plain version,
    the whole path in one call) lies within the reference test's
    protocol at pass 5; the reference renders the JAX package's prims;
  - with spans on, a render records one `k2.schedule` and one
    `k2.launch` a tile call, each with `whole_path=3`, and no `k2.sort`;
    `scene.compile` carries the pool's size;
  - a pass function's memo keeps each tile's whole-path inputs (tables,
    schedule, wavefront state) across passes and hands K2 what a
    fresh build would, rebuilding on an in-place edit of the scene or
    the rays and on another IOR;
  - `k2_launch` counts whole-path launches apart from per-bounce ones;
  - key E (depth 1) builds the JAX package's 410 prims.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.models.megakernel import mega_eligible
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.utils import profiling
from portbench.harness.scenes import SHAPE_CODES, load_scene
from portbench.reference import camera, render_samples

W, H, BOUNCES, DATE = 16, 12, 3, 3.25
PASSES = (5, 900)       # the dense route's; the kernel route's is PASSES[0]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_scene_e(depth):
    """The JAX package's scene_menger (key E) with its menger() call
    `depth` levels deep: its own generator, transforms and materials."""
    T, S, RZ, M, opa = (jscenes.T, jscenes.S, jscenes.RZ, jscenes.Material,
                        jscenes.opa)
    s = jscenes.ScenePrimitives()
    s.add_oriented_quad(T(0, 0, -100) @ S(9000, 9000, 1),
                        M(jscenes.BLANC, 0.8, 0.999))
    jscenes.menger(s, T(0, 0, -50) @ RZ(15) @ S(50), depth, 0.9,
                   M(jscenes.MAGENTA))
    s.add_cylinder(T(80, 80, -75) @ S(15, 15, 25), M(jscenes.BLEU))
    s.add_cylinder(T(-80, 80, -75) @ S(15, 15, 25), M(jscenes.VERT))
    s.add_cylinder(T(-80, -80, -75) @ S(15, 15, 25), M(jscenes.ROUGE))
    s.add_cylinder(T(80, -80, -75) @ S(15, 15, 25), M(jscenes.JAUNE))
    s.add_sphere(T(80, 80, -30) @ S(20), M(jscenes.CYAN, 0.6, 0.998))
    s.add_sphere(T(-80, 80, -30) @ S(20), M(opa(jscenes.VERT, 0.1), 0.7, 0.5))
    s.add_sphere(T(-80, -80, -30) @ S(20), M(jscenes.ROUGE, 0.95, 0.97))
    s.add_sphere(T(80, -80, -30) @ S(20),
                 M(opa(jscenes.JAUNE, 0.25), 0.5, 0.999))
    s.add_sphere(T(0, 0, -50) @ S(20), M(jscenes.BLANC, 1, 1))
    return s


def _desc(s):
    """The benchmark reference's description (portbench/harness/scenes.py)
    of a scene of analytic prims."""
    return {"name": "menger_d2", "meshes": [], "prims": [
        {"shape": int(p.type), "matrix": p.transfo, "color": p.color,
         "shininess": float(p.mat[0]), "roughness": float(p.mat[1]),
         "emissivity": float(p.mat[2]), "mesh": -1} for p in s.prims]}


def _prims(s):
    return [(p.type, p.transfo, p.inv_transfo, p.color, p.mat)
            for p in s.prims]


def _same_prims(a, b):
    assert len(a.prims) == len(b.prims)
    for pa, pb in zip(_prims(a), _prims(b)):
        assert pa[0] == pb[0]
        for x, y in zip(pa[1:], pb[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture(scope="module")
def jax_d2():
    return _jax_scene_e(2)


@pytest.fixture(scope="module")
def compiled():
    """The compiled scene, and the spans its compile recorded."""
    profiling.enable_spans()
    try:
        dev = compile_scene(scenes.SCENES["menger_d2"](), device="cpu")
        return dev, profiling.take_spans()
    finally:
        profiling.enable_spans(False)
        profiling.take_spans()


@pytest.fixture(scope="module")
def dev(compiled):
    return compiled[0]


@pytest.fixture(scope="module")
def reference(jax_d2):
    """The camera's rays and the reference's radiance of every pixel in
    each of PASSES, on the JAX package's prims."""
    from montecarlo_pathtracing_tpu_torch.render.camera import camera_rays

    proj, view = camera.pose_matrices(W, H)
    ys, xs = np.divmod(np.arange(W * H), W)
    ref = render_samples(_desc(jax_d2), proj, view, W, H, xs, ys, PASSES,
                         nb_bounces=BOUNCES, ior=1.0, date=DATE,
                         device="cpu")
    return camera_rays(proj, view, W, H, device="cpu"), ref


def test_builder_is_the_jax_generators_scene(jax_d2):
    built = scenes.SCENES["menger_d2"]()
    _same_prims(built, jax_d2)
    kinds = collections.Counter(p.type for p in built.prims)
    assert len(built.prims) == 8010 and kinds[2] == 8000
    # the replica above is the JAX package's key E at depth 1
    _same_prims(_jax_scene_e(1), jscenes.SCENES["menger"]())


def test_scene_file_holds_the_builders_prims(jax_d2):
    """The benchmark's scene file against the JAX package's generator at
    depth 2 (which the test above holds the port's builder to)."""
    desc = load_scene("menger_d2", light=1.2)
    assert desc["meshes"] == [] and len(desc["prims"]) == 8010
    assert sum(p["shape"] == SHAPE_CODES["cube"]
               for p in desc["prims"]) == 8000
    for p, q in zip(desc["prims"], jax_d2.prims):
        assert p["shape"] == int(q.type) and p["mesh"] == -1
        assert np.array_equal(p["matrix"], q.transfo)
        assert np.array_equal(p["color"], q.color)
        assert (p["shininess"], p["roughness"], p["emissivity"]) == (
            float(q.mat[0]), float(q.mat[1]), float(q.mat[2]))


def test_routes_to_k2_whole_path(dev):
    assert dev.nb_prims == 8010 and not dev.mesh_prim_index
    assert not mega_eligible(dev) and bk.fused_eligible(dev)
    assert len(dev.ana_groups) == 1 and dev.ana_groups[0][0] == 2
    assert not bk.cull_small(dev)


@pytest.mark.parametrize("route", ["dense", "kernels"])
def test_port_matches_the_reference(dev, reference, route):
    from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace

    (o, d, tc), ref = reference
    # the sponge fills part of the frame: not a sky-only comparison
    assert (ref != ref[:, :1]).any(-1).float().mean() > 0.2
    passes = PASSES if route == "dense" else PASSES[:1]
    for k, pass_index in enumerate(passes):
        rgb = raytrace(dev, o, d.reshape(-1, 3), tc.reshape(-1, 2),
                       pass_index, nb_bounces=BOUNCES, refract_ind=1.0,
                       date=DATE, use_kernels=route == "kernels")
        if route == "dense":
            assert torch.equal(rgb, ref[k])
        else:
            diff = (rgb - ref[k]).abs()
            close = (diff <= 1e-3 + 1e-3 * ref[k].abs()).all(-1)
            assert close.float().mean() > 0.98
            assert abs(rgb.mean() - ref[k].mean()) < 2e-3


def test_whole_path_spans(compiled, monkeypatch):
    """The spans of a render's route; K2's plain version, which the
    comparison above runs, is stood in for by a call that ends every
    path."""
    dev, compile_spans = compiled
    monkeypatch.setattr(bk, "fused_call",
                        lambda inp, stf, sti, whole_path: sti[0].fill_(1))
    r = Renderer(dev, RenderConfig(width=W, height=H, nb_bounces=BOUNCES,
                                   tile_rays=128, passes_per_call=1,
                                   device="cpu"))
    profiling.enable_spans()
    try:
        r.advance(1)
        spans = profiling.take_spans()
    finally:
        profiling.enable_spans(False)
        profiling.take_spans()
    count = collections.Counter(s.name for s in spans)
    assert r._ntiles == 2 and count["tile"] == 2
    assert count["k2.sort"] == 0
    for name in ("k2.schedule", "k2.launch"):
        got = [s.attrs for s in spans if s.name == name]
        assert len(got) == 2, name
        assert all(a["whole_path"] == BOUNCES and "bounce" not in a
                   for a in got), got
    assert [(s.name, s.attrs) for s in compile_spans] == [
        ("scene.compile", {"prims": 8010, "ana_groups": 1,
                           "ana_chunks": 64})]


class _Recorder:
    """A stand-in K2 call that keeps what it was handed and ends every
    path with its direction as its colour."""

    def __init__(self):
        self.calls = []

    def __call__(self, inp, stf, sti, whole_path):
        self.calls.append((inp, stf.clone(), sti.clone(), whole_path))
        stf[12:15] = stf[3:6]
        sti[0].fill_(1)


def _same_call(a, b):
    (ia, fa, sa, wa), (ib, fb, sb, wb) = a, b
    assert wa == wb and torch.equal(fa, fb) and torch.equal(sa, sb)
    for name in ia._fields:
        x, y = getattr(ia, name), getattr(ib, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def test_memo_keeps_whole_path_inputs_across_passes(dev, monkeypatch):
    """A renderer's pass function builds each tile's whole-path inputs on
    its first pass and reuses them after; every call hands K2 what a
    fresh build (no memo) hands it, and so gives the same image."""
    from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace

    rec = _Recorder()
    monkeypatch.setattr(bk, "fused_call", rec)
    r = Renderer(dev, RenderConfig(width=W, height=H, nb_bounces=BOUNCES,
                                   tile_rays=128, passes_per_call=1,
                                   device="cpu"))
    profiling.enable_spans()
    try:
        r.advance(3)
        spans = profiling.take_spans()
    finally:
        profiling.enable_spans(False)
        profiling.take_spans()
    built = [s.attrs["built"] for s in spans if s.name == "k2.inputs"]
    assert built == [True, True] + [False] * 4
    assert sum(s.name == "k2.schedule" for s in spans) == 2
    assert len(r._pass.mega_memo) == r._ntiles == 2
    got = rec.calls
    rec.calls = []
    origin = r._origin
    for k, (t, (dirs, tcs)) in enumerate(
            (t, rays) for _p in range(3) for t, rays in
            enumerate(r._tile_rays)):
        raytrace(dev, origin, dirs[0], tcs[0], k // 2, nb_bounces=BOUNCES,
                 refract_ind=1.0, date=r.config.date, use_kernels=True)
    assert len(got) == len(rec.calls) == 6
    for a, b in zip(got, rec.calls):
        _same_call(a, b)


def test_memo_rebuilds_whole_path_inputs_on_a_change(dev, monkeypatch):
    """An in-place edit of a scene tensor that K2's tables read, or of the
    rays, or another IOR, rebuilds; the same objects again reuse."""
    from montecarlo_pathtracing_tpu_torch.models.megakernel import MegaMemo

    rec = _Recorder()
    memo = MegaMemo()
    proj, view = camera.pose_matrices(W, H)
    from montecarlo_pathtracing_tpu_torch.render.camera import camera_rays
    o, d, tc = camera_rays(proj, view, W, H, device="cpu")
    d, tc = d.reshape(-1, 3)[:128].clone(), tc.reshape(-1, 2)[:128].clone()
    scene = dataclasses.replace(dev, ana_chunks=dev.ana_chunks.clone())

    def call(ior=1.0):
        profiling.enable_spans()
        try:
            bk.raytrace_fused(scene, o, d, tc, 7, nb_bounces=BOUNCES,
                              refract_ind=ior, call=rec, mega_memo=memo)
            spans = profiling.take_spans()
        finally:
            profiling.enable_spans(False)
            profiling.take_spans()
        return [s.attrs["built"] for s in spans if s.name == "k2.inputs"]

    assert call() == [True] and call() == [False]
    scene.ana_chunks.mul_(1.0)
    assert call() == [True] and call() == [False]
    d.mul_(1.0)
    assert call() == [True] and call() == [False]
    assert call(ior=1.5) == [True]
    assert rec.calls[-1][0].ior == 1.5 and len(memo) == 1
    fresh = _Recorder()
    bk.raytrace_fused(scene, o, d, tc, 7, nb_bounces=BOUNCES,
                      refract_ind=1.5, call=fresh)
    _same_call(rec.calls[-1], fresh.calls[0])


def test_k2_launch_counts_whole_path_launches_apart(dev, monkeypatch):
    """k2_launch's host side with the library call stood in for: each
    launch counts in `launches`, a whole-path one also in
    `whole_path_launches`."""
    class Lib:
        def fused_call(self, *args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(bk, "_check_inputs", lambda *a: None)
    monkeypatch.setattr(bk, "_lib", lambda counts: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(bk.k2_launch, "launches", 0)
    monkeypatch.setattr(bk.k2_launch, "launches_on",
                        collections.Counter())
    monkeypatch.setattr(bk.k2_launch, "whole_path_launches", 0)
    stf = torch.zeros((15, bk.TILE))
    sti = torch.zeros((4, stf.shape[1]), dtype=torch.int64)
    inp = bk.with_schedule(bk.fused_inputs(dev, 1.0), dev, stf)
    for whole_path in (BOUNCES, 0, 0, BOUNCES, BOUNCES):
        bk.k2_launch(inp, stf, sti, whole_path)
    assert bk.k2_launch.launches == 5
    assert bk.k2_launch.whole_path_launches == 3


def test_key_e_is_unchanged():
    port_e, jax_e = scenes.SCENES["menger"](), jscenes.SCENES["menger"]()
    assert len(port_e.prims) == 410
    _same_prims(port_e, jax_e)
    _same_prims(scenes.scene_menger(depth=1), port_e)
