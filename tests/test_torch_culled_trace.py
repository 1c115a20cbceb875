"""The culled trace kernels' plain versions (K3b
`group_best_rows_culled_plain`, K4b `mesh_best_rows_culled_plain`)
against the JAX package's Pallas kernels `group_best_rows(cbb=...)` and
`mesh_best_rows(cbb=..., sbb=...)` in interpret mode; the cull is
conservative (each equals its brute fold); the K3b branch of
`trace_soa` and of the pallas-trace route, with K5's gate lowered so
that `colonnes`' groups take it; and the compile repair (the port's
`compile_scene` of a 6,000-prim `scene_stress` bit-equal to the JAX one).

Inputs are made with numpy from fixed seeds and given to both sides.
Tolerances: the reference's 5e-4 relative between its folds
(tests/test_pallas_trace.py:72) on distances and on `a` (XLA and torch
round the same float32 formulas differently); winner rows and dircodes
equal; the trace protocol of testing/parity.py where the two sides take
different kernels (K3b here, K5 in the JAX package); the fused protocol
for the route (tests/test_bounce_kernel.py:36-45).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.models.montecarlo import raytrace as jraytrace
from montecarlo_pathtracing_tpu.ops import pallas_trace as jpt
from montecarlo_pathtracing_tpu.ops import trace as jtrace
from montecarlo_pathtracing_tpu.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.models import montecarlo as mc
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as pt
from montecarlo_pathtracing_tpu_torch.ops import trace
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    FUSED_FRAC, assert_fused_protocol, assert_trace_protocol,
    group_chunk_boxes, random_group, random_rays)
from montecarlo_pathtracing_tpu_torch.utils import transforms

CODES = [1, 2, 3, 4, 5]   # sphere, cube, cylinder, cone, oriented quad
M = 2 * pt.RAY_TILE
JAX_RTOL = 5e-4
# below the padded size of colonnes' two large groups (512 each), so that
# both take K3b instead of K5
LOW_GATE = 256

_SCENES = {}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scenes(name):
    if name not in _SCENES:
        _SCENES[name] = (jcompile(jscenes.build(name)),
                         compile_scene(scenes.build(name), device="cpu"))
    return _SCENES[name]


def _random_case(code):
    """A random 300-prim group of shape `code` with its chunk boxes, as
    (port tables, JAX tables, port cbb, JAX cbb), and 2048 random rays."""
    trf, inv, pid = random_group(transforms, code, 300, 100 * code + 300)
    tabs = pt._pad_group(torch.as_tensor(trf), torch.as_tensor(inv),
                         torch.as_tensor(pid))
    jtabs = jpt._pad_group(jnp.asarray(trf), jnp.asarray(inv),
                           jnp.asarray(pid))
    cbb = group_chunk_boxes(trf, tabs[0].shape[1])
    return (tabs, jtabs, torch.as_tensor(cbb), jnp.asarray(cbb),
            random_rays(M, code))


def _colonnes_case(gi):
    """colonnes' large group gi (1: 406 cubes, 2: 486 cylinders) with the
    scene's own chunk boxes, and 2048 random rays inside the scene."""
    jdev, dev = _scenes("colonnes")
    assert dev.group_prim[gi].shape[0] > trace.SMALL_GROUP_MAX
    tabs = pt._pad_group(dev.group_transfo[gi], dev.group_inv[gi],
                         dev.group_prim[gi])
    jtabs = jpt._pad_group(jdev.group_transfo[gi], jdev.group_inv[gi],
                           jdev.group_prim[gi])
    return (dev.group_codes[gi], tabs, jtabs, dev.group_chunk_bb[gi],
            jdev.group_chunk_bb[gi], random_rays(M, 40 + gi, -30.0, 30.0))


def _group_case(case):
    if case.startswith("colonnes"):
        return _colonnes_case(int(case[-1]))
    code = int(case[-1])
    return (code, *_random_case(code))


GROUP_CASES = [f"shape{c}" for c in CODES] + ["colonnes1", "colonnes2"]


@pytest.mark.parametrize("case", GROUP_CASES)
def test_group_best_rows_culled_plain_matches_jax(case):
    code, tabs, jtabs, cbb, jcbb, (o, d) = _group_case(case)
    assert cbb.shape == (6, tabs[0].shape[1] // pt.PRIM_CHUNK)
    np.testing.assert_array_equal(cbb.numpy(), np.asarray(jcbb))
    ref = [np.asarray(x) for x in jpt.group_best_rows(
        jnp.asarray(o), jnp.asarray(d), code, *jtabs, cbb=jcbb,
        interpret=True)]
    got = [x.numpy() for x in pt.group_best_rows(
        torch.as_tensor(o), torch.as_tensor(d), code, *tabs, cbb=cbb)]
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert (ref[1] >= 0).mean() > 0.05          # the rays hit something
    # rows may differ only at exact ties, e.g. colonnes' stacked cylinders,
    # where JAX's own brute fold differs from the port's the same way
    assert_trace_protocol(ref[:2], got[:2], f"K3b {case}", JAX_RTOL)
    same = ref[1] == got[1]
    np.testing.assert_array_equal(got[3][same], ref[3][same])
    hit = same & (ref[1] >= 0)
    np.testing.assert_allclose(got[2][hit], ref[2][hit], rtol=JAX_RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(got[0][ref[1] < 0], ref[0][ref[1] < 0])


def _mesh_case():
    """mesh_demo instance 0 (18 real chunks under 32 leaf boxes, 2 supers)
    as both packages' triangle rows and boxes, and 2048 rays in its local
    frame (random origins around it, unit directions)."""
    jdev, dev = _scenes("mesh_demo")
    off, cnt = dev.mesh_tri_offset[0], dev.mesh_tri_padded[0]
    tri = pt.pad_tris(dev.tri_va[off:off + cnt], dev.tri_vb[off:off + cnt],
                      dev.tri_vc[off:off + cnt])
    jtri = jpt.pad_tris(jdev.tri_va[off:off + cnt],
                        jdev.tri_vb[off:off + cnt],
                        jdev.tri_vc[off:off + cnt])
    return (tri, jtri, dev.mesh_chunk_bb[0], dev.mesh_super_bb[0],
            jdev.mesh_chunk_bb[0], jdev.mesh_super_bb[0],
            random_rays(M, 123, -3.0, 3.0))


@pytest.mark.parametrize("supers", [True, False])
def test_mesh_best_rows_culled_plain_matches_jax(supers):
    tri, jtri, cbb, sbb, jcbb, jsbb, (o, d) = _mesh_case()
    assert tri.shape[1] // pt.PRIM_CHUNK == 18 and cbb.shape == (6, 32)
    ref = [np.asarray(x) for x in jpt.mesh_best_rows(
        jnp.asarray(o), jnp.asarray(d), jtri, cbb=jcbb,
        sbb=jsbb if supers else None, interpret=True)]
    got = [x.numpy() for x in pt.mesh_best_rows(
        torch.as_tensor(o), torch.as_tensor(d), tri, cbb=cbb,
        sbb=sbb if supers else None)]
    assert (ref[1] >= 0).mean() > 0.03
    np.testing.assert_array_equal(got[1], ref[1])
    hit = ref[1] >= 0
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=JAX_RTOL)
    np.testing.assert_array_equal(got[0][~hit], ref[0][~hit])


@pytest.mark.parametrize("case", GROUP_CASES + ["mesh_supers", "mesh_none"])
def test_culled_plain_equals_brute_plain(case):
    """The cull is conservative: on the same rays each culled fold returns
    its brute fold's results bit for bit (tests/test_pallas_trace.py:
    138-189)."""
    if case.startswith("mesh"):
        tri, _, cbb, sbb, _, _, (o, d) = _mesh_case()
        o, d = torch.as_tensor(o), torch.as_tensor(d)
        got = pt.mesh_best_rows_culled_plain(
            o, d, tri, *((cbb, sbb) if case == "mesh_supers"
                         else pt.super_boxes(cbb)))
        ref = pt.mesh_best_rows_plain(o, d, tri)
    else:
        code, tabs, _, cbb, _, (o, d) = _group_case(case)
        o, d = torch.as_tensor(o), torch.as_tensor(d)
        got = pt.group_best_rows_culled_plain(o, d, code, *tabs, cbb)
        ref = pt.group_best_rows_plain(o, d, code, *tabs)
    assert (ref[1] >= 0).any()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def _spy(monkeypatch, name):
    """Count the calls of pallas_trace.<name>."""
    calls = []
    real = getattr(pt, name)

    def spy(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(pt, name, spy)
    return calls


def test_trace_soa_takes_k3b_past_the_gate(monkeypatch):
    """With K5's gate lowered to 256 prims, trace_soa folds colonnes' two
    large groups with K3b (a spy on its plain version sees both), and its
    hits agree with the JAX trace_soa, which takes K5 for them."""
    jdev, dev = _scenes("colonnes")
    o, d = random_rays(M, 0, -30.0, 30.0)
    ref = jtrace.trace_soa(jdev, tuple(jnp.asarray(c) for c in o),
                           tuple(jnp.asarray(c) for c in d), interpret=True)
    monkeypatch.setattr(trace, "SPARSE_GROUP_MAX", LOW_GATE)
    calls = _spy(monkeypatch, "group_best_rows_culled_plain")
    got = trace.trace_soa(dev, tuple(torch.as_tensor(c) for c in o),
                          tuple(torch.as_tensor(c) for c in d))
    assert calls == [2, 3]                       # cubes, then cylinders
    prim = np.asarray(ref.prim)
    assert (prim >= 0).mean() > 0.3
    assert_trace_protocol((np.asarray(ref.dist), prim),
                          (got.dist.numpy(), got.prim.numpy()),
                          "trace_soa through K3b", JAX_RTOL)
    same = prim == got.prim.numpy()
    for f in ("shape", "dircode"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[same],
                                      np.asarray(getattr(ref, f))[same])


ROUTE_W, ROUTE_H, ROUTE_BOUNCES = 48, 32, 3


@pytest.fixture(scope="module")
def jax_route():
    """The JAX package's pallas-trace route on colonnes at 48x32, 3
    bounces (K5 for the large groups), compiled once at XLA's lowest
    backend optimisation level (as tests/test_torch_pallas_route.py does:
    the same program up to float rounding), and its camera rays."""
    proj, view = default_rt_camera(ROUTE_W, ROUTE_H)
    o, d, tc = (np.array(a) for a in camera_rays(proj, view, ROUTE_W,
                                                 ROUTE_H))
    d, tc = d.reshape(-1, 3), tc.reshape(-1, 2)
    fn = jax.jit(functools.partial(
        jraytrace, _scenes("colonnes")[0], nb_bounces=ROUTE_BOUNCES,
        refract_ind=1.0, use_pallas=True, pallas_interpret=True,
        use_megakernel=False, use_fused=False))
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tc))
    compiled = fn.lower(*args, 0).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return (lambda p: np.asarray(compiled(*args, p))), (o, d, tc)


@pytest.mark.parametrize("pass_index", [0, 3])
def test_route_through_k3b_matches_jax(jax_route, monkeypatch, pass_index):
    """The pallas-trace route with K5's gate lowered: colonnes' groups take
    K3b in every trace (3 bounces x 2 traces, colonnes being transparent,
    x 2 groups), against the JAX route."""
    run, (o, d, tc) = jax_route
    ref = run(pass_index)
    monkeypatch.setattr(trace, "SPARSE_GROUP_MAX", LOW_GATE)
    calls = _spy(monkeypatch, "group_best_rows_culled_plain")
    got = mc.raytrace(
        _scenes("colonnes")[1], torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(tc), pass_index, nb_bounces=ROUTE_BOUNCES,
        refract_ind=1.0, use_kernels=True, use_megakernel=False,
        use_fused=False).numpy()
    assert _scenes("colonnes")[1].has_transparent
    assert len(calls) == 2 * 2 * ROUTE_BOUNCES
    assert got.shape == ref.shape == (ROUTE_W * ROUTE_H, 3)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert ref.mean() > 0.05                 # paths reach the light
    assert_fused_protocol(ref, got, f"colonnes through K3b pass {pass_index}",
                          FUSED_FRAC)


def test_compile_scene_stress_6000_bit_equal():
    """The hoisted Morton scene box changes no table: the port's
    compile_scene of scene_stress(n_prims=6000) equals the JAX one's group
    order, tables and chunk and super boxes bit for bit."""
    ref = jcompile(jscenes.scene_stress(n_prims=6000))
    got = compile_scene(scenes.scene_stress(n_prims=6000), device="cpu")
    assert list(got.group_codes) == list(ref.group_codes)
    assert max(p.shape[0] for p in got.group_prim) > 4096
    for f in ("group_prim", "group_transfo", "group_inv", "group_chunk_bb",
              "group_super_bb"):
        for g, r in zip(getattr(got, f), getattr(ref, f)):
            r = np.asarray(r)
            assert g.numpy().dtype == r.dtype, f
            np.testing.assert_array_equal(g.numpy(), r, err_msg=f)
