"""The port's scene-level trace (`ops/trace.trace_soa`, with the trace
kernels' plain versions on CPU tensors), shading (`intersection_info_soa`)
and sampling (`random_ray_soa`, `schlick_soa`) and the vec3 helpers
against the JAX package's, on the same numpy inputs.

Tolerances. Traces: the trace protocol of testing/parity.py on (dist,
prim), with distances within the reference's 5e-4 relative between
frameworks (tests/test_pallas_trace.py:72; XLA and torch round the shape
tests differently); every other HitS field equal where the winners are
equal, and the hit points within 1e-4 relative + 1e-3 absolute (world
coordinates of O(100) with float32 rounding in the local frames). Shading
and sampling: the same float32 formulas, within 1e-5; RNG counters
bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import sampling as jsampling
from montecarlo_pathtracing_tpu.ops import shading as jshading
from montecarlo_pathtracing_tpu.ops import trace as jtrace
from montecarlo_pathtracing_tpu.ops import vec as jvec
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.ops import sampling, shading, vec
from montecarlo_pathtracing_tpu_torch.ops import trace
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_trace_protocol, random_rays)

M = 2048
JAX_RTOL = 5e-4
FIELDS = ("dist", "prim", "shape", "dircode", "tri")

_SCENES = {}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scenes(name, flat_face=False):
    key = (name, flat_face)
    if key not in _SCENES:
        _SCENES[key] = (jcompile(jscenes.build(name), flat_face=flat_face),
                        compile_scene(scenes.build(name), flat_face=flat_face,
                                      device="cpu"))
    return _SCENES[key]


def _vec_np(x):
    return tuple(np.array(c) for c in x)


def _hit_np(h):
    """A HitS of either package as numpy."""
    return h._replace(**{f: np.array(getattr(h, f)) for f in FIELDS},
                      pl=_vec_np(h.pl), pg=_vec_np(h.pg))


def _traces(name, cull, seed=0, flat_face=False):
    jdev, dev = _scenes(name, flat_face)
    o, d = random_rays(M, seed, -30.0, 30.0)
    ref = jtrace.trace_soa(jdev, tuple(jnp.asarray(c) for c in o),
                           tuple(jnp.asarray(c) for c in d), interpret=True,
                           cull_chunks=cull)
    got = trace.trace_soa(dev, tuple(torch.as_tensor(c) for c in o),
                          tuple(torch.as_tensor(c) for c in d),
                          cull_chunks=cull)
    return _hit_np(ref), got


@pytest.mark.parametrize("name,cull", [("colonnes", None), ("colonnes", False),
                                       ("mesh_demo", None),
                                       ("mesh_demo", False)])
def test_trace_soa_matches_jax(name, cull):
    ref, got = _traces(name, cull)
    g = _hit_np(got)
    for f in FIELDS:
        assert getattr(g, f).dtype == getattr(ref, f).dtype, f
    assert (ref.shape >= 0).mean() > 0.3
    assert_trace_protocol((ref.dist, ref.prim), (g.dist, g.prim),
                          f"trace_soa {name} cull={cull}", JAX_RTOL)
    same = ref.prim == g.prim
    for f in ("shape", "dircode", "tri"):
        np.testing.assert_array_equal(getattr(g, f)[same],
                                      getattr(ref, f)[same], err_msg=f)
    hit = same & (ref.shape >= 0)
    for f in ("pl", "pg"):
        for c in range(3):
            np.testing.assert_allclose(getattr(g, f)[c][hit],
                                       getattr(ref, f)[c][hit], rtol=1e-4,
                                       atol=1e-3, err_msg=f"{f}[{c}]")
    np.testing.assert_array_equal(g.dist[~hit & same], ref.dist[~hit & same])


def _as_port_hit(ref):
    """A JAX HitS (numpy) as the port's, so both shade the same hits."""
    return trace.HitS(*(torch.as_tensor(getattr(ref, f)) for f in FIELDS),
                      tuple(torch.as_tensor(c) for c in ref.pl),
                      tuple(torch.as_tensor(c) for c in ref.pg))


@pytest.mark.parametrize("name,flat", [("materials", False),
                                       ("mesh_demo", False),
                                       ("mesh_demo", True)])
def test_intersection_info_soa_matches_jax(name, flat):
    """Every shape code's normal (materials has all five), mesh normals
    smooth and flat, and the previous (N, P) kept on a miss."""
    jdev, dev = _scenes(name, flat)
    ref_hit, _ = _traces(name, False, seed=5, flat_face=flat)
    jhit = jtrace.HitS(*(jnp.asarray(getattr(ref_hit, f)) for f in FIELDS),
                       tuple(jnp.asarray(c) for c in ref_hit.pl),
                       tuple(jnp.asarray(c) for c in ref_hit.pg))
    prev = random_rays(M, 9)
    ref = jshading.intersection_info_soa(
        jdev, jhit, prev=tuple(tuple(jnp.asarray(c) for c in v)
                               for v in prev))
    got = shading.intersection_info_soa(
        dev, _as_port_hit(ref_hit),
        prev=tuple(tuple(torch.as_tensor(c) for c in v) for v in prev))
    codes = set(np.unique(ref_hit.shape).tolist())
    assert -1 in codes and len(codes) >= 3
    for r, g in zip(ref, got):
        for c in range(3):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(r[c]),
                                       rtol=1e-5, atol=1e-5)
    miss = ref_hit.shape < 0
    np.testing.assert_array_equal(got[0][0].numpy()[miss], prev[0][0][miss])


def _states(n, seed):
    g = np.random.RandomState(seed)
    return tuple(g.randint(0, 2 ** 32, size=n, dtype=np.uint64)
                 .astype(np.uint32) for _ in range(3))


def test_random_ray_and_schlick_match_jax():
    g = np.random.RandomState(4)
    n = 4096
    st = _states(n, 1)
    d = random_rays(n, 2)[1]
    rough = g.uniform(0.0, 1.0, n).astype(np.float32)
    mask = g.uniform(size=n) < 0.7
    ref_ray, ref_st = jsampling.random_ray_soa(
        tuple(jnp.asarray(s) for s in st), tuple(jnp.asarray(c) for c in d),
        jnp.asarray(rough), jnp.asarray(mask))
    got_ray, got_st = sampling.random_ray_soa(
        tuple(torch.as_tensor(s.astype(np.int64)) for s in st),
        tuple(torch.as_tensor(c) for c in d), torch.as_tensor(rough),
        torch.as_tensor(mask))
    for r, s in zip(ref_st, got_st):
        np.testing.assert_array_equal(s.numpy(), np.asarray(r).astype(np.int64))
    for r, c in zip(ref_ray, got_ray):
        np.testing.assert_allclose(c.numpy(), np.asarray(r), atol=1e-5)
    n_ = random_rays(n, 3)[1]
    for ior in (1.0, 1.3, 2.5):
        ref = jsampling.schlick_soa(tuple(jnp.asarray(c) for c in d),
                                    tuple(jnp.asarray(c) for c in n_),
                                    jnp.float32(ior))
        got = sampling.schlick_soa(tuple(torch.as_tensor(c) for c in d),
                                   tuple(torch.as_tensor(c) for c in n_),
                                   torch.tensor(ior, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_vec_helpers_match_jax():
    """refract_glsl (with TIR lanes), reflect, mix, normalize with eps and
    the affine row transforms."""
    a_np, b_np = random_rays(512, 6)
    b_np = b_np * np.float32(3.0)
    a_np[:, :8] = 0.0                            # zero vectors: the eps
    k = np.random.RandomState(8).uniform(size=512).astype(np.float32)
    rows = np.random.RandomState(9).normal(size=(12, 512)).astype(np.float32)
    ja, jb = (tuple(jnp.asarray(c) for c in x) for x in (a_np, b_np))
    ta, tb = (tuple(torch.as_tensor(c) for c in x) for x in (a_np, b_np))
    jn, tn = jvec.normalize(jb), vec.normalize(tb)
    pairs = [
        (jvec.refract_glsl(jn, jvec.normalize(ja, eps=1e-30), 1.0 / 1.5),
         vec.refract_glsl(tn, vec.normalize(ta, eps=1e-30), 1.0 / 1.5)),
        (jvec.refract_glsl(jn, jvec.normalize(ja, eps=1e-30), 1.5),
         vec.refract_glsl(tn, vec.normalize(ta, eps=1e-30), 1.5)),
        (jvec.reflect(jn, ja), vec.reflect(tn, ta)),
        (jvec.mix(ja, jb, jnp.asarray(k)), vec.mix(ta, tb, torch.as_tensor(k))),
        (jvec.normalize(ja, eps=1e-30), vec.normalize(ta, eps=1e-30)),
        (jvec.apply_affine(jnp.asarray(rows), ja),
         vec.apply_affine(torch.as_tensor(rows), ta)),
        (jvec.apply_linear(jnp.asarray(rows), jb),
         vec.apply_linear(torch.as_tensor(rows), tb)),
    ]
    for ref, got in pairs:
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)
    tir = vec.refract_glsl(tn, vec.normalize(ta, eps=1e-30), 1.5)
    assert bool((tir[0] == 0).any())            # some lanes reflect totally
    m = np.random.RandomState(10).normal(size=(5, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(vec.affine_rows(torch.as_tensor(m)).numpy(),
                                  np.asarray(jvec.affine_rows(jnp.asarray(m))))
