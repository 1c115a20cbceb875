"""The port's dense route pieces against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds (and the reference camera)
and given to both packages. What is held, and how closely:

  - the AoS RNG (`xxhash32`, `srand`, `uniform*`): bit for bit against
    JAX and against the port's SoA forms;
  - the AoS samplers: RNG counters bit for bit against JAX, directions
    bit for bit against the port's SoA forms, and within SAMPLE_ATOL of
    JAX's (the two packages' libm log, cos and sin differ by an ulp,
    measured up to 4.4e-6 after the ONB);
  - the device transforms and every shape test: within 1e-6 relative to
    the size of the terms a value sums (TERM_RTOL); a plain relative
    bound is meaningless where the terms cancel (a triangle's `a`, a
    transform of a random point), and XLA sums those terms in another
    order or with FMA. The hit masks and face codes are equal;
  - `trace` on five scenes and an all-shapes one: the same prim, shape,
    dircode and tri, rows differing only at distance ties (equal to
    TIE_RTOL);
    distances within rtol 5e-4, atol 1e-3 (tests/test_pallas_trace.py:72),
    and the world hit points as closely as their distance;
  - `trace(use_kernels=True)` (the plain K3a and K4a on CPU tensors)
    against the JAX `trace(use_pallas=True, pallas_interpret=True)`;
  - `intersection_info`: normals within NORMAL_ATOL of JAX's, or no
    farther from the float64 normal than JAX's (the point differencing
    cancels world-sized terms); hit points bit for bit; prev_n/prev_p
    kept bit for bit on misses;
  - `bundle_box_votes` and `build_worklist`: bit for bit;
  - the gradient of the summed hit distance and shading normal with
    respect to the ray origins, on camera rays (with misses) and rays
    grazing each sphere: finite, and within GRAD_RTOL of jax.grad per
    ray. The JAX side reads the hit distance as |O - hit.pg|, the same
    function on hit lanes: the reference's `hit.dist` itself has no
    finite gradient (its norm's backward meets an invalid candidate's
    overflowed hit point, 0 * inf), which the port's `_safe_dist` guard
    removes without changing a forward value.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import intersect as jint
from montecarlo_pathtracing_tpu.ops import rng as jrng
from montecarlo_pathtracing_tpu.ops import sampling as jsam
from montecarlo_pathtracing_tpu.ops import shading as jsh
from montecarlo_pathtracing_tpu.ops import trace as jtrace
from montecarlo_pathtracing_tpu.ops import worklist as jwl
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import scene as jscene_mod
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu.utils import transforms as jtf
from montecarlo_pathtracing_tpu_torch.ops import intersect as pint
from montecarlo_pathtracing_tpu_torch.ops import rng
from montecarlo_pathtracing_tpu_torch.ops import sampling as sam
from montecarlo_pathtracing_tpu_torch.ops import shading as psh
from montecarlo_pathtracing_tpu_torch.ops import trace as ptrace
from montecarlo_pathtracing_tpu_torch.ops import worklist as pwl
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import all_shapes_scene
from montecarlo_pathtracing_tpu_torch.utils import transforms as tf

N = 4096
SAMPLE_ATOL = 1e-5
TERM_RTOL = 1e-6
DIST_RTOL, DIST_ATOL = 5e-4, 1e-3
TIE_RTOL = 1e-6
GRAD_RTOL = 1e-4
NORMAL_ATOL = 1e-5
SCENES = ["box_diffuse", "box_balls", "colonnes", "mesh_demo", "materials",
          "all_shapes"]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _scenes(name, flat_face=False):
    """(JAX device scene, port device scene) of one scene."""
    if name == "all_shapes":
        jprims = all_shapes_scene(jscene_mod, jtf)
        prims = all_shapes_scene(scene_mod, tf)
    else:
        jprims, prims = jscenes.build(name), scenes.build(name)
    return (jcompile(jprims, flat_face=flat_face),
            compile_scene(prims, flat_face=flat_face, device="cpu"))


def _rays(name, w=24, h=18, n_random=256, seed=0):
    """Camera rays of the reference camera and random rays inside the
    scene's box, as numpy (O [N,3], D [N,3] unit)."""
    _, dev = _scenes(name)
    proj, view = default_rt_camera(w, h)
    o, d, _ = jcamera_rays(proj, view, w, h)
    d = np.asarray(d).reshape(-1, 3)
    g = np.random.default_rng(seed)
    lo = dev.prim_bb_min.amin(dim=0).numpy()
    hi = dev.prim_bb_max.amax(dim=0).numpy()
    ro = (lo + g.random((n_random, 3)) * (hi - lo)).astype(np.float32)
    rd = g.normal(size=(n_random, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    O = np.concatenate([np.broadcast_to(np.asarray(o), d.shape), ro])
    return O.astype(np.float32), np.concatenate([d, rd]).astype(np.float32)


def _t(a):
    """A torch copy of a numpy or JAX array."""
    return torch.tensor(np.asarray(a))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x.astype(np.int64)


def _assert_terms(ref, got, scale, what, rtol=TERM_RTOL):
    """|ref - got| <= rtol * scale elementwise; scale is the size of the
    terms the value sums (>= |ref|)."""
    err = np.abs(np.asarray(ref, np.float64) - np.asarray(got, np.float64))
    worst = float((err / np.maximum(scale, 1e-30)).max())
    assert worst <= rtol, f"{what}: error {worst:.3g} of the terms' size"


# ---------------------------------------------------------------------------
# RNG and samplers
# ---------------------------------------------------------------------------

def _states(g, n=N):
    return g.integers(0, 1 << 32, (n, 3), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_aos_rng_bit_equal(seed):
    g = np.random.default_rng(seed)
    tc = g.random((N, 2), dtype=np.float32)
    pass_index = int(g.integers(0, 1 << 20))
    date = float(np.float32(g.normal() * 100))
    ref = jrng.srand(jnp.asarray(tc), jnp.int32(pass_index), date)
    got = rng.srand(_t(tc), pass_index, date)
    assert got.dtype == torch.int64 and tuple(got.shape) == (N, 3)
    np.testing.assert_array_equal(got.numpy(), _bits(ref))
    soa = rng.srand_soa(_t(tc[:, 0]), _t(tc[:, 1]), pass_index, date)
    np.testing.assert_array_equal(got.numpy(),
                                  torch.stack(soa, dim=-1).numpy())

    st = _states(g)
    jst, tst = jnp.asarray(st), _t(st.astype(np.int64))
    np.testing.assert_array_equal(rng.xxhash32(tst).numpy(),
                                  _bits(jrng.xxhash32(jst)))
    for k in range(4):
        mask = g.random(N) < 0.6
        jf, jst = jrng.uniform_masked(jst, jnp.asarray(mask))
        tf_, tst = rng.uniform_masked(tst, _t(mask))
        np.testing.assert_array_equal(_bits(tf_.numpy()), _bits(jf))
        np.testing.assert_array_equal(tst.numpy(), _bits(jst))
    jv, jst2 = jrng.uniform3(jst)
    tv, tst2 = rng.uniform3(tst)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(tst2.numpy(), _bits(jst2))
    jv, jst2 = jrng.uniform2(jst)
    tv, tst2 = rng.uniform2(tst)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(tst2.numpy(), _bits(jst2))
    f, new = rng.uniform(tst)
    fs, news = rng.uniform_soa(tuple(tst[:, k] for k in range(3)))
    np.testing.assert_array_equal(_bits(f.numpy()), _bits(fs.numpy()))
    np.testing.assert_array_equal(new.numpy(),
                                  torch.stack(news, dim=-1).numpy())


def _sampler_inputs(seed):
    g = np.random.default_rng(10 + seed)
    st = _states(g)
    d = g.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rough = g.random(N, dtype=np.float32)
    mask = g.random(N) < 0.6
    return st, d, rough, mask


SAMPLERS = {
    "sample_hemisphere": lambda m, st, d, r, k: m.sample_hemisphere(st, r),
    "random_ray": lambda m, st, d, r, k: m.random_ray(st, d, r),
    "sample_hemisphere_masked":
        lambda m, st, d, r, k: m.sample_hemisphere_masked(st, r, k),
    "random_ray_masked": lambda m, st, d, r, k: m.random_ray_masked(st, d, r,
                                                                    k),
    "random_ray_wrong": lambda m, st, d, r, k: m.random_ray_wrong(st, d),
    "random_ray_wrong2": lambda m, st, d, r, k: m.random_ray_wrong(st, d,
                                                                   which=2),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_aos_samplers(name):
    st, d, rough, mask = _sampler_inputs(len(name))
    jdir, jst = SAMPLERS[name](jsam, jnp.asarray(st), jnp.asarray(d),
                               jnp.asarray(rough), jnp.asarray(mask))
    tdir, tst = SAMPLERS[name](sam, _t(st.astype(np.int64)), _t(d),
                               _t(rough), _t(mask))
    np.testing.assert_array_equal(tst.numpy(), _bits(jst))
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir), rtol=0,
                               atol=SAMPLE_ATOL)
    if name == "random_ray_masked":
        sdir, sst = sam.random_ray_soa(
            tuple(_t(st[:, k].astype(np.int64)) for k in range(3)),
            tuple(_t(d[:, k]) for k in range(3)), _t(rough), _t(mask))
        np.testing.assert_array_equal(_bits(tdir.numpy()),
                                      _bits(torch.stack(sdir, -1).numpy()))
        np.testing.assert_array_equal(tst.numpy(),
                                      torch.stack(sst, -1).numpy())


def test_orient_frame_and_schlick():
    st, d, rough, _ = _sampler_inputs(7)
    n = np.roll(d, 1, axis=0)
    np.testing.assert_allclose(sam.orient_frame(_t(d)).numpy(),
                               np.asarray(jsam.orient_frame(jnp.asarray(d))),
                               rtol=0, atol=1e-6)
    for ior in (1.0, 1.3, 2.4):
        np.testing.assert_allclose(
            sam.schlick(_t(d), _t(n), ior).numpy(),
            np.asarray(jsam.schlick(jnp.asarray(d), jnp.asarray(n), ior)),
            rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            _bits(sam.schlick(_t(d), _t(n), ior).numpy()),
            _bits(sam.schlick_soa(tuple(_t(d[:, k]) for k in range(3)),
                                  tuple(_t(n[:, k]) for k in range(3)),
                                  ior).numpy()))


# ---------------------------------------------------------------------------
# Device transforms and shape tests
# ---------------------------------------------------------------------------

def test_device_transforms():
    g = np.random.default_rng(3)
    a = g.normal(size=(N, 3)).astype(np.float32)
    b = g.normal(size=(N, 3)).astype(np.float32)
    k = g.random((N, 1), dtype=np.float32)
    i = a / np.linalg.norm(a, axis=1, keepdims=True)
    n = b / np.linalg.norm(b, axis=1, keepdims=True)
    m = g.normal(size=(N, 4, 4)).astype(np.float32)
    ja, jb, ji, jn = (jnp.asarray(x) for x in (a, b, i, n))
    ta, tb, ti, tn = (_t(x) for x in (a, b, i, n))
    np.testing.assert_array_equal(tf.mix(ta, tb, _t(k)).numpy(),
                                  np.asarray(jtf.mix(ja, jb, jnp.asarray(k))))
    _assert_terms(jtf.dot3(ja, jb), tf.dot3(ta, tb).numpy(),
                  np.abs(a * b).sum(1), "dot3")
    _assert_terms(jtf.normalize(ja), tf.normalize(ta).numpy(),
                  np.abs(i), "normalize")
    _assert_terms(jtf.reflect(ji, jn), tf.reflect(ti, tn).numpy(),
                  np.abs(i) + 2 * np.abs(n), "reflect")
    for eta in (1.5, 1 / 1.5):
        got = tf.refract_glsl(ti, tn, eta).numpy()
        ref = np.asarray(jtf.refract_glsl(ji, jn, eta))
        ndi = (i * n).sum(1, keepdims=True)
        c = eta * np.abs(ndi) + 1.0
        _assert_terms(ref, got, eta * np.abs(i) + c * np.abs(n),
                      f"refract_glsl {eta}")
        tir = 1.0 - eta * eta * (1.0 - ndi * ndi) < 0.0
        assert (got[tir[:, 0]] == 0.0).all()
    for mm, what in ((m, "per-ray"), (m[0], "one matrix")):
        scale = np.abs(mm[..., :3, :3] * a[..., None, :]).sum(-1)
        _assert_terms(jtf.transform_dir(jnp.asarray(mm), ja),
                      tf.transform_dir(_t(mm), ta).numpy(), scale,
                      f"transform_dir {what}")
        _assert_terms(jtf.transform_point(jnp.asarray(mm), ja),
                      tf.transform_point(_t(mm), ta).numpy(),
                      scale + np.abs(mm[..., :3, 3]),
                      f"transform_point {what}")


def _local_rays(seed, n=N):
    g = np.random.default_rng(seed)
    O = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    D = g.normal(size=(n, 3)).astype(np.float32)
    return O, D / np.linalg.norm(D, axis=1, keepdims=True)


@pytest.mark.parametrize("code", [1, 2, 3, 4, 5])
def test_shape_local(code):
    O, D = _local_rays(20 + code)
    ja, jv, jc = jint.SHAPE_FNS[code](jnp.asarray(O), jnp.asarray(D))
    ta, tv, tc = pint.SHAPE_FNS[code](_t(O), _t(D))
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert 0.02 < jv.mean() < 0.5          # the rays hit and miss
    np.testing.assert_array_equal(tc.numpy()[jv], np.asarray(jc)[jv])
    ja = np.asarray(ja)
    assert (ta.numpy()[~jv] == pint.FLT_MAX).all()
    _assert_terms(ja[jv], ta.numpy()[jv], np.abs(ja[jv]), f"shape {code} a")


def test_triangle_batch():
    O, D = _local_rays(31)
    g = np.random.default_rng(32)
    va, vb, vc = (g.uniform(-2, 2, (64, 3)).astype(np.float32)
                  for _ in range(3))
    ja, jv = jint.triangle_batch(*(jnp.asarray(x) for x in (O, D, va, vb,
                                                            vc)))
    ta, tv = pint.triangle_batch(*(_t(x) for x in (O, D, va, vb, vc)))
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.any() and not jv.all()
    # a = dot(edge2, q) / det sums products that cancel: its terms' size
    e1, e2 = vb - va, vc - va
    h = np.cross(D[:, None, :], e2[None])
    det = (e1[None] * h).sum(-1)
    q = np.cross(O[:, None, :] - va[None], e1[None])
    scale = np.abs(e2[None] * q).sum(-1) / np.abs(det)
    ja = np.asarray(ja)
    _assert_terms(ja[jv], ta.numpy()[jv], (np.abs(ja) + scale)[jv],
                  "triangle a")


# ---------------------------------------------------------------------------
# The scene trace
# ---------------------------------------------------------------------------

def _check_hits(jh, th, what):
    """Same winners (rows may differ only at exact distance ties) and
    distances within DIST_RTOL/DIST_ATOL."""
    jd, td = np.asarray(jh.dist, np.float64), th.dist.numpy().astype(
        np.float64)
    jhit = np.asarray(jh.shape) >= 0
    np.testing.assert_array_equal(th.shape.numpy() >= 0, jhit,
                                  err_msg=f"{what}: hit masks")
    diff = np.zeros(jhit.shape, bool)
    for f in ("prim", "shape", "dircode", "tri"):
        diff |= getattr(th, f).numpy() != np.asarray(getattr(jh, f))
    tie = np.abs(jd - td) <= TIE_RTOL * np.abs(jd)
    assert (tie[diff]).all(), f"{what}: {int(diff.sum())} winners differ"
    assert diff.mean() < 0.005, f"{what}: {int(diff.sum())} ties"
    np.testing.assert_allclose(td[jhit], jd[jhit], rtol=DIST_RTOL,
                               atol=DIST_ATOL, err_msg=f"{what}: dist")
    assert (td[~jhit] == pint.FLT_MAX).all()
    # world hit points as closely as the distances along the ray
    same = jhit & ~diff
    err = np.abs(th.pg.numpy()[same] - np.asarray(jh.pg)[same]).max(axis=1)
    assert (err <= DIST_RTOL * jd[same] + DIST_ATOL).all(), f"{what}: pg"


@pytest.mark.parametrize("name", SCENES)
def test_trace_matches_jax(name):
    jdev, dev = _scenes(name)
    O, D = _rays(name)
    jh = jtrace.trace(jdev, jnp.asarray(O), jnp.asarray(D))
    th = ptrace.trace(dev, _t(O), _t(D))
    assert th.dist.dtype == torch.float32 and th.prim.dtype == torch.int32
    _check_hits(jh, th, name)
    np.testing.assert_array_equal(
        ptrace.hit_any(dev, _t(O), _t(D)).numpy(), np.asarray(jh.shape) >= 0)


# groups of at least 128 padded prims (K3a) and mesh instances (K4a) per
# scene: the gate of ops/trace.trace with use_kernels
KERNEL_UNITS = {"box_diffuse": (0, 0), "box_balls": (0, 0),
                "colonnes": (2, 0), "mesh_demo": (0, 3), "materials": (1, 0)}


@pytest.mark.parametrize("name", sorted(KERNEL_UNITS))
def test_trace_kernel_gate(name, monkeypatch):
    """use_kernels sends a group to K3a only from 128 prims and every
    mesh instance to K4a, through the ops/trace module's wrappers (the
    plain versions on CPU tensors); the winners are the dense fold's."""
    _, dev = _scenes(name)
    O, D = _rays(name, 12, 9, n_random=64)
    calls = {"K3a": 0, "K4a": 0}

    def counting(kid, fn):
        def wrapped(*args, **kw):
            calls[kid] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ptrace, "group_best_rows",
                        counting("K3a", ptrace.group_best_rows))
    monkeypatch.setattr(ptrace, "mesh_best_rows",
                        counting("K4a", ptrace.mesh_best_rows))
    dense = ptrace.trace(dev, _t(O), _t(D))
    assert calls == {"K3a": 0, "K4a": 0}
    kern = ptrace.trace(dev, _t(O), _t(D), use_kernels=True)
    assert (calls["K3a"], calls["K4a"]) == KERNEL_UNITS[name]
    for f in ("prim", "shape", "dircode", "tri"):
        np.testing.assert_array_equal(getattr(kern, f).numpy(),
                                      getattr(dense, f).numpy())
    np.testing.assert_allclose(kern.dist.numpy(), dense.dist.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["colonnes", "mesh_demo"])
def test_trace_kernels_match_jax_pallas(name):
    jdev, dev = _scenes(name)
    O, D = _rays(name)
    jh = jtrace.trace(jdev, jnp.asarray(O), jnp.asarray(D), use_pallas=True,
                      pallas_interpret=True)
    th = ptrace.trace(dev, _t(O), _t(D), use_kernels=True)
    _check_hits(jh, th, f"{name} with kernels")


def _normals_f64(dev, hit):
    """intersection_info of the port evaluated in float64 (scene tables
    and hit points widened): the exact normals the f32 ones round."""
    wide = {k: getattr(dev, k).double() for k in (
        "transfo", "mesh_transfo", "tri_va", "tri_vb", "tri_vc", "tri_na",
        "tri_nb", "tri_nc")}
    n, _ = psh.intersection_info(
        dataclasses.replace(dev, **wide),
        hit._replace(pl=hit.pl.double(), pg=hit.pg.double()))
    return n.numpy()


def _assert_normals(ref, got, exact, what):
    """Shading normals within NORMAL_ATOL of the reference's, or no
    farther from the float64 normal than the reference's: the point
    differencing N = normalize(T(pl + No) - Pg) cancels world-sized
    terms (up to 2.6e-4 apart on colonnes' small prims far from the
    origin), and both f32 results carry that rounding."""
    err = np.linalg.norm(got - ref, axis=-1)
    own = np.linalg.norm(got - exact, axis=-1)
    theirs = np.linalg.norm(ref - exact, axis=-1)
    bad = (err > NORMAL_ATOL) & (own > 2 * theirs + NORMAL_ATOL)
    assert not bad.any(), f"{what}: {int(bad.sum())} normals off"


@pytest.mark.parametrize("name,flat", [("all_shapes", False),
                                       ("colonnes", False),
                                       ("mesh_demo", False),
                                       ("mesh_demo", True)])
def test_intersection_info(name, flat):
    jdev, dev = _scenes(name, flat)
    O, D = _rays(name)
    jh = jtrace.trace(jdev, jnp.asarray(O), jnp.asarray(D))
    hit = np.asarray(jh.shape) >= 0
    assert 0.3 < hit.mean() < 1
    g = np.random.default_rng(40)
    prev_n = g.normal(size=O.shape).astype(np.float32)
    prev_p = g.normal(size=O.shape).astype(np.float32)
    # the JAX hit record in both, so that only intersection_info differs
    jhit_t = pint.Hit(*(_t(np.asarray(x)) for x in jh))
    n64 = _normals_f64(dev, jhit_t)
    for prev in (None, (prev_n, prev_p)):
        jp = (None, None) if prev is None else tuple(jnp.asarray(x)
                                                     for x in prev)
        tp = (None, None) if prev is None else tuple(_t(x) for x in prev)
        jn, jpos = jsh.intersection_info(jdev, jh, *jp)
        tn, tpos = psh.intersection_info(dev, jhit_t, *tp)
        jn, jpos = np.asarray(jn), np.asarray(jpos)
        _assert_normals(jn[hit], tn.numpy()[hit], n64[hit], f"{name} N")
        np.testing.assert_array_equal(tpos.numpy(), jpos)
        miss = np.asarray(jh.shape) < 0
        want = (np.zeros_like(prev_n) if prev is None else prev_n)[miss]
        np.testing.assert_array_equal(tn.numpy()[miss], want)
    if name == "all_shapes":
        # the cone's top "cap" quirk: N = 0 on face code 1
        cone_top = (np.asarray(jh.shape) == pint.CODE_CONE) & (
            np.asarray(jh.dircode) == 1)
        assert (tn.numpy()[cone_top] == 0).all()


# ---------------------------------------------------------------------------
# Worklist helpers
# ---------------------------------------------------------------------------

def test_bundle_box_votes_and_worklist_bit_equal():
    g = np.random.default_rng(50)
    m, tile, s = 2048, 128, 40
    o = g.uniform(-10, 10, (3, m)).astype(np.float32)
    d = g.normal(size=(3, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d[0, :64] = 0.0                              # axis-parallel rays
    lo = g.uniform(-12, 8, (3, s)).astype(np.float32)
    boxes = np.concatenate([lo, lo + g.uniform(0.5, 4, (3, s))]).astype(
        np.float32)
    boxes[:, -4:] = np.array([[1.0]] * 3 + [[-1.0]] * 3, np.float32)  # empty
    jv = jwl.bundle_box_votes(jwl.tile_bundles(jnp.asarray(o), jnp.asarray(d),
                                               tile), jnp.asarray(boxes))
    tv = pwl.bundle_box_votes(pwl.tile_bundles(_t(o), _t(d), tile),
                              _t(boxes))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < np.asarray(jv).mean() < 1
    for votes in (np.asarray(jv), g.random((7, 33)) < 0.3):
        for budget in (2, votes.shape[1] + 1):
            ref = jwl.build_worklist(jnp.asarray(votes), budget)
            got = pwl.build_worklist(_t(votes), budget)
            for r, t in zip(ref, got):
                np.testing.assert_array_equal(t.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# Gradients through the guards
# ---------------------------------------------------------------------------

def _grazing_rays(dev):
    """Rays passing each sphere of the scene at (1 - delta) of its radius,
    along three axes: hits at a grazing angle (delta > 0) and near
    misses (delta < 0)."""
    trf = dev.transfo.numpy()
    O, D = [], []
    for gi, code in enumerate(dev.group_codes):
        if code != pint.CODE_SPHERE:
            continue
        for i in dev.group_prim[gi].tolist():
            if i < 0:
                continue
            c, r = trf[i][:3, 3], trf[i][0, 0]
            for u, v in ((0, 1), (2, 0), (1, 2)):
                eu, ev = np.eye(3, dtype=np.float32)[[u, v]]
                for delta in (1e-2, 1e-3, -1e-3):
                    O.append(c - 3 * r * ev + (1 - delta) * r * eu)
                    D.append(ev)
    return np.array(O, np.float32), np.array(D, np.float32)


def test_trace_gradient_matches_jax():
    jdev, dev = _scenes("box_balls")
    O, D = _rays("box_balls", 12, 8, n_random=0)
    Og, Dg = _grazing_rays(dev)
    O, D = np.concatenate([O, Og]), np.concatenate([D, Dg])

    def jloss(O):
        h = jtrace.trace(jdev, O, jnp.asarray(D))
        n, _ = jsh.intersection_info(jdev, h)
        dist = jnp.sqrt(jnp.sum((O - h.pg) ** 2, axis=-1))
        return jnp.sum(jnp.where(h.shape >= 0, dist, 0.0)) + jnp.sum(n)

    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(O)))
    Ot = _t(O).requires_grad_(True)
    h = ptrace.trace(dev, Ot, _t(D))
    n, _ = psh.intersection_info(dev, h)
    loss = torch.where(h.shape >= 0, h.dist, 0.0).sum() + n.sum()
    tg, = torch.autograd.grad(loss, Ot)
    tg = tg.numpy()
    hits = h.shape.numpy() >= 0
    assert np.isfinite(tg).all() and np.isfinite(jg).all()
    assert 0.2 < hits.mean() < 0.95            # misses and hits
    assert hits[-len(Og):].any()
    size = np.linalg.norm(jg, axis=1)
    assert size[-len(Og):].max() > 10          # a grazing hit's steep term
    err = np.linalg.norm(tg - jg, axis=1)
    np.testing.assert_array_equal(tg[size == 0], 0.0)
    assert (err[size > 0] <= GRAD_RTOL * size[size > 0]).all(), \
        float((err[size > 0] / size[size > 0]).max())
