"""The port's fused per-bounce route (kernel K2's host side, its plain
version and the slice end to end) against the JAX package's
models/bounce_kernel.py.

The port runs on `from_jax_scene` of the JAX package's own compiled scene,
so both sides read identical tables. Host tables are integers or copies of
scene floats and must be exactly equal. Schedules go through interval
arithmetic and a 3x3 matrix product whose summation order differs between
XLA and torch: entry bounds within 1 ulp, and the visit order equal
wherever the entry bounds have no near-ties. One K2 call of the plain
version (`fused_call_reference`) is held against JAX `_fused_call` in
interpret mode from the same state under the fused protocol: at most 0.5%
of lanes may differ (a float beyond 1e-3 x (1 + |ref|), or an integer),
because the RNG is bit-exact and only an ulp-level winner flip at a
triangle edge sends a lane down another branch.

The slice, the port's `raytrace_fused` (the plain K2 on CPU tensors), is
held against JAX `raytrace_fused(interpret=True)` under the fused protocol
of the reference (tests/test_bounce_kernel.py:36-45): at most 0.5% of
pixels more than 1e-3 off, 1.5% on the large analytic stress scene
(tests/test_bounce_kernel.py:116-119), for the same reason. Sorted against
unsorted wavefronts and whole-path against wavefront mode only permute or
regroup the same per-lane arithmetic: within 2e-5, as the reference's own
tests hold them (tests/test_bounce_kernel.py:55-65,122-131).
"""
import dataclasses
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.models import bounce_kernel as jbk
from montecarlo_pathtracing_tpu.ops import rng as jrng
from montecarlo_pathtracing_tpu.render.camera import (
    default_rt_camera, camera_rays as jcamera_rays)
from montecarlo_pathtracing_tpu.scene import mesh as jmesh
from montecarlo_pathtracing_tpu.scene import scene as jscene_mod
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import (
    DeviceScene as JDeviceScene, compile_scene as jcompile)
from montecarlo_pathtracing_tpu.utils import transforms as jtf
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace
from montecarlo_pathtracing_tpu_torch.render import camera as cam
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import device as sdev
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    FUSED_FRAC, FUSED_FRAC_STRESS, assert_fused_protocol, cull_mesh_scene,
    opaque_mesh_scene)

W, H = 24, 18
LANE_TOL = 1e-3
PASS = 3
# (scene, IOR, bounces, allowed share of pixels off): wavefront mode with
# transparency and the schedule-free re-trace; flat faces; large analytic
# groups in whole-path mode; a mesh scene with the culled 88-prim table
SLICE_CASES = [("mesh_demo", 1.3, 4, FUSED_FRAC),
               ("flat_mesh", 1.0, 3, FUSED_FRAC),
               ("stress_4200", 1.0, 3, FUSED_FRAC_STRESS),
               ("cull_mesh", 1.3, 3, FUSED_FRAC)]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_scene(name):
    if name == "flat_mesh":
        return jcompile(opaque_mesh_scene(jscene_mod, jmesh, jtf),
                        flat_face=True)
    if name == "cull_mesh":
        return jcompile(cull_mesh_scene(jscene_mod, jmesh, jtf))
    if name.startswith("stress_"):
        return jcompile(jscenes.scene_stress(n_prims=int(name[7:])))
    return jcompile(jscenes.build(name))


def _carry(jdev):
    """The JAX scene as a port DeviceScene on the CPU (from_jax_scene)."""
    fields = {}
    for f in dataclasses.fields(JDeviceScene):
        v = getattr(jdev, f.name)
        if f.metadata.get("static"):
            fields[f.name] = v
        elif isinstance(v, tuple):
            fields[f.name] = tuple(np.asarray(a) for a in v)
        else:
            fields[f.name] = np.asarray(v)
    return sdev.from_jax_scene(fields, device="cpu")


_SCENES = {}


def _scenes(name):
    """(JAX DeviceScene, the port's carried copy), built once per name."""
    if name not in _SCENES:
        jdev = _jax_scene(name)
        _SCENES[name] = (jdev, _carry(jdev))
    return _SCENES[name]


def _primary_state(w=W, h=H, pass_index=3):
    """The fused route's padded state of primary rays, as numpy: stf
    [15, M] f32 and sti [4, M] uint32 (raytrace_fused's layout)."""
    proj, view = default_rt_camera(w, h)
    o, d, tc = (np.array(a) for a in jcamera_rays(proj, view, w, h))
    d = d.reshape(-1, 3)
    tc = tc.reshape(-1, 2)
    n = d.shape[0]
    m = -(-n // bk.TILE) * bk.TILE
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    stf = np.zeros((15, m), np.float32)
    stf[0:3] = o[:, None]
    stf[5] = 1.0
    stf[3:6, :n] = dn.T
    stf[6:9] = 0.8
    u = np.zeros(m, np.float32)
    v = np.zeros(m, np.float32)
    u[:n], v[:n] = tc[:, 0], tc[:, 1]
    s = jrng.srand_soa(jnp.asarray(u), jnp.asarray(v), pass_index, 0.0)
    sti = np.stack([np.zeros(m, np.uint32)] + [np.asarray(x) for x in s])
    return stf, sti


def _jax_call(jdev, stf, sti, ior, whole_path=0):
    """JAX `_fused_call` in interpret mode, its inputs built as JAX
    raytrace_fused builds them (bounce_kernel.py:1131-1151)."""
    groups, _ = jbk._small_meta(jdev)
    msc, msi, cbb, sbb = jbk._mesh_tables(jdev)
    csm = jbk.cull_small(jdev)
    mesh_stot = sum(int(c.shape[1]) // 16 for c in jdev.mesh_chunk_bb)
    ana_stot = sum(nc // 16 for _c, _s, nc, _ss in jdev.ana_groups)
    z6 = jnp.zeros((6, 1), jnp.float32)
    stf_j, sti_j = jnp.asarray(stf), jnp.asarray(sti)
    ordr, entr = jbk._schedules(jdev, stf_j[0:3], stf_j[3:6])
    outf, outu = jbk._fused_call(
        stf_j, sti_j, jnp.asarray(ior, jnp.float32).reshape(1, 1),
        jbk._small_table(jdev), msc, msi, cbb, sbb,
        jdev.ana_chunk_bb if jdev.ana_groups else z6,
        jdev.ana_super_bb if jdev.ana_groups else z6,
        jbk._ana_tables(jdev),
        jbk._small_super_boxes(jdev) if csm else z6, ordr, entr,
        jdev.tri_chunks if jdev.mesh_prim_index
        else jnp.zeros((1, 18, 128), jnp.float32),
        jdev.ana_chunks if jdev.ana_groups
        else jnp.zeros((1, 32, 128), jnp.float32),
        groups, len(jdev.mesh_prim_index), jdev.ana_groups, mesh_stot,
        jdev.has_transparent, jdev.flat_face, whole_path, csm,
        mesh_stot + ana_stot, True)
    return np.asarray(outf), np.asarray(outu)


def _port_call(dev, stf, sti, ior, whole_path=0):
    stf_t = torch.as_tensor(stf.copy())
    sti_t = torch.as_tensor(sti.astype(np.int64))
    inp = bk.with_schedule(bk.fused_inputs(dev, ior), dev, stf_t)
    bk.fused_call(inp, stf_t, sti_t, whole_path)
    return stf_t.numpy(), sti_t.numpy()


def _lanes_off(ref_f, ref_u, got_f, got_u):
    """Share of lanes where a float row differs beyond LANE_TOL x (1 +
    |ref|) or an integer row differs at all."""
    bad_f = np.abs(got_f - ref_f) > LANE_TOL * (1.0 + np.abs(ref_f))
    bad_u = got_u != ref_u.astype(np.int64)
    return float((bad_f.any(axis=0) | bad_u.any(axis=0)).mean())


# --------------------------------------------------------------------------
# host side
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["box_diffuse", "mesh_demo", "stress_4094",
                                  "stress_4100"])
def test_fused_eligible_matches_jax(name):
    jdev, dev = _scenes(name)
    assert bk.fused_eligible(dev) == jbk.fused_eligible(jdev)
    assert bk.cull_small(dev) == jbk.cull_small(jdev)
    assert bk.fused_eligible(dev) == (name != "box_diffuse")


def _eq(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["mesh_demo", "stress_4200", "cull_mesh"])
def test_host_tables_exact(name):
    jdev, dev = _scenes(name)
    assert bk._small_meta(dev) == jbk._small_meta(jdev)
    _eq(bk._small_table(dev), jbk._small_table(jdev))
    _eq(bk._small_super_boxes(dev), jbk._small_super_boxes(jdev))
    msc, msi, meshes, cbb, sbb = bk._mesh_tables(dev)
    ref_tables = jbk._mesh_tables(jdev)
    for got, ref in zip((msc, msi, cbb, sbb), ref_tables):
        _eq(got, ref)
    # the host copy of msi's first three rows, one tuple per instance
    ref_meshes = np.asarray(ref_tables[1])[0:3].T.tolist()
    assert meshes == tuple(map(tuple, ref_meshes[:len(jdev.mesh_prim_index)]))
    _eq(bk._ana_tables(dev), jbk._ana_tables(jdev))


def _ulps(a, b):
    """Distance in float32 units in the last place (same-sign values)."""
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("name", ["mesh_demo", "stress_4200", "cull_mesh"])
def test_schedules_match_jax(name):
    """On a primary wavefront and a secondary-like one: per 1024-ray tile,
    origins around a random point and directions in a narrow random cone,
    as the re-sort groups them, with a quarter of the lanes parked."""
    jdev, dev = _scenes(name)
    stf, _ = _primary_state(48, 40)
    g = np.random.default_rng(11)
    nt = stf.shape[1] // bk.TILE
    sec = stf.copy()
    centre = np.repeat(g.uniform(-120, 120, size=(3, nt)), bk.TILE, axis=1)
    sec[0:3] = centre + g.normal(scale=2.0, size=centre.shape)
    axis = np.repeat(g.normal(size=(3, nt)), bk.TILE, axis=1)
    dd = axis / np.linalg.norm(axis, axis=0) + g.normal(scale=0.05,
                                                        size=axis.shape)
    sec[3:6] = dd / np.linalg.norm(dd, axis=0)
    sec[0:3, ::4] = np.array([[0.0], [0.0], [bk.PARK_Z]], np.float32)
    sec[3:6, ::4] = np.array([[0.0], [0.0], [1.0]], np.float32)
    for rows in (stf, sec.astype(np.float32)):
        ref_o, ref_e = (np.asarray(x) for x in jbk._schedules(
            jdev, jnp.asarray(rows[0:3]), jnp.asarray(rows[3:6])))
        got_o, got_e = bk._schedules(dev, torch.as_tensor(rows[0:3]),
                                     torch.as_tensor(rows[3:6]))
        got_o, got_e = got_o.numpy(), got_e.numpy()
        assert got_o.dtype == np.int32 and got_o.shape == ref_o.shape
        assert got_e.dtype == np.float32 and got_e.shape == ref_e.shape
        assert (_ulps(got_e, ref_e) <= 1).all()
        # the order is compared where an entry bound has no other bound of
        # its tile within 4 ulps (ties and near-ties may order either way)
        e = ref_e[:, 0, :].astype(np.float64)
        near = np.abs(e[:, :, None] - e[:, None, :]) <= 4 * np.spacing(
            np.abs(e[:, :, None]).astype(np.float32))
        clear = near.sum(axis=2) == 1
        assert clear.any()
        np.testing.assert_array_equal(got_o[:, 0, :][clear],
                                      ref_o[:, 0, :][clear])


# --------------------------------------------------------------------------
# one K2 call
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,ior", [("mesh_demo", 1.3), ("flat_mesh", 1.0)])
def test_one_call_matches_jax_fused_call(name, ior):
    """Two successive calls, bounce 0 from primaries and bounce 1 from the
    reference's bounce-0 output, each side from the same input state."""
    jdev, dev = _scenes(name)
    stf, sti = _primary_state()
    for _bounce in range(2):
        ref_f, ref_u = _jax_call(jdev, stf, sti, ior)
        got_f, got_u = _port_call(dev, stf, sti, ior)
        off = _lanes_off(ref_f, ref_u, got_f, got_u)
        assert off <= FUSED_FRAC, off
        assert (got_u[0] != 0).sum() > (sti[0] != 0).sum()   # paths finish
        stf, sti = ref_f, ref_u


# --------------------------------------------------------------------------
# the slice: raytrace_fused end to end
# --------------------------------------------------------------------------

def _rays(w=W, h=H):
    proj, view = default_rt_camera(w, h)
    o, d, tc = (np.array(a) for a in jcamera_rays(proj, view, w, h))
    return o, d.reshape(-1, 3), tc.reshape(-1, 2)


@pytest.fixture(scope="module")
def slice_runs():
    """Per case: (JAX raytrace_fused in interpret mode, the port's
    raytrace_fused on CPU tensors). Computed once: each JAX case costs
    5-25 s to interpret."""
    o, d, tc = _rays()
    out = {}
    for name, ior, bounces, _ in SLICE_CASES:
        jdev, dev = _scenes(name)
        ref = jbk.raytrace_fused(jdev, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tc), PASS, nb_bounces=bounces,
                                 refract_ind=ior, interpret=True)
        got = bk.raytrace_fused(dev, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(tc), PASS,
                                nb_bounces=bounces, refract_ind=ior)
        out[name] = (np.asarray(ref), got.numpy())
    return out


@pytest.mark.parametrize("name,ior,bounces,frac", SLICE_CASES)
def test_slice_matches_jax_raytrace_fused(slice_runs, name, ior, bounces,
                                          frac):
    ref, got = slice_runs[name]
    assert got.shape == ref.shape == (W * H, 3)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert ref.mean() > 0.05          # paths reach the light: not vacuous
    assert_fused_protocol(ref, got, name, frac)
    assert bk.fused_eligible(_scenes(name)[1])


def test_sorted_matches_unsorted():
    _, dev = _scenes("mesh_demo")
    o, d, tc = (torch.as_tensor(a) for a in _rays())
    a = bk.raytrace_fused(dev, o, d, tc, 5, nb_bounces=3, refract_ind=1.2,
                          sort_rays=True)
    b = bk.raytrace_fused(dev, o, d, tc, 5, nb_bounces=3, refract_ind=1.2,
                          sort_rays=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_whole_path_matches_wavefront():
    _, dev = _scenes("stress_4200")
    o, d, tc = (torch.as_tensor(a) for a in _rays())
    a = bk.raytrace_fused(dev, o, d, tc, 4, nb_bounces=3, refract_ind=1.0,
                          whole_path=True)
    b = bk.raytrace_fused(dev, o, d, tc, 4, nb_bounces=3, refract_ind=1.0,
                          whole_path=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_renderer_on_mesh_demo_sums_raytrace_fused():
    """Renderer.advance on a mesh scene goes through _passes unchanged:
    its 2-pass image is the per-pass sum of raytrace_fused on its tiles."""
    dev = sdev.compile_scene(scenes.build("mesh_demo"), device="cpu")
    cfg = RenderConfig(width=16, height=12, nb_bounces=3, refract_ind=1.3,
                       device="cpu")
    r = Renderer(dev, cfg)
    img = r.run(2)
    acc = torch.zeros_like(r._acc)
    for k in range(2):
        for t in range(r._ntiles):
            acc[t] += bk.raytrace_fused(dev, r._origin, r._dirs[t], r._tc[t],
                                        k, nb_bounces=3, refract_ind=1.3)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(img, r.resolve(acc, 2))


# --------------------------------------------------------------------------
# the wrapper, the route, the defaults
# --------------------------------------------------------------------------

def test_k2_launch_refuses_cpu_tensors():
    """On CPU tensors fused_call takes the plain version; the kernel
    wrapper itself raises instead of moving work anywhere."""
    _, dev = _scenes("flat_mesh")
    stf, sti = _primary_state(8, 8)
    stf_t = torch.as_tensor(stf)
    sti_t = torch.as_tensor(sti.astype(np.int64))
    inp = bk.with_schedule(bk.fused_inputs(dev, 1.0), dev, stf_t)
    with pytest.raises(ValueError, match="CUDA"):
        bk.k2_launch(inp, stf_t, sti_t, 0)
    before = bk.k2_launch.launches
    bk.fused_call(inp, stf_t, sti_t, 0)
    assert bk.k2_launch.launches == before
    assert (sti_t[0] != 0).any()


def test_zero_bounces_black_in_both_modes():
    proj, view = default_rt_camera(8, 8)
    o, d, tc = cam.camera_rays(proj, view, 8, 8, device="cpu")
    for name in ("flat_mesh", "stress_4200"):
        _, dev = _scenes(name)
        got = bk.raytrace_fused(dev, o, d.reshape(-1, 3), tc.reshape(-1, 2),
                                0, nb_bounces=0, refract_ind=1.0)
        assert tuple(got.shape) == (64, 3) and bool((got == 0).all())


def test_raytrace_routes_mesh_scenes_to_fused(slice_runs):
    """raytrace(use_kernels=True) on mesh_demo is raytrace_fused; with
    the fused route off it takes the pallas-trace route, whose image is
    the fused route's under the fused protocol (the same integrator and
    RNG streams over other kernels), as is the dense route's (kernels
    off); a forced megakernel never takes the fused route."""
    _, dev = _scenes("mesh_demo")
    o, d, tc = (torch.as_tensor(a) for a in _rays())
    via = raytrace(dev, o, d, tc, PASS, nb_bounces=4, refract_ind=1.3,
                   use_kernels=True)
    np.testing.assert_array_equal(via.numpy(), slice_runs["mesh_demo"][1])
    dense = raytrace(dev, o, d, tc, PASS, nb_bounces=4,
                     refract_ind=1.3).numpy()
    assert np.isfinite(dense).all() and (dense >= 0).all()
    assert_fused_protocol(via.numpy(), dense, "dense route")
    trace_route = raytrace(dev, o, d, tc, PASS, nb_bounces=4, refract_ind=1.3,
                           use_kernels=True, use_fused=False).numpy()
    assert np.isfinite(trace_route).all() and (trace_route >= 0).all()
    assert_fused_protocol(via.numpy(), trace_route, "pallas-trace route")
    forced = raytrace(dev, o, d, tc, PASS, nb_bounces=2, refract_ind=1.3,
                      use_kernels=True, use_megakernel=True)
    np.testing.assert_array_equal(
        forced.numpy(), mk.raytrace_mega(dev, o, d, tc, PASS, nb_bounces=2,
                                         refract_ind=1.3).numpy())


def test_entry_points_default_to_the_card():
    assert RenderConfig().device == "cuda"
    for fn in (sdev.compile_scene, sdev.from_numpy, sdev.from_jax_scene,
               cam.camera_rays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
