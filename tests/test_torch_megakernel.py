"""The port's megakernel route against the JAX package's.

Host side (prim table, super boxes, visit order, group descriptor) must
be bit-equal. The plain K1 (`mega_pass_reference`, which the port runs on
CPU tensors) is held against JAX `raytrace_mega(interpret=True)` under
the reference's megakernel protocol (more than 98% of lanes within 1e-3
abs + 1e-3 rel, image means within 2e-3): the RNG streams are
bit-identical, so only float rounding differs, and a last-ulp difference
can send a few paths down another material branch. The CUDA kernel
itself is held against the plain version on the GPU by chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.models import megakernel as jmk
from montecarlo_pathtracing_tpu.models.montecarlo import raytrace as jsoa
from montecarlo_pathtracing_tpu.ops import worklist as jwl
from montecarlo_pathtracing_tpu.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu.scene import scene as jscene_mod
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu.utils import transforms as jtf
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace
from montecarlo_pathtracing_tpu_torch.ops import worklist as wl
from montecarlo_pathtracing_tpu_torch.ops.rng import seed_y
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    all_shapes_scene, assert_megakernel_protocol)
from montecarlo_pathtracing_tpu_torch.utils import transforms

# (scene, IOR): cull off + opaque; all 4 material cases + the re-trace;
# cull on; every shape code with cull and re-trace together
CASES = [("box_diffuse", 1.0), ("box_balls", 1.3), ("materials", 1.5),
         ("all_shapes", 1.3)]
W, H, BOUNCES, PASSES = 24, 18, 4, (0, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scenes(name):
    """(JAX DeviceScene, port DeviceScene) of the same prims."""
    if name == "all_shapes":
        return (jcompile(all_shapes_scene(jscene_mod, jtf)),
                compile_scene(all_shapes_scene(scene_mod, transforms),
                              device="cpu"))
    return (jcompile(jscenes.build(name)),
            compile_scene(scenes.build(name), device="cpu"))


def _rays(w, h):
    proj, view = default_rt_camera(w, h)
    o, d, tc = camera_rays(proj, view, w, h)
    # writable copies: torch.as_tensor warns on read-only jax buffers
    return (np.array(o), np.array(d).reshape(-1, 3),
            np.array(tc).reshape(-1, 2))


@pytest.fixture(scope="module")
def parity_runs():
    """Per case and pass: (JAX raytrace_mega in interpret mode, the port's
    raytrace_mega on CPU tensors). Computed once: each JAX scene costs
    seconds to interpret."""
    o, d, tc = _rays(W, H)
    out = {}
    for name, ior in CASES:
        jdev, dev = _scenes(name)
        for p in PASSES:
            ref = jmk.raytrace_mega(
                jdev, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tc),
                jnp.int32(p), nb_bounces=BOUNCES,
                refract_ind=jnp.float32(ior), interpret=True)
            got = mk.raytrace_mega(
                dev, torch.as_tensor(o), torch.as_tensor(d),
                torch.as_tensor(tc), p, nb_bounces=BOUNCES, refract_ind=ior)
            out[name, p] = (np.asarray(ref), got.numpy())
    return out


@pytest.mark.parametrize("name,ior", CASES)
def test_plain_k1_matches_jax_megakernel(parity_runs, name, ior):
    for p in PASSES:
        ref, got = parity_runs[name, p]
        assert got.shape == ref.shape == (W * H, 3)
        assert np.isfinite(got).all()
        assert_megakernel_protocol(ref, got, f"{name} pass {p}")


@pytest.mark.parametrize("name,ior", CASES)
def test_host_tables_bit_equal(name, ior):
    jdev, dev = _scenes(name)
    groups, total = mk._mega_meta(dev)
    assert (groups, total) == jmk._mega_meta(jdev)
    np.testing.assert_array_equal(mk._mega_table(dev).numpy(),
                                  np.asarray(jmk._mega_table(jdev)))
    sbb = mk._mega_super_boxes(dev)
    jsbb = jmk._mega_super_boxes(jdev)
    np.testing.assert_array_equal(sbb.numpy(), np.asarray(jsbb))
    # 3 tiles of primary rays, padded as raytrace_mega pads them
    o, d, _ = _rays(96, 96)
    n = d.shape[0]
    m = -(-n // mk.TILE) * mk.TILE
    rows = np.zeros((3, m), np.float32)
    rows[2] = 1.0
    rows[:, :n] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).T
    ref = jmk._mega_super_order(jnp.asarray(rows.reshape(3, -1, 128)),
                                jnp.asarray(o), jsbb, groups)
    got = mk._mega_super_order(torch.as_tensor(rows), torch.as_tensor(o),
                               sbb, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_worklist_bundles_and_entry_bit_equal():
    """tile_bundles and bundle_box_entry against the JAX package's, on
    random rays with exact-zero direction components (the a == 0 branch
    of _cond_interval) and boxes that include empty padding boxes."""
    g = np.random.default_rng(7)
    tile = 256
    o = g.normal(size=(3, 4 * tile)).astype(np.float32) * 5
    d = g.normal(size=(3, 4 * tile)).astype(np.float32)
    d[0, :tile] = 0.0
    d[2, tile:2 * tile] = 0.0
    lo = g.normal(size=(3, 40)).astype(np.float32) * 20
    boxes = np.concatenate([lo, lo + g.random((3, 40), np.float32) * 8])
    boxes[:, ::7] = np.array([[1.0]] * 3 + [[-1.0]] * 3, np.float32)
    ref_b = jwl.tile_bundles(jnp.asarray(o), jnp.asarray(d), tile)
    got_b = wl.tile_bundles(torch.as_tensor(o), torch.as_tensor(d), tile)
    for r, t in zip(ref_b, got_b):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    ref = np.asarray(jwl.bundle_box_entry(ref_b, jnp.asarray(boxes)))
    got = wl.bundle_box_entry(got_b, torch.as_tensor(boxes)).numpy()
    assert (got < wl.INF).any() and (got == wl.INF).any()
    np.testing.assert_array_equal(got, ref)


def test_zero_bounces_black_and_no_launch_on_cpu():
    _, dev = _scenes("box_diffuse")
    o, d, tc = _rays(8, 8)
    before = mk.k1_launch.launches
    got = mk.raytrace_mega(dev, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(tc), 0, nb_bounces=0,
                           refract_ind=1.0)
    assert tuple(got.shape) == (64, 3) and bool((got == 0).all())
    assert mk.k1_launch.launches == before


def test_k1_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the route takes the plain version; the kernel
    wrapper itself raises instead of moving work anywhere."""
    _, dev = _scenes("box_diffuse")
    o, d, tc = _rays(8, 8)
    inp = mk.mega_inputs(dev, torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(tc), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        mk.k1_launch(inp, seed_y(0), 3)
    assert tuple(mk.mega_pass(inp, seed_y(0), 3).shape) == (64, 3)


def test_routing():
    """use_kernels on an eligible analytic scene goes to the megakernel;
    mesh scenes are not eligible; the dense route (kernels off) meets the
    megakernel protocol against it.
    box_diffuse with the megakernel off is not fused-eligible either, so
    it takes the pallas-trace route, as the JAX raytrace does (its small
    groups fold without a kernel on either side); that image agrees with
    the megakernel's under the megakernel protocol, the reference's own
    invariant between the two routes (tests/test_megakernel.py:28-46)."""
    _, dev = _scenes("box_diffuse")
    o, d, tc = (torch.as_tensor(a) for a in _rays(16, 8))
    via_route = raytrace(dev, o, d, tc, 1, nb_bounces=3, refract_ind=1.0,
                         use_kernels=True)
    direct = mk.raytrace_mega(dev, o, d, tc, 1, nb_bounces=3,
                              refract_ind=1.0)
    np.testing.assert_array_equal(via_route.numpy(), direct.numpy())
    assert not mk.mega_eligible(compile_scene(scenes.build("mesh_demo"),
                                              device="cpu"))
    dense = raytrace(dev, o, d, tc, 1, nb_bounces=3, refract_ind=1.0)
    assert_megakernel_protocol(direct.numpy(), dense.numpy(),
                               "dense route vs megakernel")
    trace_route = raytrace(dev, o, d, tc, 1, nb_bounces=3, refract_ind=1.0,
                           use_kernels=True, use_megakernel=False).numpy()
    assert trace_route.shape == (16 * 8, 3) and np.isfinite(trace_route).all()
    assert_megakernel_protocol(direct.numpy(), trace_route,
                               "pallas-trace route vs megakernel")


def test_pad_columns_never_hit():
    """Group-padding columns carry identity transforms; the ok flag must
    keep them from tracing as phantom unit prims at the world origin
    (the reference's regression, tests/test_megakernel.py:75-108). Rays
    straight down through the origin must see the sky."""
    def build(mod, tf):
        sc = mod.ScenePrimitives()
        sc.add_cube(tf.translate(40.0, 0.0, 0.0),
                    mod.Material((0.9, 0.2, 0.2, 1.0)))
        sc.add_cube(tf.translate(-40.0, 0.0, 0.0),
                    mod.Material((0.2, 0.9, 0.2, 1.0)))
        return sc

    dev = compile_scene(build(scene_mod, transforms), device="cpu")
    jdev = jcompile(build(jscene_mod, jtf))
    groups, total = mk._mega_meta(dev)
    assert total > dev.nb_prims, "fixture must actually have pad columns"

    n = mk.TILE
    D = np.zeros((n, 3), np.float32)
    D[:, 2] = -1.0
    O = np.array([0.0, 0.0, 50.0], np.float32)
    tc = np.zeros((n, 2), np.float32)
    ref = np.asarray(jsoa(jdev, jnp.asarray(O), jnp.asarray(D),
                          jnp.asarray(tc), jnp.int32(0), nb_bounces=2,
                          refract_ind=jnp.float32(1.0),
                          use_megakernel=False))
    got = mk.raytrace_mega(dev, torch.as_tensor(O), torch.as_tensor(D),
                           torch.as_tensor(tc), 0, nb_bounces=2,
                           refract_ind=1.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    sky_low = np.array([0.5, 0.5, 0.9]) * 0.8   # attenu 0.8 * sky(d.z<0)
    np.testing.assert_allclose(got, np.broadcast_to(sky_low, got.shape),
                               atol=1e-5)


def test_direct_calls_build_k1_inputs_every_time():
    """raytrace without a memo builds K1's inputs on every call, as
    before the memo; with one, the second call on the same tensors
    reuses them and renders the same bits."""
    _, dev = _scenes("box_diffuse")
    o, d, tc = (torch.as_tensor(a) for a in _rays(8, 8))
    b0, u0 = mk.mega_inputs.builds, mk.mega_inputs.reuses
    plain = [raytrace(dev, o, d, tc, 1, nb_bounces=2, refract_ind=1.0,
                      use_kernels=True) for _ in range(2)]
    assert (mk.mega_inputs.builds, mk.mega_inputs.reuses) == (b0 + 2, u0)
    memo = mk.MegaMemo()
    kept = [raytrace(dev, o, d, tc, 1, nb_bounces=2, refract_ind=1.0,
                     use_kernels=True, mega_memo=memo) for _ in range(2)]
    assert (mk.mega_inputs.builds, mk.mega_inputs.reuses) == (b0 + 3, u0 + 1)
    for a in plain + kept[1:]:
        np.testing.assert_array_equal(a.numpy(), kept[0].numpy())


def test_k1_memo_drops_inputs_with_their_rays():
    """An entry lives as long as its ray tensor: rays passed once leave
    nothing behind, and a dead scene's table goes with it."""
    _, dev = _scenes("box_diffuse")
    o, d, tc = (torch.as_tensor(a) for a in _rays(8, 8))
    memo = mk.MegaMemo()
    for _ in range(4):
        rays = d.clone()
        memo.inputs(dev, o, rays, tc, 1.0)
        assert len(memo) == 1
    del rays
    assert len(memo) == 0 and len(memo._scenes) == 1
    del dev
    assert len(memo._scenes) == 0
