"""The port's multi-device rendering (parallel/sharding.py) on the CPU.

CPU shards stand in for cards, as tests/conftest.py's 8 virtual CPU
devices stand in for TPU chips. The RNG seed is a pure function of
(pixel uv, pass), so a sharded render must reproduce the unsharded one:

  - the port's make_sharded_pass on 8 CPU shards against JAX's
    make_sharded_pass on its 8-device mesh, the dense route, box_diffuse
    32x16, 3 bounces, by the megakernel protocol (testing/parity.py);
  - the port's sharded pass against its unsharded integrator BIT FOR BIT
    on the four routes of tests/test_sharding.py: dense, megakernel (the
    plain K1), fused (mesh_demo, the plain K2) and pallas-trace, on 8 and
    2 shards at 30x17 (510 rays: 8 shards need padding), 2 bounces;
  - make_sample_sharded_pass against the sequential sum of its passes and
    against JAX's within 1e-6 (tests/test_sharding.py:57);
  - Renderer(shard_devices=8) renders the unsharded image bit for bit and
    its checkpoint round-trips;
  - make_mesh: a mesh of more cards than the host has raises, here 2;
  - the route keywords reach only integrators that name them (C.9);
  - the kernels' device guard is a no-op off the card.
JAX runs the dense route only: no interpret-mode JAX route here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.parallel import sharding as jsharding
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import registry
from montecarlo_pathtracing_tpu_torch.parallel.sharding import (
    make_mesh, make_sample_sharded_pass, make_sharded_pass, shard_rays)
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_megakernel_protocol)

BOUNCES = 3


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rays(w, h):
    proj, view = default_rt_camera(w, h)
    o, d, tc = camera_rays(proj, view, w, h, device="cpu")
    return o, d.reshape(-1, 3), tc.reshape(-1, 2)


def _sharded(mesh, scene, o, d, tc, pass_index=0, bounces=BOUNCES, **kw):
    """One pixel-sharded pass from a zero accumulator, gathered and cut
    to the real rays."""
    sd, st, pad = shard_rays(mesh, d, tc)
    assert pad % len(mesh) == 0 and pad - d.shape[0] < len(mesh)
    acc = [torch.zeros_like(x) for x in sd]
    fn = make_sharded_pass(mesh, nb_bounces=bounces, **kw)
    out = fn(scene, acc, sd, st, o, pass_index, 1.0)
    assert all(a is b for a, b in zip(out, acc))     # added in place
    return torch.cat(out).numpy()[: d.shape[0]]


def test_sharded_pass_matches_jax_sharded_pass():
    w, h = 32, 16
    jdev = jcompile(jscenes.build("box_diffuse"))
    proj, view = default_rt_camera(w, h)
    jo, jd, jtc = jcamera_rays(proj, view, w, h)
    jd, jtc = jd.reshape(-1, 3), jtc.reshape(-1, 2)
    jmesh = jsharding.make_mesh(8)
    sd, st, pad = jsharding.shard_rays(jmesh, jd, jtc)
    jfn = jsharding.make_sharded_pass(jmesh, nb_bounces=BOUNCES)
    acc = jnp.zeros((pad, 3), jnp.float32, device=jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("rays")))
    want = np.asarray(jfn(jdev, acc, sd, st, jo, jnp.int32(0),
                          jnp.float32(1.0)))[: w * h]
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    got = _sharded(make_mesh(8, "cpu"), dev, *_rays(w, h))
    assert got.shape == want.shape and want.max() > 0
    assert_megakernel_protocol(want, got, "sharded pass vs JAX's")


ROUTES = {
    "dense": ("box_diffuse", dict(use_kernels=False)),
    "megakernel": ("box_diffuse", dict(use_kernels=True,
                                       use_megakernel=True)),
    "fused": ("mesh_demo", dict(use_kernels=True, use_megakernel=False,
                                use_fused=True)),
    "pallas-trace": ("box_diffuse", dict(use_kernels=True,
                                         use_megakernel=False,
                                         use_fused=False)),
}


@pytest.fixture(scope="module")
def route_scenes():
    return {name: compile_scene(scenes.build(name), device="cpu")
            for name in ("box_diffuse", "mesh_demo")}


@pytest.mark.parametrize("n_shards", [8, 2])
@pytest.mark.parametrize("label", list(ROUTES))
def test_sharded_route_matches_unsharded(route_scenes, label, n_shards,
                                         monkeypatch):
    """Bit for bit: every route is per ray on the CPU, where the wrappers
    run the kernels' plain versions (counted: the route really ran them)."""
    name, route = ROUTES[label]
    dev = route_scenes[name]
    o, d, tc = _rays(30, 17)
    from montecarlo_pathtracing_tpu_torch.models import (
        bounce_kernel, megakernel)
    calls = {"K1": 0, "K2": 0}

    def counting(kid, fn):
        def run(*a, **k):
            calls[kid] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(megakernel, "mega_pass_reference",
                        counting("K1", megakernel.mega_pass_reference))
    monkeypatch.setattr(bounce_kernel, "fused_call_reference",
                        counting("K2", bounce_kernel.fused_call_reference))
    got = _sharded(make_mesh(n_shards, "cpu"), dev, o, d, tc,
                   pass_index=1, bounces=2, route=route)
    sharded_calls = dict(calls)
    want = registry.get_integrator("montecarlo")(
        dev, o, d, tc, 1, nb_bounces=2, refract_ind=1.0, **route).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.max() > 0
    if label == "megakernel":
        assert sharded_calls == {"K1": n_shards, "K2": 0}
    elif label == "fused":
        assert sharded_calls["K1"] == 0 and sharded_calls["K2"] >= n_shards
    else:
        assert sharded_calls == {"K1": 0, "K2": 0}


def test_sample_sharded_pass_matches_sequential_and_jax():
    w, h = 32, 16
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    o, d, tc = _rays(w, h)
    fn = make_sample_sharded_pass(make_mesh(8, "cpu"), nb_bounces=BOUNCES)
    assert fn.n_passes_per_call == 8
    got = fn(dev, d, tc, o, 0, 1.0).numpy()
    integrator = registry.get_integrator("montecarlo")
    want = sum(integrator(dev, o, d, tc, k, nb_bounces=BOUNCES,
                          refract_ind=1.0).numpy() for k in range(8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    jdev = jcompile(jscenes.build("box_diffuse"))
    proj, view = default_rt_camera(w, h)
    jo, jd, jtc = jcamera_rays(proj, view, w, h)
    jfn = jsharding.make_sample_sharded_pass(
        jsharding.make_mesh(8, axis_name="spp"), nb_bounces=BOUNCES)
    jgot = np.asarray(jfn(jdev, jd.reshape(-1, 3), jtc.reshape(-1, 2), jo,
                          jnp.int32(0), jnp.float32(1.0)))
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)


def test_sharded_renderer_matches_unsharded_and_checkpoints(tmp_path):
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")

    def renderer(shards):
        return Renderer(dev, RenderConfig(
            width=40, height=24, nb_bounces=BOUNCES, tile_rays=512,
            shard_devices=shards, use_kernels=False, device="cpu"))

    base = renderer(0)
    sharded = renderer(8)
    assert len(sharded._accs) == 8 and base._ntiles == sharded._ntiles == 2
    img0 = base.run(2)
    np.testing.assert_array_equal(sharded.run(2), img0)
    np.testing.assert_array_equal(sharded.accumulator(), base.accumulator())

    ck = str(tmp_path / "sharded.npz")
    sharded.save_checkpoint(ck)
    resumed = renderer(8)
    resumed.load_checkpoint(ck)
    assert resumed.nb_passes == 2
    np.testing.assert_array_equal(resumed.image(), img0)
    np.testing.assert_array_equal(resumed.run(3), base.run(3))
    # shard_devices is compared like any other field, as in the JAX package
    with pytest.raises(ValueError, match="shard_devices"):
        renderer(0).load_checkpoint(ck)


def test_make_mesh():
    with pytest.raises(RuntimeError, match="this host has 0"):
        make_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="this host has 0"):
        make_mesh(None, "cuda")
    assert make_mesh(device="cpu") == [torch.device("cpu")]
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    # an explicit list is taken as given: two shards on one card
    assert make_mesh(devices=["cuda:0", "cuda:0"]) == [
        torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu", "cpu"])


def test_route_keywords_reach_only_integrators_naming_them(monkeypatch):
    seen = []

    def stub(scene, O, D, screen_tc, pass_index, *, nb_bounces,
             refract_ind, date=0.0, detach_sampling=False):
        seen.append(pass_index)
        return torch.zeros_like(D)

    monkeypatch.setitem(registry.INTEGRATORS, "montecarlo_mat", stub)
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    o, d, tc = _rays(8, 4)
    route = dict(use_kernels=True, use_megakernel=True, use_fused=False,
                 cull_chunks=None)
    mesh = make_mesh(2, "cpu")
    sd, st, _ = shard_rays(mesh, d, tc)
    make_sharded_pass(mesh, "montecarlo_mat", route=route)(
        dev, [torch.zeros_like(x) for x in sd], sd, st, o, 5, 1.0)
    make_sample_sharded_pass(mesh, "montecarlo_mat", route=route)(
        dev, d, tc, o, 5, 1.0)
    assert seen == [5, 5, 5, 6]


def test_kernel_device_guard_is_a_no_op_off_the_card():
    """Each wrapper launches under kernels.on_device(its tensors' card);
    off the card the guard is a null context (the plain versions run),
    and for cuda:1 it names card 1 (not entered: no card here)."""
    with kernels.on_device(torch.device("cpu")):
        pass
    guard = kernels.on_device(torch.device("cuda", 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
