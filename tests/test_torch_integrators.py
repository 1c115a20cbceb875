"""The port's dense route and the carousel's other integrators against
the JAX package's, on the CPU at 24x18.

  - `raytrace(use_kernels=False)` (the dense route), `montecarlo_aos`
    and both stubs against their JAX counterparts on box_diffuse,
    box_balls at IOR 1.3 and mesh_demo, passes 0 and 3, by the protocol
    of tests/test_soa_integrator.py:27-37: more than 98% of pixels within
    1e-3 abs + 1e-3 rel, image means within 2e-3. The stubs' RNG draws
    are bit for bit JAX's, `montecarlo_mat_tr`'s image too;
  - `montecarlo_aos` with use_kernels=True (the plain K3a and K4a on CPU
    tensors) against the same integrator with kernels off, by the same
    protocol, with the kernels' launch counts;
  - a port `Renderer(use_kernels=False)` image against the JAX package's
    scalar oracle `CPUReference` by tests/test_parity.py's protocol: with
    1 bounce all pixels within 1e-4 (the image is deterministic), with 3
    bounces 94% within 2e-2 abs + 1e-3 rel, image means within 5e-3;
  - every carousel name renders through the port's Renderer.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.models import registry as jregistry
from montecarlo_pathtracing_tpu.ops import rng as jrng
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu.testing.cpu_ref import CPUReference
from montecarlo_pathtracing_tpu_torch.models import registry
from montecarlo_pathtracing_tpu_torch.ops import rng
from montecarlo_pathtracing_tpu_torch.ops import trace as ptrace
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_megakernel_protocol)

W, H = 24, 18
BOUNCES = 4
PASSES = (0, 3)
CASES = {"box_diffuse": 1.0, "box_balls": 1.3, "mesh_demo": 1.0}
INTEGRATORS = ("montecarlo", "montecarlo_aos", "montecarlo_mat",
               "montecarlo_mat_tr")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX device scene, port device scene, O [3], D [N,3], tc [N,2])."""
    proj, view = default_rt_camera(W, H)
    o, d, tc = jcamera_rays(proj, view, W, H)
    return (jcompile(jscenes.build(name)),
            compile_scene(scenes.build(name), device="cpu"),
            np.asarray(o), np.asarray(d).reshape(-1, 3),
            np.asarray(tc).reshape(-1, 2))


@functools.lru_cache(maxsize=None)
def _jax_fn(name, integrator):
    """The JAX integrator on the scene's rays, jitted over the pass."""
    jdev, _, o, d, tc = _setup(name)
    fn = jregistry.get_integrator(integrator)
    ior = jnp.float32(CASES[name])
    return jax.jit(lambda p: fn(jdev, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tc), p, nb_bounces=BOUNCES,
                                refract_ind=ior))


def _port(name, integrator, p, **kw):
    _, dev, o, d, tc = _setup(name)
    fn = registry.get_integrator(integrator)
    return fn(dev, torch.tensor(o), torch.tensor(d), torch.tensor(tc), p,
              nb_bounces=BOUNCES, refract_ind=CASES[name], **kw).numpy()


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_integrator_matches_jax(name, integrator):
    for p in PASSES:
        ref = np.asarray(_jax_fn(name, integrator)(jnp.int32(p)))
        got = _port(name, integrator, p, use_kernels=False)
        assert got.shape == (W * H, 3) and np.isfinite(got).all()
        assert_megakernel_protocol(ref, got, f"{name} {integrator} pass {p}")
        if integrator == "montecarlo_mat_tr":
            np.testing.assert_array_equal(got, ref)
    if integrator in ("montecarlo_mat", "montecarlo_mat_tr"):
        # the stubs' draws: srand then one uniform3 or uniform
        _, _, _, _, tc = _setup(name)
        draw = rng.uniform3 if integrator == "montecarlo_mat" else rng.uniform
        jdraw = jrng.uniform3 if integrator == "montecarlo_mat" \
            else jrng.uniform
        for p in PASSES:
            v, st = draw(rng.srand(torch.tensor(tc), p))
            jv, jst = jdraw(jrng.srand(jnp.asarray(tc), jnp.int32(p)))
            np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                          np.asarray(jv).view(np.uint32))
            np.testing.assert_array_equal(st.numpy(),
                                          np.asarray(jst).astype(np.int64))


# K3a or K4a launches of one montecarlo_aos pass: 2 traces per bounce,
# each over the scene's groups of at least 128 prims or its instances
AOS_KERNEL_CASES = {"colonnes": ("K3a", 2), "mesh_demo": ("K4a", 3)}


@pytest.mark.parametrize("name", sorted(AOS_KERNEL_CASES))
def test_aos_kernels_match_dense(name, monkeypatch):
    _, dev, o, d, tc = _setup(name)
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
    fn = registry.get_integrator("montecarlo_aos")
    args = (dev, torch.tensor(o), torch.tensor(d), torch.tensor(tc), 1)
    dense = fn(*args, nb_bounces=BOUNCES, refract_ind=1.3).numpy()
    assert calls == {"K3a": 0, "K4a": 0}
    kern = fn(*args, nb_bounces=BOUNCES, refract_ind=1.3,
              use_kernels=True).numpy()
    kid, units = AOS_KERNEL_CASES[name]
    assert calls[kid] == BOUNCES * 2 * units and sum(calls.values()) == \
        calls[kid]
    assert np.isfinite(kern).all()
    assert_megakernel_protocol(dense, kern, f"{name} montecarlo_aos kernels")


def _oracle_parity(w, h, spp, bounces, min_match, atol):
    """tests/test_parity.py's _parity, with the port's dense Renderer."""
    jprims = jscenes.build("box_diffuse")
    jcompile(jprims)                     # sorts emissives in place
    oracle = CPUReference(jprims)
    r = Renderer(compile_scene(scenes.build("box_diffuse"), device="cpu"),
                 RenderConfig(width=w, height=h, nb_bounces=bounces,
                              use_kernels=False, device="cpu"))
    img = r.run(spp)
    ref = oracle.render(r.proj, r.view, w, h, spp, bounces, 1.0)
    close = np.all(np.abs(img - ref) <= atol + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= min_match, (close.mean(), np.abs(img - ref).max())
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-3


@pytest.mark.parametrize("bounces", [1, 3])
def test_dense_renderer_matches_cpu_oracle(bounces):
    if bounces == 1:
        _oracle_parity(16, 12, spp=1, bounces=1, min_match=1.0, atol=1e-4)
    else:
        _oracle_parity(16, 12, spp=2, bounces=3, min_match=0.94, atol=2e-2)


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_every_carousel_name_renders(integrator, use_kernels):
    r = Renderer(compile_scene(scenes.build("box_balls"), device="cpu"),
                 RenderConfig(width=8, height=6, nb_bounces=3,
                              refract_ind=1.3, integrator=integrator,
                              use_kernels=use_kernels, device="cpu"))
    img = r.run(2)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert (img >= 0).all() and img.max() > 0

