"""The pallas-trace route end to end: the port's
`models.montecarlo.raytrace(use_kernels=True, use_megakernel=False,
use_fused=False)` (the trace kernels' plain versions on CPU tensors)
against the JAX package's `raytrace(use_pallas=True,
pallas_interpret=True, use_megakernel=False, use_fused=False)`, the
Renderer's route against the JAX renderer's level 0, and a
detach_sampling render, which takes the route.

Tolerance: the fused protocol of the reference (tests/test_bounce_kernel.
py:36-45), at most 0.5% of pixels more than 1e-3 off. The RNG streams are
bit-equal; only float rounding differs between XLA and torch, and a
last-ulp flip at an edge can send a path another way.

The JAX reference is compiled at XLA's lowest backend optimisation
level: its CPU compile of the interpret-mode kernels inside the bounce
loop is most of its time, about 40 s of 50 at the default level, and
does not shrink with the image or the bounce count. The lower level
computes the same program, up to float rounding.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.models.montecarlo import raytrace as jraytrace
from montecarlo_pathtracing_tpu.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu.render.renderer import (
    RenderConfig as JRenderConfig, Renderer as JRenderer)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.models import montecarlo as mc
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    FUSED_FRAC, assert_fused_protocol)

# (scene, width, height, IOR): colonnes at the size of the reference's
# own route test (tests/test_sorted_wavefront.py:41-53): K5 for its two
# large groups; mesh_demo: K6 for its three instances, the re-trace
ROUTE_CASES = [("colonnes", 48, 32, 1.0), ("mesh_demo", 16, 12, 1.3)]
BOUNCES, PASS = 3, 1


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rays(w, h):
    proj, view = default_rt_camera(w, h)
    o, d, tc = (np.array(a) for a in camera_rays(proj, view, w, h))
    return o, d.reshape(-1, 3), tc.reshape(-1, 2)


def _jax_route(name, o, d, tc, ior):
    """The JAX package's pallas-trace route on scene `name`, compiled at
    XLA's lowest backend optimisation level."""
    fn = jax.jit(functools.partial(
        jraytrace, jcompile(jscenes.build(name)), nb_bounces=BOUNCES,
        refract_ind=ior, use_pallas=True, pallas_interpret=True,
        use_megakernel=False, use_fused=False))
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tc), PASS)
    compiled = fn.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return np.asarray(compiled(*args))


@pytest.mark.parametrize("name,w,h,ior", ROUTE_CASES)
def test_route_matches_jax(name, w, h, ior):
    o, d, tc = _rays(w, h)
    ref = _jax_route(name, o, d, tc, ior)
    got = mc.raytrace(
        compile_scene(scenes.build(name), device="cpu"), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(tc), PASS, nb_bounces=BOUNCES,
        refract_ind=ior, use_kernels=True, use_megakernel=False,
        use_fused=False).numpy()
    assert got.shape == ref.shape == (w * h, 3)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert ref.mean() > 0.05                 # paths reach the light
    assert_fused_protocol(ref, got, name, FUSED_FRAC)


# (use_kernels, use_megakernel, cull_chunks): auto, the pallas-trace route
# with the brute folds, the forced megakernel, kernels off, and the forced
# megakernel with kernels off (forced all the same)
LEVEL_CASES = [(True, None, None), (True, False, False), (True, True, True),
               (False, None, None), (False, True, None)]


@pytest.mark.parametrize("kernels,mega,cull", LEVEL_CASES)
def test_renderer_route_is_jax_level_0(kernels, mega, cull):
    """The port's routing keywords are the JAX renderer's level 0
    (render/renderer.py:154-171) with its cull_chunks (:195)."""
    jr = JRenderer(jcompile(jscenes.build("box_diffuse")),
                   JRenderConfig(width=8, height=8, use_pallas=kernels,
                                 use_megakernel=mega, cull_chunks=cull))
    level = jr._levels[0][1]
    r = Renderer(compile_scene(scenes.build("box_diffuse"), device="cpu"),
                 RenderConfig(width=8, height=8, use_kernels=kernels,
                              use_megakernel=mega, cull_chunks=cull,
                              device="cpu"))
    route = r.route
    assert route["use_kernels"] == level["use_pallas"]
    assert (route["use_megakernel"], route["use_fused"],
            route["cull_chunks"]) == (level["use_megakernel"],
                                      level["use_fused"],
                                      jr.config.cull_chunks)


def _count_traces(monkeypatch):
    """Record the cull_chunks of every trace the route makes."""
    seen = []
    real = mc.trace_soa

    def recording(scene, o, d, *, cull_chunks=None):
        seen.append(cull_chunks)
        return real(scene, o, d, cull_chunks=cull_chunks)

    monkeypatch.setattr(mc, "trace_soa", recording)
    return seen


def test_renderer_use_megakernel_false_takes_pallas_trace(monkeypatch):
    """RenderConfig(use_megakernel=False) on mesh_demo runs the
    pallas-trace route, as the JAX renderer's level 0 does (not the fused
    route), and cull_chunks reaches trace_soa."""
    dev = compile_scene(scenes.build("mesh_demo"), device="cpu")
    cfg = RenderConfig(width=16, height=12, nb_bounces=2, refract_ind=1.3,
                       use_megakernel=False, cull_chunks=False, device="cpu")
    seen = _count_traces(monkeypatch)
    r = Renderer(dev, cfg)
    img = r.run(1)
    # one pass, one tile, 2 bounces, 2 traces each (transparent scene)
    assert seen == [False] * 4
    monkeypatch.undo()
    ref = mc.raytrace(dev, r._origin, r._dirs[0], r._tc[0], 0, nb_bounces=2,
                      refract_ind=1.3, use_kernels=True, use_megakernel=False,
                      use_fused=False, cull_chunks=False)
    acc = torch.zeros_like(r._accs[0])
    acc[0] += ref
    np.testing.assert_array_equal(img, r.resolve(acc, 1))


def test_detach_sampling_render_takes_the_route(monkeypatch):
    """detach_sampling rules out the megakernel and fused routes, so a
    kernel render takes the pallas-trace route with its wavefront unsorted
    and its traces detached, as the reference's does (models/montecarlo.py:
    299-330). Detaching changes no forward value: the image is the route's
    own, bit for bit."""
    dev = compile_scene(scenes.build("mesh_demo"), device="cpu")
    cfg = RenderConfig(width=16, height=12, nb_bounces=3, refract_ind=1.3,
                       detach_sampling=True, device="cpu")
    seen = _count_traces(monkeypatch)
    r = Renderer(dev, cfg)
    img = r.run(1)
    assert len(seen) == 6                   # 3 bounces x 2 traces, no K2
    monkeypatch.undo()
    ref = mc.raytrace(dev, r._origin, r._dirs[0], r._tc[0], 0, nb_bounces=3,
                      refract_ind=1.3, use_kernels=True, use_megakernel=False,
                      use_fused=False, sort_rays=False)
    acc = torch.zeros_like(r._accs[0])
    acc[0] += ref
    np.testing.assert_array_equal(img, r.resolve(acc, 1))
    assert np.isfinite(img).all() and img.mean() > 0.05
