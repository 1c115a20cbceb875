"""The port's fast gradient route against the JAX package's, on the CPU:
pixel_grads(use_kernels=True) (the pallas-trace route with its trace
detached, the trace kernels' plain versions on CPU tensors) against JAX
render_mean(use_pallas=True, pallas_interpret=True) under jax.grad, every
leaf within 1e-3 x its largest magnitude (1e-9 where a leaf is zero on
both sides), on

  - box_diffuse, as tests/test_grad.py:162 takes it: its groups are at
    most SMALL_GROUP_MAX prims, so _small_group_soa traces and no kernel
    runs;
  - colonnes, whose two large groups take K5's plain version;
  - mesh_demo, whose instances take K6's.

The calls of the K5 and K6 ops are counted, so a case cannot pass on
another trace than the one named. The JAX side is compiled at XLA's
lowest backend optimisation level, as tests/test_torch_pallas_route.py
does, for time.
"""
import numpy as np
import jax
import pytest
import torch

from montecarlo_pathtracing_tpu.render import diff as jdiff
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.ops import trace as trace_ops
from montecarlo_pathtracing_tpu_torch.render import diff
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene

REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rays(w, h):
    proj, view = default_rt_camera(w, h)
    o, d, tc = (np.array(a) for a in jcamera_rays(proj, view, w, h))
    return o, d.reshape(-1, 3), tc.reshape(-1, 2)


def _assert_leaves_close(got, ref):
    """Each leaf within REL x its largest magnitude; the albedo's gradient
    must be nonzero (paths reach the light)."""
    assert float(np.abs(np.asarray(ref.color)).max()) > 0, "vacuous"
    for name, g, r in zip(diff.SceneParams._fields, got, ref):
        g, r = g.detach().numpy(), np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all(), name
        tol = REL * max(float(np.abs(r).max()), 1e-6)
        assert np.abs(g - r).max() <= tol, (name, np.abs(g - r).max(), tol)


# (scene, width, height, passes, bounces, IOR, K5 and K6 op calls
# expected). The rays pad to one 1024-ray tile, so the sparse walks' tile
# rules hold.
FAST_CASES = [("box_diffuse", 16, 12, 2, 5, 1.3, (False, False)),
              ("colonnes", 16, 12, 1, 3, 1.0, (True, False)),
              ("mesh_demo", 16, 12, 1, 3, 1.3, (False, True))]


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("name,w,h,n_passes,n_bounces,ior,walks", FAST_CASES,
                         ids=[c[0] for c in FAST_CASES])
def test_fast_pixel_grads_match_jax(monkeypatch, name, w, h, n_passes,
                                    n_bounces, ior, walks):
    o, d, tc = _rays(w, h)
    jdev = jcompile(jscenes.build(name))
    p = jdiff.params_of(jdev, refract_ind=ior)

    def mean_lum(pp):
        return jdiff.render_mean(jdev, pp, o, d, tc, n_passes, n_bounces,
                                 "montecarlo", True, True).mean()

    grad = jax.jit(jax.grad(mean_lum)).lower(p).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    ref = grad(p)

    calls = {"group_best_rows_sparse": 0, "mesh_best_rows_sparse": 0}
    for fn in calls:
        _counting(monkeypatch, trace_ops, fn, calls)
    dev = compile_scene(scenes.build(name), device="cpu")
    got = diff.pixel_grads(dev, diff.params_of(dev, refract_ind=ior),
                           *(torch.as_tensor(a) for a in (o, d, tc)),
                           n_passes=n_passes, nb_bounces=n_bounces,
                           use_kernels=True)
    assert (calls["group_best_rows_sparse"] > 0,
            calls["mesh_best_rows_sparse"] > 0) == walks, calls
    _assert_leaves_close(got, ref)
