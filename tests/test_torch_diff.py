"""The port's differentiable rendering (render/diff.py) against the JAX
package's, on the CPU.

  - pixel_grads on the dense route against JAX pixel_grads(use_pallas=
    False) on box_diffuse 16x12, 2 passes, 6 bounces (tests/test_grad.py:
    18-31): every leaf within 1e-3 x its largest magnitude (1e-9 where a
    leaf is zero on both sides, as the IOR's is on this opaque scene);
  - (the fast route against JAX's is in tests/test_torch_diff_fast.py);
  - the fast route against the port's own dense route with
    tests/test_grad.py:187-198's tolerances (rtol 1e-4);
  - the finite-difference checks of tests/test_grad.py:39-91;
  - the fast route's IOR gap on box_balls 24x18 (tests/test_grad.py:
    203-240), and the rule that fit_ior forces the dense route, by
    behaviour: with the card assumed, fit_ior=True calls no trace_soa and
    fit_ior=False does;
  - the albedo recovery of tests/test_grad.py:102-121;
  - Adam: the port's first 5 losses within 1e-3 relative of JAX
    inverse_render_fit's from the same seed parameters, both dense.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.render import diff as jdiff
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.models import montecarlo as mc
from montecarlo_pathtracing_tpu_torch.render import diff
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene

W, H = 16, 12
N_PASSES, N_BOUNCES = 2, 6
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


@pytest.fixture(scope="module")
def setup():
    """(port scene, port rays, JAX scene, numpy rays) on box_diffuse."""
    o, d, tc = _rays(W, H)
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    rays = tuple(torch.as_tensor(a) for a in (o, d, tc))
    return dev, rays, jcompile(jscenes.build("box_diffuse")), (o, d, tc)


def _assert_leaves_close(got, ref):
    """Each leaf within REL x its largest magnitude; the albedo's gradient
    must be nonzero (paths reach the light)."""
    assert float(np.abs(np.asarray(ref.color)).max()) > 0, "vacuous"
    for name, g, r in zip(diff.SceneParams._fields, got, ref):
        g, r = g.detach().numpy(), np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all(), name
        tol = REL * max(float(np.abs(r).max()), 1e-6)
        assert np.abs(g - r).max() <= tol, (name, np.abs(g - r).max(), tol)


def test_dense_pixel_grads_match_jax(setup):
    dev, rays, jdev, (o, d, tc) = setup
    ref = jdiff.pixel_grads(jdev, jdiff.params_of(jdev), o, d, tc,
                            n_passes=N_PASSES, nb_bounces=N_BOUNCES,
                            use_pallas=False)
    got = diff.pixel_grads(dev, diff.params_of(dev), *rays,
                           n_passes=N_PASSES, nb_bounces=N_BOUNCES)
    _assert_leaves_close(got, ref)


def test_fast_path_grads_match_dense(setup):
    """tests/test_grad.py:162-200 on the port: on this opaque scene every
    leaf, the IOR's too, agrees between the detached-trace route and the
    dense one."""
    dev, rays, _, _ = setup
    p = diff.params_of(dev, refract_ind=1.3)
    g_dense = diff.pixel_grads(dev, p, *rays, n_passes=2, nb_bounces=5,
                               use_kernels=False)
    g_fast = diff.pixel_grads(dev, p, *rays, n_passes=2, nb_bounces=5,
                              use_kernels=True)
    for name, atol in (("color", 1e-7), ("mat", 1e-6), ("light_scale", 1e-7),
                       ("refract_ind", 1e-7)):
        np.testing.assert_allclose(getattr(g_fast, name).numpy(),
                                   getattr(g_dense, name).numpy(),
                                   rtol=1e-4, atol=atol, err_msg=name)
    assert float(g_dense.color.abs().max()) > 0


def _mean_lum(dev, rays, params):
    return float(diff.render_mean(dev, params, *rays, N_PASSES,
                                  N_BOUNCES).mean())


def _with(p, field, idx, e):
    t = getattr(p, field).clone()
    t[idx] += e
    return p._replace(**{field: t})


@pytest.mark.parametrize("field,idx", [("color", (1, 0)), ("mat", (0, 2))],
                         ids=["albedo", "emissivity"])
def test_grad_matches_finite_difference(setup, field, idx):
    """tests/test_grad.py:39-79: a wall quad's red albedo and the light's
    emissivity, eps 1e-2, rtol 0.05."""
    dev, rays, _, _ = setup
    p0 = diff.params_of(dev)
    g = diff.pixel_grads(dev, p0, *rays, n_passes=N_PASSES,
                         nb_bounces=N_BOUNCES)
    analytic = float(getattr(g, field)[idx])
    eps = 1e-2
    fd = (_mean_lum(dev, rays, _with(p0, field, idx, eps))
          - _mean_lum(dev, rays, _with(p0, field, idx, -eps))) / (2 * eps)
    assert np.isfinite(analytic)
    assert analytic != 0.0, "vacuous gradient test (no light-carrying path)"
    assert abs(analytic - fd) <= 0.05 * max(abs(fd), 1e-4), (analytic, fd)
    assert float(g.light_scale) != 0.0


def test_grad_roughness_and_ior_finite(setup):
    """tests/test_grad.py:82-99."""
    dev, rays, _, _ = setup
    g = diff.pixel_grads(dev, diff.params_of(dev), *rays, n_passes=N_PASSES,
                         nb_bounces=N_BOUNCES)
    assert torch.isfinite(g.mat).all()
    assert float(g.mat[:, 1].abs().max()) > 0.0
    assert np.isfinite(float(g.refract_ind))


def test_apply_params_is_out_of_place(setup):
    dev = setup[0]
    p = diff.params_of(dev)._replace(light_scale=torch.tensor(2.0))
    mat0 = dev.mat.clone()
    s = diff.apply_params(dev, p)
    torch.testing.assert_close(s.mat[:, 2], mat0[:, 2] * 2.0)
    torch.testing.assert_close(s.mat[:, [0, 1, 3]], mat0[:, [0, 1, 3]])
    assert torch.equal(dev.mat, mat0)
    assert (s.has_transparent, s.group_codes, s.nb_prims) == (
        dev.has_transparent, dev.group_codes, dev.nb_prims)


def test_fast_ior_gap_and_fit_ior_takes_the_dense_route(monkeypatch):
    """tests/test_grad.py:203-240 on box_balls 24x18: the dense IOR
    gradient is nonzero, the fast route's stays within 0.05 x it + 1e-7;
    and inverse_render_fit, with the card assumed, traces through the
    kernels (trace_soa) unless fit_ior asks for the dense route."""
    o, d, tc = (torch.as_tensor(a) for a in _rays(24, 18))
    dev = compile_scene(scenes.build("box_balls"), device="cpu")

    def lum(kernels):
        ior = torch.tensor(1.35, requires_grad=True)
        img = mc.raytrace(dev, o, d, tc, 0, nb_bounces=6, refract_ind=ior,
                          detach_sampling=True, use_kernels=kernels,
                          nondiff_trace=kernels)
        return float(torch.autograd.grad(img.mean(), ior)[0])

    g_dense, g_fast = lum(False), lum(True)
    assert abs(g_dense) > 1e-7, "vacuous: dense IOR gradient is zero"
    assert abs(g_fast) <= 0.05 * abs(g_dense) + 1e-7, (g_fast, g_dense)

    calls = []
    trace_soa = mc.trace_soa

    def counting(*args, **kw):
        calls.append(1)
        return trace_soa(*args, **kw)

    monkeypatch.setattr(mc, "trace_soa", counting)
    monkeypatch.setattr(diff, "_auto_fast", lambda scene: True)
    target = torch.zeros((d.shape[0], 3))
    for fit_ior, traced in ((True, False), (False, True)):
        calls.clear()
        diff.inverse_render_fit(dev, target, o, d, tc, prim_ids=[0], steps=1,
                                n_passes=1, nb_bounces=2, fit_ior=fit_ior)
        assert bool(calls) == traced, (fit_ior, len(calls))


def _cube_prim(dev):
    return int(dev.group_prim[dev.group_codes.index(2)][0])


def test_inverse_rendering_recovers_albedo(setup):
    """tests/test_grad.py:102-121: perturb one cube's albedo, recover it
    within 0.15 with the loss below 0.2x its start."""
    dev, rays, _, _ = setup
    p_true = diff.params_of(dev)
    target = diff.render_mean(dev, p_true, *rays, 2, 6)
    cube = _cube_prim(dev)
    color = p_true.color.clone()
    color[cube, :3] = torch.tensor([0.1, 0.6, 0.2])
    p_fit, losses = diff.inverse_render_fit(
        dev, target, *rays, prim_ids=[cube], steps=60, lr=5e-2, n_passes=2,
        nb_bounces=6, seed_params=p_true._replace(color=color))
    assert len(losses) == 60 and all(isinstance(x, float) for x in losses)
    assert losses[-1] < losses[0] * 0.2, losses[::10]
    got = p_fit.color[cube, :3].numpy()
    want = p_true.color[cube, :3].numpy()
    assert np.abs(got - want).max() < 0.15, (got, want)
    # only the fitted row's albedo moved
    others = torch.ones(dev.nb_prims, dtype=torch.bool)
    others[cube] = False
    assert torch.equal(p_fit.color[others], p_true.color[others])
    assert torch.equal(p_fit.mat, p_true.mat)


def test_adam_losses_match_jax(setup):
    dev, rays, jdev, (o, d, tc) = setup
    cube = _cube_prim(dev)
    pj = jdiff.params_of(jdev)
    jtarget = jdiff.render_mean(jdev, pj, o, d, tc, 2, 6)
    pj = pj._replace(color=pj.color.at[cube, :3].set(
        jnp.array([0.1, 0.6, 0.2])))
    _, ref = jdiff.inverse_render_fit(
        jdev, jtarget, o, d, tc, prim_ids=[cube], steps=5, lr=5e-2,
        n_passes=2, nb_bounces=6, seed_params=pj, use_pallas=False)
    p = diff.params_of(dev)
    target = diff.render_mean(dev, p, *rays, 2, 6).detach()
    color = p.color.clone()
    color[cube, :3] = torch.tensor([0.1, 0.6, 0.2])
    _, got = diff.inverse_render_fit(
        dev, target, *rays, prim_ids=[cube], steps=5, lr=5e-2, n_passes=2,
        nb_bounces=6, seed_params=p._replace(color=color), use_kernels=False)
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    assert got[-1] < got[0]
