"""The port's scalar CPU oracle (testing/cpu_ref.py) on the CPU.

  - against the JAX package's CPUReference, BIT for bit (both are numpy
    float32): `trace` (every field of the hit), `intersection_info` and
    `raytrace` on 40 pixels each of box_diffuse, box_balls at IOR 1.3
    and mesh_demo, passes 0 and 5;
  - the port's montecarlo integrator on its kernel route (the plain K1 on
    the CPU) against the port's oracle by tests/test_parity.py's
    protocol: with 1 bounce every pixel within 1e-4 (the image is
    deterministic), with 4 bounces 94% within 2e-2 abs + 1e-3 rel and
    image means within 5e-3.
"""
import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu.testing import cpu_ref as jcpu_ref
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays_np, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.cpu_ref import CPUReference

W, H, N_PIXELS, BOUNCES = 24, 18, 40, 5
CASES = {"box_diffuse": 1.0, "box_balls": 1.3, "mesh_demo": 1.0}
HIT_FIELDS = ("dist", "pl", "pg", "prim", "shape", "dircode", "tri",
              "mesh_inst")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _oracles(name):
    """(the port's oracle, JAX's) over the scene after the emissive sort
    that compile_scene makes in place."""
    prims, jprims = scenes.build(name), jscenes.build(name)
    compile_scene(prims, device="cpu")
    jcompile(jprims)
    return CPUReference(prims), jcpu_ref.CPUReference(jprims)


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_bit_equal_to_jax(name):
    ours, theirs = _oracles(name)
    ior = CASES[name]
    proj, view = default_rt_camera(W, H)
    origin, dirs, tc = camera_rays_np(proj, view, W, H)
    pick = np.random.default_rng(11).choice(W * H, N_PIXELS, replace=False)
    hits = tri_hits = 0
    for i in pick:
        y, x = divmod(int(i), W)
        d = dirs[y, x]
        a, b = ours.trace(origin, d), theirs.trace(origin, d)
        for f in HIT_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{name} pixel {i} {f}")
        hits += a.shape >= 0
        tri_hits += a.tri >= 0
        for x_, y_ in zip(ours.intersection_info(a),
                          theirs.intersection_info(b)):
            np.testing.assert_array_equal(x_, y_)
        for p in (0, 5):
            np.testing.assert_array_equal(
                ours.raytrace(d, origin, tc[y, x, 0], tc[y, x, 1], p,
                              BOUNCES, ior),
                theirs.raytrace(d, origin, tc[y, x, 0], tc[y, x, 1], p,
                                BOUNCES, ior))
    assert hits > N_PIXELS // 2
    assert (tri_hits > 0) == (name == "mesh_demo")


@pytest.mark.parametrize("bounces,spp,min_match,atol",
                         [(1, 1, 1.0, 1e-4), (4, 2, 0.94, 2e-2)])
def test_kernel_route_matches_oracle(bounces, spp, min_match, atol):
    """tests/test_parity.py's _parity with the port's Renderer on its
    default (kernel) route."""
    w, h = 16, 12
    prims = scenes.build("box_diffuse")
    dev = compile_scene(prims, device="cpu")     # sorts emissives in place
    r = Renderer(dev, RenderConfig(width=w, height=h, nb_bounces=bounces,
                                   device="cpu"))
    assert r.route["use_kernels"]
    img = r.run(spp)
    ref = CPUReference(prims).render(r.proj, r.view, w, h, spp, bounces)
    close = np.all(np.abs(img - ref) <= atol + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= min_match, (close.mean(), np.abs(img - ref).max())
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-3
