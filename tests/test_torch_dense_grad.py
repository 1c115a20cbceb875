"""The dense route's IOR gradient against the JAX package's, on the CPU.

The dense route is the one route whose trace stays in the backward pass,
so the gradient of an image with respect to the IOR slider carries the
geometric term through the refraction exit points (the pallas-trace
route detaches its trace and drops it, tests/test_grad.py:203). On
box_balls at 24x18, 6 bounces, pass 0, with the sampled directions
detached, as tests/test_grad.py:203 takes it: the port's gradient of the
image mean is finite, nonzero, and within 1e-3 relative of jax.grad of
the JAX dense route (a sum over the image of paths that XLA and torch
round differently).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from montecarlo_pathtracing_tpu.models.montecarlo import raytrace as jraytrace
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene

W, H, BOUNCES, IOR = 24, 18, 6, 1.35


def test_dense_route_carries_the_ior_gradient():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        proj, view = default_rt_camera(W, H)
        o, d, tc = jcamera_rays(proj, view, W, H)
        o, d, tc = (np.asarray(o), np.asarray(d).reshape(-1, 3),
                    np.asarray(tc).reshape(-1, 2))
        jdev = jcompile(jscenes.build("box_balls"))

        def jmean(ior):
            return jraytrace(jdev, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tc), 0, nb_bounces=BOUNCES,
                             refract_ind=ior, detach_sampling=True).mean()

        ref = float(jax.jit(jax.grad(jmean))(jnp.float32(IOR)))
        dev = compile_scene(scenes.build("box_balls"), device="cpu")
        ior = torch.tensor(IOR, requires_grad=True)
        img = raytrace(dev, torch.tensor(o), torch.tensor(d),
                       torch.tensor(tc), 0, nb_bounces=BOUNCES,
                       refract_ind=ior, detach_sampling=True)
        got, = torch.autograd.grad(img.mean(), ior)
    finally:
        torch.set_num_threads(prev)
    got = float(got)
    assert np.isfinite(got) and abs(ref) > 1e-7, (got, ref)
    assert abs(got - ref) <= 1e-3 * abs(ref), (got, ref)
