"""Entry points: a single-device forward pass and a multi-device dry run.

Twin of the repository's __graft_entry__.py for the port: `entry` gives
one progressive pass of the flagship integrator with its example inputs,
and `dryrun_multichip` runs the distributed render/accumulate step over
an n-device mesh at tiny shapes. Both run on the card unless the caller
names the CPU, where the kernels' plain versions run.
"""
from __future__ import annotations

import torch

from .models.registry import get_integrator
from .parallel.sharding import (make_mesh, make_sample_sharded_pass,
                                make_sharded_pass, shard_rays)
from .render.camera import camera_rays, default_rt_camera
from .scene import scenes
from .scene.device import compile_scene


def _tiny_setup(device, name="box_diffuse", w=32, h=24):
    dev = compile_scene(scenes.build(name), device=device)
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h, device=device)
    return dev, origin, dirs.reshape(-1, 3), tc.reshape(-1, 2)


def entry(device="cuda"):
    """(fn, example_args): one forward pass of the flagship montecarlo
    integrator (1 spp progressive pass over a ray batch) on `device`."""
    dev, origin, dirs, tc = _tiny_setup(device)
    integrator = get_integrator("montecarlo")

    def fn(scene, origin, dirs, tc, pass_index, refract_ind):
        return integrator(scene, origin, dirs, tc, pass_index,
                          nb_bounces=3, refract_ind=refract_ind)

    return fn, (dev, origin, dirs, tc, 0, 1.0)


def _sharded(mesh, scene, dirs, tc, origin, route=None):
    """One pixel-sharded pass (pass 0, 2 bounces) over the mesh: the
    accumulator shards, checked finite."""
    sdirs, stc, _ = shard_rays(mesh, dirs, tc)
    acc = [torch.zeros_like(d) for d in sdirs]
    fn = make_sharded_pass(mesh, nb_bounces=2, route=route)
    acc = fn(scene, acc, sdirs, stc, origin, 0, 1.0)
    if not all(torch.isfinite(a).all() for a in acc):
        raise AssertionError(f"sharded pass on route {route}: not finite")
    return acc


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the distributed render/accumulate step over an n-device mesh
    once on tiny shapes (32x24, 2 bounces) and check the results finite:
    the pixel-sharded pass on the dense route, the sample-sharded pass,
    and the kernel routes real renders use under pixel sharding: the
    megakernel K1 and, on a mesh scene, the fused bounce kernel K2."""
    mesh = make_mesh(n_devices, device)
    dev, origin, dirs, tc = _tiny_setup(device)

    # axis 1: pixel/ray sharding (the primary DP axis)
    _sharded(mesh, dev, dirs, tc, origin)

    # axis 2: sample-axis DP, the partial images summed onto shard 0
    sfn = make_sample_sharded_pass(mesh, nb_bounces=2)
    rgb = sfn(dev, dirs, tc, origin, 0, 1.0)
    if not torch.isfinite(rgb).all():
        raise AssertionError("sample-sharded pass: not finite")

    # the kernel routes under pixel sharding
    _sharded(mesh, dev, dirs, tc, origin,
             route=dict(use_kernels=True, use_megakernel=True))
    mdev, *_ = _tiny_setup(device, "mesh_demo")
    _sharded(mesh, mdev, dirs, tc, origin,
             route=dict(use_kernels=True, use_megakernel=False,
                        use_fused=True))
