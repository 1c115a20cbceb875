"""The port's entry points (graft_entry.py), the twins of the
repository's __graft_entry__.py, on the CPU:

  - `entry("cpu")` gives one forward pass of the montecarlo integrator
    with its example inputs, held against the JAX package's integrator
    on the same rays (the dense route both) by the megakernel protocol;
  - `dryrun_multichip(8, device="cpu")` runs the pixel-sharded pass, the
    sample-sharded pass, and the K1 and K2 routes (their plain versions)
    sharded, over 8 CPU shards; a mesh of 2 cards raises here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.models.registry import (
    get_integrator as jget_integrator)
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.graft_entry import (
    dryrun_multichip, entry)
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_megakernel_protocol)


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_entry_matches_jax_integrator():
    fn, args = entry("cpu")
    scene, origin, dirs, tc, pass_index, ior = args
    assert scene.device.type == "cpu" and dirs.shape == (32 * 24, 3)
    got = fn(*args).numpy()
    assert got.shape == (32 * 24, 3) and np.isfinite(got).all()
    assert (got >= 0).all() and got.max() > 0
    proj, view = default_rt_camera(32, 24)
    jo, jd, jtc = jcamera_rays(proj, view, 32, 24)
    want = np.asarray(jget_integrator("montecarlo")(
        jcompile(jscenes.build("box_diffuse")), jo, jd.reshape(-1, 3),
        jtc.reshape(-1, 2), jnp.int32(pass_index), nb_bounces=3,
        refract_ind=jnp.float32(ior)))
    assert_megakernel_protocol(want, got, "entry vs the JAX integrator")


def test_dryrun_multichip_on_cpu_shards():
    dryrun_multichip(8, device="cpu")
    with pytest.raises(RuntimeError, match="this host has 0"):
        dryrun_multichip(2)
