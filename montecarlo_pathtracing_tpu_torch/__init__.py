"""montecarlo_pathtracing_tpu_torch — the PyTorch/CUDA port of the path tracer.

A second package beside montecarlo_pathtracing_tpu (the JAX reference).
It keeps the reference's layout and module names, so each module has a
counterpart there, and runs on an NVIDIA Hopper GPU: the TPU's Pallas
kernels become kernels written by hand for sm_90a (csrc/), built at first
use by kernels.py. On the CPU every kernel wrapper runs its plain PyTorch
version instead, which is what the CPU tests hold against the JAX package.

Layer map:
  ops/       RNG, shape tests, bundle/box helpers, constants
  scene/     host scene builder, demo scenes, device compile, BVH builder
  models/    integrators, the megakernel and fused routes, the sampling
             visualizer and debug views
  render/    camera + progressive renderer + checkpointing, gradients
  utils/     transforms, PNG IO, profiling
  native/    the BVH builder in C++ (g++)
  csrc/      CUDA C++ kernels (sm_90a)
  cli.py     the command line (python -m montecarlo_pathtracing_tpu_torch)

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from .scene.scene import Material, ScenePrimitives  # noqa: F401
from .scene import scenes  # noqa: F401
