"""Integrator "models" — the analog of the reference's tp/*.frag carousel
(MontecarloGPU/montecarlo.cpp:27). Each integrator is a plain function on
tensors; the megakernel route runs a whole pass in one CUDA launch."""
from .registry import INTEGRATORS, get_integrator  # noqa: F401
