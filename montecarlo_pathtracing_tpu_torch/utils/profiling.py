"""Profiling & observability — the FPS-counter/GPU-memory-query layer.

Port of montecarlo_pathtracing_tpu/utils/profiling.py. The reference's
only instruments are an FPS average over 50-frame windows
(easycppogl/gl_viewer.cpp:412-418), a BVH-build wall-time print
(MontecarloGPU/montecarlo.cpp:354-363), and NVX GPU-memory queries
(gl_viewer.cpp:443-452). Their counterparts here:

  - PassTimer: windowed passes/s + rays/s counters (the FPS analog)
  - trace_context: a torch.profiler trace (CPU and CUDA activities)
    exported as a Chrome trace into a directory
  - device_memory_stats: per-card memory counters (the NVX query analog)
  - timed_block: wall time of a call that waits for the card
  - enable_compilation_cache: where the kernels' builds are kept
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch

from .. import kernels


class PassTimer:
    """Windowed throughput counter (50-pass window like the reference's
    50-frame FPS window)."""

    def __init__(self, rays_per_pass: int, window: int = 50):
        self.rays_per_pass = rays_per_pass
        self.times = deque(maxlen=window + 1)

    def tick(self):
        self.times.append(time.perf_counter())

    @property
    def passes_per_s(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / dt if dt > 0 else 0.0

    @property
    def rays_per_s(self) -> float:
        return self.passes_per_s * self.rays_per_pass


@contextlib.contextmanager
def trace_context(logdir: str):
    """torch.profiler over the block, with CPU and (where there is a
    card) CUDA activities; the trace is written to <logdir>/trace.json
    (chrome://tracing, Perfetto). Yields the profiler, whose
    key_averages() sum the time by op and kernel."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats of each visible card, keyed "cuda:i"
    (bytes and counts); empty when there is no card."""
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def _cuda_devices(out, found):
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def timed_block(fn, *args, sync=True):
    """(result, seconds). Launches return before the card has finished,
    so with `sync` the clock stops after torch.cuda.synchronize() on
    each card that holds a returned tensor (none for CPU tensors)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if sync:
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def enable_compilation_cache(path: str | None = None) -> None:
    """Keep the kernels' builds in `path`: nvcc's shared libraries (and
    the native BVH builder's), named by a hash of their sources and
    flags, are built there at first use and loaded from there by every
    later process (kernels.BUILD_DIR). Without a path the package's
    _build/ stays. Builds nothing by itself. Called by the CLI; opt out
    with MCPT_NO_COMPILE_CACHE=1."""
    if os.environ.get("MCPT_NO_COMPILE_CACHE") or path is None:
        return
    kernels.BUILD_DIR = os.path.abspath(path)
