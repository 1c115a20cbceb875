"""Build and load the port's CUDA kernels.

Each kernel source in csrc/ has a plain C interface. It is compiled by
`nvcc` into a shared library under _build/ at first use, named by a hash
of the source, every header it includes from csrc/ and the flags (a
changed source or header builds anew), and loaded with ctypes. `build_all`
starts one nvcc per source at once and waits for all of them. Nothing is
built or loaded at import time, so the package imports on machines
without nvcc or a GPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

from .utils.profiling import span

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# IEEE float math on purpose (no --use_fast_math): the kernels divide by
# zero and rely on inf/nan being masked afterwards, as the reference does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per source: the trace kernels round every multiply and add on its own, as
# their plain versions do. Their results are world distances reconstructed
# from hit points in the prim's frame, which cancel badly for rays far from
# a prim: built with contracted multiply-adds they moved by up to 1.5e-3
# relative against the plain versions on an H100, past the reference's own
# 5e-4 between its folds. chip_smoke.py times both builds in one call.
EXTRA_FLAGS = {"trace_kernels": ("-fmad=false",)}
# K2's counting build: the same kernel with its work counters compiled in
# (held in registers, they slow it even when nothing is counted)
K2_COUNTS = ("-DK2_COUNTS",)

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def sources(name: str) -> list:
    """csrc/<name>.cu and every csrc/ header it includes, transitively."""
    out, todo = [], [name + ".cu"]
    while todo:
        path = os.path.join(CSRC, todo.pop())
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return out


def _flags(name: str, extra=()) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ()) + tuple(extra)


def library_path(name: str, extra=()) -> str:
    """Where the build of csrc/<name>.cu with its current sources and
    flags (and the `extra` flags of a variant build) lives."""
    h = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(_flags(name, extra)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def on_device(device):
    """Make `device` the CUDA runtime's current device around a launch (a
    no-op on any other device). Each wrapper passes its tensors' stream,
    but the host code reads the current device: K1 takes its SM count,
    sets its dynamic shared-memory attribute and finds its `next_ray`
    counter there, K2 its resident block count. The SM and resident
    counts are cached per card on its first launch there."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def count_launch(wrapper, device) -> None:
    """Count one launch of `wrapper`'s kernel, in `wrapper.launches` and
    by card in `wrapper.launches_on[str(device)]`."""
    wrapper.launches += 1
    wrapper.launches_on[str(device)] += 1


def host_tensor(data, dtype, device) -> torch.Tensor:
    """`data` (a list or array on the host) as a tensor on `device`,
    without waiting for the card: torch.tensor(data, device=card) copies
    through a synchronous cudaMemcpy, which waits for everything queued
    on the card's stream. Here the copy leaves from pinned memory and is
    queued on the card's current stream."""
    t = torch.as_tensor(data, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def build_all(names, variants=()) -> dict:
    """Compile every csrc/<name>.cu whose hash is new, and every variant
    build (name, extra flags), one nvcc process per build, all started
    together. Returns {name or (name, extra): library path}. The
    compiler's report (registers, spills) is kept beside each library as
    <library>.log."""
    builds = [(name, ()) for name in names] + [
        (name, tuple(extra)) for name, extra in variants]
    paths = {(name if not extra else (name, extra)): library_path(name, extra)
             for name, extra in builds}
    jobs = []
    for name, extra in builds:
        out = library_path(name, extra)
        if os.path.exists(out) or any(j[1] == out for j in jobs):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, name + ".cu")
        proc = subprocess.Popen([nvcc(), *_flags(name, extra), "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc, time.perf_counter()))
    failed = []
    for src, out, tmp, proc, t0 in jobs:
        # the jobs run at once: each span is the wait for its job
        with span("kernels.build", library=os.path.basename(out)):
            report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{report}")
            continue
        with open(out + ".log", "w") as f:
            f.write(f"built in {time.perf_counter() - t0:.1f} s\n{report}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str, extra=()) -> str:
    """build_all of one source (or variant): its shared library's path."""
    return build_all([], [(name, extra)])[
        (name, tuple(extra)) if extra else name]


def build_log(name: str, extra=()) -> str:
    """The compiler's report of the last build of csrc/<name>.cu."""
    with open(build(name, extra) + ".log") as f:
        return f.read()


def _load(name: str, extra, bind) -> ctypes.CDLL:
    """csrc/<name>.cu (with a variant's extra flags), built, loaded and
    given its argument types by bind(lib) once per process."""
    key = (name, tuple(extra)) if extra else name
    lib = _loaded.get(key)
    if lib is None:
        with span("kernels.load", library=name + "".join(extra)):
            lib = ctypes.CDLL(build(name, extra))
            bind(lib)
        _loaded[key] = lib
    return lib


def _bind_megakernel(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mega_pass.argtypes = [p, p, p, ctypes.c_uint32, p, i, p, i, p,
                              p, i, i, i, i, i, p, p]
    lib.mega_pass.restype = ctypes.c_int
    # has_transparent, cull, P, S, out [6] i32
    lib.mega_kernel_info.argtypes = [i, i, i, i, p]
    lib.mega_kernel_info.restype = ctypes.c_int
    lib.mega_error_string.argtypes = [ctypes.c_int]
    lib.mega_error_string.restype = ctypes.c_char_p


def megakernel_lib() -> ctypes.CDLL:
    """K1 (csrc/megakernel.cu), built and loaded once per process."""
    return _load("megakernel", (), _bind_megakernel)


def _bind_bounce_kernel(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_call.argtypes = [
        p, p, i, ctypes.c_float,            # stf, sti, M, ior
        p, i, p, i, p, i,                   # tab P, gsbb Sg, groups G
        p, p, i,                            # msc, msi, n_mesh
        p, i, p, i, p,                      # cbb Cm, sbb Sm, tpool
        p, i, p, i, p,                      # acbb Ca, asbb Sa, apool
        p, p, i,                            # agr, ana, A
        p, p, i, i, i,                      # ord, ent, Stot, mesh_stot,
                                            # sched_base
        i, i, i, i,                         # whole_path, transparent,
                                            # flat_face, cull_small
        p, i,                               # n_scan, lanes per ray
        p, p]                               # counts, stream
    lib.fused_call.restype = ctypes.c_int
    lib.fused_schedule.argtypes = [
        p, i, p, p, i,                      # stf, M, msc, msi, n_mesh
        p, i, p, i, p, i,                   # sbb Sm, ana A, asbb Sa
        p, i, p, i, i,                      # groups G, gsbb Sg, cull_small
        i, i, i,                            # mesh_stot, sched_base, Stot
        p, p, p, p]                         # ord, ent, scratch, stream
    lib.fused_schedule.restype = ctypes.c_int
    lib.fused_shape_rule.argtypes = [p]
    lib.fused_shape_rule.restype = None
    lib.fused_error_string.argtypes = [ctypes.c_int]
    lib.fused_error_string.restype = ctypes.c_char_p


def bounce_kernel_lib(counts: bool = False) -> ctypes.CDLL:
    """K2 and its schedule kernel (csrc/bounce_kernel.cu), built and loaded
    once per process; with `counts`, its counting build (K2_COUNTS)."""
    return _load("bounce_kernel", K2_COUNTS if counts else (),
                 _bind_bounce_kernel)


def _bind_trace_kernels(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # o, d, M, inv, trf, pid, ppad, shape, dist, row, a, dir, counts,
    # stream
    lib.group_best.argtypes = [p, p, i, p, p, p, i, i, p, p, p, p, p, p]
    # o, d, M, inv, trf, pid, ppad, cbb, sbb, nsuper, shape, dist, row,
    # a, dir, counts, stream
    lib.group_best_culled.argtypes = [p, p, i, p, p, p, i, p, p, i, i, p, p,
                                      p, p, p, p]
    # o, d, M, tri, ppad, a, row, counts, stream
    lib.mesh_best.argtypes = [p, p, i, p, i, p, p, p, p]
    # o, d, M, tri, ppad, cbb, sbb, nsuper, st, lanes, a, row, counts,
    # stream
    lib.mesh_best_culled.argtypes = [p, p, i, p, i, p, p, i, p, i, p, p, p,
                                     p]
    # o, d, M, tab, sbb, nblk, order, tlo, S, bound, shape, dist, row,
    # a, dir, counts, per_ray, stream
    lib.an_fold.argtypes = [p, p, i, p, p, i, p, p, i, p, i, p, p, p, p,
                            p, i, p]
    # o, d, M, tri, ppad, order, tlo, S, bound, a, row, counts, stream
    lib.mesh_fold.argtypes = [p, p, i, p, i, p, p, i, p, p, p, p, p]
    for fn in (lib.group_best, lib.group_best_culled, lib.mesh_best,
               lib.mesh_best_culled, lib.an_fold, lib.mesh_fold):
        fn.restype = ctypes.c_int
    # kernel (0 K3a, 1 K4a, 2 K3b, 3 K6, 4 K4b, 5 K5), shape, out [6] i32
    lib.trace_kernel_info.argtypes = [i, i, p]
    lib.trace_kernel_info.restype = ctypes.c_int
    lib.trace_error_string.argtypes = [ctypes.c_int]
    lib.trace_error_string.restype = ctypes.c_char_p


def trace_kernels_lib() -> ctypes.CDLL:
    """K3a, K3b, K4a, K4b, K5 and K6 (csrc/trace_kernels.cu), built and
    loaded once per process."""
    return _load("trace_kernels", (), _bind_trace_kernels)
