"""ctypes loader for the native BVH builder (bvh_builder.cpp).

Port of montecarlo_pathtracing_tpu/native/bvh_native.py. The shared
library is compiled on first use with g++ (plain C ABI + ctypes) into the
package's git-ignored build directory (kernels.BUILD_DIR), named by a hash
of the source and the flags as kernels.py names the CUDA libraries, and
loaded once per process. `build` returns None when no compiler or library
is available; scene/bvh_builder.py then decides whether that may fall
back to the numpy builder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .. import kernels

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bvh_builder.cpp")
FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_libs: dict = {}


def library_path() -> str:
    """Where the build of bvh_builder.cpp with its current source and
    flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(kernels.BUILD_DIR,
                        f"bvh_builder-{h.hexdigest()[:16]}.so")


def _bind(lib):
    lib.mpt_bvh_depth.restype = ctypes.c_int
    lib.mpt_bvh_depth.argtypes = [ctypes.c_int]
    lib.mpt_build_bvh.restype = None
    lib.mpt_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]


def load() -> ctypes.CDLL:
    """The library, built if its hash is new, loaded once per process.
    Raises when it cannot be built or loaded."""
    path = library_path()
    with _lock:
        lib = _libs.get(path)
        if lib is None:
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *FLAGS, "-o", tmp, _SRC], check=True,
                               capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _libs[path] = lib
    return lib


def build(centers, bbmin, bbmax):
    """Returns a scene.bvh_builder.BVH, or None when the library cannot be
    built or loaded or the input is empty."""
    from ..scene.bvh_builder import BVH

    try:
        lib = load()
    except (OSError, subprocess.CalledProcessError):
        return None
    n = int(centers.shape[0])
    if n == 0:
        return None
    centers = np.ascontiguousarray(centers, np.float32)
    bbmin = np.ascontiguousarray(bbmin, np.float32)
    bbmax = np.ascontiguousarray(bbmax, np.float32)
    depth = lib.mpt_bvh_depth(n)
    sz_leaf = 1 << depth
    sz = 2 * sz_leaf - 1
    out_min = np.empty((sz, 3), np.float32)
    out_max = np.empty((sz, 3), np.float32)
    leaf = np.empty(sz_leaf, np.int32)

    def p(a, t=ctypes.c_float):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.mpt_build_bvh(p(centers), p(bbmin), p(bbmax), n,
                      p(out_min), p(out_max), p(leaf, ctypes.c_int32))
    return BVH(out_min, out_max, leaf, depth)
