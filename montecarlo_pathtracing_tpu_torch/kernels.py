"""Build and load the port's CUDA kernels.

Each kernel source in csrc/ has a plain C interface. It is compiled by
`nvcc` into a shared library under _build/ at first use, named by a hash
of the source and the flags (a changed source builds anew), and loaded
with ctypes. Nothing is built or loaded at import time, so the package
imports on machines without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# IEEE float math on purpose (no --use_fast_math): the kernels divide by
# zero and rely on inf/nan being masked afterwards, as the reference does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def build(name: str) -> str:
    """Compile csrc/<name>.cu (if its hash is new) and return the path of
    the shared library. The compiler's report (registers, spills) is kept
    beside it as <library>.log."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(f"built in {time.perf_counter() - t0:.1f} s\n")
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """The compiler's report of the last build of csrc/<name>.cu."""
    with open(build(name) + ".log") as f:
        return f.read()


def megakernel_lib() -> ctypes.CDLL:
    """K1 (csrc/megakernel.cu), built and loaded once per process."""
    lib = _loaded.get("megakernel")
    if lib is None:
        lib = ctypes.CDLL(build("megakernel"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mega_pass.argtypes = [p, p, p, ctypes.c_uint32, p, i, p, i, p,
                                  p, i, i, i, i, i, p, p]
        lib.mega_pass.restype = ctypes.c_int
        lib.mega_error_string.argtypes = [ctypes.c_int]
        lib.mega_error_string.restype = ctypes.c_char_p
        _loaded["megakernel"] = lib
    return lib
