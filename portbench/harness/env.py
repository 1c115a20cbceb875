"""The run's environment: build caches, forbidden imports, the cards."""
from __future__ import annotations

import os
import sys

from .spec import ROOT

# what no process of a run may hold: JAX and the JAX package, compared by
# whole top-level module name (the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlo_pathtracing_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")


def set_cache_dirs(env=None) -> dict:
    """Keep every build and kernel cache at fixed paths inside the
    checkout. The program builds its CUDA kernels under its own package
    directory (montecarlo_pathtracing_tpu_torch/_build), which is inside
    the checkout too."""
    env = os.environ if env is None else env
    env["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    env.setdefault("USE_FLAX", "0")
    return env


def one_thread(env=None) -> None:
    """One intra-op thread for the host's torch and NumPy operations.
    The program's host side dispatches many small operations from one
    Python thread; a pool of intra-op threads as wide as the machine
    spins beside it on cores that the card's host shares with other
    machines' work. Set before torch is imported, and in torch too."""
    env = os.environ if env is None else env
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        env[var] = "1"
    import torch
    torch.set_num_threads(1)


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that no run may hold."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def require_cards(n: int):
    """Exit without a result unless n CUDA cards are there."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"this cell needs {n} CUDA card(s); found {count}\n")
        raise SystemExit(3)
