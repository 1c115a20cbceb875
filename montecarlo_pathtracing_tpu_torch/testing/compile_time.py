"""Host time of building `scenes.scene_stress(n_prims)` and of
`compile_scene` on it, for each prim count given, with the analytic
groups' padded sizes.

    python -m montecarlo_pathtracing_tpu_torch.testing.compile_time \
        8000 200000 [--timeout 300]

Each count runs in a child process on the CPU (tables on CPU tensors),
which is killed after --timeout seconds; such a count is printed as not
finished. Prints one line per count and the host's CPU model.
"""
from __future__ import annotations

import argparse
import platform
import subprocess
import sys
import time


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def one(n_prims: int) -> str:
    from ..scene import scenes
    from ..scene.device import compile_scene

    t0 = time.perf_counter()
    prims = scenes.scene_stress(n_prims=n_prims)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = compile_scene(prims, device="cpu")
    compile_s = time.perf_counter() - t0
    groups = ", ".join(f"shape {c}: {int(p.shape[0])}"
                       for c, p in zip(dev.group_codes, dev.group_prim))
    return (f"scene_stress({n_prims}): build {build_s:.2f} s, compile_scene "
            f"{compile_s:.2f} s; padded groups {groups}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("counts", type=int, nargs="+")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(one(args.counts[0]), flush=True)
        return 0
    print(f"host CPU: {cpu_model()}", flush=True)
    for n in args.counts:
        try:
            out = subprocess.run(
                [sys.executable, "-m", __spec__.name, "--one", str(n)],
                capture_output=True, text=True, timeout=args.timeout,
                check=True)
            print(out.stdout.strip(), flush=True)
        except subprocess.TimeoutExpired:
            print(f"scene_stress({n}): build and compile_scene did not finish "
                  f"in {args.timeout:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
