"""The benchmark of montecarlo_pathtracing_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

One process runs one cell of BENCHMARK.json once: set-up, warm-up, a
window of `--seconds`, the check against the plain reference, and one
JSON line as the last line of standard output (the end-to-end metrics
with --trace 0, the per-layer metrics with --trace 1). Each number the
check compares is printed beside its limit as the last lines of standard
error. It exits non-zero, with no result, when the cell's cards are not
there or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import env
    env.set_cache_dirs()
    env.one_thread()
    from portbench.harness import cell as cells, spec
    chips = spec.cell(args.workload)["workload"]["chips"]
    env.require_cards(chips)
    result = cells.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START)
    found = env.forbidden_modules()
    if found:
        sys.stderr.write(f"loaded forbidden modules: {found}\n")
        return 4
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
