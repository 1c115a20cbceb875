"""What the program's spans cost the host, steps on against steps off.

    python3 portbench/tools/span_cost.py --workload <name> --seed <n>
        --pairs <k>

Sets a cell up as the benchmark does (its scene, renderer, warm-up and
one intra-op thread, on the card), then runs 2k steps of its traffic in
one process, the program's spans off in one step of each pair and on in
the other (the order alternating from pair to pair, the spans taken
after each step, outside its time). Adjacent steps of one process share
the machine's state, which two runs do not: run to run the host's pace
moves 5-20%, step to step far less. The last line of standard output is
a JSON object: each step's seconds off and on, the median and quartiles
of on / off - 1 over the pairs, the spans a pass, and the host
nanoseconds of a bare span site, off and on. The benchmark's own runs
run none of this.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def site_ns(profiling, on: bool, n: int = 20000) -> float:
    """Host ns of one `with span(...)` site, spans on or off."""
    profiling.enable_spans(on)
    t = time.perf_counter_ns()
    for i in range(n):
        with profiling.span("tile", pass_index=i, tile=0):
            pass
    dt = (time.perf_counter_ns() - t) / n
    profiling.enable_spans(False)
    profiling.take_spans()
    return dt


def measure(name: str, seed: int, pairs: int, device="cuda",
            root=None) -> dict:
    import torch
    from montecarlo_pathtracing_tpu_torch.utils import profiling
    from portbench.harness import loop, spec
    cell = spec.cell(name, root or spec.ROOT)
    cfg, traffic = cell["config"], cell["traffic"]
    if traffic["step"] != "advance":
        raise ValueError(f"{name}: steps of `advance` only")
    ins = loop.inputs(seed, cfg, traffic)
    _, r = loop.setup(cfg, ins, device, loop.Spans(), root or spec.ROOT)
    loop.warm_up(r, traffic)
    r.nb_passes = ins["first_pass"]
    ppc = traffic.get("passes_per_step") or r.config.passes_per_call
    off, on, spans = [], [], 0
    for k in range(2 * pairs):
        spans_on = (k % 2) != ((k // 2) % 2)
        profiling.enable_spans(spans_on)
        t = time.perf_counter()
        r.advance(r.nb_passes + ppc)
        dt = time.perf_counter() - t
        profiling.enable_spans(False)
        spans += len(profiling.take_spans())
        (on if spans_on else off).append(dt)
    cost = [b / a - 1.0 for a, b in zip(off, on)]
    q = statistics.quantiles(cost, n=4) if len(cost) > 1 else cost * 3
    out = {"workload": name, "seed": seed, "pairs": pairs,
           "passes_per_step": ppc, "off_s": off, "on_s": on,
           "cost_median": statistics.median(cost),
           "cost_quartiles": [q[0], q[2]],
           "spans_per_pass": spans / (pairs * ppc),
           "site_ns": {"off": site_ns(profiling, False),
                       "on": site_ns(profiling, True)}}
    if torch.device(device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=12)
    args = ap.parse_args(argv)

    from portbench.harness import env, spec
    env.set_cache_dirs()
    env.one_thread()
    env.require_cards(spec.cell(args.workload)["workload"]["chips"])
    print(json.dumps(measure(args.workload, args.seed, args.pairs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
