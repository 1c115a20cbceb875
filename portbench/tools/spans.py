"""The program's own host spans in one traced run of a cell.

    python3 portbench/tools/spans.py --workload <name> --seed <n>
        --seconds <s>

Runs the cell as `portbench/run.py --trace 1` does, in this process, with
the program's spans (`harness/program_spans.py`) turned on from the
start of the run and taken after set-up, when the device stretch opens
and when it closes (off from there on, so the labelled stretch runs as
it does without them). The harness's own files have no hook for that
yet, so this tool wraps three of its functions for the run: the window
(`loop.closed_loop`, which starts once set-up is done), the tracer's
step (`trace.Tracer.after_step`, which opens and closes the stretches)
and the device stretch's digest (`trace.device_digest`, for the merged
device intervals). The last line of standard output is the run's result
line with one key more, `program_spans`:

  - `metrics`: the host milliseconds a pass of the first half (which has
    no profiler) in `k1.inputs`, `k2.inputs`, `k2.schedule` and
    `k2.sort`, and the set-up's `renderer.init` seconds, where the run
    recorded them;
  - `advance_leaf_pct`: the share of the first half's host time in
    `advance` that leaf spans cover;
  - `idle_by_span`: the device stretch's idle time inside `advance` by
    the leaf span the host was in;
  - `parts`: each part's summary by span name.

The benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.harness import program_spans  # noqa: E402

# metric name: the span whose first-half host ms a pass it reads
HOST_MS = {"k1_inputs_ms_per_pass": "k1.inputs",
           "k2_inputs_ms_per_pass": "k2.inputs",
           "k2_schedule_ms_per_pass": "k2.schedule",
           "k2_sort_ms_per_pass": "k2.sort"}


class Collector:
    """The parts of one run's spans, gathered through the wrappers that
    `installed` puts in place."""

    def __init__(self):
        self.parts = {}
        self.busy = []
        self.opened_at = 0

    def closed_loop(self, real):
        def run(*a, **k):
            setup = program_spans.take()
            out = real(*a, **k)
            self.parts["setup"] = program_spans.part(setup, 0)
            return out
        return run

    def after_step(self, real):
        def step(tracer, passes, elapsed, seconds):
            was = tracer.phase
            real(tracer, passes, elapsed, seconds)
            if was == tracer.phase:
                return
            if was is None:
                self.parts["untraced"] = program_spans.part(
                    program_spans.take(), passes)
                # the profiler's clock offset was taken as it opened
                program_spans.enable()
                self.opened_at = passes
            elif was == "device":
                self.parts["device"] = program_spans.part(
                    program_spans.take(), passes - self.opened_at, raw=True)
                program_spans.enable(False)
        return step

    def device_digest(self, real, trace):
        def digest(events, window_s, passes):
            self.busy = trace._merge([[s, t] for s, t, _ in
                                      trace._device_work(events)])
            return real(events, window_s, passes)
        return digest

    def readings(self) -> dict:
        record = {"cards": [{"program_spans": self.parts}]}
        metrics = {}
        for name, span in HOST_MS.items():
            value = program_spans.host_ms_per_pass(record, span)
            if value is not None:
                metrics[name] = value
        init = self.parts.get("setup", {}).get("spans", {}).get(
            "renderer.init")
        if init:
            metrics["renderer_init_s"] = init["s"]
        out = {"metrics": metrics}
        half = self.parts.get("untraced")
        if half and half["advance_s"]:
            out["advance_leaf_pct"] = (100.0 * half["advance_leaf_s"]
                                       / half["advance_s"])
        dev = self.parts.get("device")
        if dev:
            out["idle_by_span"] = program_spans.idle_by_span(
                dev["leaves"], dev["advance"], self.busy, dev["passes"])
        out["parts"] = {k: {"passes": p["passes"], "spans": p["spans"]}
                        for k, p in self.parts.items()}
        return out


@contextlib.contextmanager
def installed(collector: Collector):
    """The harness's three functions wrapped for `collector`, restored
    on leaving."""
    from portbench.harness import loop, trace
    saved = (loop.closed_loop, trace.Tracer.after_step, trace.device_digest)
    loop.closed_loop = collector.closed_loop(saved[0])
    trace.Tracer.after_step = collector.after_step(saved[1])
    trace.device_digest = collector.device_digest(saved[2], trace)
    try:
        yield collector
    finally:
        loop.closed_loop, trace.Tracer.after_step, trace.device_digest = \
            saved
        program_spans.enable(False)
        program_spans.take()


def run(name: str, seed: int, seconds: float, device="cuda",
        t_start=None, root=None) -> dict:
    """One traced run of cell `name` with the program's spans: its
    result line, with `program_spans`."""
    from portbench.harness import cell as cells, spec
    collector = Collector()
    with installed(collector):
        program_spans.enable()
        result = cells.run_cell(name, seed, seconds, True, device=device,
                                t_start=t_start, root=root or spec.ROOT)
    checks = result.pop("checks")
    result["program_spans"] = collector.readings()
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench.harness import env, spec
    env.set_cache_dirs()
    env.one_thread()
    env.require_cards(spec.cell(args.workload)["workload"]["chips"])
    result = run(args.workload, args.seed, args.seconds, t_start=T_START)
    found = env.forbidden_modules()
    if found:
        sys.stderr.write(f"loaded forbidden modules: {found}\n")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
