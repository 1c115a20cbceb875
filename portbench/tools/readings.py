"""The readings that the check's limits are set from.

    python3 portbench/tools/readings.py --workload <name> --seeds 1,2,3
        [--seconds 10] [--control [--passes N]] [--fault NAME]

Without --control, runs the cell's program once per seed in this process
(a one-process cell) and prints its check numbers against the float32
reference, one JSON line per seed. With --control, puts the reference
computed in bfloat16 in the program's place, over the frames the cell's
traffic compares (a batch cell: N passes from the seed's first pass; the
interactive traffic: one epoch of 32 frames), and prints its numbers against float32. With
--fault, plants that fault (`harness/faults.py`) under the program's
window. The benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def control_frames(cell: dict, seed: int, passes: int):
    from portbench.harness import check, loop
    cfg, traffic = cell["config"], cell["traffic"]
    ins = loop.inputs(seed, cfg, traffic)
    if traffic["step"] == "frame":
        every = traffic["reset_every"]
        return [(None, 0, k, k) for k in range(1, every + 1)], ins
    first = ins["first_pass"]
    return [(None, first, passes, passes)], ins


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--passes", type=int, default=64)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)

    import torch
    from portbench.harness import cell as cells, check, env, loop, spec
    from portbench.harness.scenes import load_scene
    env.set_cache_dirs()
    cell = spec.cell(args.workload)
    cfg = cell["config"]
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.control:
            frames, ins = control_frames(cell, seed, args.passes)
            ys, xs = check.sample(seed, cfg["width"], cfg["height"],
                                  cell["limits"]["pixels"])
            desc = load_scene(cfg["scene"], cfg["light"])
            proj, view = loop.camera_of(cfg)
            low = check.reference_frames(desc, cfg, proj, view, ys, xs,
                                         frames, ins["date"], device,
                                         torch.bfloat16)
            record = {"desc": desc, "ys": ys, "xs": xs, "date": ins["date"],
                      "frames": [(v, *f[1:]) for v, f in zip(low, frames)]}
            kind = "control"
        else:
            record = cells.single(cell, seed, args.seconds, False, device,
                                  time.perf_counter(), args.fault)
            kind = args.fault or "program"
        found = cells.compare(record, cfg, device)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "frames": len(record["frames"]),
                          "passes": [f[2] for f in record["frames"]][-1],
                          "numbers": found,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
