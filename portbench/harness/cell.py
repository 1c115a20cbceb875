"""One run of one cell: set-up, warm-up, the window, the check, the
result line.

`run_cell` runs a cell in this process, on one card. The result's metrics
are the cell's end-to-end metrics (`trace` 0) or its per-layer metrics
(`trace` 1), read by `metrics/<name>.py` from the run's record.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import check, faults, loop, spec, stats


def end_to_end(cell: dict, record: dict, setup_s: float) -> dict:
    cfg = cell["config"]
    cards = record["cards"]
    window_s = cards[0]["window_s"]
    passes = sum(c["passes"] for c in cards)
    found = {
        "rays_per_s": (stats.rays_per_s(cfg["width"], cfg["height"],
                                        cfg["bounces"], passes, window_s),
                       "rays/s"),
        "frame_ms_p95": (stats.percentile(cards[0]["spans"]["step"], 95)
                         * 1e3, "ms"),
        "setup_s": (setup_s, "s"),
    }
    out = {}
    for m in cell["end_to_end"]:
        value, unit = found[m["name"]]
        out[m["name"]] = {"value": value, "unit": unit}
    return out


def per_layer(cell: dict, record: dict, root: str) -> dict:
    out = {}
    for m in cell["per_layer"]:
        value = spec.metric_reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(record: dict) -> dict:
    """The traced stretch's device operations and idle gaps, averaged
    over the cards."""
    traces = [c["trace"] for c in record["cards"] if c.get("trace")]
    out = {}
    for key in ("device_ops", "idle_gaps"):
        acc = {}
        for t in traces:
            for name, s in t[key]:
                acc[name] = acc.get(name, 0.0) + s / len(traces)
        out[key] = [[n, s] for n, s in
                    sorted(acc.items(), key=lambda kv: -kv[1])[:10]]
    return out


def single(cell: dict, seed: int, seconds: float, trace: bool, device,
           t_start: float, fault=None, root: str = spec.ROOT) -> dict:
    """A one-process run. `fault`, for the harness's tests, names a fault
    to plant under the window (`harness/faults.py`)."""
    cfg, traffic = cell["config"], cell["traffic"]
    ins = loop.inputs(seed, cfg, traffic)
    setup_spans = loop.Spans()
    desc, r = loop.setup(cfg, ins, device, setup_spans, root)
    loop.warm_up(r, traffic)
    r.nb_passes = ins["first_pass"]
    if fault:
        faults.plant(fault, r)
    ys, xs = check.sample(seed, cfg["width"], cfg["height"],
                          cell["limits"]["pixels"])
    sampler = loop.Sampler(ys, xs)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    run = loop.closed_loop(r, traffic, ins, seconds, trace,
                           sampler if traffic["step"] == "frame" else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traffic["step"] == "advance":
        sampler.keep(r.resolve(passes=run["passes"]), ins["first_pass"],
                     run["passes"], run["passes"])
    run["spans"]["scene_compile"] = setup_spans.seconds["scene_compile"]
    del r
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    frames = sampler.frames
    if traffic["step"] == "frame":
        frames = check.pick_frames(frames, seed)
    return {"cards": [run], "setup_s": setup_s, "peak": peak,
            "desc": desc, "ys": ys, "xs": xs, "frames": frames,
            "date": ins["date"]}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None, dtype=torch.float32,
             fault=None, root: str = spec.ROOT) -> dict:
    """The result line of one run (a dict), with the check done. `dtype`
    is the reference's float type (bfloat16: the check's control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(name, root)
    cfg = cell["config"]
    if cell["traffic"]["processes"] != 1:
        raise ValueError(f"{name}: the generator runs one process a cell")
    record = single(cell, seed, seconds, trace, device, t_start, fault,
                    root)
    t_ref = time.perf_counter()
    found = compare(record, cfg, device, dtype)
    found["reference_s"] = time.perf_counter() - t_ref
    frames = record["frames"]
    correct, rows = check.judge(found, cell["limits"])
    metrics = (per_layer(cell, record, root) if trace
               else end_to_end(cell, record, record["setup_s"]))
    attempted = record["cards"][0]["frames"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": 0 if correct else len(frames), "metrics": metrics,
              "device": _device(device, cell, record, trace)}
    if trace:
        result["breakdown"] = breakdown(record)
    traces = [c["trace"] for c in record["cards"] if c.get("trace")]
    if traces:
        t = traces[0]
        found["trace_events"] = t["events"]
        found["trace_digest_s"] = t["digest_s"]
        # seconds a pass untraced, in the device stretch and in the
        # labelled one, and the idle share each stretch's own length
        # gives: what the profilers cost the host
        found["untraced_s_per_pass"] = t.get("untraced_s_per_pass")
        for key, st in (("device", t), ("labelled", t.get("labelled"))):
            if st and st["passes"]:
                found[f"{key}_s_per_pass"] = st["window_s"] / st["passes"]
                found[f"{key}_stretch_idle_pct"] = 100.0 * (
                    1.0 - st["busy_s"] / st["window_s"])
    result["readings"] = found
    result["checks"] = check.report(rows)
    return result


def compare(record: dict, cfg: dict, device, dtype=torch.float32) -> dict:
    """The check's numbers of a run's compared frames against the
    reference in `dtype`."""
    proj, view = loop.camera_of(cfg)
    frames = record["frames"]
    ref = check.reference_frames(record["desc"], cfg, proj, view,
                                 record["ys"], record["xs"], frames,
                                 record["date"], device, dtype)
    return check.numbers(np.stack([f[0] for f in frames]), ref)


def _device(device, cell, record, trace) -> dict:
    count = cell["workload"]["chips"]
    if torch.device(device).type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": count, "memory_peak_bytes": int(record["peak"])}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": count,
               "memory_peak_bytes": 0}
    traces = [c["trace"] for c in record["cards"] if c.get("trace")]
    if trace and traces:
        out["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        out["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
    return out
