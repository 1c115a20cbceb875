"""The program's own host spans, as a traced run collects and reads them.

The program records spans where its work happens
(montecarlo_pathtracing_tpu_torch/utils/profiling: `span`, off by
default, `enable_spans`, `take_spans`). A traced run turns them on at its
start and takes them at three points: after set-up, when the device
stretch opens (the first half of the window, which runs without a
profiler) and when it closes, when they are turned off again. Each part
is a summary by span name (count, inclusive seconds, self seconds: a
span's time less its children's); the device stretch's part also keeps
the raw intervals of its leaf spans (spans with no child) and of its
`advance` spans, in microseconds on the profiler's clock, for
`idle_by_span`. `portbench/tools/spans.py` runs a cell so; the
benchmark's own runs (`run.py`) do not collect the program's spans yet.

A program without spans (an older commit) has nothing to record: then
`enable` returns False, `take` returns nothing and every reader of a span
finds nothing and returns None.
"""
from __future__ import annotations

import bisect
import collections

REQUEST = "advance"
TOP = 10


def _recorder():
    try:
        from montecarlo_pathtracing_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "enable_spans"):
        return None
    return profiling


def enable(on: bool = True) -> bool:
    """Turn the program's spans on or off; False where it has none."""
    rec = _recorder()
    if rec is None:
        return False
    rec.enable_spans(on)
    return True


def take() -> list:
    """The program's spans since the last take (none where it has none)."""
    rec = _recorder()
    return rec.take_spans() if rec is not None else []


def _children_ns(spans) -> list:
    """Each span's children's nanoseconds."""
    out = [0] * len(spans)
    for s in spans:
        if s.parent >= 0 and s.end is not None:
            out[s.parent] += s.end - s.start
    return out


def summary(spans) -> dict:
    """{name: {count, s (inclusive), self_s}} of the closed spans."""
    out = {}
    for s, kids in zip(spans, _children_ns(spans)):
        if s.end is None:
            continue
        d = out.setdefault(s.name, {"count": 0, "s": 0.0, "self_s": 0.0})
        d["count"] += 1
        d["s"] += (s.end - s.start) / 1e9
        d["self_s"] += (s.end - s.start - kids) / 1e9
    return out


def _leaf_flags(spans) -> list:
    leaf = [True] * len(spans)
    for s in spans:
        if s.parent >= 0:
            leaf[s.parent] = False
    return leaf


def _advance_leaf_s(spans, leaves) -> tuple:
    """(host seconds of the `advance` spans, of the leaf spans inside
    them)."""
    root = []
    for i, s in enumerate(spans):
        root.append(i if s.parent < 0 else root[s.parent])
    total = inside = 0
    for i, (s, leaf) in enumerate(zip(spans, leaves)):
        if s.end is None or spans[root[i]].name != REQUEST:
            continue
        if root[i] == i:
            total += s.end - s.start
        elif leaf:
            inside += s.end - s.start
    return total / 1e9, inside / 1e9


def part(spans, passes: int, raw: bool = False) -> dict:
    """One part of the record: the summary, the passes it spans, the
    host time of `advance` and of the leaves inside it, and with `raw`
    the leaves' and the `advance` spans' intervals (us)."""
    leaves = _leaf_flags(spans)
    total, inside = _advance_leaf_s(spans, leaves)
    out = {"passes": passes, "spans": summary(spans),
           "advance_s": total, "advance_leaf_s": inside}
    if raw:
        closed = [(s, f) for s, f in zip(spans, leaves) if s.end is not None]
        out["leaves"] = [(s.name, s.start / 1e3, s.end / 1e3)
                         for s, f in closed if f and s.parent >= 0]
        out["advance"] = [(s.start / 1e3, s.end / 1e3) for s, _ in closed
                          if s.name == REQUEST]
    return out


def _overlaps(xs, ys):
    """(index in ys, length) of each overlap between two lists of sorted,
    disjoint intervals (start, end, ...)."""
    i = j = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            yield j, hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1


def idle_by_span(leaves, advance, busy, passes: int):
    """The device stretch's idle time inside `advance` by the leaf span
    the host was in. busy: the merged device intervals [[start, end]]
    (us, sorted); leaves (name, start, end) and advance (start, end) on
    the same clock. Returns {advance_idle_ms_per_pass, ms_per_pass (the
    top leaves' idle ms a pass), uncovered_share (of the idle time inside
    advance, the share in no leaf), busy_inside_share (of the device's
    busy time, the share inside advance: 1 where the clocks agree, since
    advance ends with a synchronize)}, or None without spans."""
    if not advance or not passes:
        return None
    advance = sorted(advance)
    ends = [e for _, e in busy]
    idle = []
    for a0, a1 in advance:
        cur = a0
        i = bisect.bisect_right(ends, a0)
        while i < len(busy) and busy[i][0] < a1:
            if busy[i][0] > cur:
                idle.append((cur, busy[i][0]))
            cur = max(cur, busy[i][1])
            i += 1
        if cur < a1:
            idle.append((cur, a1))
    total = sum(e - s for s, e in idle)
    # the leaves of one thread never overlap, nor do the idle gaps
    lv = sorted((s, e, name) for name, s, e in leaves)
    by = collections.Counter()
    for j, length in _overlaps(idle, lv):
        by[lv[j][2]] += length
    busy_s = sum(e - s for s, e in busy)
    inside = sum(length for _, length in _overlaps(busy, advance))
    return {"advance_idle_ms_per_pass": total / 1e3 / passes,
            "ms_per_pass": [[n, us / 1e3 / passes]
                            for n, us in by.most_common(TOP)],
            "uncovered_share": (total - sum(by.values())) / total
            if total else 0.0,
            "busy_inside_share": inside / busy_s if busy_s else None}


def host_ms_per_pass(run, name: str, part_name: str = "untraced"):
    """Host milliseconds a pass inside span `name` over one part of the
    record (by default the traced run's first half, which has no
    profiler); the mean over the cards, None where no card has it."""
    values = []
    for c in run["cards"]:
        p = (c.get("program_spans") or {}).get(part_name)
        if not p or not p["passes"]:
            continue
        s = p["spans"].get(name)
        if s:
            values.append(s["s"] / p["passes"] * 1e3)
    return sum(values) / len(values) if values else None
