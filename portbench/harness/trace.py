"""Reading torch.profiler traces of the window.

`Tracer` profiles two stretches of whole steps, each at least
TRACE_SECONDS long, once the first `start_after` seconds of the window
have run untraced:

  - the device stretch: the device's activity alone (recording the
    host's operations too would slow the host some 2.5 times). The
    device's busy seconds in it (the union of its kernel, copy and set
    intervals), each kernel's device seconds by name, the device
    operations that took most time and the stretch's length on the host
    clock are what the per-layer metrics and the result's `device` read.
    Even this profiler slows a host that launches many small operations
    (the CUDA runtime's calls are still intercepted), so the device's
    idle share is read against the untraced steps' time a pass
    (`untraced_s_per_pass`, filled in by the caller);
  - the labelled stretch, next: host and device activity, for the
    result's `breakdown.idle_gaps` alone: the idle gaps labelled by what
    the host was doing, the benchmark's own span around the call (`pb.*`)
    and the innermost host operation running at the gap's midpoint. The
    host runs slower under this profiler, so these gaps are longer than
    in an untraced step; their shares by label are what they show.

Both traces are read once the window has closed.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

# each traced stretch: whole steps up to at least this long; a longer
# trace of the host's many small operations takes too long to digest
TRACE_SECONDS = 3.0
TOP = 10


class Tracer:
    def __init__(self, enabled: bool, start_after: float = 0.0):
        self.enabled = enabled
        self.start_after = start_after
        self.prof = None
        self.phase = None
        self.t0 = 0.0
        self.passes0 = 0
        self.window = None
        self.stopped = []
        self.digest = None

    @property
    def finished(self) -> bool:
        """Whether both stretches are over (or tracing is off)."""
        return not self.enabled or len(self.stopped) == 2

    def _open(self, phase: str, passes: int):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        if phase == "labelled" or not acts:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.phase, self.passes0 = phase, passes
        if phase == "labelled":
            self.window = self.span("pb.window")
            self.window.__enter__()
        self.t0 = time.perf_counter()

    def span(self, name: str):
        """A host span the labelled stretch shows (a no-op otherwise)."""
        if self.phase != "labelled":
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def after_step(self, passes: int, elapsed: float, seconds: float):
        """At a step's end, `elapsed` seconds into the window with
        `passes` done: open the device stretch once `start_after` has
        passed, and close each stretch once it is `seconds` long, opening
        the labelled one after the device one."""
        if not self.enabled or self.finished:
            return
        if self.phase is None:
            if elapsed >= self.start_after:
                self._open("device", passes)
        elif time.perf_counter() - self.t0 >= seconds:
            done = self.phase
            self._stop(passes)
            if done == "device":
                self._open("labelled", passes)

    def _stop(self, passes: int):
        wall = time.perf_counter() - self.t0
        if self.phase == "labelled":
            self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.stopped.append((self.phase, self.prof, wall,
                             passes - self.passes0))
        self.prof = self.phase = None

    def close(self, passes: int):
        """After the window: close what is open and read both traces."""
        if self.phase is not None:
            self._stop(passes)
        if not self.stopped:
            return None
        t = time.perf_counter()
        self.digest = {"idle_gaps": [], "events": 0}
        for phase, prof, wall, n in self.stopped:
            # the raw kineto events: building the profiler's FunctionEvent
            # tree of a million events would take minutes
            events = [(e.name(), e.device_type(), e.start_ns() / 1e3,
                       e.end_ns() / 1e3, e.start_thread_id(),
                       bool(e.is_user_annotation()))
                      for e in prof.profiler.kineto_results.events()]
            self.digest["events"] += len(events)
            if phase == "device":
                self.digest.update(device_digest(events, wall, n))
            else:
                got = digest(events, n)
                self.digest["idle_gaps"] = got["idle_gaps"]
                self.digest["labelled"] = {k: got[k] for k in
                                           ("busy_s", "window_s", "passes")}
        self.stopped = []
        self.digest["digest_s"] = time.perf_counter() - t
        return self.digest


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _device_work(events, w0=float("-inf"), w1=float("inf")):
    """The device's intervals (start, end, name) within [w0, w1]."""
    from torch.autograd import DeviceType
    out = []
    for name, kind, s, t, _, note in events:
        # a host span's annotation of the device timeline is no work
        if (kind == DeviceType.CUDA and not (note or name.startswith("pb."))
                and t > w0 and s < w1):
            out.append((max(s, w0), min(t, w1), name))
    return out


def device_digest(events, window_s: float, passes: int) -> dict:
    """The device stretch: every device interval in the trace, against
    the stretch's length on the host clock."""
    return _summary(_device_work(events), window_s, passes)


def _summary(dev, window_s: float, passes: int) -> dict:
    busy_us = sum(t - s for s, t in _merge([[s, t] for s, t, _ in dev]))
    by_name = collections.Counter()
    for s, t, name in dev:
        by_name[name] += t - s
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "passes": passes,
            "kernel_s": {n: us / 1e6 for n, us in by_name.items()},
            "device_ops": [[n[:120], us / 1e6]
                           for n, us in by_name.most_common(TOP)]}


def digest(events, passes: int) -> dict:
    """events: (name, device type, start us, end us, thread, is a user
    annotation) of each profiler event. The traced stretch is the host
    span `pb.window`."""
    from torch.autograd import DeviceType

    window = [e for e in events if e[0] == "pb.window"
              and e[1] != DeviceType.CUDA]
    if not window:
        raise RuntimeError("the trace holds no pb.window span")
    _, _, w0, w1, thread, _ = window[0]
    dev = _device_work(events, w0, w1)
    host = [(s, t, name) for name, kind, s, t, th, _ in events
            if kind != DeviceType.CUDA and th == thread
            and name != "pb.window"]
    gaps = []
    edge = w0
    for s, t in _merge([[s, t] for s, t, _ in dev]):
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    return dict(_summary(dev, (w1 - w0) / 1e6, passes),
                idle_gaps=_label_gaps(gaps, host))


def _label_gaps(gaps, host):
    """Idle seconds by the host's activity at each gap's midpoint: the
    outermost `pb.*` span and the innermost operation, joined by ' > '.
    Host events of one thread nest, so a sweep with a stack finds both."""
    host.sort(key=lambda e: (e[0], -e[1]))
    starts = [e[0] for e in host]
    mids = sorted(((s + t) / 2.0, t - s) for s, t in gaps)
    labels = collections.Counter()
    stack = []
    i = 0
    for mid, length in mids:
        j = bisect.bisect_right(starts, mid)
        while i < j:
            ev = host[i]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        live = [e for e in stack if e[1] >= mid]
        outer = next((e[2] for e in live if e[2].startswith("pb.")), "")
        inner = live[-1][2] if live else "host"
        label = inner if outer in ("", inner) else f"{outer} > {inner}"
        labels[label[:120]] += length / 1e6
    return [[n, s] for n, s in labels.most_common(TOP)]
