"""Profiling & observability: host spans, profiler traces, memory stats.

Port of montecarlo_pathtracing_tpu/utils/profiling.py. The reference's
only instruments are an FPS average over 50-frame windows
(easycppogl/gl_viewer.cpp:412-418), a BVH-build wall-time print
(MontecarloGPU/montecarlo.cpp:354-363), and NVX GPU-memory queries
(gl_viewer.cpp:443-452). Their counterparts here:

  - span, enable_spans, take_spans: host spans where the work happens
    (the renderer's calls, each tile call, K1's inputs, K2's tables,
    schedules and re-sort, the launches, set-up), off by default
  - trace_context: a torch.profiler trace (CPU and CUDA activities)
    exported as a Chrome trace into a directory
  - device_memory_stats: per-card memory counters (the NVX query analog)
  - enable_compilation_cache: where the kernels' builds are kept

A span records the host's time between entering and leaving a `with`
block: a launch returns before the card has run the kernel, so a span
says what the host spent, not what the card did. Spans read the host's
monotonic clock (time.perf_counter_ns) shifted by one offset to Unix
time (time.time_ns), taken by enable_spans: the clock torch.profiler's
(kineto's) events carry, so spans and a trace's device intervals line
up. Recording adds no CUDA event, synchronize or device read.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch


class _NoSpan:
    """The span of a recorder that is off: enters and leaves, records
    nothing, reads no clock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()

# what take_spans returns, one a span
_Span = collections.namedtuple(
    "_Span", ("name", "start", "end", "parent", "request", "attrs"))


class _Recorder:
    """The spans since the last take, a column a field, and the spans
    still open. Recording appends numbers, names and the call site's
    attrs to lists: no object a span that the garbage collector would
    keep scanning (on a host holding many objects that doubled a span's
    cost). Spans nest, so the recorder is also the context manager of
    every recorded span: leaving one closes the innermost open span."""

    def __init__(self):
        self.on = False
        self.offset = 0
        self.requests = 0
        self.open = []      # (the ends column, index, request) of each
        self.clear()

    def clear(self):
        self.names, self.starts, self.ends = [], [], []
        self.parents, self.reqs, self.attrs = [], [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        ends, i, _ = self.open.pop()
        ends[i] = time.perf_counter_ns() + self.offset
        return False

    def set(self, **attrs):
        """Add attrs to the innermost open span: those the call site
        knows only inside it."""
        ends, i, _ = self.open[-1]
        if ends is self.ends:   # not taken since it opened
            self.attrs[i].update(attrs)


_recorder = _Recorder()


def span(name: str, **attrs):
    """A context manager that records the host's time inside it as one
    span when spans are on (enable_spans), and the one shared no-op
    otherwise. Use it in a `with` statement: the span starts when
    `span` is called. `with span(...) as s:` gives `s.set(**attrs)`,
    which adds attrs known only inside the span."""
    rec = _recorder
    if not rec.on:
        return _NO_SPAN
    ends = rec.ends
    if rec.open:
        up_ends, up, request = rec.open[-1]
        parent = up if up_ends is ends else -1
    else:
        rec.requests += 1
        parent, request = -1, rec.requests
    rec.open.append((ends, len(ends), request))
    rec.names.append(name)
    rec.parents.append(parent)
    rec.reqs.append(request)
    rec.attrs.append(attrs)
    ends.append(None)
    rec.starts.append(time.perf_counter_ns() + rec.offset)
    return rec


def enable_spans(on: bool = True) -> None:
    """Turn span recording on (or off). Turning it on takes the offset
    from the monotonic clock to Unix time anew; records already taken
    keep theirs."""
    _recorder.on = bool(on)
    if on:
        _recorder.offset = time.time_ns() - time.perf_counter_ns()


def take_spans() -> list:
    """The spans recorded since the last take, in the order they were
    entered (a parent before its children), and clear them. Each has
    `name`, `start` and `end` (Unix nanoseconds on the shared clock),
    `parent` (the index of the enclosing span in the same list, -1 for
    none), `request` (the sequence number of the outermost span it lies
    in: one per Renderer.advance call, one per set-up call) and `attrs`
    (pass_index, tile, bounce or whole_path, device, rank, library, or
    the compiled scene's prims, ana_groups and ana_chunks, as the call
    site gives them). Take between requests: a span still open when taken
    has `end` None, and the spans entered inside it after the take name
    no parent."""
    rec = _recorder
    out = list(map(_Span._make, zip(rec.names, rec.starts, rec.ends,
                                    rec.parents, rec.reqs, rec.attrs)))
    rec.clear()
    return out


@contextlib.contextmanager
def trace_context(logdir: str):
    """torch.profiler over the block, with CPU and (where there is a
    card) CUDA activities; the trace is written to <logdir>/trace.json
    (chrome://tracing, Perfetto). Yields the profiler, whose
    key_averages() sum the time by op and kernel."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats of each visible card, keyed "cuda:i"
    (bytes and counts); empty when there is no card."""
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def enable_compilation_cache(path: str | None = None) -> None:
    """Keep the kernels' builds in `path`: nvcc's shared libraries (and
    the native BVH builder's), named by a hash of their sources and
    flags, are built there at first use and loaded from there by every
    later process (kernels.BUILD_DIR). Without a path the package's
    _build/ stays. Builds nothing by itself. Nothing in the package calls
    it: a caller that wants the builds elsewhere does; opt out with
    MCPT_NO_COMPILE_CACHE=1."""
    from .. import kernels
    if os.environ.get("MCPT_NO_COMPILE_CACHE") or path is None:
        return
    kernels.BUILD_DIR = os.path.abspath(path)
