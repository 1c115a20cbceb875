"""The one traffic generator: a closed loop over the program's renderer.

A traffic file (`traffic/<name>.json`) sets its parameters:

  - `processes`: 1 (one process on one card: the only kind of mix this
    generator runs);
  - `step`: what one step of the loop is: `advance` (the renderer's
    `advance` by `passes_per_step` passes, or the program's default
    `passes_per_call` when that is null) or `frame` (`passes_per_step`
    passes, a synchronise and `image()`: one frame of the viewer);
  - `reset_every`: `reset()` after every so many steps (0: never);
  - `seeded`: which inputs the seed moves (`date`, `first_pass`,
    `reset_phase`).

The loop is closed: a step starts when the last one has returned. The
window starts once set-up and warm-up are done and closes at the end of
the first step that ends `seconds` or more after its start (in a traced
run, not before both traced stretches are over); nothing compiles inside
it.
"""
from __future__ import annotations

import time

import numpy as np

from . import port
from .scenes import load_scene
from .trace import TRACE_SECONDS, Tracer
from ..reference import camera

# the seed's streams: one for the run's inputs, one for the check's sample
STREAM_INPUTS, STREAM_CHECK = 0, 1


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def inputs(seed: int, cfg: dict, traffic: dict) -> dict:
    """What the seed decides, and only that: the renderer's date (the RNG
    streams' second word), the first pass index and the phase of the
    resets. Every seed gives the same sizes and the same work."""
    rng = seed_rng(seed, STREAM_INPUTS)
    seeded = traffic.get("seeded", [])
    date = float(np.float32(rng.integers(0, 1 << 20) / 16.0))
    first = int(rng.integers(0, cfg["spp"]))
    every = traffic.get("reset_every", 0)
    phase = int(rng.integers(0, every)) if every else 0
    return {"date": date if "date" in seeded else 0.0,
            "first_pass": first if "first_pass" in seeded else 0,
            "reset_phase": phase if "reset_phase" in seeded else 0}


def camera_of(cfg: dict):
    pose = cfg.get("pose", {})
    return camera.pose_matrices(cfg["width"], cfg["height"], **pose)


class Spans:
    """Host-clock spans of the benchmark's own calls into the program."""

    def __init__(self):
        self.seconds = {}

    def add(self, name: str, seconds: float):
        self.seconds.setdefault(name, []).append(seconds)


def setup(cfg: dict, ins: dict, device, spans: Spans, root: str):
    """The program's scene and renderer of a configuration."""
    desc = load_scene(cfg["scene"], cfg["light"], root)
    t = time.perf_counter()
    scene = port.compile_scene(desc, device)
    spans.add("scene_compile", time.perf_counter() - t)
    proj, view = camera_of(cfg)
    r = port.renderer(scene, port.render_config(cfg, ins["date"], device),
                      proj, view)
    return desc, r


class Sampler:
    """Keeps the check's sample of pixels of the images a step resolves."""

    def __init__(self, ys, xs):
        self.ys, self.xs = ys, xs
        self.frames = []

    def keep(self, img, first: int, passes: int, divisor: int):
        """img: an image the program resolved from the passes first ..
        first + passes - 1, divided by `divisor`."""
        self.frames.append((img[self.ys, self.xs].copy(), first, passes,
                            divisor))


def closed_loop(r, traffic: dict, ins: dict, seconds: float, trace: bool,
                sampler: Sampler | None) -> dict:
    """Run the window."""
    step = traffic["step"]
    ppc = traffic.get("passes_per_step") or r.config.passes_per_call
    every = traffic.get("reset_every", 0)
    spans = Spans()
    # a traced run's first half runs untraced: its steps' time a pass is
    # what the device's busy time a pass is read against
    tracer = Tracer(trace, start_after=seconds / 2)
    launches0 = port.launches()
    passes = frames = 0
    untraced_s = untraced_passes = 0
    since_reset = ins["reset_phase"]
    epoch_first = r.nb_passes
    t0 = time.perf_counter()
    while True:
        traced = tracer.phase is not None
        ts = time.perf_counter()
        if every and since_reset >= every:
            with tracer.span("pb.reset"):
                r.reset()
            since_reset = 0
            epoch_first = r.nb_passes
        with tracer.span("pb.advance"):
            r.advance(r.nb_passes + ppc)
        tp = time.perf_counter()
        spans.add("pass", tp - ts)
        img = None
        if step == "frame":
            with tracer.span("pb.image"):
                img = r.image()
            spans.add("resolve", time.perf_counter() - tp)
        te = time.perf_counter()
        spans.add("step", te - ts)
        passes += ppc
        frames += 1
        since_reset += 1
        if not traced:
            untraced_s += te - ts
            untraced_passes += ppc
        if sampler is not None and img is not None:
            sampler.keep(img, epoch_first, r.nb_passes - epoch_first,
                         r.nb_passes)
        tracer.after_step(passes, te - t0, min(TRACE_SECONDS, seconds))
        if te - t0 >= seconds and tracer.finished:
            break
    window_s = time.perf_counter() - t0
    if tracer.close(passes) is not None and untraced_passes:
        tracer.digest["untraced_s_per_pass"] = untraced_s / untraced_passes
    return {"window_s": window_s, "passes": passes, "frames": frames,
            "launches": port.launches() - launches0,
            "spans": spans.seconds, "trace": tracer.digest}


def warm_up(r, traffic: dict):
    """Run each shape the window will use once, then clear the state."""
    r.advance(traffic.get("passes_per_step") or r.config.passes_per_call)
    if traffic["step"] == "frame":
        r.image()
    r.reset()
