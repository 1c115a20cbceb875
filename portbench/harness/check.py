"""The check that decides `correct`.

After the window closes, the program's state is freed and the peak
memory read, the reference (`portbench/reference`) renders a sample of
the pixels, drawn from the seed, over exactly the passes whose sum the
program's compared images hold, and the two are compared:

  - batch cells: the image the program resolves from its accumulator at
    the end of the window (every pass of the window);
  - the interactive cell: every frame's `image()` of one reset epoch,
    drawn from the seed among the window's frames.

Each number compared has its limit in `limits/<workload>.json`; the run
is correct when every number is finite and at most its limit.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .loop import STREAM_CHECK, seed_rng
from .. import reference

# a channel counts as off when it differs by more than this from the
# reference (absolute plus relative: the megakernel protocol's per-lane
# test); the share is a reading, not a number compared, since it grows
# with the passes a window holds
OFF_ABS = OFF_REL = 1e-3


def sample(seed: int, width: int, height: int, n: int):
    """The check's pixels (ys, xs), drawn from the seed."""
    rng = seed_rng(seed, STREAM_CHECK)
    idx = rng.choice(width * height, size=min(n, width * height),
                     replace=False)
    return np.divmod(np.sort(idx), width)


def pick_frames(frames: list, seed: int) -> list:
    """One epoch of frames (those that share a first pass), drawn from the
    seed among all frames of the window."""
    rng = seed_rng(seed, STREAM_CHECK + 1)
    k = int(rng.integers(0, len(frames)))
    first = frames[k][1]
    lo = k
    while lo > 0 and frames[lo - 1][1] == first and \
            frames[lo - 1][2] < frames[lo][2]:
        lo -= 1
    hi = k
    while hi + 1 < len(frames) and frames[hi + 1][1] == first and \
            frames[hi + 1][2] > frames[hi][2]:
        hi += 1
    return frames[lo:hi + 1]


def reference_frames(desc, cfg, proj, view, ys, xs, frames, date, device,
                     dtype=torch.float32) -> np.ndarray:
    """The reference's value of each compared frame: the sum of the
    frame's passes, divided as the program divided it. frames: (values,
    first pass, passes, divisor), all of one epoch or one image."""
    first = min(f[1] for f in frames)
    last = max(f[1] + f[2] for f in frames)
    per_pass = reference.render_samples(
        desc, proj, view, cfg["width"], cfg["height"], xs, ys,
        range(first, last), nb_bounces=cfg["bounces"], ior=cfg["ior"],
        date=date, device=device, dtype=dtype)
    csum = torch.cumsum(per_pass, dim=0).cpu().numpy()
    out = []
    for _, f0, n, div in frames:
        s = csum[f0 - first + n - 1]
        if f0 > first:
            s = s - csum[f0 - first - 1]
        out.append(s / max(1, div))
    return np.stack(out)


def numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    """prog, ref: [frames, pixels, 3]. `bias`: the largest relative gap
    of a frame's summed radiance over the sample; `p75_abs`: the 75th
    percentile of the channels' absolute gaps; `off_share`: the share of
    channels more than 1e-3 + 1e-3 |ref| off."""
    prog = prog.astype(np.float64)
    ref = ref.astype(np.float64)
    tot = ref.reshape(ref.shape[0], -1).sum(axis=1)
    gap = np.abs(prog.reshape(prog.shape[0], -1).sum(axis=1) - tot)
    diff = np.abs(prog - ref)
    bad = ~np.isfinite(prog)
    off = bad | (diff > OFF_ABS + OFF_REL * np.abs(ref))
    return {"bias": float(np.max(gap / np.maximum(tot, 1e-30)))
            if not bad.any() else math.inf,
            "p75_abs": float(np.percentile(np.where(bad, np.inf, diff), 75)),
            "off_share": float(off.mean())}


def judge(found: dict, limits: dict):
    """(correct, [(name, value, limit)]) for the numbers with a limit."""
    rows = [(k, found[k], float(v["limit"]))
            for k, v in limits["numbers"].items()]
    ok = all(math.isfinite(x) and x <= lim for _, x, lim in rows)
    return ok, rows


def report(rows, out=sys.stderr) -> dict:
    """Print each number beside its limit as the last lines on standard
    error; return them for the result line."""
    for name, value, limit in rows:
        out.write(f"check {name} {value!r} limit {limit!r}\n")
    out.flush()
    return {name: {"value": value, "limit": limit}
            for name, value, limit in rows}
