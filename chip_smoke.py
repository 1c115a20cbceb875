"""GPU smoke of the PyTorch/CUDA port: build every kernel, hold each one
against its plain PyTorch version, and drive every ported path once.

    python3 chip_smoke.py [--only k1|k2|whole|trace|dense|diff|tools|multi|multicard]

Needs one CUDA GPU (sm_90a) and nvcc; fails with a non-zero exit code,
and prints no result, without them. Phases (about 13 minutes in all on
an H100, the builds included; `--only k1` runs phases 1-3 with K1 built
alone, `--only k2` phases 1, 4 and 5 and `--only whole` phases 1 and 6
with K2 and its counting build built, `--only trace` phases 1 and 7 with the trace kernels built alone,
`--only dense` phases 1 and 13 with K1 and the trace kernels built,
`--only diff` phases 1 and 14 with the trace kernels built alone, `--only
tools` phases 1 and 15 and `--only multi` phases 1 and 16 with K1 and K2
built, `--only multicard` phases 1 and 17 with K1, K2 and the trace
kernels built, where the host has 2 cards or more):

1. the card's name and power limit; build K1 (csrc/megakernel.cu), K2
   (csrc/bounce_kernel.cu, and its counting build for the work counters)
   and the trace kernels K3a, K3b, K4a, K4b, K5, K6
   (csrc/trace_kernels.cu), one nvcc each, started together, and print
   the compile reports (registers, spills; each K1, K2, K3a, K3b, K4a,
   K4b, K5 and K6 variant's on a line of its own), and, where the toolkit
   has cuobjdump, K1's SASS by instruction class (each variant whole, its
   innermost fold loops, and the rest) and the instructions of K3a's,
   K3b's, K4a's, K4b's, K5's tile walk's and K6's fold loops by class;
2. K1 against its plain version (models/megakernel.mega_pass_reference)
   on the card, 64x48 pixels, 4 bounces, passes 0 and 3, under the
   megakernel protocol (testing/parity.py), on box_diffuse (cull off,
   opaque), box_balls (transparent), materials (cull on), a scene with
   all five shapes, transparency and the cull, and a 1200-prim
   scene_stress (a table K1 reads from device memory, past its staging),
   with each variant's compiled kernel (registers, spills, shared memory,
   resident blocks); and nb_bounces=0 -> black;
3. K1's main path at full size: box_diffuse at 800x600, 3 bounces,
   64 passes per call, tile_rays 1<<17, through compile_scene and
   Renderer.advance; the launch count of K1 over one 64-pass window; the
   image finite and non-negative; the device's busy time per pass under
   torch.profiler and its idle share; a 4-pass accumulation of K1 against
   the plain version's; rays/s (pixels x passes x bounces / seconds), K1's
   time per pass (the card kept ahead) with 1, 2 and 3 bounces beside the
   rays in flight at each, the plain version's, and K1's bound from the
   work the pass's inputs need (mk.K1Need); then K1's other variants at
   full size on the auto route (K1_WINDOWS: materials 800x600x6, culled
   and opaque; box_balls 800x600x6 at IOR 1.5, light 0.4, transparent;
   colonnes 1920x1080x6 at light 0.4, culled and transparent): the launch
   count over the window, the image, rays/s, the device's idle share, K1's
   time per pass and compiled kernel, and on a 32,768-ray slice of tile 0
   one pass of K1 against the plain version under the megakernel protocol
   with the slice's needed work, bound and K1's time on it;
4. K2 against its plain version (models/bounce_kernel.
   fused_call_reference) through raytrace_fused on the card, 64x48, 4
   bounces, passes 0 and 3, under the fused protocol, in both modes
   (wavefront and whole path) and in each launch shape of k2_launch
   forced (8 and 16 lanes per ray) and the kernel's own choice, on
   mesh_demo at IOR 1.3 (transparent: the scheduled outer walk and the
   schedule-free re-trace), the opaque mesh fixture with flat faces, a 4200-prim scene_stress (large analytic groups; 1.5% allowed)
   and a mesh scene with a culled 88-prim table; and nb_bounces=0 ->
   black in both modes and shapes; before these, K2's schedule kernel
   (bk.k2_schedule_launch) against `_schedules` on the card on every K2
   call of those scenes in both modes (the groups' segments bit for bit,
   the mesh segments' bounds within 1 ulp or 1e-6 and their orders equal
   but for near-ties);
5. K2's main path at full size: mesh_demo at 800x600, 8 bounces, 8
   passes per call, tile_rays 1<<17, through compile_scene and
   Renderer.advance; K2's launch count and its schedule kernel's over one
   8-pass window (passes x tiles x 8 each); the image finite and
   non-negative; the schedule kernel against `_schedules` on every call of
   a recorded pass (8 tiles x 8 bounces); device busy and idle
   share under torch.profiler; K2's time per launch, per pass and by
   bounce with the rays in flight (CUDA events over one recorded pass,
   the card kept ahead of the host, the median of 5; and once with
   host-paced events, as this script timed before) in the shape the
   kernel chooses and in each shape forced, with its work counters, lane
   share and the card's SM clock and power while timed; its bound from
   the work the pass's inputs need (the plain version replayed on the
   recorded launches with bk.K2Need); the host's per-bounce sort and
   schedules (the schedule kernel's launch beside the plain torch ops); a 2-pass accumulation of K2 against the plain version's at
   full size; rays/s;
6. K2's whole-path mode on stress_10k, 3 bounces: a short window at
   800x600 and K2 by shape over one recorded pass; a 1-pass accumulation
   at 200x150 against the plain version, with K2's time by shape, the
   plain version's and the bound on that pass; then on menger_d2 (key
   E's sponge at depth 2: 8,000 cubes in one group of the analytic pool)
   at the viewer's 1280x1000, 3 bounces, through compile_scene and
   Renderer.advance with nothing forced: the pool's size on the
   `scene.compile` span, one whole-path K2 launch a tile call
   (`k2_launch.whole_path_launches` = `launches` = passes x 20 tiles),
   one schedule launch a tile in the warm-up and none after,
   over four 8-pass windows with each window's rays/s, `whole_path=3` on
   every `k2.launch` span, the inputs kept from the warm-up (`built`
   False on every `k2.inputs` span, no `k2.schedule`, no `k2.sort`), the
   schedule kernel against `_schedules` on a recorded pass's 20, K2 by
   shape over one recorded pass, and a 1-pass accumulation at 160x125 against
   the plain version;
7. each trace kernel against its plain version on the card (K5 on
   colonnes under the trace protocol, testing/parity.py; K3a, K3b, K4a,
   K4b, K6 and K5 on cones and quads rows equal on 99.99% of rays, and
   distances or a, and K3a's and K5's a and dircode, bit for bit where
   they are, printing the rows that differ): K3a on a random 200-prim
   group and K3b on a random 300-prim group with chunk boxes of each shape
   code (2048 rays), K5's tile walk on the cone and quad ones beside the
   per-ray gate these shapes had before (its differing rows and both
   times printed); K5, K3a and K3b on colonnes' two
   large groups, K6, K4a and K4b
   (the op mesh_best_rows with leaf and super boxes: K4b's path, which no
   render route reaches) on each mesh_demo instance (one 1<<17 ray tile
   each) and on mesh_hires's 796-chunk sphere (8192 rays; K4b also with
   sbb=None); and K5 and K3b against K3a, K6 and K4b against K4a on the
   same rays (tests/test_sparse_trace.py:27-54); K4b's time at 4, 8 and
   16 lanes a ray (each bit-equal to its default's), work and bound over
   those launches; the registers and spills of every K2 and K5 variant
   come from phase 1's compile reports;
8. the pallas-trace route (models.montecarlo.raytrace with the
   megakernel and the fused route off) with the kernels against the
   route with their plain versions, 64x48, 4 bounces, passes 0 and 3, on
   colonnes and mesh_demo, under the fused protocol; nb_bounces=0 ->
   black;
9. the route's two full-size paths through compile_scene and
   Renderer.advance with RenderConfig(use_megakernel=False), tile_rays
   1<<17: mesh_demo at 800x600, 8 bounces (BASELINE config 3; 192 K6
   launches per pass) over a 2-pass window, and colonnes at 1920x1080, 6
   bounces, light 0.4 (BASELINE config 5; 384 K5 launches per pass) over
   a 1-pass window: the launch counts, the image, rays/s, one tile call's
   wall time, device busy time and idle share (torch.profiler), the
   kernel's time per launch, per pass and by bounce (CUDA events, the
   card kept ahead of the host, the median of 3, with the SM clock and
   power; and host-paced, as before), its work counters and bound, and 8 of its full-size launches against the
   plain version; for K6, each launch's time beside the longest, 99th
   percentile and mean chunks walked by a 128-ray tile and by a block of
   this kernel, from a replay of the walk, and the kernel's registers,
   blocks per SM and lanes a ray;
10. one pass of each path at 800x600 with cull_chunks=False: K4a and K3a
   launch counts, the image against the culled route's under the fused
   protocol, and K4a's and K3a's times, bounds and plain versions as in
   phase 9, with each one's FMA-free ceiling (twice the bound), tests per
   launch, lane-cycles per test at the SM clock read while timed, and the
   compiled kernel's registers, spills and resident blocks per SM;
11. the large scene: scenes.scene_stress(n_prims=200_000) through
   compile_scene and Renderer.advance with use_megakernel=False, 800x600,
   3 bounces, a 1-pass window: its 150,016-prim sphere group takes K3b
   (12 launches per pass), its cube group K5 (12); the host time of the
   build and the compile, the image, rays/s, one tile call's idle share,
   K3b's time by launch, pass and bounce with its work and bound (the
   super boxes' tests, the chunk box tests in the supers a ray enters and
   the prims of the chunks it enters, each within its final best), the
   chunks entered by a warp of 32 rays gated as one, by a warp of this
   kernel and by a ray on tile 0's launches (a replay of the walk), 2
   full-size K3b launches against the plain version and K3a, and K3b's
   box scan alone (rays that enter no box);
12. the trace kernels built with FMA contraction (without kernels.
   EXTRA_FLAGS' -fmad=false) against the default build, on the recorded
   launches of phases 7 and 9-11: time per launch and the distances'
   move;
13. the dense route and the carousel's other integrators: box_diffuse
   at 800x600, 3 bounces, through Renderer.advance with
   RenderConfig(use_kernels=False) over a 4-pass window (no kernel
   launched; rays/s, device busy time and idle share under
   torch.profiler) and one full-size pass against the megakernel
   route's under the megakernel protocol; montecarlo_aos with
   use_kernels=True, one pass of colonnes 800x600x6 (K3a, 96 launches)
   and of mesh_demo 800x600x8 at IOR 1.3 (K4a, 192 launches) through its
   AoS trace (ops/trace.trace): the launch counts, the image against the
   same integrator with kernels off under the megakernel protocol, the
   kernel's time per launch and by bounce with its work and bound, and
   every launch of the pass against the plain version bit for bit (rows,
   distances or a, K3a's a and dircode; the rows that differ printed);
   montecarlo_mat and montecarlo_mat_tr on box_diffuse 800x600, one pass
   each, finite and launching nothing;
14. gradients (render/diff.py): pixel_grads on the fast route (the
   pallas-trace route with its trace detached) on colonnes 800x600x6 at
   light 0.4, 2 passes, and mesh_demo 800x600x8, 1 pass, all rays in one
   call: K5's and K6's launches (only they, and none in the backward
   pass), the wall time of the forward and the backward pass, the peak
   device memory, every leaf finite and the albedo's gradient nonzero on
   some row; the kernel's time per launch, bound and plain version over
   the window's launches (a forward under torch.no_grad, recorded); the
   fast route's gradients against the dense route's on colonnes
   96x72x4, 2 passes (K5; color and mat: colonnes has no emissive prim,
   so its light_scale gradient is 0) and mesh_demo 64x48x4, 1 pass (K6;
   color, mat and light_scale), each within 1e-3 x the leaf's largest
   magnitude, which must not be 0; a central finite difference of the albedo channel
   with the largest gradient on colonnes 160x120x6 (rtol 0.05,
   tests/test_grad.py:39-50); 20 steps of inverse_render_fit on colonnes
   160x120x6 (three prims' albedo from (0.1, 0.6, 0.2)): the loss falls,
   ms and K5 launches per step;
15. the command line and the tools: cli.main render of box_diffuse
   800x600, 64 spp, 3 bounces (K1 only; its PNG equal to a Renderer's
   resolve with the same config), bench on box_diffuse (K1) and
   mesh_demo (K2, 8 passes of 8 bounces) with its JSON line, `python -m
   montecarlo_pathtracing_tpu_torch scenes` in a subprocess, sampling
   with each sampler; render_debug_png of each channel on mesh_demo
   800x600 (no kernel); colonnes' BVH with the native builder (g++ into
   the build directory) bit-equal to numpy's, and bvh_level_image;
16. multi-device rendering (parallel/): dryrun_multichip over the host's
   cards; (a) make_sharded_pass over an explicit 2-shard mesh on the one
   card ([cuda:0, cuda:0]: the shards run one after another on its
   stream, as K1's per-device work counter needs) renders box_diffuse
   800x600x3, 4 passes, through K1 (8 launches), its accumulator bit-equal
   to the unsharded Renderer's, with both windows' rays/s, and K1 on a
   shard against its plain version with its time (the card kept ahead),
   bound and its time on all rays in one launch; (b)
   make_sample_sharded_pass on that mesh (passes 0 and 1) against their
   sequential sum within 1e-6; (c) mesh_demo 800x600x8, one pass, on the
   2 shards (16 K2 launches) against one unsharded call under the fused
   protocol, with K2 on a shard timed and against its plain version with
   its bound; (d) Renderer(shard_devices=the card count), bit-equal to the
   unsharded, where the host has 2 cards or more (else said so), and
   make_mesh of more cards than the host has raises, naming the count;
   (e) `python -m montecarlo_pathtracing_tpu_torch render --distributed`
   in 2 processes on the card (gloo) at 800x600x3, 64 spp, a checkpoint
   every 16 passes: the checkpointed accumulators' sum against a
   single-process Renderer within rtol 1e-5, atol 1e-6 and process 0's
   PNG equal to it; testing/launcher_worker.py in 2 processes crashing
   after 16 local passes, then relaunched, resumes to the same image bit
   for bit; each process's start, card and rendezvous times;
17. multi-card rendering, where the host has 2 cards or more (one line
   says it was not run otherwise), at 2 cards and at the host's count n,
   every card's launches of each kernel counted (`launches_on`), each
   route's sharded pass run once under torch.cuda.set_sync_debug_mode
   and its host syncs counted by line, rays/s with the scaling
   efficiency (rays/s on n cards over n times one card's), and, under
   torch.profiler with CUDA activity on every card, each card's busy time
   and idle share and whether card k's first launch of a pass starts
   before card k-1's last one ends: (f) dryrun_multichip over the n
   cards; (a) box_diffuse 800x600x3 (K1), Renderer(shard_devices=2, n)
   against the unsharded Renderer over 8 passes bit for bit, with each
   card's peak memory, and make_sharded_pass over n cards against one
   call on all rays bit for bit, K1 on the last card's shard against its
   plain version with its time and bound; (b) BASELINE config 5
   (examples/config5_manyrays_torch.py's colonnes 1920x1080x3, K1 culled
   and transparent), Renderer(shard_devices=2, n) over 64 passes bit for
   bit against one card, its render at 1024 spp in one process and with
   --processes 2 and n --straight (a card each) within rtol 1e-5 of it,
   and with --processes n (a stop at half, tear-down and resume) bit for
   bit the straight run's, the processes on distinct cards; (c)
   mesh_demo 800x600x8 (K2), 2 passes of make_sharded_pass over 2 and n
   cards against one call on all rays on one card under the fused
   protocol, 16 K2 launches on each card, K2 on the last card's shard
   against its plain version; (d) make_sample_sharded_pass over n cards
   against the sequential sum on one card within 1e-6; (e) the
   pallas-trace route on colonnes (K5) and mesh_demo (K6) at 200x150,
   one pass over n cards against one card under the fused protocol, the
   kernel on the last card's shard against its plain version; (g)
   launcher_worker.py in 2 and n processes, a card each, on box_diffuse
   800x600x3 at 64 spp and mesh_demo 800x600x8 at 8 spp against one
   process, one worker's crash, the others stopped and the group
   relaunched, resumed bit for bit; `render --devices n` against
   `--devices 0`, the same PNG; `render --distributed` in n processes of
   a card and in 2 processes of n/2 cards against one process.

The last three lines are a {"kernels": [...]} JSON object (K1 on each
window, K5's tile walk on the cone and quad groups beside its colonnes
path, K3a and K4a on the AoS route of phase 13 beside their brute
pallas-trace paths, K5 and K6 on phase 14's gradient windows, K1 and K2
on a shard of phase 16's sharded passes, and where phase 17 ran K1, K2,
K5 and K6 on the last card's shard of its sharded passes with their
launches by card), the
card's name and power limit, and the {"ok":
true, "device": {...}} JSON object.
Every check raises, so any failed phase exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from montecarlo_pathtracing_tpu_torch import cli, kernels
from montecarlo_pathtracing_tpu_torch.graft_entry import dryrun_multichip
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.models import debug_views
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as ptk
from montecarlo_pathtracing_tpu_torch.ops import sparse_trace as spk
from montecarlo_pathtracing_tpu_torch.ops import trace as trace_mod
from montecarlo_pathtracing_tpu_torch.ops.rng import seed_y
from montecarlo_pathtracing_tpu_torch.ops.shapes import SOA_FNS
from montecarlo_pathtracing_tpu_torch.ops.sort_rays import ray_sort_key
from montecarlo_pathtracing_tpu_torch.ops.vec import safe_rcp
from montecarlo_pathtracing_tpu_torch.parallel.sharding import (
    make_mesh, make_sample_sharded_pass, make_sharded_pass, shard_rays)
from montecarlo_pathtracing_tpu_torch.render import diff
from montecarlo_pathtracing_tpu_torch.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import bvh_builder
from montecarlo_pathtracing_tpu_torch.scene import mesh as mesh_mod
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import (
    compile_scene, to_device)
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    FUSED_FRAC, FUSED_FRAC_STRESS, FUSED_TOL, all_shapes_scene,
    assert_fused_protocol,
    assert_megakernel_protocol, assert_trace_protocol, cull_mesh_scene,
    fused_match, group_chunk_boxes, megakernel_match, opaque_mesh_scene,
    random_group, random_rays, trace_match)
from montecarlo_pathtracing_tpu_torch.utils import profiling, transforms
from montecarlo_pathtracing_tpu_torch.utils.image import read_png, tonemap

K1_SOURCE = "montecarlo_pathtracing_tpu_torch/csrc/megakernel.cu"
K1_REPLACES = "montecarlo_pathtracing_tpu/models/megakernel.py:541"
K2_SOURCE = "montecarlo_pathtracing_tpu_torch/csrc/bounce_kernel.cu"
K2_REPLACES = "montecarlo_pathtracing_tpu/models/bounce_kernel.py:776"
TRACE_SOURCE = "montecarlo_pathtracing_tpu_torch/csrc/trace_kernels.cu"
# the trace kernels: (name in the kernels line, TPU kernel replaced, the
# CUDA kernel's name in a profile)
TRACE_KERNELS = {
    "K3a": ("K3a group_kernel",
            "montecarlo_pathtracing_tpu/ops/pallas_trace.py:162",
            "group_kernel"),
    "K3b": ("K3b group_culled_kernel",
            "montecarlo_pathtracing_tpu/ops/pallas_trace.py:251",
            "group_culled_kernel"),
    "K4a": ("K4a tri_kernel",
            "montecarlo_pathtracing_tpu/ops/pallas_trace.py:497",
            "tri_kernel"),
    "K4b": ("K4b tri_culled_kernel",
            "montecarlo_pathtracing_tpu/ops/pallas_trace.py:543",
            "tri_culled_kernel"),
    "K5": ("K5 an_walk", "montecarlo_pathtracing_tpu/ops/sparse_trace.py:139",
           "an_walk"),
    "K6": ("K6 mesh_walk",
           "montecarlo_pathtracing_tpu/ops/sparse_trace.py:374",
           "mesh_walk"),
}
# each trace kernel's wrapper, which counts its launches
TRACE_WRAPPERS = {"K3a": ptk.group_best_rows,
                  "K3b": ptk.group_best_rows_culled,
                  "K4a": ptk.mesh_best_rows,
                  "K4b": ptk.mesh_best_rows_culled,
                  "K5": spk.group_best_rows_sparse,
                  "K6": spk.mesh_best_rows_sparse}
# work counters per launch: tests, chunks or blocks visited, hits; the
# culled kernels add box tests (K3b, K4b) and supers entered (K4b)
N_WORK = {"K3b": 4, "K4b": 5}

# K1's parity scenes: each variant, and a table past what K1 stages
# (stress_1200: 1,288 columns, read from device memory)
PARITY_CASES = (("box_diffuse", 1.0), ("box_balls", 1.3), ("materials", 1.5),
                ("all_shapes", 1.3), ("stress_1200", 1.0))
# (name, IOR, share of pixels allowed more than 1e-3 off)
K2_CASES = (("mesh_demo", 1.3, FUSED_FRAC), ("flat_mesh", 1.0, FUSED_FRAC),
            ("stress_4200", 1.0, FUSED_FRAC_STRESS),
            ("cull_mesh", 1.3, FUSED_FRAC))

# Published peaks of one H100 SXM at its 700 W limit: FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations (a multiply, add, divide or square root each; an FMA
# two), counted from the kernels' source (common.cuh prim_work,
# bounce_step, mt_hit, slab_cap; trace_kernels.cu prim_hit): one bounce
# step's shading, one Moller-Trumbore test and one slab test
SHADE_OPS = 150
TRI_OPS = 51
BOX_OPS = 25
# a ray-prim test: the local frame (affine, linear, vnorm) and the shape
# test by shape code for every test; the hit point and world distance
# only where the shape test passes; the shading normal (normal_point, the
# forward affine, vnorm) only for a winner (K1, K2)
FRAME_OPS = 42
SHAPE_OPS = {1: 24, 2: 36, 3: 36, 4: 44, 5: 5}
PRIM_OPS = {code: FRAME_OPS + ops for code, ops in SHAPE_OPS.items()}
HIT_OPS = 33
NORMAL_OPS = 35
WIN_OPS = HIT_OPS + NORMAL_OPS


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# cycles of torch.cuda._sleep queued before each timed launch (about 2 ms
# at an H100's clock): the host queues the launch's events, its wrapper's
# small ops and the kernel while the card sleeps, so the events time the
# card's work and not the host's pace
KEEP_AHEAD = 4_000_000


def _timed(launch, ahead=True):
    """launch() between two CUDA events, the card kept busy while the
    host queues them unless `ahead` is False. Returns (launch's result,
    the events, late): late is True when the card had passed the first
    event before the host had queued the launch, so that the events'
    interval holds time the card spent waiting for the host."""
    if ahead:
        torch.cuda._sleep(KEEP_AHEAD)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = launch()
    late = e0.query()
    e1.record()
    return out, (e0, e1), late


@contextlib.contextmanager
def clocks(label, period_ms=100, out=None):
    """Sample the card's SM clock and power draw with nvidia-smi every
    period_ms while the block runs, and print their range; the median SM
    clock in MHz goes to out["mhz"] when `out` is a dict."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                pass
        if rows:
            mhz, watts = np.array(rows).T
            if out is not None:
                out["mhz"] = float(np.median(mhz))
            print(f"{label}: SM clock {mhz.min():.0f}-{mhz.max():.0f} MHz "
                  f"(median {np.median(mhz):.0f}), power {watts.min():.1f}-"
                  f"{watts.max():.1f} W over {len(rows)} samples",
                  flush=True)
        else:
            print(f"{label}: SM clock and power not measured", flush=True)


def bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def table_ops(tab, groups):
    """FP32 operations of one ray's test of every real prim of a table:
    the local frame and the shape test of each (PRIM_OPS)."""
    ok = (tab[31] > 0).cpu().numpy()
    return sum(PRIM_OPS[code] * int(ok[start:start + count].sum())
               for code, start, count, _ in groups)


def build_scene(name: str, device):
    if name == "all_shapes":
        prims = all_shapes_scene(scene_mod, transforms)
    elif name == "flat_mesh":
        return compile_scene(opaque_mesh_scene(scene_mod, mesh_mod,
                                               transforms),
                             flat_face=True, device=device)
    elif name == "cull_mesh":
        prims = cull_mesh_scene(scene_mod, mesh_mod, transforms)
    elif name.startswith("stress_"):
        prims = scenes.scene_stress(n_prims=int(name[len("stress_"):]))
    else:
        prims = scenes.build(name)
    return compile_scene(prims, device=device)


def _rays(device, w, h):
    proj, view = default_rt_camera(w, h)
    o, d, tc = camera_rays(proj, view, w, h, device=device)
    return o, d.reshape(-1, 3), tc.reshape(-1, 2)


def phase_parity(device, w=64, h=48, bounces=4):
    """K1 vs its plain version on the same inputs, per scene and pass."""
    o, d, tc = _rays(device, w, h)
    worst = 0.0
    for name, ior in PARITY_CASES:
        dev = build_scene(name, device)
        inp = mk.mega_inputs(dev, o, d, tc, ior)
        print(f"K1 variant {_k1_variant(inp)} on {name} ({inp.tab.shape[1]} "
              f"columns): {_k1_info_line(inp)}", flush=True)
        for p in (0, 3):
            got = mk.k1_launch(inp, seed_y(p), bounces)
            ref = mk.mega_pass_reference(inp, seed_y(p), bounces)
            got, ref = got.cpu().numpy(), ref.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"{name} pass {p}: non-finite K1 output")
            frac, dmean, err = megakernel_match(ref, got)
            print(f"parity {name} ior={ior} pass={p} cull={inp.cull} "
                  f"transparent={inp.has_transparent}: close={frac:.4f} "
                  f"mean_diff={dmean:.2e} max_abs_err={err:.3e}", flush=True)
            assert_megakernel_protocol(ref, got, f"K1 {name} pass {p}")
            worst = max(worst, err)
        black = mk.k1_launch(inp, seed_y(0), 0)
        if not bool((black == 0).all()):
            raise AssertionError(f"{name}: nb_bounces=0 is not black")
    print("parity nb_bounces=0: all black", flush=True)
    return worst


def _k1_variant(inp):
    return (f"{'transparent' if inp.has_transparent else 'opaque'}, "
            f"{'culled' if inp.cull else 'uncull'}")


def _k1_info_line(inp):
    info = mk.k1_kernel_info(inp)
    return (f"{info['registers']} registers, {info['local_bytes']} bytes "
            f"local (spills), {info['shared_bytes']} + "
            f"{info['dynamic_shared_bytes']} bytes shared a block, "
            f"{info['blocks_per_sm']} blocks of {info['threads']} threads "
            f"resident per SM")


def _k1_pass_ms(inps, bounces, reps=3):
    """K1 over one pass of the tiles' inputs `inps`, the card kept ahead
    of the host (_timed around the pass's launches): (median ms per pass
    over reps passes, passes whose events held host time)."""
    evs, late = [], 0
    for rep in range(reps):
        _, ev, was_late = _timed(lambda: [mk.k1_launch(inp, seed_y(rep),
                                                       bounces)
                                          for inp in inps])
        evs.append(ev)
        late += was_late
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in evs])), late


def _k1_bound(inps, needs):
    """Least ms the card could take for K1's pass over `inps`, from the
    work its inputs need (mk.K1Need of each, from the plain version's
    final bests): PRIM_OPS of each ray-prim test, BOX_OPS of each slab
    test, WIN_OPS of each trace that hits, SHADE_OPS of each bounce step;
    each real ray's 20 bytes in and 12 out, and the tables read once a
    launch. Returns (ms, "bytes" or "operations", ops, bytes)."""
    ops = nbytes = 0
    for inp, need in zip(inps, needs):
        ops += (SHADE_OPS * int(need.steps) + WIN_OPS * int(need.hits)
                + BOX_OPS * int(need.box)
                + sum(PRIM_OPS[code] * int(n) for code, n in
                      need.prim.items()))
        tables = [inp.tab, inp.group_desc] + ([inp.sbb, inp.ordr]
                                              if inp.cull else [])
        nbytes += 32 * inp.n + sum(t.numel() * t.element_size()
                                   for t in tables)
    ms, by = bound(nbytes, ops)
    return ms, by, ops, nbytes


def _k1_need_line(needs):
    """The work K1Needs counted, and the share of a warp's lane-bounces
    that carry a path when each warp runs 32 consecutive rays until its
    longest path ends (one thread a ray)."""
    steps = sum(int(n.steps) for n in needs)
    used = slots = 0
    for n in needs:
        path = torch.nn.functional.pad(n.path, (0, -n.path.numel() % 32))
        used += int(path.sum())
        slots += 32 * int(path.reshape(-1, 32).amax(dim=1).sum())
    prim = {}
    for n in needs:
        for code, k in n.prim.items():
            prim[code] = prim.get(code, 0) + int(k)
    return (f"{steps} bounce steps, {sum(int(n.traced) for n in needs)} "
            f"traces ({sum(int(n.hits) for n in needs)} hit), ray-prim tests "
            f"by shape {prim}, {sum(int(n.box) for n in needs)} slab tests; "
            f"lanes carrying a path {used / max(1, slots):.4f} of a warp's "
            f"lane-bounces (one thread a ray)")


def _time_passes(fn, n_passes):
    """Mean device time (ms) of fn(k) over n_passes calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(n_passes):
        fn(k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_passes


def _device_seconds(fn, kernel_name, cpu=True):
    """(device-busy s, the named kernel's share of it in s) of fn() under
    torch.profiler: the sum of the CUDA kernel and copy events, which run
    on one stream and so do not overlap. (0, 0) when the profiler sees no
    device activity. cpu=False traces the device only (cheaper)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    mine = sum(e.self_device_time_total for e in dev
               if kernel_name in e.key) / 1e6
    return busy, mine


def phase_main_path(device, w=800, h=600, bounces=3, window=64,
                    tile_rays=1 << 17):
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_kernels=True, device=device)
    r = Renderer(dev, cfg)
    t0 = time.perf_counter()
    r.advance(window)                       # warm-up window
    warm_s = time.perf_counter() - t0

    mk.k1_launch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(2 * window)                   # synchronizes before returning
    window_s = time.perf_counter() - t0
    launches = mk.k1_launch.launches
    if launches != window * r._ntiles:
        raise AssertionError(f"K1 launched {launches} times in the window, "
                             f"want {window} x {r._ntiles} tiles")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("main-path image is not finite and >= 0")
    rays_per_s = w * h * window * bounces / window_s
    print(f"main path: box_diffuse {w}x{h} {bounces} bounces, "
          f"{r._ntiles} tiles of {r._tile} rays, warm-up {warm_s:.3f} s, "
          f"{window}-pass window {window_s:.4f} s, K1 launches {launches}, "
          f"image mean {img.mean():.5f}", flush=True)

    # where the window's time goes: device busy per pass, from a profiled
    # 16-pass stretch, against the unprofiled window's wall time per pass
    busy, k1_dev = _device_seconds(lambda: r.advance(r.nb_passes + 16),
                                   "mega_kernel")
    idle = (f"{1.0 - busy / 16 * window / window_s:.4f}" if busy > 0
            else "not measured")
    print(f"main path device time per pass {busy / 16 * 1e3:.4f} ms "
          f"(K1 {k1_dev / 16 * 1e3:.4f} ms) of {window_s / window * 1e3:.4f} "
          f"ms wall per pass; device idle share {idle}", flush=True)

    # K1 through the renderer vs the plain version on the same tiles
    r4 = Renderer(dev, cfg)
    img_k1 = r4.run(4)
    inps = [mk.mega_inputs(dev, r4._origin, r4._dirs[t], r4._tc[t],
                           cfg.refract_ind) for t in range(r4._ntiles)]
    acc = torch.zeros_like(r4._accs[0])
    alive = []                    # rays in flight per tile and bounce

    def plain_pass(k):
        for t, inp in enumerate(inps):
            acc[t].add_(mk.mega_pass_reference(
                inp, seed_y(k), bounces, alive=alive if k == 0 else None))

    plain_ms = _time_passes(plain_pass, 4)
    img_ref = r4.resolve(acc, 4)
    frac, dmean, err = megakernel_match(img_ref, img_k1)
    print(f"main path 4-pass K1 vs plain: close={frac:.4f} "
          f"mean_diff={dmean:.2e} max_abs_err={err:.3e}", flush=True)
    assert_megakernel_protocol(img_ref, img_k1, "main path 4 passes")

    k1_ms, late = _k1_pass_ms(inps, bounces)
    # K1 by the depth of its paths: the pass with 1, 2, ... bounces, beside
    # the rays in flight at each bounce (the plain version's, pass 0)
    for b in range(1, bounces + 1):
        ms_b = k1_ms if b == bounces else _k1_pass_ms(inps, b)[0]
        in_flight = [sum(alive[t * bounces + k] for t in range(len(inps)))
                     for k in range(b)]
        print(f"K1 box_diffuse {w}x{h} with nb_bounces={b}: {ms_b:.5f} ms "
              f"per pass (the card kept ahead, median of 3); rays in flight "
              f"by bounce {in_flight}", flush=True)
    needs = [mk.K1Need(inp) for inp in inps]
    for inp, need in zip(inps, needs):
        mk.mega_pass_reference(inp, seed_y(0), bounces, need=need)
    bound_ms, bound_by, ops, nbytes = _k1_bound(inps, needs)
    print(f"K1 bound per pass {bound_ms:.5f} ms ({bound_by}: {ops:.4g} FP32 "
          f"operations, {nbytes} bytes; {_k1_need_line(needs)}); K1 "
          f"{k1_ms:.5f} ms, {late} of 3 passes late", flush=True)
    return dict(rays_per_s=rays_per_s, window_s=window_s, launches=launches,
                k1_ms=k1_ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by)


# K1's other variants at full size, each the route's own choice on a
# BASELINE configuration (benchmarks/configs.py): (scene, light, IOR,
# width, height, bounces, passes in the window)
K1_WINDOWS = (("materials", 1.2, 1.0, 800, 600, 6, 8),
              ("box_balls", 0.4, 1.5, 800, 600, 6, 8),
              ("colonnes", 0.4, 1.0, 1920, 1080, 6, 2))
K1_SLICE = 8 * mk.TILE      # rays of the slice held against the plain K1


def phase_k1_window(device, name, light, ior, w, h, bounces, window,
                    tile_rays=1 << 17):
    """One of K1_WINDOWS through compile_scene and Renderer.advance on the
    auto route: K1's launch count over the window (passes x tiles), the
    image finite and non-negative, the device's idle share under
    torch.profiler, K1's ms per pass with the card kept ahead (_k1_pass_ms)
    and its compiled variant, and on one K1_SLICE-ray slice of tile 0
    (4096-ray aligned, so that its super visit order is the tile's) one
    pass of K1 against the plain version under the megakernel protocol,
    with the slice's needed work (mk.K1Need) and bound beside K1's time on
    the slice."""
    dev = compile_scene(scenes.build(name, light), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       refract_ind=ior, light_intensity=light,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_kernels=True, device=device)
    r = Renderer(dev, cfg)
    r.advance(window)                       # warm-up window
    mk.k1_launch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(2 * window)
    window_s = time.perf_counter() - t0
    launches = mk.k1_launch.launches
    if launches != window * r._ntiles:
        raise AssertionError(f"{name}: K1 launched {launches} times in the "
                             f"window, want {window} x {r._ntiles} tiles")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError(f"{name}: image is not finite and >= 0")
    busy, k1_dev = _device_seconds(lambda: r.advance(r.nb_passes + window),
                                   "mega_kernel")
    idle = (f"{1.0 - busy / window_s:.4f}" if busy > 0
            else "not measured")
    inps = [mk.mega_inputs(dev, r._origin, r._dirs[t], r._tc[t], ior)
            for t in range(r._ntiles)]
    k1_ms, late = _k1_pass_ms(inps, bounces)
    what = f"K1 {name} {w}x{h}x{bounces}"
    print(f"{what} (variant {_k1_variant(inps[0])}, {inps[0].tab.shape[1]}"
          f" columns, {r._ntiles} tiles of {r._tile} rays): {launches} "
          f"launches in a {window}-pass window of {window_s:.4f} s "
          f"({w * h * window * bounces / window_s:.6g} rays/s); device busy "
          f"{busy / window * 1e3:.4f} ms per pass (K1 {k1_dev / window * 1e3:.4f}"
          f"), idle share {idle}; K1 {k1_ms:.5f} ms per pass (the card kept "
          f"ahead, median of 3, {late} late); {_k1_info_line(inps[0])}",
          flush=True)

    # one slice of tile 0 against the plain version, with its needed work
    sl = mk.mega_inputs(dev, r._origin, r._dirs[0][:K1_SLICE],
                        r._tc[0][:K1_SLICE], ior)
    got = mk.k1_launch(sl, seed_y(0), bounces)
    need = mk.K1Need(sl)
    t0 = time.perf_counter()
    ref = mk.mega_pass_reference(sl, seed_y(0), bounces, need=need)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite K1 output on the slice")
    frac, dmean, err = megakernel_match(ref, got)
    print(f"{what} slice of {K1_SLICE} rays, pass 0, K1 vs plain: "
          f"close={frac:.4f} mean_diff={dmean:.2e} max_abs_err={err:.3e} "
          f"(plain {plain_s:.2f} s)", flush=True)
    assert_megakernel_protocol(ref, got, f"{what} slice")
    slice_ms, _ = _k1_pass_ms([sl], bounces)
    bound_ms, bound_by, ops, nbytes = _k1_bound([sl], [need])
    print(f"{what} slice: K1 {slice_ms:.5f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {ops:.4g} FP32 operations, {nbytes} bytes; "
          f"{_k1_need_line([need])}); scaled to the pass "
          f"({w * h} rays): bound {bound_ms * w * h / K1_SLICE:.5f} ms",
          flush=True)
    return dict(launches=launches, ms=k1_ms, slice_ms=slice_ms,
                bound_slice=bound_ms, bound_ms=bound_ms * w * h / K1_SLICE,
                bound_by=bound_by, plain_ms=plain_s * 1e3, max_abs_err=err,
                window_s=window_s, idle=idle, name=name)


def _k2_call(shape):
    """A K2 call of raytrace_fused that launches K2 in the given shape
    (None: the wrapper's own choice)."""
    def call(inp, stf, sti, whole_path):
        bk.k2_launch(inp, stf, sti, whole_path, shape=shape)
    return call


def phase_k2_parity(device, w=64, h=48, bounces=4):
    """K2 vs its plain version through raytrace_fused, per scene, mode
    (wavefront and whole path), pass and launch shape (each forced, and
    the wrapper's own choice)."""
    o, d, tc = _rays(device, w, h)
    worst = 0.0
    for name, ior, frac in K2_CASES:
        dev = build_scene(name, device)
        for whole in (False, True):
            for p in (0, 3):
                ref = bk.raytrace_fused(dev, o, d, tc, p, nb_bounces=bounces,
                                        refract_ind=ior, whole_path=whole,
                                        call=bk.fused_call_reference)
                ref = ref.cpu().numpy()
                for shape in bk.SHAPES + (None,):
                    got = bk.raytrace_fused(
                        dev, o, d, tc, p, nb_bounces=bounces, refract_ind=ior,
                        whole_path=whole, call=_k2_call(shape)).cpu().numpy()
                    what = (f"K2 {name} {'whole path' if whole else 'wavefront'}"
                            f" pass {p} shape {shape or 'auto'}")
                    if not np.isfinite(got).all():
                        raise AssertionError(f"{what}: non-finite K2 output")
                    off, err = fused_match(ref, got)
                    print(f"{what} ior={ior} meshes={len(dev.mesh_prim_index)}"
                          f" large_groups={len(dev.ana_groups)} "
                          f"cull_small={bk.cull_small(dev)} "
                          f"transparent={dev.has_transparent} "
                          f"flat_face={dev.flat_face}: off={off:.4f} (allowed "
                          f"{frac}) max_abs_err={err:.3e}", flush=True)
                    assert_fused_protocol(ref, got, what, frac)
                    worst = max(worst, err)
            for shape in bk.SHAPES:
                black = bk.raytrace_fused(dev, o, d, tc, 0, nb_bounces=0,
                                          refract_ind=ior, whole_path=whole,
                                          call=_k2_call(shape))
                if not bool((black == 0).all()):
                    raise AssertionError(f"{name}: nb_bounces=0 is not black")
    print("K2 parity nb_bounces=0: all black", flush=True)
    return worst


def _record_pass(r, pass_index):
    """Run one pass of renderer r's tiles through raytrace_fused, keeping
    each K2 call's inputs (a copy of the state before the call)."""
    rec = []

    def record(inp, stf, sti, whole_path):
        rec.append((inp, stf.clone(), sti.clone(), whole_path))
        bk.fused_call(inp, stf, sti, whole_path)

    cfg = r.config
    for t in range(r._ntiles):
        bk.raytrace_fused(r.scene, r._origin, r._dirs[t], r._tc[t],
                          pass_index, nb_bounces=cfg.nb_bounces,
                          refract_ind=cfg.refract_ind, date=cfg.date,
                          call=record)
    torch.cuda.synchronize()
    return rec


# the schedule kernel against _schedules on the card: its mesh segments'
# 3x3 products may sum in another order than cuBLAS's, so an entry bound
# may be an ulp or 1e-6 (relative to max(1, |bound|)) off, far inside the
# schedule's 1e-4 shrink and margin; the large and small groups' segments
# take the same rounded ops in the same order as the torch ops
SCHED_TOL = 1e-6


def _schedule_vs_plain(what, dev, calls):
    """K2's schedule kernel (bk.k2_schedule_launch) against `_schedules`
    run on the same card, on each recorded call's (inp, stf): the route's
    own schedule in inp bit for bit (the kernel is deterministic); the
    large and small groups' segments bit for bit, entries and orders; the
    mesh segments' entries within 1 ulp or SCHED_TOL, and their orders
    equal wherever no other entry of the tile lies within 4 ulps or
    SCHED_TOL (tests/test_torch_bounce_kernel.py's rule). Prints and
    returns (entries, mesh entries, mesh entries bit-equal, largest mesh
    error relative to max(1, |bound|))."""
    n = n_mesh = n_bits = 0
    worst = 0.0
    for inp, stf in calls:
        ref_o, ref_e = bk._schedules(dev, stf[0:3], stf[3:6])
        got_o, got_e = bk.k2_schedule_launch(inp, stf)
        if not (torch.equal(got_o, inp.ordr)
                and torch.equal(_bits_t(got_e), _bits_t(inp.entr))):
            raise AssertionError(f"{what}: the schedule kernel gave another "
                                 f"schedule on the same state")
        ro, go = ref_o[:, 0].cpu().numpy(), got_o[:, 0].cpu().numpy()
        re_, ge = ref_e[:, 0].cpu().numpy(), got_e[:, 0].cpu().numpy()
        if go.shape != ro.shape or go.dtype != ro.dtype:
            raise AssertionError(f"{what}: schedule {go.shape} {go.dtype}, "
                                 f"plain {ro.shape} {ro.dtype}")
        ms = inp.mesh_stot
        if not (np.array_equal(ge[:, ms:].view(np.int32),
                               re_[:, ms:].view(np.int32))
                and np.array_equal(go[:, ms:], ro[:, ms:])):
            raise AssertionError(f"{what}: a large or small group's segment "
                                 f"differs from the plain version's")
        n += re_.size
        if ms == 0:
            continue
        e, g = re_[:, :ms].astype(np.float64), ge[:, :ms].astype(np.float64)
        ulps = np.abs(re_[:, :ms].view(np.int32).astype(np.int64)
                      - ge[:, :ms].view(np.int32).astype(np.int64))
        scale = np.maximum(1.0, np.abs(e))
        err = np.abs(g - e) / scale
        if not ((ulps <= 1) | (err <= SCHED_TOL)).all():
            raise AssertionError(f"{what}: a mesh entry bound {err.max():.3e}"
                                 f" off the plain version's")
        near = np.abs(e[:, :, None] - e[:, None, :]) <= np.maximum(
            4 * np.spacing(np.abs(e).astype(np.float32))[:, :, None],
            SCHED_TOL * scale[:, :, None])
        clear = near.sum(axis=2) == 1
        if not np.array_equal(go[:, :ms][clear], ro[:, :ms][clear]):
            raise AssertionError(f"{what}: a mesh segment's order differs "
                                 f"where its bounds have no near-tie")
        n_mesh += e.size
        n_bits += int((ulps == 0).sum())
        worst = max(worst, float(err.max()))
    print(f"schedule kernel vs plain, {what}: {len(calls)} schedules, {n} "
          f"entries; mesh entries {n_bits} of {n_mesh} bit-equal, largest "
          f"error {worst:.3e} of max(1, |bound|); group segments bit-equal",
          flush=True)
    return n, n_mesh, n_bits, worst


def phase_schedule_parity(device, w=64, h=48, bounces=4):
    """The schedule kernel against `_schedules` on the card on each K2
    case's recorded K2 calls through raytrace_fused (both modes): mesh
    instances, flat faces, large groups, and a culled small table
    (cull_mesh, inp.cull set)."""
    o, d, tc = _rays(device, w, h)
    for name, ior, _frac in K2_CASES:
        dev = build_scene(name, device)
        for whole in (False, True):
            calls = []

            def record(inp, stf, sti, whole_path):
                calls.append((inp, stf.clone()))
                bk.fused_call(inp, stf, sti, whole_path)

            bk.raytrace_fused(dev, o, d, tc, 3, nb_bounces=bounces,
                              refract_ind=ior, whole_path=whole, call=record)
            _schedule_vs_plain(
                f"{name} {'whole path' if whole else 'wavefront'} "
                f"cull_small={bk.cull_small(dev)}", dev, calls)


def _time_launches(rec, shape=None, reps=5, count=True, ahead=True):
    """K2 over the recorded calls of one pass in the given shape (None:
    the kernel's choice), by CUDA events around each launch (_timed),
    reps times: (ms per launch, ms per pass, the pass's work counters,
    each call's ms, launches late). Each call's ms is its median over the
    reps. The work counters (tri, box, prim, traces, lane slots of the
    chunk folds) come from an untimed pass of K2's counting build, when
    `count`; late counts the timed launches whose events held host
    time."""
    work = torch.zeros(5, dtype=torch.int64, device=rec[0][1].device)
    if count:
        for inp, stf0, sti0, whole_path in rec:
            bk.k2_launch(inp, stf0.clone(), sti0.clone(), whole_path, work,
                         shape=shape)
    events, late = [], 0
    for rep in range(reps):
        for inp, stf0, sti0, whole_path in rec:
            stf, sti = stf0.clone(), sti0.clone()
            _, ev, was_late = _timed(
                lambda: bk.k2_launch(inp, stf, sti, whole_path, shape=shape),
                ahead)
            events.append(ev)
            late += was_late
    torch.cuda.synchronize()
    ms = np.array([e0.elapsed_time(e1) for e0, e1 in events])
    ms_call = np.median(ms.reshape(reps, len(rec)), axis=0)
    return (ms_call.mean(), ms_call.sum(), [int(x) for x in work.cpu()],
            ms_call, late)


def _lane_share(work):
    """Share of the warps' lane slots in K2's chunk folds that tested a
    triangle or prim for a ray that needed it (1 - divergence)."""
    return f"{(work[0] + work[2]) / work[4]:.4f}" if work[4] else "none"


def _k2_need(rec):
    """The plain version replayed on each recorded call's inputs on the
    card, counting the work those inputs need (bk.K2Need, from each
    trace's final best); returns it and the replay's ms per pass (CUDA
    events)."""
    need = bk.K2Need(rec[0][0], rec[0][1].device)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for inp, stf, sti, whole_path in rec:
        bk.fused_call_reference(inp, stf.clone(), sti.clone(), whole_path,
                                need=need)
    e1.record()
    torch.cuda.synchronize()
    return need, e0.elapsed_time(e1)


def _k2_bound(rec, need):
    """Least ms the card could take for the recorded pass's K2 work, from
    what its inputs need (_k2_need), not from K2's own walks: the
    triangle, prim and slab tests of the chunks and supers each ray enters
    within its trace's final best, one fold of the small table per trace,
    one shading step per ray in flight, one hit point and normal per trace
    that hits; each launch reads every ray's done flag, the rest of each
    live ray's state and the tables once, and writes each live ray's
    state once."""
    inp0 = rec[0][0]
    prim_ops = sum(PRIM_OPS[g[0]] * int(n)
                   for g, n in zip(inp0.ana_groups, need.prim.cpu()))
    ops = (TRI_OPS * int(need.tri) + BOX_OPS * int(need.box) + prim_ops
           + int(need.traced) * table_ops(inp0.tab, inp0.groups)
           + SHADE_OPS * int(need.steps) + WIN_OPS * int(need.hits))
    tables = (inp0.tab, inp0.gsbb, inp0.msc, inp0.cbb, inp0.sbb, inp0.tpool,
              inp0.acbb, inp0.asbb, inp0.apool, inp0.agr)
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    nbytes = 0
    for inp, stf, sti, _ in rec:
        live = int((sti[0] == 0).sum())
        words = stf.shape[0] + sti.shape[0]         # 19 per ray
        nbytes += 4 * sti.shape[1] + live * (2 * words - 1) * 4 + table_bytes
        nbytes += inp.ordr.numel() * 4 + inp.entr.numel() * 4
    ms, by = bound(nbytes, ops)
    print(f"K2 needed work of the pass (plain version's final best): "
          f"{int(need.tri)} ray-triangle tests, {need.prim.tolist()} ray-prim "
          f"tests per large group, {int(need.box)} ray-box tests, "
          f"{int(need.traced)} traces ({int(need.hits)} hits), "
          f"{int(need.steps)} bounce steps", flush=True)
    return ms, by, ops, nbytes


def _k2_by_shape(rec, bounces, ntiles, label):
    """K2 over the recorded pass in the shape the kernel chooses ("auto")
    and in each shape forced: ms per pass, by bounce with the rays in
    flight, work and lane share, printed, and each launch's rays to scan
    against each shape's time; returns {label: (ms per launch, ms per
    pass, work, ms of each launch)}."""
    out = {}
    alive = [sum(int((sti[0] == 0).sum()) for _, _, sti, _ in rec[b::bounces])
             for b in range(bounces)]
    for name in ("auto",) + bk.SHAPES:
        shape = None if name == "auto" else name
        with clocks(f"K2 {label} shape {name} timed alone"):
            ms_launch, ms_pass, work, ms_call, late = _time_launches(
                rec, shape)
        by_bounce = ms_call.reshape(ntiles, bounces).sum(axis=0)
        print(f"K2 {label} shape {name}: {ms_launch:.4f} ms per launch, "
              f"{ms_pass:.4f} ms per pass ({len(rec)} launches, median of "
              f"5, {late} timed launches late); work per "
              f"pass: {work[0]} ray-triangle tests, {work[2]} ray-prim tests, "
              f"{work[1]} ray-box tests, {work[3]} traces; lane share of the "
              f"chunk folds {_lane_share(work)}", flush=True)
        print(f"K2 {label} shape {name} by bounce (ms per pass, rays in "
              f"flight): " + ", ".join(
                  f"{b}: {t:.4f} ms {a}"
                  for b, (t, a) in enumerate(zip(by_bounce, alive))),
              flush=True)
        out[name] = (ms_launch, ms_pass, work, ms_call)
    # the same launches timed as before this harness kept the card ahead:
    # the events then also hold the time the card waits for the host to
    # queue each launch
    paced = _time_launches(rec, None, count=False, ahead=False)
    print(f"K2 {label} shape auto, host-paced events: {paced[0]:.4f} ms per "
          f"launch, {paced[1]:.4f} ms per pass ({paced[4]} of "
          f"{5 * len(rec)} launches late)", flush=True)
    # launch by launch: the rays to scan against each shape's time, from
    # which MANY_RAYS is set, and the shape the kernel took
    scan = [int(bk._n_scan(sti)) for _, _, sti, _ in rec]
    print(f"K2 {label} per launch (rays to scan: "
          + " / ".join(f"{k} lanes" for k in bk.SHAPES) + " ms, taken): "
          + ", ".join(
              f"{scan[i]}: " + " / ".join(f"{out[k][3][i]:.3f}"
                                          for k in bk.SHAPES)
              + f" {bk.k2_shape(scan[i], rec[i][3])}"
              for i in sorted(range(len(rec)), key=lambda i: scan[i])),
          flush=True)
    return out


def phase_k2_main(device, w=800, h=600, bounces=8, window=8,
                  tile_rays=1 << 17):
    dev = compile_scene(scenes.build("mesh_demo"), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_kernels=True, device=device)
    r = Renderer(dev, cfg)
    t0 = time.perf_counter()
    r.advance(2)                            # warm-up
    warm_s = time.perf_counter() - t0

    bk.k2_launch.launches = bk.k2_schedule_launch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(2 + window)                   # synchronizes before returning
    window_s = time.perf_counter() - t0
    launches = bk.k2_launch.launches
    scheduled = bk.k2_schedule_launch.launches
    if launches != window * r._ntiles * bounces or scheduled != launches:
        raise AssertionError(f"K2 launched {launches} times and its schedule "
                             f"kernel {scheduled} in the window, want "
                             f"{window} passes x {r._ntiles} tiles x "
                             f"{bounces} bounces of each")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("mesh_demo image is not finite and >= 0")
    rays_per_s = w * h * window * bounces / window_s
    print(f"K2 main path: mesh_demo {w}x{h} {bounces} bounces, "
          f"{r._ntiles} tiles of {r._tile} rays, warm-up {warm_s:.3f} s, "
          f"{window}-pass window {window_s:.4f} s, K2 launches {launches}, "
          f"schedule launches {scheduled}, image mean {img.mean():.5f}, {rays_per_s:.6g} rays/s", flush=True)

    prof_passes = 2
    busy, k2_dev = _device_seconds(
        lambda: r.advance(r.nb_passes + prof_passes), "fused_kernel")
    wall_pass = window_s / window
    idle = (f"{1.0 - busy / prof_passes / wall_pass:.4f}" if busy > 0
            else "not measured")
    print(f"K2 main path device time per pass {busy / prof_passes * 1e3:.4f}"
          f" ms (K2 {k2_dev / prof_passes * 1e3:.4f} ms) of "
          f"{wall_pass * 1e3:.4f} ms wall per pass; device idle share {idle}",
          flush=True)

    # K2 alone, by CUDA events over one recorded pass's launches, in the
    # shapes the wrapper chose and in each shape forced
    rec = _record_pass(r, r.nb_passes)
    _schedule_vs_plain(f"mesh_demo {w}x{h}, {r._ntiles} tiles x {bounces} "
                       f"bounces", dev, [(x[0], x[1]) for x in rec])
    by_shape = _k2_by_shape(rec, bounces, r._ntiles, "mesh_demo")
    ms_launch, ms_pass = by_shape["auto"][:2]
    need, replay_ms = _k2_need(rec)
    bound_ms, bound_by, ops, nbytes = _k2_bound(rec, need)
    print(f"K2 alone (auto): {ms_launch:.4f} ms per launch, {ms_pass:.4f} ms "
          f"per pass; bound {bound_ms:.4f} ms per pass ({bound_by}: {ops:.4g} "
          f"FP32 operations, {nbytes} bytes); plain version on the same "
          f"launches {replay_ms:.1f} ms", flush=True)

    # the host's share: the per-bounce re-sort and schedules (the schedule
    # kernel's launch, and the plain torch ops it replaced), each timed
    # alone on a bounce-1 state of tile 0 (host clock, synchronized)
    inp, stf, sti, _ = rec[1]
    lo, hi = dev.prim_bb_min.amin(dim=0), dev.prim_bb_max.amax(dim=0)
    def sort_once():
        key = ray_sort_key((stf[0], stf[1], stf[2]), (stf[3], stf[4], stf[5]),
                           sti[0] != 0, lo, hi)
        perm = torch.argsort(key, stable=True)
        return stf[:, perm], sti[:, perm]

    def timed(fn, n=10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    sort_ms = timed(sort_once)
    sched_ms = timed(lambda: bk.with_schedule(inp, dev, stf))
    plain_sched_ms = timed(lambda: bk._schedules(dev, stf[0:3], stf[3:6]))
    host_pass = r._ntiles * ((bounces - 1) * sort_ms + bounces * sched_ms)
    print(f"K2 main path host: re-sort {sort_ms:.4f} ms and schedules "
          f"{sched_ms:.4f} ms (the kernel's launch; the plain torch ops "
          f"{plain_sched_ms:.4f} ms) per (tile, bounce), {host_pass:.3f} ms "
          f"per pass of {wall_pass * 1e3:.3f} ms wall", flush=True)

    # K2 through the renderer vs the plain version on the same tiles
    r2 = Renderer(dev, cfg)
    img_k2 = r2.run(2)
    acc = torch.zeros_like(r2._accs[0])

    def plain_pass(k):
        for t in range(r2._ntiles):
            acc[t].add_(bk.raytrace_fused(
                dev, r2._origin, r2._dirs[t], r2._tc[t], k,
                nb_bounces=bounces, refract_ind=cfg.refract_ind,
                date=cfg.date, call=bk.fused_call_reference))

    plain_ms = _time_passes(plain_pass, 2)
    img_ref = r2.resolve(acc, 2)
    off, err = fused_match(img_ref, img_k2)
    print(f"K2 main path 2-pass K2 vs plain at {w}x{h}: off={off:.4f} "
          f"max_abs_err={err:.3e}; plain {plain_ms:.1f} ms per pass",
          flush=True)
    assert_fused_protocol(img_ref, img_k2, "K2 main path 2 passes")
    return dict(rays_per_s=rays_per_s, window_s=window_s, launches=launches,
                ms_launch=ms_launch, k2_ms=ms_pass, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                wall_pass_ms=wall_pass * 1e3, by_shape=by_shape)


def _whole_path_vs_plain(dev, name, ws, hs, bounces, tile_rays, device):
    """One pass of compiled scene `dev` at ws x hs through Renderer (K2,
    whole path) against the same tiles through the plain version, under
    the fused protocol with FUSED_FRAC_STRESS: (the renderer, max abs
    error)."""
    cfg_s = RenderConfig(width=ws, height=hs, nb_bounces=bounces,
                         tile_rays=tile_rays, use_kernels=True, device=device)
    rs = Renderer(dev, cfg_s)
    img_k2 = rs.run(1)
    acc = torch.zeros_like(rs._accs[0])
    for t in range(rs._ntiles):
        acc[t].add_(bk.raytrace_fused(
            dev, rs._origin, rs._dirs[t], rs._tc[t], 0, nb_bounces=bounces,
            refract_ind=cfg_s.refract_ind, date=cfg_s.date,
            call=bk.fused_call_reference))
    img_ref = rs.resolve(acc, 1)
    off, err = fused_match(img_ref, img_k2)
    print(f"K2 whole path {name} 1-pass K2 vs plain at {ws}x{hs}: "
          f"off={off:.4f} (allowed {FUSED_FRAC_STRESS}) max_abs_err={err:.3e}",
          flush=True)
    assert_fused_protocol(img_ref, img_k2, f"{name} 1 pass",
                          FUSED_FRAC_STRESS)
    return rs, err


def phase_k2_whole_path(device, w=800, h=600, bounces=3, window=4,
                        tile_rays=1 << 17, ws=200, hs=150):
    """K2's whole-path mode on stress_10k: a short window at w x h, K2 by
    shape over one recorded pass; then a 1-pass accumulation at ws x hs
    against the plain version, with K2's time, the plain version's and
    the bound on that pass."""
    dev = compile_scene(scenes.build("stress_10k"), device=device)
    if dev.mesh_prim_index or not dev.ana_groups:
        raise AssertionError("stress_10k should be analytic with large groups")
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_kernels=True, device=device)
    r = Renderer(dev, cfg)
    r.advance(1)                            # warm-up
    bk.k2_launch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(1 + window)
    window_s = time.perf_counter() - t0
    if bk.k2_launch.launches != window * r._ntiles:
        raise AssertionError(f"stress_10k: K2 launched "
                             f"{bk.k2_launch.launches} times, want "
                             f"{window} x {r._ntiles}")
    img = r.image()
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("stress_10k image is not finite and >= 0")
    print(f"K2 whole path: stress_10k {w}x{h} {bounces} bounces, "
          f"{len(dev.ana_groups)} large groups, {window}-pass window "
          f"{window_s:.4f} s ({window_s / window * 1e3:.3f} ms wall per pass, "
          f"{w * h * window * bounces / window_s:.6g} rays/s)", flush=True)
    rec = _record_pass(r, r.nb_passes)
    by_shape = _k2_by_shape(rec, 1, r._ntiles, f"stress_10k {w}x{h}")

    # a small accumulation against the plain version, and the bound
    rs, err = _whole_path_vs_plain(dev, "stress_10k", ws, hs, bounces,
                                   tile_rays, device)
    rec_s = _record_pass(rs, 0)
    small = _k2_by_shape(rec_s, 1, rs._ntiles, f"stress_10k {ws}x{hs}")
    need, replay_ms = _k2_need(rec_s)
    bound_ms, bound_by, ops, nbytes = _k2_bound(rec_s, need)
    print(f"K2 whole path stress_10k {ws}x{hs}: K2 {small['auto'][1]:.4f} ms "
          f"per pass; bound {bound_ms:.4f} ms ({bound_by}: {ops:.4g} FP32 "
          f"operations, {nbytes} bytes); plain version {replay_ms:.1f} ms",
          flush=True)
    return dict(by_shape=by_shape, small=small, bound_ms=bound_ms,
                plain_ms=replay_ms, max_abs_err=err)


def phase_k2_whole_menger(device, w=1280, h=1000, bounces=3, window=8,
                          windows=4, ws=160, hs=125):
    """K2's whole-path mode on menger_d2 (key E's sponge at depth 2,
    8,010 prims) through compile_scene and Renderer.advance at the
    viewer's defaults, nothing forced: the route, the pool's size on the
    `scene.compile` span, one whole-path launch a tile call over
    `windows` windows of `window` passes with each window's rays/s, the
    `whole_path` attrs of the `k2.launch` spans and the inputs kept from
    the warm-up, K2's time a pass over one recorded pass; then a 1-pass accumulation at
    ws x hs against the plain version."""
    profiling.take_spans()
    profiling.enable_spans()
    try:
        dev = compile_scene(scenes.build("menger_d2"), device=device)
        compiled = profiling.take_spans()
    finally:
        profiling.enable_spans(False)
    attrs = [s.attrs for s in compiled if s.name == "scene.compile"]
    if (mk.mega_eligible(dev) or not bk.fused_eligible(dev)
            or dev.mesh_prim_index or len(dev.ana_groups) != 1
            or attrs != [{"prims": 8010, "ana_groups": 1,
                          "ana_chunks": dev.ana_groups[0][2]}]):
        raise AssertionError(f"menger_d2 should take K2's whole path over "
                             f"one pool group: {dev.ana_groups}, {attrs}")
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       passes_per_call=window, device=device)
    r = Renderer(dev, cfg)
    bk.k2_schedule_launch.launches = 0
    r.advance(window)                       # warm-up
    if bk.k2_schedule_launch.launches != r._ntiles:
        raise AssertionError(f"menger_d2: {bk.k2_schedule_launch.launches} "
                             f"schedule launches in the warm-up, want one "
                             f"a tile ({r._ntiles})")
    rates = []
    for _ in range(windows):
        bk.k2_launch.launches = bk.k2_launch.whole_path_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.advance(r.nb_passes + window)
        rates.append(w * h * window * bounces / (time.perf_counter() - t0))
        if not (bk.k2_launch.launches == bk.k2_launch.whole_path_launches
                == window * r._ntiles):
            raise AssertionError(
                f"menger_d2: {bk.k2_launch.launches} K2 launches, "
                f"{bk.k2_launch.whole_path_launches} whole-path, want "
                f"{window} x {r._ntiles} of each")
    if bk.k2_schedule_launch.launches != r._ntiles:
        raise AssertionError(f"menger_d2: the schedule kernel ran in the "
                             f"windows ({bk.k2_schedule_launch.launches} "
                             f"launches since the warm-up's start)")
    profiling.enable_spans()
    try:
        r.advance(r.nb_passes + 1)
        spans = profiling.take_spans()
    finally:
        profiling.enable_spans(False)
    got = [s.attrs.get("whole_path") for s in spans if s.name == "k2.launch"]
    if got != [bounces] * r._ntiles:
        raise AssertionError(f"menger_d2 k2.launch spans: {got}")
    built = [s.attrs.get("built") for s in spans if s.name == "k2.inputs"]
    if built != [False] * r._ntiles:
        raise AssertionError(f"menger_d2 rebuilt its inputs: {built}")
    if any(s.name in ("k2.sort", "k2.schedule") for s in spans):
        raise AssertionError("menger_d2: a whole-path pass re-sorted or "
                             "scheduled again")
    img = r.image()
    if not np.isfinite(img).all() or (img < 0).any():
        raise AssertionError("menger_d2 image is not finite and >= 0")
    print(f"K2 whole path: menger_d2 {w}x{h} {bounces} bounces, "
          f"{dev.ana_groups[0][2]} pool chunks, {r._ntiles} tiles, one "
          f"whole-path launch a tile call; rays/s over {windows} windows of "
          f"{window} passes: " + ", ".join(f"{x:.6g}" for x in rates),
          flush=True)
    rec = _record_pass(r, r.nb_passes)
    _schedule_vs_plain(f"menger_d2 {w}x{h} whole path, {r._ntiles} tiles",
                       dev, [(x[0], x[1]) for x in rec])
    by_shape = _k2_by_shape(rec, 1, r._ntiles, f"menger_d2 {w}x{h}")

    _, err = _whole_path_vs_plain(dev, "menger_d2", ws, hs, bounces,
                                  cfg.tile_rays, device)
    return dict(rates=rates, by_shape=by_shape, max_abs_err=err)


def run_k2(name_power):
    """Phases 4 and 5 (K2 and its schedule kernel against their plain
    versions, K2's main path on mesh_demo)."""
    phase_schedule_parity("cuda")
    worst2 = phase_k2_parity("cuda")
    print(f"phase-4 K2 parity worst max_abs_err {worst2:.3e}", flush=True)
    res2 = phase_k2_main("cuda")
    print(f"[{name_power}] mesh_demo end to end {res2['rays_per_s']:.6g} "
          f"rays/s (800x600 x 8 passes x 8 bounces / "
          f"{res2['window_s']:.4f} s); K2 {res2['ms_launch']:.4f} ms/launch, "
          f"{res2['k2_ms']:.4f} ms/pass (forced: " + ", ".join(
              f"{k} {v[1]:.4f}" for k, v in res2["by_shape"].items()
              if k != "auto") + f"; bound {res2['bound_ms']:.4f} ms, "
          f"{res2['bound_by']}); plain version {res2['plain_ms']:.1f} ms/pass",
          flush=True)
    return res2


def run_whole(name_power):
    """Phase 6 (K2's whole-path mode on stress_10k and menger_d2)."""
    res6 = phase_k2_whole_path("cuda")
    print(f"[{name_power}] stress_10k whole path: K2 " + ", ".join(
        f"{k} {v[1]:.4f}" for k, v in res6["by_shape"].items())
          + " ms/pass at 800x600; at 200x150 " + ", ".join(
        f"{k} {v[1]:.4f}" for k, v in res6["small"].items())
          + f" ms/pass (bound {res6['bound_ms']:.4f} ms, plain "
          f"{res6['plain_ms']:.1f} ms)", flush=True)
    resm = phase_k2_whole_menger("cuda")
    print(f"[{name_power}] menger_d2 whole path 1280x1000x3: K2 " + ", ".join(
        f"{k} {v[1]:.4f}" for k, v in resm["by_shape"].items())
          + " ms/pass; rays/s by window " + ", ".join(
        f"{x:.6g}" for x in resm["rates"]), flush=True)
    return res6, resm


# --------------------------------------------------------------------------
# the pallas-trace route: K3a, K4a, K5, K6
# --------------------------------------------------------------------------

def _reset_counts():
    """Every kernel's launch count to 0, and K1's, K2's, K5's and K6's by
    card."""
    mk.k1_launch.launches = 0
    bk.k2_launch.launches = 0
    for wrapper in TRACE_WRAPPERS.values():
        wrapper.launches = 0
    for wrapper in CARD_WRAPPERS.values():
        wrapper.launches_on.clear()


def _all_counts():
    out = {"K1": mk.k1_launch.launches, "K2": bk.k2_launch.launches}
    out.update({k: w.launches for k, w in TRACE_WRAPPERS.items()})
    return out


@contextlib.contextmanager
def plain_trace_kernels():
    """Within the block, the pallas-trace route (ops/trace.trace_soa) runs
    the trace kernels' plain versions on the card instead of the
    kernels."""
    def k3a(o, d, code, inv_r, trf_r, pid, cbb=None):
        if cbb is not None:
            return ptk.group_best_rows_culled_plain(o, d, code, inv_r, trf_r,
                                                    pid, cbb)
        return ptk.group_best_rows_plain(o, d, code, inv_r, trf_r, pid)

    def k4a(o, d, tri, cbb=None, sbb=None):
        if cbb is not None:
            return ptk.mesh_best_rows_culled_plain(
                o, d, tri, *((cbb, sbb) if sbb is not None
                             else ptk.super_boxes(cbb)))
        return ptk.mesh_best_rows_plain(o, d, tri)

    def k5(o, d, code, inv_r, trf_r, pid, sup_bb):
        return spk.an_fold_plain(
            o, d, *spk.an_inputs(o, d, inv_r, trf_r, pid, sup_bb), code)

    def k6(o, d, tri, cbb):
        return spk.mesh_fold_plain(o, d, tri, *spk.mesh_inputs(o, d, tri, cbb))

    plain = {"group_best_rows": k3a, "mesh_best_rows": k4a,
             "group_best_rows_sparse": k5, "mesh_best_rows_sparse": k6}
    saved = {name: getattr(trace_mod, name) for name in plain}
    for name, fn in plain.items():
        setattr(trace_mod, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(trace_mod, name, fn)


# where each trace kernel is launched from: (module, function); K3b,
# K4b, K5 and K6 by their launch functions, so that a recorded call holds
# the kernel's own inputs (K4b's super boxes, K5's and K6's ranked
# schedule and bounds included)
_LAUNCH_SITES = {"K3a": (trace_mod, "group_best_rows"),
                 "K3b": (ptk, "group_best_culled"),
                 "K4a": (trace_mod, "mesh_best_rows"),
                 "K4b": (ptk, "mesh_best_culled"),
                 "K5": (spk, "an_fold"), "K6": (spk, "mesh_fold")}


def _plain_of(kid, args):
    """The plain version of recorded launch args of kernel kid."""
    if kid == "K3a":
        return ptk.group_best_rows_plain(*args[:6])
    if kid == "K3b":
        return ptk.group_best_rows_culled_plain(*args[:7])
    if kid == "K4a":
        return ptk.mesh_best_rows_plain(*args[:3])
    if kid == "K4b":
        return ptk.mesh_best_rows_culled_plain(*args[:5])
    if kid == "K5":
        return spk.an_fold_plain(*args[:7])
    return spk.mesh_fold_plain(*args[:6])


@contextlib.contextmanager
def record_launches(kid, rec):
    """Within the block, every launch of trace kernel kid on the route is
    appended to rec as (launch function, args, keywords), then run."""
    mod, name = _LAUNCH_SITES[kid]
    real = getattr(mod, name)

    def recording(*args, **kw):
        rec.append((real, args, {k: v for k, v in kw.items() if k != "work"}))
        return real(*args, **kw)

    setattr(mod, name, recording)
    try:
        yield
    finally:
        setattr(mod, name, real)


def _needed(kid, args, out):
    """The work one launch's function needs on its inputs, as int64
    device scalars (tests, hits, box tests): the tests that cost FRAME_OPS
    plus SHAPE_OPS (K3a, K3b, K5) or TRI_OPS each (K4a, K4b, K6), the hits
    that cost HIT_OPS more (K3a, K3b, K5), and the slab tests that cost
    BOX_OPS each (K3b, K4b). A brute fold (K3a, K4a) tests every ray
    against every real prim or triangle; K3a's hits are the pairs among
    those whose shape test passes (_group_passes), the same for any order
    of that fold. Every culled fold and walk has one rule: a ray must
    fold the real prims or triangles of each chunk or block whose box it
    enters within its final best (K3b, K4b: _culled_needed; a culled fold
    tests every ray against every super box and, in the supers the ray
    enters so, every real leaf box) or its
    final min(best, bound) (K5: the 8-prim blocks' boxes sup_bb; K6: the
    128-triangle chunks' boxes, the bounds of their real triangles). K3b's
    and K5's hits are counted once per ray with a winner, the least any
    fold needs. `out` is the launch's result."""
    o = args[0]
    zero = torch.zeros((), dtype=torch.int64, device=o.device)
    if kid == "K3a":
        code, inv_r, pid = args[2], args[3], args[5]
        real = pid[0] >= 0
        return (o.shape[1] * real.sum(),
                _group_passes(o, args[1], code, inv_r[:, real]), zero)
    if kid == "K4a":
        tri = args[2]
        return o.shape[1] * (tri != 0).any(dim=0).sum(), zero, zero
    if kid in ("K3b", "K4b"):
        return _culled_needed(kid, args, out)
    if kid == "K5":
        tab, bnd, boxes = args[2], args[5], args[7]
        per_unit = (tab[:, 24, :] > 0).sum(dim=1)
    else:
        tri, bnd = args[2], args[5]
        real = (tri != 0).any(dim=0)
        per_unit = real.reshape(-1, ptk.PRIM_CHUNK).sum(dim=1)
        boxes = _tri_chunk_boxes(tri, real)
    cap = torch.minimum(out[0], bnd)
    units = per_unit > 0
    tests = _entered_items(o, safe_rcp(args[1]), boxes[:, units], cap,
                           per_unit[units])
    return tests, ((out[1] >= 0).sum() if kid == "K5" else zero), zero


def _group_passes(o, d, code, inv, step=128):
    """The (ray, prim) pairs of rays o, d [3, M] and prims with inverse
    rows inv [12, n] whose shape test passes: the plain version's local
    frame and SOA shape test (ptk._group_chunk), `step` prims at a time."""
    fn = SOA_FNS[code]
    ox, oy, oz = (o[k][:, None] for k in range(3))
    dx, dy, dz = (d[k][:, None] for k in range(3))
    total = torch.zeros((), dtype=torch.int64, device=o.device)
    for c in range(0, inv.shape[1], step):
        iv = [inv[r, c:c + step][None, :] for r in range(12)]
        lox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
        loy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
        loz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
        tdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
        tdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
        tdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        nrm = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy + tdz * tdz),
                          min=1e-30)
        _, valid, _ = fn(lox, loy, loz, tdx / nrm, tdy / nrm, tdz / nrm)
        total += valid.sum()
    return total


def _tri_chunk_boxes(tri, real):
    """[6, n] boxes of the n 128-triangle chunks of tri [9, n * 128]: the
    bounds of their real triangles' corners (compile_scene's chunk
    boxes); empty (inf, -inf) for a chunk with none."""
    corners = tri.reshape(3, 3, -1)                   # [corner, xyz, tri]
    lo = torch.where(real, corners, float("inf")).amin(dim=0)
    hi = torch.where(real, corners, float("-inf")).amax(dim=0)
    return torch.cat([lo.reshape(3, -1, ptk.PRIM_CHUNK).amin(dim=2),
                      hi.reshape(3, -1, ptk.PRIM_CHUNK).amax(dim=2)])


def _entered_items(o, rd, boxes, cap, per_box, step=64):
    """The sum over rays and box columns of boxes [6, n] of per_box [n]
    where the ray enters the box within its cap (the kernels' slab test),
    `step` boxes at a time."""
    total = torch.zeros((), dtype=torch.int64, device=o.device)
    for c in range(0, boxes.shape[1], step):
        hit = _enters(o, rd, boxes[:, c:c + step], cap)
        total += (hit.to(torch.int64) * per_box[None, c:c + step]).sum()
    return total


def _enters(o, rd, boxes, best, step=64):
    """[M, n] whether each ray enters each box column of boxes [6, n]
    within its best (the kernels' slab test), `step` boxes at a time."""
    cols = [ptk._slab_enters(o[:, :, None], rd[:, :, None],
                             boxes[:, None, c:c + step], best[:, None])
            for c in range(0, boxes.shape[1], step)]
    return torch.cat(cols, dim=1)


def _group_super_boxes(cbb):
    """K3b's super boxes, as its kernel builds them on the card
    (super_of_chunks): box s the exact union of chunk boxes 16 s .. 16 s +
    15 of cbb [6, n], the minimum of their minima and the maximum of their
    maxima; [6, ceil(n / 16)]."""
    pad = -cbb.shape[1] % ptk.GROUP_SUPER
    lo = torch.nn.functional.pad(cbb[:3], (0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(cbb[3:], (0, pad), value=float("-inf"))
    return torch.cat([lo.reshape(3, -1, ptk.GROUP_SUPER).amin(dim=2),
                      hi.reshape(3, -1, ptk.GROUP_SUPER).amax(dim=2)])


def _culled_needed(kid, args, out):
    """_needed of K3b and K4b, from the launch's final best. Both count
    every super box's test, the leaf box tests of the supers a ray enters
    within its final best, and the real items of the leaves it enters so
    (K3b: supers of 16 chunks that its kernel builds, _group_super_boxes;
    K4b: the instance's super boxes)."""
    o, d = args[0], args[1]
    rd = safe_rcp(d)
    best = out[0]
    if kid == "K3b":
        pid, cbb = args[5], args[6]
        per_chunk = (pid[0] >= 0).reshape(-1, ptk.PRIM_CHUNK).sum(dim=1)
        real = per_chunk > 0
        sbb = _group_super_boxes(cbb)
        sup = _enters(o, rd, sbb, best)                      # [M, nsuper]
        leaf_sup = sup.repeat_interleave(ptk.GROUP_SUPER, dim=1)[
            :, :cbb.shape[1]][:, real]
        leaf = _enters(o, rd, cbb[:, real], best) & leaf_sup
        tests = (leaf.to(torch.int64) * per_chunk[real][None, :]).sum()
        real_sup = torch.nn.functional.pad(
            real, (0, -real.numel() % ptk.GROUP_SUPER)).reshape(
                -1, ptk.GROUP_SUPER).any(dim=1)
        boxes = o.shape[1] * real_sup.sum() + leaf_sup.sum()
        return tests, (out[1] >= 0).sum(), boxes
    tri, cbb, sbb = args[2:5]
    nreal = tri.shape[1] // ptk.PRIM_CHUNK
    per_chunk = (tri != 0).any(dim=0).reshape(nreal, ptk.PRIM_CHUNK).sum(dim=1)
    sup = _enters(o, rd, sbb, best)                          # [M, nsuper]
    leaf_sup = sup.repeat_interleave(ptk.TRI_SUPER, dim=1)[:, :nreal]
    leaf = _enters(o, rd, cbb[:, :nreal], best) & leaf_sup
    tests = (leaf.to(torch.int64) * per_chunk[None, :]).sum()
    boxes = o.shape[1] * sbb.shape[1] + leaf_sup.sum()
    return tests, torch.zeros_like(tests), boxes


def _needed_ops(kid, args, tests, hits, boxes):
    """FP32 operations of `tests` tests, `hits` hits and `boxes` slab
    tests of kernel kid's recorded launch."""
    if kid in ("K4a", "K4b", "K6"):
        return TRI_OPS * tests + BOX_OPS * boxes
    code = args[2] if kid in ("K3a", "K3b") else args[6]
    return (FRAME_OPS + SHAPE_OPS[code]) * tests + HIT_OPS * hits \
        + BOX_OPS * boxes


def _launch_bytes(kid, args):
    """Bytes one launch must move: every tensor input read once, the
    outputs (4 rows for K3a and K5, 2 for K4a and K6) written once."""
    m = args[0].shape[1]
    ins = sum(a.numel() * a.element_size() for a in args
              if isinstance(a, torch.Tensor))
    return ins + (16 if kid in ("K3a", "K5") else 8) * m


def _time_recorded(kid, rec, reps=3, ahead=True, count=True):
    """Kernel kid over the recorded launches of one pass, by CUDA events
    around each launch (_timed), reps times after an untimed pass that
    counts (when `count`): (ms of each launch, its median over the reps;
    the launch's work counters [tests, chunks or blocks visited, hits,
    and N_WORK's more]; the work its function needs [tests, hits, box
    tests], see _needed; the timed launches late)."""
    dev = rec[0][1][0].device
    work = torch.zeros((len(rec), N_WORK.get(kid, 3)), dtype=torch.int64,
                       device=dev)
    needed = torch.zeros((len(rec), 3), dtype=torch.int64, device=dev)
    for i, (real, args, kw) in enumerate(rec if count else ()):
        out = real(*args, **kw, work=work[i])
        needed[i] = torch.stack(_needed(kid, args, out))
    events, late = [], 0
    for rep in range(reps):
        for real, args, kw in rec:
            _, ev, was_late = _timed(lambda: real(*args, **kw), ahead)
            events.append(ev)
            late += was_late
    torch.cuda.synchronize()
    ms = np.array([e0.elapsed_time(e1) for e0, e1 in events])
    return (np.median(ms.reshape(reps, len(rec)), axis=0), work.cpu().numpy(),
            needed.cpu().numpy(), late)


def _plain_vs_kernel(kid, rec, n=8, sub=None):
    """Kernel kid against its plain version on a subset of n recorded
    full-size launches (every k-th of the pass, or the launches `sub`):
    K3a, K3b, K4a, K4b and K6 by _check_exact (rows equal on EXACT_ROWS of
    the rays, distances or a bit-equal where they are, and K3a's a and
    dircode), K5 under the trace protocol, and each side's mean ms per
    launch by CUDA events. Returns (plain ms, kernel ms on the same
    launches, max abs error)."""
    if sub is None:
        sub = rec[::max(1, len(rec) // n)]
    plain_ms, kern_ms, err = [], [], 0.0
    for real, args, kw in sub:
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        got = real(*args, **kw)
        e[1].record()
        e[2].record()
        ref = _plain_of(kid, args)
        e[3].record()
        torch.cuda.synchronize()
        kern_ms.append(e[0].elapsed_time(e[1]))
        plain_ms.append(e[2].elapsed_time(e[3]))
        what = f"{kid} full-size launch vs plain"
        if kid != "K5":
            err = max(err, _check_exact(what, ref, got, every=kid == "K3a"))
            continue
        ref2 = (ref[0].cpu().numpy(), ref[1].cpu().numpy())
        got2 = (got[0].cpu().numpy(), got[1].cpu().numpy())
        assert_trace_protocol(ref2, got2, what)
        err = max(err, trace_match(*ref2, *got2)[3])
    print(f"{kid} full size vs plain on {len(sub)} launches of the pass: "
          f"plain {np.mean(plain_ms):.3f} ms per launch, {kid} "
          f"{np.mean(kern_ms):.4f} ms on the same launches; max abs err "
          f"{err:.3e}", flush=True)
    return float(np.mean(plain_ms)), float(np.mean(kern_ms)), err


def _check_trace(what, ref, got, verbose=True):
    """Hold (dist, row) of two folds to the trace protocol; print (unless
    not `verbose`) and return the max abs distance error."""
    ref = (ref[0].cpu().numpy(), ref[1].cpu().numpy())
    got = (got[0].cpu().numpy(), got[1].cpu().numpy())
    frac, bad, rel, err = trace_match(*ref, *got)
    if verbose:
        print(f"{what}: rows equal {frac:.5f}, differing rows without equal "
              f"distance {bad}, max rel err {rel:.2e}, max abs err "
              f"{err:.3e}, hits {(ref[1] >= 0).mean():.4f}", flush=True)
    assert_trace_protocol(ref, got, what)
    return err


def _mixed_rays(dev, w, h, m, seed):
    """m world rays [3, m]: the first half primaries of a w x h camera
    (scanline order), the second half random rays (uniform origins in the
    scene's box, random unit directions); directions unit."""
    proj, view = default_rt_camera(w, h)
    o, d, _ = camera_rays(proj, view, w, h, device=dev.device)
    half = m // 2
    dp = d.reshape(-1, 3)[:half]
    dp = (dp / torch.linalg.vector_norm(dp, dim=-1, keepdim=True)).T
    lo = dev.prim_bb_min.amin(dim=0).cpu().numpy()
    hi = dev.prim_bb_max.amax(dim=0).cpu().numpy()
    ro, rd = random_rays(m - half, seed)
    ro = lo[:, None] + (ro + 80.0) / 160.0 * (hi - lo)[:, None]
    o_rows = torch.cat([o.reshape(3, 1).expand(3, half).to(torch.float32),
                        torch.as_tensor(ro, device=dev.device)], dim=1)
    d_rows = torch.cat([dp, torch.as_tensor(rd, device=dev.device)], dim=1)
    return o_rows.contiguous(), d_rows.contiguous()


def _local_rays(dev, mi, o_rows, d_rows):
    """World ray rows in mesh instance mi's local frame, unit directions."""
    inv = dev.inv_transfo[dev.mesh_prim_index[mi]]
    oi = inv[:3, :3] @ o_rows + inv[:3, 3:4]
    di = inv[:3, :3] @ d_rows
    di = di / torch.clamp(torch.linalg.vector_norm(di, dim=0), min=1e-30)
    return oi.contiguous(), di.contiguous()


def _instance_tris(dev, mi):
    off, cnt = dev.mesh_tri_offset[mi], dev.mesh_tri_padded[mi]
    return ptk.pad_tris(dev.tri_va[off:off + cnt], dev.tri_vb[off:off + cnt],
                        dev.tri_vc[off:off + cnt])


# the trace kernels but K5 against their plain versions: rows equal on
# this share of rays at least, and distances bit for bit where rows are
# equal (the trace kernels are built without FMA contraction,
# kernels.EXTRA_FLAGS)
EXACT_ROWS = 0.9999


def _bits(x):
    """A float32 or int32 tensor's bits as a numpy int32 array."""
    x = x.contiguous()
    return (x.view(torch.int32) if x.dtype == torch.float32
            else x.to(torch.int32)).cpu().numpy()


def _bits_t(x):
    """A float32 or int32 tensor's bits as an int32 tensor."""
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 \
        else x.to(torch.int32)


def _check_exact(what, ref, got, every=False, verbose=True):
    """_check_trace, and rows equal on EXACT_ROWS of the rays with equal
    distances where the rows are equal; with `every`, the fold's other
    outputs (K3a's a and dircode) bit-equal there too. Prints how many rows
    differ unless not `verbose`."""
    err = _check_trace(what, ref, got, verbose)
    rr, gr = ref[1].cpu().numpy(), got[1].cpu().numpy()
    same = rr == gr
    if verbose:
        print(f"{what}: {int((~same).sum())} of {same.size} rows differ",
              flush=True)
    outs = (0,) + (tuple(range(2, len(ref))) if every else ())
    if same.mean() < EXACT_ROWS or not all(np.array_equal(
            _bits(ref[i])[same], _bits(got[i])[same]) for i in outs):
        raise AssertionError(f"{what}: rows equal on {same.mean():.6f} of "
                             f"rays (need {EXACT_ROWS}) or outputs {outs} not "
                             f"bit-equal where rows are")
    return err


def _k5_behind(o, d, code, trf, tables, reps=5):
    """K5 on a random cone or quad group (300 prims, past
    trace.SMALL_GROUP_MAX, so that a route would take K5): its tile walk
    by _check_exact against an_fold_plain (rows, distances, a and dircode
    bit for bit), and the per-ray gate these shapes had before
    (an_fold(per_ray=True)) on the same inputs, whose differing rows are
    printed (ROADMAP C.11); the median ms of each over `reps` launches
    (_timed), the plain version's, the compiled kernel, and the tile
    walk's bound from the work its inputs need (_needed). Returns a
    kernels-line result of the tile walk."""
    sup = torch.as_tensor(group_chunk_boxes(trf, tables[0].shape[1],
                                            spk.SUP), device=o.device)
    inputs = spk.an_inputs(o, d, *tables, sup)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    ref = spk.an_fold_plain(o, d, *inputs, code)
    e1.record()
    launches = TRACE_WRAPPERS["K5"].launches
    got = spk.group_best_rows_sparse(o, d, code, *tables, sup)
    launches = TRACE_WRAPPERS["K5"].launches - launches
    what = f"K5 shape {code} ({tables[0].shape[1]} prims)"
    err = _check_exact(f"{what}, tile walk, vs plain", ref, got, every=True)
    old = spk.an_fold(o, d, *inputs, code, sup, per_ray=True)
    rr, orow = ref[1].cpu().numpy(), old[1].cpu().numpy()
    diff = rr != orow
    ties = diff & (_bits(ref[0]) == _bits(old[0]))
    times = {}
    for name, per_ray in (("tile walk", False), ("per-ray gate", True)):
        evs = [_timed(lambda: spk.an_fold(o, d, *inputs, code, sup,
                                          per_ray=per_ray))[1]
               for _ in range(reps)]
        torch.cuda.synchronize()
        times[name] = float(np.median([a.elapsed_time(b) for a, b in evs]))
    info = ptk.trace_kernel_info("K5", code)
    print(_info_line("K5", info), flush=True)
    args = (o, d, *inputs, code, sup)
    tests, hits, boxes = (int(x) for x in _needed("K5", args, got))
    bound_ms, bound_by = bound(_launch_bytes("K5", args),
                               _needed_ops("K5", args, tests, hits, boxes))
    print(f"{what}: the per-ray gate differs from plain on {int(diff.sum())}"
          f" of {diff.size} rows ({int(ties.sum())} of them exact distance "
          f"ties); tile walk {times['tile walk']:.4f} ms, per-ray gate "
          f"{times['per-ray gate']:.4f} ms per launch (median of {reps}); "
          f"plain {e0.elapsed_time(e1):.3f} ms; tile walk's bound "
          f"{bound_ms:.5f} ms ({bound_by}, {tests} tests needed)", flush=True)
    return dict(ms=times["tile walk"], plain_ms=e0.elapsed_time(e1),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                launches=launches, info=info, per_ray_rows=int(diff.sum()))


def phase_trace_parity(device, tile_rays=1 << 17, hires_rays=8192):
    """Each trace kernel against its plain version on the card, and the
    pruned walks and culled folds against the brute folds on the same rays
    (the reference's invariants, tests/test_sparse_trace.py:27-54 and
    tests/test_pallas_trace.py:138-189). The K4b calls here are its path:
    no route of the renderer reaches it (ops/trace.py), the op
    mesh_best_rows(cbb=..., sbb=...) does, and this drives it as the
    reference's TPU smoke does (testing/tpu_smoke.py:87-110). Returns the
    worst max abs error per kernel, K4b's recorded launches and its launch
    count over them, and K5's results on the cone and quad groups."""
    worst = {k: 0.0 for k in TRACE_KERNELS}
    behind = {}
    # K3a on a random ~200-prim group per shape code, K3b on a 300-prim one
    # with its chunk boxes, K5 on the cone and quad ones; two ray tiles
    o_np, d_np = random_rays(2048, 7)
    o = torch.as_tensor(o_np, device=device)
    d = torch.as_tensor(d_np, device=device)
    for code in sorted(SHAPE_OPS):
        trf, inv, pid = (torch.as_tensor(a, device=device) for a in
                         random_group(transforms, code, 200, 100 * code + 200))
        tables = ptk._pad_group(trf, inv, pid)
        got = ptk.group_best_rows(o, d, code, *tables)
        ref = ptk.group_best_rows_plain(o, d, code, *tables)
        worst["K3a"] = max(worst["K3a"], _check_exact(
            f"K3a shape {code} vs plain", ref, got, every=True))
        trf, inv, pid = random_group(transforms, code, 300, 100 * code + 300)
        tables = ptk._pad_group(*(torch.as_tensor(a, device=device)
                                  for a in (trf, inv, pid)))
        cbb = torch.as_tensor(group_chunk_boxes(trf, tables[0].shape[1]),
                              device=device)
        got = ptk.group_best_rows(o, d, code, *tables, cbb=cbb)
        ref = ptk.group_best_rows_culled_plain(o, d, code, *tables, cbb)
        worst["K3b"] = max(worst["K3b"], _check_exact(
            f"K3b shape {code} (300 prims) vs plain", ref, got))
        if code in mk.HITS_BEHIND:
            behind[code] = _k5_behind(o, d, code, trf, tables)
            worst["K5"] = max(worst["K5"], behind[code]["max_abs_err"])

    # K5, K3a and K3b on colonnes' two large groups, one 1<<17 ray tile
    dev = compile_scene(scenes.build("colonnes", 0.4), device=device)
    o, d = _mixed_rays(dev, 1920, 1080, tile_rays, 11)
    for gi, code in enumerate(dev.group_codes):
        if dev.group_prim[gi].shape[0] <= trace_mod.SMALL_GROUP_MAX:
            continue
        tables = ptk._pad_group(dev.group_transfo[gi], dev.group_inv[gi],
                                dev.group_prim[gi])
        sbb, cbb = dev.group_super_bb[gi], dev.group_chunk_bb[gi]
        k5 = spk.group_best_rows_sparse(o, d, code, *tables, sbb)
        p5 = spk.an_fold_plain(o, d, *spk.an_inputs(o, d, *tables, sbb), code)
        k3 = ptk.group_best_rows(o, d, code, *tables)
        p3 = ptk.group_best_rows_plain(o, d, code, *tables)
        k3b = ptk.group_best_rows(o, d, code, *tables, cbb=cbb)
        p3b = ptk.group_best_rows_culled_plain(o, d, code, *tables, cbb)
        tag = f"colonnes group {gi} (shape {code}, {tables[0].shape[1]} prims)"
        worst["K5"] = max(worst["K5"], _check_trace(f"K5 {tag} vs plain",
                                                    p5, k5))
        worst["K3a"] = max(worst["K3a"], _check_exact(f"K3a {tag} vs plain",
                                                      p3, k3, every=True))
        worst["K3b"] = max(worst["K3b"], _check_exact(f"K3b {tag} vs plain",
                                                      p3b, k3b))
        _check_trace(f"K5 vs K3a {tag}", k3, k5)
        _check_trace(f"K3b vs K3a {tag}", k3, k3b)
        _check_trace(f"K3b vs K5 {tag}", k5, k3b)

    # K4a, K4b and K6 on each mesh_demo instance at one 1<<17 ray tile (K4b
    # with the instance's super boxes), and on mesh_hires's sphere at 8192
    # rays (the brute plain fold stays cheap; K4b with and without them)
    rec4b = []
    TRACE_WRAPPERS["K4b"].launches = 0
    with record_launches("K4b", rec4b):
        for name, m in (("mesh_demo", tile_rays), ("mesh_hires", hires_rays)):
            dev = compile_scene(scenes.build(name), device=device)
            o, d = _mixed_rays(dev, 800, 600, m, 13)
            for mi in range(len(dev.mesh_prim_index)):
                if name == "mesh_hires" and mi > 0:
                    break
                oi, di = _local_rays(dev, mi, o, d)
                tri = _instance_tris(dev, mi)
                cbb, sbb = dev.mesh_chunk_bb[mi], dev.mesh_super_bb[mi]
                k6 = spk.mesh_best_rows_sparse(oi, di, tri, cbb)
                p6 = spk.mesh_fold_plain(oi, di, tri,
                                         *spk.mesh_inputs(oi, di, tri, cbb))
                k4 = ptk.mesh_best_rows(oi, di, tri)
                p4 = ptk.mesh_best_rows_plain(oi, di, tri)
                tag = (f"{name} instance {mi} ({tri.shape[1] // 128} chunks "
                       f"under {cbb.shape[1]} leaf boxes, {m} rays)")
                worst["K6"] = max(worst["K6"], _check_exact(
                    f"K6 {tag} vs plain", p6, k6))
                worst["K4a"] = max(worst["K4a"], _check_exact(
                    f"K4a {tag} vs plain", p4, k4))
                _check_trace(f"K6 vs K4a {tag}", k4, k6)
                for supers in ((sbb, None) if name == "mesh_hires"
                               else (sbb,)):
                    k4b = ptk.mesh_best_rows(oi, di, tri, cbb=cbb, sbb=supers)
                    p4b = ptk.mesh_best_rows_culled_plain(
                        oi, di, tri, *((cbb, sbb) if supers is not None
                                       else ptk.super_boxes(cbb)))
                    what = "" if supers is not None else ", sbb=None"
                    worst["K4b"] = max(worst["K4b"], _check_exact(
                        f"K4b {tag}{what} vs plain", p4b, k4b))
                    _check_trace(f"K4b vs K4a {tag}{what}", k4, k4b)
                    _check_trace(f"K4b vs K6 {tag}{what}", k6, k4b)
    launches = TRACE_WRAPPERS["K4b"].launches
    if launches != len(rec4b) or launches == 0:
        raise AssertionError(f"K4b launched {launches} times for "
                             f"{len(rec4b)} calls of the op")
    torch.cuda.synchronize()
    return worst, rec4b, launches, behind


K4B_LANES = (4, 8, 16)


def phase_k4b_stats(rec):
    """K4b over phase 7's launches: ms per launch (CUDA events) at each of
    K4B_LANES lanes a ray (each bit-equal to the default's), its work and
    bound, its compiled kernel, and the plain version on the same
    launches. No render route reaches K4b, so these are its numbers."""
    default = [real(*args, **kw) for real, args, kw in rec]
    for lanes in K4B_LANES:
        forced = [(real, args, dict(kw, lanes=lanes)) for real, args, kw in rec]
        for (_, args, kw), ref in zip(forced, default):
            got = ptk.mesh_best_culled(*args, **kw)
            if not all(torch.equal(_bits_t(x), _bits_t(y))
                       for x, y in zip(got, ref)):
                raise AssertionError(f"K4b at {lanes} lanes differs from "
                                     f"its default")
        ms_l = _time_recorded("K4b", forced, count=False)[0]
        print(f"K4b at {lanes} lanes a ray on phase 7's {len(rec)} launches: "
              + ", ".join(f"{t:.4f}" for t in ms_l)
              + f" ms ({ms_l.mean():.4f} mean)", flush=True)
    print(_info_line("K4b", ptk.trace_kernel_info("K4b")), flush=True)
    ms, work, needed, _ = _time_recorded("K4b", rec)
    ops = sum(_needed_ops("K4b", args, int(n[0]), int(n[1]), int(n[2]))
              for n, (_, args, _) in zip(needed, rec))
    nbytes = sum(_launch_bytes("K4b", args) for _, args, _ in rec)
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"K4b alone on phase 7's {len(rec)} launches: "
          + ", ".join(f"{t:.4f}" for t in ms) + f" ms ({ms.mean():.4f} "
          f"mean); work: {int(work[:, 0].sum())} tests done "
          f"({int(needed[:, 0].sum())} needed), {int(work[:, 2].sum())} hits,"
          f" {int(work[:, 1].sum())} leaf chunks and {int(work[:, 4].sum())} "
          f"supers entered, {int(work[:, 3].sum())} box tests "
          f"({int(needed[:, 2].sum())} needed); bound "
          f"{bound_ms / len(rec):.5f} ms per launch ({bound_by}: {ops:.4g} "
          f"FP32 operations, {nbytes} bytes)", flush=True)
    plain_ms, _, err = _plain_vs_kernel("K4b", rec, sub=rec)
    return dict(ms=float(ms.mean()), plain_ms=plain_ms,
                bound_ms=bound_ms / len(rec), bound_by=bound_by,
                max_abs_err=err, rec=rec, info=ptk.trace_kernel_info("K4b"))


ROUTE_CASES = (("colonnes", 0.4, 1.0), ("mesh_demo", 1.2, 1.3))


def phase_trace_route_parity(device, w=64, h=48, bounces=4):
    """The pallas-trace route with the kernels against the route with
    their plain versions, through models.montecarlo.raytrace, under the
    fused protocol; nb_bounces=0 gives black."""
    o, d, tc = _rays(device, w, h)
    worst = 0.0
    for name, light, ior in ROUTE_CASES:
        dev = compile_scene(scenes.build(name, light), device=device)
        for p in (0, 3):
            _reset_counts()
            got = raytrace(dev, o, d, tc, p, nb_bounces=bounces,
                           refract_ind=ior, use_kernels=True,
                           use_megakernel=False, use_fused=False)
            counts = _all_counts()
            with plain_trace_kernels():
                ref = raytrace(dev, o, d, tc, p, nb_bounces=bounces,
                               refract_ind=ior, use_kernels=True,
                               use_megakernel=False, use_fused=False)
            got, ref = got.cpu().numpy(), ref.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"{name} pass {p}: non-finite output")
            off, err = fused_match(ref, got)
            print(f"route parity {name} ior={ior} pass={p}: launches "
                  f"{counts}; off={off:.4f} (allowed {FUSED_FRAC}) "
                  f"max_abs_err={err:.3e}", flush=True)
            assert_fused_protocol(ref, got, f"route {name} pass {p}")
            want = "K6" if dev.mesh_prim_index else "K5"
            if counts[want] == 0:
                raise AssertionError(f"route {name}: {want} never launched")
            worst = max(worst, err)
        black = raytrace(dev, o, d, tc, 0, nb_bounces=0, refract_ind=ior,
                         use_kernels=True, use_megakernel=False,
                         use_fused=False)
        if not bool((black == 0).all()):
            raise AssertionError(f"{name}: nb_bounces=0 is not black")
    print("route parity nb_bounces=0: all black", flush=True)
    return worst


def _launches_per_pass(dev, r, kid):
    """The route's launches of kernel kid in one pass of Renderer r."""
    return r._ntiles * r.config.nb_bounces * _launches_per_bounce(dev, kid)


def _launches_per_bounce(dev, kid):
    """The route's launches of kernel kid in one bounce of one call: per
    trace (two on transparent scenes) one per mesh instance (K4a, K6) or
    large analytic group (K3a; K5 up to trace.SPARSE_GROUP_MAX padded
    prims, K3b past it)."""
    if kid in ("K4a", "K6"):
        units = len(dev.mesh_prim_index)
    else:
        sizes = [ptk._round_up(int(p.shape[0]), ptk.PRIM_CHUNK)
                 for p in dev.group_prim
                 if int(p.shape[0]) > trace_mod.SMALL_GROUP_MAX]
        units = sum(kid == "K3a" or (size <= trace_mod.SPARSE_GROUP_MAX)
                    == (kid == "K5") for size in sizes)
    traces = 2 if dev.has_transparent else 1
    return traces * units


def _pass_stats(kid, r, rec, out=None):
    """Kernel kid over one recorded pass: printed ms per launch and pass,
    by bounce, its work and bound; returns (ms per launch, ms per pass,
    bound ms per launch, bound ms per pass, bounded by). When `out` is a
    dict it gets the median SM clock while timed ("mhz"), the tests
    needed per launch ("tests", those of the bound) and each launch's ms
    ("launch_ms")."""
    clk = {}
    with clocks(f"{kid} timed alone", out=clk):
        ms, work, needed, late = _time_recorded(kid, rec)
    if out is not None:
        out.update(mhz=clk.get("mhz", float("nan")),
                   tests=float(needed[:, 0].astype(np.float64).mean()),
                   launch_ms=ms)
    paced = _time_recorded(kid, rec, reps=1, ahead=False, count=False)
    ops = sum(_needed_ops(kid, args, int(n[0]), int(n[1]), int(n[2]))
              for n, (_, args, _) in zip(needed, rec))
    nbytes = sum(_launch_bytes(kid, args) for _, args, _ in rec)
    bound_pass, bound_by = bound(nbytes, ops)
    per_tile = len(rec) // r._ntiles
    per_bounce = per_tile // r.config.nb_bounces
    by_bounce = ms.reshape(r._ntiles, r.config.nb_bounces,
                           per_bounce).sum(axis=(0, 2))
    print(f"{kid} alone: {ms.mean():.4f} ms per launch, {ms.sum():.4f} ms "
          f"per pass ({len(rec)} launches, median of 3, {late} timed "
          f"launches late; host-paced events, as before: "
          f"{paced[0].mean():.4f} ms per launch, {paced[3]} of {len(rec)} "
          f"late); work per pass: "
          f"{int(work[:, 0].sum())} tests done ({int(needed[:, 0].sum())} "
          f"needed), {int(work[:, 2].sum())} hits ({int(needed[:, 1].sum())}"
          f" needed), {int(work[:, 1].sum())} chunks or blocks visited"
          + (f", {int(work[:, 3].sum())} box tests ({int(needed[:, 2].sum())}"
             f" needed)" if work.shape[1] > 3 else "")
          + (f", {int(work[:, 4].sum())} supers entered"
             if work.shape[1] > 4 else "")
          + f"; bound {bound_pass:.4f} ms per pass ({bound_by}: {ops:.4g} "
          f"FP32 operations, {nbytes} bytes)", flush=True)
    print(f"{kid} by bounce (ms per pass): " + ", ".join(
        f"{b}: {t:.4f}" for b, t in enumerate(by_bounce)), flush=True)
    return (float(ms.mean()), float(ms.sum()), bound_pass / len(rec),
            bound_pass, bound_by)


def _k6_walks(args, lanes):
    """How many chunks each walking unit of one K6 launch (its recorded
    args) walks: a 128-ray tile under the prune over all its rays
    (mesh_fold_plain's walk, and a block of the one-thread-a-ray walk),
    and each of a tile's `lanes` blocks of 128 / lanes rays in this
    kernel, under the prune over its own rays.
    One replay of the tile walk on the card gives both: a chunk that the
    prune drops holds no hit closer than a ray's best, so at every chunk a
    block walks its rays hold the tile walk's best. Returns (walks per
    tile, walks per block), int64 tensors."""
    o, d, tri, order, tlo_sorted, bound = args[:6]
    nt, s = order.shape
    tile = spk.MESH_TILE
    shp = (nt, tile)
    oc = tuple(o[c].reshape(shp)[:, :, None] for c in range(3))
    dc = tuple(d[c].reshape(shp)[:, :, None] for c in range(3))
    bnd = bound.reshape(shp)
    a_best = torch.full(shp, float(ptk._FMAX), device=o.device)
    chunks = tri.reshape(9, -1, ptk.PRIM_CHUNK)
    on = torch.ones((nt, 1 + lanes), dtype=torch.bool, device=o.device)
    walks = torch.zeros((nt, 1 + lanes), dtype=torch.int64, device=o.device)
    for k in range(s):
        tlo = tlo_sorted[:, k:k + 1]
        cap = torch.minimum(a_best, bnd)
        caps = torch.cat([cap.amax(dim=1, keepdim=True),
                          cap.reshape(nt, lanes, -1).amax(dim=2)], dim=1)
        on &= (tlo < spk.INF) & (tlo < caps)
        walks += on
        t = torch.nonzero(on[:, 0]).squeeze(1)
        if t.numel() == 0:
            break
        bid = order[t, k].long()
        v = [chunks[r][bid][:, None, :] for r in range(9)]
        a = ptk.mt_chunk(tuple(x[t] for x in oc), tuple(x[t] for x in dc), v)
        a_best[t] = torch.minimum(a_best[t], a.amin(dim=2))
    return walks[:, 0], walks[:, 1:].reshape(-1)


def _k3b_walks(args, lanes):
    """How many chunks the warps of one K3b launch (its recorded args)
    enter: a warp of 32 rays gated as one (the one-thread-a-ray fold)
    folds every chunk whose box some ray of it enters within its best; in
    this kernel each ray walks the chunks whose box it enters within its
    best, and a warp of 32 / lanes rays folds one chunk a ray at each
    step, taking at least as many steps as its busiest ray. Replays the
    per-ray walk on the card in ascending chunk order: a chunk that a ray
    skips holds no hit closer than its best, so the best every gate reads
    is the brute fold's so far. Returns (chunks entered by each warp of 32
    rays gated as one, by each warp of this kernel, by each ray), int64
    tensors."""
    o, d, code, inv_r, trf_r, pid, cbb = args[:7]
    fn = SOA_FNS[code]
    m = o.shape[1]
    rd = safe_rcp(d)
    bd = torch.full((m,), float(ptk._FMAX), device=o.device)
    per_ray = torch.zeros((m,), dtype=torch.int64, device=o.device)
    old = torch.zeros((m // 32,), dtype=torch.int64, device=o.device)
    new = torch.zeros((m * lanes // 32,), dtype=torch.int64, device=o.device)
    for c in range(inv_r.shape[1] // ptk.PRIM_CHUNK):
        enter = ptk._slab_enters(o, rd, cbb[:, c], bd)
        old += enter.reshape(-1, 32).any(dim=1)
        new += enter.reshape(-1, 32 // lanes).any(dim=1)
        per_ray += enter
        rays = torch.nonzero(enter).squeeze(1)
        if rays.numel():
            cmin = ptk._group_chunk(fn, o[:, rays], d[:, rays], inv_r, trf_r,
                                    pid, c)[0]
            bd[rays] = torch.minimum(bd[rays], cmin)
    return old, new, per_ray


def _info_line(kid, info):
    """ptk.trace_kernel_info's numbers of kernel kid on one line."""
    return (f"{kid} compiled: {info['registers']} registers, "
            f"{info['local_bytes']} bytes of spills, {info['shared_bytes']} "
            f"bytes shared, {info['blocks_per_sm']} blocks of "
            f"{info['threads']} threads per SM, {info['lanes']} lanes a ray")


def _walk_line(walks):
    """'longest/p99/mean' of int64 walk lengths."""
    w = walks.double()
    return (f"{int(w.max())}/{float(torch.quantile(w, 0.99)):.0f}/"
            f"{float(w.mean()):.3f}")


def _k6_walk_stats(rec, ms, r):
    """Per launch of K6's recorded pass: its ms (kept ahead) beside the
    longest, 99th-percentile and mean walk of the 128-ray tiles and of
    this kernel's blocks (_k6_walks), one line per bounce; and their sums
    over the pass."""
    info = ptk.trace_kernel_info("K6")
    lanes = info["lanes"]
    print(_info_line("K6", info), flush=True)
    per_bounce = len(rec) // (r._ntiles * r.config.nb_bounces)
    lines = [[] for _ in range(r.config.nb_bounces)]
    tiles, blocks, longest = [], [], []
    for i, (_, args, _) in enumerate(rec):
        t, b = _k6_walks(args, lanes)
        tiles.append(t)
        blocks.append(b)
        longest.append((float(ms[i]), int(t.max()), int(b.max())))
        lines[(i // per_bounce) % r.config.nb_bounces].append(
            f"{ms[i]:.4f} {_walk_line(t)} {_walk_line(b)}")
    for bounce, line in enumerate(lines):
        print(f"K6 walks, bounce {bounce}, per launch (ms; chunks walked by "
              f"a tile, by a block of {spk.MESH_TILE // lanes} rays: "
              f"longest/p99/mean): " + ", ".join(line), flush=True)
    t, b = torch.cat(tiles), torch.cat(blocks)
    x = np.array(longest)
    print(f"K6 walks over the pass: tiles {_walk_line(t)} ({int(t.sum())} "
          f"chunks), blocks of {spk.MESH_TILE // lanes} rays {_walk_line(b)}"
          f" ({int(b.sum())} chunks); correlation over launches of ms with "
          f"the longest tile walk {np.corrcoef(x[:, 0], x[:, 1])[0, 1]:.3f}, "
          f"with the longest block walk "
          f"{np.corrcoef(x[:, 0], x[:, 2])[0, 1]:.3f}", flush=True)


def _k3b_walk_stats(rec, ms, launches):
    """K3b's walks (_k3b_walks) on the recorded launches `launches` (index
    into rec, with its bounce): per launch its ms (kept ahead), the
    longest, 99th-percentile and mean chunks entered by a warp of 32 rays
    gated as one, by a warp of this kernel and by a ray."""
    info = ptk.trace_kernel_info("K3b", int(rec[0][1][2]))
    lanes = info["lanes"]
    print(_info_line("K3b", info), flush=True)
    for i, bounce in launches:
        old, new, per_ray = _k3b_walks(rec[i][1], lanes)
        print(f"K3b walks, launch {i} (bounce {bounce}, {ms[i]:.4f} ms): "
              f"chunks entered, longest/p99/mean: by a warp of 32 rays "
              f"gated as one {_walk_line(old)}, by a warp of this kernel "
              f"({32 // lanes} rays of {lanes} lanes) "
              f"{_walk_line(new)}, by a ray {_walk_line(per_ray)} "
              f"({int(per_ray.sum())} in all)", flush=True)


def _tile_call(r, t, pass_index):
    """Renderer r's integrator on its ray tile t for one pass, as
    Renderer._passes calls it (nothing is accumulated)."""
    cfg = r.config
    return r._integrator(r.scene, r._origin, r._dirs[t], r._tc[t],
                         pass_index, nb_bounces=cfg.nb_bounces,
                         refract_ind=cfg.refract_ind, date=cfg.date,
                         detach_sampling=cfg.detach_sampling, **r.route)


def _tile_idle(r, kid):
    """Wall time of one tile's integrator call (host clock, synchronized),
    the device's busy time in the same call under torch.profiler and kid's
    share of it, and the idle share. One tile, not a pass: the profiler's
    cost grows with the tens of thousands of small kernels a pass
    launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _tile_call(r, 0, r.nb_passes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, mine = _device_seconds(lambda: _tile_call(r, 0, r.nb_passes),
                                 TRACE_KERNELS[kid][2], cpu=False)
    idle = f"{1.0 - busy / wall:.4f}" if busy > 0 else "not measured"
    print(f"one tile call of {r._tile} rays: {wall * 1e3:.4f} ms wall, "
          f"device busy {busy * 1e3:.4f} ms ({kid} {mine * 1e3:.4f} ms); "
          f"device idle share {idle}", flush=True)
    return wall, busy


def phase_trace_path(device, name, light, ior, kid, w, h, bounces, window,
                     tile_rays=1 << 17):
    """A full-size path of the pallas-trace route through compile_scene
    and Renderer.advance with RenderConfig(use_megakernel=False): kernel
    kid's launch count over one window, the image, rays/s, the device's
    busy time and idle share, kid's time per launch and pass with its
    work and bound, and full-size launches against the plain version."""
    dev = compile_scene(scenes.build(name, light), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       refract_ind=ior, light_intensity=light,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_megakernel=False, device=device)
    r = Renderer(dev, cfg)
    _tile_call(r, 0, 0)                     # warm-up: one tile
    rec = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_launches(kid, rec):         # keeps references only
        r.advance(window)                   # synchronizes before returning
    window_s = time.perf_counter() - t0
    counts = _all_counts()
    per_pass = _launches_per_pass(dev, r, kid)
    if counts[kid] != window * per_pass or sum(counts.values()) != counts[kid]:
        raise AssertionError(f"{name}: launches {counts} in the window, want "
                             f"{kid} {window} x {per_pass} and nothing else")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError(f"{name} image is not finite and >= 0")
    rays_per_s = w * h * window * bounces / window_s
    wall_pass = window_s / window
    print(f"trace path: {name} {w}x{h} {bounces} bounces, {r._ntiles} tiles "
          f"of {r._tile} rays, {window}-pass window {window_s:.4f} s "
          f"({wall_pass * 1e3:.3f} ms wall per pass), launches {counts} "
          f"({per_pass} {kid} per pass), image mean {img.mean():.5f}, "
          f"{rays_per_s:.6g} rays/s", flush=True)
    tile_wall, tile_busy = _tile_idle(r, kid)

    rec = rec[:per_pass]                    # the window's first pass
    extra = {}
    ms_launch, ms_pass, bound_launch, bound_pass, bound_by = _pass_stats(
        kid, r, rec, out=extra)
    if kid == "K6":
        _k6_walk_stats(rec, extra["launch_ms"], r)
    plain_ms, kern_ms, err = _plain_vs_kernel(kid, rec)
    return dict(launches=counts[kid], rays_per_s=rays_per_s,
                window_s=window_s, wall_pass_ms=wall_pass * 1e3,
                tile_wall_ms=tile_wall * 1e3, tile_busy_ms=tile_busy * 1e3,
                ms=ms_launch, ms_pass=ms_pass, plain_ms=plain_ms,
                bound_ms=bound_launch, bound_pass=bound_pass,
                bound_by=bound_by, max_abs_err=err, rec=rec)


def phase_trace_brute(device, name, light, ior, kid, bounces, w=800, h=600,
                      tile_rays=1 << 17):
    """One pass of the route with cull_chunks=False at w x h: the brute
    kernel kid's launch count, its image against the culled route's under
    the fused protocol, its time and bound over that pass, and full-size
    launches against the plain version."""
    dev = compile_scene(scenes.build(name, light), device=device)
    imgs = {}
    rec = []
    for cull in (None, False):
        cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                           refract_ind=ior, light_intensity=light,
                           tile_rays=tile_rays, use_megakernel=False,
                           cull_chunks=cull, device=device)
        r = Renderer(dev, cfg)
        _reset_counts()
        with record_launches(kid, rec):
            imgs[cull] = r.run(1)
        counts = _all_counts()
    per_pass = _launches_per_pass(dev, r, kid)
    if counts[kid] != per_pass or sum(counts.values()) != counts[kid] \
            or len(rec) != per_pass:
        raise AssertionError(f"{name} brute: launches {counts}, want {kid} "
                             f"{per_pass} and nothing else")
    off, err = fused_match(imgs[None], imgs[False])
    print(f"brute route {name} {w}x{h} {bounces} bounces: launches {counts}; "
          f"image vs the culled route off={off:.4f} (allowed {FUSED_FRAC}) "
          f"max_abs_err={err:.3e}", flush=True)
    assert_fused_protocol(imgs[None], imgs[False], f"{name} brute vs culled")
    extra = {}
    ms_launch, ms_pass, bound_launch, bound_pass, bound_by = _pass_stats(
        kid, r, rec, out=extra)
    _brute_stats(kid, dev, ms_launch, bound_launch, extra)
    plain_ms, kern_ms, err = _plain_vs_kernel(kid, rec)
    return dict(launches=counts[kid], ms=ms_launch, ms_pass=ms_pass,
                plain_ms=plain_ms, bound_ms=bound_launch,
                bound_pass=bound_pass, bound_by=bound_by, max_abs_err=err,
                rec=rec)


def _brute_stats(kid, dev, ms, bound_ms, extra):
    """Print what bounds brute kernel kid on its window: the FMA-free
    ceiling (twice the bound: the build rounds every multiply and add on
    its own, so each FP32 operation of the bound, an FMA counted as two,
    is one instruction), tests per launch, lane-cycles per test at the SM
    clock read while it was timed (SMs x 128 FP32 lanes), and the
    compiled kernel's registers, spills and resident blocks per SM
    (ptk.trace_kernel_info; K3a for each of the scene's large groups'
    shape codes)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tests = extra["tests"]
    cycles = ms * 1e-3 * extra["mhz"] * 1e6 * sms * 128 / tests
    codes = ([None] if kid == "K4a" else sorted(
        {int(c) for c, p in zip(dev.group_codes, dev.group_prim)
         if int(p.shape[0]) > trace_mod.SMALL_GROUP_MAX}))
    infos = "; ".join(
        (f"shape {c}: " if c is not None else "")
        + "{registers} registers, {local_bytes} bytes of spills, "
        "{shared_bytes} bytes shared, {blocks_per_sm} blocks of {threads} "
        "threads per SM".format(
            **ptk.trace_kernel_info(kid, c or 1)) for c in codes)
    print(f"{kid} brute: {ms:.4f} ms per launch against a bound of "
          f"{bound_ms:.4f} ms and an FMA-free ceiling of {2 * bound_ms:.4f} "
          f"ms; {tests:.6g} tests per launch, {cycles:.1f} lane-cycles per "
          f"test at {extra['mhz']:.0f} MHz ({sms} SMs); {infos}", flush=True)


def _k3b_scan_ms(launch, reps=10):
    """K3b's chunk-box scan alone: the recorded launch's rays moved 1000
    units above the scene's top and sent straight up, so that no ray
    enters a chunk box and each only tests the group's boxes; ms per
    launch (CUDA events over reps launches). It bounds what reading the
    boxes otherwise (shared memory) could save."""
    real, args, kw = launch
    o, d, cbb = args[0], args[1], args[6]
    top = float(cbb[5].max()) + 1000.0
    o_up = torch.stack([o[0], o[1], torch.full_like(o[2], top)])
    d_up = torch.zeros_like(d)
    d_up[2] = 1.0
    up = (o_up, d_up) + tuple(args[2:])
    work = torch.zeros(N_WORK["K3b"], dtype=torch.int64, device=o.device)
    out = real(*up, **kw, work=work)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        real(*up, **kw)
    e1.record()
    torch.cuda.synchronize()
    if int(work[1]) or bool((out[1] >= 0).any()):
        raise AssertionError("K3b scan: rays above the scene entered a chunk")
    ms = e0.elapsed_time(e1) / reps
    print(f"K3b chunk-box scan alone ({o.shape[1]} rays entering none of "
          f"{cbb.shape[1]} boxes): {ms:.4f} ms per launch", flush=True)
    return ms


def phase_large_scene(device, n_prims=200_000, w=800, h=600, bounces=3,
                      window=1, tile_rays=1 << 17, n_plain=2):
    """scenes.scene_stress(n_prims) (the procedural field that
    benchmarks/stress_curve.py sweeps) through compile_scene and
    Renderer.advance with RenderConfig(use_megakernel=False): its sphere
    group, past trace.SPARSE_GROUP_MAX padded prims, takes K3b, its cube
    group K5. The host time of the scene build and the compile; the launch
    counts over one window (opaque: per tile one trace per bounce, each
    one K3b and one K5 launch); the image; rays/s; one tile call's wall
    time, device busy time and idle share; K3b's time per launch, per pass
    and by bounce with its work and bound; n_plain recorded full-size K3b
    launches (a primary and a later bounce) against the plain version and
    against K3a; and K3b's chunk-box scan alone (_k3b_scan_ms)."""
    t0 = time.perf_counter()
    prims = scenes.scene_stress(n_prims=n_prims)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = compile_scene(prims, device=device)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    groups = {int(c): int(p.shape[0])
              for c, p in zip(dev.group_codes, dev.group_prim)}
    print(f"large scene: scene_stress(n_prims={n_prims}) built in "
          f"{build_s:.3f} s, compile_scene {compile_s:.3f} s (host clock); "
          f"padded groups by shape code {groups}", flush=True)
    if dev.has_transparent or dev.mesh_prim_index:
        raise AssertionError("scene_stress should be opaque and analytic")
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_megakernel=False, device=device)
    r = Renderer(dev, cfg)
    _tile_call(r, 0, 0)                     # warm-up: one tile
    rec = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_launches("K3b", rec):       # keeps references only
        r.advance(window)                   # synchronizes before returning
    window_s = time.perf_counter() - t0
    counts = _all_counts()
    want = {k: window * _launches_per_pass(dev, r, k) for k in ("K3b", "K5")}
    if any(counts[k] != n or n != window * r._ntiles * bounces
           for k, n in want.items()) or sum(counts.values()) != sum(
               want.values()) or len(rec) != want["K3b"]:
        raise AssertionError(f"large scene: launches {counts} in the window, "
                             f"want {want} ({r._ntiles} tiles x {bounces} "
                             f"traces per pass) and nothing else")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("large-scene image is not finite and >= 0")
    rays_per_s = w * h * window * bounces / window_s
    print(f"large scene path: {w}x{h} {bounces} bounces, {r._ntiles} tiles "
          f"of {r._tile} rays, {window}-pass window {window_s:.4f} s, "
          f"launches {counts}, image mean {img.mean():.5f}, "
          f"{rays_per_s:.6g} rays/s", flush=True)
    tile_wall, tile_busy = _tile_idle(r, "K3b")
    extra = {}
    ms_launch, ms_pass, bound_launch, bound_pass, bound_by = _pass_stats(
        "K3b", r, rec[:r._ntiles * bounces], out=extra)  # the first pass
    # tile 0's launches, one per bounce
    _k3b_walk_stats(rec, extra["launch_ms"],
                    [(b, b) for b in range(bounces)])
    # tile 0's primaries and tile 1's first bounce
    sub = [rec[0], rec[bounces + 1]][:n_plain]
    plain_ms, _, err = _plain_vs_kernel("K3b", rec, sub=sub)
    for real, args, kw in sub:
        _check_trace("K3b vs K3a full-size launch", ptk.group_best_rows(
            *args[:6]), real(*args, **kw))
    scan_ms = _k3b_scan_ms(rec[0])
    return dict(launches=counts["K3b"], k5_launches=counts["K5"],
                rays_per_s=rays_per_s, window_s=window_s,
                build_s=build_s, compile_s=compile_s,
                tile_wall_ms=tile_wall * 1e3, tile_busy_ms=tile_busy * 1e3,
                ms=ms_launch, ms_pass=ms_pass, plain_ms=plain_ms,
                bound_ms=bound_launch, bound_pass=bound_pass,
                bound_by=bound_by, max_abs_err=err, scan_ms=scan_ms, rec=rec)


@contextlib.contextmanager
def fma_trace_kernels():
    """Within the block, the trace kernels' wrappers launch a build of
    csrc/trace_kernels.cu with contracted multiply-adds: the flags of
    kernels.py without the -fmad=false of kernels.EXTRA_FLAGS."""
    flags = kernels.EXTRA_FLAGS
    lib = kernels._loaded.pop("trace_kernels")
    kernels.EXTRA_FLAGS = {}
    try:
        kernels.trace_kernels_lib()         # builds and loads that build
        yield
    finally:
        kernels.EXTRA_FLAGS = flags
        kernels._loaded["trace_kernels"] = lib


def phase_fma(trace, n=8):
    """Each trace kernel built with FMA contraction against the default
    build without it, in this call, on the recorded full-size launches of
    phases 7 (K4b), 9, 10 and 11 (K3b): the mean ms per launch of each
    build over the pass
    (CUDA events, _time_recorded), and how far the FMA build's distances
    move from the default build's, which equal the plain versions', on n
    of the launches."""
    for kid in ("K3a", "K3b", "K4a", "K4b", "K5", "K6"):
        rec = trace[kid]["rec"]
        sub = rec[::max(1, len(rec) // n)]
        ms_ref = _time_recorded(kid, rec)[0].mean()
        ref = [real(*args, **kw)[:2] for real, args, kw in sub]
        with fma_trace_kernels():
            ms_fma = _time_recorded(kid, rec)[0].mean()
            got = [real(*args, **kw)[:2] for real, args, kw in sub]

        def rows(outs, i):
            return torch.cat([o[i] for o in outs]).cpu().numpy()

        frac, bad, rel, err = trace_match(rows(ref, 0), rows(ref, 1),
                                          rows(got, 0), rows(got, 1))
        print(f"{kid} built with FMA contraction vs without: {ms_fma:.4f} "
              f"vs {ms_ref:.4f} ms per launch over the pass ({len(rec)} "
              f"launches); on {len(sub)} launches rows equal {frac:.5f}, "
              f"differing rows without equal distance {bad}, max rel err "
              f"{rel:.2e}, max abs err {err:.3e}", flush=True)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def print_registers(log, kernel):
    """Each compiled variant of `kernel` in an nvcc -Xptxas -v report:
    its registers and spill bytes, one line each."""
    entry, spill = None, (0, 0)
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry, spill = m.group(1), (0, 0)
            continue
        m = _SPILL.search(line)
        if m and entry:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m and entry and kernel in entry:
            print(f"{kernel} {entry}: {m.group(1)} registers, spill stores "
                  f"{spill[0]} bytes, loads {spill[1]} bytes", flush=True)
            entry = None


_SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_CLASSES = (("FP32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                           "FCHK")),
                 ("MUFU", ("MUFU",)), ("shared loads", ("LDS",)),
                 ("branch-class", ("BRA", "BSSY", "BSYNC", "CALL", "RET",
                                   "VOTE", "WARPSYNC")))


def _fold_loop(ins):
    """ins [(address, opcode, operands)] of one function: its fold loop,
    one test a trip: of the backward branches whose body holds a VOTE.ANY
    (the gate on a test's rest) and a MUFU (a test's reciprocal or square
    root), the one with the fewest votes, then the shortest; split at the
    vote into the instructions every test runs and the gated rest, each
    counted by class. None where there is no such loop."""
    loops = []
    for i, (_, op, rest) in enumerate(ins):
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not (op.startswith("BRA") and m):
            continue
        lo = next((k for k, (a, _, _) in enumerate(ins)
                   if a == int(m.group(1), 16)), None)
        if lo is None or lo >= i:
            continue
        votes = sum(o.startswith("VOTE.ANY") for _, o, _ in ins[lo:i])
        if votes and any(o.startswith("MUFU") for _, o, _ in ins[lo:i]):
            loops.append((votes, i - lo, lo, i))
    if not loops:
        return None
    _, _, lo, hi = min(loops)
    body = [op for _, op, _ in ins[lo:hi + 1]]
    vote = next(k for k, op in enumerate(body) if op.startswith("VOTE"))
    parts = {}
    for part, ops in (("every test", body[:vote + 2]),
                      ("gated", body[vote + 2:])):
        parts[part] = {"all": len(ops), **{
            cls: sum(op.split(".")[0] in names for op in ops)
            for cls, names in _SASS_CLASSES}}
    return parts


def print_fold_sass():
    """The fold loops of K3a (group_kernel) and K3b (group_culled_kernel,
    and group_tile_kernel for cones and quads), by shape code, of K5's tile
    walk (an_tile_walk), of K4a (tri_kernel), K4b (tri_culled_kernel, by
    lanes a ray) and K6 (mesh_walk) in the SASS of the loaded trace
    kernels (_sass_functions), one line each."""
    funcs = _sass_functions(kernels.library_path("trace_kernels"),
                            r"(group_kernel|group_culled_kernel|"
                            r"group_tile_kernel|tri_kernel|tri_culled_kernel|"
                            r"an_tile_walk|mesh_walk)")
    if funcs is None:
        print("cuobjdump not found: SASS not read", flush=True)
        return
    short = {}
    for name, body in funcs.items():
        m = re.search(r"(group_kernel|group_culled_kernel|group_tile_kernel|"
                      r"tri_kernel|tri_culled_kernel|an_tile_walk|mesh_walk)"
                      r"(?:ILi(\d+))?", name)
        short[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = body
    for name, body in sorted(short.items()):
        parts = _fold_loop(body)
        print(f"SASS fold loop of {name}: " + ("; ".join(
            f"{part} " + ", ".join(f"{k} {v}" for k, v in c.items())
            for part, c in parts.items()) if parts else "not found"),
              flush=True)


_SASS_K1_CLASSES = _SASS_CLASSES + (("device loads", ("LDG", "LD")),
                                     ("constant loads", ("LDC", "ULDC")))


def _sass_functions(lib, pattern):
    """{function name: [(address, opcode, operands)]} of the functions of
    a loaded library's SASS whose name matches `pattern` (cuobjdump beside
    nvcc); None where the toolkit lacks cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, ins = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ins = funcs.setdefault(name, []) if re.search(pattern, name) \
                else None
            continue
        m = _SASS_OP.search(line)
        if ins is not None and m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def _by_class(ops):
    return {"all": len(ops), **{cls: sum(op.split(".")[0] in names
                                         for op in ops)
                                for cls, names in _SASS_K1_CLASSES}}


def print_k1_sass():
    """K1's SASS by instruction class, per compiled variant: the whole
    kernel, its innermost loops that hold a MUFU (the fold over a group's
    prims: a test's reciprocal or square root) and the rest (the bounce
    step, the RNG, the loop control), one line each."""
    funcs = _sass_functions(kernels.library_path("megakernel"),
                            r"mega_kernel")
    if funcs is None:
        print("cuobjdump not found: K1's SASS not read", flush=True)
        return
    for name, ins in sorted(funcs.items()):
        addr = {a: k for k, (a, _, _) in enumerate(ins)}
        loops = []
        for i, (_, op, rest) in enumerate(ins):
            m = re.search(r"0x([0-9a-f]+)", rest)
            lo = addr.get(int(m.group(1), 16)) if m else None
            if op.startswith("BRA") and lo is not None and lo < i and any(
                    o.startswith("MUFU") for _, o, _ in ins[lo:i]):
                loops.append((lo, i))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in loops)]
        in_loop = set(k for lo, hi in inner for k in range(lo, hi + 1))
        print(f"SASS of {name}: kernel {_by_class([o for _, o, _ in ins])}; "
              f"outside its {len(inner)} innermost MUFU loops "
              f"{_by_class([o for k, (_, o, _) in enumerate(ins) if k not in in_loop])}",
              flush=True)
        for lo, hi in inner:
            print(f"  loop at {ins[lo][0]:#x}: "
                  f"{_by_class([o for _, o, _ in ins[lo:hi + 1]])}",
                  flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the dense route and the carousel's other integrators
# ---------------------------------------------------------------------------

def phase_dense_route(device, w=800, h=600, bounces=3, window=4,
                      tile_rays=1 << 17):
    """box_diffuse at w x h through the dense route (RenderConfig(
    use_kernels=False), torch ops only) and Renderer.advance: no kernel
    launched over the window, rays/s, the device's busy time per pass and
    idle share (torch.profiler over one pass), the image; then one
    full-size pass against the megakernel route's (K1) under the
    megakernel protocol."""
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       tile_rays=tile_rays, passes_per_call=window,
                       use_kernels=False, device=device)
    r = Renderer(dev, cfg)
    r.advance(1)                            # warm-up pass
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(1 + window)                   # synchronizes before returning
    window_s = time.perf_counter() - t0
    counts = _all_counts()
    if any(counts.values()):
        raise AssertionError(f"the dense route launched kernels: {counts}")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("dense route image is not finite and >= 0")
    rays_per_s = w * h * window * bounces / window_s
    wall_pass = window_s / window
    busy, _ = _device_seconds(lambda: r.advance(r.nb_passes + 1), "",
                              cpu=False)
    idle = f"{1.0 - busy / wall_pass:.4f}" if busy > 0 else "not measured"
    print(f"dense route: box_diffuse {w}x{h} {bounces} bounces, "
          f"{r._ntiles} tiles of {r._tile} rays, {window}-pass window "
          f"{window_s:.4f} s ({wall_pass * 1e3:.3f} ms wall per pass), no "
          f"kernel launched, image mean {img.mean():.5f}, {rays_per_s:.6g} "
          f"rays/s; device busy {busy * 1e3:.4f} ms per pass, idle share "
          f"{idle}", flush=True)

    one = dataclasses.replace(cfg, passes_per_call=1)
    dense = Renderer(dev, one).run(1)
    mega = Renderer(dev, dataclasses.replace(one, use_kernels=True)).run(1)
    frac, dmean, err = megakernel_match(mega, dense)
    print(f"dense route pass 0 vs the megakernel route (K1): close="
          f"{frac:.4f} mean_diff={dmean:.2e} max_abs_err={err:.3e}",
          flush=True)
    assert_megakernel_protocol(mega, dense, "dense route vs K1, 1 pass")
    return dict(rays_per_s=rays_per_s, window_s=window_s,
                wall_pass_ms=wall_pass * 1e3, busy_ms=busy * 1e3, idle=idle)


# montecarlo_aos with use_kernels=True at 800x600, tile_rays 1<<17 (4
# tiles): (kernel, scene, light, IOR, bounces, its launches per pass:
# tiles x bounces x 2 traces x groups of 128 prims or more, or instances)
AOS_CASES = (("K3a", "colonnes", 0.4, 1.0, 6, 96),
             ("K4a", "mesh_demo", 1.2, 1.3, 8, 192))


def _aos_units(dev, kid):
    """The scene's groups of at least PRIM_CHUNK padded prims (K3a) or
    mesh instances (K4a): the units ops/trace.trace sends to the kernel."""
    if kid == "K4a":
        return len(dev.mesh_prim_index)
    return sum(int(p.shape[0]) >= ptk.PRIM_CHUNK for p in dev.group_prim)


def _every_launch_vs_plain(kid, rec):
    """Every recorded launch of kid against its plain version, bit for
    bit (_check_exact, quietly): (rows differing in all, rays in all,
    max abs error, the plain version's and the kernel's mean ms per
    launch, CUDA events)."""
    differ = rays = 0
    err = 0.0
    plain_ms, kern_ms = [], []
    for real, args, kw in rec:
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        got = real(*args, **kw)
        e[1].record()
        e[2].record()
        ref = _plain_of(kid, args)
        e[3].record()
        torch.cuda.synchronize()
        kern_ms.append(e[0].elapsed_time(e[1]))
        plain_ms.append(e[2].elapsed_time(e[3]))
        differ += int((ref[1] != got[1]).sum())
        rays += int(ref[1].numel())
        err = max(err, _check_exact(f"{kid} montecarlo_aos launch vs plain",
                                    ref, got, every=kid == "K3a",
                                    verbose=False))
    return (differ, rays, err, float(np.mean(plain_ms)),
            float(np.mean(kern_ms)))


def phase_aos(device, kid, name, light, ior, bounces, want, w=800, h=600,
              tile_rays=1 << 17):
    """One pass of montecarlo_aos with use_kernels=True through
    compile_scene and Renderer.advance: kid's launch count (want, and
    nothing else launched), the image against the same integrator with
    kernels off under the megakernel protocol, kid's time per launch (the
    card kept ahead) with its work and bound over the pass, and every
    launch of the pass against the plain version bit for bit."""
    dev = compile_scene(scenes.build(name, light), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       refract_ind=ior, light_intensity=light,
                       tile_rays=tile_rays, passes_per_call=1,
                       integrator="montecarlo_aos", use_kernels=True,
                       device=device)
    r = Renderer(dev, cfg)
    rec = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_launches(kid, rec):         # keeps references only
        r.advance(1)                        # synchronizes before returning
    pass_s = time.perf_counter() - t0
    counts = _all_counts()
    per_pass = r._ntiles * bounces * 2 * _aos_units(dev, kid)
    if per_pass != want or counts[kid] != want or len(rec) != want \
            or sum(counts.values()) != counts[kid]:
        raise AssertionError(f"montecarlo_aos {name}: launches {counts}, "
                             f"want {kid} {want} ({per_pass} from the "
                             f"scene) and nothing else")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError(f"montecarlo_aos {name} image is not finite "
                             f"and >= 0")
    rays_per_s = w * h * bounces / pass_s
    _reset_counts()
    t0 = time.perf_counter()
    dense = Renderer(dev, dataclasses.replace(cfg, use_kernels=False)).run(1)
    dense_s = time.perf_counter() - t0
    if any(_all_counts().values()):
        raise AssertionError(f"montecarlo_aos {name} with kernels off "
                             f"launched {_all_counts()}")
    frac, dmean, img_err = megakernel_match(dense, img)
    print(f"montecarlo_aos {name} {w}x{h} {bounces} bounces, IOR {ior}: "
          f"{kid} launches {counts[kid]} in the pass ({r._ntiles} tiles x "
          f"{bounces} bounces x 2 traces x {_aos_units(dev, kid)}), nothing "
          f"else; pass {pass_s:.4f} s, {rays_per_s:.6g} rays/s (kernels off:"
          f" {dense_s:.4f} s); image vs kernels off close={frac:.4f} "
          f"mean_diff={dmean:.2e} max_abs_err={img_err:.3e}", flush=True)
    assert_megakernel_protocol(dense, img, f"montecarlo_aos {name} kernels "
                               f"on vs off")
    ms_launch, ms_pass, bound_launch, bound_pass, bound_by = _pass_stats(
        kid, r, rec)
    differ, rays, err, plain_ms, kern_ms = _every_launch_vs_plain(kid, rec)
    print(f"montecarlo_aos {name}: all {len(rec)} {kid} launches vs plain: "
          f"{differ} of {rays} rows differ, max abs err {err:.3e}; plain "
          f"{plain_ms:.3f} ms per launch, {kid} {kern_ms:.4f} ms on the same "
          f"launches (host-paced)", flush=True)
    return dict(launches=counts[kid], rays_per_s=rays_per_s, pass_s=pass_s,
                dense_s=dense_s, size=f"{w}x{h}x{bounces}", ms=ms_launch, ms_pass=ms_pass,
                plain_ms=plain_ms, bound_ms=bound_launch,
                bound_pass=bound_pass, bound_by=bound_by, max_abs_err=err,
                differ=differ)


def phase_stubs(device, w=800, h=600, tile_rays=1 << 17):
    """montecarlo_mat and montecarlo_mat_tr on box_diffuse at w x h, one
    pass each through Renderer.advance: no kernel launched (their trace is
    the dense fold), the output finite and non-negative."""
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    for name in ("montecarlo_mat", "montecarlo_mat_tr"):
        r = Renderer(dev, RenderConfig(width=w, height=h, integrator=name,
                                       tile_rays=tile_rays,
                                       passes_per_call=1, device=device))
        _reset_counts()
        t0 = time.perf_counter()
        img = r.run(1)
        dt = time.perf_counter() - t0
        if any(_all_counts().values()):
            raise AssertionError(f"{name} launched {_all_counts()}")
        if img.shape != (h, w, 3) or not np.isfinite(img).all() \
                or (img < 0).any() or img.max() <= 0:
            raise AssertionError(f"{name} image is not finite, >= 0 and "
                                 f"lit")
        print(f"{name} box_diffuse {w}x{h}: one pass {dt:.4f} s, no kernel "
              f"launched, image finite, mean {img.mean():.5f}", flush=True)


# pixel_grads on the fast route at full size, one window each: (kernel,
# scene, light, width, height, bounces, passes). All rays go in one call,
# so each bounce launches the kernel once per large group or instance and
# trace; the backward pass launches nothing (the trace is detached)
GRAD_CASES = (("K5", "colonnes", 0.4, 800, 600, 6, 2),
              ("K6", "mesh_demo", 1.2, 800, 600, 8, 1))


def _check_leaves(g, what):
    """Every leaf finite, and the albedo's gradient nonzero on some row;
    returns the largest magnitude of each leaf."""
    for name, t in zip(g._fields, g):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{what}: the {name} gradient is not finite")
    rows = int((g.color != 0).any(dim=1).sum())
    if rows == 0:
        raise AssertionError(f"{what}: the gradient is zero on every row")
    return rows, {name: float(t.abs().max()) for name, t in zip(g._fields, g)}


def _launch_stats(kid, rec):
    """Kernel kid over recorded launches: median ms per launch (the card
    kept ahead), the bound per launch from the work their inputs need,
    and 4 of them against the plain version."""
    ms, _, needed, _ = _time_recorded(kid, rec)
    ops = sum(_needed_ops(kid, args, int(n[0]), int(n[1]), int(n[2]))
              for n, (_, args, _) in zip(needed, rec))
    nbytes = sum(_launch_bytes(kid, args) for _, args, _ in rec)
    bound_all, bound_by = bound(nbytes, ops)
    plain_ms, _, err = _plain_vs_kernel(kid, rec, n=4)
    return dict(ms=float(ms.mean()), bound_ms=bound_all / len(rec),
                bound_by=bound_by, plain_ms=plain_ms, max_abs_err=err)


def phase_grad_window(device, kid, name, light, w, h, bounces, passes):
    """pixel_grads on the fast route (the scene on the card, use_kernels
    auto) at w x h through render/diff.py: kid's launches over the
    window, nothing else launched; the wall time of the forward and of
    the backward pass; the peak device memory; every leaf finite and the
    albedo's gradient nonzero on some row. Then the same forward under
    torch.no_grad with its launches recorded: kid's time per launch, its
    bound and its plain version on them."""
    dev = compile_scene(scenes.build(name, light), device=device)
    o, d, tc = _rays(device, w, h)
    p = diff.params_of(dev)
    marks = {}
    real_grad = diff._grad

    def timed_grad(out, leaves):       # the backward pass, timed alone
        torch.cuda.synchronize()
        marks["forward"] = time.perf_counter()
        g = real_grad(out, leaves)
        torch.cuda.synchronize()
        marks["backward"] = time.perf_counter()
        return g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    diff._grad = timed_grad
    _reset_counts()
    try:
        t0 = time.perf_counter()
        g = diff.pixel_grads(dev, p, o, d, tc, n_passes=passes,
                             nb_bounces=bounces)
    finally:
        diff._grad = real_grad
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = marks["forward"] - t0, marks["backward"] - marks["forward"]
    want = passes * bounces * _launches_per_bounce(dev, kid)
    if counts[kid] != want or sum(counts.values()) != counts[kid]:
        raise AssertionError(f"{name} gradients: launches {counts}, want "
                             f"{kid} {want} and nothing else")
    rows, mags = _check_leaves(g, f"{name} gradients")
    print(f"gradients: pixel_grads {name} {w}x{h} {bounces} bounces "
          f"{passes} passes on the fast route: launches {counts}; forward "
          f"{fwd:.4f} s, backward {bwd:.4f} s wall; peak device memory "
          f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB before); every "
          f"leaf finite, the albedo's gradient nonzero on {rows} of "
          f"{dev.nb_prims} rows; largest " + ", ".join(
              f"{k} {v:.4g}" for k, v in mags.items()), flush=True)
    rec = []
    with torch.no_grad(), record_launches(kid, rec):
        diff.render_mean(dev, p, o, d, tc, passes, bounces,
                         use_kernels=True)
    stats = _launch_stats(kid, rec)
    print(f"{kid} over the gradient window's {len(rec)} launches: "
          f"{stats['ms']:.4f} ms per launch (bound {stats['bound_ms']:.5f} "
          f"ms, {stats['bound_by']}); plain {stats['plain_ms']:.3f} ms",
          flush=True)
    return dict(stats, launches=counts[kid], forward_s=fwd, backward_s=bwd,
                peak_gib=peak / 2**30, size=f"{w}x{h}x{bounces}",
                passes=passes, name=name)


# the fast route against the dense route at a small size: (kernel, scene,
# light, width, height, bounces, passes, leaves compared). colonnes holds
# no emissive prim (it is lit by the sky), so its light_scale gradient is
# exactly 0 on both routes and is not compared there; mesh_demo has an
# emissive quad, so its light_scale is, and its instances take K6. Every
# compared leaf must have a nonzero gradient on the dense route
GRAD_ROUTE_CASES = (
    ("K5", "colonnes", 0.4, 96, 72, 4, 2, ("color", "mat")),
    ("K6", "mesh_demo", 1.2, 64, 48, 4, 1, ("color", "mat", "light_scale")))


def phase_grad_routes(device, kid, name, light, w, h, bounces, passes,
                      leaves):
    """The fast route's gradients (kid) against the dense route's (torch
    ops only, no kernel) on scene `name` at w x h: each of `leaves` within
    1e-3 x its largest magnitude on the dense route, which must not be
    0."""
    dev = compile_scene(scenes.build(name, light), device=device)
    o, d, tc = _rays(device, w, h)
    p = diff.params_of(dev)
    grads, counts = {}, {}
    for kernels_on in (True, False):
        _reset_counts()
        grads[kernels_on] = diff.pixel_grads(
            dev, p, o, d, tc, n_passes=passes, nb_bounces=bounces,
            use_kernels=kernels_on)
        counts[kernels_on] = _all_counts()
    want = passes * bounces * _launches_per_bounce(dev, kid)
    if counts[True][kid] != want or any(counts[False].values()):
        raise AssertionError(f"fast vs dense {name}: launches {counts}, "
                             f"want {kid} {want} on the fast route, none "
                             f"on the dense")
    _check_leaves(grads[False], f"{name} dense gradients")
    worst = {}
    for leaf in leaves:
        fast, dense = getattr(grads[True], leaf), getattr(grads[False], leaf)
        scale = float(dense.abs().max())
        worst[leaf] = (float((fast - dense).abs().max()), scale)
        if scale == 0.0:
            raise AssertionError(f"fast vs dense {name} {leaf}: the dense "
                                 f"gradient is 0, nothing is compared")
        if worst[leaf][0] > 1e-3 * scale:
            raise AssertionError(f"fast vs dense {name} {leaf}: "
                                 f"{worst[leaf][0]} past 1e-3 x {scale}")
    print(f"gradients fast ({kid}, {counts[True][kid]} launches) vs dense "
          f"on {name} {w}x{h}x{bounces}, {passes} passes: largest "
          f"difference " + ", ".join(f"{k} {v[0]:.3e} (of {v[1]:.4g})"
                                     for k, v in worst.items()), flush=True)
    return worst


def phase_grad_fd(device, w=160, h=120, bounces=6, passes=2, eps=1e-2):
    """One central finite difference of the albedo channel with the
    largest gradient on colonnes (the fast route both ways), held as
    tests/test_grad.py:39-50 holds it: rtol 0.05."""
    dev = compile_scene(scenes.build("colonnes", 0.4), device=device)
    o, d, tc = _rays(device, w, h)
    p = diff.params_of(dev)
    g = diff.pixel_grads(dev, p, o, d, tc, n_passes=passes,
                         nb_bounces=bounces)
    prim = int(g.color[:, 0].abs().argmax())
    analytic = float(g.color[prim, 0])

    def lum(e):
        color = p.color.clone()
        color[prim, 0] += e
        with torch.no_grad():
            return float(diff.render_mean(
                dev, p._replace(color=color), o, d, tc, passes, bounces,
                use_kernels=True).mean())

    fd = (lum(eps) - lum(-eps)) / (2 * eps)
    print(f"gradients: colonnes {w}x{h}x{bounces}, prim {prim} red albedo: "
          f"analytic {analytic:.6g}, central difference {fd:.6g} (eps "
          f"{eps})", flush=True)
    if not np.isfinite(analytic) or analytic == 0.0 \
            or abs(analytic - fd) > 0.05 * max(abs(fd), 1e-4):
        raise AssertionError(f"analytic {analytic} vs fd {fd}")
    return analytic, fd


def phase_grad_fit(device, w=160, h=120, bounces=6, passes=2, steps=20,
                   n_prims=3):
    """inverse_render_fit on colonnes at w x h on the fast route: the
    albedo of the n_prims prims with the largest albedo gradient, started
    from (0.1, 0.6, 0.2); the loss must fall. ms per step, K5's launches
    per step."""
    dev = compile_scene(scenes.build("colonnes", 0.4), device=device)
    o, d, tc = _rays(device, w, h)
    p = diff.params_of(dev)
    g = diff.pixel_grads(dev, p, o, d, tc, n_passes=passes,
                         nb_bounces=bounces)
    prims = [int(i) for i in g.color[:, :3].abs().sum(dim=1).argsort(
        descending=True)[:n_prims]]
    with torch.no_grad():
        target = diff.render_mean(dev, p, o, d, tc, passes, bounces,
                                  use_kernels=True)
    color = p.color.clone()
    color[prims, :3] = torch.tensor([0.1, 0.6, 0.2], device=device)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, losses = diff.inverse_render_fit(
        dev, target, o, d, tc, prim_ids=prims, steps=steps, lr=5e-2,
        n_passes=passes, nb_bounces=bounces,
        seed_params=p._replace(color=color))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = _all_counts()
    want = steps * passes * bounces * _launches_per_bounce(dev, "K5")
    if counts["K5"] != want or sum(counts.values()) != want:
        raise AssertionError(f"fit: launches {counts}, want K5 {want}")
    err0 = float((color[prims, :3] - p.color[prims, :3]).abs().max())
    err1 = float((fit.color[prims, :3] - p.color[prims, :3]).abs().max())
    print(f"inverse_render_fit colonnes {w}x{h}x{bounces}, {passes} passes, "
          f"prims {prims}: loss {losses[0]:.6g} -> {losses[-1]:.6g} over "
          f"{steps} steps; albedo error {err0:.4f} -> {err1:.4f}; "
          f"{step_ms:.3f} ms per step, {counts['K5'] // steps} K5 launches "
          f"per step", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the fit's loss did not fall: {losses}")
    return dict(step_ms=step_ms, k5_per_step=counts["K5"] // steps,
                loss0=losses[0], loss1=losses[-1])


def run_diff(name_power):
    """Phase 14 (gradients, render/diff.py): the full-size windows' results
    by kernel."""
    res = {}
    for kid, name, light, w, h, bounces, passes in GRAD_CASES:
        r = phase_grad_window("cuda", kid, name, light, w, h, bounces, passes)
        print(f"[{name_power}] pixel_grads {name} {w}x{h}x{bounces}, {passes}"
              f" passes: forward {r['forward_s']:.4f} s, backward "
              f"{r['backward_s']:.4f} s, peak {r['peak_gib']:.3f} GiB; "
              f"{kid} {r['launches']} launches, {r['ms']:.4f} ms per launch "
              f"(bound {r['bound_ms']:.5f} ms, plain {r['plain_ms']:.3f} ms)",
              flush=True)
        res[kid] = r
    for case in GRAD_ROUTE_CASES:
        phase_grad_routes("cuda", *case)
    phase_grad_fd("cuda")
    fit = phase_grad_fit("cuda")
    print(f"[{name_power}] inverse_render_fit colonnes 160x120x6: "
          f"{fit['step_ms']:.3f} ms per step, {fit['k5_per_step']} K5 "
          f"launches per step", flush=True)
    return res


def _grad_line(kid, res):
    line = _trace_line(kid, res)
    line["name"] += (f", pixel_grads {res['name']} {res['size']} "
                     f"({res['passes']} passes)")
    return line


def _cli(argv):
    """cli.main(argv) with its standard output captured: (exit code, the
    lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def phase_cli(device, tmp, w=800, h=600, spp=64, mesh_spp=8):
    """The command line on the card (phase 15): `render` of box_diffuse at
    w x h, spp passes, 3 bounces launches K1 only, and its PNG equals the
    tonemapped, flipped resolve of a Renderer with the same config;
    `bench` on box_diffuse (K1, spp passes) and mesh_demo (K2, mesh_spp
    passes of 8 bounces), its JSON line; `python -m
    montecarlo_pathtracing_tpu_torch scenes` in a subprocess; `sampling`
    for each sampler (no kernel). On the CPU (a rehearsal) every
    subcommand gets --cpu and the renders --pallas: the kernels' route,
    with their plain versions."""
    cpu = [] if device == "cuda" else ["--cpu"]
    size = ["--width", str(w), "--height", str(h)]
    path = os.path.join(tmp, "render.png")
    _reset_counts()
    t0 = time.perf_counter()
    rc, out = _cli(["render", "--scene", "box_diffuse", *size, "--spp",
                    str(spp), "--bounces", "3", "--out", path]
                   + cpu + ["--pallas"] * bool(cpu))
    wall = time.perf_counter() - t0
    counts = _all_counts()
    cfg = RenderConfig(width=w, height=h, nb_bounces=3,
                       light_intensity=1.2, device=device)
    r = Renderer(compile_scene(scenes.build("box_diffuse", 1.2),
                               device=device), cfg)
    if rc != 0 or out != [path] or counts["K1"] != spp * r._ntiles \
            or sum(counts.values()) != counts["K1"]:
        raise AssertionError(f"CLI render: exit {rc}, printed {out}, "
                             f"launches {counts}")
    want = tonemap(r.run(spp))[::-1] / np.float32(255.0)
    got = read_png(path)
    differ = int((got != want).sum())
    print(f"CLI render box_diffuse {w}x{h}, {spp} spp, 3 bounces: {wall:.3f} s "
          f"wall (scene compile and PNG included), launches {counts}; its "
          f"PNG against the Renderer's resolve: {differ} of {want.size} "
          f"channels differ", flush=True)
    if differ:
        raise AssertionError("the CLI's PNG is not the Renderer's image")
    benches = {}
    for name, kid, extra in (
            ("box_diffuse", "K1", ["--spp", str(spp), "--bounces", "3"]),
            ("mesh_demo", "K2", ["--spp", str(mesh_spp), "--bounces", "8"])):
        _reset_counts()
        rc, out = _cli(["bench", "--scene", name, *size, *extra]
                       + cpu + ["--pallas"] * bool(cpu))
        counts = _all_counts()
        line = json.loads(out[-1])
        if rc != 0 or counts[kid] == 0 or sum(counts.values()) != \
                counts[kid] or set(line) != {
                    "metric", "value", "unit", "vs_baseline",
                    "baseline_rays_per_s", "baseline_source"}:
            raise AssertionError(f"CLI bench {name}: exit {rc}, printed "
                                 f"{out}, launches {counts}")
        print(f"CLI bench {name} {w}x{h} {' '.join(extra)}: launches "
              f"{counts}; {out[-1]}", flush=True)
        benches[name] = dict(line, launches=counts[kid])
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m",
                           "montecarlo_pathtracing_tpu_torch", "scenes"],
                          cwd=root, capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0 or proc.stdout.split() != list(scenes.SCENES):
        raise AssertionError(f"python -m ... scenes: {proc.returncode} "
                             f"{proc.stdout!r} {proc.stderr[-2000:]}")
    print(f"python -m montecarlo_pathtracing_tpu_torch scenes: exit 0, "
          f"{len(scenes.SCENES)} scenes", flush=True)
    for sampler in ("hsphere", "hsphere_wrong", "hsphere_wrong2"):
        spath = os.path.join(tmp, f"{sampler}.png")
        _reset_counts()
        rc, out = _cli(["sampling", "--sampler", sampler, "--out", spath]
                       + cpu)
        img = read_png(spath)
        lit = int((img.sum(-1) > 0).sum())
        if rc != 0 or out != [spath] or img.shape != (512, 512, 3) \
                or lit < 200 or any(_all_counts().values()):
            raise AssertionError(f"CLI sampling {sampler}: exit {rc}, "
                                 f"{lit} pixels lit")
        print(f"CLI sampling {sampler}: {lit} pixels lit", flush=True)
    return dict(render_s=wall, render_k1=spp * r._ntiles, benches=benches)


def phase_debug_views(device, tmp, w=800, h=600, level=4):
    """The debug views on the card (phase 15): render_debug_png of each
    channel on mesh_demo at w x h (the dense first-hit trace: no kernel),
    its PNG read back; colonnes' BVH built with use_native=True (g++,
    into the build directory) bit-equal to the numpy builder and to the
    one scene_bvh caches, and bvh_level_image of its level `level`."""
    dev = compile_scene(scenes.build("mesh_demo"), device=device)
    proj, view = default_rt_camera(w, h)
    for channel in ("albedo", "normal", "depth", "prim_id"):
        path = os.path.join(tmp, f"{channel}.png")
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = debug_views.render_debug_png(dev, proj, view, w, h, path,
                                           channel=channel)
        dt = time.perf_counter() - t0
        if img.shape != (h, w, 3) or not np.isfinite(img).all() \
                or img.max() <= 0 or any(_all_counts().values()):
            raise AssertionError(f"debug view {channel}: not a finite, lit "
                                 f"image, or a kernel launched")
        if not (read_png(path) == tonemap(img.astype(np.float32))[::-1]
                / np.float32(255.0)).all():
            raise AssertionError(f"debug view {channel}: PNG differs")
        print(f"render_debug_png mesh_demo {w}x{h} {channel}: {dt:.4f} s "
              f"wall, no kernel launched, mean {img.mean():.5f}", flush=True)
    col = compile_scene(scenes.build("colonnes"), device=device)
    mn = col.prim_bb_min.cpu().numpy()
    mx = col.prim_bb_max.cpu().numpy()
    centers = ((mn + mx) / 2.0).astype(np.float32)
    t0 = time.perf_counter()
    native = bvh_builder.build_bvh(centers, mn, mx, use_native=True)
    dt = time.perf_counter() - t0
    plain = bvh_builder.build_bvh(centers, mn, mx, use_native=False)
    cached = debug_views.scene_bvh(col)
    for a, b, c in zip(native[:3], plain[:3], cached[:3]):
        if not (np.array_equal(a, b) and np.array_equal(a, c)):
            raise AssertionError("the native BVH differs from numpy's")
    bvh_builder.check_invariants(native, col.nb_prims)
    img = debug_views.bvh_level_image(col, *default_rt_camera(w, h), w, h,
                                      level, path=os.path.join(tmp, "bvh.png"))
    # the wires' colour (debug_views.bvh_level_image) over the dimmed depth
    wires = int((img == np.float32([1.0, 0.9, 0.1])).all(-1).sum())
    print(f"native BVH of colonnes ({col.nb_prims} prims, depth "
          f"{native.depth}) in {dt:.4f} s (its g++ build included where "
          f"new), bit-equal to numpy's and scene_bvh's; bvh_level_image "
          f"level {level} at {w}x{h}: {wires} wire pixels", flush=True)
    if wires < 100:
        raise AssertionError("bvh_level_image drew no wires")


def run_tools(name_power):
    """Phase 15 (the CLI and the tools)."""
    with tempfile.TemporaryDirectory() as tmp:
        res = phase_cli("cuda", tmp)
        phase_debug_views("cuda", tmp)
    print(f"[{name_power}] CLI render box_diffuse 800x600x3, 64 spp: "
          f"{res['render_s']:.3f} s wall, {res['render_k1']} K1 launches; "
          + "; ".join(f"bench {k}: {v['value']} rays/s, {v['launches']} "
                      f"launches" for k, v in res["benches"].items()),
          flush=True)
    return res


def run_dense(name_power):
    """Phase 13: (the AoS cells' results by kernel)."""
    res = phase_dense_route("cuda")
    print(f"[{name_power}] dense route box_diffuse end to end "
          f"{res['rays_per_s']:.6g} rays/s (800x600 x 4 passes x 3 bounces "
          f"/ {res['window_s']:.4f} s); device busy {res['busy_ms']:.4f} ms "
          f"of {res['wall_pass_ms']:.3f} ms wall per pass, idle share "
          f"{res['idle']}", flush=True)
    aos = {}
    for kid, name, light, ior, bounces, want in AOS_CASES:
        resa = phase_aos("cuda", kid, name, light, ior, bounces, want)
        print(f"[{name_power}] montecarlo_aos {name} 800x600x{bounces}: "
              f"{resa['rays_per_s']:.6g} rays/s (1 pass); {kid} "
              f"{resa['ms']:.4f} ms/launch, {resa['ms_pass']:.4f} ms/pass "
              f"over {resa['launches']} launches (bound "
              f"{resa['bound_ms']:.5f} ms/launch, {resa['bound_by']}); plain "
              f"{resa['plain_ms']:.3f} ms/launch; {resa['differ']} rows "
              f"differ", flush=True)
        aos[kid] = dict(resa, name=name)
    phase_stubs("cuda")
    return aos


# --------------------------------------------------------------------------
# phase 16: multi-device rendering (parallel/sharding.py, launcher.py)
# --------------------------------------------------------------------------

def _two_shards(device):
    """An explicit 2-shard mesh on the one card (cuda:0 twice; the CPU when
    rehearsing): the shards run one after another on its current stream."""
    d = "cuda:0" if device == "cuda" else "cpu"
    return make_mesh(devices=[d, d])


def phase_sharded_main(device, w=800, h=600, bounces=3, passes=4,
                       tile_rays=1 << 17):
    """(a) make_sharded_pass over 2 shards on one card renders box_diffuse
    w x h x bounces, `passes` passes, through K1 (2 launches a pass), its
    image bit-equal to the unsharded Renderer's; K1 on a shard against
    its plain version, timed, with its bound. (b) make_sample_sharded_pass
    on the same mesh: passes 0 and 1 summed, against their sequential sum
    within 1e-6."""
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       tile_rays=tile_rays, passes_per_call=passes,
                       device=device)
    r = Renderer(dev, cfg)
    r.advance(passes)                       # warm-up (K1 loaded)
    r.reset()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(passes)
    un_s = time.perf_counter() - t0
    un_k1 = _all_counts()["K1"]
    want = r.image()

    o, d, tc = _rays(device, w, h)
    mesh = _two_shards(device)
    sd, st, _ = shard_rays(mesh, d, tc)
    fn = make_sharded_pass(mesh, nb_bounces=bounces, route=r.route)
    fn(dev, [torch.zeros_like(x) for x in sd], sd, st, o, 0, 1.0)  # warm-up
    acc = [torch.zeros_like(x) for x in sd]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(passes):
        fn(dev, acc, sd, st, o, k, cfg.refract_ind)
    torch.cuda.synchronize()
    sh_s = time.perf_counter() - t0
    counts = _all_counts()
    if counts["K1"] != passes * len(mesh) or sum(counts.values()) != \
            counts["K1"]:
        raise AssertionError(f"sharded window launches {counts}, want "
                             f"{passes} x {len(mesh)} K1")
    got = (torch.cat(acc).cpu().numpy()[: w * h] / passes).reshape(h, w, 3)
    differ = int((got != want).any(-1).sum())
    rays = w * h * passes * bounces
    print(f"(a) sharded pass box_diffuse {w}x{h}x{bounces}, {passes} passes, "
          f"2 shards of {sd[0].shape[0]} rays on {mesh[0]}: "
          f"{counts['K1']} K1 launches, {sh_s:.4f} s wall, "
          f"{rays / sh_s:.6g} rays/s; the unsharded Renderer ({r._ntiles} "
          f"tiles of {r._tile} rays, {un_k1} K1 launches) {un_s:.4f} s, "
          f"{rays / un_s:.6g} rays/s; {differ} of {w * h} pixels differ",
          flush=True)
    if differ:
        raise AssertionError("the sharded accumulator is not the unsharded "
                             "Renderer's")

    # K1 on one shard: against its plain version, its time, its bound; and
    # on all rays in one launch
    shard = _k1_shard_line(dev, o, sd, st, bounces, mesh)
    full = mk.mega_inputs(dev, o, d, tc, cfg.refract_ind)
    full_ms, _ = _k1_pass_ms([full], bounces)
    print(f"K1 on all {full.n} rays in one launch: {full_ms:.5f} ms",
          flush=True)

    # (b) sample-axis DP: shard k renders pass k of every pixel
    sfn = make_sample_sharded_pass(mesh, nb_bounces=bounces, route=r.route)
    _reset_counts()
    rgb = sfn(dev, d, tc, o, 0, cfg.refract_ind).cpu().numpy()
    s_k1 = _all_counts()["K1"]
    seq = sum(raytrace(dev, o, d, tc, k, nb_bounces=bounces,
                       refract_ind=cfg.refract_ind, **r.route).cpu().numpy()
              for k in range(len(mesh)))
    s_err = float(np.abs(rgb - seq).max())
    print(f"(b) sample-sharded pass, passes 0-1 on 2 shards: {s_k1} K1 "
          f"launches, max abs difference from the sequential sum "
          f"{s_err:.3e}", flush=True)
    if s_k1 != len(mesh):
        raise AssertionError(f"sample-sharded pass launched K1 {s_k1} times")
    np.testing.assert_allclose(rgb, seq, rtol=1e-6, atol=1e-6)
    return dict(shard, rays_per_s=rays / sh_s, window_s=sh_s,
                un_rays_per_s=rays / un_s, un_window_s=un_s,
                launches=counts["K1"], full_ms=full_ms)


def phase_sharded_fused(device, w=800, h=600, bounces=8):
    """(c) make_sharded_pass over 2 shards on one card renders mesh_demo
    w x h x bounces, one pass, through K2 (a launch a bounce and shard),
    against one unsharded call on all rays under the fused protocol (K2's
    schedules depend on the batch); K2 on a shard against its plain
    version, timed, with its bound."""
    dev = compile_scene(scenes.build("mesh_demo"), device=device)
    o, d, tc = _rays(device, w, h)
    route = dict(use_kernels=True, use_megakernel=None, use_fused=None,
                 cull_chunks=None)
    raytrace(dev, o, d[:4096], tc[:4096], 0, nb_bounces=bounces,
             refract_ind=1.0, **route)      # warm-up (K2 loaded)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = raytrace(dev, o, d, tc, 0, nb_bounces=bounces, refract_ind=1.0,
                    **route)
    torch.cuda.synchronize()
    un_s = time.perf_counter() - t0
    un_k2 = _all_counts()["K2"]

    mesh = _two_shards(device)
    sd, st, _ = shard_rays(mesh, d, tc)
    fn = make_sharded_pass(mesh, nb_bounces=bounces, route=route)
    acc = [torch.zeros_like(x) for x in sd]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(dev, acc, sd, st, o, 0, 1.0)
    torch.cuda.synchronize()
    sh_s = time.perf_counter() - t0
    counts = _all_counts()
    if counts["K2"] != len(mesh) * bounces or sum(counts.values()) != \
            counts["K2"]:
        raise AssertionError(f"sharded mesh_demo launches {counts}, want "
                             f"{len(mesh)} x {bounces} K2")
    got = torch.cat(acc)[: w * h]
    share, err = fused_match(want.cpu(), got.cpu())
    rays = w * h * bounces
    print(f"(c) sharded pass mesh_demo {w}x{h}x{bounces}, 1 pass, 2 shards "
          f"of {sd[0].shape[0]} rays: {counts['K2']} K2 launches, "
          f"{sh_s:.4f} s wall, {rays / sh_s:.6g} rays/s; unsharded (one call"
          f" on all rays, {un_k2} K2 launches) {un_s:.4f} s, "
          f"{rays / un_s:.6g} rays/s; {int(round(share * w * h))} of {w * h}"
          f" pixels more than {FUSED_TOL} off (share {share:.5f}), max abs "
          f"difference {err:.3e}", flush=True)
    assert_fused_protocol(want.cpu(), got.cpu(), "sharded mesh_demo")

    # K2 on one shard: its recorded launches timed; the plain version
    # through the same route on the shard, timed and its needed work
    # counted
    shard = _k2_shard(dev, o, sd, st, bounces, mesh)
    return dict(shard, rays_per_s=rays / sh_s, window_s=sh_s,
                un_rays_per_s=rays / un_s, un_window_s=un_s,
                launches=counts["K2"])


def phase_renderer_mesh(device, w=800, h=600, bounces=3, passes=4):
    """(d) Renderer(shard_devices=every card) against the unsharded one,
    bit for bit, where the host has 2 cards or more; a mesh of more cards
    than the host has raises, naming its count."""
    n = torch.cuda.device_count() if device == "cuda" else 0
    ask = max(2, n + 1)
    try:
        make_mesh(ask, "cuda")
    except RuntimeError as e:
        if f"this host has {n}" not in str(e):
            raise
        print(f"(d) make_mesh({ask}, 'cuda') raised: {e}", flush=True)
    else:
        raise AssertionError(f"make_mesh({ask}, 'cuda') did not raise")
    if n < 2:
        print(f"(d) Renderer(shard_devices={max(2, n)}) not run: this host "
              f"has {n} card{'s' * (n != 1)}", flush=True)
        return
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    imgs = []
    for shards in (0, n):
        r = Renderer(dev, RenderConfig(width=w, height=h, nb_bounces=bounces,
                                       tile_rays=1 << 17, shard_devices=shards,
                                       device=device))
        imgs.append(r.run(passes))
    differ = int((imgs[0] != imgs[1]).any(-1).sum())
    print(f"(d) Renderer(shard_devices={n}) box_diffuse {w}x{h}x{bounces}, "
          f"{passes} passes: {differ} pixels differ from the unsharded",
          flush=True)
    if differ:
        raise AssertionError("the sharded Renderer's image differs")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_ranks(cmds, cpu, timeout=300):
    """Start one process per command at once and wait for all: ([(exit
    code, output)], wall s, the host clock at the start)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    t_start = time.time()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results, time.perf_counter() - t0, t_start


def phase_two_process(device, tmp, w=800, h=600, bounces=3, spp=64,
                      every=16):
    """(e) `python -m montecarlo_pathtracing_tpu_torch render
    --distributed` in 2 processes (gloo; both on the one card) renders
    box_diffuse w x h x bounces at spp passes, a checkpoint every `every`:
    the sum of the two processes' checkpointed accumulators against a
    single-process Renderer within rtol 1e-5, atol 1e-6, the PNG that
    process 0 wrote equal to that sum's; then testing/launcher_worker.py
    in 2 processes, both crashing after `every` local passes, and a
    relaunch that resumes from their checkpoints to the same image bit for
    bit. Every process has a time limit."""
    cpu = device != "cuda"
    size = ["--width", str(w), "--height", str(h)]
    ck, png = os.path.join(tmp, "cli.npz"), os.path.join(tmp, "cli.png")
    port = _free_port()
    results, cli_s, _ = _launch_ranks([
        [sys.executable, "-m", "montecarlo_pathtracing_tpu_torch", "render",
         "--distributed", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(k), "--scene",
         "box_diffuse", *size, "--spp", str(spp), "--bounces", str(bounces),
         "--checkpoint-every", str(every), "--checkpoint", ck, "--out", png]
        + ["--cpu", "--pallas"] * cpu for k in (0, 1)], cpu)
    if [rc for rc, _ in results] != [0, 0] or png not in results[0][1]:
        raise AssertionError("2-process CLI render failed:\n" + "\n".join(
            out[-3000:] for _, out in results))

    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       light_intensity=1.2, device=device)
    r = Renderer(compile_scene(scenes.build("box_diffuse", 1.2),
                               device=device), cfg)
    r.advance(cfg.passes_per_call)          # warm-up
    r.reset()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = r.run(spp)
    one_s = time.perf_counter() - t0
    one_k1 = _all_counts()["K1"]
    parts = []
    for k in (0, 1):
        with np.load(f"{ck[:-4]}.p{k}.npz") as z:
            parts.append((int(z["nb_passes"]), z["acc"]))
    if [p for p, _ in parts] != [spp // 2, spp]:
        raise AssertionError(f"checkpointed passes {[p for p, _ in parts]}")
    img = r.resolve(parts[0][1] + parts[1][1], passes=spp)
    differ = int((img != ref).sum())
    err = float(np.abs(img - ref).max())
    want_png = tonemap(img)[::-1] / np.float32(255.0)
    png_differ = int((read_png(png) != want_png).sum())
    rays = w * h * spp * bounces
    print(f"(e) 2-process CLI render box_diffuse {w}x{h}x{bounces}, {spp} "
          f"spp: {cli_s:.3f} s wall for both processes (start, card, "
          f"rendezvous and PNG included), {rays / cli_s:.6g} rays/s; one "
          f"process in this one {one_s:.4f} s ({one_k1} K1 launches: "
          f"{spp} passes x {r._ntiles} tiles), {rays / one_s:.6g} rays/s; "
          f"{differ} of {img.size} channels differ from it, max abs "
          f"{err:.3e}; the PNG of process 0: {png_differ} channels differ "
          f"from the checkpoints' sum", flush=True)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    if png_differ:
        raise AssertionError("process 0's PNG is not the gathered image")

    wck, out = os.path.join(tmp, "w.npz"), os.path.join(tmp, "w.npy")

    def worker(crash):
        port = _free_port()
        return _launch_ranks([
            [sys.executable, "-m",
             "montecarlo_pathtracing_tpu_torch.testing.launcher_worker",
             "--process-id", str(k), "--num-processes", "2", "--port",
             str(port), "--spp", str(spp), "--checkpoint-every", str(every),
             "--checkpoint", wck, "--out", out, "--scene", "box_diffuse",
             *size, "--bounces", str(bounces), "--tile-rays",
             str(cfg.tile_rays), "--passes-per-call",
             str(cfg.passes_per_call)]
            + ["--crash-at", str(every)] * crash + ["--cpu"] * cpu
            for k in (0, 1)], cpu)

    results, crash_s, _ = worker(True)
    if [rc for rc, _ in results] != [3, 3] or os.path.exists(out):
        raise AssertionError("the crashing workers did not both exit 3:\n"
                             + "\n".join(o[-3000:] for _, o in results))
    saved = []
    for k in (0, 1):
        with np.load(f"{wck[:-4]}.p{k}.npz") as z:
            saved.append(int(z["nb_passes"]))
    results, resume_s, t_start = worker(False)
    if [rc for rc, _ in results] != [0, 0]:
        raise AssertionError("the relaunched workers failed:\n" + "\n".join(
            o[-3000:] for _, o in results))
    resumed = np.load(out)
    r_differ = int((resumed != img).sum())
    times = [json.loads(o.strip().splitlines()[-1]) for _, o in results]
    start = [t["t_enter"] - t_start for t in times]
    join = [t["t_joined"] - t["t_enter"] for t in times]
    ready = [t["t_ready"] - t["t_joined"] for t in times]
    print(f"(e) crash after {every} local passes: both workers exit 3 in "
          f"{crash_s:.3f} s, checkpoints at passes {saved}; the relaunch "
          f"resumed and finished in {resume_s:.3f} s: {r_differ} channels "
          f"differ from the uninterrupted render. Per process of the "
          f"relaunch: interpreter and package import "
          f"{[f'{x:.3f}' for x in start]} s, "
          f"torch import, card and rendezvous {[f'{x:.3f}' for x in join]} "
          f"s, the scene on the card (CUDA context) "
          f"{[f'{x:.3f}' for x in ready]} s", flush=True)
    if saved != [every, spp // 2 + every] or r_differ:
        raise AssertionError("crash and resume did not reproduce the image")
    return dict(cli_s=cli_s, one_s=one_s, rays_per_s=rays / cli_s,
                one_rays_per_s=rays / one_s, resume_s=resume_s,
                crash_s=crash_s, start=start, join=join, ready=ready)


def run_multi(name_power):
    """Phase 16 (multi-device rendering): (the sharded K1 window's result,
    the sharded K2 pass's)."""
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) on the card: the dense, sample-sharded, "
          f"K1 and K2 routes sharded at 32x24, finite", flush=True)
    a = phase_sharded_main("cuda")
    c = phase_sharded_fused("cuda")
    phase_renderer_mesh("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        e = phase_two_process("cuda", tmp)
    print(f"[{name_power}] sharded box_diffuse 800x600x3 (2 shards, one "
          f"card): {a['rays_per_s']:.6g} rays/s against the unsharded "
          f"Renderer's {a['un_rays_per_s']:.6g}; {a['launches']} K1 "
          f"launches, K1 {a['ms']:.5f} ms a shard launch ({a['shard_rays']} "
          f"rays; {a['full_ms']:.5f} ms on all rays); sharded mesh_demo "
          f"800x600x8: {c['rays_per_s']:.6g} rays/s against "
          f"{c['un_rays_per_s']:.6g} unsharded, {c['launches']} K2 launches, "
          f"K2 {c['ms_launch']:.4f} ms a shard launch; 2-process CLI render "
          f"{e['rays_per_s']:.6g} rays/s against {e['one_rays_per_s']:.6g} "
          f"in one process; phase 16 {time.perf_counter() - t0:.1f} s",
          flush=True)
    return a, c


# ---------------------------------------------------------------------------
# phase 17: multi-card rendering (--only multicard)
# ---------------------------------------------------------------------------

# the wrappers of the kernels on the multi-card routes, which count their
# launches by card (`launches_on`), and the CUDA kernels' names in a profile
CARD_WRAPPERS = {"K1": mk.k1_launch, "K2": bk.k2_launch,
                 "K5": spk.group_best_rows_sparse,
                 "K6": spk.mesh_best_rows_sparse}
CARD_KERNELS = {"K1": "mega_kernel", "K2": "fused_kernel", "K5": "an_walk",
                "K6": "mesh_walk"}
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")


def _sync_cards(mesh):
    for dev in dict.fromkeys(mesh):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)


def _launches_on(kid, mesh, want=None):
    """Kernel kid's launches on each distinct device of `mesh` since the
    counts were reset; raises when a card launched it no time, or not
    `want` times for each of its shards."""
    on = CARD_WRAPPERS[kid].launches_on
    shards = {}
    for d in mesh:
        shards[str(d)] = shards.get(str(d), 0) + 1
    got = {d: on.get(d, 0) for d in shards}
    if any(n == 0 or (want is not None and n != want * shards[d])
           for d, n in got.items()):
        raise AssertionError(f"{kid} launches by card {got}, want "
                             f"{want or 'at least 1'} for each shard")
    return got


def sync_audit(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the host syncs it
    made, {"file:line": count}, at the Python line that made each."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchronizing CUDA operation" in str(w.message):
            where = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[where] = sites.get(where, 0) + 1
    return sites


# the routes of the host-sync audit: (label, scene, light, IOR, width,
# height, bounces, route keywords)
AUDIT_ROUTES = (
    ("K1 box_diffuse", "box_diffuse", 1.2, 1.0, 800, 600, 3,
     dict(use_kernels=True, use_megakernel=True)),
    ("K1 culled colonnes", "colonnes", 1.2, 1.0, 1920, 1080, 3,
     dict(use_kernels=True, use_megakernel=True)),
    ("K2 mesh_demo", "mesh_demo", 1.2, 1.0, 800, 600, 8,
     dict(use_kernels=True, use_megakernel=False, use_fused=True)),
    ("pallas-trace K5 colonnes", "colonnes", 0.4, 1.0, 200, 150, 6,
     dict(use_kernels=True, use_megakernel=False, use_fused=False)),
    ("pallas-trace K6 mesh_demo", "mesh_demo", 1.2, 1.3, 200, 150, 8,
     dict(use_kernels=True, use_megakernel=False, use_fused=False)),
)


def audit_routes(device, mesh):
    """One make_sharded_pass over `mesh` on each route of AUDIT_ROUTES
    (after a warm-up pass) under sync_audit: {label: {"file:line":
    count}}. It uses only what the port has had since its multi-device
    slice, so that it also counts an older checkout's syncs when that
    checkout's package comes first on the path."""
    out = {}
    for label, name, light, ior, w, h, bounces, route in AUDIT_ROUTES:
        dev = compile_scene(scenes.build(name, light), device=device)
        o, d, tc = _rays(device, w, h)
        sd, st, _ = shard_rays(mesh, d, tc)
        fn = make_sharded_pass(mesh, nb_bounces=bounces, route=route)
        acc = [torch.zeros_like(x) for x in sd]
        fn(dev, acc, sd, st, o, 0, ior)
        _sync_cards(mesh)
        out[label] = sync_audit(lambda: fn(dev, acc, sd, st, o, 1, ior))
        _sync_cards(mesh)
        print(f"sync audit, one sharded pass of {label} {w}x{h}x{bounces} "
              f"over {[str(m) for m in mesh]}: "
              f"{sum(out[label].values())} host syncs"
              + (f" at {out[label]}" if out[label] else ""), flush=True)
    return out


def _merged_ms(spans):
    """Total ms of the union of (start, end) intervals in µs."""
    total, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _together_ms(spans):
    """ms during which two or more cards are busy at once, from each
    card's (start, end) intervals in µs."""
    edges = []
    for card_spans in spans.values():
        merged = []
        for s, e in sorted(card_spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        edges += [(s, 1) for s, _ in merged] + [(e, -1) for _, e in merged]
    total, busy, last = 0.0, 0, None
    for t, step in sorted(edges):
        if busy >= 2:
            total += t - last
        busy += step
        last = t
    return total / 1e3


def card_profile(fn, mesh, kid, per_pass):
    """fn() (a window of passes over the cards of `mesh`, ending in a sync
    of every card) under torch.profiler with CUDA activity on every card:
    per card its busy ms (the union of its kernels' and copies'
    intervals on the profiler's common clock) and idle share of the
    window's host wall time, the ms during which two or more cards are
    busy at once, and whether the cards overlap: for each pass and each
    card k > 0, whether k's first launch of kernel kid in the pass starts
    before card k-1's last one of the pass ends (`per_pass` launches of
    kid a card and pass; where a pass queues its tiles on every card in
    turn, this holds whenever a card has more than one tile). Returns a
    dict; device time not seen by the profiler reads "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = [torch.device(d) for d in dict.fromkeys(mesh)]
    _sync_cards(cards)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync_cards(cards)
        wall = time.perf_counter() - t0
    spans, launches = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        spans.setdefault(e.device_index, []).append(span)
        if CARD_KERNELS[kid] in e.name:
            launches.setdefault(e.device_index, []).append(span)
    busy = {f"cuda:{i}": _merged_ms(s) for i, s in sorted(spans.items())}
    out = {"wall_ms": wall * 1e3, "busy_ms": busy,
           "idle": {c: 1.0 - ms / (wall * 1e3) for c, ms in busy.items()},
           "together_ms": _together_ms(spans)}
    idx = [c.index for c in cards if c.type == "cuda"]
    if len(idx) < 2 or any(i not in launches for i in idx):
        out["overlap"] = "not measured"
        return out
    passes = [sorted(launches[i]) for i in idx]
    n_pass = min(len(p) for p in passes) // per_pass
    pairs = overlapped = 0
    lead = []
    for p in range(n_pass):
        chunk = [x[p * per_pass:(p + 1) * per_pass] for x in passes]
        for k in range(1, len(chunk)):
            pairs += 1
            overlapped += chunk[k][0][0] < chunk[k - 1][-1][1]
        # how far the last card's first launch starts after the first
        # card's first launch, µs
        lead.append(chunk[-1][0][0] - chunk[0][0][0])
    out["overlap"] = f"{overlapped} of {pairs}"
    out["last_card_start_us"] = float(np.median(lead)) if lead else None
    return out


def _profile_line(what, prof):
    busy = ", ".join(f"{c} {ms:.4f} ms (idle {prof['idle'][c]:.4f})"
                     for c, ms in prof["busy_ms"].items())
    print(f"{what} under torch.profiler: {prof['wall_ms']:.4f} ms wall; "
          f"device busy by card: {busy or 'not measured'}"
          + (f", two or more cards at once {prof['together_ms']:.4f} ms"
             if busy else "") + "; card k's first "
          f"launch of a pass before card k-1's last one ended: "
          f"{prof['overlap']}" + (
              f"; the last card starts {prof['last_card_start_us']:.1f} us "
              f"after the first (median over passes)"
              if prof.get("last_card_start_us") is not None else ""),
          flush=True)


def _peak_memory(mesh):
    """Peak bytes allocated on each card since the last reset."""
    return {str(d): torch.cuda.max_memory_allocated(d)
            for d in dict.fromkeys(mesh) if torch.device(d).type == "cuda"}


def _reset_peaks(mesh):
    for d in dict.fromkeys(mesh):
        if torch.device(d).type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def _timed_window(run, mesh):
    """Host seconds of run(), every card of `mesh` idle before and synced
    after."""
    _sync_cards(mesh)
    t0 = time.perf_counter()
    run()
    _sync_cards(mesh)
    return time.perf_counter() - t0


def _scaling(rays, secs):
    """{cards: (rays/s, efficiency against one card)} from {cards: s}."""
    one = rays / secs[1]
    return {n: (rays / s, rays / s / (n * one)) for n, s in secs.items()}


def _scaling_line(what, scale):
    print(f"{what}: " + "; ".join(
        f"{n} card{'s' * (n > 1)} {rps:.6g} rays/s (efficiency {eff:.4f})"
        for n, (rps, eff) in sorted(scale.items())), flush=True)


def _k1_shard_line(dev, o, sd, st, bounces, mesh):
    """K1 on the last card's shard: against its plain version, its time
    (the card kept ahead), the plain version's and its bound."""
    last = mesh[-1]
    with kernels.on_device(last):   # events, sleeps and syncs on it
        inp = mk.mega_inputs(to_device(dev, last), o.to(last), sd[-1], st[-1],
                             1.0)
        k1 = mk.k1_launch(inp, seed_y(0), bounces)
        plain = mk.mega_pass_reference(inp, seed_y(0), bounces)
        frac, dmean, err = megakernel_match(plain.cpu(), k1.cpu())
        assert_megakernel_protocol(plain.cpu(), k1.cpu(),
                                   f"K1 on the shard on {last}")
        ms, late = _k1_pass_ms([inp], bounces)
        plain_ms = _time_passes(
            lambda k: mk.mega_pass_reference(inp, seed_y(k), bounces), 1)
        need = mk.K1Need(inp)
        mk.mega_pass_reference(inp, seed_y(0), bounces, need=need)
        bound_ms, bound_by, ops, nbytes = _k1_bound([inp], [need])
    print(f"K1 on the shard of {inp.n} rays on {last}: {ms:.5f} ms a launch "
          f"(the card kept ahead, median of 3, {late} late); plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{ops:.4g} operations, {nbytes} bytes); against the plain version "
          f"close={frac:.4f} mean_diff={dmean:.2e} max_abs_err={err:.3e}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, shard_rays=inp.n,
                card=str(last))


def phase_mc_box(device, counts, w=800, h=600, bounces=3, passes=8,
                 tile_rays=1 << 17):
    """(a) K1 on box_diffuse w x h x bounces: Renderer(shard_devices=n) for
    n in `counts` against the unsharded Renderer over the same `passes`
    passes, bit for bit, with rays/s, the scaling efficiency, K1's
    launches by card, the cards' busy time, idle share and overlap under
    torch.profiler and their peak memory; make_sharded_pass over the most
    cards against one call on all rays, bit for bit; K1 on the last card's
    shard against its plain version with its time and bound."""
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    secs, imgs, by_card, total = {}, {}, {}, {}
    for n in [1] + counts:
        cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                           tile_rays=tile_rays, passes_per_call=passes,
                           shard_devices=n if n > 1 else 0, device=device)
        r = Renderer(dev, cfg)
        r.advance(passes)                   # warm-up: K1 loaded on each card
        r.reset()
        _reset_counts()
        _reset_peaks(r._mesh)
        secs[n] = _timed_window(lambda: r.advance(passes), r._mesh)
        imgs[n] = r.image()
        total[n] = mk.k1_launch.launches
        if n > 1:
            by_card[n] = _launches_on("K1", r._mesh,
                                      want=passes * r._ntiles)
        differ = int((imgs[n] != imgs[1]).any(-1).sum())
        print(f"(a) box_diffuse {w}x{h}x{bounces}, {passes} passes, "
              f"Renderer(shard_devices={n if n > 1 else 0}) on "
              f"{[str(d) for d in r._mesh]}: {secs[n]:.4f} s, "
              f"{mk.k1_launch.launches} K1 launches"
              + (f" by card {by_card[n]}" if n > 1 else "")
              + f"; peak memory by card {_peak_memory(r._mesh)} bytes; "
              f"{differ} of {w * h} pixels differ from one card", flush=True)
        if differ:
            raise AssertionError(f"Renderer(shard_devices={n}) differs")
    scale = _scaling(w * h * passes * bounces, secs)
    _scaling_line(f"(a) box_diffuse {w}x{h}x{bounces} in one process",
                  scale)
    prof = card_profile(lambda: r.advance(r.nb_passes + passes), r._mesh,
                        "K1", r._ntiles)
    _profile_line(f"(a) {passes} passes on {len(r._mesh)} cards", prof)

    # make_sharded_pass over the most cards against one call on all rays
    o, d, tc = _rays(device, w, h)
    mesh = r._mesh
    sd, st, _ = shard_rays(mesh, d, tc)
    fn = make_sharded_pass(mesh, nb_bounces=bounces, route=r.route)
    acc = [torch.zeros_like(x) for x in sd]
    _reset_counts()
    fn(dev, acc, sd, st, o, 0, 1.0)
    one_each = _launches_on("K1", mesh, want=1)
    got = torch.cat([a.cpu() for a in acc])[: w * h]
    want = raytrace(dev, o, d, tc, 0, nb_bounces=bounces, refract_ind=1.0,
                    **r.route).cpu()
    differ = int((got != want).any(-1).sum())
    print(f"(a) make_sharded_pass over {len(mesh)} cards, shards of "
          f"{sd[0].shape[0]} rays, K1 by card {one_each}: {differ} of "
          f"{w * h} pixels differ from one call on all rays", flush=True)
    if differ:
        raise AssertionError("the sharded pass differs from one call")
    shard = _k1_shard_line(dev, o, sd, st, bounces, mesh)
    return dict(shard, scale=scale, prof=prof, launches=total[max(counts)],
                by_card=by_card[max(counts)])


def _example(name):
    """The example script examples/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(argv, cpu, timeout=1200):
    """examples/config5_manyrays_torch.py with `argv` in a subprocess:
    its manyrays.json."""
    results, _, _ = _launch_ranks(
        [[sys.executable, os.path.join(EXAMPLES, "config5_manyrays_torch.py"),
          *argv]], cpu, timeout=timeout)
    rc, out = results[0]
    if rc != 0:
        raise AssertionError(f"config5_manyrays_torch.py {argv} exit {rc}:\n"
                             + out[-3000:])
    return json.loads(out.strip().splitlines()[-1])


def phase_mc_config5(device, counts, tmp, w=1920, h=1080, spp=1024,
                     window=64, bounces=3):
    """(b) BASELINE config 5 (colonnes, the example's pose, K1 culled and
    transparent): Renderer(shard_devices=n) over `window` passes, bit for
    bit against one card, with rays/s, launches by card and the cards' idle
    share and overlap; the example's render at spp passes in one process
    (a Renderer here) and with --processes n --straight (one card each)
    for n in `counts`: bit for bit the one process's render of the same
    blocks summed in process order, and against its sequential sum within
    the bound of float32 summation; with --processes n (stop at half, tear
    down, resume), bit for bit the straight run's, every process on a
    card of its own."""
    ex = _example("config5_manyrays_torch")
    size = ["--width", str(w), "--height", str(h), "--spp", str(spp),
            "--bounces", str(bounces)] + ["--cpu"] * (device == "cpu")
    scene, cfg, proj, view = ex._config(ex._args(size))
    dev = compile_scene(scene, device=device)
    secs, imgs = {}, {}
    for n in [1] + counts:
        r = Renderer(dev, dataclasses.replace(
            cfg, shard_devices=n if n > 1 else 0), proj, view)
        r.advance(cfg.passes_per_call)      # warm-up
        r.reset()
        _reset_counts()
        secs[n] = _timed_window(lambda: r.advance(window), r._mesh)
        imgs[n] = r.image()
        # (--cpu renders the example on the dense route: no K1 there)
        by = (_launches_on("K1", r._mesh, want=window * r._ntiles)
              if n > 1 and cfg.use_kernels else {})
        differ = int((imgs[n] != imgs[1]).any(-1).sum())
        print(f"(b) config 5 colonnes {w}x{h}x{bounces}, {window} passes on "
              f"{n} card{'s' * (n > 1)}: {secs[n]:.4f} s, "
              f"{mk.k1_launch.launches} K1 launches"
              f"{f' by card {by}' * (n > 1)};"
              f" {differ} of {w * h} pixels differ from one card", flush=True)
        if differ:
            raise AssertionError(f"config 5 on {n} cards differs")
    scale = _scaling(w * h * window * bounces, secs)
    _scaling_line(f"(b) config 5 {w}x{h}x{bounces} in one process", scale)
    prof = card_profile(lambda: r.advance(r.nb_passes + cfg.passes_per_call),
                        r._mesh, "K1", r._ntiles)
    _profile_line(f"(b) {cfg.passes_per_call} passes on {len(r._mesh)} "
                  f"cards", prof)

    # one process, spp passes: the Renderer's sequential sum, and in the
    # same passes each process's block of a run in n processes, summed in
    # process order as run_multihost_render sums them (each pass is added
    # to a zero buffer, exactly its rgb, then to both)
    r = Renderer(dev, cfg, proj, view)
    seq = torch.zeros_like(r._accs[0])
    one = torch.zeros_like(seq)
    blocks = {n: [torch.zeros_like(seq) for _ in range(n)] for n in counts}

    def one_process():
        for p in range(spp):
            one.zero_()
            r._accs = [one]
            r._passes(p, 1)
            seq.add_(one)
            for n, parts in blocks.items():
                parts[p * n // spp].add_(one)

    one_s = _timed_window(one_process, r._mesh)
    ref = r.resolve(seq, passes=spp)
    rays = w * h * spp * bounces
    # recursive float32 summation of spp passes: each sum within
    # spp * 2**-24 of the sum of its (non-negative) terms
    rtol = 2 * spp * 2.0 ** -24
    proc = {1: (one_s, one_s)}
    straight = {}
    for n in counts:
        stats = _run_example(size + ["--processes", str(n), "--straight",
                                     "--out", os.path.join(tmp, f"s{n}")],
                             device == "cpu")
        straight[n] = np.load(os.path.join(tmp, f"s{n}",
                                           "manyrays_image.npy"))
        proc[n] = (stats["render_s"], stats["wall_s"])
        parts = [a.cpu().numpy() for a in blocks[n]]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        differ = int((straight[n] != r.resolve(total, passes=spp)).sum())
        off = np.abs(straight[n] - ref)
        print(f"(b) config 5 at {spp} spp in {n} processes on "
              f"{stats['devices']}: {stats['render_s']:.3f} s for the "
              f"longest process's block (its scene on its card to its last "
              f"pass), {stats['wall_s']} s wall with the processes' starts; "
              f"one process {one_s:.3f} s; {differ} channels differ from its "
              f"blocks summed in process order; from its sequential sum max "
              f"abs difference {off.max():.3e}, max relative "
              f"{(off / np.maximum(ref, 1e-30)).max():.3e} (bound {rtol:.3e}),"
              f" {int((off > 1e-5 * np.abs(ref) + 1e-6).sum())} channels past "
              f"rtol 1e-5", flush=True)
        if differ:
            raise AssertionError(f"config 5 in {n} processes is not its "
                                 f"blocks' sum")
        np.testing.assert_allclose(straight[n], ref, rtol=rtol, atol=0)
        _distinct_cards(device, stats["devices"], n)
    n = max(counts)
    stats = _run_example(size + ["--processes", str(n), "--out",
                                 os.path.join(tmp, f"r{n}")], device == "cpu")
    resumed = np.load(os.path.join(tmp, f"r{n}", "manyrays_image.npy"))
    r_differ = int((resumed != straight[n]).sum())
    print(f"(b) config 5 in {n} processes on {stats['devices']}, each "
          f"stopped after its first half (checkpoints at passes "
          f"{stats['resumed_at_pass']}) and resumed in new processes: "
          f"{stats['wall_s']} s wall; {r_differ} channels differ from the "
          f"straight run", flush=True)
    if r_differ:
        raise AssertionError("config 5's resume is not bit-identical")
    _distinct_cards(device, stats["devices"], n)
    pscale = {k: (rays / s[0], rays / s[0] / (k * rays / one_s))
              for k, s in proc.items()}
    _scaling_line(f"(b) config 5 at {spp} spp, one process per card "
                  f"(render, without the processes' starts)", pscale)
    return dict(scale=scale, pscale=pscale, prof=prof, one_s=one_s,
                proc=proc)


def _distinct_cards(device, devices, n):
    """Raise unless the n processes' devices are n distinct cards (on the
    card, where the host has n of them)."""
    if device == "cuda" and torch.cuda.device_count() >= n \
            and len(set(devices)) != n:
        raise AssertionError(f"{n} processes on {devices}: not one card each")


def _k2_shard(dev, o, sd, st, bounces, mesh):
    """K2 on the last card's shard: its recorded launches timed (the card
    kept ahead), the plain version through the same route with its time
    and needed work, and the two against each other."""
    last = mesh[-1]
    with kernels.on_device(last):   # events, sleeps and syncs on it
        s, o = to_device(dev, last), o.to(last)
        rec = []

        def record(inp, stf, sti, whole_path):
            rec.append((inp, stf.clone(), sti.clone(), whole_path))
            bk.fused_call(inp, stf, sti, whole_path)

        got = bk.raytrace_fused(s, o, sd[-1], st[-1], 0, nb_bounces=bounces,
                                refract_ind=1.0, call=record)
        ms_launch, ms_pass, _, _, late = _time_launches(rec, count=False,
                                                        reps=3)
        plain_rec, plain_ev, need = [], [], []

        def plain_call(inp, stf, sti, whole_path):
            if not need:
                need.append(bk.K2Need(inp, stf.device))
            plain_rec.append((inp, stf.clone(), sti.clone(), whole_path))
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            bk.fused_call_reference(inp, stf, sti, whole_path, need=need[0])
            e1.record()
            plain_ev.append((e0, e1))

        plain = bk.raytrace_fused(s, o, sd[-1], st[-1], 0, nb_bounces=bounces,
                                  refract_ind=1.0, call=plain_call)
        torch.cuda.synchronize()
        plain_ms = sum(e0.elapsed_time(e1) for e0, e1 in plain_ev)
        bound_ms, bound_by, ops, nbytes = _k2_bound(plain_rec, need[0])
    share, err = fused_match(plain.cpu(), got.cpu())
    print(f"K2 on the shard of {sd[-1].shape[0]} rays on {last}: "
          f"{ms_launch:.4f} ms a launch, {ms_pass:.4f} ms over its "
          f"{len(rec)} launches (the card kept ahead, median of 3, {late} "
          f"late); plain {plain_ms:.1f} ms; bound {bound_ms:.5f} ms "
          f"({bound_by}: {ops:.4g} operations, {nbytes} bytes); against the "
          f"plain version {share:.5f} of pixels more than {FUSED_TOL} off, "
          f"max_abs_err={err:.3e}", flush=True)
    assert_fused_protocol(plain.cpu(), got.cpu(), f"K2 on the shard on {last}")
    return dict(ms=ms_pass, ms_launch=ms_launch, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shard_rays=sd[-1].shape[0], shard_launches=len(rec),
                card=str(last))


def phase_mc_mesh(device, counts, w=800, h=600, bounces=8, passes=2):
    """(c) K2 on mesh_demo w x h x bounces: `passes` passes of
    make_sharded_pass over n cards for n in `counts` against one call on
    all rays a pass on one card, under the fused protocol, with rays/s,
    the scaling efficiency, K2's launches by card (a launch a bounce and
    pass on each), the cards' busy time, idle share, overlap and peak
    memory; K2 on the last card's shard against its plain version with
    its time and bound."""
    dev = compile_scene(scenes.build("mesh_demo"), device=device)
    o, d, tc = _rays(device, w, h)
    route = dict(use_kernels=True, use_megakernel=None, use_fused=None,
                 cull_chunks=None)

    def one_card():
        return sum(raytrace(dev, o, d, tc, k, nb_bounces=bounces,
                            refract_ind=1.0, **route) for k in range(passes))

    raytrace(dev, o, d[:4096], tc[:4096], 0, nb_bounces=bounces,
             refract_ind=1.0, **route)      # warm-up
    _reset_counts()
    out = {}
    secs = {1: _timed_window(lambda: out.update(want=one_card()),
                             [dev.device])}
    want = out["want"].cpu() / passes
    for n in counts:
        mesh = make_mesh(n, device)
        sd, st, _ = shard_rays(mesh, d, tc)
        fn = make_sharded_pass(mesh, nb_bounces=bounces, route=route)
        wd, wt, _ = shard_rays(mesh, d[:4096 * n], tc[:4096 * n])
        fn(dev, [torch.zeros_like(x) for x in wd], wd, wt, o, 0, 1.0)
        acc = [torch.zeros_like(x) for x in sd]
        _reset_counts()
        _reset_peaks(mesh)

        def window():
            for k in range(passes):
                fn(dev, acc, sd, st, o, k, 1.0)

        secs[n] = _timed_window(window, mesh)
        by = _launches_on("K2", mesh, want=passes * bounces)
        got = torch.cat([a.cpu() for a in acc])[: w * h] / passes
        share, err = fused_match(want, got)
        print(f"(c) mesh_demo {w}x{h}x{bounces}, {passes} passes over {n} "
              f"cards: {secs[n]:.4f} s, K2 by card {by}; peak memory by card "
              f"{_peak_memory(mesh)} bytes; {int(round(share * w * h))} of "
              f"{w * h} pixels more than {FUSED_TOL} off one card (share "
              f"{share:.5f}), max abs difference {err:.3e}", flush=True)
        assert_fused_protocol(want, got, f"mesh_demo on {n} cards")
    scale = _scaling(w * h * passes * bounces, secs)
    _scaling_line(f"(c) mesh_demo {w}x{h}x{bounces} in one process", scale)
    prof = card_profile(window, mesh, "K2", bounces)
    _profile_line(f"(c) {passes} passes on {n} cards", prof)
    shard = _k2_shard(dev, o, sd, st, bounces, mesh)
    return dict(shard, scale=scale, prof=prof,
                launches=passes * bounces * len(mesh), by_card=by)


def phase_mc_sample(device, n, w=800, h=600, bounces=3):
    """(d) make_sample_sharded_pass over n cards (passes 0 .. n-1 of
    box_diffuse, one K1 launch on each card) against their sequential sum
    on one card within 1e-6, the sum on the first card."""
    dev = compile_scene(scenes.build("box_diffuse"), device=device)
    o, d, tc = _rays(device, w, h)
    route = dict(use_kernels=True, use_megakernel=True, use_fused=False,
                 cull_chunks=None)
    mesh = make_mesh(n, device)
    sfn = make_sample_sharded_pass(mesh, nb_bounces=bounces, route=route)
    _reset_counts()
    rgb = sfn(dev, d, tc, o, 0, 1.0)
    by = _launches_on("K1", mesh, want=1)
    seq = sum(raytrace(dev, o, d, tc, k, nb_bounces=bounces, refract_ind=1.0,
                       **route) for k in range(n))
    err = float((rgb.cpu() - seq.cpu()).abs().max())
    print(f"(d) sample-sharded pass over {n} cards (K1 by card {by}), summed "
          f"on {rgb.device}: max abs difference from the sequential sum on "
          f"one card {err:.3e}", flush=True)
    if rgb.device != mesh[0]:
        raise AssertionError(f"the sample-sharded sum is on {rgb.device}")
    np.testing.assert_allclose(rgb.cpu().numpy(), seq.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)


def _trace_shard(kid, dev, o, sd, st, bounces, ior, mesh, route):
    """Trace kernel kid over the last card's shard of one pass: its
    recorded launches timed (the card kept ahead), held against the plain
    version, and the bound of the work their inputs need."""
    last = mesh[-1]
    rec = []
    with kernels.on_device(last):   # events, sleeps and syncs on it
        s, o = to_device(dev, last), o.to(last)
        with record_launches(kid, rec):
            raytrace(s, o, sd[-1], st[-1], 0, nb_bounces=bounces,
                     refract_ind=ior, **route)
        ms, work, needed, late = _time_recorded(kid, rec)
        plain_ms, _, err = _plain_vs_kernel(kid, rec, n=4)
    ops = sum(_needed_ops(kid, args, int(k[0]), int(k[1]), int(k[2]))
              for k, (_, args, _) in zip(needed, rec))
    nbytes = sum(_launch_bytes(kid, args) for _, args, _ in rec)
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"{kid} over the shard of {sd[-1].shape[0]} rays on {last}: "
          f"{ms.mean():.4f} ms a launch over {len(rec)} launches (median of "
          f"3, {late} late); bound {bound_ms / len(rec):.5f} ms a launch "
          f"({bound_by}); plain {plain_ms:.3f} ms", flush=True)
    return dict(ms=float(ms.mean()), plain_ms=plain_ms,
                bound_ms=bound_ms / len(rec), bound_by=bound_by,
                max_abs_err=err, shard_rays=sd[-1].shape[0], card=str(last))


def phase_mc_trace(device, n, w=200, h=150):
    """(e) the pallas-trace route (use_megakernel=False) on colonnes (K5)
    and mesh_demo (K6), w x h, one pass over n cards against one call on
    all rays on one card under the fused protocol, each card launching the
    kernel; the kernel over the last card's shard against its plain
    version."""
    out = {}
    for kid, name, light, ior, bounces in (("K5", "colonnes", 0.4, 1.0, 6),
                                           ("K6", "mesh_demo", 1.2, 1.3, 8)):
        dev = compile_scene(scenes.build(name, light), device=device)
        o, d, tc = _rays(device, w, h)
        route = dict(use_kernels=True, use_megakernel=False, use_fused=False,
                     cull_chunks=None)
        want = raytrace(dev, o, d, tc, 0, nb_bounces=bounces,
                        refract_ind=ior, **route).cpu()
        mesh = make_mesh(n, device)
        sd, st, _ = shard_rays(mesh, d, tc)
        fn = make_sharded_pass(mesh, nb_bounces=bounces, route=route)
        acc = [torch.zeros_like(x) for x in sd]
        _reset_counts()
        secs = _timed_window(lambda: fn(dev, acc, sd, st, o, 0, ior), mesh)
        by = _launches_on(kid, mesh)
        got = torch.cat([a.cpu() for a in acc])[: w * h]
        share, err = fused_match(want, got)
        print(f"(e) pallas-trace route {name} {w}x{h}x{bounces}, 1 pass over "
              f"{n} cards: {secs:.4f} s, {kid} by card {by}; "
              f"{int(round(share * w * h))} of {w * h} pixels more than "
              f"{FUSED_TOL} off one card, max abs difference {err:.3e}",
              flush=True)
        assert_fused_protocol(want, got, f"{name} pallas-trace on {n} cards")
        res = _trace_shard(kid, dev, o, sd, st, bounces, ior, mesh, route)
        out[kid] = dict(res, by_card=by,
                        launches=sum(by.values()), name=name,
                        size=f"{w}x{h}x{bounces}")
    return out


_CARDS = re.compile(r"process (\d+) of \d+: (cuda:[\d-]+)")


def _cards_of(results):
    """{process: its cards} from the processes' output lines."""
    out = {}
    for _, text in results:
        for pid, cards in _CARDS.findall(text):
            out[int(pid)] = cards
    return out


def _worker_cmds(nproc, port, ck, out, scene, w, h, bounces, spp, every,
                 cpu, crash=None):
    """launcher_worker commands for nproc processes; process `crash`, if
    given, exits after 2 * every local passes."""
    return [[sys.executable, "-m",
             "montecarlo_pathtracing_tpu_torch.testing.launcher_worker",
             "--process-id", str(k), "--num-processes", str(nproc), "--port",
             str(port), "--spp", str(spp), "--checkpoint-every", str(every),
             "--checkpoint", ck, "--out", out, "--scene", scene, "--width",
             str(w), "--height", str(h), "--bounces", str(bounces),
             "--tile-rays", str(1 << 17), "--passes-per-call", "8"]
            + ["--crash-at", str(2 * every)] * (k == crash) + ["--cpu"] * cpu
            for k in range(nproc)]


def _worker_render(nproc, tmp, tag, scene, w, h, bounces, spp, every, cpu):
    """nproc launcher_worker processes, one card each: (the image, the
    longest render of a process's block, from its scene on its card to its
    last pass before the gather, the wall seconds with the processes'
    starts, each process's device)."""
    ck, out = os.path.join(tmp, f"{tag}.npz"), os.path.join(tmp, f"{tag}.npy")
    results, wall, _ = _launch_ranks(_worker_cmds(
        nproc, _free_port(), ck, out, scene, w, h, bounces, spp, every, cpu),
        cpu)
    if any(rc for rc, _ in results):
        raise AssertionError(f"{nproc} workers failed:\n" + "\n".join(
            o[-3000:] for _, o in results))
    times = [json.loads(o.strip().splitlines()[-1]) for _, o in results]
    render = max(t["t_rendered"] - t["t_ready"] for t in times)
    return np.load(out), render, wall, [t["device"] for t in times]


def _crash_one(nproc, tmp, img, scene, w, h, bounces, spp, every, cpu):
    """nproc workers, one card each, process 1 crashing after 2 * every of
    its passes; the others, their blocks checkpointed, are stopped as a
    job scheduler tears down the group, and nproc new processes resume
    from the checkpoints: the image against `img` bit for bit."""
    ck, out = os.path.join(tmp, "crash.npz"), os.path.join(tmp, "crash.npy")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    per = spp // nproc
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in _worker_cmds(nproc, _free_port(), ck, out, scene, w,
                                     h, bounces, spp, every, cpu, crash=1)]
    try:
        procs[1].communicate(timeout=600)
        if procs[1].returncode != 3:
            raise AssertionError(f"the crashing worker exit "
                                 f"{procs[1].returncode}")
        deadline = time.perf_counter() + 600
        for k in range(nproc):
            if k == 1:
                continue
            path = f"{ck[:-4]}.p{k}.npz"
            while True:
                try:
                    with np.load(path) as z:
                        if int(z["nb_passes"]) == (k + 1) * per:
                            break
                except (OSError, ValueError, KeyError, EOFError):
                    pass
                if time.perf_counter() > deadline:
                    raise AssertionError(f"worker {k} never checkpointed "
                                         f"its block")
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    crash_s = time.perf_counter() - t0
    with np.load(f"{ck[:-4]}.p1.npz") as z:
        saved = int(z["nb_passes"])
    results, resume_s, _ = _launch_ranks(_worker_cmds(
        nproc, _free_port(), ck, out, scene, w, h, bounces, spp, every, cpu),
        cpu)
    if any(rc for rc, _ in results):
        raise AssertionError("the relaunched workers failed:\n" + "\n".join(
            o[-3000:] for _, o in results))
    differ = int((np.load(out) != img).sum())
    print(f"(g) {nproc} workers, one card each: worker 1 crashed at pass "
          f"{saved} (its block starts at {per}), the others stopped once "
          f"their blocks were checkpointed ({crash_s:.3f} s); the relaunch "
          f"resumed and finished in {resume_s:.3f} s: {differ} channels "
          f"differ from the uninterrupted render", flush=True)
    if saved != per + 2 * every or differ:
        raise AssertionError("one worker's crash and resume did not "
                             "reproduce the image")


def _cli_group(nproc, devices, tmp, tag, size, spp, every, cpu):
    """`render --distributed` in nproc processes, `devices` cards each: the
    sum of their checkpointed accumulators, process 0's PNG and each
    process's cards."""
    ck, png = os.path.join(tmp, f"{tag}.npz"), os.path.join(tmp, f"{tag}.png")
    port = _free_port()
    results, wall, _ = _launch_ranks([
        [sys.executable, "-m", "montecarlo_pathtracing_tpu_torch", "render",
         "--distributed", "--coordinator", f"localhost:{port}",
         "--num-processes", str(nproc), "--process-id", str(k), "--scene",
         "box_diffuse", *size, "--spp", str(spp), "--checkpoint-every",
         str(every), "--checkpoint", ck, "--out", png, "--devices",
         str(devices)] + ["--cpu", "--pallas"] * cpu for k in range(nproc)],
        cpu)
    if any(rc for rc, _ in results) or png not in results[0][1]:
        raise AssertionError(f"{nproc}-process CLI render failed:\n"
                             + "\n".join(o[-3000:] for _, o in results))
    acc = 0
    for k in range(nproc):
        with np.load(f"{ck[:-4]}.p{k}.npz") as z:
            acc = acc + z["acc"]
    return acc, read_png(png), _cards_of(results), wall


def phase_mc_processes(device, tmp, n, w=800, h=600, bounces=3, spp=64,
                       every=4, mesh_spp=8):
    """(g) processes and the command line: one process per card, 2 and n
    processes (launcher_worker), on box_diffuse w x h x bounces at spp
    passes and mesh_demo w x h x 8 at mesh_spp, against one process here
    (rays/s of the render, and the wall with the processes' starts); the
    CLI's render --devices n against --devices 0, the same PNG; render
    --distributed in n processes, one card each, and in 2 processes of 2
    cards each, against one process within rtol 1e-5, process 0's PNG
    the gathered image's; one worker's crash and the group's relaunch,
    resumed bit for bit."""
    cpu = device == "cpu"
    size = ["--width", str(w), "--height", str(h), "--bounces", str(bounces)]
    out = {}
    for scene, b, s in (("box_diffuse", bounces, spp),
                        ("mesh_demo", 8, mesh_spp)):
        cfg = RenderConfig(width=w, height=h, nb_bounces=b,
                           tile_rays=1 << 17, passes_per_call=8,
                           device=device)
        r = Renderer(compile_scene(scenes.build(scene), device=device), cfg)
        r.advance(cfg.passes_per_call)      # warm-up
        r.reset()
        one_s = _timed_window(lambda: r.advance(s), r._mesh)
        ref = r.image()
        rays = w * h * s * b
        rows = {1: (rays / one_s, 1.0, one_s)}
        for nproc in sorted({2, n}):
            img, render, wall, devs = _worker_render(
                nproc, tmp, f"{scene}{nproc}", scene, w, h, b, s, every, cpu)
            _distinct_cards(device, devs, nproc)
            np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
            rows[nproc] = (rays / render, rays / render / (nproc * rays
                                                           / one_s), wall)
            print(f"(g) {scene} {w}x{h}x{b}, {s} spp in {nproc} processes on "
                  f"{devs}: {render:.4f} s render ({rays / render:.6g} rays/s,"
                  f" efficiency {rows[nproc][1]:.4f}), {wall:.3f} s wall with "
                  f"the starts; one process {one_s:.4f} s ({rays / one_s:.6g} "
                  f"rays/s); max abs difference {np.abs(img - ref).max():.3e}",
                  flush=True)
            if scene == "box_diffuse" and nproc == n:
                straight = img
        out[scene] = rows
    _crash_one(n, tmp, straight, "box_diffuse", w, h, bounces, spp, every,
               cpu)

    # the CLI: --devices n against --devices 0 in this process
    pngs = []
    for devices in (0, n):
        path = os.path.join(tmp, f"devices{devices}.png")
        rc, lines = _cli(["render", "--scene", "box_diffuse", *size, "--spp",
                          str(spp // 4), "--devices", str(devices), "--out",
                          path] + ["--cpu", "--pallas"] * cpu)
        if rc != 0 or path not in lines:
            raise AssertionError(f"render --devices {devices} failed")
        pngs.append(read_png(path))
    differ = int((pngs[0] != pngs[1]).sum())
    print(f"(g) render --devices {n} against --devices 0, box_diffuse "
          f"{w}x{h}x{bounces}, {spp // 4} spp: {differ} PNG channels differ",
          flush=True)
    if differ:
        raise AssertionError(f"render --devices {n} wrote another PNG")

    # render --distributed: n processes of one card, 2 of 2 cards
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       light_intensity=1.2, device=device)
    r = Renderer(compile_scene(scenes.build("box_diffuse", 1.2),
                               device=device), cfg)
    ref = r.run(spp)
    # 2 processes of n/2 cards each need n cards (one card: shards that
    # share it come from an explicit mesh, which the CLI does not take)
    groups = [(n, 0)] + [(2, n // 2)] * (n >= 4 and (
        cpu or torch.cuda.device_count() >= n))
    for nproc, devices in groups:
        acc, png, cards, wall = _cli_group(nproc, devices, tmp,
                                           f"cli{nproc}x{devices}", size, spp,
                                           every, cpu)
        img = r.resolve(acc, passes=spp)
        want_png = tonemap(img)[::-1] / np.float32(255.0)
        png_differ = int((png != want_png).sum())
        print(f"(g) render --distributed in {nproc} processes x "
              f"{max(1, devices)} card{'s' * (devices > 1)} on {cards}: "
              f"{wall:.3f} s wall; max abs difference from one process "
              f"{np.abs(img - ref).max():.3e}; process 0's PNG: {png_differ} "
              f"channels differ from the checkpoints' sum", flush=True)
        np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
        if png_differ:
            raise AssertionError("process 0's PNG is not the gathered image")
        if not cpu and torch.cuda.device_count() >= nproc * max(1, devices):
            want = {k: (f"cuda:{k}" if devices <= 1 else
                        f"cuda:{k * devices}-{k * devices + devices - 1}")
                    for k in range(nproc)}
            if cards != want:
                raise AssertionError(f"processes on {cards}, want {want}")
    return out


def _mc_line(kid, name, res):
    """A kernels-line entry of phase 17: the kernel on the last card's
    shard, with its launches in the phase's window, by card."""
    source, replaces = {"K1": (K1_SOURCE, K1_REPLACES),
                        "K2": (K2_SOURCE, K2_REPLACES)}.get(
        kid) or (TRACE_SOURCE, TRACE_KERNELS[kid][1])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": res["launches"],
            "launches_by_card": res["by_card"],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


def run_multicard(name_power):
    """Phase 17 (multi-card rendering), where the host has 2 cards or
    more: its kernels-line entries ([] where it did not run)."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 17 (multi-card rendering) not run: this host has {n} "
              f"card{'s' * (n != 1)}, it needs 2 or more", flush=True)
        return []
    t0 = time.perf_counter()
    counts = sorted({2, n})
    _reset_counts()
    dryrun_multichip(n)
    print(f"(f) dryrun_multichip({n}) over {n} cards: K1 by card "
          f"{_launches_on('K1', make_mesh(n))}, K2 by card "
          f"{_launches_on('K2', make_mesh(n))}", flush=True)
    audit = audit_routes("cuda", make_mesh(n))
    a = phase_mc_box("cuda", counts)
    with tempfile.TemporaryDirectory() as tmp:
        b = phase_mc_config5("cuda", counts, tmp)
    c = phase_mc_mesh("cuda", counts)
    phase_mc_sample("cuda", n)
    e = phase_mc_trace("cuda", n)
    with tempfile.TemporaryDirectory() as tmp:
        g = phase_mc_processes("cuda", tmp, n)
    print(f"[{name_power}] phase 17 over {n} cards: rays/s at "
          + "; ".join(f"{what} " + ", ".join(
              f"{k}: {v[0]:.6g} ({v[1]:.4f})" for k, v in sorted(sc.items()))
              for what, sc in (("(a) in one process", a["scale"]),
                               ("(b) in one process", b["scale"]),
                               ("(b) a process per card", b["pscale"]),
                               ("(c) in one process", c["scale"]),
                               ("(a) a process per card", g["box_diffuse"]),
                               ("(c) a process per card", g["mesh_demo"])))
          + f" (cards: rays/s (efficiency)); host syncs of a sharded pass: "
          + ", ".join(f"{k} {sum(v.values())}" for k, v in audit.items())
          + f"; phase 17 {time.perf_counter() - t0:.1f} s", flush=True)
    return [_mc_line("K1", f"K1 mega_kernel, box_diffuse 800x600x3 on {n} "
                           f"cards, the {a['shard_rays']}-ray shard on "
                           f"{a['card']}", a),
            _mc_line("K2", f"K2 fused_kernel, mesh_demo 800x600x8 on {n} "
                           f"cards, the {c['shard_rays']}-ray shard on "
                           f"{c['card']} (its {c['shard_launches']} "
                           f"launches)", c)] + [
        _mc_line(kid, f"{TRACE_KERNELS[kid][0]}, pallas-trace route "
                      f"{e[kid]['name']} {e[kid]['size']} on {n} cards, the "
                      f"{e[kid]['shard_rays']}-ray shard on {e[kid]['card']}",
                 e[kid]) for kid in ("K5", "K6")]


def _aos_line(kid, res):
    line = _trace_line(kid, res)
    line["name"] += f", montecarlo_aos {res['name']} {res['size']}"
    return line


def _trace_line(kid, res):
    name, replaces, _ = TRACE_KERNELS[kid]
    if "info" in res:
        name += (f" ({res['info']['threads']} threads a block, "
                 f"{res['info']['lanes']} lanes a ray)")
    return {"name": name, "route": "cuda", "source": TRACE_SOURCE,
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


def phase_builds(names, variants=()):
    """Phase 1: build and load the kernels of csrc/<name>.cu for `names`
    (and the variant builds), one nvcc each, started together; print the
    compile reports, each variant's registers and spills, and the SASS by
    instruction class."""
    t0 = time.perf_counter()
    kernels.build_all(names, variants)
    loaders = {"megakernel": kernels.megakernel_lib,
               "bounce_kernel": kernels.bounce_kernel_lib,
               "trace_kernels": kernels.trace_kernels_lib}
    for name in names:
        loaders[name]()
    print(f"{', '.join(names)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        print(kernels.build_log(name).strip(), flush=True)
    if "megakernel" in names:
        print_registers(kernels.build_log("megakernel"), "mega_kernel")
        print_k1_sass()
    if "bounce_kernel" in names:
        print_registers(kernels.build_log("bounce_kernel"), "fused_kernel")
    if "trace_kernels" in names:
        for kernel in ("an_walk", "an_tile_walk", "group_kernel",
                       "group_culled_kernel", "group_tile_kernel",
                       "tri_kernel", "tri_culled_kernel", "mesh_walk"):
            print_registers(kernels.build_log("trace_kernels"), kernel)
        print_fold_sass()


def run_k1(name_power):
    """Phases 2, 3 and K1's full-size windows: (phase 3's result, the
    windows' results)."""
    worst = phase_parity("cuda")
    res = phase_main_path("cuda")
    print(f"[{name_power}] end to end {res['rays_per_s']:.6g} rays/s "
          f"(800x600 x 64 passes x 3 bounces / {res['window_s']:.4f} s); "
          f"K1 {res['k1_ms']:.5f} ms/pass (bound {res['bound_ms']:.5f} ms, "
          f"{res['bound_by']}); plain version {res['plain_ms']:.3f} ms/pass "
          f"(800x600, 3 bounces)", flush=True)
    print(f"phase-2 parity worst max_abs_err {worst:.3e}", flush=True)
    k1_windows = []
    for args in K1_WINDOWS:
        resw = phase_k1_window("cuda", *args)
        print(f"[{name_power}] K1 {resw['name']} {args[3]}x{args[4]}x"
              f"{args[5]}: {resw['ms']:.5f} ms per pass; on the slice "
              f"{resw['slice_ms']:.5f} ms (bound {resw['bound_slice']:.5f} "
              f"ms, {resw['bound_by']}; plain {resw['plain_ms']:.1f} ms)",
              flush=True)
        k1_windows.append(resw)
    return res, k1_windows


def run_trace_parity(name_power):
    """Phase 7 and K4b's numbers over its launches: (K4b's kernels-line
    result, K5's on the cone and quad groups)."""
    worst3, rec4b, k4b_launches, behind = phase_trace_parity("cuda")
    print(f"phase-7 trace kernel parity worst max_abs_err {worst3}",
          flush=True)
    k4b = dict(phase_k4b_stats(rec4b), launches=k4b_launches)
    print(f"[{name_power}] K4b {k4b['ms']:.4f} ms/launch over "
          f"phase 7's {k4b_launches} launches (bound "
          f"{k4b['bound_ms']:.5f} ms/launch, {k4b['bound_by']}); plain "
          f"{k4b['plain_ms']:.3f} ms/launch", flush=True)
    return k4b, behind


def main(argv=()) -> int:
    """With no arguments every phase; `--only k1` (phases 1-3 and K1's
    windows, K1 built alone), `--only k2` (phases 1, 4 and 5) and `--only
    whole` (phases 1 and 6), K2 and its counting build built, `--only trace` (phases 1 and 7, the trace
    kernels built alone), `--only dense` (phases 1 and 13, K1 and the
    trace kernels built), `--only diff` (phases 1 and 14, the trace
    kernels built alone), `--only tools` (phases 1 and 15, K1 and K2
    built), `--only multi` (phases 1 and 16, K1 and K2 built) or `--only
    multicard` (phases 1 and 17, K1, K2 and the trace kernels built, on
    a host of 2 cards or more; its kernels line too) run one part, for a
    quick look."""
    only = None
    parts = ("k1", "k2", "whole", "trace", "dense", "diff", "tools", "multi",
             "multicard")
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or argv[1] not in parts:
            print(f"usage: chip_smoke.py [--only {'|'.join(parts)}]",
                  file=sys.stderr)
            return 2
        only = argv[1]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_power = card()
    print(name_power, flush=True)
    if only == "k1":
        phase_builds(["megakernel"])
        run_k1(name_power)
    elif only == "k2":
        phase_builds(["bounce_kernel"], [("bounce_kernel", kernels.K2_COUNTS)])
        run_k2(name_power)
    elif only == "whole":
        phase_builds(["bounce_kernel"], [("bounce_kernel", kernels.K2_COUNTS)])
        run_whole(name_power)
    elif only == "trace":
        phase_builds(["trace_kernels"])
        run_trace_parity(name_power)
    elif only == "dense":
        phase_builds(["megakernel", "trace_kernels"])
        run_dense(name_power)
    elif only == "diff":
        phase_builds(["trace_kernels"])
        run_diff(name_power)
    elif only == "tools":
        phase_builds(["megakernel", "bounce_kernel"])
        run_tools(name_power)
    elif only == "multi":
        phase_builds(["megakernel", "bounce_kernel"])
        run_multi(name_power)
    elif only == "multicard":
        if torch.cuda.device_count() >= 2:
            phase_builds(["megakernel", "bounce_kernel", "trace_kernels"])
        print(json.dumps({"kernels": run_multicard(name_power)}))
    if only:
        print(name_power)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    phase_builds(["megakernel", "bounce_kernel", "trace_kernels"],
                 [("bounce_kernel", kernels.K2_COUNTS)])
    res, k1_windows = run_k1(name_power)
    res2 = run_k2(name_power)
    run_whole(name_power)

    k4b, behind = run_trace_parity(name_power)
    trace = {"K4b": k4b}
    worst4 = phase_trace_route_parity("cuda")
    print(f"phase-8 route parity worst max_abs_err {worst4:.3e}", flush=True)
    for kid, name, light, ior, w, h, bounces, window in (
            ("K6", "mesh_demo", 1.2, 1.0, 800, 600, 8, 2),
            ("K5", "colonnes", 0.4, 1.0, 1920, 1080, 6, 1)):
        res3 = phase_trace_path("cuda", name, light, ior, kid, w, h, bounces,
                                window)
        print(f"[{name_power}] {name} pallas-trace route end to end "
              f"{res3['rays_per_s']:.6g} rays/s ({w}x{h} x {window} passes x "
              f"{bounces} bounces / {res3['window_s']:.4f} s); {kid} "
              f"{res3['ms']:.4f} ms/launch, {res3['ms_pass']:.4f} ms/pass "
              f"(bound {res3['bound_pass']:.4f} ms/pass, {res3['bound_by']}); "
              f"plain {res3['plain_ms']:.3f} ms/launch", flush=True)
        trace[kid] = res3
    for kid, name, light, ior, bounces in (
            ("K4a", "mesh_demo", 1.2, 1.0, 8), ("K3a", "colonnes", 0.4, 1.0, 6)):
        res3 = phase_trace_brute("cuda", name, light, ior, kid, bounces)
        print(f"[{name_power}] {name} cull_chunks=False {kid} "
              f"{res3['ms']:.4f} ms/launch, {res3['ms_pass']:.4f} ms/pass "
              f"(bound {res3['bound_pass']:.4f} ms/pass, {res3['bound_by']}); "
              f"plain {res3['plain_ms']:.3f} ms/launch", flush=True)
        trace[kid] = res3
    res4 = phase_large_scene("cuda")
    print(f"[{name_power}] scene_stress(200000) pallas-trace route end to "
          f"end {res4['rays_per_s']:.6g} rays/s (800x600 x 1 pass x 3 bounces"
          f" / {res4['window_s']:.4f} s; host build {res4['build_s']:.2f} s, "
          f"compile_scene {res4['compile_s']:.2f} s); K3b {res4['ms']:.4f} "
          f"ms/launch, {res4['ms_pass']:.4f} ms/pass (bound "
          f"{res4['bound_pass']:.4f} ms/pass, {res4['bound_by']}; its box "
          f"scan alone {res4['scan_ms']:.4f} ms/launch); plain "
          f"{res4['plain_ms']:.3f} ms/launch", flush=True)
    trace["K3b"] = res4
    phase_fma(trace)
    aos = run_dense(name_power)
    grads = run_diff(name_power)
    run_tools(name_power)
    multi_k1, multi_k2 = run_multi(name_power)
    multicard = run_multicard(name_power)

    print(json.dumps({"kernels": [
        {"name": "K1 mega_kernel", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": res["launches"],
         "max_abs_err": res["max_abs_err"], "ms": res["k1_ms"],
         "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
         "bound_by": res["bound_by"], "library_ms": None}]
        + [{"name": f"K1 mega_kernel {rw['name']}, a {K1_SLICE}-ray slice",
            "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
            "launches": rw["launches"], "max_abs_err": rw["max_abs_err"],
            "ms": rw["slice_ms"], "plain_ms": rw["plain_ms"],
            "bound_ms": rw["bound_slice"], "bound_by": rw["bound_by"],
            "library_ms": None} for rw in k1_windows]
        + [{"name": "K2 fused_kernel", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": res2["launches"],
         "max_abs_err": res2["max_abs_err"], "ms": res2["k2_ms"],
         "plain_ms": res2["plain_ms"], "bound_ms": res2["bound_ms"],
         "bound_by": res2["bound_by"], "library_ms": None}]
        + [_trace_line(kid, trace[kid])
           for kid in ("K3a", "K3b", "K4a", "K4b", "K5", "K6")]
        + [_aos_line(kid, aos[kid]) for kid in ("K3a", "K4a")]
        + [_grad_line(kid, grads[kid]) for kid in ("K5", "K6")]
        + [dict(line, name=line["name"].replace(
            "K5 an_walk", f"K5 an_tile_walk, a random shape-{code} group"))
           for code, line in sorted((c, _trace_line("K5", r))
                                    for c, r in behind.items())]
        + [{"name": f"K1 mega_kernel, sharded box_diffuse 800x600x3, a "
                    f"{multi_k1['shard_rays']}-ray shard of 2 on one card",
            "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
            "launches": multi_k1["launches"],
            "max_abs_err": multi_k1["max_abs_err"], "ms": multi_k1["ms"],
            "plain_ms": multi_k1["plain_ms"],
            "bound_ms": multi_k1["bound_ms"],
            "bound_by": multi_k1["bound_by"], "library_ms": None},
           {"name": f"K2 fused_kernel, sharded mesh_demo 800x600x8, a "
                    f"{multi_k2['shard_rays']}-ray shard of 2 on one card "
                    f"(its {multi_k2['shard_launches']} launches)",
            "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "launches": multi_k2["launches"],
            "max_abs_err": multi_k2["max_abs_err"], "ms": multi_k2["ms"],
            "plain_ms": multi_k2["plain_ms"],
            "bound_ms": multi_k2["bound_ms"],
            "bound_by": multi_k2["bound_by"], "library_ms": None}]
        + multicard}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
