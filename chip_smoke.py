"""GPU smoke of the PyTorch/CUDA port: build every kernel, hold each one
against its plain PyTorch version, and drive both ported paths once.

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a) and nvcc; fails with a non-zero exit code,
and prints no result, without them. Phases (about 4 minutes in all on an
H100, the builds included):

1. the card's name and power limit; build K1 (csrc/megakernel.cu) and K2
   (csrc/bounce_kernel.cu), one nvcc each, started together, and print
   both compile reports (registers, spills);
2. K1 against its plain version (models/megakernel.mega_pass_reference)
   on the card, 64x48 pixels, 4 bounces, passes 0 and 3, under the
   megakernel protocol (testing/parity.py), on box_diffuse (cull off,
   opaque), box_balls (transparent), materials (cull on) and a scene with
   all five shapes, transparency and the cull; and nb_bounces=0 -> black;
3. K1's main path at full size: box_diffuse at 800x600, 3 bounces,
   64 passes per call, tile_rays 1<<17, through compile_scene and
   Renderer.advance; the launch count of K1 over one 64-pass window; the
   image finite and non-negative; the device's busy time per pass under
   torch.profiler and its idle share; a 4-pass accumulation of K1 against
   the plain version's; rays/s (pixels x passes x bounces / seconds), K1's
   and the plain version's time per pass, and K1's bound;
4. K2 against its plain version (models/bounce_kernel.
   fused_call_reference) through raytrace_fused on the card, 64x48, 4
   bounces, passes 0 and 3, under the fused protocol, on mesh_demo at IOR
   1.3 (wavefront mode, transparent: the scheduled outer walk and the
   schedule-free re-trace), the opaque mesh fixture with flat faces, a
   4200-prim scene_stress (large analytic groups, whole-path mode; 1.5%
   allowed) and a mesh scene with a culled 88-prim table; and
   nb_bounces=0 -> black in both modes;
5. K2's main path at full size: mesh_demo at 800x600, 8 bounces, 8
   passes per call, tile_rays 1<<17, through compile_scene and
   Renderer.advance; K2's launch count over one 8-pass window (passes x
   tiles x 8); the image finite and non-negative; device busy and idle
   share under torch.profiler; the host's per-bounce sort and schedules;
   K2's time per launch and per pass by CUDA events, with its work
   counters and bound; a 2-pass accumulation of K2 against the plain
   version's at full size; rays/s;
6. a short window of K2's whole-path mode: stress_10k at 800x600, 3
   bounces.

The last three lines are a {"kernels": [...]} JSON object, the card's
name and power limit, and the {"ok": true, "device": {...}} JSON object.
Every check raises, so any failed phase exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.ops.rng import seed_y
from montecarlo_pathtracing_tpu_torch.ops.sort_rays import ray_sort_key
from montecarlo_pathtracing_tpu_torch.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import mesh as mesh_mod
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    FUSED_FRAC, FUSED_FRAC_STRESS, all_shapes_scene, assert_fused_protocol,
    assert_megakernel_protocol, cull_mesh_scene, fused_match,
    megakernel_match, opaque_mesh_scene)
from montecarlo_pathtracing_tpu_torch.utils import transforms

K1_SOURCE = "montecarlo_pathtracing_tpu_torch/csrc/megakernel.cu"
K1_REPLACES = "montecarlo_pathtracing_tpu/models/megakernel.py:541"
K2_SOURCE = "montecarlo_pathtracing_tpu_torch/csrc/bounce_kernel.cu"
K2_REPLACES = "montecarlo_pathtracing_tpu/models/bounce_kernel.py:776"

PARITY_CASES = (("box_diffuse", 1.0), ("box_balls", 1.3), ("materials", 1.5),
                ("all_shapes", 1.3))
# (name, IOR, share of pixels allowed more than 1e-3 off)
K2_CASES = (("mesh_demo", 1.3, FUSED_FRAC), ("flat_mesh", 1.0, FUSED_FRAC),
            ("stress_4200", 1.0, FUSED_FRAC_STRESS),
            ("cull_mesh", 1.3, FUSED_FRAC))

# Published peaks of one H100 SXM at its 700 W limit: FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations, counted from the kernels' source (common.cuh
# prim_work, bounce_step; bounce_kernel.cu fold_tris, slab_cap), of one
# ray's test of one prim by shape code (local frame, shape test, and the
# hit point and normal where it hits), one bounce step's shading, one
# Moller-Trumbore test and one slab test
PRIM_OPS = {1: 70, 2: 130, 3: 110, 4: 120, 5: 60}
SHADE_OPS = 150
TRI_OPS = 60
BOX_OPS = 25


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def table_ops(tab, groups):
    """FP32 operations of one ray's test of every real prim of a table."""
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
    elif name == "stress_4200":
        prims = scenes.scene_stress(n_prims=4200)
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


def _device_seconds(fn, kernel_name):
    """(device-busy s, the named kernel's share of it in s) of fn() under
    torch.profiler: the sum of the CUDA kernel and copy events, which run
    on one stream and so do not overlap. (0, 0) when the profiler sees no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    acc = torch.zeros_like(r4._acc)
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

    k1_ms = _time_passes(
        lambda k: [mk.k1_launch(inp, seed_y(k), bounces) for inp in inps], 20)
    # bound of one pass: every ray in flight tests every real prim and
    # shades once per bounce; 20 bytes in and 12 out per ray
    ops = sum(alive) * (table_ops(inps[0].tab, inps[0].groups) + SHADE_OPS)
    nbytes = sum(inp.dirs.shape[0] for inp in inps) * 32
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"K1 bound per pass {bound_ms:.4f} ms ({bound_by}: {ops:.4g} FP32 "
          f"operations over {sum(alive)} ray-bounces, {nbytes} bytes)",
          flush=True)
    return dict(rays_per_s=rays_per_s, window_s=window_s, launches=launches,
                k1_ms=k1_ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_k2_parity(device, w=64, h=48, bounces=4):
    """K2 vs its plain version through raytrace_fused, per scene and pass."""
    o, d, tc = _rays(device, w, h)
    worst = 0.0
    for name, ior, frac in K2_CASES:
        dev = build_scene(name, device)
        for p in (0, 3):
            got = bk.raytrace_fused(dev, o, d, tc, p, nb_bounces=bounces,
                                    refract_ind=ior)
            ref = bk.raytrace_fused(dev, o, d, tc, p, nb_bounces=bounces,
                                    refract_ind=ior,
                                    call=bk.fused_call_reference)
            got, ref = got.cpu().numpy(), ref.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"{name} pass {p}: non-finite K2 output")
            off, err = fused_match(ref, got)
            print(f"K2 parity {name} ior={ior} pass={p} "
                  f"meshes={len(dev.mesh_prim_index)} "
                  f"large_groups={len(dev.ana_groups)} "
                  f"cull_small={bk.cull_small(dev)} "
                  f"transparent={dev.has_transparent} "
                  f"flat_face={dev.flat_face}: off={off:.4f} (allowed "
                  f"{frac}) max_abs_err={err:.3e}", flush=True)
            assert_fused_protocol(ref, got, f"K2 {name} pass {p}", frac)
            worst = max(worst, err)
        black = bk.raytrace_fused(dev, o, d, tc, 0, nb_bounces=0,
                                  refract_ind=ior)
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


def _time_launches(rec, reps=3):
    """(ms per launch, ms per pass) of K2 over the recorded calls of one
    pass, by CUDA events around each launch, the pass's work counters
    (tri, box, prim, traces, lane slots of the chunk folds), and each
    recorded call's mean ms."""
    work = torch.zeros(5, dtype=torch.int64, device=rec[0][1].device)
    events = []
    for rep in range(reps):
        for inp, stf0, sti0, whole_path in rec:
            stf, sti = stf0.clone(), sti0.clone()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            bk.k2_launch(inp, stf, sti, whole_path,
                         work if rep == 0 else None)
            e1.record()
            events.append((e0, e1))
    torch.cuda.synchronize()
    ms = np.array([e0.elapsed_time(e1) for e0, e1 in events])
    return (ms.mean(), ms.sum() / reps, [int(x) for x in work.cpu()],
            ms.reshape(reps, len(rec)).mean(axis=0))


def _lane_share(work):
    """Share of the warps' lane slots in K2's chunk folds that tested a
    triangle or prim for a thread that needed it (1 - divergence)."""
    return f"{(work[0] + work[2]) / work[4]:.4f}" if work[4] else "none"


def _k2_bound(rec, work):
    """Least ms the card could take for the recorded pass's K2 work: the
    tests K2 did (work counters) and the small table per trace, one
    shading step per ray in flight at each launch; each launch reads its
    state and tables once and writes its state once."""
    tri, box, prim, traces, _slots = work
    inp0 = rec[0][0]
    steps = sum(int((sti[0] == 0).sum()) for _, _, sti, _ in rec)
    ana_ops = (np.mean([PRIM_OPS[g[0]] for g in inp0.ana_groups])
               if inp0.ana_groups else 0.0)
    ops = (TRI_OPS * tri + BOX_OPS * box + ana_ops * prim
           + traces * table_ops(inp0.tab, inp0.groups) + SHADE_OPS * steps)
    tables = (inp0.tab, inp0.gsbb, inp0.msc, inp0.cbb, inp0.sbb, inp0.tpool,
              inp0.acbb, inp0.asbb, inp0.apool, inp0.agr)
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    nbytes = 0
    for inp, stf, sti, _ in rec:
        nbytes += 2 * (stf.numel() * 4 + sti.numel() * 4) + table_bytes
        nbytes += inp.ordr.numel() * 4 + inp.entr.numel() * 4
    ms, by = bound(nbytes, ops)
    return ms, by, ops, nbytes, steps


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

    bk.k2_launch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.advance(2 + window)                   # synchronizes before returning
    window_s = time.perf_counter() - t0
    launches = bk.k2_launch.launches
    if launches != window * r._ntiles * bounces:
        raise AssertionError(f"K2 launched {launches} times in the window, "
                             f"want {window} passes x {r._ntiles} tiles x "
                             f"{bounces} bounces")
    img = r.image()
    if img.shape != (h, w, 3) or not np.isfinite(img).all() \
            or (img < 0).any():
        raise AssertionError("mesh_demo image is not finite and >= 0")
    rays_per_s = w * h * window * bounces / window_s
    print(f"K2 main path: mesh_demo {w}x{h} {bounces} bounces, "
          f"{r._ntiles} tiles of {r._tile} rays, warm-up {warm_s:.3f} s, "
          f"{window}-pass window {window_s:.4f} s, K2 launches {launches}, "
          f"image mean {img.mean():.5f}, {rays_per_s:.6g} rays/s", flush=True)

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

    # K2 alone, by CUDA events over one recorded pass's launches
    rec = _record_pass(r, r.nb_passes)
    ms_launch, ms_pass, work, ms_call = _time_launches(rec)
    bound_ms, bound_by, ops, nbytes, steps = _k2_bound(rec, work)
    print(f"K2 alone: {ms_launch:.4f} ms per launch, {ms_pass:.4f} ms per "
          f"pass ({len(rec)} launches); work per pass: {work[0]} "
          f"ray-triangle tests, {work[1]} ray-box tests, {work[3]} traces, "
          f"{steps} bounce steps; bound {bound_ms:.4f} ms per pass "
          f"({bound_by}: {ops:.4g} FP32 operations, {nbytes} bytes); lane "
          f"share of the chunk folds {_lane_share(work)}", flush=True)
    # by bounce, summed over the tiles (rec holds each tile's launches in
    # bounce order): K2's ms and the rays still in flight
    by_bounce = ms_call.reshape(r._ntiles, bounces).sum(axis=0)
    alive = [sum(int((sti[0] == 0).sum()) for _, _, sti, _ in rec[b::bounces])
             for b in range(bounces)]
    print("K2 by bounce (ms per pass, rays in flight): " + ", ".join(
        f"{b}: {t:.4f} ms {a}" for b, (t, a) in enumerate(zip(by_bounce,
                                                               alive))),
          flush=True)

    # the host's share: the per-bounce re-sort and schedules, each timed
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
    host_pass = r._ntiles * ((bounces - 1) * sort_ms + bounces * sched_ms)
    print(f"K2 main path host: re-sort {sort_ms:.4f} ms and schedules "
          f"{sched_ms:.4f} ms per (tile, bounce), {host_pass:.3f} ms per "
          f"pass of {wall_pass * 1e3:.3f} ms wall", flush=True)

    # K2 through the renderer vs the plain version on the same tiles
    r2 = Renderer(dev, cfg)
    img_k2 = r2.run(2)
    acc = torch.zeros_like(r2._acc)

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
                wall_pass_ms=wall_pass * 1e3)


def phase_k2_whole_path(device, w=800, h=600, bounces=3, window=4,
                        tile_rays=1 << 17):
    """A short window of K2's whole-path mode on stress_10k."""
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
    _, ms_pass, work, _ = _time_launches(_record_pass(r, r.nb_passes))
    print(f"K2 whole path: stress_10k {w}x{h} {bounces} bounces, "
          f"{len(dev.ana_groups)} large groups, {window}-pass window "
          f"{window_s:.4f} s ({window_s / window * 1e3:.3f} ms wall per pass, "
          f"{w * h * window * bounces / window_s:.6g} rays/s); K2 "
          f"{ms_pass:.4f} ms per pass by CUDA events; work per pass: "
          f"{work[2]} ray-prim tests, {work[1]} ray-box tests; lane share of "
          f"the chunk folds {_lane_share(work)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_power = card()
    print(name_power, flush=True)
    t0 = time.perf_counter()
    kernels.build_all(["megakernel", "bounce_kernel"])
    kernels.megakernel_lib()
    kernels.bounce_kernel_lib()
    print(f"K1 and K2 built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(kernels.build_log("megakernel").strip(), flush=True)
    print(kernels.build_log("bounce_kernel").strip(), flush=True)

    worst = phase_parity("cuda")
    res = phase_main_path("cuda")
    print(f"[{name_power}] end to end {res['rays_per_s']:.6g} rays/s "
          f"(800x600 x 64 passes x 3 bounces / {res['window_s']:.4f} s); "
          f"K1 {res['k1_ms']:.4f} ms/pass (bound {res['bound_ms']:.4f} ms, "
          f"{res['bound_by']}); plain version {res['plain_ms']:.3f} ms/pass "
          f"(800x600, 3 bounces)", flush=True)
    print(f"phase-2 parity worst max_abs_err {worst:.3e}", flush=True)

    worst2 = phase_k2_parity("cuda")
    print(f"phase-4 K2 parity worst max_abs_err {worst2:.3e}", flush=True)
    res2 = phase_k2_main("cuda")
    print(f"[{name_power}] mesh_demo end to end {res2['rays_per_s']:.6g} "
          f"rays/s (800x600 x 8 passes x 8 bounces / "
          f"{res2['window_s']:.4f} s); K2 {res2['ms_launch']:.4f} ms/launch, "
          f"{res2['k2_ms']:.4f} ms/pass (bound {res2['bound_ms']:.4f} ms, "
          f"{res2['bound_by']}); plain version {res2['plain_ms']:.1f} ms/pass",
          flush=True)
    phase_k2_whole_path("cuda")

    print(json.dumps({"kernels": [
        {"name": "K1 mega_kernel", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": res["launches"],
         "max_abs_err": res["max_abs_err"], "ms": res["k1_ms"],
         "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
         "bound_by": res["bound_by"], "library_ms": None},
        {"name": "K2 fused_kernel", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": res2["launches"],
         "max_abs_err": res2["max_abs_err"], "ms": res2["k2_ms"],
         "plain_ms": res2["plain_ms"], "bound_ms": res2["bound_ms"],
         "bound_by": res2["bound_by"], "library_ms": None}]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
