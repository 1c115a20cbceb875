"""GPU smoke of the PyTorch/CUDA port: build every kernel, hold each one
against its plain PyTorch version, and drive the main path once.

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a) and nvcc; fails with a non-zero exit code,
and prints no result, without them. Phases:

1. the card's name and power limit; build K1 (csrc/megakernel.cu);
2. K1 against its plain version (models/megakernel.mega_pass_reference)
   on the card, 64x48 pixels, 4 bounces, passes 0 and 3, under the
   megakernel protocol (testing/parity.py), on box_diffuse (cull off,
   opaque), box_balls (transparent), materials (cull on) and a scene with
   all five shapes, transparency and the cull; and nb_bounces=0 -> black;
3. the main path at full size: box_diffuse at 800x600, 3 bounces,
   64 passes per call, tile_rays 1<<17, through compile_scene and
   Renderer.advance; the launch count of K1 over one 64-pass window; the
   image finite and non-negative; the device's busy time per pass under
   torch.profiler and its idle share; a 4-pass accumulation of K1 against the
   plain version's; rays/s (pixels x passes x bounces / seconds) and K1's
   and the plain version's time per pass.

The last two lines are a {"kernels": [...]} JSON object and the
{"ok": true, "device": {...}} JSON object.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.ops.rng import seed_y
from montecarlo_pathtracing_tpu_torch.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    all_shapes_scene, assert_megakernel_protocol, megakernel_match)
from montecarlo_pathtracing_tpu_torch.utils import transforms

K1_SOURCE = "montecarlo_pathtracing_tpu_torch/csrc/megakernel.cu"
K1_REPLACES = "montecarlo_pathtracing_tpu/models/megakernel.py:541"

PARITY_CASES = (("box_diffuse", 1.0), ("box_balls", 1.3), ("materials", 1.5),
                ("all_shapes", 1.3))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_scene(name: str, device):
    if name == "all_shapes":
        prims = all_shapes_scene(scene_mod, transforms)
    else:
        prims = scenes.build(name)
    return compile_scene(prims, device=device)


def phase_parity(device, w=64, h=48, bounces=4):
    """K1 vs its plain version on the same inputs, per scene and pass."""
    proj, view = default_rt_camera(w, h)
    o, d, tc = camera_rays(proj, view, w, h, device=device)
    worst = 0.0
    for name, ior in PARITY_CASES:
        dev = build_scene(name, device)
        inp = mk.mega_inputs(dev, o, d.reshape(-1, 3), tc.reshape(-1, 2), ior)
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


def _device_seconds(fn):
    """(device-busy s, K1's share of it in s) of fn() under torch.profiler:
    the sum of the CUDA kernel and copy events, which run on one stream and
    so do not overlap. (0, 0) when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    k1 = sum(e.self_device_time_total for e in dev
             if "mega_kernel" in e.key) / 1e6
    return busy, k1


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
    busy, k1_dev = _device_seconds(lambda: r.advance(r.nb_passes + 16))
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

    def plain_pass(k):
        for t, inp in enumerate(inps):
            acc[t].add_(mk.mega_pass_reference(inp, seed_y(k), bounces))

    plain_ms = _time_passes(plain_pass, 4)
    img_ref = r4.resolve(acc, 4)
    frac, dmean, err = megakernel_match(img_ref, img_k1)
    print(f"main path 4-pass K1 vs plain: close={frac:.4f} "
          f"mean_diff={dmean:.2e} max_abs_err={err:.3e}", flush=True)
    assert_megakernel_protocol(img_ref, img_k1, "main path 4 passes")

    k1_ms = _time_passes(
        lambda k: [mk.k1_launch(inp, seed_y(k), bounces) for inp in inps], 20)
    return dict(rays_per_s=rays_per_s, window_s=window_s, launches=launches,
                k1_ms=k1_ms, plain_ms=plain_ms, max_abs_err=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_power = card()
    print(name_power, flush=True)
    t0 = time.perf_counter()
    kernels.megakernel_lib()
    print(f"K1 built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(kernels.build_log("megakernel").strip(), flush=True)

    worst = phase_parity("cuda")
    res = phase_main_path("cuda")
    print(f"[{name_power}] end to end {res['rays_per_s']:.6g} rays/s "
          f"(800x600 x 64 passes x 3 bounces / {res['window_s']:.4f} s); "
          f"K1 {res['k1_ms']:.4f} ms/pass; plain version "
          f"{res['plain_ms']:.3f} ms/pass (800x600, 3 bounces)", flush=True)
    print(f"phase-2 parity worst max_abs_err {worst:.3e}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "K1 mega_kernel", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": res["launches"],
        "max_abs_err": res["max_abs_err"], "ms": res["k1_ms"],
        "plain_ms": res["plain_ms"]}]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
