"""Command-line renderer — the headless replacement for the GL viewer.

Port of montecarlo_pathtracing_tpu/cli.py. The reference has zero CLI
(all configuration is ImGui sliders + keyboard scene/shader switching,
MontecarloGPU/montecarlo.cpp:249-335,584-606). The port exposes the same
knobs as flags, on the GPU unless --cpu is given:

  python -m montecarlo_pathtracing_tpu_torch render --scene box_diffuse \\
      --spp 256 --bounces 6 --width 800 --height 600 --out out.png

Subcommands:
  render   progressive render of a demo scene to PNG (+ checkpointing)
  scenes   list the built-in scenes (the Q..I keyboard registry)
  sampling hemisphere-sampling visualizer (DrawSampling)
  bench    same measurement as bench.py with custom knobs
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_render_args(p):
    p.add_argument("--scene", default="box_diffuse",
                   help="scene name (see `scenes` subcommand)")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=64,
                   help="progressive passes (1 path/pixel each)")
    p.add_argument("--bounces", type=int, default=6,
                   help="path bounce cap 0-9 (reference slider range)")
    p.add_argument("--subsampling", type=int, default=0,
                   help="power-of-2 resolution divisor 0-5")
    p.add_argument("--ior", type=float, default=1.0,
                   help="refraction index slider 1.0-2.5")
    p.add_argument("--light", type=float, default=1.2,
                   help="light intensity baked into emissive materials")
    p.add_argument("--integrator", default="montecarlo",
                   choices=["montecarlo", "montecarlo_mat",
                            "montecarlo_mat_tr", "montecarlo_aos"])
    p.add_argument("--flat-face", action="store_true",
                   help="flat mesh normals instead of smooth")
    p.add_argument("--yaw", type=float, default=0.0,
                   help="orbit yaw in degrees (trackball analog)")
    p.add_argument("--pitch", type=float, default=0.0,
                   help="orbit pitch in degrees")
    p.add_argument("--zoom", type=float, default=1.0,
                   help="camera distance scale (<1 closer, >1 farther)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--pallas", action="store_true",
                   help="force the hand-written CUDA kernels (default: "
                        "auto — on when running on the GPU; their plain "
                        "versions on the CPU)")
    g.add_argument("--no-pallas", action="store_true",
                   help="force the dense route (torch ops) even on the GPU")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the GPU")
    p.add_argument("--devices", type=int, default=0,
                   help="split each ray tile over this many devices "
                        "(0 = one; cards, or virtual shards with --cpu; "
                        "with --distributed, each process's own cards)")


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="montecarlo_pathtracing_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(rp)
    rp.add_argument("--out", default="render.png")
    rp.add_argument("--checkpoint", default=None,
                    help=".npz accumulation state; resumes if it exists, "
                         "saved on completion")
    rp.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the checkpoint every N passes")
    rp.add_argument("--distributed", action="store_true",
                    help="sample-DP render across processes "
                         "(torch.distributed, gloo); process 0 writes --out")
    rp.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (with --distributed)")
    rp.add_argument("--num-processes", type=int, default=None)
    rp.add_argument("--process-id", type=int, default=None)

    sub.add_parser("scenes", help="list built-in scenes")

    sp = sub.add_parser("sampling",
                        help="hemisphere-sampling visualizer (DrawSampling)")
    sp.add_argument("--sampler", default="hsphere",
                    choices=["hsphere", "hsphere_wrong", "hsphere_wrong2"])
    sp.add_argument("--samples", type=int, default=4000)
    sp.add_argument("--roughness", type=float, default=1.0)
    sp.add_argument("--normal", type=float, nargs=3, default=[0.0, 0.0, 1.0])
    sp.add_argument("--out", default="sampling.png")
    sp.add_argument("--cpu", action="store_true")

    bp = sub.add_parser("bench", help="throughput measurement")
    _add_render_args(bp)
    bp.add_argument("--warmup", type=int, default=2)

    args = ap.parse_args(argv)

    if args.cmd == "scenes":
        from .scene.scenes import SCENES
        for name in SCENES:
            print(name)
        return 0

    device = "cpu" if args.cpu else "cuda"

    if args.cmd == "sampling":
        from .models.draw_sampling import save_sampling_png
        save_sampling_png(args.out, n_samples=args.samples,
                          normal=tuple(args.normal),
                          roughness=args.roughness, sampler=args.sampler,
                          device=device)
        print(args.out)
        return 0

    if getattr(args, "distributed", False):
        # before anything touches the card: the process takes its card here
        from .parallel.launcher import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id,
                         devices_per_process=max(1, args.devices))

    from .scene import scenes
    from .scene.device import compile_scene
    from .render.renderer import RenderConfig, Renderer

    # auto-route: the kernels on the card, the dense route elsewhere (the
    # JAX package's "Pallas on TPU"); --pallas on the CPU runs the
    # kernels' plain versions
    use_kernels = args.pallas or (device == "cuda" and not args.no_pallas)
    cfg = RenderConfig(
        width=args.width, height=args.height, nb_bounces=args.bounces,
        subsampling=args.subsampling, refract_ind=args.ior,
        light_intensity=args.light, integrator=args.integrator,
        flat_face=args.flat_face, use_kernels=use_kernels,
        shard_devices=args.devices, device=device,
    )
    t0 = time.time()
    dev = compile_scene(scenes.build(args.scene, args.light),
                        flat_face=args.flat_face, device=device)
    from .render.camera import default_rt_camera
    proj, view = default_rt_camera(
        cfg.render_width, cfg.render_height,
        yaw=args.yaw, pitch=args.pitch, zoom=args.zoom)
    r = Renderer(dev, cfg, proj, view)
    print(f"scene {args.scene}: {dev.nb_prims} prims "
          f"({dev.nb_emissives} emissive), compiled in {time.time()-t0:.2f}s",
          file=sys.stderr)

    if args.cmd == "bench":
        # warm up the same batched call the timed run uses; the clock
        # stops once the card has finished
        r.advance(max(args.warmup, min(args.spp, cfg.passes_per_call)))
        _sync(device)
        base = r.nb_passes
        t0 = time.time()
        r.advance(base + args.spp)
        _sync(device)
        dt = time.time() - t0
        rays = cfg.render_width * cfg.render_height * args.spp * args.bounces
        # Denominator: the measured CPU baseline for THIS scene if the
        # per-scene file has it, else the single-scene box_diffuse
        # measurement. The JSON names the denominator and its source: the
        # files under benchmarks/ are the JAX package's CPU measurements
        # (baseline_cpu.json on a 2-vCPU host), read as they are.
        bdir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "benchmarks")
        with open(os.path.join(bdir, "baseline_per_scene.json")) as f:
            per_scene = json.load(f)["scenes"]
        if args.scene in per_scene:
            base_rays_s = float(per_scene[args.scene]["rays_per_s"])
            base_src = "benchmarks/baseline_per_scene.json"
        else:
            with open(os.path.join(bdir, "baseline_cpu.json")) as f:
                base_rays_s = float(json.load(f)["rays_per_s"])
            base_src = "benchmarks/baseline_cpu.json (box_diffuse only)"
        target = 10.0 * base_rays_s     # BASELINE.md: >=10x CPU rays/s
        print(json.dumps({
            "metric": f"rays_per_s_{args.scene}",
            "value": round(rays / dt, 1),
            "unit": "rays/s",
            "vs_baseline": round(rays / dt / target, 3),
            "baseline_rays_per_s": base_rays_s,
            "baseline_source": base_src,
        }))
        return 0

    # render
    if args.distributed:
        from .parallel.launcher import rank_and_size, run_multihost_render
        from .utils.image import write_png
        img = run_multihost_render(
            r, args.spp, checkpoint=args.checkpoint,
            checkpoint_every=args.checkpoint_every or 64)
        if rank_and_size()[0] == 0:
            write_png(args.out, img)
            print(args.out)
        return 0

    if args.checkpoint and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint)
        print(f"resumed at pass {r.nb_passes}", file=sys.stderr)
    t0 = time.time()
    while r.nb_passes < args.spp:
        if args.checkpoint and args.checkpoint_every:
            target = min(args.spp, r.nb_passes + args.checkpoint_every)
        else:
            target = args.spp
        r.advance(target)      # batched multi-pass dispatch
        if args.checkpoint and args.checkpoint_every:
            r.save_checkpoint(args.checkpoint)
    _sync(device)
    print(f"{r.nb_passes} passes in {time.time()-t0:.2f}s", file=sys.stderr)
    r.save_png(args.out)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    print(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
