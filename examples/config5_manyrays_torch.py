"""BASELINE config 5 through the PyTorch/CUDA port: the 'manyrays'
converged scene at scale.

Twin of examples/config5_manyrays.py. It renders colonnes (the
reference's 84000-ray showcase) at 1920x1080 with progressive
accumulation to a high spp target, exercising the checkpoint/resume
protocol mid-run as a preempted job would: render the first half, save
the .npz checkpoint, TEAR DOWN the renderer, rebuild it from scratch,
load the checkpoint, and finish. Seeds are pure functions of (uv, pass),
so the resumed half continues the same sample sequence.

With --processes N the same render runs through
parallel.launcher.run_multihost_render in N processes (gloo on
localhost; on one card they share it): each renders its block of passes
up to its first half and stops after checkpointing, then N new
processes resume from their checkpoints and finish, and process 0
gathers the image. Within one process, Renderer(shard_devices=N) splits
the rays instead (tests/test_torch_sharding.py).

On the card the render takes the kernels (use_kernels=True); --cpu
renders on the CPU on the dense route, as the JAX script renders off the
TPU. Writes manyrays.png and manyrays.json (wall clock, spp/s, rays/s,
the resume proof) to --out (default artifacts/examples_torch/).

    python examples/config5_manyrays_torch.py [--spp 1024] [--quick]
        [--cpu] [--processes N]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

# a process that has not finished after this long fails the run
PROCESS_TIMEOUT_S = 3000


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=None, help="1024 (quick 32)")
    ap.add_argument("--width", type=int, default=None,
                    help="1920 (quick 320)")
    ap.add_argument("--height", type=int, default=None,
                    help="1080 (quick 180)")
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="320x180 @ 32 spp smoke mode")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--processes", type=int, default=1,
                    help="render through run_multihost_render in this "
                         "many processes")
    ap.add_argument("--out", default=os.path.join(
        HERE, "..", "artifacts", "examples_torch"))
    # one process of a --processes run (set by the parent)
    ap.add_argument("--process-id", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stop-at-half", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    w, h, spp = (320, 180, 32) if args.quick else (1920, 1080, 1024)
    args.width, args.height = args.width or w, args.height or h
    args.spp = args.spp or spp
    return args


def _make(args):
    """make(): a fresh renderer of the run's configuration."""
    from montecarlo_pathtracing_tpu_torch.render.camera import (
        default_rt_camera)
    from montecarlo_pathtracing_tpu_torch.render.renderer import (
        RenderConfig, Renderer)
    from montecarlo_pathtracing_tpu_torch.scene import scenes
    from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene

    device = "cpu" if args.cpu else "cuda"
    cfg = RenderConfig(width=args.width, height=args.height,
                       nb_bounces=args.bounces, refract_ind=1.0,
                       use_kernels=device == "cuda", tile_rays=1 << 17,
                       passes_per_call=8, device=device)
    scene = scenes.build("colonnes", light_intensity=1.2)
    # the gallery's colonnade pose (examples/render_gallery.py POSES)
    proj, view = default_rt_camera(cfg.render_width, cfg.render_height,
                                   yaw=10.0, pitch=-5.0, zoom=0.6)

    def make():
        return Renderer(compile_scene(scene, device=device), cfg, proj, view)

    return make


def _device_name(args):
    import torch
    return "cpu" if args.cpu else torch.cuda.get_device_name(0)


def _stats(args, img, total, t_half, t_second, resumed_at, ckpt_bytes):
    rays = args.width * args.height * args.spp * args.bounces
    return {
        "scene": "colonnes",
        "width": args.width, "height": args.height, "spp": args.spp,
        "bounces": args.bounces, "device": _device_name(args),
        "processes": args.processes,
        "wall_s": round(total, 1),
        "first_half_s": round(t_half, 1),
        "resumed_half_s": round(t_second, 1),
        "spp_per_s": round(args.spp / total, 2),
        "rays_per_s": round(rays / total, 1),
        "resumed_at_pass": resumed_at,
        "img_mean": round(float(img.mean()), 5),
        "checkpoint_bytes": ckpt_bytes,
    }


def _write(args, img, stats):
    from montecarlo_pathtracing_tpu_torch.utils.image import write_png
    write_png(os.path.join(args.out, "manyrays.png"), img)
    with open(os.path.join(args.out, "manyrays.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))


def one_process(args):
    """The single-process run: half, checkpoint, tear down, resume."""
    ckpt = os.path.join(args.out, "manyrays_state.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    make = _make(args)
    half = args.spp // 2
    t0 = time.perf_counter()
    r = make()
    r.run(half)
    r.save_checkpoint(ckpt)
    half_passes = r.nb_passes
    t_half = time.perf_counter() - t0

    # simulated preemption: lose the process state, resume from disk
    del r
    t1 = time.perf_counter()
    r = make()
    r.load_checkpoint(ckpt)
    if r.nb_passes != half_passes:
        raise RuntimeError("resume lost the pass counter")
    img = r.run(args.spp)
    t_second = time.perf_counter() - t1
    total = time.perf_counter() - t0
    _write(args, img, _stats(args, img, total, t_half, t_second,
                             half_passes, os.path.getsize(ckpt)))


class _Stopped(Exception):
    pass


def rank_process(args):
    """One process of a --processes run: its block of passes through
    run_multihost_render, stopping after the checkpoint at the block's
    half with --stop-at-half; process 0 saves the gathered image."""
    import numpy as np
    from montecarlo_pathtracing_tpu_torch.parallel.launcher import (
        init_distributed, run_multihost_render)

    init_distributed(f"localhost:{args.port}", args.processes,
                     args.process_id)
    r = _make(args)()
    first = args.process_id * args.spp // args.processes
    end = (args.process_id + 1) * args.spp // args.processes
    half = max(1, (end - first) // 2)
    if args.stop_at_half:
        run = r.run

        def stopping_run(target):
            if r.nb_passes - first >= half:
                raise _Stopped
            return run(target)

        r.run = stopping_run
    try:
        img = run_multihost_render(
            r, args.spp, checkpoint=os.path.join(args.out,
                                                 "manyrays_state.npz"),
            checkpoint_every=half)
    except _Stopped:
        return
    if args.process_id == 0:
        np.save(os.path.join(args.out, "manyrays_image.npy"), img)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, argv, stop):
    """Start the run's processes, wait for all, raise if any failed."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, ".."))
    if args.cpu:
        env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv,
         "--process-id", str(k), "--port", str(port)]
        + ["--stop-at-half"] * stop, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(args.processes)]
    failed = []
    try:
        for k, p in enumerate(procs):
            out, _ = p.communicate(timeout=PROCESS_TIMEOUT_S)
            if p.returncode != 0:
                failed.append(f"process {k} exit {p.returncode}:\n"
                              f"{out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError("\n".join(failed))


def multi_process(args, argv):
    """--processes N: every process renders its block's first half and
    stops after checkpointing; N new processes resume and finish."""
    import glob

    import numpy as np
    from montecarlo_pathtracing_tpu_torch.parallel.launcher import (
        process_checkpoint_path)

    ckpt = os.path.join(args.out, "manyrays_state.npz")
    for path in glob.glob(os.path.join(args.out, "manyrays_state.p*.npz")):
        os.remove(path)
    t0 = time.perf_counter()
    _launch(args, argv, stop=True)
    t_half = time.perf_counter() - t0
    paths = [process_checkpoint_path(ckpt, k) for k in range(args.processes)]
    resumed_at = [int(np.load(p)["nb_passes"]) for p in paths]
    t1 = time.perf_counter()
    _launch(args, argv, stop=False)
    t_second = time.perf_counter() - t1
    total = time.perf_counter() - t0
    img = np.load(os.path.join(args.out, "manyrays_image.npy"))
    _write(args, img, _stats(args, img, total, t_half, t_second, resumed_at,
                             sum(os.path.getsize(p) for p in paths)))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.process_id is not None:
        rank_process(args)
    elif args.processes > 1:
        multi_process(args, argv)
    else:
        one_process(args)


if __name__ == "__main__":
    main()
