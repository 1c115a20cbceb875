"""One process of a multi-process render through
parallel.launcher.run_multihost_render, with an optional simulated crash
for the resume check. tests/test_torch_launcher.py and chip_smoke.py
start it, one process per rank:

    python -m montecarlo_pathtracing_tpu_torch.testing.launcher_worker \\
        --process-id K --num-processes P --port PORT --spp S --out IMG.npy \\
        [--crash-at N] [--checkpoint CK] [--checkpoint-every E] [--cpu] \\
        [--scene box_diffuse --width 64 --height 48 --bounces 6 \\
         --tile-rays 1024 --passes-per-call 1]

Process 0 saves the resolved [H, W, 3] image to --out. The last line
each process prints is a JSON object with its rank, passes, and the
host clock (time.time()) when it entered main, had joined the process
group, had its scene compiled on its device (the card's context made),
and finished.
"""
import argparse
import json
import os
import time


def main(argv=None):
    t_enter = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="os._exit(3) once this many passes are rendered "
                    "by THIS process (after its last checkpoint)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true")
    # width > 32 by default, so the block32 pixel permutation is not the
    # identity: a launcher that forgot to invert it would scramble the image
    ap.add_argument("--scene", default="box_diffuse")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--tile-rays", type=int, default=1 << 10)
    ap.add_argument("--passes-per-call", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np

    from ..parallel.launcher import (init_distributed, rank_and_size,
                                     run_multihost_render)
    from ..render.renderer import RenderConfig, Renderer
    from ..scene import scenes
    from ..scene.device import compile_scene

    init_distributed(f"localhost:{args.port}", args.num_processes,
                     args.process_id)
    t_joined = time.time()
    device = "cpu" if args.cpu else "cuda"
    dev = compile_scene(scenes.build(args.scene), device=device)
    t_ready = time.time()
    cfg = RenderConfig(width=args.width, height=args.height,
                       nb_bounces=args.bounces,
                       passes_per_call=args.passes_per_call,
                       tile_rays=args.tile_rays, device=device)
    r = Renderer(dev, cfg)

    if args.crash_at is not None:
        run = r.run
        first = args.process_id * args.spp // args.num_processes

        def crashing_run(target):
            if r.nb_passes - first >= args.crash_at:
                os._exit(3)                 # a simulated host failure
            return run(target)

        r.run = crashing_run

    img = run_multihost_render(r, args.spp, checkpoint=args.checkpoint,
                               checkpoint_every=args.checkpoint_every)
    if rank_and_size()[0] == 0:
        np.save(args.out, img)
    print(json.dumps({"rank": args.process_id, "passes": r.nb_passes,
                      "t_enter": t_enter, "t_joined": t_joined,
                      "t_ready": t_ready,
                      "t_done": time.time()}), flush=True)


if __name__ == "__main__":
    main()
