"""Inverse-rendering demo (BASELINE config 4) through the PyTorch/CUDA port.

Twin of examples/inverse_rendering.py. It renders a target image of the
box_balls scene (all four material cases live there), perturbs one
cube's albedo and roughness AND the global refraction index, then
recovers all three: albedo by Adam descent on the pixel MSE with the
exact detached-sampling gradients (render/diff.inverse_render_fit),
roughness and IOR by deterministic coordinate scans on forward renders —
the loss is deterministic (fixed per-pass RNG seeds), and AD is knowably
wrong for those two scalars (the detached estimator drops the
roughness-through-sampling pathway; the clamped-Schlick quirk zeroes the
fast route's IOR pathway). Two interleaved stages resolve the coupling.

On the card the renders take the fast route (use_kernels=True: the
pallas-trace route with its trace detached, the trace kernels K5/K6);
--cpu renders on the CPU on the dense route, as the JAX script renders
off the TPU. Writes target / initial / recovered PNGs and
inverse_rendering.json to --outdir (default artifacts/examples_torch/).

  python examples/inverse_rendering_torch.py            # 800x600 on the card
  python examples/inverse_rendering_torch.py --cpu --quick
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


def _set(t, index, value):
    """A copy of tensor t with t[index] = value (the leaves stay as they
    are)."""
    t = t.clone()
    t[index] = value
    return t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=None, help="120 (quick 30)")
    ap.add_argument("--width", type=int, default=None, help="800 (quick 64)")
    ap.add_argument("--height", type=int, default=None,
                    help="600 (quick 48)")
    ap.add_argument("--quick", action="store_true",
                    help="64x48, 30 steps")
    ap.add_argument("--no-scans", action="store_true",
                    help="recover the albedo by AD alone, without the "
                         "roughness, IOR and albedo scans (each scan is "
                         "about 20 renders)")
    ap.add_argument("--outdir", default=os.path.join(
        HERE, "..", "artifacts", "examples_torch"))
    args = ap.parse_args(argv)

    import torch
    from montecarlo_pathtracing_tpu_torch.render.camera import (
        camera_rays, default_rt_camera)
    from montecarlo_pathtracing_tpu_torch.render.diff import (
        inverse_render_fit, params_of, render_mean)
    from montecarlo_pathtracing_tpu_torch.scene import scenes
    from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
    from montecarlo_pathtracing_tpu_torch.utils.image import write_png

    w, h, steps = (64, 48, 30) if args.quick else (800, 600, 120)
    w, h = args.width or w, args.height or h
    steps = steps if args.steps is None else args.steps
    os.makedirs(args.outdir, exist_ok=True)
    device = "cpu" if args.cpu else "cuda"
    fast = device == "cuda"

    dev = compile_scene(scenes.build("box_balls"), device=device)
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h, device=device)
    dirs, tc = dirs.reshape(-1, 3), tc.reshape(-1, 2)

    # a pure-diffuse cube of box_balls (alpha == 1, shininess == 0): a
    # pure-diffuse row keeps the fit inside one material case — see
    # inverse_render_fit's doc. (The spheres all carry shininess.)
    cubes = [int(i) for i in dev.group_prim[dev.group_codes.index(2)]
             if i >= 0]
    mat = dev.mat.cpu().numpy()
    col = dev.color.cpu().numpy()
    target_prim = next(i for i in cubes
                       if col[i, 3] == 1.0 and mat[i, 0] == 0.0)

    def render(p):
        with torch.no_grad():
            return render_mean(dev, p, origin, dirs, tc, 4, 6, "montecarlo",
                               use_kernels=fast)

    def save(name, img):
        write_png(os.path.join(args.outdir, name),
                  img.cpu().numpy().reshape(h, w, 3))

    ior_true = 1.35
    p_true = params_of(dev, refract_ind=ior_true)
    t0 = time.perf_counter()
    target = render(p_true)
    save("inv_target.png", target)

    f32 = dict(dtype=torch.float32, device=dev.device)
    p0 = p_true._replace(
        color=_set(p_true.color, (target_prim, slice(0, 3)),
                   torch.tensor([0.05, 0.55, 0.3], **f32)),
        mat=_set(p_true.mat, (target_prim, 1), 0.9),
        refract_ind=torch.tensor(1.05, **f32),
    )
    save("inv_initial.png", render(p0))

    # Staged recovery (see the JAX script): the two scalars AD gets wrong
    # are recovered by exact coordinate scans with parabolic refinement on
    # forward renders, interleaved with albedo-only AD stages whose
    # gradients ARE exact.
    losses = []

    def loss_of(p):
        return float(torch.mean((render(p) - target) ** 2))

    def scan_scalar(p, put, lo, hi, coarse=13, refine=3):
        """Deterministic 1-D recovery: coarse grid + golden refinement."""
        xs = np.linspace(lo, hi, coarse)
        ls = [loss_of(put(p, x)) for x in xs]
        i = int(np.argmin(ls))
        a = xs[max(i - 1, 0)]
        b = xs[min(i + 1, coarse - 1)]
        for _ in range(refine):
            m1 = a + (b - a) / 3
            m2 = b - (b - a) / 3
            if loss_of(put(p, m1)) < loss_of(put(p, m2)):
                b = m2
            else:
                a = m1
        x = 0.5 * (a + b)
        p = put(p, x)
        losses.append(loss_of(p))
        return p

    def put_rough(p, x):
        return p._replace(mat=_set(p.mat, (target_prim, 1), float(x)))

    def put_ior(p, x):
        return p._replace(refract_ind=torch.tensor(float(x), **f32))

    def put_albedo(ch):
        def put(p, x):
            return p._replace(color=_set(p.color, (target_prim, ch),
                                         float(x)))
        return put

    p_fit = p0
    ad_steps = max(10, steps // 3)
    for stage in range(2):
        # albedo via AD (exact detached-sampling gradients)
        p_fit, la = inverse_render_fit(
            dev, target, origin, dirs, tc, prim_ids=[target_prim],
            steps=ad_steps, lr=5e-2, n_passes=4, nb_bounces=6,
            fit_albedo=True, seed_params=p_fit, verbose=True,
            use_kernels=fast)
        losses.extend(la)
        if args.no_scans:
            continue
        # the two scalars via deterministic scans
        p_fit = scan_scalar(p_fit, put_rough, 0.0, 1.0)
        p_fit = scan_scalar(p_fit, put_ior, 1.0, 2.5)
        # Adam plateaus within ~0.1 of the albedo optimum; the loss is
        # deterministic, so polish each channel with the same exact scan
        for ch in range(3):
            lo = float(p_fit.color[target_prim, ch]) - 0.25
            p_fit = scan_scalar(p_fit, put_albedo(ch),
                                max(0.0, lo), min(1.0, lo + 0.5),
                                coarse=11, refine=5)
        print(f"stage {stage}: loss {losses[-1]:.6f} albedo "
              f"{[round(float(c), 3) for c in p_fit.color[target_prim, :3]]}"
              f" rough {float(p_fit.mat[target_prim, 1]):.3f} "
              f"ior {float(p_fit.refract_ind):.3f}")

    # two scan-only rounds walk the coordinate descent down the coupled
    # valley floor (albedo <-> rough/ior); each scan is exact, so the
    # loss curve stays monotone
    for _ in range(0 if args.no_scans else 2):
        p_fit = scan_scalar(p_fit, put_rough, 0.0, 0.4, coarse=11, refine=5)
        p_fit = scan_scalar(p_fit, put_ior, 1.1, 1.7, coarse=13, refine=5)
        for ch in range(3):
            lo = float(p_fit.color[target_prim, ch]) - 0.15
            p_fit = scan_scalar(p_fit, put_albedo(ch),
                                max(0.0, lo), min(1.0, lo + 0.3),
                                coarse=11, refine=5)

    save("inv_recovered.png", render(p_fit))
    wall = time.perf_counter() - t0

    out = {
        "scene": "box_balls", "width": w, "height": h, "steps": steps,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
        "fast_path": fast,
        "wall_s": round(wall, 1),
        "loss_curve": [round(x, 6) for x in losses],
        "true": {
            "albedo": p_true.color[target_prim, :3].tolist(),
            "roughness": float(p_true.mat[target_prim, 1]),
            "ior": ior_true,
        },
        "initial": {
            "albedo": [0.05, 0.55, 0.3], "roughness": 0.9, "ior": 1.05,
        },
        "recovered": {
            "albedo": p_fit.color[target_prim, :3].tolist(),
            "roughness": float(p_fit.mat[target_prim, 1]),
            "ior": float(p_fit.refract_ind),
        },
    }
    with open(os.path.join(args.outdir, "inverse_rendering.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}  ({wall:.0f}s)")
    print("true     ", out["true"])
    print("recovered", out["recovered"])


if __name__ == "__main__":
    main()
