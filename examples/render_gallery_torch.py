"""Converged visual goldens through the PyTorch/CUDA port: render every
demo scene and compare it with the committed gallery.

Twin of examples/render_gallery.py. It renders the same scenes at 800x625
(the capture viewport's 1.28 aspect) with the reference captures'
settings (light 0.4, IOR 1), using the NCC-fitted poses committed in
examples/captures/poses.json, and writes PNGs and gallery.json to --out
(default artifacts/examples_torch/, never examples/captures/, which holds
the JAX package's committed renders). Each render is compared with the
committed PNG of the same scene (utils/image.read_png): the mean absolute
difference and the NCC of their 64x50 luminance grids go into
gallery.json. With --ref-dir, the directory of the reference app's
screenshots (N-04-1.png: the Nth scene of the Q..I carousel), each
carousel scene is also compared with its capture, as the JAX script does;
without it that comparison is skipped.

The card renders with the kernels (use_kernels=True); --cpu renders on
the CPU on the dense route, as the JAX script renders off the TPU.

    python examples/render_gallery_torch.py [--spp 256] [--quick] [--cpu]
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

# scene key order Q..I of the reference carousel (montecarlo.cpp:249-290)
REF_CAPTURE_ORDER = [
    "box_diffuse", "box_balls", "menger", "box_no_top",
    "materials", "4boules", "menger_lights", "colonnes",
]
CAPTURES = os.path.join(HERE, "captures")
VIEWPORT = (1280, 1000)    # the app's window size (montecarlo.cpp:801)
# the ImGui settings panel, excluded from the capture comparison, as
# fractions of the viewport (the captures are full-window screenshots
# with the panel overlaid top-left)
PANEL_FRAC = (0.56, 0.48)
# the colonnade pose when poses.json names none (a column stands in front
# of the default head-on camera)
POSES = {"colonnes": dict(yaw=10.0, pitch=-5.0, zoom=0.6)}


def load_poses(path):
    poses = dict(POSES)
    with open(path) as f:
        fit = json.load(f)
    for name, p in fit.items():
        pose = {k: p[k] for k in ("yaw", "pitch", "zoom", "roll", "fov")
                if k in p}
        if "center" in p:
            pose["center"] = tuple(p["center"])
        poses[name] = pose
    return poses


def ref_viewport(img):
    """Crop the window chrome from a reference screenshot: the GL
    viewport is 1280x1000, 10 px in from the bottom/left window border."""
    h, w = img.shape[:2]
    vw, vh = VIEWPORT
    if h <= vh or w <= vw:
        return img
    x0 = (w - vw) // 2
    y0 = h - 10 - vh
    return img[y0:y0 + vh, x0:x0 + vw]


def panel_mask(gh=50, gw=64):
    m = np.ones((gh, gw), bool)
    m[:int(PANEL_FRAC[1] * gh), :int(PANEL_FRAC[0] * gw)] = False
    return m


def masked_ncc(a, b, m=None):
    if m is not None:
        a, b = a[m], b[m]
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def downsample_luma(img, gw=64, gh=50):
    """Mean luminance on a gw x gh grid (shape-normalizing)."""
    h, w = img.shape[:2]
    lum = img @ np.array([0.299, 0.587, 0.114], np.float32)
    ys = (np.arange(gh + 1) * h) // gh
    xs = (np.arange(gw + 1) * w) // gw
    out = np.empty((gh, gw), np.float32)
    for j in range(gh):
        for i in range(gw):
            out[j, i] = lum[ys[j]:max(ys[j + 1], ys[j] + 1),
                            xs[i]:max(xs[i + 1], xs[i] + 1)].mean()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--light", type=float, default=0.4)
    ap.add_argument("--ior", type=float, default=1.0)
    ap.add_argument("--bounces", type=int, default=9)
    ap.add_argument("--quick", action="store_true",
                    help="200x150 @ 16 spp smoke mode")
    ap.add_argument("--width", type=int, default=None,
                    help="override the mode's width (800; quick 200)")
    ap.add_argument("--height", type=int, default=None,
                    help="override the mode's height (625; quick 150)")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the dense route)")
    ap.add_argument("--ref-dir", default=None,
                    help="the reference app's capture screenshots")
    ap.add_argument("--out", default=os.path.join(
        HERE, "..", "artifacts", "examples_torch"))
    args = ap.parse_args(argv)

    import torch
    from montecarlo_pathtracing_tpu_torch.render.camera import (
        default_rt_camera)
    from montecarlo_pathtracing_tpu_torch.render.renderer import (
        RenderConfig, Renderer)
    from montecarlo_pathtracing_tpu_torch.scene import scenes
    from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
    from montecarlo_pathtracing_tpu_torch.utils import transforms as tf
    from montecarlo_pathtracing_tpu_torch.utils.image import (
        read_png, tonemap)

    device = "cpu" if args.cpu else "cuda"
    w, h, spp = (200, 150, 16) if args.quick else (800, 625, args.spp)
    w, h = args.width or w, args.height or h
    os.makedirs(args.out, exist_ok=True)
    report = {"config": {"width": w, "height": h, "spp": spp,
                         "light": args.light, "ior": args.ior,
                         "bounces": args.bounces,
                         "device": (torch.cuda.get_device_name(0)
                                    if device == "cuda" else "cpu"),
                         "use_kernels": device == "cuda"},
              "scenes": {}}

    names = args.scenes or list(scenes.SCENES)
    poses = load_poses(os.path.join(CAPTURES, "poses.json"))
    for name in names:
        t0 = time.perf_counter()
        dev = compile_scene(scenes.build(name, light_intensity=args.light),
                            device=device)
        pose = dict(poses.get(name, {}))
        roll = pose.pop("roll", 0.0)
        fov = pose.pop("fov", 1.0)
        proj, view = default_rt_camera(w, h, **pose)
        if fov != 1.0:
            # focal-length scale (<1 widens), which orbit zoom cannot express
            proj = proj.copy()
            proj[0, 0] *= fov
            proj[1, 1] *= fov
        if roll:
            # screen-plane rotation (trackball edge-drag Z-rotate)
            view = tf.rotate_z(roll).astype(np.float32) @ view
        r = Renderer(dev, RenderConfig(
            width=w, height=h, nb_bounces=args.bounces,
            refract_ind=args.ior, use_kernels=device == "cuda",
            tile_rays=1 << 17, device=device), proj, view)
        img = r.run(spp)
        png = os.path.join(args.out, f"{name}.png")
        r.save_png(png)
        entry = {
            "png": os.path.basename(png),
            "pose": poses.get(name, {}),
            "seconds": round(time.perf_counter() - t0, 1),
            "mean": round(float(img.mean()), 5),
            "p99": round(float(np.quantile(img, 0.99)), 4),
            "nonzero_frac": round(float((img.sum(-1) > 0).mean()), 4),
        }
        # as the PNG reads back: tone-mapped, row 0 = top
        ours = tonemap(img)[::-1] / np.float32(255.0)
        ga = downsample_luma(ours)
        committed = os.path.join(CAPTURES, f"{name}.png")
        if os.path.exists(committed):
            gc = downsample_luma(read_png(committed))
            entry["committed_png"] = os.path.basename(committed)
            entry["committed_mad"] = round(float(np.abs(ga - gc).mean()), 5)
            entry["committed_luma_ncc"] = round(masked_ncc(ga, gc), 3)
        if args.ref_dir and name in REF_CAPTURE_ORDER:
            refp = os.path.join(
                args.ref_dir, f"{REF_CAPTURE_ORDER.index(name) + 1}-04-1.png")
            if os.path.exists(refp):
                gb = downsample_luma(ref_viewport(read_png(refp)))
                m = panel_mask()                     # exclude the ImGui UI
                entry["ref_capture"] = os.path.basename(refp)
                entry["ref_luma_mean"] = round(float(gb[m].mean()), 4)
                entry["our_luma_mean"] = round(float(ga[m].mean()), 4)
                entry["luma_ncc"] = round(masked_ncc(ga, gb, m), 3)
        report["scenes"][name] = entry
        print(name, entry, flush=True)

    # merge partial runs (--scenes ...) into an existing gallery.json
    gpath = os.path.join(args.out, "gallery.json")
    if args.scenes and os.path.exists(gpath):
        with open(gpath) as f:
            old = json.load(f)
        old["scenes"].update(report["scenes"])
        old["config"] = report["config"]
        report = old
    with open(gpath, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", gpath)


if __name__ == "__main__":
    main()
