"""Progressive renderer: accumulation as a running sum on the device.

Port of montecarlo_pathtracing_tpu/render/renderer.py, the replacement
for the reference's FBO additive-blend protocol (MontecarloGPU/
montecarlo.cpp:420-476): each pass renders 1 spp per pixel with a
pass-indexed RNG seed and adds into a float32 accumulator (GL_ONE/GL_ONE
blending analog); the resolve divides by the pass count (average.frag).
The accumulator, pass count and RNG pass index serialize to an .npz so
long renders checkpoint and resume (SURVEY.md §5).

Large images are processed in ray tiles of `tile_rays`. Pixels are laid
out in 32x32 screen blocks so that each 4096-ray tile of the megakernel's
super visit order is screen-compact. With `shard_devices` > 1 each tile's
rays are split over that many devices (parallel/sharding.py), and the
accumulator lives as per-device shards, gathered in shard order to
resolve and to checkpoint.

Unlike the reference there is no fallback chain: a kernel that fails to
build or launch raises.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, asdict

import numpy as np
import torch

from ..models.registry import get_integrator
from ..parallel.sharding import make_mesh, make_sharded_pass
from ..scene.device import DeviceScene, compile_scene
from ..utils.image import write_png
from .camera import default_rt_camera, camera_rays


@dataclass(frozen=True)
class RenderConfig:
    """The reference's knobs (ImGui sliders + defaults,
    montecarlo.cpp:128-130,584-606,801) as a config dataclass. The JAX
    package's `use_pallas` is `use_kernels` here, and defaults to True:
    the kernel routes are the card's renderer, while the dense route
    (use_kernels=False) is the reference semantics, the route for
    gradients, and the trace the stub integrators use; `device` names
    the torch device the render runs on and must match the scene's. It
    is the card unless the caller names the CPU: nothing falls back to
    the CPU when no card is found."""
    width: int = 1280
    height: int = 1000
    nb_bounces: int = 3          # slider 0-9
    paths_per_pass: int = 1      # slider 1-8
    subsampling: int = 0         # power-of-2 resolution divisor, 0-5
    refract_ind: float = 1.0     # slider 1.0-2.5
    light_intensity: float = 1.2
    date: float = 0.0            # deterministic stand-in for wall clock
    integrator: str = "montecarlo"
    flat_face: bool = False
    detach_sampling: bool = False
    use_kernels: bool = True     # hand-written GPU kernels (CPU: plain)
    # None = auto-route (montecarlo.py); False = the pallas-trace route;
    # True = the megakernel, forced, even with use_kernels off
    use_megakernel: bool | None = None
    # the pallas-trace route's kernels: None = auto (the pruned walks K5
    # and K6 where they apply), False = the brute folds K3a and K4a
    cull_chunks: bool | None = None
    pixel_order: str = "block32"  # "block32" tiles the image into 32x32
    # pixel blocks so each ray tile is screen-compact; "scanline" =
    # row-major
    passes_per_call: int = 8     # passes folded into one advance step
    shard_devices: int = 0       # >1: split each ray tile over this many
    # devices of `device`'s kind (parallel/sharding.make_mesh)
    tile_rays: int = 1 << 16
    device: str = "cuda"

    @property
    def render_width(self) -> int:
        return max(1, self.width >> self.subsampling)

    @property
    def render_height(self) -> int:
        return max(1, self.height >> self.subsampling)


# config keys that steer the route or the device, not the radiance: a
# checkpoint resumes across them (with a warning)
_ROUTING_ONLY = {"use_kernels", "use_megakernel", "cull_chunks", "device"}


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _block_perm(w: int, h: int, bs: int = 32) -> np.ndarray:
    """Permutation putting pixels in bs x bs screen blocks (row-major
    blocks, row-major within a block)."""
    idx = np.arange(w * h).reshape(h, w)
    parts = []
    for by in range(0, h, bs):
        for bx in range(0, w, bs):
            parts.append(idx[by:by + bs, bx:bx + bs].ravel())
    return np.concatenate(parts)


class Renderer:
    """Progressive path-tracing renderer over a compiled device scene."""

    def __init__(self, scene: DeviceScene, config: RenderConfig,
                 proj: np.ndarray | None = None,
                 view: np.ndarray | None = None):
        self.device = torch.device(config.device)
        if scene.device.type != self.device.type:
            raise ValueError(f"scene is on {scene.device}, config.device is "
                             f"{config.device}")
        self.scene = scene
        self.config = config
        w, h = config.render_width, config.render_height
        if proj is None or view is None:
            proj, view = default_rt_camera(w, h)
        self.proj, self.view = proj, view
        origin, dirs, tc = camera_rays(proj, view, w, h, device=self.device)
        npix = w * h
        pad = _round_up(npix, min(config.tile_rays, _round_up(npix, 256)))
        self._npix = npix
        self._tile = min(config.tile_rays, pad)
        self._ntiles = pad // self._tile
        if config.pixel_order == "block32":
            perm = _block_perm(w, h)
        else:
            perm = np.arange(npix)
        self._inv_perm = np.argsort(perm)
        perm_t = torch.as_tensor(perm, device=self.device)
        d = torch.cat([dirs.reshape(npix, 3)[perm_t],
                       dirs.new_tensor([0.0, 0.0, 1.0]).expand(pad - npix, 3)])
        t = torch.cat([tc.reshape(npix, 2)[perm_t],
                       tc.new_zeros((pad - npix, 2))])
        self._origin = origin
        self._dirs = d.reshape(self._ntiles, self._tile, 3)
        self._tc = t.reshape(self._ntiles, self._tile, 2)
        self._integrator = get_integrator(config.integrator)
        # pixel/ray DP (shard_devices > 1): the within-tile ray axis is
        # split over the mesh, as the JAX renderer shards it
        # (P(None, "rays", None)); one shard on the renderer's device
        # otherwise
        if config.shard_devices > 1:
            self._mesh = make_mesh(config.shard_devices, config.device)
        else:
            self._mesh = [self.device]
        n = len(self._mesh)
        sizes = [self._tile // n + (k < self._tile % n) for k in range(n)]
        self._cuts = np.cumsum([0] + sizes)
        self._shard_dirs = [self._dirs[:, lo:hi].to(dev).contiguous()
                            for dev, lo, hi in self._shards()]
        self._shard_tc = [self._tc[:, lo:hi].to(dev).contiguous()
                          for dev, lo, hi in self._shards()]
        self._pass = make_sharded_pass(
            self._mesh, config.integrator, nb_bounces=config.nb_bounces,
            detach_sampling=config.detach_sampling, date=config.date,
            route=self.route)
        self.reset()

    def _shards(self):
        """(device, first ray, end) of each shard of a tile."""
        return zip(self._mesh, self._cuts[:-1], self._cuts[1:])

    # -- accumulation protocol --------------------------------------------

    def _passes(self, base_pass: int, n_passes: int):
        """Accumulate passes base_pass .. base_pass + n_passes - 1, each over
        every ray tile and each shard of it, in pass order. The accumulator
        is updated in place (`add_`), so the order of the adds is the
        reference's. The integrator gets only the route keywords its
        signature names, as in the reference renderer
        (render/renderer.py:196-197)."""
        for k in range(n_passes):
            for t in range(self._ntiles):
                self._pass(self.scene, [a[t] for a in self._accs],
                           [d[t] for d in self._shard_dirs],
                           [c[t] for c in self._shard_tc], self._origin,
                           base_pass + k, self.config.refract_ind)

    @property
    def route(self) -> dict:
        """The integrator's routing keywords: the reference renderer's
        level 0 (render/renderer.py:154-171) with its cull_chunks.
        use_megakernel True forces the megakernel, kernels on or off (the
        reference inserts that level whatever use_pallas says). Otherwise,
        kernels on: use_megakernel None is auto (megakernel or fused
        route), False the pallas-trace route; kernels off: the dense route.
        There is no lower level to degrade to: a failure raises."""
        cfg = self.config
        kernels = cfg.use_kernels
        if cfg.use_megakernel:
            kernels, mega, fused = True, True, False
        elif not kernels or cfg.use_megakernel is False:
            mega, fused = False, False
        else:
            mega, fused = None, None
        return dict(use_kernels=kernels, use_megakernel=mega,
                    use_fused=fused, cull_chunks=cfg.cull_chunks)

    def reset(self):
        """Camera move / slider / scene switch analog: clear the FBO and
        pass counter (montecarlo.cpp:238-246)."""
        self._accs = [torch.zeros((self._ntiles, hi - lo, 3),
                                  dtype=torch.float32, device=dev)
                      for dev, lo, hi in self._shards()]
        self.nb_passes = 0

    def render_pass(self):
        """One progressive pass (paths_per_pass sub-passes, each with its
        own pass index — montecarlo.cpp:454-466)."""
        n = self.config.paths_per_pass
        self._passes(self.nb_passes, n)
        self.nb_passes += n

    def advance(self, spp: int) -> None:
        """Render up to spp passes in steps of passes_per_call (at least
        paths_per_pass), WITHOUT resolving an image; waits for the device
        before it returns. A "frame" of k paths is k consecutive pass
        indices, so stepping is accumulation-identical to k single
        passes."""
        ppc = max(max(1, self.config.passes_per_call),
                  max(1, self.config.paths_per_pass))
        while self.nb_passes + ppc <= spp:
            self._passes(self.nb_passes, ppc)
            self.nb_passes += ppc
        while self.nb_passes < spp:
            self.render_pass()
        for dev in dict.fromkeys(self._mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(self, spp: int):
        """advance(spp) + resolve: returns the [H, W, 3] image."""
        self.advance(spp)
        return self.image()

    def resolve(self, acc=None, passes: int | None = None) -> np.ndarray:
        """Resolve an accumulator into an image: undo the pixel-block
        layout permutation, divide by the pass count (average.frag
        analog). `acc` defaults to this renderer's accumulator."""
        w, h = self.config.render_width, self.config.render_height
        if passes is None:
            passes = self.nb_passes
        a = self.accumulator() if acc is None else acc
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a).reshape(-1, 3)[: self._npix]
        a = a[self._inv_perm]              # undo the pixel-block layout
        return (a / max(1, passes)).reshape(h, w, 3)

    def accumulator(self) -> np.ndarray:
        """The accumulator on the host, [tiles, tile rays, 3] in the
        pixel-block layout, its shards gathered in shard order."""
        return np.concatenate([a.detach().cpu().numpy() for a in self._accs],
                              axis=1)

    def image(self) -> np.ndarray:
        """Resolve: accumulated sum / pass count (average.frag analog).
        Returns [H, W, 3] float32, row 0 = bottom."""
        return self.resolve()

    def save_png(self, path: str):
        write_png(path, self.image())

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str):
        np.savez_compressed(
            path,
            acc=self.accumulator(),
            nb_passes=self.nb_passes,
            config=json.dumps(asdict(self.config)),
        )

    def load_checkpoint(self, path: str):
        """Resume from an .npz checkpoint. Configs are compared with
        forward/backward compatibility: keys absent from the saved config
        are filled with the field's DATACLASS default (not the current
        run's value), and unknown saved keys are ignored. Any remaining
        mismatch rejects, because every compared field affects the
        accumulator layout or the accumulated radiance. Route and device
        knobs (use_kernels/use_megakernel/cull_chunks/device) are exempt
        with a warning: the kernel and its plain version agree to float
        rounding, and nearest-first routes may pick a different, equally
        close winner on exact distance ties."""
        with np.load(path, allow_pickle=False) as z:
            saved = json.loads(str(z["config"]))
            acc = z["acc"]
            nb_passes = int(z["nb_passes"])
        current = asdict(self.config)
        defaults = asdict(type(self.config)())
        # a checkpoint that names no device (the JAX package's) says
        # nothing about one: it resumes on this renderer's without a warning
        defaults["device"] = current["device"]
        merged = {k: saved.get(k, defaults[k]) for k in current}
        diff = {k: (merged[k], current[k]) for k in current
                if merged[k] != current[k] and k not in _ROUTING_ONLY}
        if diff:
            raise ValueError(
                f"checkpoint config mismatch (saved, current): {diff}")
        route_diff = {k: (merged[k], current[k]) for k in _ROUTING_ONLY
                      if merged[k] != current[k]}
        if route_diff:
            warnings.warn(
                "resuming under a different engine route or device "
                f"{route_diff}: radiance identical up to float rounding and "
                "exact distance ties", stacklevel=2)
        if acc.shape != (self._ntiles, self._tile, 3):
            raise ValueError(f"checkpoint accumulator {acc.shape}, want "
                             f"{(self._ntiles, self._tile, 3)}")
        self._accs = [torch.as_tensor(np.ascontiguousarray(acc[:, lo:hi]),
                                      device=dev)
                      for dev, lo, hi in self._shards()]
        self.nb_passes = nb_passes


def render_scene(scene_prims, config: RenderConfig, spp: int,
                 proj=None, view=None) -> np.ndarray:
    """Convenience one-shot: compile on config.device (with the config's
    flat_face) + render spp passes + resolve."""
    dev = compile_scene(scene_prims, flat_face=config.flat_face,
                        device=config.device)
    return Renderer(dev, config, proj, view).run(spp)
