"""Multi-device parallelism in one process: ray sharding and sample-axis
data parallelism over a list of devices.

Port of montecarlo_pathtracing_tpu/parallel/sharding.py. JAX lays a
`Mesh` over its devices and has GSPMD or `shard_map` run one program on
every shard; here a mesh is a list of torch devices and a host loop makes
one integrator call per shard, on that shard's device, against a replica
of the scene and the camera origin there. Nothing in a call waits for
its card (no host sync, no copy from another card), so the loop queues
each card's work and goes on to the next card's call while the cards
run. Each card's work still starts only once the host has queued it:
the host's per-call work (K1's launch, K2's schedules, the wavefront's
torch ops) runs shard after shard on the one thread, and on the
host-bound routes a pass over N cards takes about N times the host time
of a pass over one (PERF.md, "Four cards"). Shards that share a card run one
after another on that card's current stream, never on two streams at
once: K1 keeps one work counter per device (csrc/megakernel.cu
`next_ray`).

  1. PIXEL/RAY SHARDING (primary): the flattened ray batch is split into
     contiguous shards, one per device. No communication per pass: the
     accumulator is kept as per-device shards, gathered only to resolve.
  2. SAMPLE-AXIS DP: shard k renders pass (base + k) of the SAME pixels
     and the partial images are summed onto the first device in shard
     order (the counterpart of JAX's psum), the axis that scales samples
     per pixel for the 1024-spp convergence runs (BASELINE.json config 5).

Determinism: the RNG seed is a pure function of (pixel uv, pass index)
(ops/rng.srand_soa), so any split of pixels or samples renders the
unsharded values: bit for bit on the per-ray routes.
"""
from __future__ import annotations

import inspect

import torch

from ..models.megakernel import MegaMemo
from ..models.registry import get_integrator
from ..scene.device import DeviceScene, to_device
from ..utils.profiling import span
from .launcher import first_card


def make_mesh(n_devices: int | None = None, device="cuda",
              devices=None) -> list:
    """The devices of a mesh, one per shard.

    `devices`, an explicit list, is taken as given: two shards may then
    share one card. Otherwise `device` names the kind. "cuda" gives n
    cards (n defaults to every card) and raises when the host has too
    few: it never puts two shards on one card unasked. Alone, a process
    takes cuda:0 .. cuda:n-1; in a process group of several processes
    (parallel/launcher.init_distributed), the process of local rank r
    takes its own cards, cuda:r*n .. cuda:r*n+n-1, the first of which
    init_distributed made its current device. "cpu" gives n virtual
    shards on the CPU (n defaults to 1), the counterpart of the JAX
    tests' virtual CPU devices."""
    if devices is not None:
        mesh = [torch.device(d) for d in devices]
        if not mesh or n_devices not in (None, len(mesh)):
            raise ValueError(f"a mesh of {n_devices} devices, given "
                             f"{len(mesh)}")
        return mesh
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        first = first_card(n)
        if n < 1 or first + n > count:
            where = "" if first == 0 else f" from cuda:{first}"
            raise RuntimeError(f"a mesh of {n} CUDA devices{where} was asked "
                               f"for; this host has {count}")
        return [torch.device("cuda", first + k) for k in range(n)]
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh of {n} CPU shards")
        return [torch.device("cpu")] * n
    raise ValueError(f"no mesh on {device!r}")


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def shard_rays(mesh: list, dirs, tc):
    """Pad the flattened ray batch to a multiple of the shard count
    (direction (0, 0, 1), tc 0, as the JAX package pads) and split it.
    Returns (dir shards, tc shards, padded count), shard k on mesh[k]."""
    n, nd = dirs.shape[0], len(mesh)
    pad = _round_up(n, nd)
    if pad != n:
        dirs = torch.cat([dirs, dirs.new_tensor([0.0, 0.0, 1.0])
                          .expand(pad - n, 3)])
        tc = torch.cat([tc, tc.new_zeros((pad - n, 2))])
    per = pad // nd
    return ([dirs[k * per:(k + 1) * per].to(d) for k, d in enumerate(mesh)],
            [tc[k * per:(k + 1) * per].to(d) for k, d in enumerate(mesh)],
            pad)


def route_keywords(integrator, route: dict | None) -> dict:
    """The route keywords the integrator's signature names (the stubs
    take none of them; ROADMAP C.9)."""
    params = inspect.signature(integrator).parameters
    return {k: v for k, v in dict(route or {}).items() if k in params}


def _route(integrator, route: dict | None) -> dict:
    """`route_keywords` with a new models.megakernel.MegaMemo, for the
    integrators that name `mega_memo`: a pass function's memo, which
    builds K1's inputs (and K2's in whole-path mode) once per tile and
    shard and reuses them on every later pass that hands it the same
    objects."""
    return route_keywords(integrator, {**(route or {}),
                                       "mega_memo": MegaMemo()})


def _replicator(mesh: list):
    """(scene, tensors...) -> for each shard, their replicas on its device:
    one copy per distinct device, kept while the same objects are passed.
    The copies are made before a call queues any work: a copy from
    another card runs on that card's stream, behind its queued work."""
    held = {}

    def put(obj, dev):
        return to_device(obj, dev) if isinstance(obj, DeviceScene) \
            else obj.to(dev)

    def replicas(*objs):
        for k, obj in enumerate(objs):
            if k not in held or held[k][0] is not obj:
                held[k] = (obj, {d: put(obj, d) for d in dict.fromkeys(mesh)})
        return [tuple(held[k][1][d] for k in range(len(objs))) for d in mesh]

    return replicas


def make_sharded_pass(mesh: list, integrator_name: str = "montecarlo", *,
                      nb_bounces: int = 3, detach_sampling: bool = False,
                      date: float = 0.0, route: dict | None = None):
    """Pixel-sharded progressive pass. Returns fn(scene, acc_shards,
    dir_shards, tc_shards, origin, pass_index, refract_ind) -> acc_shards:
    each shard's rgb is added in place into its accumulator shard (JAX
    donates its accumulator), the scene replicated onto each device.

    route: the routing keywords forwarded to the integrator (e.g.
    dict(use_kernels=True, use_megakernel=True)), filtered by its
    signature. Every route, the kernels' included, runs whole on each
    shard: the production layout, and bit-identical to one device on the
    per-ray routes. The megakernel route, and the fused route in
    whole-path mode, keep each tile's and shard's inputs for the pass
    function's life, in `fn.mega_memo` (`_route`; None for integrators
    that take no memo)."""
    integrator = get_integrator(integrator_name)
    kw = _route(integrator, route)
    replicas = _replicator(mesh)

    def one_pass(scene, acc, dirs, tc, origin, pass_index, refract_ind):
        if not len(acc) == len(dirs) == len(tc) == len(mesh):
            raise ValueError(f"{len(mesh)} shards, given {len(acc)} "
                             f"accumulators, {len(dirs)} and {len(tc)} rays")
        for (s, o), a, d, t in zip(replicas(scene, origin), acc, dirs, tc):
            rgb = integrator(s, o, d, t, pass_index, nb_bounces=nb_bounces,
                             refract_ind=refract_ind, date=date,
                             detach_sampling=detach_sampling, **kw)
            with span("accumulate", device=a.device):
                a.add_(rgb)
        return acc

    one_pass.mega_memo = kw.get("mega_memo")
    return one_pass


def make_sample_sharded_pass(mesh: list, integrator_name: str = "montecarlo",
                             *, nb_bounces: int = 3,
                             detach_sampling: bool = False, date: float = 0.0,
                             route: dict | None = None):
    """Sample-axis DP: shard k renders pass (base + k) of the SAME pixels
    on its device; the partial images are summed onto the first device
    in shard order. One call advances the accumulator by len(mesh)
    passes (`fn.n_passes_per_call`). Returns fn(scene, dirs, tc, origin,
    base_pass, refract_ind) -> the summed rgb. The kernel routes keep
    their inputs in `fn.mega_memo`, as make_sharded_pass's does: shards
    that share a device share them."""
    integrator = get_integrator(integrator_name)
    kw = _route(integrator, route)
    replicas = _replicator(mesh)

    def sample_pass(scene, dirs, tc, origin, base_pass, refract_ind):
        # every shard's pass is queued before the first copy to mesh[0],
        # which waits for its card's work
        rgbs = [integrator(s, o, d, t, base_pass + k, nb_bounces=nb_bounces,
                           refract_ind=refract_ind, date=date,
                           detach_sampling=detach_sampling, **kw)
                for k, (s, o, d, t) in enumerate(
                    replicas(scene, origin, dirs, tc))]
        total = rgbs[0]
        for rgb in rgbs[1:]:
            total = total + rgb.to(mesh[0])
        return total

    sample_pass.n_passes_per_call = len(mesh)
    sample_pass.mega_memo = kw.get("mega_memo")
    return sample_pass
