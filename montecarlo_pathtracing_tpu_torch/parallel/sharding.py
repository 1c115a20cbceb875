"""Multi-device parallelism in one process: ray sharding and sample-axis
data parallelism over a list of devices.

Port of montecarlo_pathtracing_tpu/parallel/sharding.py. JAX lays a
`Mesh` over its devices and has GSPMD or `shard_map` run one program on
every shard; here a mesh is a list of torch devices and a host loop makes
one integrator call per shard, on that shard's device, against a replica
of the scene there. Calls on distinct cards overlap, each queued on its
own card's current stream. Shards that share a card run one after another
on that card's current stream, never on two streams at once: K1 keeps one
work counter per device (csrc/megakernel.cu `next_ray`).

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

from ..models.registry import get_integrator
from ..scene.device import to_device


def make_mesh(n_devices: int | None = None, device="cuda",
              devices=None) -> list:
    """The devices of a mesh, one per shard.

    `devices`, an explicit list, is taken as given: two shards may then
    share one card. Otherwise `device` names the kind. "cuda" gives
    cuda:0 .. cuda:n-1 (n defaults to every card) and raises when the host
    has fewer cards than asked: it never puts two shards on one card
    unasked. "cpu" gives n virtual shards on the CPU (n defaults to 1),
    the counterpart of the JAX tests' virtual CPU devices."""
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
        if not 1 <= n <= count:
            raise RuntimeError(f"a mesh of {n} CUDA devices was asked for; "
                               f"this host has {count}")
        return [torch.device("cuda", k) for k in range(n)]
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


def _replicator(mesh: list):
    """scene -> its replica on each shard's device: one copy per distinct
    device, kept while the same scene is passed."""
    held = {}

    def replicas(scene):
        if held.get("scene") is not scene:
            held["scene"] = scene
            held["by_device"] = {d: to_device(scene, d)
                                 for d in dict.fromkeys(mesh)}
        return [held["by_device"][d] for d in mesh]

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
    per-ray routes."""
    integrator = get_integrator(integrator_name)
    kw = route_keywords(integrator, route)
    replicas = _replicator(mesh)

    def one_pass(scene, acc, dirs, tc, origin, pass_index, refract_ind):
        if not len(acc) == len(dirs) == len(tc) == len(mesh):
            raise ValueError(f"{len(mesh)} shards, given {len(acc)} "
                             f"accumulators, {len(dirs)} and {len(tc)} rays")
        for dev, s, a, d, t in zip(mesh, replicas(scene), acc, dirs, tc):
            a.add_(integrator(s, origin.to(dev), d, t, pass_index,
                              nb_bounces=nb_bounces, refract_ind=refract_ind,
                              date=date, detach_sampling=detach_sampling,
                              **kw))
        return acc

    return one_pass


def make_sample_sharded_pass(mesh: list, integrator_name: str = "montecarlo",
                             *, nb_bounces: int = 3,
                             detach_sampling: bool = False, date: float = 0.0,
                             route: dict | None = None):
    """Sample-axis DP: shard k renders pass (base + k) of the SAME pixels
    on its device; the partial images are summed onto the first device
    in shard order. One call advances the accumulator by len(mesh)
    passes (`fn.n_passes_per_call`). Returns fn(scene, dirs, tc, origin,
    base_pass, refract_ind) -> the summed rgb."""
    integrator = get_integrator(integrator_name)
    kw = route_keywords(integrator, route)
    replicas = _replicator(mesh)

    def sample_pass(scene, dirs, tc, origin, base_pass, refract_ind):
        total = None
        for k, (dev, s) in enumerate(zip(mesh, replicas(scene))):
            rgb = integrator(s, origin.to(dev), dirs.to(dev), tc.to(dev),
                             base_pass + k, nb_bounces=nb_bounces,
                             refract_ind=refract_ind, date=date,
                             detach_sampling=detach_sampling, **kw)
            rgb = rgb.to(mesh[0])
            total = rgb if total is None else total + rgb
        return total

    sample_pass.n_passes_per_call = len(mesh)
    return sample_pass
