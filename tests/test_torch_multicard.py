"""The port's multi-card layer on the CPU (parallel/, kernels.py).

The card itself runs in chip_smoke.py phase 17; here:

  - make_mesh under a stand-in process group (LOCAL_RANK, world size and
    card count monkeypatched) gives each process cards of its own, and
    raises when the host has too few; init_distributed makes the mesh's
    first card the process's current device;
  - one 4-shard CPU pass of the K1, K2, dense and pallas-trace routes
    makes no host sync: per shard call, no op that reads a device value
    on the host (aten._local_scalar_dense, aten.nonzero, boolean-mask
    indexing, masked_select) and no host data copied to the shard's
    device through torch.tensor / torch.as_tensor / Tensor.new_tensor
    (on a card a synchronous cudaMemcpy that waits for the card's queued
    work), the kernels' plain versions left out (on the card they are the
    kernels). A route that adds one fails here; the K1 and K2 routes
    make none with spans on either;
  - each kernel wrapper counts its launches by card; kernels.host_tensor;
  - the sharded pass copies the scene and the camera origin to each
    device once, not on every call.
"""
import collections
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.models import registry
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as ptk
from montecarlo_pathtracing_tpu_torch.ops import sparse_trace as spk
from montecarlo_pathtracing_tpu_torch.parallel import launcher, sharding
from montecarlo_pathtracing_tpu_torch.parallel.sharding import (
    make_mesh, make_sample_sharded_pass, make_sharded_pass, shard_rays)
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _host(monkeypatch, cards, rank=None, world=2, local=None):
    """A stand-in host of `cards` cards; with `rank`, this process is rank
    `rank` of a group of `world` (LOCAL_RANK `local` when given)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dist, "is_initialized", lambda: rank is not None)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    if local is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", str(local))


def _cards(*idx):
    return [torch.device("cuda", k) for k in idx]


@pytest.mark.parametrize("rank, local, n, want", [
    (None, None, 2, (0, 1)),        # no process group: cuda:0 ..
    (0, 0, 2, (0, 1)),
    (1, 1, 2, (2, 3)),              # 2 processes x 2 cards on 4
    (3, None, 1, (3,)),             # LOCAL_RANK unset: the rank
    (5, 1, 2, (2, 3)),              # LOCAL_RANK, not the rank
    (2, 2, 1, (2,)),
])
def test_make_mesh_takes_the_process_own_cards(monkeypatch, rank, local, n,
                                               want):
    _host(monkeypatch, 4, rank=rank, world=4, local=local)
    assert make_mesh(n, "cuda") == _cards(*want)


def test_make_mesh_raises_when_the_host_has_too_few(monkeypatch):
    _host(monkeypatch, 4, rank=1, world=2, local=1)
    with pytest.raises(RuntimeError, match="3 CUDA devices from cuda:3.*"
                                           "this host has 4"):
        make_mesh(3, "cuda")
    _host(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="this host has 2"):
        make_mesh(3, "cuda")
    # one card each: processes share the cards of a host that has fewer
    _host(monkeypatch, 1, rank=1, world=2, local=1)
    assert launcher.first_card(1) == 0
    # an explicit list is taken as given, group or not
    assert make_mesh(devices=["cuda:0"] * 2) == _cards(0, 0)


@pytest.mark.parametrize("pid, per_process, card", [
    (1, 2, 2), (0, 2, 0), (3, 1, 3), (5, 1, 1), (1, 3, None)])
def test_init_distributed_pins_the_mesh_first_card(monkeypatch, pid,
                                                   per_process, card):
    _host(monkeypatch, 4)
    pinned, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda k: "stand-in")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: joined.append(k["rank"]))
    args = ("localhost:1", 8, pid)
    if card is None:
        with pytest.raises(RuntimeError, match="this host has 4"):
            launcher.init_distributed(*args, devices_per_process=per_process)
        assert pinned == joined == []
        return
    assert launcher.init_distributed(
        *args, devices_per_process=per_process) == pid
    assert pinned == [card] and joined == [pid]


# ---------------------------------------------------------------------------
# host syncs of a sharded pass
# ---------------------------------------------------------------------------

_READS = {"_local_scalar_dense", "nonzero", "masked_select", "item"}


class SyncRecorder(TorchDispatchMode):
    """Counts, per shard call of the sharded pass, the ops that would make
    the host wait for the card: `_READS`, and indexing with a boolean
    mask. Paused inside the kernels' plain versions."""

    def __init__(self, shards):
        super().__init__()
        self.by_shard = [0] * shards
        self.shard = -1
        self.paused = 0
        self.ops = []
        self.plain = {}

    def note(self, what):
        if not self.paused and self.shard >= 0:
            self.by_shard[self.shard] += 1
            self.ops.append((self.shard, what))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _READS:
            self.note(name)
        elif name in ("index", "index_put", "index_put_"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx or ()):
                self.note(name + " by a boolean mask")
        return func(*args, **(kwargs or {}))


def _record(monkeypatch, rec):
    """Mark each shard's call of the integrator, pause the recorder inside
    the plain versions, and note host data copied to a device."""
    real = registry.get_integrator("montecarlo")
    calls = iter(range(len(rec.by_shard)))

    @functools.wraps(real)      # its signature: the route keywords pass
    def marked(*a, **k):
        rec.shard = next(calls)
        return real(*a, **k)

    monkeypatch.setitem(registry.INTEGRATORS, "montecarlo", marked)

    def paused(fn):
        def run(*a, **k):
            rec.plain[fn.__name__] = rec.plain.get(fn.__name__, 0) + 1
            rec.paused += 1
            try:
                return fn(*a, **k)
            finally:
                rec.paused -= 1
        return run

    for mod, name in ((mk, "mega_pass_reference"),
                      (bk, "fused_call_reference"),
                      (spk, "an_fold_plain"), (spk, "mesh_fold_plain"),
                      (ptk, "group_best_rows_plain"),
                      (ptk, "mesh_best_rows_plain")):
        monkeypatch.setattr(mod, name, paused(getattr(mod, name)))

    def copying(fn, data_at=0):
        def run(*a, **k):
            data = a[data_at] if len(a) > data_at else k.get("data")
            if not isinstance(data, torch.Tensor) and (
                    "device" in k or fn is real_new):
                rec.note(f"{fn.__name__} of host data")
            return fn(*a, **k)
        return run

    real_new = torch.Tensor.new_tensor
    monkeypatch.setattr(torch, "tensor", copying(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", copying(torch.as_tensor))
    monkeypatch.setattr(torch.Tensor, "new_tensor",
                        copying(real_new, data_at=1))


# (scene, route, the plain versions the route runs a pass: K1's once a
# shard, K2's once a bounce and shard; the pallas-trace route's small
# groups are traced by torch ops, its K5 and K6 only on larger ones)
ROUTES = {
    "K1": ("box_diffuse", dict(use_kernels=True, use_megakernel=True),
           {"mega_pass_reference": 4}),
    "K2": ("mesh_demo", dict(use_kernels=True, use_megakernel=False,
                             use_fused=True), {"fused_call_reference": 8}),
    "dense": ("box_diffuse", dict(use_kernels=False), {}),
    "pallas-trace": ("box_diffuse", dict(use_kernels=True,
                                         use_megakernel=False,
                                         use_fused=False), {}),
}


def _rays(w, h):
    proj, view = default_rt_camera(w, h)
    o, d, tc = camera_rays(proj, view, w, h, device="cpu")
    return o, d.reshape(-1, 3), tc.reshape(-1, 2)


def _one_pass(name, route, monkeypatch, inject=False):
    """The syncs of one 4-shard CPU pass, by shard, and what they were."""
    dev = compile_scene(scenes.build(name), device="cpu")
    o, d, tc = _rays(16, 12)
    mesh = make_mesh(4, "cpu")
    sd, st, _ = shard_rays(mesh, d, tc)
    rec = SyncRecorder(len(mesh))
    _record(monkeypatch, rec)
    if inject:      # a route that reads a value back, as a stand-in fault
        real = registry.INTEGRATORS["montecarlo"]

        @functools.wraps(real)
        def reading(*a, **k):
            rgb = real(*a, **k)
            float(rgb.sum())
            return rgb

        monkeypatch.setitem(registry.INTEGRATORS, "montecarlo", reading)
    fn = make_sharded_pass(mesh, nb_bounces=2, route=route)
    acc = [torch.zeros_like(x) for x in sd]
    with rec:
        fn(dev, acc, sd, st, o, 1, 1.0)
    assert all(torch.isfinite(a).all() for a in acc)
    return rec


@pytest.mark.parametrize("label", list(ROUTES))
def test_sharded_pass_makes_no_host_sync(label, monkeypatch):
    """0 on every route since the multi-card slice, which removed from
    each call K1's 2 host-data copies (its ray padding and group table),
    K2's 3 or 4 (its mesh and small-group tables and the park point, and
    its large-group table where the scene has large groups) and the
    wavefront's 1 (the IOR)."""
    name, route, plain = ROUTES[label]
    rec = _one_pass(name, route, monkeypatch)
    assert rec.plain == plain
    assert rec.by_shard == [0, 0, 0, 0], rec.ops


@pytest.mark.parametrize("label", ["K1", "K2"])
def test_sharded_pass_with_spans_makes_no_host_sync(label, monkeypatch):
    """Spans on add no host sync: they read the host's clock alone."""
    name, route, plain = ROUTES[label]
    profiling.take_spans()
    profiling.enable_spans()
    try:
        rec = _one_pass(name, route, monkeypatch)
        spans = profiling.take_spans()
    finally:
        profiling.enable_spans(False)
    assert rec.plain == plain
    assert rec.by_shard == [0, 0, 0, 0], rec.ops
    count = collections.Counter(s.name for s in spans)
    assert count["accumulate"] == 4
    assert count["k1.launch" if label == "K1" else "k2.launch"] == (
        4 if label == "K1" else 8)


def test_sync_recorder_sees_a_sync(monkeypatch):
    """The recorder is not vacuous: a route that reads its result back on
    the host makes one sync a shard."""
    rec = _one_pass(*ROUTES["K1"][:2], monkeypatch, inject=True)
    assert rec.by_shard == [1, 1, 1, 1], rec.ops
    assert {what for _, what in rec.ops} == {"_local_scalar_dense"}


# ---------------------------------------------------------------------------
# launch counts by card, host tensors, replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrapper", [mk.k1_launch, bk.k2_launch,
                                     spk.group_best_rows_sparse,
                                     spk.mesh_best_rows_sparse],
                         ids=["K1", "K2", "K5", "K6"])
def test_launches_are_counted_by_card(wrapper, monkeypatch):
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "launches_on", type(wrapper.launches_on)())
    for card in ("cuda:1", "cuda:3", "cuda:1"):
        kernels.count_launch(wrapper, torch.device(card))
    assert wrapper.launches == 3
    assert dict(wrapper.launches_on) == {"cuda:1": 2, "cuda:3": 1}


def test_host_tensor():
    t = kernels.host_tensor(((1, 0, 4, 2), (3, 4, 4, 6)), torch.int32, "cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), [[1, 0, 4, 2], [3, 4, 4, 6]])
    msi = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(
        kernels.host_tensor(msi, torch.int32, "cpu").numpy(), msi)


def test_replicas_are_made_once(monkeypatch):
    """The scene and the camera origin go to each device on the first call
    and are kept while the same objects come: no call copies from another
    card behind its work."""
    made = []
    real = sharding.to_device

    def counting(scene, dev):
        made.append(str(dev))
        return real(scene, dev)

    monkeypatch.setattr(sharding, "to_device", counting)
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    o, d, tc = _rays(8, 4)
    mesh = make_mesh(2, "cpu")
    sd, st, _ = shard_rays(mesh, d, tc)
    fn = make_sharded_pass(mesh, nb_bounces=1, route=dict(use_kernels=False))
    acc = [torch.zeros_like(x) for x in sd]
    for k in range(3):
        fn(dev, acc, sd, st, o, k, 1.0)
    sfn = make_sample_sharded_pass(mesh, nb_bounces=1,
                                   route=dict(use_kernels=False))
    for k in range(2):
        sfn(dev, d, tc, o, 2 * k, 1.0)
    assert made == ["cpu", "cpu"]      # one device: one replica a pass fn
