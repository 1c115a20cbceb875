"""K2's per-bounce super schedule on the CPU: `with_schedule` and the host
side of its kernel (csrc/bounce_kernel.cu, schedule_kernel).

On CPU tensors `with_schedule` is `_schedules`' torch ops, bit for bit;
`tests/test_torch_bounce_kernel.py` holds those against the JAX package.
The kernel runs only on the card (`chip_smoke.py` holds it against
`_schedules` there); here its algorithm, written out in numpy float32 one
rounded op at a time from the tables it reads (`FusedInputs`, not the
scene), is held against `_schedules`: the large and small groups'
segments bit for bit, the mesh segments' entry bounds within 1 ulp (the
3x3 products may sum in another order than torch's matmul) and their
orders equal wherever a bound has no other bound of its tile within 4
ulps. The wrapper refuses CPU tensors, and its launches count apart from
K2's.
"""

import collections
import types

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.ops.sort_rays import ray_sort_key
from montecarlo_pathtracing_tpu_torch.ops.worklist import INF
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.scene import mesh as mesh_mod
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import cull_mesh_scene
from montecarlo_pathtracing_tpu_torch.utils import transforms

W, H = 64, 48
F32 = np.float32
# the cases of test_schedules_match_jax, and the analytic pool of menger_d2
SCENES = ("mesh_demo", "stress_4200", "cull_mesh", "menger_d2")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        if name == "cull_mesh":
            prims = cull_mesh_scene(scene_mod, mesh_mod, transforms)
        elif name == "stress_4200":
            prims = scenes.scene_stress(n_prims=4200)
        elif name == "menger_d2":
            prims = scenes.SCENES["menger_d2"]()
        else:
            prims = scenes.build(name)
        _SCENES[name] = compile_scene(prims, device="cpu")
    return _SCENES[name]


def _states(dev):
    """A primary wavefront (raytrace_fused's state at the camera) and a
    secondary one, re-sorted as raytrace_fused re-sorts from bounce 1:
    origins scattered around a few random points, directions in narrow
    random cones, a quarter of the lanes finished and parked."""
    proj, view = default_rt_camera(W, H)
    o, d, tc = camera_rays(proj, view, W, H, device="cpu")
    stf, sti, _lane, _n = bk._wavefront(o, d.reshape(-1, 3),
                                        tc.reshape(-1, 2))
    g = np.random.default_rng(7)
    m = stf.shape[1]
    pick = g.integers(0, 4, size=m)
    centres = g.uniform(-120, 120, size=(3, 4))
    axes = g.normal(size=(3, 4))
    axes /= np.linalg.norm(axes, axis=0)
    org = centres[:, pick] + g.normal(scale=2.0, size=(3, m))
    dd = axes[:, pick] + g.normal(scale=0.05, size=(3, m))
    sec = stf.clone()
    sec[0:3] = torch.as_tensor(org, dtype=torch.float32)
    sec[3:6] = torch.as_tensor(dd / np.linalg.norm(dd, axis=0),
                               dtype=torch.float32)
    done = torch.zeros(m, dtype=torch.bool)
    done[::4] = True
    park = torch.tensor([0.0, 0.0, bk.PARK_Z, 0.0, 0.0, 1.0])[:, None]
    sec[0:6] = torch.where(done[None, :], park, sec[0:6])
    key = ray_sort_key((sec[0], sec[1], sec[2]), (sec[3], sec[4], sec[5]),
                       done, dev.prim_bb_min.amin(dim=0),
                       dev.prim_bb_max.amax(dim=0))
    return stf, sec[:, torch.argsort(key, stable=True)].contiguous()


# --------------------------------------------------------------------------
# the kernel's algorithm in numpy, from the tables it reads
# --------------------------------------------------------------------------

def _cond_interval(a, b):
    pos, neg = a > 0, a < 0
    zer = ~(pos | neg)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ratio = (b / np.where(zer, F32(1), a)).astype(F32)
    lo = np.where(neg, np.where(np.isnan(ratio), ratio,
                                np.maximum(ratio, F32(0))), F32(0))
    hi = np.where(pos, ratio, F32(INF))
    hi = np.where(zer & (b < 0), F32(-1), hi)
    return lo.astype(F32), hi.astype(F32)


def _entries(bundle, boxes):
    """bundle_entry of the kernel over the columns of boxes [6, n]."""
    olo, ohi, dlo, dhi = bundle
    t_lo = np.zeros(boxes.shape[1], F32)
    t_hi = np.full(boxes.shape[1], INF, F32)
    with np.errstate(over="ignore", invalid="ignore"):
        for c in range(3):
            lo1, hi1 = _cond_interval(dlo[c], boxes[3 + c] - olo[c])
            lo2, hi2 = _cond_interval(-dhi[c], ohi[c] - boxes[c])
            t_lo = np.maximum(t_lo, np.maximum(lo1, lo2))
            t_hi = np.minimum(t_hi, np.minimum(hi1, hi2))
    real = (boxes[0:3] <= boxes[3:6]).all(axis=0)
    return np.where((t_hi >= t_lo) & real, t_lo, F32(INF))


def _dot(l, x):
    """l . x in index order, each product and sum rounded."""
    return (l[0] * x[0] + l[1] * x[1]) + l[2] * x[2]


def _local(iv, bundle):
    """The instance's local-frame bundle and dmin (local_bundle)."""
    olo, ohi, dlo, dhi = bundle
    half = F32(0.5)
    oc, orad = (olo + ohi) * half, (ohi - olo) * half
    dc, drad = (dlo + dhi) * half, (dhi - dlo) * half
    out = np.zeros((4, 3), F32)
    sq = np.zeros(3, F32)
    for r in range(3):
        lin = iv[4 * r:4 * r + 3]
        oc_l = _dot(lin, oc) + iv[4 * r + 3]
        orad_l = _dot(np.abs(lin), orad)
        dc_l, drad_l = _dot(lin, dc), _dot(np.abs(lin), drad)
        out[:, r] = (oc_l - orad_l, oc_l + orad_l, dc_l - drad_l,
                     dc_l + drad_l)
        lo, hi = out[2, r], out[3, r]
        cmin = F32(0) if (lo <= 0 and hi >= 0) else np.minimum(abs(lo),
                                                                abs(hi))
        sq[r] = cmin * cmin
    return tuple(out), np.sqrt((sq[0] + sq[1]) + sq[2])


def _sorted_by_rank(e):
    """(order, entries) of one segment: each entry at its rank, the count
    of entries smaller, or equal with a lower index, nan last."""
    n = e.shape[0]
    idx = np.arange(n)
    a, b = e[:, None], e[None, :]           # a: the others, b: the entry
    ia, ib = idx[:, None], idx[None, :]
    before = np.where(np.isnan(a), np.isnan(b) & (ia < ib),
                      np.isnan(b) | (a < b) | ((a == b) & (ia < ib)))
    rank = before.sum(axis=0)
    order = np.zeros(n, np.int32)
    ent = np.zeros(n, F32)
    order[rank], ent[rank] = idx, e
    return order, ent


def _world(bundle, boxes):
    """A large or small group's entry bounds: world distance, shrunk."""
    raw = _entries(bundle, boxes)
    return np.where(raw >= INF, F32(INF), raw * F32(1 - 1e-4) - F32(1e-4))


def _kernel_schedule(inp, stf):
    """schedule_kernel's ordr, entr [nt, 1, Stot] from inp's tables."""
    o, d = stf[0:3].numpy(), stf[3:6].numpy()
    nt = o.shape[1] // bk.TILE
    stot = bk._schedule_len(inp)
    msc, msi, sbb = inp.msc.numpy(), inp.msi.numpy(), inp.sbb.numpy()
    asbb, gsbb = inp.asbb.numpy(), inp.gsbb.numpy()
    shrink, margin = F32(1 - 1e-4), F32(1e-4)
    ordr = np.zeros((nt, 1, max(stot, 1)), np.int32)
    entr = np.full((nt, 1, max(stot, 1)), INF, F32)
    for t in range(nt):
        ot = o[:, t * bk.TILE:(t + 1) * bk.TILE]
        dt = d[:, t * bk.TILE:(t + 1) * bk.TILE]
        world = (ot.min(axis=1), ot.max(axis=1), dt.min(axis=1),
                 dt.max(axis=1))
        segs = []
        for mi, (_cstart, nsup, sstart) in enumerate(inp.meshes):
            local, dmin = _local(msc[0:12, mi], world)
            raw = _entries(local, sbb[:, sstart:sstart + nsup])
            with np.errstate(over="ignore", invalid="ignore"):
                scaled = (raw * dmin) * shrink - margin
            segs.append((int(msi[2, mi]), np.where(raw >= INF, F32(INF),
                                                   scaled)))
        off = inp.mesh_stot
        for _code, _cstart, nchunks, sstart in inp.ana_groups:
            n = nchunks // bk.TRI_SUPER
            segs.append((off, _world(world, asbb[:, sstart:sstart + n])))
            off += n
        if inp.cull:
            for _code, _start, count, sstart in inp.groups:
                n = -(-count // bk.MEGA_SUPER)
                segs.append((inp.sched_base + sstart,
                             _world(world, gsbb[:, sstart:sstart + n])))
        for off, e in segs:
            order, ent = _sorted_by_rank(e.astype(F32))
            ordr[t, 0, off:off + e.shape[0]] = order
            entr[t, 0, off:off + e.shape[0]] = ent
    return ordr, entr


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCENES)
def test_with_schedule_on_cpu_is_the_plain_version(name):
    """On CPU tensors with_schedule returns _schedules' ordr and entr bit
    for bit, on a primary and a re-sorted secondary wavefront, and never
    reaches the kernel's wrapper."""
    dev = _scene(name)
    inp = bk.fused_inputs(dev, 1.0)
    before = bk.k2_schedule_launch.launches
    for stf in _states(dev):
        got = bk.with_schedule(inp, dev, stf)
        ref_o, ref_e = bk._schedules(dev, stf[0:3], stf[3:6])
        assert got.ordr.dtype == torch.int32 and torch.equal(got.ordr, ref_o)
        assert torch.equal(got.entr.view(torch.int32),
                           ref_e.view(torch.int32))
        assert got.ordr.shape == (stf.shape[1] // bk.TILE, 1,
                                  bk._schedule_len(inp))
    assert bk.k2_schedule_launch.launches == before


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", SCENES)
def test_kernel_algorithm_from_its_tables_is_the_plain_version(name):
    """schedule_kernel's algorithm (numpy float32, one rounded op at a
    time, rank sort) from FusedInputs' tables against _schedules from the
    scene's: the groups' segments bit for bit, the mesh segments' bounds
    within 1 ulp and their orders equal but for near-ties."""
    dev = _scene(name)
    inp = bk.fused_inputs(dev, 1.0)
    for stf in _states(dev):
        ref_o, ref_e = (x.numpy() for x in bk._schedules(dev, stf[0:3],
                                                          stf[3:6]))
        got_o, got_e = _kernel_schedule(inp, stf)
        assert got_o.shape == ref_o.shape and got_e.shape == ref_e.shape
        ms = inp.mesh_stot
        np.testing.assert_array_equal(got_o[:, :, ms:], ref_o[:, :, ms:])
        np.testing.assert_array_equal(got_e[:, :, ms:].view(np.int32),
                                      ref_e[:, :, ms:].view(np.int32))
        assert (_ulps(got_e, ref_e) <= 1).all()
        e = ref_e[:, 0, :ms].astype(np.float64)
        near = np.abs(e[:, :, None] - e[:, None, :]) <= 4 * np.spacing(
            np.abs(e[:, :, None]).astype(F32))
        clear = near.sum(axis=2) == 1
        assert clear.any() or ms == 0
        np.testing.assert_array_equal(got_o[:, 0, :ms][clear],
                                      ref_o[:, 0, :ms][clear])


def test_schedule_launch_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors; nothing falls back to
    the torch ops or counts."""
    dev = _scene("mesh_demo")
    inp = bk.fused_inputs(dev, 1.0)
    stf = torch.zeros((bk.SF, bk.TILE))
    before = bk.k2_schedule_launch.launches
    with pytest.raises(ValueError, match="CUDA"):
        bk.k2_schedule_launch(inp, stf)
    assert bk.k2_schedule_launch.launches == before


def test_schedule_launches_count_apart_from_k2(monkeypatch):
    """k2_schedule_launch's host side with the library stood in for: it
    passes the bound argument list (kernels._bind_bounce_kernel), Stot is
    _schedules' width, and each launch counts in its own counter, not in
    k2_launch.launches, which launches_per_pass reads."""
    dev = _scene("cull_mesh")
    inp = bk.fused_inputs(dev, 1.0)
    bound = types.SimpleNamespace(
        fused_call=types.SimpleNamespace(),
        fused_schedule=types.SimpleNamespace(),
        fused_shape_rule=types.SimpleNamespace(),
        fused_error_string=types.SimpleNamespace())
    kernels._bind_bounce_kernel(bound)
    calls = []

    class Lib:
        def fused_schedule(self, *args):
            assert len(args) == len(bound.fused_schedule.argtypes)
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(bk, "_state_width", lambda kernel, stf: stf.shape[1])
    monkeypatch.setattr(bk, "_check_tensors", lambda *a: None)
    monkeypatch.setattr(bk, "_lib", lambda counts: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(bk.k2_schedule_launch, "launches", 0)
    monkeypatch.setattr(bk.k2_schedule_launch, "launches_on",
                        collections.Counter())
    k2_before = bk.k2_launch.launches
    stf = _states(dev)[1]
    for _ in range(3):
        ordr, entr = bk.k2_schedule_launch(inp, stf)
    ref_o, _ = bk._schedules(dev, stf[0:3], stf[3:6])
    assert ordr.shape == entr.shape == ref_o.shape
    assert calls[-1][18] == ref_o.shape[2] == bk._schedule_len(inp)
    assert inp.cull and bk._schedule_len(inp) > inp.sched_base
    assert bk.k2_schedule_launch.launches == 3
    assert bk.k2_schedule_launch.launches_on["cpu"] == 3
    assert bk.k2_launch.launches == k2_before
