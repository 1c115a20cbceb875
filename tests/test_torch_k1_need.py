"""The work one pass of K1's inputs needs (models/megakernel.K1Need), which
chip_smoke.py turns into K1's bound, against an independent count.

mega_pass_reference counts, per trace and per ray that traces for real
(a ray in flight; a refracting ray in the re-trace), against the trace's
final best world distance: with the cull, a slab test of every super box
of each group, a slab test of the real prims' boxes of each super the ray
enters so, and a ray-prim test for each real prim whose box it enters so;
without it, a test of every real prim. Here the same count is made again
in numpy from the traces the counter kept, ray by ray and box by box, and
must agree exactly: both sides round every float32 operation of the slab
test alike. The count never exceeds the brute fold's tests, and counting
leaves the plain version's output unchanged.
"""
import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.scene import scene as scene_mod
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import all_shapes_scene
from montecarlo_pathtracing_tpu_torch.utils import transforms

W, H, BOUNCES = 24, 16, 3
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(name, ior):
    """K1's inputs of a W x H camera on a scene ("all_shapes": every shape,
    transparency and the cull)."""
    prims = (all_shapes_scene(scene_mod, transforms) if name == "all_shapes"
             else scenes.build(name))
    dev = compile_scene(prims, device="cpu")
    proj, view = default_rt_camera(W, H)
    o, d, tc = camera_rays(proj, view, W, H, device="cpu")
    return mk.mega_inputs(dev, o, d.reshape(-1, 3), tc.reshape(-1, 2), ior)


def _rcp(x):
    return (np.where(x < 0, F32(-1), F32(1))
            / np.maximum(np.abs(x), F32(1e-30))).astype(F32)


def _slab(o, rd, dl, box, best, behind):
    """Ray by ray: the fold's slab test of box (6 floats) against best."""
    t0 = (box[0:3, None] - o) * rd
    t1 = (box[3:6, None] - o) * rd
    tmin = np.minimum(t0, t1).max(axis=0)
    tmax = np.maximum(t0, t1).min(axis=0)
    if behind:
        near = np.maximum(np.maximum(tmin, -tmax), F32(0))
        return (tmax >= tmin) & (near * dl <= best)
    tmin = np.maximum(tmin, F32(0))
    return (tmax >= tmin) & (tmin * dl <= best)


def _independent(inp, traces):
    """({code: ray-prim tests}, slab tests) of the kept traces in numpy."""
    tab = inp.tab.numpy()
    real = tab[31] > 0
    sbb = inp.sbb.numpy() if inp.cull else None
    prim = {code: 0 for code, *_ in inp.groups}
    boxes = 0
    for o, d, lanes, best in traces:
        o = np.stack([x.numpy() for x in o]).astype(F32)
        d = np.stack([x.numpy() for x in d]).astype(F32)
        lanes, best = lanes.numpy(), best.numpy()
        for code, start, count, sstart in inp.groups:
            cols = [c for c in range(start, start + count) if real[c]]
            if not inp.cull:
                prim[code] += int(lanes.sum()) * len(cols)
                continue
            behind = code in mk.HITS_BEHIND
            rd = _rcp(d)
            dl = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            nsup = -(-count // mk.MEGA_SUPER)
            boxes += int(lanes.sum()) * nsup
            for s in range(nsup):
                inside = lanes & _slab(o, rd, dl, sbb[:, sstart + s], best,
                                       behind)
                for c in cols:
                    if (c - start) // mk.MEGA_SUPER != s:
                        continue
                    boxes += int(inside.sum())
                    prim[code] += int((inside & _slab(
                        o, rd, dl, tab[32:38, c], best, behind)).sum())
    return prim, boxes


@pytest.mark.parametrize("name, ior", [("materials", 1.0), ("all_shapes", 1.3),
                                       ("box_balls", 1.3)])
def test_k1_needed_work_matches_an_independent_count(name, ior):
    """Culled and opaque (materials), culled and transparent (all_shapes),
    uncull and transparent (box_balls)."""
    inp = _inputs(name, ior)
    need = mk.K1Need(inp, keep=True)
    got = mk.mega_pass_reference(inp, 5, BOUNCES, need=need)
    assert torch.equal(got, mk.mega_pass_reference(inp, 5, BOUNCES))
    prim, boxes = _independent(inp, need.traces)
    assert {k: int(v) for k, v in need.prim.items()} == prim
    assert int(need.box) == boxes
    traced = sum(int(t[2].sum()) for t in need.traces)
    assert int(need.traced) == traced
    assert int(need.hits) == sum(int((t[2] & (t[3] < mk._FMAX)).sum())
                                 for t in need.traces)
    assert int(need.steps) == int(need.path.sum()) <= traced
    assert need.path.max() <= BOUNCES
    real = int((inp.tab[31] > 0).sum())
    assert 0 < sum(prim.values()) <= traced * real
    if inp.cull:
        assert sum(prim.values()) < traced * real     # the cull drops tests
    if inp.has_transparent:
        assert traced > int(need.steps)               # the re-traces
