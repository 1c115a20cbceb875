"""The work K2's inputs need (models/bounce_kernel.K2Need), which
chip_smoke.py turns into K2's bound, against an independent count, and
K2's launch-shape choice.

fused_call_reference counts, per trace and per ray that traces for real,
the slab tests of the super boxes and of the real leaf boxes of the supers
the ray enters within its trace's final best, and the triangles or prims
of the leaves it enters so. Here the same count is made again in numpy
from the traces the accumulator kept (each ray's origin, direction,
whether it traced, its final best), ray by ray and box by box, and must
agree exactly: both sides round every float32 operation of the slab test
alike. The count never exceeds the brute fold's tests (every traced ray
against every real triangle or prim).
"""
import os
import re

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import bounce_kernel as bk
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene

W, H, BOUNCES = 16, 12, 3
F32 = np.float32


def _scene(name):
    prims = (scenes.scene_stress(n_prims=4200) if name == "stress_4200"
             else scenes.build(name))
    return compile_scene(prims, device="cpu")


def _needs(dev):
    """One pass of the fused route on the plain version, with a K2Need
    (keeping its traces) per K2 call."""
    proj, view = default_rt_camera(W, H)
    o, d, tc = camera_rays(proj, view, W, H, device="cpu")
    needs = []

    def call(inp, stf, sti, whole_path):
        need = bk.K2Need(inp, stf.device, keep=True)
        bk.fused_call_reference(inp, stf, sti, whole_path, need=need)
        needs.append((inp, need))

    bk.raytrace_fused(dev, o, d.reshape(-1, 3), tc.reshape(-1, 2), 0,
                      nb_bounces=BOUNCES, refract_ind=1.3, call=call)
    return needs


def _rcp(x):
    x = x.astype(F32)
    return (np.where(x < 0, F32(-1), F32(1))
            / np.maximum(np.abs(x), F32(1e-30))).astype(F32)


def _enters(o, rd, box, cap):
    """Ray by ray: does o + t d, t in [0, cap], enter box (6 floats)?"""
    t0 = (box[0:3, None] - o) * rd
    t1 = (box[3:6, None] - o) * rd
    tmin = np.maximum(np.minimum(t0, t1).max(axis=0), F32(0))
    tmax = np.maximum(t0, t1).min(axis=0)
    return (tmax >= tmin) & (tmin <= cap)


def _count(o, rd, cap, lanes, sbb, cbb, per_chunk):
    """(slab tests, items of the entered leaves), super by super."""
    boxes, items = int(lanes.sum()) * sbb.shape[1], 0
    for s in range(sbb.shape[1]):
        sup = _enters(o, rd, sbb[:, s], cap) & lanes
        for j in range(bk.TRI_SUPER):
            c = s * bk.TRI_SUPER + j
            if per_chunk[c] == 0:
                continue
            boxes += int(sup.sum())
            items += int(per_chunk[c]) * int(
                (sup & _enters(o, rd, cbb[:, c], cap)).sum())
    return boxes, items


def _independent(inp, traces):
    """(triangle tests, prim tests per large group, slab tests, traced
    rays) of the kept traces, counted in numpy."""
    tpool, apool = inp.tpool.numpy(), inp.apool.numpy()
    tri_real = (tpool[:, 0:9] != 0).any(axis=1).sum(axis=1)
    prim_real = (apool[:, 31] > 0).sum(axis=1)
    msc, cbb, sbb = inp.msc.numpy(), inp.cbb.numpy(), inp.sbb.numpy()
    acbb, asbb = inp.acbb.numpy(), inp.asbb.numpy()
    tri = box = traced = 0
    prim = np.zeros(len(inp.ana_groups), np.int64)
    for o, d, lanes, best in traces:
        o = np.stack([x.numpy() for x in o]).astype(F32)
        d = np.stack([x.numpy() for x in d]).astype(F32)
        lanes, best = lanes.numpy(), best.numpy()
        traced += int(lanes.sum())
        for mi, (cstart, nsup, sstart) in enumerate(inp.meshes):
            iv = msc[0:12, mi]
            oi = np.stack([iv[4 * r] * o[0] + iv[4 * r + 1] * o[1]
                           + iv[4 * r + 2] * o[2] + iv[4 * r + 3]
                           for r in range(3)])
            dn = np.stack([iv[4 * r] * d[0] + iv[4 * r + 1] * d[1]
                           + iv[4 * r + 2] * d[2] for r in range(3)])
            nrm = np.maximum(np.sqrt(dn[0] * dn[0] + dn[1] * dn[1]
                                     + dn[2] * dn[2]), F32(1e-30))
            nch = nsup * bk.TRI_SUPER
            b, t = _count(oi, _rcp(dn / nrm), best * nrm, lanes,
                          sbb[:, sstart:sstart + nsup],
                          cbb[:, cstart:cstart + nch],
                          tri_real[cstart:cstart + nch])
            box, tri = box + b, tri + t
        for g, (_code, cstart, nch, sstart) in enumerate(inp.ana_groups):
            b, t = _count(o, _rcp(d), best, lanes,
                          asbb[:, sstart:sstart + nch // bk.TRI_SUPER],
                          acbb[:, cstart:cstart + nch],
                          prim_real[cstart:cstart + nch])
            box, prim[g] = box + b, prim[g] + t
    return tri, prim, box, traced


@pytest.mark.parametrize("name", ["mesh_demo", "stress_4200"])
def test_k2_needed_work_matches_an_independent_count(name):
    dev = _scene(name)
    needs = _needs(dev)
    assert needs
    total_tri = total_prim = 0
    for inp, need in needs:
        tri, prim, box, traced = _independent(inp, need.traces)
        assert int(need.tri) == tri
        assert need.prim.tolist() == prim.tolist()
        assert int(need.box) == box
        assert int(need.traced) == traced
        assert 0 <= int(need.hits) <= traced
        assert int(need.steps) <= traced
        # never more than the brute fold's tests
        real_tri = int((inp.tpool[:, 0:9] != 0).any(dim=1).sum())
        assert int(need.tri) <= traced * real_tri
        for g, (_c, cstart, nch, _s) in enumerate(inp.ana_groups):
            real = int((inp.apool[cstart:cstart + nch, 31] > 0).sum())
            assert int(need.prim[g]) <= traced * real
        total_tri += int(need.tri)
        total_prim += int(need.prim.sum())
    # the scenes do need work: meshes their triangles, stress its prims
    assert (total_tri if dev.mesh_prim_index else total_prim) > 0


def test_k2_need_leaves_the_plain_version_unchanged():
    dev = _scene("mesh_demo")
    proj, view = default_rt_camera(W, H)
    o, d, tc = camera_rays(proj, view, W, H, device="cpu")
    args = (dev, o, d.reshape(-1, 3), tc.reshape(-1, 2), 2)

    def counting(inp, stf, sti, whole_path):
        bk.fused_call_reference(inp, stf, sti, whole_path,
                                need=bk.K2Need(inp, stf.device))

    ref = bk.raytrace_fused(*args, nb_bounces=BOUNCES, refract_ind=1.3,
                            call=bk.fused_call_reference)
    got = bk.raytrace_fused(*args, nb_bounces=BOUNCES, refract_ind=1.3,
                            call=counting)
    assert torch.equal(ref, got)


def test_k2_shape_choice_and_rays_to_scan():
    many, few = bk.SHAPES
    assert bk.k2_shape(bk.MANY_RAYS, 0) == many
    assert bk.k2_shape(bk.MANY_RAYS - 1, 0) == few
    assert bk.k2_shape(0, 3) == many               # whole-path mode
    rng = np.random.default_rng(0)
    done = rng.random(4096) < 0.7
    done[3000:] = True
    sti = torch.zeros((4, 4096), dtype=torch.int64)
    sti[0] = torch.as_tensor(done.astype(np.int64))
    assert int(bk._n_scan(sti)) == int(np.nonzero(~done)[0].max()) + 1
    sti[0] = 1
    assert int(bk._n_scan(sti)) == 0


def test_k2_launch_refuses_an_unknown_shape():
    dev = _scene("mesh_demo")
    inp = bk.fused_inputs(dev, 1.3)
    stf = torch.zeros((bk.SF, 1024))
    sti = torch.zeros((bk.SU, 1024), dtype=torch.int32)
    before = bk.k2_launch.launches
    for bad in ("warp", 1, 32):
        with pytest.raises(ValueError, match="shape"):
            bk.k2_launch(inp, stf, sti, 0, shape=bad)
    with pytest.raises(ValueError, match="CUDA"):
        bk.k2_launch(inp, stf, sti, 0, shape=bk.SHAPES[0])
    assert bk.k2_launch.launches == before


def test_k2_shape_rule_mirrors_the_kernel_source():
    """SHAPES and MANY_RAYS are a copy of csrc/bounce_kernel.cu's
    constants (on the card, bounce_kernel._lib checks the build's)."""
    src = open(os.path.join(kernels.CSRC, "bounce_kernel.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("LANES_MANY"), const("LANES_FEW")) == bk.SHAPES
    assert const("MANY_RAYS") == bk.MANY_RAYS
