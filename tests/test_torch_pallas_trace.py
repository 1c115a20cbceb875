"""The brute trace kernels' plain versions (K3a `group_best_rows_plain`,
K4a `mesh_best_rows_plain`) against the JAX package's Pallas kernels
`group_best_rows` and `mesh_best_rows` in interpret mode, the padded
tables bit for bit, and the wrappers' dispatch on CPU tensors (the culled
plain versions themselves are held against JAX in
test_torch_culled_trace.py).

Inputs are made with numpy from fixed seeds and given to both sides.
Tolerance: the trace protocol of testing/parity.py. Winner rows equal on
at least 99% of the rays, and a differing row only where both distances
agree: a last-ulp difference can flip a winner at an exact or near tie.
Distances (world distance for K3a, the local ray parameter for K4a) agree
within JAX_RTOL = 5e-4 relative wherever both hit, the reference's own
tolerance between its Pallas and dense folds on these groups and rays
(tests/test_pallas_trace.py:72): XLA and torch round the same float32
formulas differently, and the sphere's and cone's quadratics cancel for
rays far from a prim or grazing it (measured up to 1.1e-4 relative here).
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py at 1e-5, which they meet exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import pallas_trace as jpt
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as pt
from montecarlo_pathtracing_tpu_torch.ops import sparse_trace as sp
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_trace_protocol, group_chunk_boxes, random_group, random_rays)
from montecarlo_pathtracing_tpu_torch.utils import transforms

CODES = [1, 2, 3, 4, 5]   # sphere, cube, cylinder, cone, oriented quad
M = 2 * pt.RAY_TILE
JAX_RTOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tables(code, n_prims=150):
    """A random group (numpy) padded by both packages' _pad_group."""
    trf, inv, pid = random_group(transforms, code, n_prims, 100 * code + 7)
    got = pt._pad_group(torch.as_tensor(trf), torch.as_tensor(inv),
                        torch.as_tensor(pid))
    ref = jpt._pad_group(jnp.asarray(trf), jnp.asarray(inv), jnp.asarray(pid))
    return got, ref


@pytest.mark.parametrize("code", CODES)
def test_group_best_rows_plain_matches_jax(code):
    (inv_r, trf_r, pid), jtab = _tables(code)
    o, d = random_rays(M, code)
    ref = [np.asarray(x) for x in jpt.group_best_rows(
        jnp.asarray(o), jnp.asarray(d), code, *jtab, interpret=True)]
    got = [x.numpy() for x in pt.group_best_rows(
        torch.as_tensor(o), torch.as_tensor(d), code, inv_r, trf_r, pid)]
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert (ref[1] >= 0).mean() > 0.05          # the rays hit something
    assert_trace_protocol(ref[:2], got[:2], f"K3a shape {code}", JAX_RTOL)
    same = (ref[1] == got[1]) & (ref[1] >= 0)
    np.testing.assert_allclose(got[2][same], ref[2][same], rtol=JAX_RTOL)
    np.testing.assert_array_equal(got[3][same], ref[3][same])
    miss = ref[1] < 0
    np.testing.assert_array_equal(got[1][miss], -1)
    np.testing.assert_array_equal(got[3][miss], ref[3][miss])


def _mesh_instance(mi=0):
    """mesh_demo instance mi's padded triangle rows (both packages) and
    2048 rays in its local frame: a band of camera-like rays from one
    origin and random rays, as numpy [3, M]."""
    jdev = jcompile(jscenes.build("mesh_demo"))
    dev = compile_scene(scenes.build("mesh_demo"), device="cpu")
    off, cnt = dev.mesh_tri_offset[mi], dev.mesh_tri_padded[mi]
    tri = pt.pad_tris(dev.tri_va[off:off + cnt], dev.tri_vb[off:off + cnt],
                      dev.tri_vc[off:off + cnt])
    jtri = jpt.pad_tris(jdev.tri_va[off:off + cnt],
                        jdev.tri_vb[off:off + cnt],
                        jdev.tri_vc[off:off + cnt])
    inv = dev.inv_transfo[dev.mesh_prim_index[mi]].numpy()
    o, d = random_rays(M, 21, lo=-150.0, hi=150.0)
    # half the rays leave the camera's eye point towards the scene
    o[:, :M // 2] = np.array([[0.0], [-250.0], [60.0]], np.float32)
    g = np.random.RandomState(3)
    aim = g.uniform(-60, 60, (3, M // 2)).astype(np.float32) - o[:, :M // 2]
    d[:, :M // 2] = aim / np.linalg.norm(aim, axis=0)
    oi = (inv[:3, :3] @ o + inv[:3, 3:4]).astype(np.float32)
    di = inv[:3, :3] @ d
    di = (di / np.linalg.norm(di, axis=0)).astype(np.float32)
    return tri, jtri, oi, di, dev.mesh_chunk_bb[mi]


def test_mesh_best_rows_plain_matches_jax():
    tri, jtri, oi, di, _ = _mesh_instance()
    ref = [np.asarray(x) for x in jpt.mesh_best_rows(
        jnp.asarray(oi), jnp.asarray(di), jtri, interpret=True)]
    got = [x.numpy() for x in pt.mesh_best_rows(
        torch.as_tensor(oi), torch.as_tensor(di), tri)]
    assert tri.shape[1] // pt.PRIM_CHUNK == 18     # a multi-chunk instance
    assert (ref[1] >= 0).mean() > 0.05
    assert_trace_protocol(ref, got, "K4a mesh_demo instance 0", JAX_RTOL)
    np.testing.assert_array_equal(got[0][ref[1] < 0], ref[0][ref[1] < 0])


@pytest.mark.parametrize("code", [2, 5])
def test_pad_group_bit_equal(code):
    got, ref = _tables(code, n_prims=200)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)
    assert got[0].shape == (12, 256)


def test_pad_tris_bit_equal():
    tri, jtri, _, _, _ = _mesh_instance(1)
    jtri = np.asarray(jtri)
    assert tri.numpy().dtype == jtri.dtype and tri.shape == jtri.shape
    np.testing.assert_array_equal(tri.numpy(), jtri)
    # a count off the chunk grid pads with zero (degenerate) triangles
    va = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    got = pt.pad_tris(va, va + 1, va + 2)
    ref = np.asarray(jpt.pad_tris(jnp.asarray(va.numpy()),
                                  jnp.asarray(va.numpy() + 1),
                                  jnp.asarray(va.numpy() + 2)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_culled_wrappers_take_the_culled_plain_version_on_cpu():
    """On CPU tensors, chunk boxes send group_best_rows to K3b's plain
    version and mesh_best_rows (with or without super boxes) to K4b's,
    and no wrapper counts a launch; boxes of the wrong width are
    refused."""
    (inv_r, trf_r, pid), _ = _tables(2)
    o, d = (torch.as_tensor(x) for x in random_rays(M, 1))
    cbb = torch.as_tensor(group_chunk_boxes(
        random_group(transforms, 2, 150, 207)[0], inv_r.shape[1]))
    wrappers = (pt.group_best_rows, pt.group_best_rows_culled,
                pt.mesh_best_rows, pt.mesh_best_rows_culled)
    before = [w.launches for w in wrappers]
    got = pt.group_best_rows(o, d, 2, inv_r, trf_r, pid, cbb=cbb)
    ref = pt.group_best_rows_culled_plain(o, d, 2, inv_r, trf_r, pid, cbb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    with pytest.raises(ValueError, match="K3b"):
        pt.group_best_rows(o, d, 2, inv_r, trf_r, pid, cbb=cbb[:, :1])

    tri, _, oi, di, mcbb = _mesh_instance()
    oi, di = torch.as_tensor(oi), torch.as_tensor(di)
    cases = ((mcbb, None, pt.super_boxes(mcbb)),
             (mcbb[:, :18], None, pt.super_boxes(mcbb[:, :18])),
             (mcbb, torch.full((6, 2), 0.0), (mcbb, torch.full((6, 2), 0.0))))
    for c, s, plain_boxes in cases:
        got = pt.mesh_best_rows(oi, di, tri, cbb=c, sbb=s)
        ref = pt.mesh_best_rows_culled_plain(oi, di, tri, *plain_boxes)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    with pytest.raises(ValueError, match="K4b"):
        pt.mesh_best_rows(oi, di, tri, cbb=mcbb[:, :16], sbb=mcbb[:, :1])
    assert [w.launches for w in wrappers] == before


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """On CPU tensors each wrapper runs its plain version without counting
    a launch; the launch functions refuse CPU tensors."""
    (inv_r, trf_r, pid), _ = _tables(1)
    o, d = (torch.as_tensor(x) for x in random_rays(M, 2))
    before = (pt.group_best_rows.launches, pt.mesh_best_rows.launches)
    got = pt.group_best_rows(o, d, 1, inv_r, trf_r, pid)
    ref = pt.group_best_rows_plain(o, d, 1, inv_r, trf_r, pid)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    pt.mesh_best_rows(o, d, torch.zeros((9, 128)))
    assert (pt.group_best_rows.launches, pt.mesh_best_rows.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        sp.mesh_fold(o, d, torch.zeros((9, 128)),
                     torch.zeros((M // sp.MESH_TILE, 1), dtype=torch.int32),
                     torch.zeros((M // sp.MESH_TILE, 1)), torch.zeros(M))
