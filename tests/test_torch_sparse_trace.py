"""The pruned walks' plain versions (K5 `an_fold_plain`, K6
`mesh_fold_plain`, through the wrappers `group_best_rows_sparse` and
`mesh_best_rows_sparse`) against the JAX package's
ops/sparse_trace.py in interpret mode, their host side bit for bit, and
the pruned walks against the brute folds (the reference's invariant,
tests/test_sparse_trace.py:27-54).

Rays are made with numpy from fixed seeds (ROADMAP C.1). Tolerance: the
trace protocol of testing/parity.py, as in test_torch_pallas_trace.py:
winner rows equal on at least 99% of the rays, a differing row only where
both distances agree, and distances within the reference's 5e-4 relative
between frameworks (XLA and torch round the shape tests differently).
Within the port, the walk and the brute fold compute every tested prim
with the same arithmetic, so their distances are bit-equal and their rows
differ only on exact ties. The entry bounds, exit bounds and ranked
schedule are bit-equal where the keys of a tile are distinct.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import pallas_trace as jpt
from montecarlo_pathtracing_tpu.ops import sparse_trace as jsp
from montecarlo_pathtracing_tpu.ops import worklist as jwl
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.ops import pallas_trace as pt
from montecarlo_pathtracing_tpu_torch.ops import sparse_trace as sp
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_trace_protocol, random_rays)

M = 2 * sp.AN_TILE
JAX_RTOL = 5e-4

_SCENES = {}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scenes(name):
    """(JAX DeviceScene, port DeviceScene on the CPU), built once."""
    if name not in _SCENES:
        _SCENES[name] = (jcompile(jscenes.build(name)),
                         compile_scene(scenes.build(name), device="cpu"))
    return _SCENES[name]


def _rays(seed, lo=-30.0, hi=30.0):
    """Rays through the scene as the reference's sparse tests make them:
    origins uniform in [lo, hi]^3, unit directions ([3, M] numpy)."""
    return random_rays(M, seed, lo, hi)


def _coherent_rays(dev, seed, tile):
    """Rays bundled per tile, as the sorted wavefront groups them: per
    tile an origin around a random point and directions in a narrow cone
    about the way to a random point of the scene's box, or near a mesh
    instance ([3, M] numpy)."""
    g = np.random.RandomState(seed)
    nt = M // tile
    if dev.mesh_prim_index:     # around the mesh instances' centres
        centres = dev.transfo[list(dev.mesh_prim_index), :3, 3].numpy().T
        target = centres[:, g.randint(centres.shape[1], size=nt)]
        target = target + g.normal(scale=20.0, size=target.shape)
    else:
        lo = dev.prim_bb_min.amin(dim=0).numpy()[:, None]
        hi = dev.prim_bb_max.amax(dim=0).numpy()[:, None]
        target = lo + g.uniform(size=(3, nt)) * (hi - lo)
    o = np.repeat(g.uniform(-120, 120, (3, nt)), tile, axis=1)
    target = np.repeat(target, tile, axis=1)
    axis = target - o
    o = o + g.normal(scale=2.0, size=o.shape)
    d = axis / np.linalg.norm(axis, axis=0) + g.normal(scale=0.05,
                                                       size=axis.shape)
    return (o.astype(np.float32),
            (d / np.linalg.norm(d, axis=0)).astype(np.float32))


def _large_groups(jdev, dev):
    """(index, code, port tables, JAX tables) of the groups that take
    the kernels."""
    out = []
    for gi, code in enumerate(dev.group_codes):
        if dev.group_prim[gi].shape[0] <= 96:
            continue
        tabs = pt._pad_group(dev.group_transfo[gi], dev.group_inv[gi],
                             dev.group_prim[gi])
        jtabs = jpt._pad_group(jdev.group_transfo[gi], jdev.group_inv[gi],
                               jdev.group_prim[gi])
        out.append((gi, code, tabs, jtabs))
    return out


def _local(dev, mi, o, d):
    inv = dev.inv_transfo[dev.mesh_prim_index[mi]].numpy()
    oi = (inv[:3, :3] @ o + inv[:3, 3:4]).astype(np.float32)
    di = inv[:3, :3] @ d
    return oi, (di / np.linalg.norm(di, axis=0)).astype(np.float32)


def _instance_tris(dev, mi):
    off, cnt = dev.mesh_tri_offset[mi], dev.mesh_tri_padded[mi]
    return pt.pad_tris(dev.tri_va[off:off + cnt], dev.tri_vb[off:off + cnt],
                       dev.tri_vc[off:off + cnt])


def test_group_best_rows_sparse_matches_jax():
    jdev, dev = _scenes("colonnes")
    o, d = _rays(0)
    groups = _large_groups(jdev, dev)
    assert [code for _, code, _, _ in groups] == [2, 3]   # cubes, cylinders
    for gi, code, tabs, jtabs in groups:
        ref = [np.asarray(x) for x in jsp.group_best_rows_sparse(
            jnp.asarray(o), jnp.asarray(d), code, *jtabs,
            jdev.group_super_bb[gi], interpret=True)]
        got = [x.numpy() for x in sp.group_best_rows_sparse(
            torch.as_tensor(o), torch.as_tensor(d), code, *tabs,
            dev.group_super_bb[gi])]
        assert (ref[1] >= 0).mean() > 0.02
        assert_trace_protocol(ref[:2], got[:2], f"K5 group {gi}", JAX_RTOL)
        same = (ref[1] == got[1]) & (ref[1] >= 0)
        np.testing.assert_allclose(got[2][same], ref[2][same], rtol=JAX_RTOL)
        np.testing.assert_array_equal(got[3][same], ref[3][same])


def test_mesh_best_rows_sparse_matches_jax():
    jdev, dev = _scenes("mesh_demo")
    o, d = _rays(1, -150.0, 150.0)
    for mi in range(len(dev.mesh_prim_index)):
        oi, di = _local(dev, mi, o, d)
        tri = _instance_tris(dev, mi)
        off, cnt = jdev.mesh_tri_offset[mi], jdev.mesh_tri_padded[mi]
        jtri = jpt.pad_tris(jdev.tri_va[off:off + cnt],
                            jdev.tri_vb[off:off + cnt],
                            jdev.tri_vc[off:off + cnt])
        ref = [np.asarray(x) for x in jsp.mesh_best_rows_sparse(
            jnp.asarray(oi), jnp.asarray(di), jtri, jdev.mesh_chunk_bb[mi],
            interpret=True)]
        got = [x.numpy() for x in sp.mesh_best_rows_sparse(
            torch.as_tensor(oi), torch.as_tensor(di), tri,
            dev.mesh_chunk_bb[mi])]
        assert (ref[1] >= 0).any()
        assert_trace_protocol(ref, got, f"K6 instance {mi}", JAX_RTOL)


def _jax_bound(o, d, boxes):
    """The reference's per-ray root-box exit, sparse_trace.py:288-298."""
    inf = jwl.INF
    real = jnp.all(boxes[0:3] <= boxes[3:6], axis=0)
    root_lo = jnp.min(jnp.where(real[None, :], boxes[0:3], inf), axis=1)
    root_hi = jnp.max(jnp.where(real[None, :], boxes[3:6], -inf), axis=1)
    rd = jpt._safe_rcp(d)
    t0b = (root_lo[:, None] - o) * rd
    t1b = (root_hi[:, None] - o) * rd
    tent = jnp.maximum(jnp.max(jnp.minimum(t0b, t1b), axis=0), 0.0)
    texi = jnp.min(jnp.maximum(t0b, t1b), axis=0)
    return jnp.where(texi >= tent,
                     texi * np.float32(1.0001) + np.float32(1e-4),
                     np.float32(0.0))


def _jax_entry(o, d, boxes, tile):
    """The reference's tile entry bounds with margins, :281-283."""
    tlo = jwl.bundle_box_entry(jwl.tile_bundles(o, d, tile), boxes)
    return jnp.where(tlo >= jwl.INF, jwl.INF,
                     tlo * np.float32(1.0 - 1e-4) - np.float32(1e-4))


@pytest.mark.parametrize("name", ["colonnes", "mesh_demo"])
def test_entry_bound_and_schedule_bit_equal(name):
    """tlo, the root-exit bound and the ranked schedule of the port
    against the reference's expressions, on the groups' 8-prim windows
    (1024-ray tiles) or the instances' chunks (128-ray tiles)."""
    jdev, dev = _scenes(name)
    tile = sp.AN_TILE if name == "colonnes" else sp.MESH_TILE
    o, d = _coherent_rays(dev, 2, tile)
    if name == "colonnes":
        cases = [(o, d, dev.group_super_bb[gi], jdev.group_super_bb[gi],
                  sp.AN_TILE) for gi, _, _, _ in _large_groups(jdev, dev)]
    else:
        cases = []
        for mi in range(len(dev.mesh_prim_index)):
            oi, di = _local(dev, mi, o, d)
            n = dev.mesh_tri_padded[mi] // pt.PRIM_CHUNK
            cases.append((oi, di, dev.mesh_chunk_bb[mi][:, :n],
                          jdev.mesh_chunk_bb[mi][:, :n], sp.MESH_TILE))
    for oo, dd, boxes, jboxes, tile in cases:
        ot, dt = torch.as_tensor(oo), torch.as_tensor(dd)
        tlo = sp._entry(ot, dt, boxes, tile)
        jtlo = _jax_entry(jnp.asarray(oo), jnp.asarray(dd), jboxes, tile)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jtlo))
        assert (tlo < sp.INF).any() and (tlo == sp.INF).any()
        if tile == sp.AN_TILE:
            _, _, _, bound = sp.an_inputs(ot, dt, *_large_groups(
                jdev, dev)[0][2], boxes)
        else:
            bound = sp.mesh_inputs(ot, dt, torch.zeros(
                (9, boxes.shape[1] * pt.PRIM_CHUNK)), boxes)[2]
        np.testing.assert_array_equal(
            bound.numpy(), np.asarray(_jax_bound(jnp.asarray(oo),
                                                 jnp.asarray(dd), jboxes)))
        order, tlo_sorted = sp._ranked_schedule(tlo)
        jorder, jsorted = (np.asarray(x) for x in jsp._ranked_schedule(jtlo))
        assert order.dtype == torch.int32
        np.testing.assert_array_equal(tlo_sorted.numpy(), jsorted)
        # compared where a tile's key is distinct (ties may order either way)
        t = jsorted
        distinct = ((np.diff(t, axis=1, prepend=-np.inf) != 0)
                    & (np.diff(t, axis=1, append=np.inf) != 0))
        assert distinct.any()
        np.testing.assert_array_equal(order.numpy()[distinct],
                                      jorder[distinct])


@pytest.mark.parametrize("name", ["colonnes", "mesh_demo"])
def test_plain_sparse_matches_plain_brute(name):
    """The walk skips only blocks that cannot hold a strictly closer hit,
    so its distances are the brute fold's bit for bit and its rows differ
    only on exact distance ties."""
    jdev, dev = _scenes(name)
    o, d = _rays(3)
    pairs = []
    if name == "colonnes":
        for gi, code, tabs, _ in _large_groups(jdev, dev):
            ot, dt = torch.as_tensor(o), torch.as_tensor(d)
            pairs.append((pt.group_best_rows(ot, dt, code, *tabs)[:2],
                          sp.group_best_rows_sparse(
                              ot, dt, code, *tabs, dev.group_super_bb[gi])[:2]))
    else:
        for mi in range(len(dev.mesh_prim_index)):
            oi, di = (torch.as_tensor(x) for x in _local(dev, mi, o, d))
            tri = _instance_tris(dev, mi)
            pairs.append((pt.mesh_best_rows(oi, di, tri),
                          sp.mesh_best_rows_sparse(oi, di, tri,
                                                   dev.mesh_chunk_bb[mi])))
    for brute, sparse in pairs:
        np.testing.assert_array_equal(sparse[0].numpy(), brute[0].numpy())
        tie = sparse[1].numpy() != brute[1].numpy()
        assert tie.mean() < 0.01
        assert (brute[1].numpy() >= 0).any()


def test_sparse_launchers_refuse_cpu_tensors():
    jdev, dev = _scenes("colonnes")
    o, d = (torch.as_tensor(x) for x in _rays(4))
    gi, code, tabs, _ = _large_groups(jdev, dev)[0]
    inputs = sp.an_inputs(o, d, *tabs, dev.group_super_bb[gi])
    before = sp.group_best_rows_sparse.launches
    with pytest.raises(ValueError, match="CUDA"):
        sp.an_fold(o, d, *inputs, code, dev.group_super_bb[gi])
    assert sp.group_best_rows_sparse.launches == before
    assert sp.group_best_rows_sparse(o, d, code, *tabs,
                                     dev.group_super_bb[gi])[0].shape == (M,)
    assert sp.group_best_rows_sparse.launches == before
