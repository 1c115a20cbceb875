"""The port's tools against the JAX package's, on the CPU: the sampling
visualizer (models/draw_sampling.py), the debug views
(models/debug_views.py) and the BVH builders (scene/bvh_builder.py,
native/).

  - sample_cloud within 1e-5 of JAX's for each sampler; render_cloud
    equal to JAX's; save_sampling_png's file read back by read_png;
  - first_hit_views on box_balls, colonnes and mesh_demo at 32x24:
    prim_id, shape and albedo equal (a row may differ only on an exact
    distance tie, ROADMAP C.2: none does here), depth within 5e-4
    relative, normals within 1e-4 of JAX's or no farther from the
    float64 normal than twice JAX's (the reference's point differencing
    cancels world-sized terms: JAX's own normals are up to 8.8e-4 off on
    colonnes' small prims, the port's within 1e-7, as
    tests/test_torch_dense_trace.py holds intersection_info);
  - each render_debug_png channel against JAX's image and its PNG;
    bvh_level_boxes and bvh_level_image against JAX's; the BVH cache
    evicted with its scene;
  - build_bvh (numpy) bit-equal to JAX build_bvh(use_native=False) over
    tests/test_bvh.py's sizes; the port's native builder, built with g++
    into the package's _build/, bit-equal to its numpy one;
    check_invariants.
"""
import dataclasses
import gc
import os

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.models import debug_views as jdv
from montecarlo_pathtracing_tpu.models import draw_sampling as jds
from montecarlo_pathtracing_tpu.render.camera import (
    camera_rays as jcamera_rays, default_rt_camera)
from montecarlo_pathtracing_tpu.scene import bvh_builder as jbvh
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch import kernels
from montecarlo_pathtracing_tpu_torch.models import debug_views as dv
from montecarlo_pathtracing_tpu_torch.models import draw_sampling as ds
from montecarlo_pathtracing_tpu_torch.native import bvh_native
from montecarlo_pathtracing_tpu_torch.ops.shading import intersection_info
from montecarlo_pathtracing_tpu_torch.ops.trace import trace
from montecarlo_pathtracing_tpu_torch.scene import bvh_builder
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.utils.image import read_png, tonemap

W, H = 32, 24
NORMAL_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def box():
    """(port scene, JAX scene, proj, view) of box_diffuse."""
    proj, view = default_rt_camera(W, H)
    return (compile_scene(scenes.build("box_diffuse"), device="cpu"),
            jcompile(jscenes.build("box_diffuse")), proj, view)


# ---------------------------------------------------------------------------
# The sampling visualizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", sorted(ds.SAMPLERS))
def test_sample_cloud_matches_jax(sampler):
    normal, rough = (0.3, -0.5, 0.8), 0.5
    ref = np.asarray(jds.sample_cloud(500, normal, rough, sampler, 3))
    got = ds.sample_cloud(500, normal, rough, sampler, 3, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (500, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_render_cloud_and_png(tmp_path):
    pts = ds.sample_cloud(1000, (0, 0, 1), 0.8, device="cpu").numpy()
    img = ds.render_cloud(pts, 128, 96, normal=(0, 0, 1))
    np.testing.assert_array_equal(img, jds.render_cloud(pts, 128, 96,
                                                        normal=(0, 0, 1)))
    assert (img.sum(-1) > 0).sum() > 200
    path = str(tmp_path / "s.png")
    out = ds.save_sampling_png(path, n_samples=500, sampler="hsphere_wrong",
                               width=64, height=48, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == (500, 3)
    want = ds.render_cloud(out, 64, 48, normal=(0.0, 0.0, 1.0))
    np.testing.assert_array_equal(read_png(path),
                                  tonemap(want)[::-1] / np.float32(255.0))


# ---------------------------------------------------------------------------
# The debug views
# ---------------------------------------------------------------------------

def _normals_f64(dev, o, d):
    """The port's first-hit normals with the scene tables and hit points
    widened to float64: the exact normals the f32 ones round."""
    hit = trace(dev, o.expand(d.shape), d)
    wide = {k: getattr(dev, k).double() for k in (
        "transfo", "mesh_transfo", "tri_va", "tri_vb", "tri_vc", "tri_na",
        "tri_nb", "tri_nc")}
    n, _ = intersection_info(dataclasses.replace(dev, **wide),
                             hit._replace(pl=hit.pl.double(),
                                          pg=hit.pg.double()))
    return (0.5 * (n + 1.0)).numpy()


@pytest.mark.parametrize("name", ["box_balls", "colonnes", "mesh_demo"])
def test_first_hit_views_match_jax(name):
    proj, view = default_rt_camera(W, H)
    o, d, _ = (np.array(a) for a in jcamera_rays(proj, view, W, H))
    d = d.reshape(-1, 3)
    ref = {k: np.asarray(v) for k, v in jdv.first_hit_views(
        jcompile(jscenes.build(name)), o, d).items()}
    dev = compile_scene(scenes.build(name), device="cpu")
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = {k: v.numpy() for k, v in dv.first_hit_views(dev, to, td).items()}
    assert set(got) == set(ref)
    hit = ref["shape"] >= 0
    assert 0.3 < hit.mean() < 1
    # a row may differ only where its two winners are equally close
    differ = (got["prim_id"] != ref["prim_id"]) | (
        got["shape"] != ref["shape"])
    tie = np.isclose(got["depth"], ref["depth"], rtol=1e-6, atol=0)
    assert not (differ & ~tie).any()
    same = hit & ~differ
    np.testing.assert_array_equal(got["albedo"][~differ],
                                  ref["albedo"][~differ])
    assert np.isinf(got["depth"][~hit]).all()
    np.testing.assert_allclose(got["depth"][hit], ref["depth"][hit],
                               rtol=5e-4, atol=0)
    exact = _normals_f64(dev, to, td)
    err = np.linalg.norm(got["normal"] - ref["normal"], axis=-1)[same]
    own = np.linalg.norm(got["normal"] - exact, axis=-1)[same]
    theirs = np.linalg.norm(ref["normal"] - exact, axis=-1)[same]
    assert not ((err > NORMAL_ATOL) & (own > 2 * theirs + NORMAL_ATOL)).any()
    assert (got["normal"][~hit] == 0).all()


@pytest.mark.parametrize("channel", ["albedo", "normal", "depth", "prim_id"])
def test_render_debug_png_matches_jax(box, tmp_path, channel):
    dev, jdev, proj, view = box
    path = str(tmp_path / f"{channel}.png")
    img = dv.render_debug_png(dev, proj, view, W, H, path, channel=channel)
    ref = jdv.render_debug_png(jdev, proj, view, W, H,
                               str(tmp_path / "jax.png"), channel=channel)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    assert img.max() > 0
    np.testing.assert_array_equal(
        read_png(path), tonemap(img.astype(np.float32))[::-1]
        / np.float32(255.0))


def test_bvh_level_boxes_and_image_match_jax(box, tmp_path):
    dev, jdev, proj, view = box
    for level in (0, 1, 2, 3):
        got = dv.bvh_level_boxes(dev, level)
        assert got.shape == (1 << level, 2, 3)
        np.testing.assert_array_equal(got, jdv.bvh_level_boxes(jdev, level))
    path = str(tmp_path / "bvh.png")
    img = dv.bvh_level_image(dev, proj, view, 48, 32, level=1, path=path)
    ref = jdv.bvh_level_image(jdev, proj, view, 48, 32, level=1)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    wires = (img == np.float32([1.0, 0.9, 0.1])).all(-1)
    assert wires.sum() > 20
    assert os.path.getsize(path) > 0


def test_scene_bvh_cache_is_evicted_with_its_scene():
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    key = id(dev)
    bvh = dv.scene_bvh(dev)
    assert dv.scene_bvh(dev) is bvh and key in dv._BVH_CACHE
    del dev
    gc.collect()
    assert key not in dv._BVH_CACHE


# ---------------------------------------------------------------------------
# The BVH builders
# ---------------------------------------------------------------------------

def _random_boxes(n, seed):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-100, 100, (n, 3)).astype(np.float32)
    half = rs.uniform(0.5, 5.0, (n, 3)).astype(np.float32)
    return centers, (centers - half).astype(np.float32), \
        (centers + half).astype(np.float32)


def _assert_same_bvh(got, ref):
    assert got.depth == ref.depth
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 13, 17, 33, 64, 100, 255,
                               257])
def test_numpy_bvh_matches_jax(n):
    c, mn, mx = _random_boxes(n, 1000 + n)
    got = bvh_builder.build_bvh(c, mn, mx, use_native=False)
    _assert_same_bvh(got, jbvh.build_bvh(c, mn, mx, use_native=False))
    bvh_builder.check_invariants(got, n)


@pytest.mark.parametrize("n", [1, 2, 5, 9, 64, 100, 1000, 4097])
def test_native_bvh_matches_numpy(n):
    c, mn, mx = _random_boxes(n, n)
    native = bvh_builder.build_bvh(c, mn, mx, use_native=True)
    _assert_same_bvh(native, bvh_builder.build_bvh(c, mn, mx,
                                                   use_native=False))
    bvh_builder.check_invariants(native, n)
    # built and loaded from the package's build directory, never the JAX
    # package's
    path = bvh_native.library_path()
    assert os.path.dirname(path) == kernels.BUILD_DIR and os.path.exists(path)
    assert "montecarlo_pathtracing_tpu_torch" in path


def test_check_invariants_rejects_a_broken_bvh():
    c, mn, mx = _random_boxes(17, 5)
    bvh = bvh_builder.build_bvh(c, mn, mx, use_native=False)
    leaf = bvh.leaf.copy()
    leaf[np.flatnonzero(leaf >= 0)[0]] = -1
    with pytest.raises(AssertionError):
        bvh_builder.check_invariants(bvh._replace(leaf=leaf), 17)
    bb_min = bvh.bb_min.copy()
    bb_min[0] += 10.0                            # the root no longer holds
    with pytest.raises(AssertionError):
        bvh_builder.check_invariants(bvh._replace(bb_min=bb_min), 17)
