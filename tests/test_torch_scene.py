"""The port's scene compile against the JAX package's: exact equality.

Every DeviceScene field (per-prim tables, typed groups, mesh pools,
chunk/super boxes, the analytic pool) must be element-wise equal with the
same dtype and shape, and all static metadata equal. `from_jax_scene`
must carry the JAX scene into a port DeviceScene equal to the port's own
compile. Scenes are procedural, so both packages build the same prims.
"""
import dataclasses

import numpy as np
import pytest

from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import (
    DeviceScene as JDeviceScene, compile_scene as jcompile)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import (
    DeviceScene, compile_scene, from_jax_scene)

SCENES = ["box_diffuse", "box_balls", "materials", "mesh_demo"]


def _build(mod, name):
    """stress_4400: past the 4096-prim table cap, so the chunked analytic
    pool (ana_chunks, ana_groups) is populated."""
    if name == "stress_4400":
        return mod.scene_stress(n_prims=4400)
    return mod.build(name)


def _is_static(cls, name):
    return bool(next(f for f in dataclasses.fields(cls)
                     if f.name == name).metadata.get("static"))


def _assert_same_array(name, ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=name)


def _assert_scene_equal(ref, got, ref_cls):
    names = [f.name for f in dataclasses.fields(ref_cls)]
    assert names == [f.name for f in dataclasses.fields(DeviceScene)]
    for name in names:
        r, g = getattr(ref, name), getattr(got, name)
        if _is_static(ref_cls, name):
            assert _is_static(DeviceScene, name), name
            assert g == r, (name, g, r)
        elif isinstance(r, tuple):
            assert isinstance(g, tuple) and len(g) == len(r), name
            for k, (ra, ga) in enumerate(zip(r, g)):
                _assert_same_array(f"{name}[{k}]", ra, ga)
        else:
            _assert_same_array(name, r, g)


def _jax_fields(jdev):
    out = {}
    for f in dataclasses.fields(JDeviceScene):
        v = getattr(jdev, f.name)
        if f.metadata.get("static"):
            out[f.name] = v
        elif isinstance(v, tuple):
            out[f.name] = tuple(np.asarray(a) for a in v)
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", SCENES + ["stress_4400"])
def test_compile_scene_matches_jax(name):
    ref = jcompile(_build(jscenes, name))
    got = compile_scene(_build(scenes, name), device="cpu")
    _assert_scene_equal(ref, got, JDeviceScene)
    assert got.device.type == "cpu"


@pytest.mark.parametrize("name", SCENES)
def test_from_jax_scene_matches_port_compile(name):
    carried = from_jax_scene(_jax_fields(jcompile(jscenes.build(name))),
                             device="cpu")
    own = compile_scene(scenes.build(name), device="cpu")
    _assert_scene_equal(own, carried, DeviceScene)
