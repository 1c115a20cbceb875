"""The port's Renderer against the JAX package's.

The pixel-block permutation and the resolve must be exactly the
reference's. A small progressive render through the port (the plain K1
on the CPU) is held against the JAX Renderer on its dense route, the same
reference tests/test_megakernel.py holds the megakernel to, under the
megakernel protocol (> 98% of pixels within 1e-3 abs + 1e-3 rel, image
means within 2e-3). Checkpoints round-trip, also from the JAX package.
"""
import warnings

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.render import renderer as jrenderer
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu.utils import image as jimage
from montecarlo_pathtracing_tpu_torch.utils.image import write_png
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer, _block_perm)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_megakernel_protocol)

SIZE, SPP, BOUNCES = 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(**kw):
    cfg = RenderConfig(width=SIZE, height=SIZE, nb_bounces=BOUNCES,
                       device="cpu", **kw)
    return Renderer(compile_scene(scenes.build("box_diffuse"), device="cpu"),
                    cfg)


@pytest.fixture(scope="module")
def jax_renderer():
    cfg = jrenderer.RenderConfig(width=SIZE, height=SIZE,
                                 nb_bounces=BOUNCES, use_pallas=False)
    r = jrenderer.Renderer(jcompile(jscenes.build("box_diffuse")), cfg)
    r.run(SPP)
    return r


@pytest.mark.parametrize("w,h", [(32, 32), (800, 600), (45, 70), (7, 3)])
def test_block_perm_matches_jax(w, h):
    np.testing.assert_array_equal(_block_perm(w, h),
                                  jrenderer._block_perm(w, h))


def test_run_matches_jax_dense_renderer(jax_renderer):
    r = _port()
    img = r.run(SPP)
    assert img.shape == (SIZE, SIZE, 3) and r.nb_passes == SPP
    assert np.isfinite(img).all() and (img >= 0).all()
    assert_megakernel_protocol(jax_renderer.image(), img,
                               "32x32 4-spp render")


def test_resolve_matches_jax(jax_renderer):
    """The same accumulator resolves to the same image, in both
    directions of the block permutation and with padding rays."""
    r = _port(tile_rays=256)
    jcfg = jrenderer.RenderConfig(width=SIZE, height=SIZE, tile_rays=256)
    jr = jrenderer.Renderer(jcompile(jscenes.build("box_diffuse")), jcfg)
    acc = np.random.default_rng(5).random(
        tuple(r._acc.shape), dtype=np.float32)
    np.testing.assert_array_equal(r.resolve(torch.as_tensor(acc), 7),
                                  jr.resolve(acc, 7))


def test_checkpoint_round_trip(tmp_path, jax_renderer):
    full = _port().run(SPP)
    r = _port()
    r.advance(2)
    r.save_checkpoint(str(tmp_path / "ck.npz"))
    resumed = _port()
    resumed.load_checkpoint(str(tmp_path / "ck.npz"))
    assert resumed.nb_passes == 2
    np.testing.assert_array_equal(resumed.run(SPP), full)

    # a radiance-changing knob rejects; a route/device knob warns
    with pytest.raises(ValueError, match="nb_bounces"):
        Renderer(compile_scene(scenes.build("box_diffuse"), device="cpu"),
                 RenderConfig(width=SIZE, height=SIZE, nb_bounces=5,
                              device="cpu")
                 ).load_checkpoint(str(tmp_path / "ck.npz"))
    with pytest.warns(UserWarning, match="route"):
        _port(use_megakernel=True).load_checkpoint(str(tmp_path / "ck.npz"))

    # a checkpoint written by the JAX package resumes here: its use_pallas
    # key is unknown to the port and ignored
    jax_renderer.save_checkpoint(str(tmp_path / "jax.npz"))
    from_jax = _port()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        from_jax.load_checkpoint(str(tmp_path / "jax.npz"))
    assert from_jax.nb_passes == SPP
    np.testing.assert_array_equal(from_jax.image(), jax_renderer.image())


def test_png_matches_jax(tmp_path):
    """write_png writes the same bytes as the JAX package's writer (tone
    map, flip, encoding)."""
    img = np.random.default_rng(3).random((13, 21, 3), dtype=np.float32) * 2
    write_png(str(tmp_path / "port.png"), img)
    jimage.write_png(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()


def test_unported_options_raise():
    """Multi-device rendering (ROADMAP A.13) raises; every name of the
    carousel resolves to its integrator, and an unknown name raises
    KeyError."""
    with pytest.raises(NotImplementedError, match="A.13"):
        _port(shard_devices=2)
    from montecarlo_pathtracing_tpu_torch.models import registry
    assert list(registry.INTEGRATORS) == ["montecarlo", "montecarlo_mat",
                                          "montecarlo_mat_tr",
                                          "montecarlo_aos"]
    for name, fn in registry.INTEGRATORS.items():
        assert _port(integrator=name)._integrator is fn
    with pytest.raises(KeyError, match="unknown integrator"):
        _port(integrator="montecarlo_bvh")
    with pytest.raises(ValueError, match="scene is on"):
        Renderer(compile_scene(scenes.build("box_diffuse"), device="cpu"),
                 RenderConfig(width=8, height=8, device="meta"))


def test_renderer_passes_only_the_route_keywords_an_integrator_takes(
        monkeypatch):
    """An integrator whose signature names only `use_kernels` of the route
    keywords renders through Renderer.advance and gets exactly that one
    (the reference renderer filters them by the signature,
    render/renderer.py:196-197)."""
    from montecarlo_pathtracing_tpu_torch.models import registry

    seen = []

    def kernels_only(scene, O, D, screen_tc, pass_index, *, nb_bounces,
                     refract_ind, date=0.0, detach_sampling=False,
                     use_kernels=False):
        seen.append(use_kernels)
        return torch.full((D.shape[0], 3), 0.25)

    monkeypatch.setitem(registry.INTEGRATORS, "montecarlo", kernels_only)
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    r = Renderer(dev, RenderConfig(width=16, height=8, nb_bounces=2,
                                   use_kernels=True, device="cpu"))
    r.advance(2)
    assert seen == [True] * (2 * r._ntiles)
    np.testing.assert_allclose(r.image(), 0.25, rtol=1e-6)
