"""The port's Renderer against the JAX package's.

The pixel-block permutation and the resolve must be exactly the
reference's. A small progressive render through the port (the plain K1
on the CPU) is held against the JAX Renderer on its dense route, the same
reference tests/test_megakernel.py holds the megakernel to, under the
megakernel protocol (> 98% of pixels within 1e-3 abs + 1e-3 rel, image
means within 2e-3). Checkpoints round-trip, also from the JAX package.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.render import renderer as jrenderer
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu.utils import image as jimage
from montecarlo_pathtracing_tpu_torch.models import megakernel as mk
from montecarlo_pathtracing_tpu_torch.ops.rng import seed_y
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
        tuple(r._accs[0].shape), dtype=np.float32)
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
    """Multi-device rendering (ROADMAP A.13) is ported: a 2-shard CPU
    renderer renders the unsharded image bit for bit. Every name of the
    carousel resolves to its integrator, and an unknown name raises
    KeyError."""
    sharded = _port(shard_devices=2)
    assert len(sharded._accs) == 2
    np.testing.assert_array_equal(sharded.run(2), _port().run(2))
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


# --- K1's inputs built once a tile and shard (models/megakernel.MegaMemo):
# a 32x32 render in 2 tiles of 512 rays, on 1 and 2 CPU shards

def _k1_port(name="box_diffuse", shards=1, bounces=0, ior=1.0):
    cfg = RenderConfig(width=SIZE, height=SIZE, nb_bounces=bounces,
                       tile_rays=512, passes_per_call=1, refract_ind=ior,
                       shard_devices=shards, device="cpu")
    return Renderer(compile_scene(scenes.build(name), device="cpu"), cfg)


def _k1_calls(r):
    """(tile, the shard's first ray, its rays, its screen coords) of each
    tile call of a pass, each from the renderer's unsharded rays."""
    return [(t, lo, r._dirs[t, lo:hi], r._tc[t, lo:hi])
            for t in range(r._ntiles) for _, lo, hi in r._shards()]


def _fresh_inputs(r, D, tc):
    return mk.mega_inputs(r.scene, r._origin, D, tc, r.config.refract_ind)


def _fresh_acc(r, passes):
    """The accumulator of passes 0 .. passes - 1, each tile call's pass
    from a fresh mega_inputs and mega_pass, added in the renderer's
    order."""
    acc = torch.zeros((r._ntiles, r._tile, 3))
    for p in range(passes):
        for t, lo, D, tc in _k1_calls(r):
            acc[t, lo:lo + D.shape[0]].add_(mk.mega_pass(
                _fresh_inputs(r, D, tc), seed_y(p, r.config.date),
                r.config.nb_bounces))
    return acc.numpy()


def _assert_memo_matches_fresh(r):
    """Each tile call's kept inputs are bit for bit a fresh build's."""
    memo = r._pass.mega_memo
    for (t, lo, _, _), (D, tc) in zip(
            _k1_calls(r), ((d, c) for ds, cs in r._tile_rays
                           for d, c in zip(ds, cs))):
        kept, built = memo.inputs(r.scene, r._origin, D, tc,
                                  r.config.refract_ind)
        assert not built
        fresh = _fresh_inputs(r, D, tc)
        for name, a, b in zip(mk.MegaInputs._fields, kept, fresh):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (t, lo, name)
            else:
                assert a == b, (t, lo, name)


def _counts():
    return mk.mega_inputs.builds, mk.mega_inputs.reuses


@pytest.mark.parametrize("shards", [1, 2])
def test_kept_k1_inputs_render_bit_equal_to_fresh_ones(shards):
    """Three advances with a reset between them, on a culled scene (the
    super boxes and visit order kept too), give the accumulator of the
    same passes each computed from fresh inputs."""
    r = _k1_port("materials", shards, bounces=1, ior=1.5)
    ref = _fresh_acc(r, 2)
    for _ in range(3):
        r.reset()
        r.advance(2)
        np.testing.assert_array_equal(r.accumulator(), ref)
    _assert_memo_matches_fresh(r)


@pytest.mark.parametrize("shards", [1, 2])
def test_k1_inputs_built_once_a_tile_and_shard(shards):
    r = _k1_port(shards=shards)
    calls = r._ntiles * shards
    assert r._ntiles == 2
    b0, u0 = _counts()
    r.advance(1)
    assert _counts() == (b0 + calls, u0)
    r.advance(4)
    assert _counts() == (b0 + calls, u0 + 3 * calls)
    r.reset()
    r.advance(2)
    assert _counts() == (b0 + calls, u0 + 5 * calls)


# each edit returns the tile calls it touches: a scene, an origin and an
# IOR are shared by all; a tile's rays are a view of its shard's tensor,
# whose version counter every tile of the shard shares
def _edit_scene(r):
    r.scene.color.mul_(0.5)
    return r._ntiles * len(r._mesh)


def _edit_rays(r):
    r._tile_rays[1][0][0][:, 0].add_(0.25)
    return r._ntiles


def _move_origin(r):
    r._origin = r._origin + 0.5
    return r._ntiles * len(r._mesh)


def _change_ior(r):
    r.config = dataclasses.replace(r.config, refract_ind=1.7)
    return r._ntiles * len(r._mesh)


@pytest.mark.parametrize("edit", [_edit_scene, _edit_rays, _move_origin,
                                  _change_ior])
@pytest.mark.parametrize("shards", [1, 2])
def test_kept_k1_inputs_rebuild_on_a_change(edit, shards):
    """An in-place edit of a scene tensor the table reads or of a tile's
    rays, another origin or another IOR rebuilds the tile calls it
    touches, once, and the rebuilt inputs match a fresh build."""
    r = _k1_port(shards=shards)
    calls = r._ntiles * shards
    r.advance(1)
    touched = edit(r)
    b0, u0 = _counts()
    r.advance(3)
    assert _counts() == (b0 + touched, u0 + 2 * calls - touched)
    _assert_memo_matches_fresh(r)


@pytest.mark.parametrize("shards", [1, 2])
def test_k1_memo_holds_one_entry_a_tile_and_shard(shards):
    r = _k1_port(shards=shards)
    for spp in range(1, 9):
        r.advance(spp)
        assert len(r._pass.mega_memo) == r._ntiles * shards
