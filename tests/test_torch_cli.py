"""The port's command line (cli.py, __main__.py), its helpers
(utils/image.read_png, render/camera.camera_rays_np,
render/renderer.render_scene) and utils/profiling against the JAX
package's, on the CPU.

  - `scenes` prints the JAX CLI's list; `python -m
    montecarlo_pathtracing_tpu_torch scenes` runs in a subprocess;
  - `render --cpu` at 16x12, 2 spp, 3 bounces writes the PNG of the port
    Renderer's resolve, and within 2/255 of the JAX CLI's PNG on more
    than 98% of channels; a checkpointed render resumed to 4 spp writes
    the PNG of a straight 4-spp render;
  - `--devices 2` and `--distributed` (one process) write the plain
    render's PNG;
  - `sampling` and `bench --cpu` print what the JAX CLI prints, key for
    key;
  - read_png reads a JAX-written PNG; camera_rays_np is bit-equal to
    JAX's; render_scene equals Renderer.run;
  - the profiling helpers on the CPU.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu import cli as jcli
from montecarlo_pathtracing_tpu.render import camera as jcamera
from montecarlo_pathtracing_tpu.utils import image as jimage
from montecarlo_pathtracing_tpu_torch import cli, kernels
from montecarlo_pathtracing_tpu_torch.render.camera import (
    camera_rays_np, default_rt_camera)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer, render_scene)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.utils import profiling
from montecarlo_pathtracing_tpu_torch.utils.image import (
    read_png, tonemap, write_png)

RENDER = ["--width", "16", "--height", "12", "--spp", "2", "--bounces", "3"]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _out(capsys):
    return capsys.readouterr().out.splitlines()


def test_scenes_lists_what_jax_lists(capsys):
    assert cli.main(["scenes"]) == 0
    got = _out(capsys)
    assert jcli.main(["scenes"]) == 0
    assert got == _out(capsys) and "box_diffuse" in got


def test_python_m_scenes_in_a_subprocess():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-m",
                          "montecarlo_pathtracing_tpu_torch", "scenes"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == list(scenes.SCENES)


def _port_png(spp, bounces=3, **kw):
    """The port Renderer's resolve at the CLI's defaults, as its PNG
    reads back."""
    cfg = RenderConfig(width=16, height=12, nb_bounces=bounces,
                       light_intensity=1.2, use_kernels=False, device="cpu",
                       **kw)
    dev = compile_scene(scenes.build("box_diffuse", 1.2), device="cpu")
    img = Renderer(dev, cfg).run(spp)
    return tonemap(img)[::-1] / np.float32(255.0)


def test_render_cpu_writes_the_renderers_image(tmp_path, capsys):
    path = str(tmp_path / "port.png")
    assert cli.main(["render", "--cpu", *RENDER, "--out", path]) == 0
    assert _out(capsys) == [path]
    got = read_png(path)
    assert got.shape == (12, 16, 3)
    np.testing.assert_array_equal(got, _port_png(2))
    jpath = str(tmp_path / "jax.png")
    assert jcli.main(["render", "--cpu", *RENDER, "--out", jpath]) == 0
    assert _out(capsys) == [jpath]
    close = np.abs(got - read_png(jpath)) <= 2.0 / 255.0 + 1e-6
    assert close.mean() > 0.98, close.mean()
    assert got.max() > 0


def test_checkpoint_resume_equals_a_straight_render(tmp_path, capsys):
    ck = str(tmp_path / "state.npz")
    args = ["render", "--cpu", "--width", "16", "--height", "12",
            "--bounces", "3", "--checkpoint", ck]
    assert cli.main(args + ["--spp", "2", "--out",
                            str(tmp_path / "a.png")]) == 0
    assert cli.main(args + ["--spp", "4", "--checkpoint-every", "1",
                            "--out", str(tmp_path / "b.png")]) == 0
    assert "resumed at pass 2" in capsys.readouterr().err
    straight = str(tmp_path / "c.png")
    assert cli.main(["render", "--cpu", "--width", "16", "--height", "12",
                     "--bounces", "3", "--spp", "4", "--out", straight]) == 0
    np.testing.assert_array_equal(read_png(str(tmp_path / "b.png")),
                                  read_png(straight))
    np.testing.assert_array_equal(read_png(straight), _port_png(4))


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--distributed"]])
def test_multi_device_flags_raise_naming_a13(tmp_path, capsys, flags):
    """ROADMAP A.13 is ported: `--devices 2` (two CPU shards) and
    `--distributed` with one process write the plain render's PNG."""
    path = str(tmp_path / "x.png")
    assert cli.main(["render", "--cpu", *RENDER, *flags, "--out", path]) == 0
    assert _out(capsys) == [path]
    np.testing.assert_array_equal(read_png(path), _port_png(2))


def test_sampling_prints_what_jax_prints(tmp_path, capsys):
    for sampler in ("hsphere", "hsphere_wrong", "hsphere_wrong2"):
        path, jpath = str(tmp_path / "p.png"), str(tmp_path / "j.png")
        args = ["sampling", "--cpu", "--sampler", sampler, "--samples", "400",
                "--roughness", "0.5"]
        assert cli.main(args + ["--out", path]) == 0
        assert _out(capsys) == [path]
        assert jcli.main(args + ["--out", jpath]) == 0
        assert _out(capsys) == [jpath]
        got, ref = read_png(path), read_png(jpath)
        assert got.shape == ref.shape == (512, 512, 3)
        # the clouds agree within 1e-5 (tests/test_torch_tools.py): a
        # point on a pixel edge may land one pixel over
        assert (got != ref).any(-1).sum() <= 4


def test_bench_prints_what_jax_prints(capsys):
    args = ["bench", "--cpu", "--width", "16", "--height", "12", "--spp",
            "2", "--bounces", "2", "--warmup", "1"]
    assert cli.main(args) == 0
    got = json.loads(_out(capsys)[-1])
    assert jcli.main(args) == 0
    ref = json.loads(_out(capsys)[-1])
    assert list(got) == list(ref)
    for key in ("metric", "unit", "baseline_rays_per_s", "baseline_source"):
        assert got[key] == ref[key], key
    assert got["value"] > 0 and got["vs_baseline"] >= 0


def test_read_png_reads_a_jax_png(tmp_path):
    rgb = np.random.default_rng(3).uniform(-0.2, 1.3, (7, 5, 3)).astype(
        np.float32)
    path = str(tmp_path / "j.png")
    jimage.write_png(path, rgb)
    got = read_png(path)
    np.testing.assert_array_equal(got, jimage.read_png(path))
    np.testing.assert_array_equal(got, tonemap(rgb)[::-1] / np.float32(255))
    path2 = str(tmp_path / "p.png")
    write_png(path2, rgb)
    np.testing.assert_array_equal(read_png(path2), got)


@pytest.mark.parametrize("w,h", [(16, 12), (45, 70), (7, 3)])
def test_camera_rays_np_bit_equal_to_jax(w, h):
    proj, view = default_rt_camera(w, h, yaw=20.0, zoom=0.8)
    got = camera_rays_np(proj, view, w, h)
    ref = jcamera.camera_rays_np(proj, view, w, h)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_render_scene_equals_renderer_run():
    cfg = RenderConfig(width=16, height=12, nb_bounces=3, flat_face=True,
                       device="cpu")
    got = render_scene(scenes.build("box_diffuse"), cfg, 2)
    dev = compile_scene(scenes.build("box_diffuse"), flat_face=True,
                        device="cpu")
    assert dev.flat_face
    np.testing.assert_array_equal(got, Renderer(dev, cfg).run(2))


def test_profiling_helpers_on_the_cpu(tmp_path, monkeypatch):
    out, dt = profiling.timed_block(lambda a, b: (a + b, {"x": a}),
                                    torch.ones(3), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0)) and dt >= 0.0
    assert profiling.device_memory_stats() == {}
    timer = profiling.PassTimer(rays_per_pass=100, window=3)
    assert timer.passes_per_s == 0.0
    for _ in range(5):
        timer.tick()
        time.sleep(0.002)
    assert len(timer.times) == 4
    assert timer.passes_per_s > 0
    assert timer.rays_per_s == pytest.approx(100 * timer.passes_per_s)
    with profiling.trace_context(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    # the build cache: a path moves the kernels' builds there, the opt-out
    # and no path leave them where they are
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    default = kernels.BUILD_DIR
    profiling.enable_compilation_cache()
    assert kernels.BUILD_DIR == default
    monkeypatch.setenv("MCPT_NO_COMPILE_CACHE", "1")
    profiling.enable_compilation_cache(str(tmp_path / "cache"))
    assert kernels.BUILD_DIR == default
    monkeypatch.delenv("MCPT_NO_COMPILE_CACHE")
    profiling.enable_compilation_cache(str(tmp_path / "cache"))
    assert kernels.BUILD_DIR == str(tmp_path / "cache")
    assert kernels.library_path("megakernel").startswith(
        str(tmp_path / "cache"))
    assert not os.path.exists(tmp_path / "cache")   # nothing built
