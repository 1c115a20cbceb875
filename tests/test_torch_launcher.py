"""The port's multi-process launcher (parallel/launcher.py) on the CPU.

  - run_multihost_render in one process equals Renderer.image() BIT for
    bit at 64x48, where the block32 pixel permutation is not the
    identity (a launcher that forgot to invert it scrambles the image);
  - it is held against the JAX package's one-process
    run_multihost_render on the dense route by the megakernel protocol;
  - process_checkpoint_path names what JAX's names; run_distributed_render
    checkpoints and resumes;
  - two gloo processes (testing/launcher_worker.py, box_diffuse 64x48, 6
    bounces, 8 spp, the plain K1) against a single-process render within
    rtol 1e-5, atol 1e-6 (the cross-process sum reorders float adds;
    tests/test_launcher.py:112), and a crash after 2 local passes
    followed by a relaunch resumes to a BIT-identical image.
Each subprocess runs single-threaded with a 120 s limit and is killed
past it.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.parallel import launcher as jlauncher
from montecarlo_pathtracing_tpu.render import renderer as jrenderer
from montecarlo_pathtracing_tpu.scene import scenes as jscenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene as jcompile
from montecarlo_pathtracing_tpu_torch.parallel.launcher import (
    process_checkpoint_path, run_distributed_render, run_multihost_render)
from montecarlo_pathtracing_tpu_torch.render.renderer import (
    RenderConfig, Renderer)
from montecarlo_pathtracing_tpu_torch.scene import scenes
from montecarlo_pathtracing_tpu_torch.scene.device import compile_scene
from montecarlo_pathtracing_tpu_torch.testing.parity import (
    assert_megakernel_protocol)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "montecarlo_pathtracing_tpu_torch.testing.launcher_worker"
SPP = 8
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Small elementwise ops are far slower multi-threaded on a shared CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(tmp, out, crash_at=None, checkpoint=None):
    """The worker in 2 processes: [(exit code, output)] by rank."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for pid in (0, 1):
        cmd = [sys.executable, "-m", WORKER, "--process-id", str(pid),
               "--num-processes", "2", "--port", str(port), "--spp",
               str(SPP), "--out", out, "--checkpoint-every", "2", "--cpu"]
        if checkpoint:
            cmd += ["--checkpoint", checkpoint]
        if crash_at is not None:
            cmd += ["--crash-at", str(crash_at)]
        procs.append(subprocess.Popen(cmd, cwd=str(tmp), env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out_b, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out_b.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _renderer(**kw):
    dev = compile_scene(scenes.build("box_diffuse"), device="cpu")
    cfg = RenderConfig(width=64, height=48, passes_per_call=1,
                       tile_rays=1 << 10, device="cpu", **kw)
    return Renderer(dev, cfg)


def test_single_process_launcher_matches_renderer_image():
    r = _renderer(nb_bounces=3)
    img = run_multihost_render(r, 2)
    assert r.nb_passes == 2
    np.testing.assert_array_equal(img, r.image())
    assert not np.array_equal(r._inv_perm, np.arange(r._npix))


def test_single_process_launcher_matches_jax_launcher(tmp_path):
    r = _renderer(nb_bounces=3, use_kernels=False)
    ck = str(tmp_path / "port.npz")
    img = run_multihost_render(r, 3, checkpoint=ck, checkpoint_every=2)
    assert os.path.exists(process_checkpoint_path(ck, 0))
    jr = jrenderer.Renderer(
        jcompile(jscenes.build("box_diffuse")),
        jrenderer.RenderConfig(width=64, height=48, nb_bounces=3,
                               passes_per_call=1, tile_rays=1 << 10))
    want = jlauncher.run_multihost_render(jr, 3)
    assert img.shape == want.shape == (48, 64, 3)
    assert_megakernel_protocol(want, img, "one-process launcher vs JAX's")


def test_distributed_render_checkpoints_and_resumes(tmp_path):
    """run_distributed_render in one process (the coordinator): it saves
    the checkpoint every 2 passes, and a fresh renderer resumes from it to
    the same image as a straight render."""
    ck = str(tmp_path / "state.npz")
    r = _renderer(nb_bounces=3, use_kernels=False)
    run_distributed_render(r, 2, ck, checkpoint_every=2)
    resumed = _renderer(nb_bounces=3, use_kernels=False)
    img = run_distributed_render(resumed, 4, ck, checkpoint_every=2)
    assert resumed.nb_passes == 4
    with np.load(ck) as z:
        assert int(z["nb_passes"]) == 4
    np.testing.assert_array_equal(
        img, _renderer(nb_bounces=3, use_kernels=False).run(4))


@pytest.mark.parametrize("name", ["state.npz", "state", "a/b/run.ckpt.npz",
                                  "dir.v2/state", "/abs/path/s.npz"])
def test_process_checkpoint_path_matches_jax(name):
    for pid in (0, 1, 7):
        assert process_checkpoint_path(name, pid) == \
            jlauncher.process_checkpoint_path(name, pid)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The 2-process render without a crash: its image."""
    tmp = tmp_path_factory.mktemp("launcher")
    out = str(tmp / "uninterrupted.npy")
    results = _launch(tmp, out)
    for rc, log in results:
        assert rc == 0, log[-2000:]
    lines = [json.loads(log.strip().splitlines()[-1]) for _, log in results]
    assert [d["rank"] for d in lines] == [0, 1]
    assert [d["passes"] for d in lines] == [SPP // 2, SPP]
    return np.load(out)


def test_two_process_render_matches_single(uninterrupted):
    ref = _renderer(nb_bounces=6).run(SPP)
    np.testing.assert_allclose(uninterrupted, ref, rtol=1e-5, atol=1e-6)
    assert ref.max() > 0


def test_crash_resume_bit_identical(tmp_path, uninterrupted):
    ck = str(tmp_path / "state.npz")
    out = str(tmp_path / "crashed.npy")
    # both processes die after their first checkpoint (2 local passes),
    # before the gather
    results = _launch(tmp_path, out, crash_at=2, checkpoint=ck)
    assert [rc for rc, _ in results] == [3, 3], results
    for pid in (0, 1):
        with np.load(process_checkpoint_path(ck, pid)) as z:
            assert int(z["nb_passes"]) == pid * SPP // 2 + 2
    assert not os.path.exists(out)
    # the relaunch resumes from the checkpoints and completes
    results = _launch(tmp_path, out, checkpoint=ck)
    for rc, log in results:
        assert rc == 0, log[-2000:]
    np.testing.assert_array_equal(np.load(out), uninterrupted)
