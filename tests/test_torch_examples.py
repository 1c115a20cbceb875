"""The port's example twins (examples/*_torch.py) in their quick mode on
the CPU, at a few dozen pixels, each in a subprocess (single-threaded,
killed past 240 s) writing into the test's directory; their JSON reports
are read back:

  - render_gallery_torch.py on box_diffuse and box_balls: the PNGs, and
    each render against the committed gallery PNG (mean absolute
    difference and luma NCC of their 64x50 luminance grids);
  - inverse_rendering_torch.py with --no-scans: the albedo fit by AD
    lowers the loss;
  - config5_manyrays_torch.py: the checkpoint, tear-down and resume run,
    in one process and in two (--processes 2: run_multihost_render over
    gloo), the same PNG.
"""
import json
import os
import subprocess
import sys

import numpy as np

from montecarlo_pathtracing_tpu_torch.utils.image import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--width", "16", "--height", "12"]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", script), "--cpu",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    return out


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_render_gallery_twin(tmp_path):
    _run("render_gallery_torch.py", "--quick", *SIZE, "--scenes",
         "box_diffuse", "box_balls", "--out", str(tmp_path))
    report = _json(tmp_path / "gallery.json")
    assert report["config"]["device"] == "cpu"
    assert not report["config"]["use_kernels"]
    assert report["config"]["spp"] == 16
    assert list(report["scenes"]) == ["box_diffuse", "box_balls"]
    for name, entry in report["scenes"].items():
        assert read_png(str(tmp_path / entry["png"])).shape == (12, 16, 3)
        assert entry["committed_png"] == f"{name}.png"
        assert 0 <= entry["committed_mad"] < 0.5
        assert -1 <= entry["committed_luma_ncc"] <= 1
        assert entry["mean"] > 0 and "luma_ncc" not in entry


def test_inverse_rendering_twin(tmp_path):
    _run("inverse_rendering_torch.py", "--quick", *SIZE, "--steps", "3",
         "--no-scans", "--outdir", str(tmp_path))
    out = _json(tmp_path / "inverse_rendering.json")
    assert out["device"] == "cpu" and not out["fast_path"]
    assert (out["width"], out["height"], out["steps"]) == (16, 12, 3)
    curve = out["loss_curve"]
    assert len(curve) == 20 and curve[-1] < curve[0]
    assert out["recovered"]["albedo"] != out["initial"]["albedo"]
    for name in ("inv_target", "inv_initial", "inv_recovered"):
        assert read_png(str(tmp_path / f"{name}.png")).shape == (12, 16, 3)


def test_config5_manyrays_twin(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    _run("config5_manyrays_torch.py", "--quick", *SIZE, "--spp", "4",
         "--out", str(one))
    _run("config5_manyrays_torch.py", "--quick", *SIZE, "--spp", "4",
         "--processes", "2", "--out", str(two))
    a, b = _json(one / "manyrays.json"), _json(two / "manyrays.json")
    assert (a["spp"], a["processes"], a["resumed_at_pass"]) == (4, 1, 2)
    assert (b["processes"], b["resumed_at_pass"]) == (2, [1, 3])
    assert a["img_mean"] == b["img_mean"] > 0
    np.testing.assert_array_equal(read_png(str(one / "manyrays.png")),
                                  read_png(str(two / "manyrays.png")))
