"""The reference against the program's own routes on the CPU at a tiny
size: bit for bit against the dense route, within the megakernel
protocol against the routes the cells run (K1's and K2's plain
versions)."""
import numpy as np
import pytest
import torch

from portbench.harness import port
from portbench.harness.scenes import load_scene
from portbench.reference import camera, render_samples

CASES = [("colonnes", 16, 9, 3, dict(yaw=10.0, pitch=-5.0, zoom=0.6)),
         ("mesh_demo", 16, 12, 4, {})]


@pytest.mark.parametrize("name,w,h,bounces,pose", CASES)
@pytest.mark.parametrize("route", ["dense", "kernels"])
def test_reference_matches_the_program(tiny_root, name, w, h, bounces,
                                       pose, route):
    from montecarlo_pathtracing_tpu_torch.models.montecarlo import raytrace
    from montecarlo_pathtracing_tpu_torch.render.camera import camera_rays

    desc = load_scene(name, 1.2, tiny_root)
    proj, view = camera.pose_matrices(w, h, **pose)
    scene = port.compile_scene(desc, "cpu")
    o, d, tc = camera_rays(proj, view, w, h, device="cpu")
    ys, xs = np.divmod(np.arange(w * h), w)
    ref = render_samples(desc, proj, view, w, h, xs, ys, [5, 900],
                         nb_bounces=bounces, ior=1.0, date=3.25,
                         device="cpu")
    for k, pass_index in enumerate([5, 900]):
        rgb = raytrace(scene, o, d.reshape(-1, 3), tc.reshape(-1, 2),
                       pass_index, nb_bounces=bounces, refract_ind=1.0,
                       date=3.25, use_kernels=route == "kernels")
        if route == "dense":
            assert torch.equal(rgb, ref[k])
        else:
            diff = (rgb - ref[k]).abs()
            close = (diff <= 1e-3 + 1e-3 * ref[k].abs()).all(-1)
            assert close.float().mean() > 0.98
            assert abs(rgb.mean() - ref[k].mean()) < 2e-3


def test_reference_is_one_lane_per_pixel_and_pass(tiny_root):
    desc = load_scene("mesh_demo", 1.2, tiny_root)
    proj, view = camera.pose_matrices(16, 12)
    xs, ys = np.array([3, 7, 11]), np.array([2, 5, 9])
    both = render_samples(desc, proj, view, 16, 12, xs, ys, [1, 2],
                          nb_bounces=3, ior=1.0, date=0.0, device="cpu",
                          block=2)
    one = render_samples(desc, proj, view, 16, 12, xs[1:2], ys[1:2], [2],
                         nb_bounces=3, ior=1.0, date=0.0, device="cpu")
    assert both.shape == (2, 3, 3)
    assert torch.equal(both[1, 1], one[0, 0])
