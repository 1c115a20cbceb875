"""The port's camera against the JAX package's.

Matrices are numpy on both sides and must be equal. Rays and texture
coordinates go through the same float32 ops in another framework, so
they agree to 1e-6 (a few ulps of unit-length vectors); the origin is a
numpy value on both sides and must be exact.
"""
import numpy as np
import pytest
import torch

from montecarlo_pathtracing_tpu.render import camera as jcam
from montecarlo_pathtracing_tpu_torch.render import camera as cam


@pytest.mark.parametrize("w,h,kw", [
    (24, 18, {}),
    (64, 48, dict(yaw=30.0, pitch=10.0, zoom=0.7)),
    (800, 600, {}),
    (37, 53, dict(center=(5.0, -3.0, 2.0), radius=90.0)),
])
def test_camera_rays_match_jax(w, h, kw):
    jproj, jview = jcam.default_rt_camera(w, h, **kw)
    proj, view = cam.default_rt_camera(w, h, **kw)
    np.testing.assert_array_equal(proj, jproj)
    np.testing.assert_array_equal(view, jview)
    jo, jd, jtc = jcam.camera_rays(jproj, jview, w, h)
    o, d, tc = cam.camera_rays(proj, view, w, h, device="cpu")
    assert o.dtype == d.dtype == tc.dtype == torch.float32
    assert tuple(d.shape) == (h, w, 3) and tuple(tc.shape) == (h, w, 2)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jtc), rtol=0,
                               atol=1e-6)


def test_ortho_and_camera_matrices_match_jax():
    for aspect in (0.5, 1.0, 1.7):
        np.testing.assert_array_equal(cam.ortho(aspect, 0.1, 50.0),
                                      jcam.ortho(aspect, 0.1, 50.0))
        c = cam.Camera(scene_radius=30.0, aspect=aspect,
                       perspective_mode=False)
        jc = jcam.Camera(scene_radius=30.0, aspect=aspect,
                         perspective_mode=False)
        np.testing.assert_array_equal(c.projection_matrix(),
                                      jc.projection_matrix())
        np.testing.assert_array_equal(c.view_matrix(), jc.view_matrix())
