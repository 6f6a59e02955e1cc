"""`xrslam_tpu_torch.geometry.camera` against `xrslam_tpu.geometry.camera`
on seeded float64 inputs: projection, bearings, the projection
Jacobian and radial-tangential (un)distortion, to 1e-12 (the same
formulas; rounding only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.geometry import camera as jcam
from xrslam_tpu_torch.geometry import camera

T = torch.as_tensor
K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]])
# EuRoC cam0's k1, k2, p1, p2, and the same with a k3 term
DISTORTIONS = [np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]),
               np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.01])]


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_projection_and_jacobian_match():
    rng = np.random.default_rng(0)
    p = rng.uniform([-2, -2, 0.5], [2, 2, 8], (5, 7, 3))
    _close(camera.apply_k(T(p), T(K)), jcam.apply_k(jnp.asarray(p), jnp.asarray(K)))
    uv = rng.uniform([0, 0], [752, 480], (64, 2))
    _close(camera.remove_k(T(uv), T(K)), jcam.remove_k(jnp.asarray(uv), jnp.asarray(K)))
    _close(camera.dproj_dp(T(p)), jcam.dproj_dp(jnp.asarray(p)))


@pytest.mark.parametrize("dist", DISTORTIONS, ids=["k1k2p1p2", "k3"])
def test_distortion_round_trip_matches(dist):
    rng = np.random.default_rng(1)
    xn = rng.uniform(-0.6, 0.6, (200, 2))
    xd = camera.distort_radtan(T(xn), T(dist))
    _close(xd, jcam.distort_radtan(jnp.asarray(xn), jnp.asarray(dist)))
    xu = camera.undistort_radtan(xd, T(dist))
    _close(xu, jcam.undistort_radtan(jnp.asarray(xd.numpy()), jnp.asarray(dist)))
    assert np.abs(xu.numpy() - xn).max() < 1e-3
    uv = rng.uniform([0, 0], [752, 480], (100, 2))
    _close(camera.undistort_pixels(T(uv), T(K), T(dist)),
           jcam.undistort_pixels(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(dist)))
