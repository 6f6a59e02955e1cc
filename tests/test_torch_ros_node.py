"""The port's ROS node adapter (`xrslam_tpu_torch.tools.ros_node`) on
the CPU, without a ROS master: both tests of tests/test_ros_node.py
(images wait until the IMU stream passes them, reference
xrslam-ros/src/xrslam-ros/src/xrslam_node.cpp:95-130; undistortion at
ingest), and the undistorted image against the JAX package's
`RosVioNode` within 1e-6 (both remap through native/xr_host.cpp)."""

import numpy as np
import pytest
import torch

from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.tools.ros_node import RosVioNode as JRosVioNode
from xrslam_tpu_torch import native
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.tools.ros_node import RosVioNode


def test_image_buffers_until_imu_catches_up():
    n = RosVioNode(Config(), device="cpu")
    img = np.zeros((48, 64), np.float32)

    n.handle_image(0.05, img)
    assert len(n._pending_images) == 1  # no IMU yet

    for i in range(8):  # IMU up to 0.035 < image time
        n.handle_imu(0.005 * i, np.zeros(3), np.array([0, 0, 9.81]))
    assert len(n._pending_images) == 1

    for i in range(8, 14):  # IMU passes the image timestamp
        n.handle_imu(0.005 * i, np.zeros(3), np.array([0, 0, 9.81]))
    assert len(n._pending_images) == 0

    # out-of-order-safe: a second image arrives before its IMU
    n.handle_image(0.1, img)
    assert len(n._pending_images) == 1
    for i in range(14, 22):
        n.handle_imu(0.005 * i, np.zeros(3), np.array([0, 0, 9.81]))
    assert len(n._pending_images) == 0


def _distorted(cls):
    return cls(
        camera_intrinsic=np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]]),
        camera_resolution=(64, 48),
        camera_distortion_flag=True,
        camera_distortion=np.array([-0.2, 0.05, 0.0, 0.0]),
    )


def _ingest(node, img):
    published = []
    node.slam.push_sensor_data = lambda ty, t, d: published.append((ty, d))
    node.slam.run_one_frame = lambda: None
    node.handle_imu(0.0, np.zeros(3), np.array([0, 0, 9.81]))
    node.handle_image(-0.01, img)
    return [d for ty, d in published if getattr(ty, "name", "") == "CAMERA"]


def test_undistortion_applied_at_ingest():
    n = RosVioNode(_distorted(Config), device="cpu")
    assert n._undistort is not None
    rng = np.random.default_rng(0)
    before = native.CALLS["remap_bilinear"]
    cam = _ingest(n, rng.uniform(0, 1, (48, 64)).astype(np.float32))
    assert len(cam) == 1 and cam[0].shape == (48, 64)
    assert native.CALLS["remap_bilinear"] == before + 1


def test_undistorted_image_matches_jax():
    img = np.random.default_rng(0).uniform(0, 1, (48, 64)).astype(np.float32)
    out = _ingest(RosVioNode(_distorted(Config), device="cpu"), img)
    ref = _ingest(JRosVioNode(_distorted(JConfig)), img)
    assert len(out) == len(ref) == 1
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-6)


def test_node_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        RosVioNode(Config())
