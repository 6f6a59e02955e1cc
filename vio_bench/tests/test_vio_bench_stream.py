"""The traffic generator: the same seed gives the same stream, another
seed another landmark field and texture over the same trajectory."""

import numpy as np
import pytest
from types import SimpleNamespace

from vio_bench import stream

CAM = SimpleNamespace(camera_resolution=(160, 120),
                      camera_intrinsic=np.array([[130.0, 0, 80], [0, 130.0, 60], [0, 0, 1]]))


@pytest.fixture(scope="module")
def traffic():
    return stream.load_traffic("stream1")


def test_same_seed_same_stream(traffic):
    a = stream.make_stream(traffic, CAM, 2**31 + 17, 12, "cpu")
    b = stream.make_stream(traffic, CAM, 2**31 + 17, 12, "cpu")
    for k in ("images", "t_cam", "imu_t", "imu_w", "imu_a", "gt_q", "gt_p", "landmarks"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.images.dtype == np.uint8 and a.images.shape == (12, 120, 160)


def test_other_seed_other_field_same_trajectory(traffic):
    a = stream.make_stream(traffic, CAM, 5, 12, "cpu")
    b = stream.make_stream(traffic, CAM, 6, 12, "cpu")
    assert not np.allclose(a.landmarks, b.landmarks)
    assert (a.images != b.images).mean() > 0.5
    assert np.array_equal(a.gt_p, b.gt_p) and np.array_equal(a.imu_a, b.imu_a)
    # the shell the field is drawn in
    r = np.linalg.norm(a.landmarks[:, :2], axis=1)
    assert r.min() >= 0.2 * 3.0 and r.max() <= 0.8 * 3.0
    assert a.landmarks[:, 2].min() >= -0.5 and a.landmarks[:, 2].max() <= 3.0


def test_ground_truth_is_the_dead_reckoned_imu(traffic):
    """The frame states follow from the IMU by the Euler scheme: frame 1
    again from frame 0 and the samples between them."""
    s = stream.make_stream(traffic, CAM, 1, 3, "cpu")
    S = s.samples_per_frame
    q, p = s.gt_q[0], s.gt_p[0]
    import torch
    from vio_bench import geom
    t = torch.from_numpy
    # velocity at frame 0 from the analytic trajectory
    _, _, _, v_a, imu_t, w, a = stream._trajectory(traffic, 3)
    v = v_a[0].numpy()
    dq, dp, dv = t(np.array([1.0, 0, 0, 0])), t(np.zeros(3)), t(np.zeros(3))
    ts = list(s.imu_t[:S]) + [s.t_cam[1]]
    for k in range(S):
        dt = ts[k + 1] - ts[k]
        aw = geom.rotate(dq, t(s.imu_a[k]))
        dp = dp + dt * dv + 0.5 * dt * dt * aw
        dv = dv + dt * aw
        dq = geom.qnormalize(geom.qmul(dq, geom.expmap(t(s.imu_w[k]) * dt)))
    T = s.t_cam[1] - s.t_cam[0]
    g = np.array([0, 0, -stream.GRAVITY])
    p1 = p + 0.5 * g * T * T + v * T + geom.rotate(t(q), dp).numpy()
    assert np.abs(p1 - s.gt_p[1]).max() < 1e-12


def test_blob_centres_are_the_projections(traffic):
    s = stream.make_stream(traffic, CAM, 3, 2, "cpu")
    drawn = np.isfinite(s.blob_uv[0, :, 0])
    assert drawn.sum() > 50
    u, v = s.blob_uv[0, drawn].T
    assert ((u >= -7) & (u < 167) & (v >= -7) & (v < 127)).all()


@pytest.mark.parametrize("key, value", [("streams", 4), ("loop", "open")])
def test_a_mix_the_driver_does_not_implement_is_refused(monkeypatch, traffic, key, value):
    import time

    from vio_bench import run

    monkeypatch.setattr(stream, "load_traffic", lambda name: dict(traffic, **{key: value}))
    bench = run.load_benchmark()
    cell = bench["workloads"][0]
    with pytest.raises(run.RunError, match=f"traffic {cell['traffic']} sets {key}="):
        run.run_cell(bench, cell, 1, 1.0, False, "cpu", time.perf_counter(), n_frames=4)
