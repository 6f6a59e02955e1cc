"""Synthetic EuRoC-geometry sequence in memory, and a player that drives
it through the public API.

`render_sequence` is the frame renderer of
`xrslam_tpu/tools/make_dataset.py` (blob-textured grayscale frames of
a `wave_scene`), writing no files: it returns the uint8 frames, the
camera/IMU event streams with the timestamps a EuRoC reader of the
rendered dataset would produce, the ground truth, and the `Config`
that the dataset's YAML pair describes. `run_sequence` feeds those
events to `api.XRSLAM` in time order (the dataset player's loop) and
`ate` scores the output against the ground truth.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..core import nputil
from ..eval import trajectory as traj
from ..geometry import lie
from ..io.synthetic import euler_consistent, wave_scene

T0_NS = 1_500_000_000_000_000_000  # dataset epoch of the rendered sequence


def camera_extrinsics():
    """(q_bc [w,x,y,z], p_bc) of the rendered rig: optical axis along
    body +y, small lever arm."""
    q_bc = lie.expmap(torch.tensor([-np.pi / 2, 0.0, 0.0],
                                   dtype=torch.float64)).numpy()
    return q_bc, np.array([0.02, -0.01, 0.03])


def sequence_config(width: int, height: int, focal: float) -> Config:
    """The Config the rendered dataset's slam/device YAML pair loads to."""
    q_bc, p_bc = camera_extrinsics()
    return Config(
        camera_intrinsic=np.array([[focal, 0, width / 2], [0, focal, height / 2],
                                   [0, 0, 1.0]]),
        camera_resolution=(width, height),
        camera_to_body_rotation=q_bc, camera_to_body_translation=p_bc,
        keypoint_noise_cov=np.array([[0.25, 0.0], [0.0, 0.25]]),
        gyroscope_noise_cov=1.0e-6 * np.eye(3),
        accelerometer_noise_cov=1.0e-4 * np.eye(3),
        gyroscope_bias_noise_cov=1.0e-10 * np.eye(3),
        accelerometer_bias_noise_cov=1.0e-8 * np.eye(3),
        sliding_window_size=10, sliding_window_subframe_size=3,
        sliding_window_force_keyframe_landmarks=20,
        feature_tracker_min_keypoint_distance=15.0,
        feature_tracker_max_keypoint_detection=120,
        initializer_keyframe_num=8, initializer_keyframe_gap=3,
        initializer_min_matches=30, initializer_min_parallax=5.0,
        initializer_min_triangulation=25, initializer_min_landmarks=18,
        solver_iteration_limit=10)


def render_sequence(n_frames: int = 60, n_landmarks: int = 500,
                    width: int = 320, height: int = 240, focal: float = 260.0,
                    seed: int = 3, landmarks=None) -> dict:
    """Render the wave scene. Returns {images (F,H,W) uint8, t_cam (F,),
    imu_t (M,), imu_w (M,3), imu_a (M,3), gt_t (F,), gt_p (F,3),
    config}; times are in seconds on the dataset clock."""
    W, H, Fc = width, height, focal
    K = np.array([[Fc, 0, W / 2], [0, Fc, H / 2], [0, 0, 1.0]])
    q_bc, p_bc = camera_extrinsics()
    scene = euler_consistent(wave_scene(n_frames=n_frames,
                                        n_landmarks=n_landmarks, seed=seed,
                                        landmarks=landmarks))
    qs, ps = scene.q.numpy(), scene.p.numpy()
    lms = scene.landmarks.numpy()
    ts = scene.t.numpy()

    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.35, 0.75, n_landmarks) * rng.choice([-1.0, 1.0],
                                                             n_landmarks)
    sig = 2.2
    bg = rng.uniform(0, 1, (H // 8 + 1, W // 8 + 1))
    bg = np.kron(bg, np.ones((8, 8)))[:H, :W]
    k = np.ones(13) / 13.0
    for _ in range(3):
        bg = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, bg)
        bg = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, bg)
    bg = bg * 0.06 + 0.45

    def render(i):
        q_wc = nputil.quat_mul(qs[i], q_bc)
        p_wc = ps[i] + nputil.quat_rotate(qs[i], p_bc)
        R_cw = nputil.quat_to_matrix(nputil.quat_conj(q_wc))
        Xc = (R_cw @ (lms - p_wc).T).T
        vis = Xc[:, 2] > 0.3
        uv = (K @ (Xc[vis] / Xc[vis, 2:3]).T).T[:, :2]
        img = bg.copy()
        r = 7
        for (u, v), amp in zip(uv, amps[vis]):
            if u < -r or u >= W + r or v < -r or v >= H + r:
                continue
            x0, x1 = max(0, int(u) - r), min(W, int(u) + r + 1)
            y0, y1 = max(0, int(v) - r), min(H, int(v) + r + 1)
            xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            img[y0:y1, x0:x1] += amp * np.exp(
                -((xs - u) ** 2 + (ys - v) ** 2) / (2 * sig * sig))
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def clock(t_s):
        return np.array([float(T0_NS + int(round(t * 1e9))) * 1e-9 for t in t_s])

    it = scene.imu_t.numpy().reshape(-1)
    return {
        "images": np.stack([render(i) for i in range(n_frames)]),
        "t_cam": clock(ts),
        "imu_t": clock(it),
        "imu_w": scene.imu_w.numpy().reshape(-1, 3),
        "imu_a": scene.imu_a.numpy().reshape(-1, 3),
        "gt_t": clock(ts),
        "gt_p": ps.copy(),
        "config": sequence_config(W, H, Fc),
    }


def events(seq: dict):
    """Time-ordered (t, kind, index) events; at equal times camera, then
    gyroscope, then accelerometer (the dataset reader's stable sort)."""
    ev = ([(t, 0, i) for i, t in enumerate(seq["t_cam"])]
          + [(t, 1, i) for i, t in enumerate(seq["imu_t"])]
          + [(t, 2, i) for i, t in enumerate(seq["imu_t"])])
    ev.sort(key=lambda e: (e[0], e[1]))
    return ev


def run_sequence(api_module, slam, seq: dict, max_frames=None, on_frame=None):
    """Feed `seq` to an XRSLAM instance `slam` of `api_module` (the
    port's api, or any module with the same SensorType/ResultType/State
    surface). Returns (ts, ps (N,3)) of the tracked frames' body poses.
    `on_frame(i, slam)` runs after each frame."""
    A = api_module
    ts, ps = [], []
    n_img = 0
    for t, kind, i in events(seq):
        if kind == 1:
            slam.push_sensor_data(A.SensorType.GYROSCOPE, t, seq["imu_w"][i])
        elif kind == 2:
            slam.push_sensor_data(A.SensorType.ACCELERATION, t, seq["imu_a"][i])
        else:
            img = seq["images"][i].astype(np.float32) / 255.0
            slam.push_sensor_data(A.SensorType.CAMERA, t, img)
            slam.run_one_frame()
            n_img += 1
            if slam.get_result(A.ResultType.STATE) == A.State.TRACKING_SUCCESS:
                pose = slam.get_result(A.ResultType.BODY_POSE)
                ts.append(pose.timestamp)
                ps.append(pose.translation)
            if on_frame is not None:
                on_frame(i, slam)
            if max_frames and n_img >= max_frames:
                break
    slam.flush()
    return np.asarray(ts), np.asarray(ps).reshape(-1, 3)


def ate(seq: dict, ts, ps) -> float:
    """ATE RMSE (m) after SE3 alignment against the ground truth."""
    ia, ib = traj.associate(ts, seq["gt_t"])
    if len(ia) < 10:
        return float("nan")
    return traj.ate_rmse(ps[ia], seq["gt_p"][ib])


def timed_run(slam, seq: dict, device, max_frames=None) -> dict:
    """Drive the port on `seq` (its first `max_frames` frames) and
    report frames tracked, ATE, frames/s (host clock, ending in a device
    sync) and the per-stage means."""
    from .. import api

    t0 = time.perf_counter()
    ts, ps = run_sequence(api, slam, seq, max_frames=max_frames)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = min(len(seq["t_cam"]), max_frames or len(seq["t_cam"]))
    return {"frames": n, "frames_tracked": len(ts),
            "ate_m": ate(seq, ts, ps), "seconds": dt,
            "frames_per_s": n / dt,
            "stage_ms": {k: v * 1e3 for k, v in sorted(slam.times.means().items())}}
