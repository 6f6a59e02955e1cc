"""Synthetic EuRoC-geometry sequence, in memory or written to disk as
an EuRoC-layout dataset, and a player that drives the in-memory one
through the public API.

`render_sequence` is the frame renderer of
`xrslam_tpu/tools/make_dataset.py` (blob-textured grayscale frames of
a `wave_scene`), writing no files: it returns the uint8 frames, the
camera/IMU event streams with the timestamps a EuRoC reader of the
rendered dataset would produce, the ground truth, and the `Config`
that the dataset's YAML pair describes. `run_sequence` feeds those
events to `api.XRSLAM` in time order (the dataset player's loop) and
`ate` scores the output against the ground truth. `render_dataset`
(the counterpart of `xrslam_tpu/tools/make_dataset.py`) writes the same
frames, optional aligned depth images, the IMU and ground-truth CSVs and
the YAML pair to disk for `tools/run_dataset.py`:

  python -m xrslam_tpu_torch.tools.make_dataset /tmp/seq --frames 120 \
      --width 752 --height 480 --focal 458 --depth
  python -m xrslam_tpu_torch.tools.run_dataset euroc:///tmp/seq/mav0 \
      --slam-config /tmp/seq/slam.yaml --device-config /tmp/seq/device.yaml --gt
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

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


def _renderer(n_frames: int, n_landmarks: int, width: int, height: int,
              focal: float, seed: int, landmarks=None):
    """The wave scene and its frame renderer: `render(i, with_depth)`
    gives frame i as float [0,1] blob texture and, with depth, the
    (H,W) float32 z-depth of the blobs (0 where none; the nearest blob
    wins where they overlap)."""
    W, H, Fc = width, height, focal
    K = np.array([[Fc, 0, W / 2], [0, Fc, H / 2], [0, 0, 1.0]])
    q_bc, p_bc = camera_extrinsics()
    scene = euler_consistent(wave_scene(n_frames=n_frames,
                                        n_landmarks=n_landmarks, seed=seed,
                                        landmarks=landmarks))
    qs, ps = scene.q.numpy(), scene.p.numpy()
    lms = scene.landmarks.numpy()

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

    def render(i, with_depth=False):
        q_wc = nputil.quat_mul(qs[i], q_bc)
        p_wc = ps[i] + nputil.quat_rotate(qs[i], p_bc)
        R_cw = nputil.quat_to_matrix(nputil.quat_conj(q_wc))
        Xc = (R_cw @ (lms - p_wc).T).T
        vis = Xc[:, 2] > 0.3
        uv = (K @ (Xc[vis] / Xc[vis, 2:3]).T).T[:, :2]
        img = bg.copy()
        dep = np.zeros((H, W), dtype=np.float32)
        r = 7
        for (u, v), amp, z in zip(uv, amps[vis], Xc[vis, 2]):
            if u < -r or u >= W + r or v < -r or v >= H + r:
                continue
            x0, x1 = max(0, int(u) - r), min(W, int(u) + r + 1)
            y0, y1 = max(0, int(v) - r), min(H, int(v) + r + 1)
            xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            img[y0:y1, x0:x1] += amp * np.exp(
                -((xs - u) ** 2 + (ys - v) ** 2) / (2 * sig * sig))
            if with_depth:
                disc = ((xs - u) ** 2 + (ys - v) ** 2) <= (r - 2) ** 2
                blk = dep[y0:y1, x0:x1]
                blk[disc & ((blk == 0) | (blk > z))] = z
                dep[y0:y1, x0:x1] = blk
        return np.clip(img, 0, 1), dep

    return scene, render


def render_sequence(n_frames: int = 60, n_landmarks: int = 500,
                    width: int = 320, height: int = 240, focal: float = 260.0,
                    seed: int = 3, landmarks=None) -> dict:
    """Render the wave scene. Returns {images (F,H,W) uint8, t_cam (F,),
    imu_t (M,), imu_w (M,3), imu_a (M,3), gt_t (F,), gt_p (F,3),
    config}; times are in seconds on the dataset clock."""
    scene, render = _renderer(n_frames, n_landmarks, width, height, focal,
                              seed, landmarks)
    ts = scene.t.numpy()

    def clock(t_s):
        return np.array([float(T0_NS + int(round(t * 1e9))) * 1e-9 for t in t_s])

    it = scene.imu_t.numpy().reshape(-1)
    return {
        "images": np.stack([(render(i)[0] * 255).astype(np.uint8)
                            for i in range(n_frames)]),
        "t_cam": clock(ts),
        "imu_t": clock(it),
        "imu_w": scene.imu_w.numpy().reshape(-1, 3),
        "imu_a": scene.imu_a.numpy().reshape(-1, 3),
        "gt_t": clock(ts),
        "gt_p": scene.p.numpy().copy(),
        "config": sequence_config(width, height, focal),
    }


def render_dataset(out_dir: str, n_frames: int, n_landmarks: int,
                   width: int, height: int, focal: float, seed: int = 3,
                   with_depth: bool = False) -> dict:
    """Write the wave scene as an EuRoC-layout dataset under `out_dir`:
    mav0/cam0 (uint8 PNGs), with `with_depth` mav0/depth0 (uint16
    millimetre PNGs of the blobs' z-depth, 0 = no measurement), imu0,
    state_groundtruth_estimate0 (ns timestamps), and the slam/device
    YAML pair. PNGs are written by Pillow. Returns
    {root, slam_yaml, device_yaml}."""

    W, H, F = width, height, focal
    q_bc, p_bc = camera_extrinsics()
    scene, render = _renderer(n_frames, n_landmarks, W, H, F, seed)
    qs, ps = scene.q.numpy(), scene.p.numpy()
    ts = scene.t.numpy()

    root = os.path.join(out_dir, "mav0")
    os.makedirs(os.path.join(root, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(root, "state_groundtruth_estimate0"), exist_ok=True)
    if with_depth:
        os.makedirs(os.path.join(root, "depth0", "data"), exist_ok=True)
    cam_rows = ["#timestamp [ns],filename"]
    dep_rows = ["#timestamp [ns],filename"]
    for i in range(n_frames):
        tns = T0_NS + int(round(ts[i] * 1e9))
        fn = f"{tns}.png"
        img, dep = render(i, with_depth)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, "cam0", "data", fn))
        cam_rows.append(f"{tns},{fn}")
        if with_depth:
            Image.fromarray(np.clip(dep * 1000.0, 0, 65535).astype(np.uint16)).save(
                os.path.join(root, "depth0", "data", fn))
            dep_rows.append(f"{tns},{fn}")
    with open(os.path.join(root, "cam0", "data.csv"), "w") as f:
        f.write("\n".join(cam_rows) + "\n")
    if with_depth:
        with open(os.path.join(root, "depth0", "data.csv"), "w") as f:
            f.write("\n".join(dep_rows) + "\n")

    it = scene.imu_t.numpy()
    iw = scene.imu_w.numpy()
    ia = scene.imu_a.numpy()
    imu_rows = ["#timestamp [ns],wx,wy,wz,ax,ay,az"]
    for i in range(n_frames):
        for s in range(it.shape[1]):
            tns = T0_NS + int(round(it[i, s] * 1e9))
            w, a = iw[i, s], ia[i, s]
            imu_rows.append(f"{tns},{w[0]},{w[1]},{w[2]},{a[0]},{a[1]},{a[2]}")
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(imu_rows) + "\n")

    gt_rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i in range(n_frames):
        tns = T0_NS + int(round(ts[i] * 1e9))
        gt_rows.append(f"{tns},{ps[i,0]},{ps[i,1]},{ps[i,2]},"
                       f"{qs[i,0]},{qs[i,1]},{qs[i,2]},{qs[i,3]}")
    with open(os.path.join(root, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("\n".join(gt_rows) + "\n")

    device_yaml = os.path.join(out_dir, "device.yaml")
    with open(device_yaml, "w") as f:
        f.write(f"""%YAML:1.0
cam0:
  resolution: [{W}, {H}]
  intrinsics: [{F}, {F}, {W/2}, {H/2}]
  camera_distortion_flag: 0
  time_offset: 0.0
  extrinsic:
    q_bc: [{q_bc[1]}, {q_bc[2]}, {q_bc[3]}, {q_bc[0]}]
    p_bc: [{p_bc[0]}, {p_bc[1]}, {p_bc[2]}]
  noise: [0.25, 0.0, 0.0, 0.25]
imu:
  extrinsic:
    q_bi: [0.0, 0.0, 0.0, 1.0]
    p_bi: [0.0, 0.0, 0.0]
  noise:
    cov_g: [1.0e-6, 0.0, 0.0, 0.0, 1.0e-6, 0.0, 0.0, 0.0, 1.0e-6]
    cov_a: [1.0e-4, 0.0, 0.0, 0.0, 1.0e-4, 0.0, 0.0, 0.0, 1.0e-4]
    cov_bg: [1.0e-10, 0.0, 0.0, 0.0, 1.0e-10, 0.0, 0.0, 0.0, 1.0e-10]
    cov_ba: [1.0e-8, 0.0, 0.0, 0.0, 1.0e-8, 0.0, 0.0, 0.0, 1.0e-8]
""")
    slam_yaml = os.path.join(out_dir, "slam.yaml")
    with open(slam_yaml, "w") as f:
        f.write("""%YAML:1.0
sliding_window:
  size: 10
  subframe_size: 3
  force_keyframe_landmarks: 20
feature_tracker:
  min_keypoint_distance: 15.0
  max_keypoint_detection: 120
initializer:
  keyframe_num: 8
  keyframe_gap: 3
  min_matches: 30
  min_parallax: 5.0
  min_triangulation: 25
  min_landmarks: 18
solver:
  iteration_limit: 10
""")
    return {"root": root, "slam_yaml": slam_yaml, "device_yaml": device_yaml}


def events(seq: dict):
    """Time-ordered (t, kind, index) events; at equal times camera, then
    gyroscope, then accelerometer (the dataset reader's stable sort)."""
    ev = ([(t, 0, i) for i, t in enumerate(seq["t_cam"])]
          + [(t, 1, i) for i, t in enumerate(seq["imu_t"])]
          + [(t, 2, i) for i, t in enumerate(seq["imu_t"])])
    ev.sort(key=lambda e: (e[0], e[1]))
    return ev


def run_sequence(api_module, slam, seq: dict, max_frames=None, on_frame=None,
                 start: int = 0, stop=None):
    """Feed `seq` to an XRSLAM instance `slam` of `api_module` (the
    port's api, or any module with the same SensorType/ResultType/State
    surface): the events from frame `start`'s image up to, not
    including, frame `stop`'s (to the end without `stop`), and at most
    `max_frames` images. Returns (ts, ps (N,3)) of the tracked frames'
    body poses. `on_frame(i, slam)` runs after each frame."""
    A = api_module
    ts, ps = [], []
    n_img = 0
    lo = (seq["t_cam"][start], 0)
    hi = None if stop is None or stop >= len(seq["t_cam"]) else (seq["t_cam"][stop], 0)
    for t, kind, i in events(seq):
        if (t, kind) < lo:
            continue
        if hi is not None and (t, kind) >= hi:
            break
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


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write the wave scene as an "
                                 "EuRoC-layout dataset")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--landmarks", type=int, default=500)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--focal", type=float, default=458.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--depth", action="store_true",
                    help="also write aligned depth images (mav0/depth0)")
    args = ap.parse_args(argv)
    print(render_dataset(args.out_dir, n_frames=args.frames, n_landmarks=args.landmarks,
                         width=args.width, height=args.height, focal=args.focal,
                         seed=args.seed, with_depth=args.depth))


if __name__ == "__main__":
    main()
