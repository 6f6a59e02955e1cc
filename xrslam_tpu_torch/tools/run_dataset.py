"""Dataset player CLI (port of `xrslam_tpu/tools/run_dataset.py`):
drives the pipeline over a EuRoC/TUM-VI sequence through the public
API, writes a TUM trajectory and evaluates ATE against the sequence's
ground truth. Runs on the card unless `--device cpu` is given.

Usage:
  python -m xrslam_tpu_torch.tools.run_dataset euroc:///data/MH_01_easy/mav0 \
      --slam-config configs/euroc_slam.yaml \
      --device-config configs/euroc_sensor.yaml \
      --tum out.tum --gt  # --gt reads mav0/state_groundtruth_estimate0

It prints one JSON line: frames_tracked, fps, ate_rmse_m (with --gt)
and the per-stage mean times in seconds (`timings`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import api
from ..config import Config, load_config
from ..eval import trajectory as traj
from ..io.dataset import DataType, create_reader, load_euroc_groundtruth
from ..utils import inspection


def run_sequence(uri: str, config: Config, tum_out=None, max_frames=None,
                 async_reader: bool = True, progress: bool = False,
                 device="cuda", on_frame=None):
    """Returns (ts, qs (N,4)[w,x,y,z], ps (N,3), slam): the body pose
    after each camera frame while tracking, and the engine, into whose
    `times` the reader records its times too. `on_frame(n, slam)` runs
    after the n-th frame (from 1)."""
    slam = api.XRSLAM(config=config, device=device)
    reader = create_reader(uri, config, async_=async_reader, times=slam.times)
    ts, qs, ps = [], [], []
    n_img = 0
    t_start = time.perf_counter()
    while (kind := reader.next()) != DataType.END:
        if kind == DataType.GYROSCOPE:
            t, w = reader.read_gyroscope()
            slam.push_sensor_data(api.SensorType.GYROSCOPE, t, w)
        elif kind == DataType.ACCELEROMETER:
            t, a = reader.read_accelerometer()
            slam.push_sensor_data(api.SensorType.ACCELERATION, t, a)
        elif kind == DataType.DEPTH:
            t, d = reader.read_depth()
            slam.push_sensor_data(api.SensorType.DEPTH_CAMERA, t, d)
        else:
            t, img = reader.read_image()
            slam.push_sensor_data(api.SensorType.CAMERA, t, img)
            with slam.times.stage("run_one_frame_time"):
                slam.run_one_frame()
            n_img += 1
            if slam.get_result(api.ResultType.STATE) == api.State.TRACKING_SUCCESS:
                pose = slam.get_result(api.ResultType.BODY_POSE)
                x, y, z, w_ = pose.quaternion
                ts.append(pose.timestamp)
                qs.append([w_, x, y, z])
                ps.append(pose.translation)
            if on_frame is not None:
                on_frame(n_img, slam)
            if progress and n_img % 50 == 0:
                el = time.perf_counter() - t_start
                print(f"[{n_img}] {slam.pipeline.state} {n_img / el:.1f} img/s",
                      file=sys.stderr)
            if max_frames and n_img >= max_frames:
                break
    slam.flush()
    fps = n_img / max(time.perf_counter() - t_start, 1e-9)
    inspection.inspect(inspection.FEATURE_TRACKER_FPS, fps)
    ts, qs, ps = np.asarray(ts), np.asarray(qs).reshape(-1, 4), np.asarray(ps).reshape(-1, 3)
    if tum_out and len(ts):
        traj.write_tum(tum_out, ts, qs, ps)
    return ts, qs, ps, slam


def evaluate_ate(seq_path: str, ts, ps) -> float:
    gt_t, gt_p, _ = load_euroc_groundtruth(seq_path)
    ia, ib = traj.associate(ts, gt_t)
    if len(ia) < 10:
        return float("nan")
    return traj.ate_rmse(ps[ia], gt_p[ib])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", help="euroc://PATH or tum://PATH")
    ap.add_argument("--slam-config")
    ap.add_argument("--device-config")
    ap.add_argument("--tum", help="TUM trajectory output path")
    ap.add_argument("--gt", action="store_true",
                    help="evaluate ATE vs EuRoC ground truth")
    ap.add_argument("--max-frames", type=int)
    ap.add_argument("--sync", action="store_true",
                    help="disable the async reader thread")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)

    if args.slam_config and args.device_config:
        config = load_config(args.slam_config, args.device_config)
    else:
        config = Config()
    ts, qs, ps, slam = run_sequence(args.dataset, config, tum_out=args.tum,
                                    max_frames=args.max_frames,
                                    async_reader=not args.sync, progress=True,
                                    device=args.device)
    out = {"frames_tracked": len(ts),
           "fps": inspection.inspect_get(inspection.FEATURE_TRACKER_FPS),
           "timings": slam.times.means()}
    if args.gt and len(ts):
        out["ate_rmse_m"] = evaluate_ate(args.dataset.split("://", 1)[-1], ts, ps)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
