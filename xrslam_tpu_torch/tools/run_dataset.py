"""Dataset player CLI (port of `xrslam_tpu/tools/run_dataset.py`):
drives the pipeline over a EuRoC/TUM-VI sequence through the public
API, writes a TUM trajectory and evaluates ATE against the sequence's
ground truth. Runs on the card unless `--device cpu` is given.

Usage:
  python -m xrslam_tpu_torch.tools.run_dataset euroc:///data/MH_01_easy/mav0 \
      --slam-config configs/euroc_slam.yaml \
      --device-config configs/euroc_sensor.yaml \
      --tum out.tum --gt  # --gt reads mav0/state_groundtruth_estimate0

It prints one JSON line: frames_tracked, frames_processed (by the
tracker; a frame waits for the IMU stream to pass it), fps, ate_rmse_m
(with --gt),
the per-stage mean times in seconds (`timings`) and, with `--viz DIR`,
the number of overlay PNGs written there (`overlays`; the trajectory
plot is `DIR/trajectory.png`). `--live PORT` serves the live viewer.
"""

from __future__ import annotations

import argparse
import json
import os
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
                 device="cuda", on_frame=None, viewer=None, latency=None):
    """Returns (ts, qs (N,4)[w,x,y,z], ps (N,3), slam): the body pose
    after each camera frame while tracking, and the engine, into whose
    `times` the reader records its times too. `on_frame(n, slam)` runs
    after the n-th frame (from 1). `viewer`: an optional
    `live_viewer.LiveViewer` to publish poses, landmarks and stats to.
    `latency`: an optional list that receives, for each processed frame,
    the host seconds from its image push to the end of the push that
    processed it (a frame waits for the IMU stream to pass it, and its
    processing ends in a host read of its pose)."""
    slam = api.XRSLAM(config=config, device=device)
    reader = create_reader(uri, config, async_=async_reader, times=slam.times)
    ts, qs, ps = [], [], []
    n_img = 0
    pushed = []
    t_start = time.perf_counter()

    def note_processed():
        done = slam.pipeline.frames_processed
        if latency is not None and done > len(latency):
            now = time.perf_counter()
            latency.extend(now - t for t in pushed[len(latency):done])

    while (kind := reader.next()) != DataType.END:
        if kind == DataType.GYROSCOPE:
            t, w = reader.read_gyroscope()
            slam.push_sensor_data(api.SensorType.GYROSCOPE, t, w)
            note_processed()
        elif kind == DataType.ACCELEROMETER:
            t, a = reader.read_accelerometer()
            slam.push_sensor_data(api.SensorType.ACCELERATION, t, a)
            note_processed()
        elif kind == DataType.DEPTH:
            t, d = reader.read_depth()
            slam.push_sensor_data(api.SensorType.DEPTH_CAMERA, t, d)
        else:
            t, img = reader.read_image()
            pushed.append(time.perf_counter())
            slam.push_sensor_data(api.SensorType.CAMERA, t, img)
            with slam.times.stage("run_one_frame_time"):
                slam.run_one_frame()
            note_processed()
            n_img += 1
            state = slam.get_result(api.ResultType.STATE)
            if state == api.State.TRACKING_SUCCESS:
                pose = slam.get_result(api.ResultType.BODY_POSE)
                x, y, z, w_ = pose.quaternion
                ts.append(pose.timestamp)
                qs.append([w_, x, y, z])
                ps.append(pose.translation)
                if viewer is not None:
                    lms = slam.get_result(api.ResultType.LANDMARKS)
                    viewer.publish(
                        pose_q=qs[-1], pose_p=ps[-1], landmarks=lms,
                        stats={"frame": n_img,
                               "fps": n_img / max(time.perf_counter() - t_start, 1e-9),
                               "landmarks": len(lms)})
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
    ap.add_argument("--viz", metavar="DIR",
                    help="write per-frame keypoint overlays + a "
                         "trajectory plot into DIR")
    ap.add_argument("--live", metavar="PORT", type=int,
                    help="serve the interactive live viewer (trajectory/"
                         "landmarks/frustum/feature overlay) on PORT")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)

    if args.slam_config and args.device_config:
        config = load_config(args.slam_config, args.device_config)
    else:
        config = Config()

    writer = None
    if args.viz:
        from .viz import OverlayWriter

        writer = OverlayWriter(args.viz)
    viewer = None
    if args.live is not None:
        from .live_viewer import LiveViewer

        viewer = LiveViewer(port=args.live)
        print(f"live viewer: {viewer.url}", file=sys.stderr)
    try:
        ts, qs, ps, slam = run_sequence(args.dataset, config, tum_out=args.tum,
                                        max_frames=args.max_frames,
                                        async_reader=not args.sync, progress=True,
                                        device=args.device, viewer=viewer)
    finally:
        if writer is not None:
            writer.close()
        if viewer is not None:
            viewer.close()
    out = {"frames_tracked": len(ts),
           "frames_processed": slam.pipeline.frames_processed,
           "fps": inspection.inspect_get(inspection.FEATURE_TRACKER_FPS),
           "timings": slam.times.means()}
    gt_p = None
    if args.gt and len(ts):
        seq = args.dataset.split("://", 1)[-1]
        out["ate_rmse_m"] = evaluate_ate(seq, ts, ps)
        _, gt_p, _ = load_euroc_groundtruth(seq)
    if writer is not None:
        out["overlays"] = writer.written
        if len(ts):
            from .viz import plot_trajectory

            plot_trajectory(os.path.join(args.viz, "trajectory.png"), ps, gt_p)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
