"""Public API (port of `xrslam_tpu/api.py`): push IMU, camera and
aligned depth samples, run one frame, query the body/camera pose,
tracking state, landmarks, keypoints, IMU biases, intrinsics and
version. Quaternions cross this API in the C ABI's [x,y,z,w] order.

Both the class-based interface (`XRSLAM`) and the module-level
singleton functions (`create`/`push_sensor_data`/`run_one_frame`/
`get_result`/`destroy`) are provided; both run on the card unless
`device="cpu"` is asked for.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import __version__
from .config import Config, load_config
from .core import nputil
from .core.detail import VIOPipeline, compute_device
from .frontend.tracker import KLTFeatureTracker
from .utils import inspection
from .utils.timing import StageTimes


class SensorType(enum.IntEnum):
    CAMERA = 0
    DEPTH_CAMERA = 1
    ACCELERATION = 2
    GYROSCOPE = 3
    GRAVITY = 4
    ROTATION_VECTOR = 5
    UNKNOWN = 6


class ResultType(enum.IntEnum):
    BODY_POSE = 0
    CAMERA_POSE = 1
    STATE = 2
    LANDMARKS = 3
    FEATURES = 4
    BIAS = 5
    DEBUG_LOGS = 6
    VERSION = 7
    UNKNOWN = 8
    INTRINSICS = 9


class State(enum.IntEnum):
    INITIALIZING = 0
    TRACKING_SUCCESS = 1
    TRACKING_FAIL = 2


@dataclass
class Pose:
    """quaternion in the C ABI's [x,y,z,w] order."""
    timestamp: float = 0.0
    quaternion: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class IMUBias:
    acc_bias: np.ndarray = field(default_factory=lambda: np.zeros(3))
    gyr_bias: np.ndarray = field(default_factory=lambda: np.zeros(3))


class XRSLAM:
    """One VIO engine instance on `device`, a torch device. It runs on
    the card ("cuda") unless the caller asks for "cpu"; without a CUDA
    device the default raises, nothing falls back to the CPU."""

    def __init__(self, slam_config_path: Optional[str] = None,
                 device_config_path: Optional[str] = None,
                 config: Optional[Config] = None, *, device="cuda",
                 capacity: int = 256):
        device = compute_device(device)
        if config is None:
            if slam_config_path and device_config_path:
                config = load_config(slam_config_path, device_config_path)
            else:
                config = Config()
        self.config = config
        self.device = device
        self.times = StageTimes()
        self.pipeline = VIOPipeline(
            config, KLTFeatureTracker(config, self.device, capacity=capacity,
                                      times=self.times),
            self.device, times=self.times)
        self._cur_image: Optional[tuple] = None
        self._cur_depth: Optional[tuple] = None
        self._last_output = None

    def push_sensor_data(self, sensor_type: SensorType, timestamp: float,
                         data) -> None:
        if sensor_type == SensorType.CAMERA:
            self._cur_image = (float(timestamp), np.asarray(data))
        elif sensor_type == SensorType.DEPTH_CAMERA:
            # aligned depth image: (H,W) float32 metres, or uint16
            # millimetres, 0 = invalid; paired with the camera frame of
            # the same time in run_one_frame
            d = np.asarray(data)
            if d.dtype == np.uint16:
                d = d.astype(np.float32) / 1000.0
            self._cur_depth = (float(timestamp), d)
        elif sensor_type == SensorType.GYROSCOPE:
            self._note_output(self.pipeline.track_gyroscope(float(timestamp), data))
        elif sensor_type == SensorType.ACCELERATION:
            self._note_output(self.pipeline.track_accelerometer(float(timestamp), data))
        else:
            raise ValueError(f"unsupported sensor type {sensor_type!r}")

    def _note_output(self, out):
        if out is not None:
            self._last_output = out

    def run_one_frame(self) -> None:
        if self._cur_image is None:
            raise RuntimeError("push a CAMERA sample before run_one_frame")
        t, img = self._cur_image
        self._cur_image = None
        depth = None
        if self._cur_depth is not None:
            td, d = self._cur_depth
            if abs(td - t) < 0.02:  # within ~half a 20 Hz frame period
                depth = d
                self._cur_depth = None
            elif td <= t:
                self._cur_depth = None  # stale: its frame has gone by
            # else the depth stream leads: hold it for its frame
        self.pipeline.track_camera_image(t, img, depth=depth)
        self._note_output(self.pipeline.predict_pose(self.pipeline.last_imu_t))

    def flush(self) -> None:
        """Complete the deferred work at the end of a stream: the last
        frame's tracking, backend stage and write-back."""
        self.pipeline.flush()

    def get_result(self, result_type: ResultType):
        rt = ResultType(result_type)
        if rt == ResultType.BODY_POSE:
            return self._compose_pose(self.config.imu_to_body_rotation,
                                      self.config.imu_to_body_translation)
        if rt == ResultType.CAMERA_POSE:
            return self._compose_pose(self.config.camera_to_body_rotation,
                                      self.config.camera_to_body_translation)
        if rt == ResultType.STATE:
            return (State.TRACKING_SUCCESS if self.pipeline.state == "tracking"
                    else State.INITIALIZING)
        if rt == ResultType.LANDMARKS:
            return self._landmarks()
        if rt == ResultType.FEATURES:
            return self._features()
        if rt == ResultType.BIAS:
            return self._bias()
        if rt == ResultType.INTRINSICS:
            K = self.config.camera_intrinsic
            return dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2])
        if rt == ResultType.VERSION:
            return __version__
        raise ValueError(f"unsupported result type {result_type!r}")

    def _compose_pose(self, q_bs, p_bs) -> Pose:
        out = self._last_output
        if out is None:
            return Pose()
        q = nputil.quat_mul(out.q, np.asarray(q_bs))
        p = out.p + nputil.quat_rotate(out.q, np.asarray(p_bs))
        return Pose(timestamp=out.t, quaternion=np.array([q[1], q[2], q[3], q[0]]),
                    translation=p)

    def _landmarks(self) -> np.ndarray:
        """World points (N,3) of the window's triangulated tracks."""
        swt = self.pipeline.swt
        if swt is None:
            return np.zeros((0, 3))
        pts = [tr.p_w for tr in swt.map.tracks.values()
               if tr.triangulated and tr.p_w is not None]
        return np.asarray(pts).reshape(-1, 3)

    def _features(self) -> np.ndarray:
        """Pixel keypoints (N,2) of the newest tracker frame."""
        frames = self.pipeline.tracker_map.frames
        if not frames:
            return np.zeros((0, 2))
        f = frames[-1]
        pts = getattr(f, "_pts", None)
        if pts is None:
            # bearings-only path (SyntheticTracker): project through K
            b = f.bearings[f.track_ids >= 0]
            z = np.clip(b[:, 2:3], 1e-9, None)
            return ((f.K @ (b / z).T).T)[:, :2]
        return pts[f.track_ids >= 0]

    def _bias(self) -> IMUBias:
        swt = self.pipeline.swt
        if swt is None:
            return IMUBias()
        _, _, _, _, bg, ba = swt.get_latest_state()
        inspection.inspect(inspection.CURRENT_BG, bg)
        inspection.inspect(inspection.CURRENT_BA, ba)
        return IMUBias(acc_bias=ba.copy(), gyr_bias=bg.copy())

    def destroy(self) -> None:
        self.pipeline = None
        self._cur_image = None
        self._cur_depth = None
        self._last_output = None


# ---------------------------------------------------------------------------
# module-level singleton (the C ABI's shape)
# ---------------------------------------------------------------------------

_instance: Optional[XRSLAM] = None


def create(slam_config_path: Optional[str] = None,
           device_config_path: Optional[str] = None,
           config: Optional[Config] = None, *, device="cuda") -> XRSLAM:
    global _instance
    _instance = XRSLAM(slam_config_path, device_config_path, config, device=device)
    return _instance


def _current() -> XRSLAM:
    if _instance is None:
        raise RuntimeError("call create() first")
    return _instance


def push_sensor_data(sensor_type: SensorType, timestamp: float, data) -> None:
    _current().push_sensor_data(sensor_type, timestamp, data)


def run_one_frame() -> None:
    _current().run_one_frame()


def get_result(result_type: ResultType):
    return _current().get_result(result_type)


def destroy() -> None:
    global _instance
    if _instance is not None:
        _instance.destroy()
    _instance = None
