"""Public API (port of `xrslam_tpu/api.py`): push IMU/camera samples,
run one frame, query the body/camera pose, tracking state and IMU
biases. Quaternions cross this API in the C ABI's [x,y,z,w] order.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .config import Config, load_config
from .core import nputil
from .core.detail import VIOPipeline
from .frontend.tracker import KLTFeatureTracker
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
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                'XRSLAM runs on a CUDA device by default and none is available; '
                'pass device="cpu" to run on the CPU')
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
        self._last_output = None

    def push_sensor_data(self, sensor_type: SensorType, timestamp: float,
                         data) -> None:
        if sensor_type == SensorType.CAMERA:
            self._cur_image = (float(timestamp), np.asarray(data))
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
        self.pipeline.track_camera_image(t, img)
        self._note_output(self.pipeline.predict_pose(self.pipeline.last_imu_t))

    def flush(self) -> None:
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
        if rt == ResultType.BIAS:
            swt = self.pipeline.swt
            if swt is None:
                return IMUBias()
            _, _, _, _, bg, ba = swt.get_latest_state()
            return IMUBias(acc_bias=ba.copy(), gyr_bias=bg.copy())
        raise ValueError(f"unsupported result type {result_type!r}")

    def _compose_pose(self, q_bs, p_bs) -> Pose:
        out = self._last_output
        if out is None:
            return Pose()
        q = nputil.quat_mul(out.q, np.asarray(q_bs))
        p = out.p + nputil.quat_rotate(out.q, np.asarray(p_bs))
        return Pose(timestamp=out.t, quaternion=np.array([q[1], q[2], q[3], q[0]]),
                    translation=p)
