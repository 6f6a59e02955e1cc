"""Host side of the port's C ABI (port of `xrslam_tpu/capi_host.py`;
the shim is `xrslam_tpu_torch/native/xr_capi.cpp`, built by
`native.build_capi`).

The native shim embeds CPython and calls the flat functions in this
module with only scalars / bytes / str — no numpy or torch objects
cross the C boundary, so the shim needs nothing beyond the stable
CPython object protocol. Together they export the reference's C surface
(`native/XRSLAM.h`; reference: xrslam-interface/include/XRSLAM.h:195-230
and the singleton XRSLAMManager) over `xrslam_tpu_torch.api.XRSLAM`.

The C surface takes only the two YAML paths, so an embedding program
chooses the torch device through the environment: `create` reads
XRSLAM_TORCH_DEVICE (default "cuda"; "cpu" to run on the CPU). The
default raises without a CUDA device, as `api.XRSLAM` does.

All returns are plain tuples/bytes/str. Pose tuples are
(qx, qy, qz, qw, px, py, pz, t) — the C ABI's [x,y,z,w] order.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .api import XRSLAM, ResultType, SensorType

DEVICE_ENV = "XRSLAM_TORCH_DEVICE"

_engine: Optional[XRSLAM] = None


def create(slam_config_path: str, device_config_path: str) -> int:
    """Returns 1 on success; raises on config errors or a missing CUDA
    device (the shim converts the exception to a 0 return +
    XRSLAMGetLastError). The device is $XRSLAM_TORCH_DEVICE, "cuda" by
    default."""
    global _engine
    _engine = XRSLAM(slam_config_path or None, device_config_path or None,
                     device=os.environ.get(DEVICE_ENV, "cuda"))
    return 1


def destroy() -> None:
    global _engine
    if _engine is not None:
        _engine.flush()
        _engine.destroy()
        _engine = None


def camera_bytes(stride: int) -> int:
    """Byte count of one camera frame at the given row stride (the
    image height comes from the device config's camera resolution)."""
    _, h = _engine.config.camera_resolution
    return int(stride) * int(h)


def depth_bytes() -> int:
    w, h = _engine.config.camera_resolution
    return int(w) * int(h) * 2


def push_camera(t: float, data: bytes, stride: int, channel: int) -> None:
    """Gray or interleaved-RGB(A) rows of the configured resolution
    (the image height comes from the device config, exactly like the
    reference manager — XRSLAMManager.cpp:55-76 channel conversion)."""
    w, h = _engine.config.camera_resolution
    ch = max(int(channel), 1)
    arr = np.frombuffer(data, np.uint8, count=stride * h).reshape(h, stride)
    arr = arr[:, : w * ch]
    if ch > 1:
        rgb = arr.reshape(h, w, ch)[..., :3].astype(np.float32)
        gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2])
    else:
        gray = arr.astype(np.float32)
    # the pipeline's image convention is float32 in [0,1]
    # (VIOPipeline.track_camera_image)
    _engine.push_sensor_data(SensorType.CAMERA, t, gray / 255.0)


def push_depth(t: float, data: bytes) -> None:
    w, h = _engine.config.camera_resolution
    d = np.frombuffer(data, np.uint16, count=w * h).reshape(h, w)
    _engine.push_sensor_data(SensorType.DEPTH_CAMERA, t, d)


def push_imu(kind: int, t: float, x: float, y: float, z: float) -> None:
    _engine.push_sensor_data(SensorType(kind), t, np.array([x, y, z]))


def run_one_frame() -> None:
    _engine.run_one_frame()


def get_pose(which: int) -> tuple:
    pose = _engine.get_result(ResultType(which))
    q, p = pose.quaternion, pose.translation
    return (float(q[0]), float(q[1]), float(q[2]), float(q[3]),
            float(p[0]), float(p[1]), float(p[2]), float(pose.timestamp))


def get_state() -> int:
    return int(_engine.get_result(ResultType.STATE))


def get_landmarks() -> bytes:
    """float64 (x,y,z) triples."""
    pts = _engine.get_result(ResultType.LANDMARKS)
    return np.ascontiguousarray(pts, dtype=np.float64).tobytes()


def get_features() -> bytes:
    """float64 (x,y) pixel pairs of the newest tracked frame."""
    pts = _engine.get_result(ResultType.FEATURES)
    return np.ascontiguousarray(pts, dtype=np.float64).tobytes()


def get_bias() -> tuple:
    b = _engine.get_result(ResultType.BIAS)
    return tuple(float(v) for v in b.acc_bias) + \
        tuple(float(v) for v in b.gyr_bias)


def get_intrinsics() -> tuple:
    d = _engine.get_result(ResultType.INTRINSICS)
    return (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]))


def get_version() -> str:
    return str(_engine.get_result(ResultType.VERSION))


def get_debug_logs() -> str:
    """Drain the UI message queue (reference Logger::getAllMessage,
    utility/logger.h:5-27; exported through the C ABI's
    XRSLAM_RESULT_DEBUG_LOGS)."""
    from .utils.logging import Logger

    return "\n".join(Logger.instance().get_all_messages())
