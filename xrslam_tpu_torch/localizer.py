"""Visual (re)localization: SLAM -> global-map registration (port of
`xrslam_tpu/localizer.py`).

Two backends share the transform bookkeeping of `LocalizerBase`:

  - `MapLocalizer`: in-process RANSAC PnP (`ransac/pnp.find_pnp_matrix`,
    on the card unless `device="cpu"`) against a global landmark map
    served by a matcher, which stands in for the retrieval and matching
    of an XRLocalization server. Query n draws its minimal samples from
    a `torch.Generator` seeded with n; `idx=` passes fixed sample sets
    through instead.
  - `HttpLocalizer`: client of an XRLocalization server. It posts a
    base64 JPEG (Pillow) and the OPENCV intrinsics to `/loc`, takes the
    global camera pose `qvec/tvec` and the inlier count back, and
    uploads poses to `/pose`. Queries run on a daemon thread unless
    `block=True`; failures are logged, never silent.

Given the global camera pose T_g_cam and the SLAM-frame output pose at
the same instant,
  slam_to_global = T_g_cam ∘ T_cam_slam
and later outputs map as out = slam_to_global ∘ pose. The screen
orientations other than portrait rotate about the camera's optical
axis first.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from .core import nputil
from .core.detail import compute_device
from .ransac import pnp as pnp_mod
from .utils.logging import log_warning


class ScreenState(Enum):
    PORTRAIT = 0
    RIGHT = 1
    LEFT = 2
    DOWN = 3


@dataclass
class SE3:
    q: np.ndarray  # [w,x,y,z]
    p: np.ndarray

    @staticmethod
    def identity() -> "SE3":
        return SE3(np.array([1.0, 0, 0, 0]), np.zeros(3))

    def inverse(self) -> "SE3":
        qi = nputil.quat_conj(self.q)
        return SE3(qi, -nputil.quat_rotate(qi, self.p))

    def __matmul__(self, other: "SE3") -> "SE3":
        return SE3(nputil.quat_mul(self.q, other.q),
                   self.p + nputil.quat_rotate(self.q, other.p))

    def apply(self, x: np.ndarray) -> np.ndarray:
        return nputil.quat_rotate(self.q, x) + self.p


def _screen_rotation(q_slam_cam: np.ndarray, state: ScreenState) -> np.ndarray:
    """q_cam1_cam0: rotation about the camera's optical axis expressed
    in the SLAM frame."""
    if state == ScreenState.PORTRAIT:
        return np.array([1.0, 0, 0, 0])
    z_in_slam = nputil.quat_rotate(q_slam_cam, np.array([0.0, 0.0, 1.0]))
    angle = {ScreenState.RIGHT: -np.pi / 2,
             ScreenState.LEFT: np.pi / 2,
             ScreenState.DOWN: np.pi}[state]
    return nputil.expmap(z_in_slam * angle)


class LocalizerBase:
    """Shared transform bookkeeping + query throttling."""

    def __init__(self, config=None, query_interval: float = 3.0,
                 min_inliers: int = 20):
        self.config = config
        self.query_interval = query_interval
        self.min_inliers = min_inliers
        self.slam_to_global = SE3.identity()
        self._init = False
        self._lock = threading.Lock()
        self._last_query_t = -np.inf
        self._query_frame_flag = False
        # output-to-body extrinsic the transform is anchored at
        if config is not None:
            self._q_bo = np.asarray(config.output_to_body_rotation, float)
            self._p_bo = np.asarray(config.output_to_body_translation, float)
        else:
            self._q_bo = np.array([1.0, 0, 0, 0])
            self._p_bo = np.zeros(3)

    def is_initialized(self) -> bool:
        return self._init

    def query_frame(self) -> None:
        """Let the next query through the throttle."""
        self._query_frame_flag = True

    def transform(self, q: np.ndarray, p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """SLAM-frame pose -> global frame."""
        with self._lock:
            T = self.slam_to_global
        return (nputil.quat_mul(T.q, q), T.p + nputil.quat_rotate(T.q, p))

    def _update_transform(self, q_slam_body: np.ndarray, p_slam_body: np.ndarray,
                          q_g_cam: np.ndarray, p_g_cam: np.ndarray,
                          screen_state: ScreenState = ScreenState.PORTRAIT):
        """Register slam -> global from one (body pose in SLAM, camera
        pose in the global map) pair."""
        q_slam_cam = nputil.quat_mul(q_slam_body, self._q_bo)
        p_slam_cam = p_slam_body + nputil.quat_rotate(q_slam_body, self._p_bo)
        q_rot = _screen_rotation(q_slam_cam, screen_state)
        T_slam_cam1 = SE3(nputil.quat_mul(q_rot, q_slam_cam), p_slam_cam)
        T_cam1_slam = T_slam_cam1.inverse()
        T_g_cam1 = SE3(np.asarray(q_g_cam, float), np.asarray(p_g_cam, float))
        with self._lock:
            self.slam_to_global = T_g_cam1 @ T_cam1_slam
            self._init = True

    def _throttle(self, t: float) -> bool:
        if t - self._last_query_t > self.query_interval or self._query_frame_flag:
            self._last_query_t = t
            self._query_frame_flag = False
            return True
        return False


class MapLocalizer(LocalizerBase):
    """In-process relocalizer: RANSAC PnP against a global landmark map.

    `matcher(frame_data)` returns (X (N,3) global points, x (N,2)
    normalized image coordinates, valid (N,)) correspondences, or None."""

    def __init__(self, config=None, matcher=None, device="cuda", **kw):
        super().__init__(config, **kw)
        self.matcher = matcher
        self.device = compute_device(device)
        self._seed = 0

    def query_localization(self, t: float, frame_data,
                           q_slam_body: np.ndarray, p_slam_body: np.ndarray,
                           screen_state: ScreenState = ScreenState.PORTRAIT,
                           idx=None) -> bool:
        if not self._throttle(t) or self.matcher is None:
            return False
        got = self.matcher(frame_data)
        if got is None:
            return False
        X, x, valid = got
        if int(np.sum(valid)) < self.min_inliers:
            return False
        self._seed += 1
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        dev = self.device
        T, inliers, count = pnp_mod.find_pnp_matrix(
            gen, torch.as_tensor(np.asarray(X, np.float64), device=dev),
            torch.as_tensor(np.asarray(x, np.float64), device=dev),
            valid=torch.as_tensor(np.asarray(valid, bool), device=dev),
            idx=None if idx is None else torch.as_tensor(np.array(idx), device=dev))
        if int(count) < self.min_inliers:
            return False
        T = T.cpu().numpy()
        # PnP gives world->camera [R|t]; the transform update takes the
        # camera pose in the global map (camera->global)
        R_cw = T[:3, :3]
        q_g_cam = nputil.matrix_to_quat(R_cw.T)
        p_g_cam = -R_cw.T @ T[:3, 3]
        self._update_transform(q_slam_body, p_slam_body, q_g_cam, p_g_cam,
                               screen_state)
        return True


class HttpLocalizer(LocalizerBase):
    """Client of an XRLocalization server (`/loc`, `/pose`). Queries run
    on a daemon thread unless `block=True`."""

    def __init__(self, config, ip: Optional[str] = None,
                 port: Optional[int] = None, **kw):
        super().__init__(config, **kw)
        self.ip = ip or config.visual_localization_config_ip
        self.port = port or config.visual_localization_config_port
        self._pose_buf: list = []

    def query_localization(self, t: float, image: np.ndarray,
                           q_slam_body: np.ndarray, p_slam_body: np.ndarray,
                           screen_state: ScreenState = ScreenState.PORTRAIT,
                           block: bool = False):
        if not self._throttle(t):
            return
        args = (np.array(image, copy=True), q_slam_body.copy(),
                p_slam_body.copy(), screen_state)
        if block:
            self._query_loc(*args)
        else:
            threading.Thread(target=self._query_loc, args=args,
                             daemon=True).start()

    def _query_loc(self, image, q_slam_body, p_slam_body, screen_state):
        import base64
        import io
        import json
        from http.client import HTTPConnection

        try:
            arr = np.clip(image * 255.0, 0, 255).astype(np.uint8) \
                if image.dtype != np.uint8 else image
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            # request: base64 JPEG + an OPENCV intrinsic block whose
            # params are [fx, fy, cx, cy] then the distortion coefficients
            K = np.asarray(self.config.camera_intrinsic)
            params = [float(K[0, 0]), float(K[1, 1]),
                      float(K[0, 2]), float(K[1, 2])]
            params += [float(d) for d in np.ravel(self.config.camera_distortion)]
            msg = {
                "image": base64.b64encode(buf.getvalue()).decode(),
                "intrinsic": {
                    "model": "OPENCV",
                    "width": int(arr.shape[1]), "height": int(arr.shape[0]),
                    "params": params,
                },
            }
            conn = HTTPConnection(self.ip, self.port, timeout=30)
            conn.request("POST", "/loc", json.dumps(msg),
                         {"Content-Type": "application/json"})
            res = conn.getresponse()
            if res.status != 200:
                log_warning("localizer /loc query failed: HTTP %d", res.status)
                return
            out = json.loads(res.read())
            if out.get("ninlier", 0) <= self.min_inliers:
                log_warning("localizer /loc rejected: ninlier %d <= %d",
                            int(out.get("ninlier", 0)), self.min_inliers)
                return
            qvec = np.asarray(out["qvec"], float)   # [w,x,y,z]
            tvec = np.asarray(out["tvec"], float)
            self._update_transform(q_slam_body, p_slam_body, qvec, tvec,
                                   screen_state)
        except Exception as e:  # the query thread must not die silently
            log_warning("localizer /loc query failed: %s", e)

    def add_pose_message(self, t: float, q: np.ndarray, p: np.ndarray):
        """Buffer a pose for upload: x, y, z, qx, qy, qz, qw."""
        self._pose_buf.extend([float(p[0]), float(p[1]), float(p[2]),
                               float(q[1]), float(q[2]), float(q[3]),
                               float(q[0])])

    def send_pose(self):
        import json
        from http.client import HTTPConnection

        try:
            conn = HTTPConnection(self.ip, self.port, timeout=30)
            conn.request("POST", "/pose", json.dumps({"pose": self._pose_buf}),
                         {"Content-Type": "application/json"})
            if conn.getresponse().status == 200:
                self._pose_buf.clear()
        except Exception as e:
            log_warning("localizer /pose upload failed: %s", e)
