"""Sample synchronization + pipeline driver (port of
`xrslam_tpu/core/detail.py`):

  - gyroscope and accelerometer streams are paired by interpolating the
    gyro to each accelerometer timestamp,
  - camera frames (images, or bearings with track hints for the
    `SyntheticTracker`) wait until the IMU stream has passed them,
  - every IMU sample yields an output pose forward-propagated from the
    last optimized state,
  - frames go to the feature tracker, then to the Initializer until it
    succeeds and to the SlidingWindowTracker after; a tracking failure
    resets to initialization,
  - with `visual_pnp_enable`, every tracked frame gets a pose-only PnP
    against the backend's landmarks, published as the latest state (the
    camera-rate pose path; the backend may run at a reduced rate,
    `sliding_window_tracker_frequent`). The IMU samples are kept back to
    the backend's anchor, since the next backend refresh may restart the
    propagation there, older than the PnP frame. The JAX package drops
    them at each PnP frame, so that its next pose skips them,
    propagated from an anchor up to `sliding_window_tracker_frequent`
    frames back (`tests/test_torch_pnp_chain.py`),
  - with `visual_localization_enable`, every tracked frame offers its
    image and SLAM-frame pose to the installed localizer (throttled by
    the localizer), and once the localizer has registered the SLAM ->
    global transform every output pose is mapped through it. An
    `HttpLocalizer` is installed when a server port is configured;
    `set_localizer` installs another (a `MapLocalizer`).

The schedules (the reference's threaded backend, `frontend_worker.cpp`,
where the backend lags the tracker by one frame):
  - synchronous (default): each frame's backend stage runs at the end of
    its own push; the backend's pending write-backs ride the tracker's
    read;
  - `worker_overlap` (one-frame lag): frame t's backend stage runs inside
    frame t+1's push, between the tracker's dispatch and its read, and
    its fresh write-back rides that read;
  - `worker_overlap` + `pipelined_writeback` (two-frame lag, PARSAC
    off): the pending write-backs are collected first and ride the
    tracker's read, which starts before the backend stage of the queue's
    head runs; up to two solves stay in flight
    (`sliding_window.writeback_depth`).
  - `chained_frontend` on top of the two-frame lag (the tracker's
    device-chained KLT route, `frontend/tracker.py`): frame n's KLT is
    dispatched from frame n-1's device outputs, before frame n-1's read
    has been finished on the host.
`flush()` completes the deferred work at the end of a stream. The solves
take the same values under the first three schedules; the published
poses differ by when their anchor moves. The chained route tracks other
keypoints (the host's drops and detections land a frame late), so its
solves differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..frontend.tracker import chained_frontend_missing, detect_no_translation
from ..ransac import pnp as pnp_mod
from ..utils.fetch import fetch_packed
from ..utils.timing import StageTimes
from . import nputil
from .initializer import Initializer
from .map import FrameRec, PipelineMap, new_frame_id
from .sliding_window import SlidingWindowTracker, writeback_depth

GRAVITY = np.array([0.0, 0.0, -9.80665])


@dataclass
class OutputPose:
    t: float
    q: np.ndarray  # body-to-world [w,x,y,z]
    p: np.ndarray


def compute_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (nothing
    falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'the port runs on a CUDA device by default and none is available; '
            'pass device="cpu" to run on the CPU')
    return device


class VIOPipeline:
    """Push IMU + camera samples, get poses. Runs on the card unless
    `device="cpu"` is asked for."""

    def __init__(self, config: Config, tracker, device="cuda",
                 times: Optional[StageTimes] = None):
        # the JAX package ignores the flag without its prerequisites; the
        # port refuses it
        missing = chained_frontend_missing(config) if config.chained_frontend else []
        if missing:
            raise ValueError("Config.chained_frontend=True needs the two-frame schedule "
                             "with PARSAC off: set " + ", ".join(missing))
        self.config = config
        self.tracker = tracker
        self.device = compute_device(device)
        self.times = times if times is not None else StageTimes()
        self.tracker_map = PipelineMap()
        self.initializer: Optional[Initializer] = Initializer(
            config, self.device, times=self.times)
        self.swt: Optional[SlidingWindowTracker] = None
        # visual (re)localization: the HTTP client when a server port is
        # configured; set_localizer installs another backend
        self.localizer = None
        if config.visual_localization_enable and \
                config.visual_localization_config_port:
            from ..localizer import HttpLocalizer

            self.localizer = HttpLocalizer(config)
        self.gyro_buf: List[tuple] = []
        self.accel_buf: List[tuple] = []
        self.imu_pending: List[tuple] = []
        self.frame_pending: List[FrameRec] = []
        self.last_imu_t = -np.inf
        self._prop: Optional[dict] = None
        self._prop_cache = None
        self._imu_since_opt: List[tuple] = []
        self._last_frame_t: Optional[float] = None
        self._last_frame_id: Optional[int] = None
        self._last_taken: Optional[tuple] = None
        self._frame_count = 0
        # camera-rate PnP: tracker-track-id -> landmark world point, and
        # the number of frames whose PnP pose was published
        self._keymap: dict = {}
        self.pnp_frames = 0
        # worker_overlap: frames tracked whose backend stage runs inside a
        # later push
        self._issue_queue: List[FrameRec] = []

    def set_localizer(self, localizer) -> None:
        """Install a visual-localization backend (`MapLocalizer` or
        `HttpLocalizer`); the tracking loop queries it only with
        `visual_localization_enable`."""
        self.localizer = localizer

    # ------------------------------------------------------------------
    def track_gyroscope(self, t: float, w) -> Optional[OutputPose]:
        self.gyro_buf.append((t, np.asarray(w, dtype=float)))
        self._fuse()
        return self.predict_pose(t)

    def track_accelerometer(self, t: float, a) -> Optional[OutputPose]:
        self.accel_buf.append((t, np.asarray(a, dtype=float)))
        self._fuse()
        return self.predict_pose(t)

    def _fuse(self):
        """Interpolate gyro to each accel timestamp once both sides
        bracket it."""
        while self.accel_buf and len(self.gyro_buf) >= 2:
            ta, a = self.accel_buf[0]
            while len(self.gyro_buf) > 2 and self.gyro_buf[1][0] <= ta:
                self.gyro_buf.pop(0)
            t0, w0 = self.gyro_buf[0]
            t1, w1 = self.gyro_buf[1]
            if ta < t0:
                self.accel_buf.pop(0)
                continue
            if ta > t1:
                break
            lam = 0.0 if t1 == t0 else (ta - t0) / (t1 - t0)
            self.accel_buf.pop(0)
            self._track_imu(ta, (1 - lam) * w0 + lam * w1, a)

    def _track_imu(self, t, w, a):
        if t <= self.last_imu_t:
            return
        self.last_imu_t = t
        self.imu_pending.append((t, w, a))
        self._imu_since_opt.append((t, w, a))
        self._flush_frames()

    # ------------------------------------------------------------------
    def track_camera(self, t: float, bearings: np.ndarray,
                     track_hint: Optional[np.ndarray] = None) -> None:
        """Push a camera frame as its fixed-capacity (C,3) unit-bearing
        array; `track_hint` (C,) carries the `SyntheticTracker`'s
        correspondence ids, -1 = empty."""
        f = self._make_frame(t, np.asarray(bearings, dtype=float))
        f._hint = track_hint
        self.frame_pending.append(f)
        self._flush_frames()

    def track_camera_image(self, t: float, image: np.ndarray,
                           depth: Optional[np.ndarray] = None) -> None:
        """Push a grayscale image ((H,W) float32 in [0,1]); the tracker
        fills the keypoint slots when the frame is processed. `depth`
        optionally carries an aligned metric depth image ((H,W) float32
        metres, 0 = invalid), sampled at the keypoints into
        `FrameRec.kp_depth`. Refused under the two-frame schedule."""
        if depth is not None and writeback_depth(self.config) == 2:
            raise ValueError(
                "depth input is refused with pipelined_writeback: the JAX package's "
                "depth-camera keyframe path triangulates from host poses that a "
                "pending solve has not written yet, one solve stale "
                "(xrslam_tpu/core/sliding_window.py:561-569; ROADMAP.md, queue 3)")
        f = self._make_frame(t, np.zeros((self.tracker.capacity, 3)))
        f._image = np.asarray(image, dtype=np.float32)
        f._depth_img = depth
        self.frame_pending.append(f)
        self._flush_frames()

    def _make_frame(self, t: float, bearings: np.ndarray) -> FrameRec:
        cfg = self.config
        return FrameRec(
            id=new_frame_id(), t=t,
            q=np.array([1.0, 0, 0, 0]), p=np.zeros(3), v=np.zeros(3),
            bg=cfg.gyroscope_bias.copy(), ba=cfg.accelerometer_bias.copy(),
            q_bc=np.asarray(cfg.camera_to_body_rotation, dtype=float),
            p_bc=np.asarray(cfg.camera_to_body_translation, dtype=float),
            q_bi=np.asarray(cfg.imu_to_body_rotation, dtype=float),
            p_bi=np.asarray(cfg.imu_to_body_translation, dtype=float),
            K=np.asarray(cfg.camera_intrinsic, dtype=float),
            sqrt_inv_cov2=np.diag([
                cfg.camera_intrinsic[0, 0] / np.sqrt(cfg.keypoint_noise_cov[0, 0]),
                cfg.camera_intrinsic[1, 1] / np.sqrt(cfg.keypoint_noise_cov[1, 1]),
            ]),
            bearings=bearings,
            track_ids=np.full((bearings.shape[0],), -1, dtype=np.int64),
        )

    def _flush_frames(self):
        while self.frame_pending and self.last_imu_t >= self.frame_pending[0].t:
            f = self.frame_pending.pop(0)
            take = [s for s in self.imu_pending if s[0] <= f.t]
            self.imu_pending = [s for s in self.imu_pending if s[0] > f.t]
            # boundary sample: re-stamp the previous frame's last sample
            # at that frame's time so no span of IMU is dropped
            if (take and self._last_frame_t is not None
                    and self._last_taken is not None
                    and take[0][0] - self._last_frame_t > 1e-5):
                take.insert(0, (self._last_frame_t, self._last_taken[1],
                                self._last_taken[2]))
            if take:
                f.imu_t = np.array([s[0] for s in take])
                f.imu_w = np.stack([s[1] for s in take])
                f.imu_a = np.stack([s[2] for s in take])
                self._last_taken = take[-1]
            self._last_frame_t = f.t
            self._last_frame_id = f.id
            with self.times.frame(f.id, kind="init" if self.swt is None else "track"):
                self._process_frame(f)

    def _process_frame(self, frame: FrameRec):
        # every frame is tracked; every Nth detects and reaches the
        # backend (always while initializing)
        issue = (self.swt is None or
                 self._frame_count % self.config.sliding_window_tracker_frequent == 0)
        self._frame_count += 1
        frame._detect_tag = issue
        image = getattr(frame, "_image", None)  # the tracker releases it
        self.tracker_map.attach_frame(frame)
        cfg = self.config
        rider = between = None
        if cfg.worker_overlap and writeback_depth(cfg) == 2:
            # two-frame lag: the pending write-backs ride the tracker's
            # read, which starts before the queue head's backend stage
            if self.swt is not None:
                rider = self.swt.collect_riders()

            def between():
                if self._issue_queue:
                    with self.times.stage("backend_overlap_time"):
                        self._issue_frame(self._issue_queue.pop(0))
        elif cfg.worker_overlap:
            # one-frame lag: the queued backend stage runs between the
            # tracker's dispatch and its read; its write-back rides it
            def between():
                with self.times.stage("backend_overlap_time"):
                    self._run_deferred_issue()
                return None if self.swt is None else self.swt.collect_riders()
        elif self.swt is not None:
            rider = self.swt.collect_riders()
        with self.times.stage("feature_tracker_time"):
            self.tracker.track_frame(self.tracker_map, frame, rider=rider,
                                     between=between)
        if self.swt is not None and cfg.visual_pnp_enable:
            # a pipelined tracker returns with `frame` in flight: PnP runs
            # on the newest frame it completed
            f_pnp = frame if self.tracker._pending is None else self.tracker.last_finished
            if f_pnp is not None:
                with self.times.stage("visual_pnp_time"):
                    self._solve_pnp_highrate(f_pnp)
        # throttled visual-localization query while tracking, with the
        # frame's image and its SLAM-frame pose
        if (self.localizer is not None and self.swt is not None
                and self.config.visual_localization_enable):
            prop = self._propagate_full(frame.t)
            if prop is not None:
                _, q_b, p_b, _ = prop
                with self.times.stage("localizer_time"):
                    self.localizer.query_localization(
                        frame.t, image if image is not None else frame, q_b, p_b)
        cap = (self.config.feature_tracker_max_frames if self.swt
               else self.config.feature_tracker_max_init_frames)
        while len(self.tracker_map.frames) > cap:
            self.tracker_map.detach_frame(0)
        if issue:
            if cfg.worker_overlap:
                self._issue_queue.append(frame)
            else:
                with self.times.stage("backend_time"):
                    self._issue_frame(frame)

    def _run_deferred_issue(self):
        while self._issue_queue:
            self._issue_frame(self._issue_queue.pop(0))

    def _issue_frame(self, frame: FrameRec):
        if self.swt is None:
            self.initializer.mirror_keyframe_map(self.tracker_map, frame.id)
            if self.initializer.map is not None:
                with self.times.stage("initializer_time"):
                    swt = self.initializer.initialize()
                if swt is not None:
                    self.swt = swt
                    self._refresh_prop_state()
        elif self.swt.mirror_frame(self.tracker_map, frame.id):
            if self.swt.track():
                self._refresh_prop_state()
            else:
                self.swt = None
                self.initializer = Initializer(self.config, self.device,
                                               times=self.times)
        if self.swt is None and self._prop is not None:
            self._trim_while_lost()

    def flush(self) -> None:
        """Complete the deferred work at the end of a stream: the
        tracker's frame in flight, the queued backend stages, the
        pending write-backs."""
        self.tracker.flush()
        self._run_deferred_issue()
        if self.swt is not None:
            self.swt.materialize_pending()

    def _refresh_prop_state(self):
        """Install the backend's latest state as the propagation anchor;
        the samples it needs are those after it, which a PnP publish
        keeps (the anchor may be older than the last PnP frame)."""
        t, q, p, v, bg, ba = self.swt.get_latest_state()
        self._prop = dict(t=t, q=q.copy(), p=p.copy(), v=v.copy(),
                          bg=bg.copy(), ba=ba.copy())
        self._prop_cache = None
        self._imu_since_opt = [s for s in self._imu_since_opt if s[0] > t]
        if self.config.visual_pnp_enable:
            with self.times.stage("pnp_keymap_time"):
                self._refresh_keymap()

    def _trim_while_lost(self):
        """Bound the samples while tracking is lost. The propagation
        resumes from its cursor (no PnP or refresh resets it until the
        initializer succeeds), and the initializer's anchor is one of the
        tracker's frames: samples at or before both are never read
        again."""
        c = self._prop_cache
        if c is None or not self.tracker_map.frames:
            return
        t = min(c[0], self.tracker_map.frames[0].t)
        if self._imu_since_opt and self._imu_since_opt[0][0] <= t:
            self._imu_since_opt = [s for s in self._imu_since_opt if s[0] > t]

    # ------------------------------------------------------------------
    # camera-rate visual PnP pose path
    # ------------------------------------------------------------------
    def _refresh_keymap(self):
        """Mirror the backend's triangulated, non-outlier landmarks into a
        tracker-track-id -> world-point table."""
        keymap = {}
        swt_map = self.swt.map
        tframes = {f.id: f for f in self.tracker_map.frames}
        for sf in swt_map.all_frames():
            tf = tframes.get(sf.id)
            if tf is None:
                continue
            for k in np.nonzero(sf.track_ids >= 0)[0]:
                wtr = swt_map.tracks.get(int(sf.track_ids[k]))
                if (wtr is None or not (wtr.valid and wtr.triangulated)
                        or wtr.p_w is None or wtr.outlier):
                    continue
                ttid = int(tf.track_ids[k])
                if ttid >= 0:
                    keymap[ttid] = wtr.p_w
        self._keymap = keymap

    def _solve_pnp_highrate(self, frame: FrameRec):
        """Pose-only PnP of the newest tracked frame against the keymap
        landmarks (`pnp.refine_pose_pnp` from the IMU-propagated pose),
        published as the latest output state."""
        cfg = self.config
        prop = self._propagate_full(frame.t)
        if prop is None:
            return
        _, q_b, p_b, v_b = prop
        C = frame.track_ids.shape[0]
        X = np.zeros((C, 3))
        valid = np.zeros((C,), dtype=bool)
        for k in np.nonzero(frame.track_ids >= 0)[0]:
            p_w = self._keymap.get(int(frame.track_ids[k]))
            if p_w is not None:
                X[k] = p_w
                valid[k] = True
        if valid.sum() < cfg.visual_pnp_min_landmarks:
            self.times.count("pnp_skipped")
            self.times.tag(frame.id, pnp="skipped")
            return
        q_wc = nputil.quat_mul(q_b, frame.q_bc)
        p_wc = p_b + nputil.quat_rotate(q_b, frame.p_bc)
        dev = self.device
        q_wc2, p_wc2 = pnp_mod.refine_pose_pnp(
            torch.as_tensor(q_wc, device=dev), torch.as_tensor(p_wc, device=dev),
            torch.as_tensor(X, device=dev), torch.as_tensor(frame.bearings, device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(frame.sqrt_inv_cov2, device=dev),
            iters=cfg.solver_iteration_limit)
        qp = fetch_packed(torch.cat([q_wc2, p_wc2]))    # one read
        q_b2 = nputil.quat_normalize(
            nputil.quat_mul(qp[:4], nputil.quat_conj(frame.q_bc)))
        p_b2 = qp[4:] - nputil.quat_rotate(q_b2, frame.p_bc)
        frame.q, frame.p, frame.v = q_b2, p_b2, v_b.copy()
        s = self._prop
        self._prop = dict(t=frame.t, q=q_b2, p=p_b2, v=v_b,
                          bg=s["bg"].copy(), ba=s["ba"].copy())
        self._prop_cache = None
        self.pnp_frames += 1
        self.times.count("pnp_published")
        self.times.tag(frame.id, pnp="published")

    # ------------------------------------------------------------------
    def predict_pose(self, t: float) -> Optional[OutputPose]:
        """IMU-forward pose at time t from the last optimized state."""
        prop = self._propagate_full(t)
        if prop is None:
            return None
        t_cur, q, p, _ = prop
        # SLAM frame -> global frame once the localizer has registered
        if self.localizer is not None and self.localizer.is_initialized():
            q, p = self.localizer.transform(q, p)
        return OutputPose(t=t_cur, q=q, p=p)

    def _propagate_full(self, t: float):
        """Forward-propagate (q, p, v) to time t from the last optimized
        state, resuming from the last reached sample. Returns
        (t_reached, q, p, v) or None before initialization."""
        if self._prop is None:
            return None
        s = self._prop
        c = self._prop_cache
        if c is not None and c[0] <= t:
            t_cur, q, p, v = c
        else:
            q, p, v, t_cur = s["q"], s["p"], s["v"], s["t"]
        bg, ba = s["bg"], s["ba"]
        n = 0
        for (ti, w, a) in self._imu_since_opt:
            if ti <= t_cur or ti > t:
                continue
            dt = ti - t_cur
            v = v + dt * (nputil.quat_rotate(q, a - ba) + GRAVITY)
            p = p + dt * v
            q = nputil.quat_normalize(nputil.quat_mul(q, nputil.expmap((w - bg) * dt)))
            t_cur = ti
            n += 1
        if n:
            # the poses published between frames are counted with the
            # newest frame processed, whose anchor they propagate
            self.times.count("imu_samples_replayed", n, frame_id=self._last_frame_id)
        self._prop_cache = (t_cur, q, p, v)
        return t_cur, q, p, v

    @property
    def state(self) -> str:
        return "tracking" if self.swt is not None else "initializing"

    @property
    def frames_processed(self) -> int:
        """Camera frames the tracker (and the backend) have processed."""
        return self._frame_count


class SyntheticTracker:
    """Feature tracker fed by ground-truth correspondences: the frame's
    `_hint` array (`VIOPipeline.track_camera`) holds a persistent
    synthetic track id per keypoint slot; keypoints sharing an id across
    frames join the same map track.

    With a `config`, it also runs the image tracker's FT_NO_TRANSLATION
    detector (`frontend.tracker.detect_no_translation`, rotation RANSAC
    + misalignment percentile) over the matched bearings, with a
    `torch.Generator` on `device` (the card unless "cpu" is asked
    for)."""

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self._id_map = {}
        self._prev: Optional[FrameRec] = None
        self.config = config
        self.device = compute_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0 if config is None else int(config.random))
        # a frame is complete when track_frame returns
        self._pending = None
        self.last_finished: Optional[FrameRec] = None

    def finish_pending(self) -> None:
        """Nothing is ever in flight."""

    def flush(self) -> None:
        """Nothing is ever in flight or staged."""

    def track_frame(self, tracker_map: PipelineMap, frame: FrameRec,
                    rider=None, between=None) -> None:
        """`rider` is ignored (this tracker reads nothing from the
        device); `between` runs at once: there is no read to overlap."""
        if between is not None:
            between()
        hint = getattr(frame, "_hint", None)
        if hint is None:
            return
        for k in np.nonzero(hint >= 0)[0]:
            h = int(hint[k])
            tid = self._id_map.get(h)
            tr = tracker_map.tracks.get(tid) if tid is not None else None
            if tr is None:
                tr = tracker_map.get_track(frame, int(k), create=True)
                self._id_map[h] = tr.id
            else:
                tracker_map.add_observation(tr, frame, int(k))
            tr.life += 1

        prev = self._prev
        if self.config is not None and prev is not None:
            C = frame.bearings.shape[0]
            bp = np.zeros((C, 3))
            bp[:, 2] = 1.0
            bn = bp.copy()
            valid = np.zeros((C,), dtype=bool)
            i = 0
            for k in np.nonzero(frame.track_ids >= 0)[0]:
                tr = tracker_map.tracks.get(int(frame.track_ids[k]))
                kp = tr.obs.get(prev.id) if tr is not None else None
                if kp is None:
                    continue
                bp[i] = prev.bearings[kp]
                bn[i] = frame.bearings[k]
                valid[i] = True
                i += 1
            if valid.sum() >= 8 and detect_no_translation(
                    self.generator, bp, bn, valid, self.config):
                frame.no_translation = True
        self._prev = frame
        self.last_finished = frame
