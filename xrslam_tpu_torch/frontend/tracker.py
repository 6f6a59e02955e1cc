"""Image-based KLT feature tracker (port of `xrslam_tpu/frontend/tracker.py`):

  1. CLAHE + 3-level LK pyramid on arrival (on the device),
  2. gyro-rotation-predicted initial flow,
  3. forward + backward pyramidal LK with its gates (kernel K1),
  4. essential-matrix RANSAC inlier gate,
  5. 2-point rotation RANSAC + 70th-percentile misalignment angle →
     FT_NO_TRANSLATION,
  6. track-length-priority Poisson-disk re-filter (host, the native
     runtime's `poisson_filter`),
  7. GFTT detection with spacing filter into free slots,
  8. with an aligned depth image, its value at each final keypoint into
     `FrameRec.kp_depth`; the painter tap (`utils.inspection`).

Every device result a frame needs on the host comes back in one packed
read (`utils.fetch`). With a `between` callback (`Config.worker_overlap`)
the tracker runs a two-frame software pipeline: it dispatches the
frame, runs `between` (the pipeline's backend stage of an earlier
frame), starts the read and returns with it in flight; the next call,
or `finish_pending`, completes the frame.

`Config.chained_frontend` (on top of the two-frame schedule, PARSAC
off): frame n's KLT is dispatched from frame n-1's device outputs
(tracked positions, post-gate status, bearings) in stable keypoint
slots (`_chained_track_step`), so the dispatch never waits for frame
n-1's read. The host's track-length-priority Poisson drops and its new
detections reach the device one frame later as a masked slot update;
a new detection is placed at the rotation-compensated position of the
step in flight, and its first observation is recorded on the next
frame, so that each track's observations stay contiguous. The pure
host arithmetic of that route is `chained_keep` and
`chained_injection`. The first frame, and any frame whose previous
frame has no device state (after `flush`, or a restore), goes the
standard route and re-seeds the device state from its final layout.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import native
from ..config import Config
from ..core import nputil
from ..core.map import FrameRec, PipelineMap
from ..ransac import stereo as stereo_mod
from ..utils import inspection
from ..utils.fetch import fetch_packed, fetch_packed_start
from ..utils.timing import StageTimes
from . import image as img_ops
from . import klt


def _poisson_accept(pts: np.ndarray, order: np.ndarray, keep_ok: np.ndarray,
                    min_dist: float) -> np.ndarray:
    """Greedy spacing filter over pts[order]: accept a point iff it is
    ≥ min_dist from every previously accepted point (grid-bucketed).
    Returns the accept mask aligned with pts. The plain version of
    `native.poisson_filter`, which the tracker calls."""
    accept = np.zeros(len(pts), dtype=bool)
    cell = min_dist / np.sqrt(2.0)
    grid = {}
    for i in order:
        if not keep_ok[i]:
            continue
        p = pts[i]
        gx, gy = int(p[0] // cell), int(p[1] // cell)
        ok = True
        for dx in range(-2, 3):
            for dy in range(-2, 3):
                for j in grid.get((gx + dx, gy + dy), ()):
                    if np.sum((pts[j] - p) ** 2) < min_dist * min_dist:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            accept[i] = True
            grid.setdefault((gx, gy), []).append(i)
    return accept


def _post_klt_gates(generator, nxt, status, bearings_prev, Kinv,
                    rot_thresh_deg: float, mis_thresh_deg: float,
                    idx_e=None, idx_r=None):
    """Post-KLT gates on the device: bearing lift of the tracked pixel
    positions, the essential-matrix inlier gate and the rotation
    RANSAC + 70th-percentile misalignment test (both only with >= 8 KLT
    survivors). `idx_e`/`idx_r` optionally replace the random minimal
    samples. Returns (b_next (C,3), status_out, no_translation ())."""
    C = nxt.shape[0]
    dt = bearings_prev.dtype
    h = torch.cat([nxt.to(dt), torch.ones((C, 1), dtype=dt, device=nxt.device)], 1)
    b = h @ Kinv.T.to(dt)
    b_next = b / torch.linalg.norm(b, dim=1, keepdim=True)
    h_prev = bearings_prev / torch.clamp(bearings_prev[:, 2:3], min=1e-9)
    h_next = b / torch.clamp(b[:, 2:3], min=1e-9)
    _, e_mask, _ = stereo_mod.find_essential_matrix(
        generator, h_prev, h_next, valid=status, threshold=1.0, idx=idx_e)
    apply = torch.sum(status) >= 8
    st = torch.where(apply, status & e_mask, status)
    R_rot, r_mask, _ = stereo_mod.find_rotation_matrix(
        generator, bearings_prev, b_next, valid=st,
        threshold=math.pi / 180.0 * rot_thresh_deg, idx=idx_r)
    r_mask = r_mask & st
    cosang = torch.clamp(torch.sum((bearings_prev @ R_rot.T) * b_next, dim=1),
                         -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cosang))
    ang_sorted = torch.sort(torch.where(r_mask, ang, float("inf"))).values
    m = torch.sum(r_mask)
    mis = torch.where(m > 0, ang_sorted[torch.clamp((m * 7) // 10, 0, C - 1)],
                      0.0)
    return b_next, st, apply & (mis < mis_thresh_deg)


def chained_frontend_missing(config: Config) -> list:
    """What `Config.chained_frontend` lacks in `config`: the two-frame
    schedule (`worker_overlap`, `pipelined_writeback`, deferred
    write-backs) with PARSAC off. Empty when the route can run."""
    missing = [f"{flag}=True" for flag in ("worker_overlap", "pipelined_writeback",
                                           "deferred_subframe_write")
               if not getattr(config, flag)]
    return missing + (["parsac_flag=False"] if config.parsac_flag else [])


def _apply_slot_update(pts, valid, bear, upd_keep, upd_pts, upd_mask, upd_bear):
    """The host's slot update, staged one frame late: slots in
    `upd_mask` take the injected positions and bearings, the others
    keep theirs if `upd_keep` (the Poisson re-filter's verdict)."""
    pts = torch.where(upd_mask[:, None], upd_pts.to(pts.dtype), pts)
    bear = torch.where(upd_mask[:, None], upd_bear.to(bear.dtype), bear)
    return pts, (valid & upd_keep) | upd_mask, bear


def _rotation_predicted_flow(pts, valid, bear, R_pred, K, shape):
    """The initial flow of the chained step on the device: each valid
    slot's bearing rotated by `R_pred` and projected through `K` (f64),
    cast to the positions' f32; slots whose prediction leaves the image
    (or turns behind the camera) keep their position."""
    H, W = shape
    pred_b = bear @ R_pred.to(bear.dtype).T
    z = torch.clamp(pred_b[:, 2:3], min=1e-6)
    uv = ((pred_b / z) @ K.to(bear.dtype).T)[:, :2].to(pts.dtype)
    inb = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
           & (uv[:, 1] < H) & (pred_b[:, 2] > 0))
    return torch.where((inb & valid)[:, None], uv, pts)


def _chained_track_step(generator, prev_pyr, cur_pyr, pts, valid, bear,
                        upd_keep, upd_pts, upd_mask, upd_bear, R_pred, K, Kinv,
                        rot_thresh_deg: float, mis_thresh_deg: float,
                        win: int = 21, iters: int = 30, eps: float = 0.01,
                        border: int = 20, idx_e=None, idx_r=None):
    """One frame of the device-chained frontend, on tensors: apply the
    staged slot update, predict the initial flow, run K1
    (`klt.track_keypoints`) from the previous frame's device state and
    the fused gates (`idx_e`/`idx_r` optionally replace their minimal
    samples). Adds no read of the device. Returns (nxt, status, b_next,
    no_trans); (nxt, status, b_next) is the next frame's device state."""
    pts, valid, bear = _apply_slot_update(pts, valid, bear, upd_keep, upd_pts,
                                          upd_mask, upd_bear)
    pts_init = _rotation_predicted_flow(pts, valid, bear, R_pred, K,
                                        cur_pyr[0].shape)
    nxt, status = klt.track_keypoints(prev_pyr, cur_pyr, pts.contiguous(),
                                      pts_init.contiguous(), valid.contiguous(),
                                      win=win, iters=iters, eps=eps, border=border)
    ez = torch.zeros_like(bear[:1])
    ez[:, 2] = 1.0
    b_next, status, no_trans = _post_klt_gates(
        generator, nxt, status, torch.where(valid[:, None], bear, ez), Kinv,
        rot_thresh_deg, mis_thresh_deg, idx_e=idx_e, idx_r=idx_r)
    return nxt, status, b_next, no_trans


def chained_keep(nxt, status, lengths, live, pending_slots, min_dist: float):
    """Host half of a chained frame's tracking, in stable slots: the
    slots whose KLT survived and that carry a live host track pass the
    spacing filter longest track first (`accept`); the staged new
    detections take their slots unless a track holds them (`placed`).
    Returns (accept, keep = accept | placed, placed)."""
    order = np.argsort(-np.asarray(lengths), kind="stable")
    accept = native.poisson_filter(np.asarray(nxt, np.float64), order,
                                   np.asarray(status) & np.asarray(live), min_dist)
    placed = [int(s) for s in pending_slots if not accept[s]]
    keep = accept.copy()
    keep[placed] = True
    return accept, keep, placed


def chained_injection(pts_used, free, cand, cvalid, K, R_last, shape,
                      max_detection: int, min_dist: float, capacity: int):
    """New detections of a chained frame into its free slots: the GFTT
    candidates after the kept keypoints `pts_used` through the spacing
    filter, at most `max_detection`, each mapped through the rotation
    prediction `R_last` of the step in flight (the device tracks it
    from the next frame's previous pyramid); a detection the rotation
    takes out of the image keeps its raw position. Returns the slot
    update (upts (C,2) f32, umask (C,), ubear (C,3)) and the staged
    first observations [(slot, uv, bearing)]."""
    upts = np.zeros((capacity, 2), np.float32)
    umask = np.zeros((capacity,), bool)
    ubear = np.zeros((capacity, 3))
    ubear[:, 2] = 1.0
    news = []
    if cand is None or not len(free):
        return upts, umask, ubear, news
    n_pre = len(pts_used)
    accept = native.poisson_filter(np.concatenate([pts_used, cand], axis=0),
                                   np.arange(n_pre + len(cand)),
                                   np.concatenate([np.ones(n_pre, bool), cvalid]),
                                   min_dist)
    sel = np.nonzero(accept[n_pre:])[0][:max_detection]
    Kinv = np.linalg.inv(K)
    H, W = shape
    for s, i in zip(free, sel):
        b = Kinv @ np.array([cand[i, 0], cand[i, 1], 1.0])
        b /= np.linalg.norm(b)
        b2, uv2 = R_last @ b, cand[i]
        if b2[2] > 1e-6:
            uv2 = (K @ (b2 / b2[2]))[:2]
        b2 = b2 / np.linalg.norm(b2)
        if not (0 <= uv2[0] < W and 0 <= uv2[1] < H):
            b2, uv2 = b, cand[i]
        news.append((int(s), np.asarray(uv2, float), np.asarray(b2, float)))
        upts[s] = uv2
        umask[s] = True
        ubear[s] = b2
    return upts, umask, ubear, news


def _preprocess_image(im: torch.Tensor, clip_limit: float, tiles_x: int,
                      tiles_y: int, levels: int):
    """CLAHE + pyramid of a uint8 (or [0,1] float) image."""
    imf = im.to(torch.float32) if im.dtype == torch.uint8 else im * 255.0
    return img_ops.build_pyramid(
        img_ops.clahe(imf, clip_limit=clip_limit, tiles_x=tiles_x,
                      tiles_y=tiles_y), levels=levels)


class KLTFeatureTracker:
    """Fills the pipeline map's keypoint slots from raw grayscale
    images. Frames carry `_image` ((H,W) float32 in [0,1]); the tracker
    attaches `_pts` ((C,2) pixels) and `_pyr` (the CLAHE'd pyramid on
    the device, kept until the next frame has been tracked)."""

    def __init__(self, config: Config, device, capacity: int = 256,
                 pyramid_levels: int = 3, times: Optional[StageTimes] = None):
        self.config = config
        self.device = torch.device(device)
        self.capacity = capacity
        self.levels = pyramid_levels
        self.times = times if times is not None else StageTimes()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.random))
        self._prev: Optional[FrameRec] = None
        self._Kinv = None
        # the frame whose read is in flight (two-frame pipeline), and the
        # newest frame completed
        self._pending: Optional[dict] = None
        self.last_finished: Optional[FrameRec] = None
        # the device-chained route (Config.chained_frontend): the device
        # state (pts, valid, bear) of frame `_dev_frame_id`, the staged
        # slot update (keep, upts, umask, ubear), the staged first
        # observations of new detections, the step in flight's rotation
        self.chained = bool(config.chained_frontend) and not chained_frontend_missing(config)
        self._dev: Optional[tuple] = None
        self._dev_frame_id = None
        self._slot_upd: Optional[tuple] = None
        self._pending_new: list = []
        self._last_R = None
        # frames dispatched by the chained step and by the standard route
        # (every frame with the flag off; with it, the first frame and
        # every re-seed), and the device state's seeds from a standard frame
        self.stats = {"chained_frames": 0, "standard_frames": 0, "reseeds": 0}

    def track_frame(self, tracker_map: PipelineMap, frame: FrameRec,
                    rider=None, between=None) -> None:
        """One frame of tracking + detection: dispatch everything, then
        one packed read. `rider`: in-flight reads of the backend (a list
        of `utils.fetch.FetchHandle`) that this read completes, since
        they were started before it on the same stream: they are marked
        arrived with it. `between`: a callback run after the dispatch
        and before the read; the frame then stays in flight until the
        next call (or `finish_pending`). With `rider` None, `between`
        may return the riders (its own fresh write-backs) and runs
        before the read starts; with `rider` given, the read starts
        first and carries only those earlier riders."""
        image = frame._image
        if image is None:
            raise ValueError("KLTFeatureTracker needs frame._image")
        if image.dtype != np.uint8:
            image = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
        with self.times.stage("tracker_preprocess_time"):
            frame._pyr = _preprocess_image(
                torch.from_numpy(image).to(self.device),
                clip_limit=float(self.config.feature_tracker_clahe_clip_limit),
                tiles_x=int(self.config.feature_tracker_clahe_width),
                tiles_y=int(self.config.feature_tracker_clahe_height),
                levels=int(self.levels))
        frame._pts = np.zeros((self.capacity, 2), dtype=np.float64)
        prev = self._prev
        if self.chained and between is not None and prev is not None \
                and getattr(prev, "_pyr", None) is not None:
            # the device state must be the previous frame's: at the
            # bootstrap (or after a flush) finishing it seeds the state
            if self._dev_frame_id != prev.id:
                self.finish_pending()
            if self._dev is not None and self._dev_frame_id == prev.id:
                self._track_frame_chained(tracker_map, frame, rider, between)
                return
        # the previous frame's keypoints are this frame's KLT input
        self.finish_pending()

        dev_out = {}
        ctx = None
        self.stats["standard_frames"] += 1
        with self.times.stage("tracker_dispatch_time"):
            if prev is not None and prev.n_keypoints() > 0 \
                    and getattr(prev, "_pyr", None) is not None:
                ctx = self._dispatch_track(prev, frame, dev_out)
            detect = getattr(frame, "_detect_tag", True)
            if detect:
                cand, _, cvalid = img_ops.gftt_candidates(
                    frame._pyr[0], max_candidates=1024, quality_level=1e-3,
                    border=20)
                dev_out["cand"] = cand
                dev_out["cvalid"] = cvalid
        riders = []

        def attach(handles):
            for h in handles or ():
                if not h.riding:
                    h.riding = True
                    riders.append(h)

        if between is not None and rider is None:
            attach(between())   # its fresh write-backs ride this read
        else:
            attach(rider)
        handle = fetch_packed_start(dev_out)
        if between is not None and rider is not None:
            between()           # this read carries only the earlier riders
        self._pending = dict(frame=frame, prev=prev, ctx=ctx, detect=detect,
                             handle=handle, map=tracker_map, riders=riders)
        self._prev = frame
        if between is None:
            self.finish_pending()

    def finish_pending(self) -> None:
        """Complete the frame whose read is in flight: wait for the read,
        mark its riders arrived, then the host half of tracking and
        detection. Nothing to do when no frame is pending."""
        p, self._pending = self._pending, None
        if p is None:
            return
        with self.times.stage("tracker_fetch_time"):
            vals = p["handle"].get()
        for h in p["riders"]:
            h.arrived = True
        frame, prev, tracker_map = p["frame"], p["prev"], p["map"]
        chained = p["ctx"] == "chained"
        if chained:
            keep = self._finish_track_chained(tracker_map, prev, frame, vals)
            # detections into the free slots (none on a frame that does
            # not detect): the slot update the next chained step applies
            *upd, self._pending_new = chained_injection(
                frame._pts[frame.track_ids >= 0], np.nonzero(frame.track_ids < 0)[0],
                vals["cand"] if p["detect"] else None,
                vals["cvalid"] if p["detect"] else None, frame.K, self._last_R,
                frame._pyr[0].shape, self.config.feature_tracker_max_keypoint_detection,
                self.config.feature_tracker_min_keypoint_distance, self.capacity)
            self._slot_upd = (keep, *upd)
        else:
            if p["ctx"] is not None:
                self._finish_track(tracker_map, prev, frame, p["ctx"], vals)
            if p["detect"]:
                self._finish_detect(tracker_map, frame, vals)
        if prev is not None:
            prev._pyr = None  # release_image_buffer
        self._finalize_frame(tracker_map, frame)
        if self.chained and not chained and (frame.track_ids >= 0).any():
            # a standard-route frame: (re)seed the device state from its
            # final layout, so that the next chained step pairs its slots
            # with this frame's pyramid; anything staged is stale
            pts, valid, bear = self._upload(frame._pts.astype(np.float32),
                                            frame.track_ids >= 0, frame.bearings)
            self._dev = (pts.to(torch.float32), valid > 0.5, bear)
            self._dev_frame_id = frame.id
            self._slot_upd, self._pending_new = None, []
            self.stats["reseeds"] += 1

    def flush(self) -> None:
        """Complete the frame in flight (`finish_pending`), then drop
        what the chained route staged for the next frame: its slot
        update and the first observations of its new detections. The
        frame after a flush (or after a restore, whose tracker is new)
        goes the standard route from the host's layout and re-seeds the
        device state; the dropped detections are detected again there."""
        self.finish_pending()
        self._dev = self._dev_frame_id = self._slot_upd = None
        self._pending_new = []

    def _upload(self, *arrays):
        """Host arrays -> float64 device tensors of the same shapes, in
        one copy (from pinned memory without a sync on the card)."""
        host = torch.from_numpy(np.concatenate(
            [np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays]))
        if self.device.type == "cuda":
            host = host.pin_memory().to(self.device, non_blocking=True)
        parts = torch.split(host, [int(np.size(a)) for a in arrays])
        return [x.reshape(np.shape(a)) for x, a in zip(parts, arrays)]

    def _finalize_frame(self, tracker_map: PipelineMap, frame: FrameRec) -> None:
        """Post-tracking host work on the frame's final keypoints: depth
        sampling (nearest pixel, 0 outside the image), the painter tap,
        and the image release."""
        dimg = getattr(frame, "_depth_img", None)
        if dimg is not None:
            kd = np.zeros((self.capacity,), dtype=np.float64)
            Hd, Wd = dimg.shape
            for k in np.nonzero(frame.track_ids >= 0)[0]:
                u = int(round(frame._pts[k, 0]))
                v = int(round(frame._pts[k, 1]))
                if 0 <= u < Wd and 0 <= v < Hd:
                    kd[k] = float(dimg[v, u])
            frame.kp_depth = kd
            frame._depth_img = None
        if inspection.inspect_get(inspection.PAINTER_ENABLE):
            active = np.nonzero(frame.track_ids >= 0)[0]
            lengths = np.array([
                len(t.obs) if (t := tracker_map.get_track(frame, int(k))) else 0
                for k in active])
            inspection.inspect(inspection.PAINTER_FRAME, {
                "image": frame._image, "pts": frame._pts[active].copy(),
                "lengths": lengths, "frame_id": frame.id, "t": frame.t,
            })
        frame._image = None
        self.last_finished = frame

    def _gyro_delta_q(self, prev: FrameRec, frame: FrameRec) -> np.ndarray:
        """Gyro-only Δq over the inter-frame IMU samples at the previous
        frame's bias."""
        dq = np.array([1.0, 0.0, 0.0, 0.0])
        t_cur = prev.t
        for i in range(len(frame.imu_t)):
            dt = float(frame.imu_t[i] - t_cur)
            if dt <= 0:
                continue
            dq = nputil.quat_mul(dq, nputil.expmap((frame.imu_w[i] - prev.bg) * dt))
            t_cur = float(frame.imu_t[i])
        if frame.t > t_cur and len(frame.imu_t):
            dq = nputil.quat_mul(dq, nputil.expmap(
                (frame.imu_w[-1] - prev.bg) * (frame.t - t_cur)))
        return nputil.quat_normalize(dq)

    def flow_rotation(self, prev: FrameRec, frame: FrameRec):
        """The camera rotation that predicts the flow from `prev` to
        `frame`, delta_key_q = (q_bc^† · q_bi · Δq_gyro · q_bi^† · q_bc)^†
        as a matrix; None when prediction is off or no IMU sample came."""
        if not (self.config.feature_tracker_predict_keypoints
                and len(frame.imu_t) > 0):
            return None
        dq = self._gyro_delta_q(prev, frame)
        q_cam = nputil.quat_mul(
            nputil.quat_conj(prev.q_bc),
            nputil.quat_mul(prev.q_bi, nputil.quat_mul(
                dq, nputil.quat_mul(nputil.quat_conj(frame.q_bi), frame.q_bc))))
        return nputil.quat_to_matrix(nputil.quat_conj(q_cam))

    def predicted_init(self, prev: FrameRec, frame: FrameRec, pts_prev,
                       bearings_prev, n: int) -> np.ndarray:
        """Rotation-predicted initial flow (`flow_rotation`)."""
        pts_init = pts_prev.copy()
        R = self.flow_rotation(prev, frame)
        if R is None:
            return pts_init
        H, W = frame._pyr[0].shape
        pred_b = bearings_prev @ R.T
        z = np.clip(pred_b[:, 2:3], 1e-6, None)
        uv = (frame.K @ (pred_b / z).T).T[:, :2]
        inb = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
               & (uv[:, 1] < H) & (pred_b[:, 2] > 0))
        pts_init[:n] = np.where(inb[:, None], uv, pts_prev[:n]).astype(np.float32)
        return pts_init

    def _dispatch_track(self, prev: FrameRec, frame: FrameRec, dev_out: dict):
        """KLT + the post-KLT gates for the previous frame's keypoints
        (compacted into the first n slots)."""
        cfg = self.config
        C = self.capacity
        slots = np.nonzero(prev.track_ids >= 0)[0]
        n = len(slots)
        valid = np.zeros((C,), dtype=bool)
        valid[:n] = True
        pts_prev = np.zeros((C, 2), dtype=np.float32)
        pts_prev[:n] = prev._pts[slots]
        bearings_prev = prev.bearings[slots]
        pts_init = self.predicted_init(prev, frame, pts_prev, bearings_prev, n)

        dev = self.device
        nxt, status = klt.track_keypoints(
            prev._pyr, frame._pyr, torch.from_numpy(pts_prev).to(dev),
            torch.from_numpy(pts_init).to(dev), torch.from_numpy(valid).to(dev),
            win=21, iters=30, eps=0.01, border=20)
        bp = np.zeros((C, 3))
        bp[:, 2] = 1.0
        bp[:n] = bearings_prev
        if self._Kinv is None:
            self._Kinv = torch.as_tensor(np.linalg.inv(frame.K),
                                         dtype=torch.float64, device=dev)
        b_next, status, no_trans = _post_klt_gates(
            self.generator, nxt, status,
            torch.as_tensor(bp, dtype=torch.float64, device=dev), self._Kinv,
            rot_thresh_deg=float(cfg.rotation_ransac_threshold),
            mis_thresh_deg=float(cfg.rotation_misalignment_threshold))
        dev_out.update(nxt=nxt, status=status, b_next=b_next,
                       no_trans=no_trans)
        return {"slots": slots, "n": n}

    def _track_frame_chained(self, tracker_map: PipelineMap, frame: FrameRec,
                             rider, between) -> None:
        """A frame of the chained route: dispatch its chained step and
        GFTT, start its packed read with the earlier riders, finish the
        previous frame (its read started a frame ago; this stages the
        slot update for the next step), run `between`, and leave this
        frame pending."""
        prev = self._prev
        dev_out = {}
        with self.times.stage("tracker_dispatch_time"):
            self._dispatch_chained(prev, frame, dev_out)
            detect = getattr(frame, "_detect_tag", True)
            if detect:
                cand, _, cvalid = img_ops.gftt_candidates(
                    frame._pyr[0], max_candidates=1024, quality_level=1e-3,
                    border=20)
                dev_out["cand"] = cand
                dev_out["cvalid"] = cvalid
        riders = []
        for h in rider or ():
            if not h.riding:
                h.riding = True
                riders.append(h)
        handle = fetch_packed_start(dev_out)
        self.finish_pending()
        between()
        self._pending = dict(frame=frame, prev=prev, ctx="chained", detect=detect,
                             handle=handle, map=tracker_map, riders=riders)
        self._prev = frame

    def _dispatch_chained(self, prev: FrameRec, frame: FrameRec, dev_out: dict):
        """The chained step from the device state of `prev`, with the
        staged slot update (none staged: keep every slot) and the flow
        rotation uploaded in one copy."""
        cfg = self.config
        C = self.capacity
        if self._slot_upd is None:
            ubear = np.zeros((C, 3))
            ubear[:, 2] = 1.0
            upd = (np.ones((C,), bool), np.zeros((C, 2), np.float32),
                   np.zeros((C,), bool), ubear)
        else:
            upd, self._slot_upd = self._slot_upd, None
        R = self.flow_rotation(prev, frame)
        self._last_R = np.eye(3) if R is None else R
        keep, upts, umask, ubear, R_d, K_d = self._upload(*upd, self._last_R, frame.K)
        if self._Kinv is None:
            self._Kinv = torch.as_tensor(np.linalg.inv(frame.K),
                                         dtype=torch.float64, device=self.device)
        nxt, status, b_next, no_trans = _chained_track_step(
            self.generator, prev._pyr, frame._pyr, *self._dev, keep > 0.5,
            upts.to(torch.float32), umask > 0.5, ubear, R_d, K_d, self._Kinv,
            rot_thresh_deg=float(cfg.rotation_ransac_threshold),
            mis_thresh_deg=float(cfg.rotation_misalignment_threshold))
        self._dev = (nxt, status, b_next)
        self._dev_frame_id = frame.id
        self.stats["chained_frames"] += 1
        dev_out.update(nxt=nxt, status=status, b_next=b_next, no_trans=no_trans)

    def _finish_track_chained(self, tracker_map: PipelineMap, prev: FrameRec,
                              frame: FrameRec, vals: dict) -> np.ndarray:
        """Host half of a chained frame's tracking (`chained_keep`): the
        accepted slots extend their tracks in place, and the staged new
        detections record their first observation here, at the position
        the device tracks them from. Returns the keep mask of the slot
        update."""
        C = self.capacity
        nxt = np.asarray(vals["nxt"], dtype=np.float64)
        b_next = np.asarray(vals["b_next"], dtype=np.float64)
        if bool(vals["no_trans"]):
            frame.no_translation = True
        # the device tracked a superset (host drops land a frame late):
        # only slots with a live host track extend
        lengths = np.zeros((C,), dtype=np.int64)
        live = np.zeros((C,), dtype=bool)
        for i in np.nonzero(vals["status"] & (prev.track_ids >= 0))[0]:
            tr = tracker_map.get_track(prev, int(i))
            if tr is not None and not tr.trash:
                lengths[i] = len(tr.obs)
                live[i] = True
        pending = {s: (uv, b) for s, uv, b in self._pending_new}
        self._pending_new = []
        accept, keep, placed = chained_keep(
            nxt, vals["status"], lengths, live, list(pending),
            self.config.feature_tracker_min_keypoint_distance)
        for i in np.nonzero(accept)[0]:
            tr = tracker_map.get_track(prev, int(i), create=True)
            frame.bearings[i] = b_next[i]
            frame._pts[i] = nxt[i]
            tracker_map.add_observation(tr, frame, int(i))
            tr.life += 1
        for s in placed:
            frame._pts[s], frame.bearings[s] = pending[s]
            tracker_map.get_track(frame, s, create=True)
        return keep

    def _finish_track(self, tracker_map: PipelineMap, prev: FrameRec,
                      frame: FrameRec, ctx: dict, vals: dict) -> None:
        """Host half: Poisson re-filter + track extension."""
        cfg = self.config
        C = self.capacity
        slots, n = ctx["slots"], ctx["n"]
        nxt = np.asarray(vals["nxt"], dtype=np.float64)
        status = vals["status"].copy()
        status[n:] = False
        b_next = np.asarray(vals["b_next"], dtype=np.float64)
        if bool(vals["no_trans"]):
            frame.no_translation = True
        lengths = np.zeros((C,), dtype=np.int64)
        keep_ok = np.zeros((C,), dtype=bool)
        for i in range(n):
            if not status[i]:
                continue
            tr = tracker_map.get_track(prev, int(slots[i]))
            if tr is None or tr.trash:
                continue
            lengths[i] = len(tr.obs)
            keep_ok[i] = True
        order = np.argsort(-lengths, kind="stable")
        accept = native.poisson_filter(nxt, order, keep_ok & status,
                                       cfg.feature_tracker_min_keypoint_distance)
        out_slot = 0
        for i in np.nonzero(accept)[0]:
            tr = tracker_map.get_track(prev, int(slots[i]), create=True)
            frame.bearings[out_slot] = b_next[i]
            frame._pts[out_slot] = nxt[i]
            tracker_map.add_observation(tr, frame, out_slot)
            tr.life += 1
            out_slot += 1

    def _finish_detect(self, tracker_map: PipelineMap, frame: FrameRec,
                       vals: dict) -> None:
        """New keypoints into free slots: existing keypoints first, then
        GFTT candidates in response order, through the spacing filter."""
        cfg = self.config
        C = self.capacity
        used = np.nonzero(frame.track_ids >= 0)[0]
        if C - len(used) <= 0:
            return
        cand = vals["cand"]
        cvalid = vals["cvalid"]
        n_pre = len(used)
        all_pts = np.concatenate([frame._pts[used], cand], axis=0)
        keep_ok = np.concatenate([np.ones(n_pre, bool), cvalid])
        accept = native.poisson_filter(all_pts, np.arange(len(all_pts)), keep_ok,
                                       cfg.feature_tracker_min_keypoint_distance)
        sel = np.nonzero(accept[n_pre:])[0]
        sel = sel[:cfg.feature_tracker_max_keypoint_detection]
        Kinv = np.linalg.inv(frame.K)
        slot = n_pre
        for i in sel:
            if slot >= C:
                break
            b = Kinv @ np.array([cand[i, 0], cand[i, 1], 1.0])
            b /= np.linalg.norm(b)
            frame.bearings[slot] = b
            frame._pts[slot] = cand[i]
            tracker_map.get_track(frame, slot, create=True)
            slot += 1


def detect_no_translation(generator, bearings_prev, bearings_next, valid,
                          cfg) -> bool:
    """Pure-rotation (FT_NO_TRANSLATION) detector over matched (C,3)
    bearing sets with `valid`: 2-pt rotation RANSAC, then the
    70th-percentile misalignment angle against the threshold."""
    dev = generator.device
    R_rot, r_mask, _ = stereo_mod.find_rotation_matrix(
        generator, torch.as_tensor(bearings_prev, device=dev),
        torch.as_tensor(bearings_next, device=dev),
        valid=torch.as_tensor(valid, device=dev),
        threshold=np.pi / 180.0 * cfg.rotation_ransac_threshold)
    R_rot, r_mask = fetch_packed((R_rot, r_mask))
    r_mask = r_mask & valid
    if r_mask.sum() > 0:
        cosang = np.clip(np.sum((bearings_prev @ R_rot.T) * bearings_next,
                                axis=1), -1, 1)
        angles = np.sort(np.degrees(np.arccos(cosang[r_mask])))
        misalignment = angles[len(angles) * 7 // 10]
    else:
        misalignment = 0.0
    return misalignment < cfg.rotation_misalignment_threshold
