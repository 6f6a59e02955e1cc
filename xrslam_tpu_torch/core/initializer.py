"""SfM + IMU initialization (port of `xrslam_tpu/core/initializer.py`).

  mirror_keyframe_map — clone 8 keyframes (gap from the config) from the
                        tracker map with IMU concatenation
  init_sfm            — match/parallax gates, homography + essential
                        hypotheses (8 R,t) scored by triangulation,
                        metric rescale by measured keypoint depths,
                        reprojection-prior localization of the middle
                        frames, vision-only BA, RPE pruning
  init_imu            — gyro-bias LS, gravity/scale/velocity linear
                        solve, S² gravity refinement, gravity-aligned
                        application
  initialize          — full VI-BA, hand-off to the SlidingWindowTracker
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..estimation.solver import SolveOptions, solve_window
from ..geometry import homography as homo_mod
from ..geometry.essential import decompose_essential
from ..imu import preintegration as pre
from ..ransac import stereo as stereo_mod
from ..utils.timing import StageTimes
from . import nputil
from .map import FrameRec, PipelineMap
from .sliding_window import SlidingWindowTracker
from .window_builder import (extract_window, interval_samples, needed_imu_cap,
                             triangulate_track, write_back)

GRAVITY_NOMINAL = pre.GRAVITY_NOMINAL


class Initializer:
    def __init__(self, config: Config, device,
                 times: Optional[StageTimes] = None):
        self.config = config
        self.device = torch.device(device)
        # RANSAC draws: a generator on the device, seeded per instance
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.random))
        self.times = times if times is not None else StageTimes()
        self.map: Optional[PipelineMap] = None
        self.noise = pre.ImuNoise.from_config(config, device=self.device)
        # the last depth rescale of init_sfm: factor and ratio count
        self.depth_scale: Optional[float] = None
        self.depth_ratios = 0

    def _extract(self, pmap, frames, K_slots, **kw):
        return extract_window(pmap, frames, K_slots,
                              self.config.init_landmark_slots, self.noise,
                              self.device, **kw)

    # ------------------------------------------------------------------
    def mirror_keyframe_map(self, tracker_map: PipelineMap, init_frame_id: int):
        cfg = self.config
        idx_last = tracker_map.frame_index_by_id(init_frame_id)
        if idx_last is None:
            self.map = None
            return
        gap = cfg.initializer_keyframe_gap
        dist = gap * (cfg.initializer_keyframe_num - 1)
        if idx_last < dist:
            self.map = None
            return
        idxs = [idx_last - dist + i * gap for i in range(cfg.initializer_keyframe_num)]
        pmap = PipelineMap()
        clones: List[FrameRec] = []
        for i in idxs:
            f = tracker_map.frames[i].clone_shallow()
            f.track_ids = np.full_like(f.track_ids, -1)
            clones.append(f)
            pmap.frames.append(f)
        for j in range(1, len(idxs)):
            old_i = tracker_map.frames[idxs[j - 1]]
            old_j = tracker_map.frames[idxs[j]]
            new_i, new_j = clones[j - 1], clones[j]
            for ki in np.nonzero(old_i.track_ids >= 0)[0]:
                tr_old = tracker_map.tracks.get(int(old_i.track_ids[ki]))
                if tr_old is None:
                    continue
                kj = tr_old.obs.get(old_j.id)
                if kj is None:
                    continue
                tr_new = pmap.get_track(new_i, int(ki), create=True)
                pmap.add_observation(tr_new, new_j, int(kj))
            spans = tracker_map.frames[idxs[j - 1] + 1: idxs[j] + 1]
            new_j.imu_t = np.concatenate([f.imu_t for f in spans])
            new_j.imu_w = np.concatenate([f.imu_w for f in spans])
            new_j.imu_a = np.concatenate([f.imu_a for f in spans])
        self.map = pmap

    # ------------------------------------------------------------------
    def initialize(self) -> Optional[SlidingWindowTracker]:
        if self.map is None:
            return None
        if not self.init_sfm():
            return None
        if not self.init_imu():
            return None
        frames = self.map.frames
        frames[0].fix_pose = True
        state, data, meta = self._extract(
            self.map, frames, len(frames), track_filter=lambda t: t.valid,
            imu_cap=128)
        st, _ = solve_window(state, data, SolveOptions(
            iterations=self.config.solver_iteration_limit))
        write_back(self.map, st, meta)
        frames[0].fix_pose = False
        for f in frames:
            f.keyframe = True
        tracker = SlidingWindowTracker(self.map, self.config, self.device,
                                       times=self.times)
        self.map = None
        return tracker

    # ------------------------------------------------------------------
    def init_sfm(self) -> bool:
        cfg = self.config
        pmap = self.map
        fi = pmap.frames[0]
        fj = pmap.frames[-1]
        m1, m2, tids, kis = [], [], [], []
        for ki in np.nonzero(fi.track_ids >= 0)[0]:
            tr = pmap.tracks.get(int(fi.track_ids[ki]))
            if tr is None:
                continue
            kj = tr.obs.get(fj.id)
            if kj is None:
                continue
            b1 = fi.bearings[ki]
            b2 = fj.bearings[kj]
            m1.append(b1[:2] / b1[2])
            m2.append(b2[:2] / b2[2])
            tids.append(tr.id)
            kis.append(int(ki))
        if len(m1) < cfg.initializer_min_matches:
            return False
        m1 = np.stack(m1)
        m2 = np.stack(m2)
        fu, fv = fi.K[0, 0], fi.K[1, 1]
        par = np.linalg.norm((m1 - m2) * np.array([fu, fv]), axis=1).mean()
        if par < cfg.initializer_min_parallax:
            return False

        # 8 (R,t) hypotheses from homography + essential
        N_CAP = 256
        n = min(len(m1), N_CAP)
        a1 = np.zeros((N_CAP, 2))
        a2 = np.zeros((N_CAP, 2))
        a1[:n] = m1[:n]
        a2[:n] = m2[:n]
        vv = np.zeros((N_CAP,), dtype=bool)
        vv[:n] = True
        dev = self.device

        def T(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)

        H, _, _ = stereo_mod.find_homography_matrix(
            self.generator, T(a1), T(a2), valid=torch.as_tensor(vv, device=dev),
            threshold=0.7 / fu, n_hyp=128)
        RH1, RH2, TH1, TH2, _, _, pure = homo_mod.decompose_homography(H)
        h1 = np.concatenate([a1, np.ones((N_CAP, 1))], axis=1)
        h2 = np.concatenate([a2, np.ones((N_CAP, 1))], axis=1)
        E, _, _ = stereo_mod.find_essential_matrix(
            self.generator, T(h1), T(h2), valid=torch.as_tensor(vv, device=dev),
            threshold=0.7 / fu, n_hyp=64)
        RE1, RE2, TE = decompose_essential(E)
        RH1, RH2, TH1, TH2, pure, RE1, RE2, TE = (
            x.cpu().numpy() for x in (RH1, RH2, TH1, TH2, pure, RE1, RE2, TE))
        if bool(pure):
            return False
        Rs, Ts = [], []
        for R, Tt in ((RH1, TH1), (RH2, TH2)):
            Tt = Tt / max(np.linalg.norm(Tt), 1e-12)
            Rs += [R, R]
            Ts += [Tt, -Tt]
        TE = TE / max(np.linalg.norm(TE), 1e-12)
        Rs += [RE1, RE1, RE2, RE2]
        Ts += [TE, -TE, TE, -TE]

        best = None
        for R, Tt in zip(Rs, Ts):
            P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
            P2 = np.concatenate([R, Tt[:, None]], axis=1)
            pts, status, score = _triangulate_pairs(P1, P2, m1, m2)
            count = int(status.sum())
            if best is None:
                best = (count, score, R, Tt, pts, status)
            else:
                bc, bs = best[0], best[1]
                if (count > cfg.initializer_min_triangulation and score < bs) or count > bc:
                    best = (count, score, R, Tt, pts, status)
        count, _, R, Tt, pts, status = best
        if count < cfg.initializer_min_triangulation:
            return False

        # depth-camera metric rescale: with measured keypoint depths on
        # the first keyframe, scale T and the points by the median
        # measured/triangulated depth ratio (at least 5 ratios)
        if fi.kp_depth is not None:
            ratios = []
            for k in range(len(m1)):
                if not status[k]:
                    continue
                zd = float(fi.kp_depth[kis[k]])
                zt = float(pts[k][2])
                if zd > 1e-3 and zt > 1e-6:
                    ratios.append(zd / zt)
            if len(ratios) >= 5:
                sc = float(np.median(ratios))
                Tt = Tt * sc
                pts = pts * sc
                self.depth_scale, self.depth_ratios = sc, len(ratios)

        _set_camera_pose(fi, np.array([1.0, 0, 0, 0]), np.zeros(3))
        _set_camera_pose(fj, nputil.matrix_to_quat(R.T), -(R.T @ Tt))
        for k in range(len(m1)):
            if not status[k]:
                continue
            tr = pmap.tracks.get(tids[k])
            if tr is None:
                continue
            tr.p_w = pts[k]
            tr.valid = True
            tr.triangulated = True

        for j in range(1, len(pmap.frames) - 1):
            prev = pmap.frames[j - 1]
            cur = pmap.frames[j]
            cur.q, cur.p = prev.q.copy(), prev.p.copy()
            self._solve_pnp_prior(cur, anchor_frame=fi)

        frames_by_id = {f.id: f for f in pmap.frames}
        for tr in pmap.tracks.values():
            if tr.valid:
                continue
            p, _ = triangulate_track(tr, frames_by_id)
            if p is not None:
                tr.p_w = p
                tr.valid = True
                tr.triangulated = True

        # vision-only BA, frame 0 fixed
        frames = pmap.frames
        saved = [(f.fix_pose, f.fix_motion) for f in frames]
        frames[0].fix_pose = True
        for f in frames:
            f.fix_motion = True
        state, data, meta = self._extract(pmap, frames, len(frames),
                                          track_filter=lambda t: t.valid,
                                          with_preint=False)
        st, _ = solve_window(state, data, SolveOptions(
            iterations=self.config.solver_iteration_limit, use_preint=False))
        write_back(pmap, st, meta)
        for f, (fp, fm) in zip(frames, saved):
            f.fix_pose, f.fix_motion = fp, fm
        self._prune_rpe(3.0)
        return True

    def _solve_pnp_prior(self, frame: FrameRec, anchor_frame: FrameRec):
        """Localize `frame` against triangulated tracks also seen in the
        anchor frame (reprojection priors, landmarks fixed)."""
        pmap = self.map
        wframes = [anchor_frame, frame] if anchor_frame is not frame else [frame]
        saved = [(f.fix_pose, f.fix_motion) for f in wframes]
        for f in wframes[:-1]:
            f.fix_pose = True
        for f in wframes:
            f.fix_motion = True

        def tf(tr):
            return (tr.valid and tr.triangulated and anchor_frame.id in tr.obs
                    and frame.id in tr.obs)

        state, data, meta = self._extract(pmap, wframes, 2, track_filter=tf,
                                          with_preint=False)
        data = data._replace(fix_landmark=torch.ones_like(data.fix_landmark))
        st, _ = solve_window(state, data, SolveOptions(
            iterations=self.config.solver_iteration_limit, use_preint=False))
        for f, (fp, fm) in zip(wframes, saved):
            f.fix_pose, f.fix_motion = fp, fm
        write_back(pmap, st, meta, write_landmarks=False, frame_subset={frame.id})

    def _prune_rpe(self, px_thresh: float):
        pmap = self.map
        frames_by_id = {f.id: f for f in pmap.frames}
        dead = []
        for tr in pmap.tracks.values():
            if not tr.valid or tr.p_w is None:
                if not tr.valid:
                    dead.append(tr.id)
                continue
            rpe, cnt, ok = 0.0, 0, True
            for fid, k in tr.obs.items():
                f = frames_by_id.get(fid)
                if f is None:
                    continue
                q_wc, p_wc = f.camera_pose()
                y = nputil.quat_rotate_inv(q_wc, tr.p_w - p_wc)
                if y[2] <= 1e-6:
                    ok = False
                    break
                b = f.bearings[k]
                du = (y[0] / y[2] - b[0] / b[2]) * f.K[0, 0]
                dv = (y[1] / y[2] - b[1] / b[2]) * f.K[1, 1]
                rpe += float(np.hypot(du, dv))
                cnt += 1
            if not ok or rpe / max(cnt, 1) > px_thresh:
                dead.append(tr.id)
        for tid in dead:
            pmap.erase_track(tid)

    # ------------------------------------------------------------------
    def init_imu(self) -> bool:
        cfg = self.config
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.gravity = np.zeros(3)
        self.scale = 1.0
        self.velocities = [np.zeros(3) for _ in self.map.frames]
        self._preintegrate()
        self._solve_gyro_bias()
        self._preintegrate()
        self._solve_gravity_scale_velocity()
        if not (0.001 < self.scale < 1.0):
            return False
        if cfg.initializer_refine_imu:
            self._refine_scale_velocity_via_gravity()
            if not (0.001 < self.scale < 1.0):
                return False
        return self._apply_init()

    def _preintegrate(self, cap: int = 256):
        """Preintegrate every keyframe interval at the current bias
        estimate (one batched integration, one host copy)."""
        cap = needed_imu_cap([[f] for f in self.map.frames[1:]], floor=cap)
        n_int = len(self.map.frames) - 1
        t_bufs = np.zeros((n_int, cap))
        w_bufs = np.zeros((n_int, cap, 3))
        a_bufs = np.zeros((n_int, cap, 3))
        t_ends = np.zeros((n_int,))
        counts = np.zeros((n_int,), dtype=np.int64)
        for j in range(1, len(self.map.frames)):
            f = self.map.frames[j]
            t_buf, w_buf, a_buf, n, t0 = interval_samples([f], cap)
            t_bufs[j - 1], w_bufs[j - 1], a_bufs[j - 1] = t_buf, w_buf, a_buf
            t_ends[j - 1] = f.t - t0
            counts[j - 1] = n
        dev = self.device

        def T(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                                   device=dev)

        batch = pre.integrate_batch(
            T(t_bufs), T(w_bufs), T(a_bufs), T(t_ends),
            T(np.broadcast_to(self.bg, (n_int, 3))),
            T(np.broadcast_to(self.ba, (n_int, 3))), self.noise,
            torch.as_tensor(counts, device=dev), compute_sqrt_inv=False,
            steps=int(counts.max()) if n_int else 0)
        host = pre.PreintDelta(*(x.cpu().numpy() for x in batch))
        self.deltas = [None] + [pre.PreintDelta(*(x[j] for x in host))
                                for j in range(n_int)]

    def _imu_pose(self, f: FrameRec):
        return nputil.quat_mul(f.q, f.q_bi), f.p + nputil.quat_rotate(f.q, f.p_bi)

    def _solve_gyro_bias(self):
        """LS gyro bias from rotation-only preintegration residuals."""
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for j in range(1, len(self.map.frames)):
            qi, _ = self._imu_pose(self.map.frames[j - 1])
            qj, _ = self._imu_pose(self.map.frames[j])
            d = self.deltas[j]
            r = nputil.logmap(nputil.quat_mul(
                nputil.quat_conj(nputil.quat_mul(qi, d.q)), qj))
            A += d.dq_dbg.T @ d.dq_dbg
            b += d.dq_dbg.T @ r
        self.bg = np.linalg.lstsq(A, b, rcond=None)[0]

    def _solve_gravity_scale_velocity(self):
        """Linear system for gravity, scale and per-frame velocity."""
        N = len(self.map.frames)
        A = np.zeros(((N - 1) * 6, 3 + 1 + 3 * N))
        b = np.zeros((N - 1) * 6)
        for j in range(1, N):
            i = j - 1
            fi, fj = self.map.frames[i], self.map.frames[j]
            d = self.deltas[j]
            dt = float(d.t)
            _, pci = fi.camera_pose()
            _, pcj = fj.camera_pose()
            Ri = nputil.quat_to_matrix(fi.q)
            Rj = nputil.quat_to_matrix(fj.q)
            A[i * 6: i * 6 + 3, 0:3] = -0.5 * dt * dt * np.eye(3)
            A[i * 6: i * 6 + 3, 3] = pcj - pci
            A[i * 6: i * 6 + 3, 4 + i * 3: 7 + i * 3] = -dt * np.eye(3)
            b[i * 6: i * 6 + 3] = Ri @ d.p + (Rj @ fj.p_bc - Ri @ fi.p_bc)
            A[i * 6 + 3: i * 6 + 6, 0:3] = -dt * np.eye(3)
            A[i * 6 + 3: i * 6 + 6, 4 + i * 3: 7 + i * 3] = -np.eye(3)
            A[i * 6 + 3: i * 6 + 6, 4 + j * 3: 7 + j * 3] = np.eye(3)
            b[i * 6 + 3: i * 6 + 6] = Ri @ d.v
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        g = x[0:3]
        self.gravity = g / max(np.linalg.norm(g), 1e-12) * GRAVITY_NOMINAL
        self.scale = float(x[3])
        self.velocities = [x[4 + i * 3: 7 + i * 3] for i in range(N)]

    def _refine_scale_velocity_via_gravity(self):
        """One damped refinement on the S² tangent of gravity."""
        damp = 0.1
        N = len(self.map.frames)
        A = np.zeros(((N - 1) * 6, 2 + 1 + 3 * N))
        b = np.zeros((N - 1) * 6)
        Tg = _s2_tangential_basis(self.gravity)
        for j in range(1, N):
            i = j - 1
            fi, fj = self.map.frames[i], self.map.frames[j]
            d = self.deltas[j]
            dt = float(d.t)
            _, pci = fi.camera_pose()
            _, pcj = fj.camera_pose()
            Ri = nputil.quat_to_matrix(fi.q)
            Rj = nputil.quat_to_matrix(fj.q)
            A[i * 6: i * 6 + 3, 0:2] = -0.5 * dt * dt * Tg
            A[i * 6: i * 6 + 3, 2] = pcj - pci
            A[i * 6: i * 6 + 3, 3 + i * 3: 6 + i * 3] = -dt * np.eye(3)
            b[i * 6: i * 6 + 3] = (0.5 * dt * dt * self.gravity + Ri @ d.p
                                   + (Rj @ fj.p_bc - Ri @ fi.p_bc))
            A[i * 6 + 3: i * 6 + 6, 0:2] = -dt * Tg
            A[i * 6 + 3: i * 6 + 6, 3 + i * 3: 6 + i * 3] = -np.eye(3)
            A[i * 6 + 3: i * 6 + 6, 3 + j * 3: 6 + j * 3] = np.eye(3)
            b[i * 6 + 3: i * 6 + 6] = dt * self.gravity + Ri @ d.v
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        g = self.gravity + damp * Tg @ x[0:2]
        self.gravity = g / max(np.linalg.norm(g), 1e-12) * GRAVITY_NOMINAL
        self.scale = float(x[2])
        self.velocities = [x[3 + i * 3: 6 + i * 3] for i in range(N)]

    def _apply_init(self) -> bool:
        """Gravity-align, scale, set velocities/biases, re-triangulate."""
        g_nominal = np.array([0.0, 0.0, -GRAVITY_NOMINAL])
        q_align = nputil.quat_from_two_vectors(self.gravity, g_nominal)
        for i, f in enumerate(self.map.frames):
            qi, pi = self._imu_pose(f)
            qi = nputil.quat_mul(q_align, qi)
            pi = self.scale * nputil.quat_rotate(q_align, pi)
            qb = nputil.quat_normalize(nputil.quat_mul(qi, nputil.quat_conj(f.q_bi)))
            f.q = qb
            f.p = pi - nputil.quat_rotate(qb, f.p_bi)
            f.v = nputil.quat_rotate(q_align, self.velocities[i])
            f.bg = self.bg.copy()
            f.ba = self.ba.copy()
        n_ok = 0
        frames_by_id = {f.id: f for f in self.map.frames}
        for tr in self.map.tracks.values():
            p, _ = triangulate_track(tr, frames_by_id)
            if p is not None:
                tr.p_w = p
                tr.valid = True
                tr.triangulated = True
                n_ok += 1
            else:
                tr.valid = False
        return n_ok >= self.config.initializer_min_landmarks


def _triangulate_pairs(P1, P2, m1, m2):
    """Two-view DLT of all matches with cheirality + depth < 100 gates
    and the symmetric reprojection score."""
    n = len(m1)
    pts = np.zeros((n, 3))
    status = np.zeros(n, dtype=bool)
    score = 0.0
    for j in range(n):
        b1 = np.array([m1[j, 0], m1[j, 1], 1.0])
        b2 = np.array([m2[j, 0], m2[j, 1], 1.0])
        A = np.stack([b1[0] * P1[2] - b1[2] * P1[0], b1[1] * P1[2] - b1[2] * P1[1],
                      b2[0] * P2[2] - b2[2] * P2[0], b2[1] * P2[2] - b2[2] * P2[1]])
        _, _, vt = np.linalg.svd(A)
        q = vt[-1]
        q1 = P1 @ q
        q2 = P2 @ q
        if q1[2] * q[3] > 0 and q2[2] * q[3] > 0 and \
                q1[2] / q[3] < 100 and q2[2] / q[3] < 100:
            pts[j] = q[:3] / q[3]
            status[j] = True
            score += 0.5 * (np.sum((q1[:2] / q1[2] - m1[j]) ** 2)
                            + np.sum((q2[:2] / q2[2] - m2[j]) ** 2))
    return pts, status, score


def _set_camera_pose(f: FrameRec, q_wc: np.ndarray, p_wc: np.ndarray):
    """Set the body pose from a camera pose."""
    qb = nputil.quat_normalize(nputil.quat_mul(q_wc, nputil.quat_conj(f.q_bc)))
    f.q = qb
    f.p = p_wc - nputil.quat_rotate(qb, f.p_bc)


def _s2_tangential_basis(x: np.ndarray) -> np.ndarray:
    b0 = np.cross(x, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(b0) < 1e-6:
        b0 = np.cross(x, np.array([0.0, 1.0, 0.0]))
    b0 /= np.linalg.norm(b0)
    b1 = np.cross(x, b0)
    b1 /= np.linalg.norm(b1)
    return np.stack([b0, b1], axis=1)
