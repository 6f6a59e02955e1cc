"""Sliding-window VIO backend (port of the synchronous path of
`xrslam_tpu/core/sliding_window.py`).

  track():
    [parsac_flag] judge_track_status, then update_track_status when the
               judge returns True (IMU-PARSAC dynamic-outlier rejection)
    keyframe decision (pure), then
    keyframe:  localize → inject → triangulate candidates → full-window
               VI-BA → landmark gates (solve_keyframe_chain), write-back,
               marginalization (slide_window)
    keyframe with measured keypoint depths in the window (depth-camera
    input): split on the host, since the depth-seeded triangulation
    needs the localized pose there: localize_newframe (write-back),
    manage_keyframe, track_landmark (`triangulate_track`),
    refine_window (full-window VI-BA + landmark gates, write-back),
    marginalization
    subframe:  localize + subwindow refine (solve_chained), write-back;
               with a `solve_broker`, prepare_fused_subframe /
               finish_fused_subframe around one batched solve of N
               sequences (tools/multiseq.py)

Every write-back is applied immediately (the port has no deferred
write-back pipeline). The PARSAC stage reads the device at most twice a
frame: the judge's inlier mask together with the IMU-predicted pose, and
all of update_track_status's masks stacked.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..estimation.marginalization import marginalize_frame
from ..estimation.solver import (SolveOptions, landmark_gates,
                                 solve_chained, solve_keyframe_chain,
                                 solve_window)
from ..estimation.window import MargPrior
from ..geometry import lie
from ..imu import preintegration as pre
from ..ransac import parsac as parsac_mod
from ..ransac import pnp as pnp_mod
from ..ransac import stereo as stereo_mod
from ..utils.timing import StageTimes
from . import nputil
from .map import FrameRec, PipelineMap
from .window_builder import (extract_window, interval_samples,
                             needed_imu_cap, triangulate_track, write_back)


def _predict_slot(state, data, idx: int):
    """IMU-forward prediction of window slot `idx` from slot idx-1 with
    the extraction's own preintegration delta; an empty interval keeps
    the previous state."""
    i = idx - 1
    q_prev, p_prev, v_prev = state.q[i], state.p[i], state.v[i]
    bg_prev, ba_prev = state.bg[i], state.ba[i]
    delta = pre.PreintDelta(*(x[idx] for x in data.preint))
    q_i = lie.quat_mul(q_prev, data.q_bi[i])
    p_i = p_prev + lie.quat_rotate(q_prev, data.p_bi[i])
    qj, pj, vj, _, _ = pre.predict(q_i, p_i, v_prev, bg_prev, ba_prev, delta)
    q_b = lie.quat_normalize(lie.quat_mul(qj, lie.quat_conj(data.q_bi[idx])))
    p_b = pj - lie.quat_rotate(q_b, data.p_bi[idx])
    has = data.preint.t[idx] > 0

    def upd(arr, val, fallback):
        out = arr.clone()
        out[idx] = torch.where(has, val, fallback).to(arr.dtype)
        return out

    return state._replace(q=upd(state.q, q_b, q_prev), p=upd(state.p, p_b, p_prev),
                          v=upd(state.v, vj, v_prev), bg=upd(state.bg, bg_prev, bg_prev),
                          ba=upd(state.ba, ba_prev, ba_prev))


class SlidingWindowTracker:
    # rotation-subframe merge trigger (3->1 grouping)
    ROT_MERGE_TRIGGER = 9

    def __init__(self, pmap: PipelineMap, config: Config, device,
                 times: Optional[StageTimes] = None):
        self.map = pmap
        self.config = config
        self.device = torch.device(device)
        self.times = times if times is not None else StageTimes()
        self.noise = pre.ImuNoise.from_config(config, device=self.device)
        # +2: a subframe lift inserts an extra keyframe in the step that
        # attached the new frame, before slide_window trims it
        self.K_slots = config.sliding_window_size + 2
        self.L_slots = config.window_landmark_slots
        self.K_sub = 1 + max(self.ROT_MERGE_TRIGGER,
                             config.sliding_window_subframe_size) + 1
        self.marg: Optional[MargPrior] = None
        # multi-sequence mode: collects the fused subframe solves
        # (tools/multiseq.ChainedSolveBroker); None solves each at once
        self.solve_broker = None
        self._pred_frame: Optional[FrameRec] = None
        self._last_window = None
        # PARSAC state: the two bin-confidence vectors live on the device
        # across frames (the 2D-2D essential PARSAC keeps its own), the
        # draws come from a generator of their own, and the tracker map
        # receives the static-tag cross-propagation
        self.bin_conf = parsac_mod.initial_bin_confidences(device=self.device)
        self.bin_conf_2d2d = parsac_mod.initial_bin_confidences(device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.random))
        self.m_th = 0.0
        self._tracker_map: Optional[PipelineMap] = None
        self._pred_parsac = None
        self.stats = {
            "tracks_unstatic": 0,     # tracks losing TT_STATIC via PARSAC
            "judge_calls": 0,         # judge_track_status calls
            "judge_true": 0,          # ... that returned True
            "judge_prior_ok": 0,      # ... whose IMU-PARSAC passed the prior gate
            # ... refused by a gate: < 20 triangulated tracks, < 40 of them
            # matched to the keyframe, < 20 PnP inliers or < 20 outliers
            # among those, outliers' median epipolar distance < 2x the
            # inliers'
            "judge_refused_points": 0,
            "judge_refused_matches": 0,
            "judge_refused_inliers": 0,
            "judge_refused_outliers": 0,
            "judge_refused_ambiguous": 0,
            "parsac_host_reads": 0,   # device -> host reads in the PARSAC stage
            "depth_keyframes": 0,     # keyframes through the depth-camera split path
            "depth_seeded": 0,        # landmarks seeded from a measured depth there
        }

    def _extract(self, frames, K_slots, **kw):
        return extract_window(self.map, frames, K_slots, self.L_slots,
                              self.noise, self.device, **kw)

    def keyframes(self) -> List[FrameRec]:
        return self.map.frames

    def last_frame_chain(self) -> FrameRec:
        kf = self.map.frames[-1]
        return kf.subframes[-1] if kf.subframes else kf

    def get_latest_state(self):
        """Latest optimized state (t, q, p, v, bg, ba)."""
        f = self.last_frame_chain()
        return f.t, f.q, f.p, f.v, f.bg, f.ba

    # ------------------------------------------------------------------
    def mirror_frame(self, tracker_map: PipelineMap, frame_id: int) -> bool:
        """Pull the new frame from the tracker map: clone it, splice the
        IMU samples of skipped frames, extend tracks continuing from the
        window's latest frame, stage the IMU prediction."""
        self._tracker_map = tracker_map
        frame_i = self.last_frame_chain()
        idx_i = tracker_map.frame_index_by_id(frame_i.id)
        idx_j = tracker_map.frame_index_by_id(frame_id)
        if idx_i is None or idx_j is None:
            return False
        old_i = tracker_map.frames[idx_i]
        old_j = tracker_map.frames[idx_j]
        new_j = old_j.clone_shallow()
        between = tracker_map.frames[idx_i + 1: idx_j + 1]
        new_j.imu_t = np.concatenate([f.imu_t for f in between])
        new_j.imu_w = np.concatenate([f.imu_w for f in between])
        new_j.imu_a = np.concatenate([f.imu_a for f in between])
        new_track_ids = np.full_like(new_j.track_ids, -1)
        for ki in np.nonzero(old_i.track_ids >= 0)[0]:
            tr_old = tracker_map.tracks.get(int(old_i.track_ids[ki]))
            if tr_old is None:
                continue
            kj = tr_old.obs.get(old_j.id)
            if kj is None:
                continue
            tr_new = self.map.get_track(frame_i, int(ki), create=True)
            new_track_ids[kj] = tr_new.id
            if tr_old.static is False:
                tr_new.static = False
        new_j.track_ids = new_track_ids
        self.map.attach_frame(new_j)
        for k in np.nonzero(new_j.track_ids >= 0)[0]:
            tid = int(new_j.track_ids[k])
            if tid in self.map.tracks:
                self.map.tracks[tid].obs[new_j.id] = int(k)
        # host values hold the previous frame's state until the
        # prediction lands: without PARSAC it is composed on the device
        # from the extraction's own preintegration (_apply_pred); with
        # PARSAC it is staged here and lands with the judge's mask
        new_j.bg = frame_i.bg.copy()
        new_j.ba = frame_i.ba.copy()
        new_j.q, new_j.p = frame_i.q.copy(), frame_i.p.copy()
        new_j.v = frame_i.v.copy()
        self._pred_parsac = None
        if self.config.parsac_flag:
            self._pred_parsac = self._stage_prediction(frame_i, new_j)
        else:
            self._pred_frame = new_j
        return True

    def _stage_prediction(self, frame_i: FrameRec, frame_j: FrameRec):
        """Integrate frame_j's IMU interval and predict its body pose on
        the device (one upload). Returns (frame_j, q_b, p_b, v) on the
        device, or None without IMU samples."""
        t_buf, w_buf, a_buf, n, t0 = interval_samples(
            [frame_j], needed_imu_cap([[frame_j]]))
        if n == 0:
            return None
        # compose at the IMU, then back to body
        q_i = nputil.quat_mul(frame_i.q, frame_i.q_bi)
        p_i = frame_i.p + nputil.quat_rotate(frame_i.q, frame_i.p_bi)
        t_d, w_d, a_d, te_d, qi_d, pi_d, vi_d, bg_d, ba_d, qbi_d, pbi_d = self._upload(
            t_buf, w_buf, a_buf, [frame_j.t - t0], q_i, p_i, frame_i.v,
            frame_i.bg, frame_i.ba, frame_j.q_bi, frame_j.p_bi)
        d = pre.integrate(t_d, w_d, a_d, te_d[0], bg_d, ba_d, self.noise,
                          count=n, compute_sqrt_inv=False)
        qj, pj, vj, _, _ = pre.predict(qi_d, pi_d, vi_d, bg_d, ba_d, d)
        q_b = lie.quat_normalize(lie.quat_mul(qj, lie.quat_conj(qbi_d)))
        p_b = pj - lie.quat_rotate(q_b, pbi_d)
        return frame_j, q_b, p_b, vj

    def _upload(self, *arrays):
        """Host arrays -> float64 device tensors of the same shapes, in
        one host -> device copy."""
        host = np.concatenate([np.asarray(a, dtype=np.float64).reshape(-1)
                               for a in arrays])
        flat = torch.as_tensor(host, device=self.device)
        parts = torch.split(flat, [int(np.size(a)) for a in arrays])
        return [x.reshape(np.shape(a)) for x, a in zip(parts, arrays)]

    def _read(self, tensors):
        """One device -> host read of several tensors (packed as float64);
        returns numpy arrays, bool where the tensor was bool."""
        self.stats["parsac_host_reads"] += 1
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
        out = []
        for t, a in zip(tensors, np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])):
            a = a.reshape(tuple(t.shape))
            out.append(a.astype(bool) if t.dtype == torch.bool else a)
        return out

    def _land_prediction(self, extra=None):
        """Read the staged PARSAC prediction into its host record, with
        the `extra` tensor in the same read; returns extra's value."""
        pp, self._pred_parsac = self._pred_parsac, None
        if pp is None:
            return None if extra is None else self._read([extra])[0]
        frame_j, q_b, p_b, vj = pp
        out = self._read([q_b, p_b, vj] + ([] if extra is None else [extra]))
        frame_j.q = nputil.quat_normalize(out[0])
        frame_j.p, frame_j.v = out[1], out[2]
        return None if extra is None else out[3]

    # ------------------------------------------------------------------
    def track(self) -> bool:
        if self.config.parsac_flag:
            with self.times.stage("parsac_time"):
                if self.judge_track_status():
                    self.stats["judge_true"] += 1
                    self.update_track_status()
        verdict = self._keyframe_decision()
        if verdict != "subframe":
            if any(f.kp_depth is not None for f in self.map.all_frames()):
                self.stats["depth_keyframes"] += 1
                with self.times.stage("localize_newframe_time"):
                    self.localize_newframe()
                self.manage_keyframe(verdict)
                self.track_landmark()
                with self.times.stage("bundle_adjustor_solve_time"):
                    self.refine_window()
            else:
                with self.times.stage("bundle_adjustor_solve_time"):
                    self._fused_keyframe_step(verdict)
            with self.times.stage("bundle_adjustor_marginalization_time"):
                self.slide_window()
        else:
            target = self.map.frames[-1]
            self.manage_keyframe(verdict)
            with self.times.stage("subwindow_solve_time"):
                self._fused_subframe_step(target)
        return True

    def _fused_keyframe_step(self, verdict: str) -> None:
        """Localize → inject → triangulate candidates → full-window
        VI-BA → landmark gates, then the write-back and flag updates."""
        l_state, l_data, l_meta, target, l_slot = self._prepare_localize()
        l_opts = SolveOptions(iterations=self.config.solver_iteration_limit)
        self.manage_keyframe(verdict)
        frames = list(self.map.frames)
        new_kf = frames[-1]
        cand_ids = set()
        for k in np.nonzero(new_kf.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(new_kf.track_ids[k]))
            if tr is not None and not tr.triangulated:
                cand_ids.add(tr.id)
        base_filter = self._refine_track_filter(frames)
        state, data, meta = self._extract(
            frames, self.K_slots,
            track_filter=lambda t: base_filter(t) or t.id in cand_ids,
            all_frames_between=self._kf_between(frames), imu_cap=128)
        if self.marg is None:
            self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
        data = data._replace(marg=self.marg, use_marg=torch.ones(
            (), dtype=torch.bool, device=self.device))
        cand_mask = np.array([tid in cand_ids for tid in meta.track_ids]
                             + [False] * (self.L_slots - len(meta.track_ids)))
        if target in frames:
            s2, inject = frames.index(target), True
        else:  # lifted-subframe cases: the target is not a window slot
            s2, inject = 0, False
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames]
                       + [[1.0, 1.0]] * (self.K_slots - len(frames)))
        r_opts = SolveOptions(iterations=self.config.solver_iteration_limit)
        st1, st2, gates, tri_ok = solve_keyframe_chain(
            l_state, l_data, l_opts, state, data, r_opts, l_slot, s2, inject,
            torch.as_tensor(cand_mask, device=self.device),
            torch.as_tensor(fuv, dtype=state.p.dtype, device=self.device))
        data_eff = data._replace(
            landmark_mask=(data.landmark_mask | tri_ok) & gates[0])
        self._last_window = (st2, data_eff, meta)
        meta_eff = dataclasses.replace(meta, landmark_mask=meta.landmark_mask | cand_mask)
        if not inject:
            q, p, v, bg, ba = (x[l_slot].cpu().numpy()
                               for x in (st1.q, st1.p, st1.v, st1.bg, st1.ba))
            target.q, target.p, target.v = nputil.quat_normalize(q), p, v
            target.bg, target.ba = bg, ba
        (g_ok, _), t_ok = write_back(self.map, st2, meta_eff,
                                     extra=(gates, tri_ok), write_landmarks=True)
        for l, tid in enumerate(meta.track_ids):
            if not cand_mask[l]:
                continue
            tr = self.map.tracks.get(tid)
            if tr is None:
                continue
            if t_ok[l]:
                tr.triangulated = tr.valid = tr.static = True
                tr.life = max(tr.life, 1)
            else:
                tr.triangulated = tr.valid = False
                tr.p_w = None
        self._apply_landmark_gates(meta_eff, g_ok & (t_ok | ~cand_mask))
        covered = {tid for l, tid in enumerate(meta.track_ids)
                   if meta_eff.landmark_mask[l]}
        self._revalidate_landmarks(frames, skip_ids=covered)

    def prepare_fused_subframe(self, target: FrameRec) -> dict:
        """Host half of the fused subframe step: subwindow extraction and
        the localize stage's masking. Returns the ctx dict of the
        solve_chained operands (l_state, l_data, l_opts, s_state, s_data,
        s_opts, s2) and what finish_fused_subframe needs. Public so that
        the multi-sequence driver (tools/multiseq.py) can solve N
        sequences' steps in one `solve_chained_batch`."""
        prep = self._prepare_subwindow()
        s_state, s_data, s_meta, s_opts, variant, kf, saved = prep
        frames = s_meta.frames
        s2 = len(frames) - 1
        assert frames[s2] is target
        K = self.K_sub
        pm = np.zeros((K,), dtype=bool)
        pm[s2] = bool(s_meta.preint_mask[s2])
        fix = np.ones((K,), dtype=bool)
        fix[s2] = False
        dev = self.device
        l_data = s_data._replace(
            preint_mask=torch.as_tensor(pm, device=dev),
            fix_pose=torch.as_tensor(fix, device=dev),
            fix_motion=torch.as_tensor(fix, device=dev),
            fix_landmark=torch.ones_like(s_data.fix_landmark),
            obs_mask=torch.as_tensor(s_meta.obs_mask, device=dev),
            landmark_mask=torch.as_tensor(s_meta.landmark_mask, device=dev))
        if variant == "subwindow_rot":
            l_data = l_data._replace(landmark_mask=s_data.landmark_mask)
        l_state = self._apply_pred(s_state, frames, s_data)
        l_opts = SolveOptions(iterations=self.config.solver_iteration_limit)
        return dict(l_state=l_state, l_data=l_data, l_opts=l_opts,
                    s_state=s_state, s_data=s_data, s_opts=s_opts, s2=s2,
                    variant=variant, kf=kf, saved=saved, meta=s_meta)

    def finish_fused_subframe(self, ctx: dict, st2) -> None:
        """Apply a fused subframe solve's result: restore the keyframe's
        fix flags, write the subwindow back."""
        ctx["kf"].fix_pose, ctx["kf"].fix_motion = ctx["saved"]
        write_back(self.map, st2, ctx["meta"], write_landmarks=False)

    def _fused_subframe_step(self, target: FrameRec) -> None:
        """Localize + subwindow refine over the subwindow tensors: the
        localize stage is the subwindow system with every frame but the
        target fixed, every landmark fixed and preintegration only
        prev→target. With a `solve_broker` (tools/multiseq.py) the step
        hands its solve to the broker, which solves every lockstepped
        sequence's step at once and finishes each."""
        ctx = self.prepare_fused_subframe(target)
        if self.solve_broker is not None:
            self.solve_broker.submit(self, ctx)
            return
        _, st2, _ = solve_chained(ctx["l_state"], ctx["l_data"], ctx["l_opts"],
                                  ctx["s_state"], ctx["s_data"], ctx["s_opts"],
                                  ctx["s2"], ctx["s2"])
        self.finish_fused_subframe(ctx, st2)

    # ------------------------------------------------------------------
    def _prepare_localize(self):
        """Localize window: keyframes (minus the newest) + the previous
        frame + the target, all fixed except the target, preintegration
        only prev→target, landmarks fixed. Returns (state, data, meta,
        target, slot)."""
        frames = list(self.map.frames)
        kf = frames[-2] if len(frames) >= 2 else frames[0]
        prev = kf.subframes[-1] if kf.subframes else kf
        target = frames[-1]
        wframes = frames[:-1] + ([prev] if prev is not kf else []) + [target]
        saved = [(f.fix_pose, f.fix_motion) for f in wframes]
        for f in wframes[:-1]:
            f.fix_pose = True
            f.fix_motion = True
        state, data, meta = self._extract(
            wframes, self.K_slots + 2,
            track_filter=lambda t: t.all_tagged("valid", "triangulated", "static"),
            with_preint=True, imu_cap=96)
        for f, (fp, fm) in zip(wframes, saved):
            f.fix_pose, f.fix_motion = fp, fm
        state = self._apply_pred(state, wframes, data)
        pm = np.zeros((self.K_slots + 2,), dtype=bool)
        pm[len(wframes) - 1] = bool(meta.preint_mask[len(wframes) - 1])
        data = data._replace(preint_mask=torch.as_tensor(pm, device=self.device),
                             fix_landmark=torch.ones_like(data.fix_landmark))
        return state, data, meta, target, len(wframes) - 1

    def localize_newframe(self) -> None:
        """Solve the new frame alone (the localize window) and write its
        state back."""
        state, data, meta, target, _ = self._prepare_localize()
        st, _ = solve_window(state, data, SolveOptions(
            iterations=self.config.solver_iteration_limit))
        write_back(self.map, st, meta, write_landmarks=False,
                   frame_subset={target.id})

    def track_landmark(self) -> None:
        """Triangulate the new keyframe's untriangulated tracks on the
        host (`triangulate_track`: depth-seeded where an observation has
        a measured depth)."""
        new_j = self.map.frames[-1]
        frames_by_id = {f.id: f for f in self.map.all_frames()}
        for k in np.nonzero(new_j.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(new_j.track_ids[k]))
            if tr is None or tr.triangulated:
                continue
            p, seeded = triangulate_track(tr, frames_by_id)
            self.stats["depth_seeded"] += seeded
            if p is not None:
                tr.p_w = p
                tr.triangulated = tr.valid = tr.static = True
                tr.life = 1
            else:
                tr.triangulated = tr.valid = False

    def refine_window(self) -> None:
        """Full sliding-window VI-BA with the marginalization prior, the
        landmark depth/RPE gates on the device, one write-back, then the
        host re-validation of the tracks outside the window's slots."""
        frames = list(self.map.frames)
        state, data, meta = self._extract(
            frames, self.K_slots, track_filter=self._refine_track_filter(frames),
            all_frames_between=self._kf_between(frames), imu_cap=128)
        if self.marg is None:
            self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
        data = data._replace(marg=self.marg, use_marg=torch.ones(
            (), dtype=torch.bool, device=self.device))
        st, _ = solve_window(state, data, SolveOptions(
            iterations=self.config.solver_iteration_limit))
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames]
                       + [[1.0, 1.0]] * (self.K_slots - len(frames)))
        gates = landmark_gates(st, data, torch.as_tensor(
            fuv, dtype=st.p.dtype, device=self.device))
        # landmarks the gates reject do not enter the marginalization prior
        self._last_window = (
            st, data._replace(landmark_mask=data.landmark_mask & gates[0]), meta)
        ok, _ = write_back(self.map, st, meta, extra=gates)
        self._apply_landmark_gates(meta, ok)
        covered = {tid for l, tid in enumerate(meta.track_ids)
                   if meta.landmark_mask[l]}
        self._revalidate_landmarks(frames, skip_ids=covered)

    def _apply_pred(self, state, frames, data):
        """Patch the staged IMU prediction of the newest frame into its
        window slot (the host record still holds the previous state)."""
        pf = self._pred_frame
        if pf is None or pf not in frames:
            return state
        idx = frames.index(pf)
        if idx <= 0:
            return state
        self._pred_frame = None
        return _predict_slot(state, data, idx)

    # ------------------------------------------------------------------
    def _keyframe_decision(self) -> str:
        """Pure classification of the new frame: 'lift_rotation',
        'lift_translation', 'overflow', 'forced' (too few mapped
        landmarks) or 'subframe'."""
        kf_i = self.map.frames[-2]
        new_j = self.map.frames[-1]
        cfg = self.config
        if kf_i.subframes:
            if kf_i.subframes[-1].no_translation:
                if not new_j.no_translation:
                    return "lift_rotation"
            else:
                if new_j.no_translation:
                    return "lift_translation"
                if len(kf_i.subframes) >= cfg.sliding_window_subframe_size:
                    return "overflow"
        mapped = 0
        for k in np.nonzero(new_j.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(new_j.track_ids[k]))
            if tr is not None and tr.all_tagged("valid", "triangulated", "static"):
                mapped += 1
        if mapped < cfg.sliding_window_force_keyframe_landmarks:
            return "forced"
        return "subframe"

    def manage_keyframe(self, verdict: Optional[str] = None) -> bool:
        """Apply the subframe/keyframe state machine for `verdict`.
        Returns True if the new frame (or a lifted subframe) became a
        keyframe."""
        if verdict is None:
            verdict = self._keyframe_decision()
        kf_i = self.map.frames[-2]
        new_j = self.map.frames[-1]
        if verdict == "lift_rotation":
            lifted = kf_i.subframes.pop()
            lifted.keyframe = True
            self.map.attach_frame(lifted, len(self.map.frames) - 1)
            new_j.keyframe = True
            return True
        if verdict == "lift_translation":
            lifted = kf_i.subframes.pop()
            lifted.keyframe = True
            nj = self.map.detach_frame(len(self.map.frames) - 1)
            lifted.subframes.append(nj)
            self.map.attach_frame(lifted)
            return True
        if verdict in ("overflow", "forced"):
            new_j.keyframe = True
            return True
        assert verdict == "subframe", verdict
        sub = self.map.detach_frame(len(self.map.frames) - 1)
        kf_i.subframes.append(sub)
        for k in np.nonzero(sub.track_ids >= 0)[0]:
            tid = int(sub.track_ids[k])
            if tid in self.map.tracks:
                self.map.tracks[tid].obs[sub.id] = int(k)
        return False

    # ------------------------------------------------------------------
    def _kf_between(self, frames: List[FrameRec]):
        """IMU-interval frame lists for a keyframe window: entry j is
        keyframe j-1's subframes plus keyframe j."""
        out = [[]]
        for j in range(1, len(frames)):
            out.append(list(frames[j - 1].subframes) + [frames[j]])
        return out

    def _refine_track_filter(self, frames):
        kf_ids = {f.id for f in frames}

        def ok(tr):
            return tr.valid and tr.static and tr.first_frame_id() in kf_ids
        return ok

    def _apply_landmark_gates(self, meta, ok: np.ndarray):
        """Apply landmark_gates verdicts to the map."""
        for l, tid in enumerate(meta.track_ids):
            if not meta.landmark_mask[l]:
                continue
            tr = self.map.tracks.get(tid)
            if tr is None:
                continue
            tr.valid = bool(ok[l])
            tr.trash = not tr.valid
        self.map.prune_tracks(lambda t: t.trash and not t.static)

    def _revalidate_landmarks(self, frames, skip_ids=frozenset()):
        """Host twin of landmark_gates for triangulated tracks outside
        the window's landmark slots (depth in (1e-3, 50], mean
        reprojection error < 3 px); the verdict can restore TT_VALID."""
        slot = {f.id: i for i, f in enumerate(frames)}
        trs = [tr for tr in self.map.tracks.values()
               if tr.id not in skip_ids and tr.triangulated and tr.p_w is not None]
        if not trs:
            return
        R_cw = np.stack([nputil.quat_to_matrix(nputil.quat_mul(f.q, f.q_bc)).T
                         for f in frames])
        p_wc = np.stack([f.p + nputil.quat_rotate(f.q, f.p_bc) for f in frames])
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames])
        ti, fi, bo = [], [], []
        for t_idx, tr in enumerate(trs):
            for fid, k in tr.obs.items():
                s = slot.get(fid)
                if s is None:
                    continue
                ti.append(t_idx)
                fi.append(s)
                bo.append(frames[s].bearings[k])
        n_tr = len(trs)
        rpe_sum = np.zeros(n_tr)
        cnt = np.zeros(n_tr)
        depth_bad = np.zeros(n_tr, bool)
        if ti:
            ti_a = np.asarray(ti, np.intp)
            fi_a = np.asarray(fi, np.intp)
            b = np.stack(bo)
            X = np.stack([trs[i].p_w for i in ti_a])
            y = np.einsum("nij,nj->ni", R_cw[fi_a], X - p_wc[fi_a])
            z = y[:, 2]
            zs = np.where(np.abs(z) > 1e-12, z, 1e-12)
            bz = np.where(np.abs(b[:, 2]) > 1e-12, b[:, 2], 1e-12)
            du = (y[:, 0] / zs - b[:, 0] / bz) * fuv[fi_a, 0]
            dv = (y[:, 1] / zs - b[:, 1] / bz) * fuv[fi_a, 1]
            np.add.at(rpe_sum, ti_a, np.hypot(du, dv))
            np.add.at(cnt, ti_a, 1.0)
            np.logical_or.at(depth_bad, ti_a, (z <= 1.0e-3) | (z > 50.0))
        ok_all = ~depth_bad & (rpe_sum / np.maximum(cnt, 1.0) < 3.0)
        for i, tr in enumerate(trs):
            tr.valid = bool(ok_all[i])
            tr.trash = not tr.valid
        self.map.prune_tracks(lambda t: t.trash and not t.static)

    # ------------------------------------------------------------------
    def slide_window(self):
        """Marginalize the oldest keyframe(s)."""
        while len(self.map.frames) > self.config.sliding_window_size:
            frames = list(self.map.frames)
            last = self._last_window
            if last is not None and last[2].frames == frames:
                # marginalize at the window just solved, re-integrating
                # its IMU buffers at the solved bias linearization
                st, data, meta = last
                tb, wb, ab, te, cnt, steps = meta.imu
                bg_lin = torch.cat([st.bg[:1], st.bg[:-1]], dim=0)
                ba_lin = torch.cat([st.ba[:1], st.ba[:-1]], dim=0)
                preint = pre.integrate_batch(tb, wb, ab, te, bg_lin, ba_lin,
                                             self.noise, cnt, steps=steps)
                state = st
                data = data._replace(preint=preint, bg_lin=bg_lin, ba_lin=ba_lin)
            else:
                state, data, meta = self._extract(
                    frames, self.K_slots,
                    track_filter=self._refine_track_filter(frames),
                    all_frames_between=self._kf_between(frames), imu_cap=128)
                if self.marg is None:
                    self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
                data = data._replace(marg=self.marg, use_marg=torch.ones(
                    (), dtype=torch.bool, device=self.device))
            self._last_window = None
            self.marg = marginalize_frame(state, data, victim=0)
            victim = self.map.frames[0]
            for sub in victim.subframes:
                self.map.untrack_frame(sub)
            victim.subframes.clear()
            self.map.detach_frame(0)
            self.map.prune_tracks(lambda t: len(t.obs) == 0)

    # ------------------------------------------------------------------
    def _prepare_subwindow(self):
        """Subframe merge + subwindow extraction + factor masking.
        Returns (state, data, meta, opts, variant, kf, saved_fix_flags)
        or None when the keyframe has no subframes."""
        kf = self.map.frames[-1]
        if not kf.subframes:
            return None
        rotation_mode = kf.subframes[0].no_translation
        if rotation_mode and len(kf.subframes) >= self.ROT_MERGE_TRIGGER:
            groups = len(kf.subframes) // 3
            merged = []
            for g in range(groups):
                grp = kf.subframes[g * 3:(g + 1) * 3]
                tgt = grp[-1]
                tgt.imu_t = np.concatenate([f.imu_t for f in grp])
                tgt.imu_w = np.concatenate([f.imu_w for f in grp])
                tgt.imu_a = np.concatenate([f.imu_a for f in grp])
                for src in grp[:-1]:
                    self.map.untrack_frame(src)
                merged.append(tgt)
            merged += kf.subframes[groups * 3:]
            kf.subframes = merged

        frames = [kf] + list(kf.subframes)
        saved = (kf.fix_pose, kf.fix_motion)
        kf.fix_pose = True
        kf.fix_motion = True
        last_sub = kf.subframes[-1]
        kf_anchor_ids = {f.id for f in self.map.frames}
        sub_ids = {f.id for f in frames[1:]}
        if rotation_mode:
            def tf(tr):
                return last_sub.id in tr.obs and tr.valid
        else:
            def tf(tr):
                if not tr.all_tagged("valid", "triangulated", "static"):
                    return False
                first = tr.first_frame_id()
                return first in kf_anchor_ids or first in sub_ids
        state, data, meta = self._extract(frames, self.K_sub, track_filter=tf,
                                          imu_cap=128)
        refs = meta.ref_idx
        fix_lm = refs == 0
        dev = self.device
        if rotation_mode:
            lm_mask = meta.landmark_mask
            tri = np.zeros_like(lm_mask)
            for l, tid in enumerate(meta.track_ids):
                tr = self.map.tracks.get(tid)
                tri[l] = bool(tr and tr.triangulated and tr.static)
            obs = meta.obs_mask
            keep = np.zeros_like(obs)
            keep[len(frames) - 1] = obs[len(frames) - 1]
            keep[refs[None, :] == np.arange(self.K_sub)[:, None]] = True
            obs_rot = obs & keep & (lm_mask & ~tri)[None, :]
            obs_rep = obs & keep & tri[None, :]
            data_r = data._replace(
                landmark_mask=torch.as_tensor(lm_mask & tri, device=dev),
                fix_landmark=torch.as_tensor(fix_lm | tri, device=dev),
                obs_mask=torch.as_tensor(obs_rep | obs_rot, device=dev))
            opts = SolveOptions(iterations=self.config.solver_iteration_limit,
                                use_rotation=True)
            variant = "subwindow_rot"
        else:
            data_r = data._replace(fix_landmark=torch.as_tensor(fix_lm, device=dev))
            opts = SolveOptions(iterations=self.config.solver_iteration_limit)
            variant = "subwindow"
        return state, data_r, meta, opts, variant, kf, saved

    # ------------------------------------------------------------------
    # PARSAC dynamic-object rejection
    # ------------------------------------------------------------------
    def _tracker_twin(self, frame: FrameRec) -> Optional[FrameRec]:
        """The tracker map's frame with `frame`'s id (window frames are
        clones, so keypoint indices align 1:1)."""
        if self._tracker_map is None:
            return None
        oi = self._tracker_map.frame_index_by_id(frame.id)
        return None if oi is None else self._tracker_map.frames[oi]

    def judge_track_status(self) -> bool:
        """IMU-PARSAC PnP of the new frame against the window's
        landmarks, gated by the IMU-predicted prior pose, then the
        epipolar ambiguity check against the last keyframe. When the
        split is unambiguous it sets m_th and each track's outlier/static
        tags (on both maps) and returns True."""
        self.stats["judge_calls"] += 1
        curr = self.map.frames[-1]
        kf = self.map.frames[-2]
        P3D, P2D, lens, kps = [], [], [], []
        for k in np.nonzero(curr.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            if tr is None or not (tr.valid and tr.triangulated) or tr.p_w is None:
                continue
            b = curr.bearings[k]
            P2D.append(b[:2] / b[2])
            P3D.append(tr.p_w)
            lens.append(max(tr.life, 0))
            kps.append(int(k))
        if len(P2D) < 20:
            self.stats["judge_refused_points"] += 1
            self._land_prediction()  # the frame's pose still has to land
            return False
        N_CAP = 256
        n = min(len(P2D), N_CAP)
        X = np.zeros((N_CAP, 3))
        x2 = np.zeros((N_CAP, 2))
        ln = np.zeros((N_CAP,), dtype=np.int64)
        X[:n] = np.stack(P3D)[:n]
        x2[:n] = np.stack(P2D)[:n]
        ln[:n] = np.asarray(lens)[:n]
        valid = np.zeros((N_CAP,), dtype=bool)
        valid[:n] = True

        # one upload; the prior pose (world -> camera) is composed on the
        # device from the staged prediction when there is one
        pp = self._pred_parsac
        host_pose = () if pp is not None and pp[0] is curr else (curr.q, curr.p)
        X_d, x2_d, ln_d, valid_d, q_bc, p_bc, *pose = self._upload(
            X, x2, ln, valid, curr.q_bc, curr.p_bc, *host_pose)
        q_b, p_b = pose if pose else pp[1:3]
        q_wc = lie.quat_mul(q_b, q_bc)
        p_wc = p_b + lie.quat_rotate(q_b, p_bc)
        Rcw = lie.quat_to_matrix(q_wc).T
        prior_T = torch.eye(4, dtype=p_b.dtype, device=self.device)
        prior_T[:3, :3] = Rcw
        prior_T[:3, 3] = -(Rcw @ p_wc)

        fu = curr.K[0, 0]
        _, mask, _, self.bin_conf, ok = pnp_mod.find_pnp_matrix_parsac_imu(
            self.generator, X_d, x2_d, ln_d, prior_T, self.bin_conf,
            self.config.parsac_dynamic_probability, valid=valid_d > 0.5,
            threshold=1.0 / fu, norm_scale=self.config.parsac_norm_scale)
        # one read: the mask, the prior gate and the staged prediction
        mask_ok = self._land_prediction(extra=torch.cat([mask, ok.reshape(1)]))
        mask = mask_ok[:-1]
        self.stats["judge_prior_ok"] += int(mask_ok[-1])

        # epipolar ambiguity check between keyframe and current frame
        # with the IMU-predicted relative pose
        q_wc, p_wc = curr.camera_pose()
        q_kfc, p_kfc = kf.camera_pose()
        R_kf = nputil.quat_to_matrix(q_kfc)
        R_cu = nputil.quat_to_matrix(q_wc)
        Rrel = R_cu.T @ R_kf          # kf cam -> cur cam
        trel = R_cu.T @ (p_kfc - p_wc)
        tx = np.array([[0, -trel[2], trel[1]],
                       [trel[2], 0, -trel[0]],
                       [-trel[1], trel[0], 0]])
        Kk, Kc = kf.K, curr.K
        F = np.linalg.inv(Kk.T) @ (tx @ Rrel) @ np.linalg.inv(Kc)

        sel_i, b1s, b2s = [], [], []
        for i, k in enumerate(kps[:n]):
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            kj = tr.obs.get(kf.id) if tr else None
            if kj is None:
                continue
            sel_i.append(i)
            b1s.append(kf.bearings[kj])
            b2s.append(curr.bearings[k])
        if len(sel_i) < 40:
            self.stats["judge_refused_matches"] += 1
            return False
        b1s = np.stack(b1s)
        b2s = np.stack(b2s)
        p1 = (b1s / b1s[:, 2:3]) @ Kk.T
        p2 = (b2s / b2s[:, 2:3]) @ Kc.T
        l1 = p1 @ F.T
        l2 = p2 @ F
        d1 = np.abs(np.sum(p2 * l1, axis=1)) / np.maximum(
            np.hypot(l1[:, 0], l1[:, 1]), 1e-12)
        d2 = np.abs(np.sum(p1 * l2, axis=1)) / np.maximum(
            np.hypot(l2[:, 0], l2[:, 1]), 1e-12)
        d = d1 + d2
        m_sel = mask[np.asarray(sel_i, dtype=np.intp)]
        in_d = d[m_sel]
        out_d = d[~m_sel]
        if len(in_d) < 20 or len(out_d) < 20:
            self.stats["judge_refused_inliers" if len(in_d) < 20
                       else "judge_refused_outliers"] += 1
            return False
        th1 = float(np.median(in_d))
        th2 = float(np.median(out_d))
        if th2 < th1 * 2:
            self.stats["judge_refused_ambiguous"] += 1
            return False
        self.m_th = 0.5 * (th1 + th2)
        # refresh both maps with the fresh per-frame verdict: without the
        # positive (inlier -> static) direction, one false PnP rejection
        # would ratchet a static track non-static forever through the
        # cross-propagation in update_track_status
        old_frame = self._tracker_twin(curr)
        for i, k in enumerate(kps[:n]):
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            if tr is None:
                continue
            old_tr = None
            if old_frame is not None and old_frame.track_ids[k] >= 0:
                old_tr = self._tracker_map.tracks.get(int(old_frame.track_ids[k]))
            if mask[i]:
                tr.outlier = False
                tr.static = True
                if old_tr is not None:
                    old_tr.static = True
            else:
                tr.outlier = True
                if tr.static:
                    self.stats["tracks_unstatic"] += 1
                tr.static = False
                if old_tr is not None:
                    old_tr.static = False
        return True

    def update_track_status(self):
        """2D-2D essential PARSAC (32 hypotheses) of the new frame against
        each of the last `parsac_keyframe_check_size` keyframes; tracks
        flagged as outliers in more than half of outlier_th and 80% of
        their matches lose TT_STATIC, and the static tag is
        cross-propagated both ways between the window track and the
        tracker-map track. The bin confidences chain on the device from
        call to call; every mask comes back in one read."""
        curr = self.map.frames[-1]
        n_check = self.config.parsac_keyframe_check_size
        start = max(len(self.map.frames) - 1 - n_check, 0)
        C = curr.track_ids.shape[0]
        outlier_cnt = np.zeros(C, dtype=int)
        match_cnt = np.zeros(C, dtype=int)
        N_CAP = 256
        host = []
        for i in range(start, len(self.map.frames) - 1):
            fr = self.map.frames[i]
            p1, p2, idxs = [], [], []
            for ki in np.nonzero(fr.track_ids >= 0)[0]:
                tr = self.map.tracks.get(int(fr.track_ids[ki]))
                kj = tr.obs.get(curr.id) if tr else None
                if kj is None:
                    continue
                b1 = fr.bearings[ki]
                b2 = curr.bearings[kj]
                p1.append(b1[:2] / b1[2])
                p2.append(b2[:2] / b2[2])
                idxs.append(int(kj))
            if len(p1) < 10:
                continue
            nn = min(len(p1), N_CAP)
            a = np.zeros((3, N_CAP, 3))     # x1, x2 (z = 1) and the valid mask
            a[:2, :, 2] = 1.0
            a[0, :nn, :2] = np.stack(p1)[:nn]
            a[1, :nn, :2] = np.stack(p2)[:nn]
            a[2, :nn, 0] = 1.0
            # m_th comes from judge_track_status (track() calls this only
            # after it returned True)
            host.append((a, self.m_th / fr.K[0, 0], nn, idxs))
        if host:
            masks = []
            for a, (_, thr, _, _) in zip(self._upload(*[h[0] for h in host]), host):
                _, mask, _, self.bin_conf_2d2d = stereo_mod.find_essential_matrix_parsac(
                    self.generator, a[0], a[1], self.bin_conf_2d2d,
                    valid=a[2, :, 0] > 0.5, threshold=thr,
                    norm_scale=self.config.parsac_norm_scale, n_hyp=32)
                masks.append(mask)
            for mask, (_, _, nn, idxs) in zip(self._read([torch.stack(masks)])[0], host):
                for j in range(nn):
                    match_cnt[idxs[j]] += 1
                    if not mask[j]:
                        outlier_cnt[idxs[j]] += 1

        old_frame = self._tracker_twin(curr)
        outlier_th = len(self.map.frames) // 2
        for k in np.nonzero(curr.track_ids >= 0)[0]:
            tr = self.map.tracks.get(int(curr.track_ids[k]))
            if tr is None:
                continue
            if outlier_cnt[k] > outlier_th / 2 and outlier_cnt[k] > 0.8 * match_cnt[k]:
                if tr.static:
                    self.stats["tracks_unstatic"] += 1
                tr.static = False
            # static-tag cross-propagation window <-> tracker map
            if old_frame is not None and old_frame.track_ids[k] >= 0:
                old_tr = self._tracker_map.tracks.get(int(old_frame.track_ids[k]))
                if old_tr is not None and (not old_tr.static or not tr.static):
                    tr.static = False
                    old_tr.static = False
