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

Under a `Config.solver_time_limit` below 1e5 s every solve's iteration
count is budgeted from its variant's measured time an iteration
(`_note_solve`, `_budgeted_iterations`, `_budget_chained`); each solve
that the budget cuts below `solver_iteration_limit` counts one
`budget_clamped` in the trace record.

With `Config.deferred_subframe_write` (the default) a solve's result is
not read when the solve is dispatched: its write-back is queued with a
packed copy in flight (`window_builder.write_back_start`) and lands at
the next frame's mirror_frame, or sooner when it is due. Meanwhile
`get_latest_state` returns the anchor: the newest state the host records
held solved when the solve was queued, so that published poses are
IMU-propagated from one solve back, the reference's threaded output
path. Under `worker_overlap` + `pipelined_writeback` with PARSAC off
(`writeback_depth` 2) a subframe step's solve may stay in flight into
the next extraction, which then takes the values that its write-back
would land from that solve's device state (`_inject_solved`); a
keyframe step's write-back, which also sets track flags and world
points, lands before the next extraction. So every schedule's solves
take the values the synchronous schedule gives them (the JAX package's
two-frame schedule does not, ROADMAP.md queue 3).

The PARSAC stage reads the device at most twice a frame: the judge's
inlier mask together with the IMU-predicted pose, and all of
update_track_status's masks stacked.
"""

from __future__ import annotations

import dataclasses
import time
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
from ..utils import timing
from ..utils.fetch import fetch_packed, fetch_packed_start
from ..utils.timing import StageTimes
from . import nputil
from .map import FrameRec, PipelineMap
from .window_builder import (extract_window, interval_samples,
                             needed_imu_cap, triangulate_track, write_back,
                             write_back_start)


def writeback_depth(config: Config) -> int:
    """Solves whose write-back may be in flight at once: 2 under the
    two-frame schedule (worker_overlap + pipelined_writeback with
    deferred write-backs and PARSAC off; PARSAC reads the refined pose
    on the host every frame), else 1. Depth 1 holds with PARSAC too:
    mirror_frame lands every pending write before the judge runs."""
    return 2 if (config.pipelined_writeback and config.worker_overlap
                 and config.deferred_subframe_write
                 and not config.parsac_flag) else 1


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


def _normalize_rows(q: torch.Tensor) -> torch.Tensor:
    """Each row of q (N,4) over its norm, the sum of squares taken in
    index order as `nputil.quat_normalize`'s numpy norm takes it."""
    sq = q[:, 0] * q[:, 0]
    for i in range(1, 4):
        sq = sq + q[:, i] * q[:, i]
    return q / torch.sqrt(sq)[:, None]


def _inject_frames(state, pend, fmap, fmask):
    """`state` with the frame slots under `fmask` replaced by the pending
    solve `pend`'s slots `fmap`, the rotations normalized as write_back
    normalizes them. Fixed-shape maps: one gather and one select a
    field."""
    def pick(dst, src):
        return torch.where(fmask[:, None], src.index_select(0, fmap).to(dst.dtype), dst)

    return state._replace(q=pick(state.q, _normalize_rows(pend.q)), p=pick(state.p, pend.p),
                          v=pick(state.v, pend.v), bg=pick(state.bg, pend.bg),
                          ba=pick(state.ba, pend.ba))


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
        # attached the new frame, before slide_window trims it. The
        # initializer hands over initializer_keyframe_num keyframes, which
        # the first keyframe step's slide_window trims to the window size
        # (the mobile profile: window 5, 8 keyframes); the JAX package
        # sizes the slots by the window alone and fails extract_window's
        # K <= K_slots there (xrslam_tpu/core/sliding_window.py:135).
        self.K_slots = max(config.sliding_window_size,
                           config.initializer_keyframe_num) + 2
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
        # deferred write-backs (Config.deferred_subframe_write): a FIFO of
        # queued solves, each with its read in flight; the output anchor
        # (t, q, p, v, bg, ba) published while one is pending; a staged
        # localize result of the lifted-subframe keyframe cases; the
        # depth path's localize result (localize_newframe(defer_write))
        self._pending_writes: list = []
        self._copied_from = None   # (new frame, the frame its host values copy)
        self._latest_solved = None
        self._pending_loc = None
        self._loc_result = None
        # set while a solve waits in the solve_broker: the window's
        # newest frame holds no solved values yet
        self._in_broker = False
        self.max_pending = writeback_depth(config)
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
            "budget_syncs": 0,        # device waits of the solver time budget's calibration
        }
        # solver_time_limit (the reference's Ceres max_solver_time_in_seconds,
        # solver.cpp:186): a solve runs a fixed number of LM iterations,
        # so the budget measures each solve variant's time per iteration
        # at start-up and clamps the iteration count of its later solves
        self._iter_seconds: dict = {}
        self._solve_calls: dict = {}
        self._solve_samples: dict = {}   # the calibration samples per variant

    def _extract(self, frames, K_slots, **kw):
        return extract_window(self.map, frames, K_slots, self.L_slots,
                              self.noise, self.device, **kw)

    # ------------------------------------------------------------------
    # solver time budget
    # ------------------------------------------------------------------
    # iteration counts a clamped solve may take
    BUDGET_LADDER = (1, 2, 3, 5, 8, 15, 30)
    # calls of a variant timed after its first (untimed) call; their
    # median fixes its time per iteration
    _CALIB_SAMPLES = 3

    def _ladder_value(self, fit: int) -> int:
        return max([v for v in self.BUDGET_LADDER if v <= fit] or [1])

    def _limit_active(self) -> bool:
        limit = self.config.solver_time_limit
        return bool(limit) and 0 < limit < 1.0e5

    def _budgeted_iterations(self, variant: str) -> int:
        """Iteration count of a solve variant under solver_time_limit."""
        iters = self.config.solver_iteration_limit
        limit = self.config.solver_time_limit
        est = self._iter_seconds.get(variant)
        if limit and limit > 0 and est:
            fit = max(1, int(limit / est))
            if fit < iters:
                iters = self._ladder_value(fit)
        return iters

    def _budget_chained(self, chain_key: str, l_opts: SolveOptions,
                        s_opts: SolveOptions) -> SolveOptions:
        """Clamp the second share of a chained solve so that the whole
        chain fits the budget; the localize share is left as it is."""
        limit = self.config.solver_time_limit
        est = self._iter_seconds.get(chain_key)
        if not self._limit_active() or not est:
            return s_opts
        fit = max(1, int(limit / est) - l_opts.iterations)
        if fit < s_opts.iterations:
            return dataclasses.replace(s_opts, iterations=self._ladder_value(fit))
        return s_opts

    def _count_clamped(self, *opts: SolveOptions) -> None:
        """Record counter `budget_clamped`: +1 for each solve about to
        run whose iteration count the budget cut below
        solver_iteration_limit."""
        n = sum(o.iterations < self.config.solver_iteration_limit for o in opts)
        if n:
            self.times.count("budget_clamped", n)

    def _wait_device(self, result) -> None:
        """The budget's one wait on the device: synchronize the result's
        CUDA device (nothing to wait for on the CPU)."""
        self.stats["budget_syncs"] += 1
        if result.p.is_cuda:
            with timing.host_wait():
                torch.cuda.synchronize(result.p.device)

    def _note_solve(self, variant: str, result, iterations: int, t0: float) -> None:
        """Start-up timing of a solve variant begun at `t0`
        (time.perf_counter()): call 0 is skipped, calls 1..3 wait for the
        device and their median time per iteration is kept, and later
        calls add no wait. The JAX package starts its clock after the
        solve's asynchronous dispatch; the port dispatches a solve op by
        op from the host, so its clock starts before the solve."""
        n = self._solve_calls.get(variant, 0)
        self._solve_calls[variant] = n + 1
        if (n < 1 or n > self._CALIB_SAMPLES
                or variant in self._iter_seconds or iterations <= 0):
            return
        self._wait_device(result)
        dt = time.perf_counter() - t0
        samples = self._solve_samples.setdefault(variant, [])
        samples.append(dt / iterations)
        if len(samples) >= self._CALIB_SAMPLES:
            samples.sort()
            self._iter_seconds[variant] = samples[len(samples) // 2]

    def _solve_timed(self, variant: str, state, data, opts: SolveOptions):
        """solve_window, timed by _note_solve under a solver_time_limit."""
        if not self._limit_active():
            return solve_window(state, data, opts)
        t0 = time.perf_counter()
        st, info = solve_window(state, data, opts)
        self._note_solve(variant, st, opts.iterations, t0)
        return st, info

    def keyframes(self) -> List[FrameRec]:
        return self.map.frames

    def last_frame_chain(self) -> FrameRec:
        kf = self.map.frames[-1]
        return kf.subframes[-1] if kf.subframes else kf

    def get_latest_state(self):
        """Latest optimized state (t, q, p, v, bg, ba). While a write-back
        is pending (or a solve waits in the broker) this is the anchor,
        one solve back; the pipeline IMU-propagates past it."""
        if (self._pending_writes or self._in_broker) and self._latest_solved is not None:
            return self._latest_solved
        f = self.last_frame_chain()
        return f.t, f.q, f.p, f.v, f.bg, f.ba

    @staticmethod
    def _snapshot(f: FrameRec):
        return f.t, f.q.copy(), f.p.copy(), f.v.copy(), f.bg.copy(), f.ba.copy()

    # ------------------------------------------------------------------
    # deferred write-backs
    # ------------------------------------------------------------------
    def _apply_write(self, pend: dict) -> None:
        out = write_back(self.map, pend["st"], pend["meta"],
                         write_landmarks=pend.get("write_landmarks", False),
                         extra=pend.get("extra"), prefetched=pend["pf"])
        if self._copied_from and self._copied_from[0] in pend["meta"].frames:
            self._copied_from = None
        # the anchor moves to the newest frame this write solved
        newest = None
        for f in pend["meta"].frames:
            if not (f.fix_pose and f.fix_motion) and (newest is None or f.t > newest.t):
                newest = f
        if newest is not None:
            self._latest_solved = self._snapshot(newest)
        cb = pend.get("cb")
        if cb is not None:
            cb(out)

    def materialize_pending(self) -> None:
        """Land every deferred write-back, oldest first; the staged
        localize result lands first, so that a window write of the same
        frame wins."""
        self._materialize_loc()
        while self._pending_writes:
            self._apply_write(self._pending_writes.pop(0))

    def _materialize_for_mirror(self) -> None:
        """mirror_frame's landing rule: every pending write whose read
        has arrived (it rode a completed tracker read) lands without a
        wait; then the oldest land, waiting if they must, until at most
        max_pending - 1 remain and none of them is a keyframe step's.
        Depth 1 lands them all. A keyframe step's write also sets track
        flags and world points, which select and seed the next
        extraction's landmarks, so under the two-frame schedule it lags
        one frame, not two; the JAX package keeps it in flight
        (xrslam_tpu/core/sliding_window.py:339-352), and its next solve
        then takes another landmark set than the synchronous schedule
        gives it."""
        self._materialize_loc()
        pend = self._pending_writes
        while pend and pend[0]["pf"].arrived:
            self._apply_write(pend.pop(0))
        while len(pend) >= self.max_pending or any(w.get("cb") for w in pend):
            self._apply_write(pend.pop(0))

    def _queue_write(self, **pend) -> None:
        self._pending_writes.append(pend)
        while len(self._pending_writes) > self.max_pending:
            self._apply_write(self._pending_writes.pop(0))

    def _inject_solved(self, state, data, frames, meta):
        """Correct an extraction from the solves whose write-back has not
        landed (subframe steps under the two-frame schedule), so that the
        solve starts from what the extraction after materialize_pending()
        holds, on the device:
        - every frame slot that a pending solve covers takes its state
          (oldest solve first, so that the newest wins), and the newest
          frame's slot, whose host values are mirror_frame's copy of its
          predecessor's, that predecessor's;
        - every landmark slot anchored on such a frame takes the inverse
          depth from its world point and the anchor's landed position;
        - every preintegration linearized at such a frame's biases is
          integrated again at the landed ones.
        The JAX package corrects only the first
        (xrslam_tpu/core/sliding_window.py:359-413). Returns (state,
        data)."""
        if not self._pending_writes:
            return state, data
        dev = self.device
        K = int(state.q.shape[0])
        new_j, src = self._copied_from or (None, None)
        covered = {f.id for pend in self._pending_writes for f in pend["meta"].frames}
        # the frame whose pending state each slot takes
        of = [src if f is new_j and f.id not in covered else f for f in frames]
        injected = np.zeros((K,), bool)
        for pend in self._pending_writes:
            idx = {f.id: j for j, f in enumerate(pend["meta"].frames)}
            fmap = np.array([idx.get(f.id, 0) for f in of] + [0] * (K - len(frames)))
            fmask = np.array([f.id in idx for f in of] + [False] * (K - len(frames)))
            if fmask.any():
                injected |= fmask
                state = _inject_frames(state, pend["st"], torch.as_tensor(fmap, device=dev),
                                       torch.as_tensor(fmask, device=dev))
        if not injected.any():
            return state, data
        slots = [l for l in range(len(meta.track_ids))
                 if meta.landmark_mask[l] and injected[meta.ref_idx[l]]]
        if slots:
            p_w = np.stack([self.map.tracks[meta.track_ids[l]].p_w for l in slots])
            ref = torch.as_tensor(meta.ref_idx[slots].astype(np.int64), device=dev)
            p_wc = state.p.index_select(0, ref) + lie.quat_rotate(
                state.q.index_select(0, ref), data.p_bc.index_select(0, ref))
            rng = torch.linalg.vector_norm(
                torch.as_tensor(p_w, dtype=p_wc.dtype, device=dev) - p_wc, dim=-1)
            state = state._replace(inv_depth=state.inv_depth.index_copy(
                0, torch.as_tensor(slots, device=dev), 1.0 / torch.clamp(rng, min=1e-9)))
        # preintegration entry j is linearized at frame j-1's biases
        lin = np.zeros((K,), bool)
        lin[1:] = meta.preint_mask[1:] & injected[:-1]
        if lin.any():
            m = torch.as_tensor(lin, device=dev)[:, None]
            bg_lin = torch.where(m, torch.roll(state.bg, 1, 0), data.bg_lin)
            ba_lin = torch.where(m, torch.roll(state.ba, 1, 0), data.ba_lin)
            tb, wb, ab, te, cnt, steps = meta.imu
            data = data._replace(bg_lin=bg_lin, ba_lin=ba_lin, preint=pre.integrate_batch(
                tb, wb, ab, te, bg_lin, ba_lin, self.noise, cnt, steps=steps))
        return state, data

    def _apply_loc(self, pf, target: FrameRec) -> None:
        if self._copied_from and self._copied_from[0] is target:
            self._copied_from = None
        q, p, v, bg, ba = pf.get()
        target.q, target.p, target.v = nputil.quat_normalize(q), p, v
        target.bg, target.ba = bg, ba

    def _materialize_loc(self) -> None:
        """Land a staged localize result (lifted-subframe keyframe
        cases)."""
        pl, self._pending_loc = self._pending_loc, None
        if pl is not None:
            self._apply_loc(pl["pf"], pl["target"])

    def collect_riders(self) -> list:
        """The in-flight reads that should ride the tracker's next read
        (pending write-backs, the staged localize result); each rides at
        most one (the tracker marks it `riding`)."""
        out = [] if self._pending_loc is None else [self._pending_loc["pf"]]
        out += [pend["pf"] for pend in self._pending_writes]
        return [h for h in out if not h.riding]

    # ------------------------------------------------------------------
    def mirror_frame(self, tracker_map: PipelineMap, frame_id: int) -> bool:
        """Pull the new frame from the tracker map: clone it, splice the
        IMU samples of skipped frames, extend tracks continuing from the
        window's latest frame, stage the IMU prediction. Due write-backs
        land first (_materialize_for_mirror)."""
        self._materialize_for_mirror()
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
        # the copy is stale while frame_i's write is pending: _inject_solved
        # gives new_j's slot frame_i's pending state
        self._copied_from = (new_j, frame_i)
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
        """One packed device -> host read of several tensors (numpy
        arrays of their dtypes)."""
        self.stats["parsac_host_reads"] += 1
        return list(fetch_packed(tuple(tensors)))

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
        self.times.tag(self.map.frames[-1].id,
                       kind="subframe" if verdict == "subframe" else "keyframe")
        if verdict != "subframe":
            if any(f.kp_depth is not None for f in self.map.all_frames()):
                self.stats["depth_keyframes"] += 1
                with self.times.stage("localize_newframe_time"):
                    self.localize_newframe(defer_write=True)
                self.manage_keyframe(verdict)
                self._materialize_localize()
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
        self._loc_result = None
        return True

    def _fused_keyframe_step(self, verdict: str) -> None:
        """Localize → inject → triangulate candidates → full-window
        VI-BA → landmark gates, then the write-back and flag updates."""
        l_state, l_data, l_meta, target, l_slot = self._prepare_localize()
        l_opts = SolveOptions(iterations=self._budgeted_iterations("localize"))
        # the anchor while this write is pending: the temporally latest
        # frame whose host record holds solved values (all but the target)
        frames0 = self.map.frames
        anchor = frames0[-1]
        if len(frames0) >= 2:
            anchor = frames0[-2].subframes[-1] if frames0[-2].subframes else frames0[-2]
        anchor_state = self._snapshot(anchor)
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
        state, data = self._inject_solved(state, data, frames, meta)
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
        # the refine share is budgeted with the whole chain, as the
        # subframe chain is (_budget_chained), from the "kf_chain" time
        # that _note_solve measures. Departure from the JAX package, which
        # takes it from the "refine" time (xrslam_tpu/core/sliding_window.py:650)
        # that only the depth path's refine_window measures, and so never
        # clamps this chain; the reference limits every solve (solver.cpp:186).
        r_opts = self._budget_chained(
            "kf_chain", l_opts,
            SolveOptions(iterations=self._budgeted_iterations("refine")))
        self._count_clamped(l_opts, r_opts)
        t0 = time.perf_counter()
        st1, st2, gates, tri_ok = solve_keyframe_chain(
            l_state, l_data, l_opts, state, data, r_opts, l_slot, s2, inject,
            torch.as_tensor(cand_mask, device=self.device),
            torch.as_tensor(fuv, dtype=state.p.dtype, device=self.device))
        if self._limit_active():
            self._note_solve("kf_chain", st2, l_opts.iterations + r_opts.iterations, t0)
        data_eff = data._replace(
            landmark_mask=(data.landmark_mask | tri_ok) & gates[0])
        self._last_window = (st2, data_eff, meta)
        meta_eff = dataclasses.replace(meta, landmark_mask=meta.landmark_mask | cand_mask)

        def apply_flags(extra_out):
            # candidates keep their track only if triangulation and the
            # post-solve gates accept them
            (g_ok, _), t_ok = extra_out
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

        # lifted-subframe cases: the target is not a window slot; its
        # host record takes the localized state
        pf_loc = None if inject else fetch_packed_start(
            tuple(x[l_slot] for x in (st1.q, st1.p, st1.v, st1.bg, st1.ba)))
        if self.config.deferred_subframe_write:
            if self._latest_solved is None or not self._pending_writes:
                self._latest_solved = anchor_state
            self._queue_write(st=st2, meta=meta_eff, extra=(gates, tri_ok),
                              pf=write_back_start(st2, (gates, tri_ok)),
                              cb=apply_flags, write_landmarks=True)
            if pf_loc is not None:
                self._pending_loc = dict(pf=pf_loc, target=target)
        else:
            if pf_loc is not None:
                self._apply_loc(pf_loc, target)
            apply_flags(write_back(self.map, st2, meta_eff, extra=(gates, tri_ok),
                                   write_landmarks=True))

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
        # under a solver_time_limit the chain is budgeted as one solve:
        # its time per iteration clamps the subwindow share, the localize
        # share keeps its own count
        chain_key = "chained:" + variant
        l_opts = SolveOptions(iterations=self._budgeted_iterations("localize"))
        s_opts = self._budget_chained(chain_key, l_opts, s_opts)
        self._count_clamped(l_opts, s_opts)
        return dict(l_state=l_state, l_data=l_data, l_opts=l_opts,
                    s_state=s_state, s_data=s_data, s_opts=s_opts, s2=s2,
                    variant=variant, chain_key=chain_key, kf=kf, saved=saved,
                    meta=s_meta)

    def finish_fused_subframe(self, ctx: dict, st2) -> None:
        """Apply a fused subframe solve's result: time it for the budget
        (from ctx["t0"], set where the solve began), restore the
        keyframe's fix flags, queue the subwindow's write-back (or write
        it back at once without deferred write-backs)."""
        if self._limit_active():
            self._note_solve(ctx["chain_key"], st2, ctx["l_opts"].iterations
                             + ctx["s_opts"].iterations, ctx["t0"])
        self._in_broker = False
        ctx["kf"].fix_pose, ctx["kf"].fix_motion = ctx["saved"]
        frames = ctx["meta"].frames
        if self.config.deferred_subframe_write and len(frames) >= 2:
            if self._latest_solved is None or not self._pending_writes:
                # frames[-2]: the newest frame whose host record is solved
                # (older pending writes move the anchor as they land)
                self._latest_solved = self._snapshot(frames[-2])
            self._queue_write(st=st2, meta=ctx["meta"], pf=write_back_start(st2))
        else:
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
            if self.config.deferred_subframe_write:
                # until the broker solves, publish the anchor that
                # finish_fused_subframe sets, not the unsolved target
                if self._latest_solved is None or not self._pending_writes:
                    self._latest_solved = self._snapshot(ctx["meta"].frames[-2])
                self._in_broker = True
            self.solve_broker.submit(self, ctx)
            return
        ctx["t0"] = time.perf_counter()
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
        state, data = self._inject_solved(state, data, wframes, meta)
        state = self._apply_pred(state, wframes, data)
        pm = np.zeros((self.K_slots + 2,), dtype=bool)
        pm[len(wframes) - 1] = bool(meta.preint_mask[len(wframes) - 1])
        data = data._replace(preint_mask=torch.as_tensor(pm, device=self.device),
                             fix_landmark=torch.ones_like(data.fix_landmark))
        return state, data, meta, target, len(wframes) - 1

    def localize_newframe(self, defer_write: bool = False) -> None:
        """Solve the new frame alone (the localize window) and write its
        state back; with `defer_write` its read starts and
        _materialize_localize lands it."""
        state, data, meta, target, slot = self._prepare_localize()
        opts = SolveOptions(iterations=self._budgeted_iterations("localize"))
        self._count_clamped(opts)
        st, _ = self._solve_timed("localize", state, data, opts)
        if defer_write:
            self._loc_result = (fetch_packed_start(
                tuple(x[slot] for x in (st.q, st.p, st.v, st.bg, st.ba))), target)
        else:
            write_back(self.map, st, meta, write_landmarks=False,
                       frame_subset={target.id})

    def _materialize_localize(self) -> None:
        """Land localize_newframe(defer_write=True)'s result in the
        target's host record."""
        loc, self._loc_result = self._loc_result, None
        if loc is not None:
            self._apply_loc(*loc)

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
        state, data = self._inject_solved(state, data, frames, meta)
        if self.marg is None:
            self.marg = MargPrior.gauge_fix(self.K_slots, self.L_slots, state)
        data = data._replace(marg=self.marg, use_marg=torch.ones(
            (), dtype=torch.bool, device=self.device))
        opts = SolveOptions(iterations=self._budgeted_iterations("refine"))
        self._count_clamped(opts)
        st, _ = self._solve_timed("refine", state, data, opts)
        fuv = np.stack([[f.K[0, 0], f.K[1, 1]] for f in frames]
                       + [[1.0, 1.0]] * (self.K_slots - len(frames)))
        gates = landmark_gates(st, data, torch.as_tensor(
            fuv, dtype=st.p.dtype, device=self.device))
        # landmarks the gates reject do not enter the marginalization prior
        self._last_window = (
            st, data._replace(landmark_mask=data.landmark_mask & gates[0]), meta)

        def apply_gates(extra_out):
            self._apply_landmark_gates(meta, extra_out[0])
            covered = {tid for l, tid in enumerate(meta.track_ids)
                       if meta.landmark_mask[l]}
            self._revalidate_landmarks(frames, skip_ids=covered)

        if self.config.deferred_subframe_write:
            # the localize stage landed the target's pose: the anchor is
            # the target
            self._latest_solved = self._snapshot(frames[-1])
            self._queue_write(st=st, meta=meta, extra=gates, cb=apply_gates,
                              pf=write_back_start(st, gates), write_landmarks=True)
        else:
            apply_gates(write_back(self.map, st, meta, extra=gates))

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
                # the extraction reads host records: land deferred writes
                self.materialize_pending()
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
        state, data = self._inject_solved(state, data, frames, meta)
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
            opts = SolveOptions(iterations=self._budgeted_iterations("subwindow_rot"),
                                use_rotation=True)
            variant = "subwindow_rot"
        else:
            data_r = data._replace(fix_landmark=torch.as_tensor(fix_lm, device=dev))
            opts = SolveOptions(iterations=self._budgeted_iterations("subwindow"))
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
