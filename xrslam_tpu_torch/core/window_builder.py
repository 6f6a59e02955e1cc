"""Bridge between the host-side PipelineMap and the fixed-shape solver
tensors (port of `xrslam_tpu/core/window_builder.py`).

Extraction selects an ordered frame list and a track filter and builds
padded (K_slots, L_slots) WindowState/WindowData on the device;
write-back pushes optimized states and landmark world points into the
map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..estimation.window import MargPrior, WindowData, WindowState
from ..imu import preintegration as pre
from ..utils.fetch import fetch_packed_start
from . import nputil
from .map import FrameRec, PipelineMap, TrackRec


@dataclass
class WindowMeta:
    """Bookkeeping to write solver results back into the map, with
    host copies of the index/mask arrays the orchestration branches
    on."""

    frames: List[FrameRec]
    track_ids: List[int]          # landmark slot -> track id
    anchor_bearing: np.ndarray    # (L,3)
    ref_idx: np.ndarray           # (L,) int32
    landmark_mask: np.ndarray     # (L,) bool
    obs_mask: np.ndarray          # (K,L) bool
    preint_mask: np.ndarray       # (K,) bool
    imu: tuple = None             # device (t, w, a, t_end, count, steps)


IMU_CAP_BUCKETS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def bucket_imu_cap(n: int) -> int:
    """Smallest allowed IMU buffer capacity >= n."""
    for b in IMU_CAP_BUCKETS:
        if n <= b:
            return b
    raise RuntimeError(
        f"IMU interval holds {n} samples — beyond the largest supported "
        f"buffer ({IMU_CAP_BUCKETS[-1]}); check the frame/IMU rates")


def needed_imu_cap(frame_lists, floor: int = 0) -> int:
    needed = floor
    for fl in frame_lists:
        needed = max(needed, sum(len(f.imu_t) for f in fl))
    return bucket_imu_cap(needed)


def interval_samples(frames_between: List[FrameRec], cap: int):
    """Concatenate the raw IMU samples of `frames_between` into a
    fixed-capacity buffer (t (cap,), w (cap,3), a (cap,3), count, t0).
    Timestamps are rebased to the interval's first sample t0 on the
    host (absolute dataset times have ~128 s resolution in float32);
    callers pass end times relative to t0."""
    if frames_between:
        ts = np.concatenate([f.imu_t for f in frames_between])
        ws = np.concatenate([f.imu_w for f in frames_between])
        accs = np.concatenate([f.imu_a for f in frames_between])
    else:
        ts, ws, accs = np.zeros((0,)), np.zeros((0, 3)), np.zeros((0, 3))
    if len(ts) > cap:
        raise RuntimeError(
            f"IMU buffer overflow: {len(ts)} samples > cap {cap} — "
            "caller must bucket the capacity (needed_imu_cap)")
    n = len(ts)
    t_buf = np.zeros((cap,))
    w_buf = np.zeros((cap, 3))
    a_buf = np.zeros((cap, 3))
    t0 = float(ts[0]) if n else 0.0
    t_buf[:n] = ts - t0
    w_buf[:n] = ws
    a_buf[:n] = accs
    return t_buf, w_buf, a_buf, n, t0


def depth_seed(tr, frames_by_id) -> Optional[np.ndarray]:
    """The landmark of the track's first observation with a measured
    keypoint depth (`FrameRec.kp_depth` > 1e-3) and a bearing in front
    of the camera: the point at that z along the bearing, through the
    frame's camera pose. None without such an observation."""
    for fid, k in tr.obs.items():
        f = frames_by_id.get(fid)
        if f is None or f.kp_depth is None:
            continue
        z = float(f.kp_depth[k])
        if z <= 1e-3:
            continue
        b = f.bearings[k]
        if b[2] <= 1e-6:
            continue
        q_wc, p_wc = f.camera_pose()
        return nputil.quat_rotate(q_wc, b / b[2] * z) + p_wc
    return None


def triangulate_track(tr, frames_by_id) -> Tuple[Optional[np.ndarray], bool]:
    """(the track's landmark or None, whether a measured depth seeded
    it). Seeded from a measured depth where one of its observations has
    one (`depth_seed`: one observation suffices, no cheirality gate),
    else the multi-view DLT with cheirality check over all of its
    observing frames (host, numpy)."""
    p = depth_seed(tr, frames_by_id)
    if p is not None:
        return p, True
    rows = []
    Ps = []
    for fid, k in tr.obs.items():
        f = frames_by_id.get(fid)
        if f is None:
            continue
        q_wc, p_wc = f.camera_pose()
        R = nputil.quat_to_matrix(q_wc).T
        T = -(R @ p_wc)
        P = np.concatenate([R, T[:, None]], axis=1)
        b = f.bearings[k]
        rows.append(b[0] * P[2] - b[2] * P[0])
        rows.append(b[1] * P[2] - b[2] * P[1])
        Ps.append(P)
    if len(Ps) < 2:
        return None, False
    _, _, vt = np.linalg.svd(np.stack(rows), full_matrices=True)
    h = vt[-1]
    for P in Ps:
        if not ((P @ h)[2] * h[3] > 0):
            return None, False
    return h[:3] / h[3], False


def extract_window(pmap: PipelineMap, frames: List[FrameRec], K_slots: int,
                   L_slots: int, noise: pre.ImuNoise, device,
                   track_filter: Optional[Callable[[TrackRec], bool]] = None,
                   imu_cap: int = 256, with_preint: bool = True,
                   all_frames_between: Optional[List[List[FrameRec]]] = None,
                   dtype=torch.float64):
    """Build (WindowState, WindowData, WindowMeta) from `frames` on
    `device`.

    Landmark slots hold tracks passing `track_filter` observed by ≥1
    window frame, anchored at their first window observation;
    preintegration entry j integrates the raw IMU of
    `all_frames_between[j]` (default: frame j); frame fix flags come
    from the FrameRec tags."""
    K = len(frames)
    assert K <= K_slots
    fid_to_slot = {f.id: i for i, f in enumerate(frames)}

    def padK(arrs, d):
        out = np.zeros((K_slots,) + d)
        for i, a in enumerate(arrs):
            out[i] = a
        return out

    q = padK([f.q for f in frames], (4,))
    q[K:, 0] = 1.0
    p = padK([f.p for f in frames], (3,))
    v = padK([f.v for f in frames], (3,))
    bg = padK([f.bg for f in frames], (3,))
    ba = padK([f.ba for f in frames], (3,))
    q_bc = padK([f.q_bc for f in frames], (4,))
    q_bc[K:, 0] = 1.0
    p_bc = padK([f.p_bc for f in frames], (3,))
    q_bi = padK([f.q_bi for f in frames], (4,))
    q_bi[K:, 0] = 1.0
    p_bi = padK([f.p_bi for f in frames], (3,))
    w2 = padK([f.sqrt_inv_cov2 for f in frames], (2, 2))

    track_filter = track_filter or (lambda t: True)
    chosen: List[TrackRec] = []
    seen = set()
    for f in frames:
        for k in np.nonzero(f.track_ids >= 0)[0]:
            tid = int(f.track_ids[k])
            if tid in seen:
                continue
            seen.add(tid)
            tr = pmap.tracks.get(tid)
            if tr is None or not track_filter(tr):
                continue
            if not any(fid in fid_to_slot for fid in tr.obs):
                continue
            chosen.append(tr)
            if len(chosen) >= L_slots:
                break
        if len(chosen) >= L_slots:
            break

    bearings = np.zeros((K_slots, L_slots, 3))
    bearings[..., 2] = 1.0
    obs_mask = np.zeros((K_slots, L_slots), dtype=bool)
    inv_depth = np.zeros((L_slots,))
    lm_mask = np.zeros((L_slots,), dtype=bool)
    track_ids = [tr.id for tr in chosen]
    anchor_bearing = np.zeros((L_slots, 3))
    anchor_bearing[:, 2] = 1.0
    tid_to_slot = {tid: l for l, tid in enumerate(track_ids)}
    for s, f in enumerate(frames):
        ks = np.nonzero(f.track_ids >= 0)[0]
        if len(ks) == 0:
            continue
        ls = np.fromiter((tid_to_slot.get(int(t), -1) for t in f.track_ids[ks]),
                         np.int64, len(ks))
        sel = ls >= 0
        if not sel.any():
            continue
        b = f.bearings[ks[sel]]
        bearings[s, ls[sel]] = b / np.linalg.norm(b, axis=1, keepdims=True)
        obs_mask[s, ls[sel]] = True
    n_ch = len(chosen)
    ref_idx = np.where(obs_mask.any(axis=0), obs_mask.argmax(axis=0), 0).astype(np.int32)
    anchor_bearing[:n_ch] = bearings[ref_idx[:n_ch], np.arange(n_ch)]
    if n_ch:
        p_wc_all = np.stack([f.p + nputil.quat_rotate(f.q, f.p_bc) for f in frames])
        has = np.array([tr.p_w is not None for tr in chosen])
        if has.any():
            idxs = np.nonzero(has)[0]
            X = np.stack([chosen[i].p_w for i in idxs])
            rng = np.linalg.norm(X - p_wc_all[ref_idx[idxs]], axis=1)
            inv_depth[idxs] = 1.0 / np.maximum(rng, 1e-9)
            lm_mask[idxs] = True

    if with_preint:
        lists = [(all_frames_between[j] if all_frames_between is not None
                  else [frames[j]]) for j in range(1, K)]
        imu_cap = needed_imu_cap(lists, floor=imu_cap)
    pmask = np.zeros((K_slots,), dtype=bool)
    bg_lin = np.zeros((K_slots, 3))
    ba_lin = np.zeros((K_slots, 3))
    t_bufs = np.zeros((K_slots, imu_cap))
    w_bufs = np.zeros((K_slots, imu_cap, 3))
    a_bufs = np.zeros((K_slots, imu_cap, 3))
    t_ends = np.zeros((K_slots,))
    counts = np.zeros((K_slots,), dtype=np.int64)
    for j in range(1, K if with_preint else 0):
        between = (all_frames_between[j] if all_frames_between is not None
                   else [frames[j]])
        t_buf, w_buf, a_buf, n, t0 = interval_samples(between, imu_cap)
        if n == 0:
            continue
        t_bufs[j], w_bufs[j], a_bufs[j] = t_buf, w_buf, a_buf
        t_ends[j] = frames[j].t - t0
        counts[j] = n
        pmask[j] = True
        bg_lin[j] = frames[j - 1].bg
        ba_lin[j] = frames[j - 1].ba
    frame_mask = np.zeros((K_slots,), dtype=bool)
    frame_mask[:K] = True
    fix_pose = np.zeros((K_slots,), dtype=bool)
    fix_motion = np.zeros((K_slots,), dtype=bool)
    for i, f in enumerate(frames):
        fix_pose[i] = f.fix_pose
        fix_motion[i] = f.fix_motion

    def T(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def B(x):
        return torch.as_tensor(x, device=device)

    noise = pre.ImuNoise(*(T(x) for x in noise))
    steps = int(counts.max()) if len(counts) else 0
    tb, wb, ab, te, cnt = T(t_bufs), T(w_bufs), T(a_bufs), T(t_ends), B(counts)
    bgl, bal = T(bg_lin), T(ba_lin)
    preint = pre.integrate_batch(tb, wb, ab, te, bgl, bal, noise, cnt,
                                 steps=steps)
    state = WindowState(q=T(q), p=T(p), v=T(v), bg=T(bg), ba=T(ba),
                        inv_depth=T(inv_depth))
    data = WindowData(
        q_bc=T(q_bc), p_bc=T(p_bc), q_bi=T(q_bi), p_bi=T(p_bi),
        bearings=T(bearings), obs_mask=B(obs_mask),
        ref_idx=B(ref_idx), sqrt_inv_cov2=T(w2), preint=preint,
        preint_mask=B(pmask), bg_lin=bgl, ba_lin=bal,
        frame_mask=B(frame_mask), fix_pose=B(fix_pose),
        fix_motion=B(fix_motion), landmark_mask=B(lm_mask),
        fix_landmark=torch.zeros((L_slots,), dtype=torch.bool, device=device),
        marg=MargPrior.zeros(K_slots, 0, dtype=dtype, device=device),
        use_marg=torch.zeros((), dtype=torch.bool, device=device))
    meta = WindowMeta(frames=frames, track_ids=track_ids,
                      anchor_bearing=anchor_bearing, ref_idx=ref_idx,
                      landmark_mask=lm_mask, obs_mask=obs_mask,
                      preint_mask=pmask, imu=(tb, wb, ab, te, cnt, steps))
    return state, data, meta


def write_back_start(state: WindowState, extra=None):
    """Start the read of a solve's result for a later
    write_back(..., prefetched=handle): the state and the `extra`
    tensors in one packed copy that does not wait."""
    return fetch_packed_start((tuple(state), extra))


def write_back(pmap: PipelineMap, state: WindowState, meta: WindowMeta,
               write_landmarks: bool = True,
               frame_subset: Optional[set] = None, extra=None, prefetched=None):
    """Push optimized states into the map: the state and the `extra`
    tensors (returned as numpy) in one packed read, or from
    `prefetched`, a handle of write_back_start(state, extra)."""
    if prefetched is None:
        prefetched = write_back_start(state, extra)
    (qs, ps, vs, bgs, bas, invd), extra_out = prefetched.get()
    for i, f in enumerate(meta.frames):
        if frame_subset is not None and f.id not in frame_subset:
            continue
        if f.fix_pose and f.fix_motion:
            continue
        if not f.fix_pose:
            f.q = nputil.quat_normalize(qs[i])
            f.p = ps[i].copy()
        if not f.fix_motion:
            f.v = vs[i].copy()
            f.bg = bgs[i].copy()
            f.ba = bas[i].copy()
    if write_landmarks:
        for l, tid in enumerate(meta.track_ids):
            tr = pmap.tracks.get(tid)
            if tr is None or not meta.landmark_mask[l]:
                continue
            q_wc, p_wc = meta.frames[int(meta.ref_idx[l])].camera_pose()
            x_c = meta.anchor_bearing[l] / max(float(invd[l]), 1e-9)
            tr.p_w = nputil.quat_rotate(q_wc, x_c) + p_wc
    return extra_out
