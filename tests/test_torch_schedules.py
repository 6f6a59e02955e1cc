"""The deferred write-back and the overlapped schedules of the port
(`core/sliding_window.py`, `core/detail.py`, `frontend/tracker.py`,
`utils/fetch.py`) held to the JAX package and to each other, on the CPU
in float64.

Both packages resume from the JAX checkpoint at frame 30 of
`tests/test_torch_checkpoint.py`'s bearing scene
(`tests/data/jax_circle_ckpt30.npz`) and drive its last 10 frames, so
that the initializer's draws, which the packages cannot share, stay out
of the comparison. Schedules: "sync" (the default `Config`: deferred
write-backs), "overlap" (`worker_overlap`, the one-frame lag) and
"pipelined" (`worker_overlap` + `pipelined_writeback`, the two-frame
lag).

- (i) the default `Config`: after every frame, the published pose
  (`predict_pose` at the frame time) and `get_latest_state()` (not
  materialized) within 1e-6 m of the JAX package's;
- (ii) overlap and pipelined against the JAX package under the same
  schedule: the frames tracking agree, the published poses within
  1e-6 m; pipelined with the JAX package's injection rule swapped in,
  since the port's rule corrects stale reads that the JAX rule misses
  (ROADMAP.md, queue 3);
- (iii) within the port, sync, overlap and pipelined end in the same
  final window after `flush()` within 1e-9 (q, p, v), PARSAC off; with
  PARSAC on, sync and overlap (PARSAC keeps one write in flight);
- (iv) an extraction with pending solves injected (`_inject_solved`)
  equals the extraction after `materialize_pending()`;
- (v) a save taken with a write pending (and, under overlap, a backend
  stage queued) resumes to the straight run's tail within 1e-6 m;
- (vi) a 320x240 image drive (`tools.make_dataset.render_sequence`,
  40 frames), sync against pipelined, within
  `tests/test_worker_overlap.py`'s bounds: frames tracked within 1, the
  same last output time, positions on common output times within
  2e-2 m; and the final window after `flush()` within 1e-9;
- and `utils.fetch`'s packed read of CPU tensors (its card test is
  `tests/test_torch_cuda.py::test_packed_read_is_pinned_and_asynchronous`).

The JAX side of (i) and (ii) is committed (`tests/data/jax_circle_schedules.npz`);
`slow` regenerates it and checks the committed file:

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \\
        python tests/test_torch_schedules.py --write
"""

import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import (CUT, DATA, JAX_CKPT, JAX_TAIL, N_FRAMES,
                                         SLOTS, jax_config, make_config, scene_inputs)
from xrslam_tpu_torch.core import sliding_window as sw
from xrslam_tpu_torch.core.detail import SyntheticTracker
from xrslam_tpu_torch.utils import checkpoint as ck

JAX_SCHEDULES = os.path.join(DATA, "jax_circle_schedules.npz")
SCHEDULES = {"sync": {},
             "overlap": {"worker_overlap": True},
             "pipelined": {"worker_overlap": True, "pipelined_writeback": True}}
POSE_TOL_M = 1e-6
WINDOW_TOL = 1e-9
# tests/test_worker_overlap.py's image-drive bound on common output times
IMAGE_POS_TOL_M = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def push_frame(pipe, inputs, k: int) -> None:
    """Frame k's IMU samples and bearings into `pipe` (either package's)."""
    bearings, mask, ts, imu_t, imu_w, imu_a = inputs
    n_frames = len(ts)
    if k > 0:
        for s in range(imu_t.shape[1]):
            t = float(imu_t[k - 1, s])
            pipe.track_gyroscope(t, imu_w[k - 1, s])
            pipe.track_accelerometer(t, imu_a[k - 1, s])
    pipe.track_gyroscope(float(ts[k]) + 1e-6, imu_w[min(k, n_frames - 2), 0])
    pipe.track_accelerometer(float(ts[k]) + 1e-6, imu_a[min(k, n_frames - 2), 0])
    kp = np.zeros((SLOTS, 3))
    kp[:, 2] = 1.0
    hint = np.full((SLOTS,), -1, dtype=np.int64)
    for slot, lm in enumerate(np.nonzero(mask[k])[0][:SLOTS]):
        kp[slot] = bearings[k, lm]
        hint[slot] = lm
    pipe.track_camera(float(ts[k]), kp, hint)


def drive_outputs(pipe, inputs, k0: int = CUT, k1=None) -> dict:
    """Frames k0..k1-1; after each, whether the pipeline tracks and, if
    so, its published pose at the frame time and its latest state (not
    materialized). Then `flush()` and the final window's frames."""
    ts = inputs[2]
    out = {k: [] for k in ("tracking", "pose_t", "pose_q", "pose_p", "latest_t",
                           "latest_p")}
    for k in range(k0, len(ts) if k1 is None else k1):
        push_frame(pipe, inputs, k)
        tracking = pipe.state == "tracking"
        out["tracking"].append(tracking)
        if tracking:
            pose = pipe.predict_pose(float(ts[k]))
            t, _, p, _, _, _ = pipe.swt.get_latest_state()
            out["pose_t"].append(pose.t)
            out["pose_q"].append(np.asarray(pose.q))
            out["pose_p"].append(np.asarray(pose.p))
            out["latest_t"].append(float(t))
            out["latest_p"].append(np.asarray(p))
    pipe.flush()
    frames = list(pipe.swt.map.all_frames())
    out.update(window_t=[f.t for f in frames], window_q=[f.q for f in frames],
               window_p=[f.p for f in frames], window_v=[f.v for f in frames])
    return {k: np.asarray(v) for k, v in out.items()}


def hint_map(path: str = JAX_TAIL) -> dict:
    ref = np.load(path)
    return dict(zip(ref["hints"].tolist(), ref["track_ids"].tolist()))


def port_run(schedule: str, **cfg_kw) -> dict:
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = hint_map()
    cfg = make_config(**cfg_kw).replace(**SCHEDULES[schedule])
    pipe = ck.load_pipeline(JAX_CKPT, cfg, tracker, device="cpu")
    return drive_outputs(pipe, scene_inputs(make_config()))


def jax_run(schedule: str) -> dict:
    import dataclasses

    from xrslam_tpu.core.detail import SyntheticTracker as JSyntheticTracker
    from xrslam_tpu.utils import checkpoint as jck

    tracker = JSyntheticTracker()
    tracker._id_map = hint_map()
    cfg = dataclasses.replace(jax_config(), **SCHEDULES[schedule])
    pipe = jck.load_pipeline(JAX_CKPT, cfg, tracker)
    return drive_outputs(pipe, scene_inputs(make_config()))


def write_jax_file(path: str = JAX_SCHEDULES) -> None:
    np.savez(path, **{f"{s}/{k}": v for s in SCHEDULES
                      for k, v in jax_run(s).items()})


def jax_rule_landing(swt):
    """The JAX package's landing rule at mirror_frame
    (xrslam_tpu/core/sliding_window.py:339-352): a keyframe step's
    write may stay in flight too."""
    swt._materialize_loc()
    pend = swt._pending_writes
    while pend and pend[0]["pf"].arrived:
        swt._apply_write(pend.pop(0))
    while len(pend) >= swt.max_pending:
        swt._apply_write(pend.pop(0))


def jax_rule_inject(swt, state, data, frames, meta):
    """The JAX package's injection rule
    (xrslam_tpu/core/sliding_window.py:359-413), for the test that holds
    the rest of the two-frame schedule to it: frame slots, and the
    inverse depth of landmark slots with the pending solve's anchor
    frame; no bias linearization."""
    K, L = int(state.q.shape[0]), int(state.inv_depth.shape[0])
    for pend in swt._pending_writes:
        pm = pend["meta"]
        idx = {f.id: j for j, f in enumerate(pm.frames)}
        fmap, fmask = np.zeros((K,), np.int64), np.zeros((K,), bool)
        for i, f in enumerate(frames):
            if f.id in idx:
                fmap[i], fmask[i] = idx[f.id], True
        lmap, lmask = np.zeros((L,), np.int64), np.zeros((L,), bool)
        if pend.get("write_landmarks"):
            pslot = {tid: l for l, tid in enumerate(pm.track_ids) if pm.landmark_mask[l]}
            for l2, tid in enumerate(meta.track_ids):
                l = pslot.get(tid) if meta.landmark_mask[l2] else None
                if l is not None and \
                        meta.frames[meta.ref_idx[l2]].id == pm.frames[pm.ref_idx[l]].id:
                    lmap[l2], lmask[l2] = l, True
        st = pend["st"]
        state = sw._inject_frames(state, st, torch.as_tensor(fmap), torch.as_tensor(fmask))
        state = state._replace(inv_depth=torch.where(
            torch.as_tensor(lmask), st.inv_depth[torch.as_tensor(lmap)], state.inv_depth))
    return state, data


def jax_outputs(schedule: str, path: str = JAX_SCHEDULES) -> dict:
    ref = np.load(path)
    return {k.split("/", 1)[1]: ref[k] for k in ref.files
            if k.startswith(schedule + "/")}


@pytest.fixture(scope="module")
def port_runs():
    return {s: port_run(s) for s in SCHEDULES}


def pose_errors(ref: dict, out: dict) -> dict:
    """Largest distance of the published poses and latest states, after
    checking that the same frames track with the same output times."""
    np.testing.assert_array_equal(out["tracking"], ref["tracking"])
    np.testing.assert_array_equal(out["pose_t"], ref["pose_t"])
    np.testing.assert_array_equal(out["latest_t"], ref["latest_t"])
    assert ref["tracking"].sum() >= 5
    return {k: float(np.max(np.linalg.norm(out[k] - ref[k], axis=-1)))
            for k in ("pose_p", "latest_p")}


def test_default_anchor_matches_jax(port_runs):
    """(i): the port publishes the JAX package's poses under the default
    Config (deferred write-backs: one solve back)."""
    err = pose_errors(jax_outputs("sync"), port_runs["sync"])
    assert max(err.values()) < POSE_TOL_M, err


def test_overlap_matches_jax(port_runs):
    """(ii), the one-frame lag."""
    err = pose_errors(jax_outputs("overlap"), port_runs["overlap"])
    assert max(err.values()) < POSE_TOL_M, err


def test_pipelined_matches_jax(monkeypatch):
    """(ii), the two-frame lag: with the JAX package's landing and
    injection rules in place of the port's, the port publishes the JAX
    package's poses. The port lands a keyframe step's write before the
    next extraction and corrects the new frame's copied values, the
    landmarks anchored on injected frames and the bias linearization
    (`_materialize_for_mirror`, `_inject_solved`); the JAX rules leave
    these stale, and the JAX package parts from its own synchronous
    schedule (the final window's last frame 5.2e-4 m away on this scene,
    `jax_circle_schedules.npz`; ROADMAP.md, queue 3) where the port does
    not (test_schedules_end_in_the_sync_window)."""
    monkeypatch.setattr(sw.SlidingWindowTracker, "_materialize_for_mirror", jax_rule_landing)
    monkeypatch.setattr(sw.SlidingWindowTracker, "_inject_solved", jax_rule_inject)
    err = pose_errors(jax_outputs("pipelined"), port_run("pipelined"))
    assert max(err.values()) < POSE_TOL_M, err
    jax_sync, jax_pipe = jax_outputs("sync"), jax_outputs("pipelined")
    assert np.abs(jax_sync["window_p"] - jax_pipe["window_p"]).max() > 1e-4


def assert_same_window(a: dict, b: dict) -> None:
    np.testing.assert_array_equal(a["window_t"], b["window_t"])
    for k in ("window_q", "window_p", "window_v"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=WINDOW_TOL, err_msg=k)


@pytest.mark.parametrize("schedule", ["overlap", "pipelined"])
def test_schedules_end_in_the_sync_window(port_runs, schedule):
    """(iii), PARSAC off."""
    assert_same_window(port_runs["sync"], port_runs[schedule])
    assert abs(int(port_runs["sync"]["tracking"].sum())
               - int(port_runs[schedule]["tracking"].sum())) <= 1


def test_overlap_with_parsac_ends_in_the_sync_window():
    """(iii), PARSAC on: the judge runs on every backend frame."""
    sync = port_run("sync", parsac_flag=True)
    assert_same_window(sync, port_run("overlap", parsac_flag=True))


def test_inject_solved_equals_materialized_extraction():
    """(iv): under the two-frame schedule, at every frame with solves
    pending, the window's extraction with them injected equals the
    extraction after they land: every frame state, the bias
    linearization and the preintegration, and the inverse depth of every
    landmark that both extractions hold with the same anchor frame."""
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = hint_map()
    cfg = make_config().replace(**SCHEDULES["pipelined"])
    pipe = ck.load_pipeline(JAX_CKPT, cfg, tracker, device="cpu")
    inputs = scene_inputs(make_config())
    checked = landmarks = 0
    for k in range(CUT, N_FRAMES):
        push_frame(pipe, inputs, k)
        swt = pipe.swt
        if not swt._pending_writes:
            continue
        # the state at the next extraction: mirror_frame's landing rule
        swt._materialize_for_mirror()
        if not swt._pending_writes:
            continue
        frames = list(swt.map.frames)

        def extract():
            keep = {tr.id for tr in swt.map.tracks.values()
                    if tr.valid and tr.triangulated and tr.static}
            return swt._extract(frames, swt.K_slots, track_filter=lambda t: t.id in keep,
                                all_frames_between=swt._kf_between(frames), imu_cap=128)

        state, data, meta = extract()
        injected, inj_data = swt._inject_solved(state, data, frames, meta)
        swt.materialize_pending()
        landed, landed_data, meta2 = extract()
        pairs = [(getattr(injected, n), getattr(landed, n), n) for n in ("q", "p", "v", "bg", "ba")]
        pairs += [(getattr(inj_data, n), getattr(landed_data, n), n) for n in ("bg_lin", "ba_lin")]
        pairs += list(zip(inj_data.preint, landed_data.preint, inj_data.preint._fields))
        for a, b, name in pairs:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12,
                                       err_msg=f"frame {k} {name}")
        slot2 = {tid: l for l, tid in enumerate(meta2.track_ids) if meta2.landmark_mask[l]}
        for l, tid in enumerate(meta.track_ids):
            l2 = slot2.get(tid)
            if meta.landmark_mask[l] and l2 is not None and \
                    meta.frames[meta.ref_idx[l]] is meta2.frames[meta2.ref_idx[l2]]:
                assert abs(float(injected.inv_depth[l] - landed.inv_depth[l2])) \
                    <= 1e-12 * max(1.0, abs(float(landed.inv_depth[l2]))), (k, tid)
                landmarks += 1
        checked += 1
    assert checked >= 5 and landmarks > 0, (checked, landmarks)


def test_save_with_write_pending_resumes(tmp_path):
    """(v): save at frame 35 under overlap, with a write-back pending and
    the frame's backend stage queued; the resumed tail equals the saved
    pipeline's own, driven on. (The default schedule's save with a write
    pending is tests/test_torch_checkpoint.py's resume test.)"""
    schedule = "overlap"
    inputs = scene_inputs(make_config())
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = hint_map()
    cfg = make_config().replace(**SCHEDULES[schedule])
    straight = ck.load_pipeline(JAX_CKPT, cfg, tracker, device="cpu")
    cut = CUT + 5
    for k in range(CUT, cut):
        push_frame(straight, inputs, k)
    assert straight.swt._pending_writes
    assert straight._issue_queue
    path = str(tmp_path / "pending.npz")
    ck.save_pipeline(path, straight)
    assert not straight.swt._pending_writes and not straight._issue_queue
    tracker2 = SyntheticTracker(device="cpu")
    tracker2._id_map = dict(straight.tracker._id_map)
    resumed = ck.load_pipeline(path, cfg, tracker2, device="cpu")
    a = drive_outputs(straight, inputs, cut)
    c = drive_outputs(resumed, inputs, cut)
    err = pose_errors(a, c)
    assert max(err.values()) < POSE_TOL_M, err
    assert_same_window(a, c)


def image_run(seq: dict, schedule: str):
    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.tools.make_dataset import run_sequence

    slam = api.XRSLAM(config=seq["config"].replace(**SCHEDULES[schedule]), device="cpu")
    ts, ps = run_sequence(api, slam, seq)
    # run_sequence ends in api.XRSLAM.flush: the last frame tracked, issued
    # and written back
    pipe, swt = slam.pipeline, slam.pipeline.swt
    assert pipe.tracker._pending is None and not pipe._issue_queue
    assert not swt._pending_writes and swt.last_frame_chain().t == pipe.tracker_map.frames[-1].t
    frames = list(swt.map.all_frames())
    return ts, ps, {"window_t": np.asarray([f.t for f in frames]),
                    **{f"window_{k}": np.asarray([getattr(f, k) for f in frames])
                       for k in "qpv"}}


def test_image_drive_pipelined_matches_sync():
    """(vi)"""
    from xrslam_tpu_torch.tools.make_dataset import render_sequence

    seq = render_sequence(n_frames=40)
    ts_s, ps_s, win_s = image_run(seq, "sync")
    ts_p, ps_p, win_p = image_run(seq, "pipelined")
    assert len(ts_s) >= 5, len(ts_s)
    assert abs(len(ts_s) - len(ts_p)) <= 1 and ts_s[-1] == ts_p[-1]
    idx_p = {t: i for i, t in enumerate(ts_p.tolist())}
    common = [(i, idx_p[t]) for i, t in enumerate(ts_s.tolist()) if t in idx_p]
    assert len(common) >= len(ts_s) - 1
    d = max(float(np.linalg.norm(ps_s[i] - ps_p[j])) for i, j in common)
    assert d < IMAGE_POS_TOL_M, d
    assert_same_window(win_s, win_p)


def test_fetch_packed_on_the_cpu():
    """`utils.fetch` on CPU tensors: complete at once, each leaf a copy
    of its tensor with its dtype, the tree's structure kept (None and
    numpy leaves pass through)."""
    from xrslam_tpu_torch.estimation.window import WindowState
    from xrslam_tpu_torch.utils.fetch import fetch_packed_start

    st = WindowState(*(torch.arange(4.0).reshape(2, 2) * i for i in range(6)))
    tree = (st, {"ok": torch.tensor([True, False]), "n": torch.arange(3)}, None, np.ones(2))
    h = fetch_packed_start(tree)
    assert h.ready() and not h.arrived
    st.q.add_(1.0)  # the values are taken when the read starts
    out = h.get()
    assert h.arrived and isinstance(out[0], WindowState) and out[2] is None
    np.testing.assert_array_equal(out[0].q, np.zeros((2, 2)))
    np.testing.assert_array_equal(out[0].p, np.arange(4.0).reshape(2, 2))
    assert out[1]["ok"].dtype == bool and out[1]["n"].dtype == np.int64
    assert out[3] is tree[3]


@pytest.mark.slow
def test_committed_jax_file_matches_fresh_jax_run(tmp_path):
    path = str(tmp_path / "schedules.npz")
    write_jax_file(path)
    for s in SCHEDULES:
        fresh, committed = jax_outputs(s, path), jax_outputs(s)
        assert sorted(fresh) == sorted(committed)
        for k in fresh:
            np.testing.assert_allclose(fresh[k].astype(float), committed[k].astype(float),
                                       rtol=0, atol=1e-12, err_msg=f"{s}/{k}")


if __name__ == "__main__" and "--write" in sys.argv:
    write_jax_file()
    print("wrote", JAX_SCHEDULES)
