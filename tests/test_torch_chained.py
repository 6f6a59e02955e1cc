"""The device-chained KLT frontend (`Config.chained_frontend`,
`xrslam_tpu_torch/frontend/tracker.py`) held to the JAX package's, on
the CPU (the backend in float64).

The JAX side is a record of the JAX package's chained drive
(`worker_overlap` + `pipelined_writeback` + `chained_frontend`, its KLT
on the TPU level tracker, XR_LK_BACKEND=mxu) over the rendered 320x240
wave scene (`tools.make_dataset.render_sequence`), 60 frames: at 40
frames both packages initialize near frame 37 and track 3 frames, too
few for an ATE. For every chained step it holds the step's inputs (the
device state, the staged slot update, the flow rotation, K), JAX's
initial flow and KLT outputs on them, the two RANSAC draws derived from
the step's key (as `tests/test_torch_modules.py::test_post_klt_gates_match`
derives them) with JAX's gates on its KLT outputs, and the step's own
outputs; for every chained frame finished on the host, the inputs and
outputs of its host half; and the drive's output poses.

- (a) the step, teacher-forced on every recorded step: the slot update
  and the initial flow within 1e-3 px; the gates from JAX's KLT outputs
  with its draws injected: bearings 1e-12, status and verdict equal; K1
  on JAX's inputs at `tests/test_torch_klt.py`'s limits (status equal
  on >= 99% of the slots, 1e-3 px on the slots both keep) and the whole
  `_chained_track_step` with the draws injected at K1's limits, on every
  10th step (on every step: `slow`);
- (b) the host half on the recorded inputs (`chained_keep`,
  `chained_injection`): accept, keep, the slot update and the staged
  first observations equal, floats 1e-12;
- (c) the port's free-running chained drive on the same scene: tracked
  within 2 of the JAX drive, ATE <= 0.25 m and <= 2x JAX's + 0.01 m (the
  packages' initializer draws differ), the chained route on every frame
  pair but at most 3;
- a flush drops what the route staged, and the next frame re-seeds;
- `slow`: both routes on the card's 752x480 benchmark scene in both
  packages, and the port's at six initializer seeds.

The record is committed (`tests/data/jax_chained_drive.npz`); `slow`
regenerates it and compares it with the committed file:

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \\
        python tests/test_torch_chained.py --write
"""

import os
import sys

import numpy as np
import pytest
import torch

from xrslam_tpu_torch.frontend import klt
from xrslam_tpu_torch.frontend import tracker as ttracker
from xrslam_tpu_torch.tools.make_dataset import ate, render_sequence, run_sequence

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
JAX_CHAINED = os.path.join(DATA, "jax_chained_drive.npz")
N_FRAMES = 60
CHAINED = dict(worker_overlap=True, pipelined_writeback=True, chained_frontend=True)
# tests/test_torch_klt.py's limits
STATUS_AGREE = 0.99
PX_TOL = 1e-3
FLOAT_TOL = 1e-12
C = 256
# the config's gate thresholds (rotation RANSAC, misalignment), degrees
ROT_DEG, MIS_DEG = 10.0, 0.1
# tier 1 runs K1 (the plain version, ~0.1 s a pair here alone, far more
# beside other test processes) on every KLT_STRIDE-th step
KLT_STRIDE = 10
STEP_KEYS = ("pts", "valid", "bear", "upd_keep", "upd_pts", "upd_mask", "upd_bear",
             "R_pred", "K", "Kinv", "pts_u", "valid_u", "pts_init", "klt_nxt",
             "klt_status", "idx_e", "idx_r", "gate_b", "gate_status", "gate_nt",
             "out_nxt", "out_status", "out_b", "out_nt", "pair")
HOST_KEYS = ("nxt", "status", "lengths", "live", "pend_mask", "pend_uv", "pend_b",
             "accept", "keep", "used_pts", "free", "cand", "cvalid", "R_last",
             "shape", "upts", "umask", "ubear", "new_mask", "new_uv", "new_b")


def _pending_arrays(news):
    mask = np.zeros((C,), bool)
    uv = np.zeros((C, 2))
    b = np.zeros((C, 3))
    for s, u, v in news:
        mask[s], uv[s], b[s] = True, u, v
    return mask, uv, b


def record_jax_drive(seq: dict) -> dict:
    """Drive the JAX package's chained route over `seq` and record
    (see the module docstring). Needs JAX on the CPU in float64 and
    XR_LK_BACKEND=mxu set before its KLT is traced."""
    import jax
    import jax.numpy as jnp

    from xrslam_tpu import api as japi
    from xrslam_tpu.config import Config as JConfig
    from xrslam_tpu.frontend import klt as jklt
    from xrslam_tpu.frontend import tracker as jtracker
    from xrslam_tpu.ransac import core as jcore
    from xrslam_tpu_torch import convert

    steps, hosts, pair = [], [], {}
    orig_step = jtracker._chained_track_step
    orig_frame = jtracker.KLTFeatureTracker._track_frame_chained
    orig_track = jtracker.KLTFeatureTracker._finish_track_chained
    orig_detect = jtracker.KLTFeatureTracker._finish_detect_chained
    t_cam = np.asarray(seq["t_cam"])

    def index(t):
        return int(np.argmin(np.abs(t_cam - t)))

    def track_frame_chained(self, tracker_map, frame, rider, between):
        pair["now"] = (index(self._prev.t), index(frame.t))
        return orig_frame(self, tracker_map, frame, rider, between)

    def step(key, prev_pyr, cur_pyr, pts, valid, bear, upd_keep, upd_pts, upd_mask,
             upd_bear, R_pred, K, Kinv, **kw):
        out = orig_step(key, prev_pyr, cur_pyr, pts, valid, bear, upd_keep, upd_pts,
                        upd_mask, upd_bear, R_pred, K, Kinv, **kw)
        # the step's pieces, as its body computes them
        HI = jax.lax.Precision.HIGHEST
        pts_u = jnp.where(upd_mask[:, None], upd_pts.astype(pts.dtype), pts)
        bear_u = jnp.where(upd_mask[:, None], upd_bear.astype(bear.dtype), bear)
        valid_u = (valid & upd_keep) | upd_mask
        H, W = cur_pyr[0].shape
        pred_b = jnp.einsum("ij,nj->ni", R_pred.astype(bear.dtype), bear_u, precision=HI)
        z = jnp.clip(pred_b[:, 2:3], 1e-6, None)
        uv = jnp.einsum("ij,nj->ni", K.astype(bear.dtype), pred_b / z,
                        precision=HI)[:, :2].astype(pts.dtype)
        inb = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
               & (pred_b[:, 2] > 0))
        pts_init = jnp.where((inb & valid_u)[:, None], uv, pts_u)
        nxt_k, st_k = jklt.track_keypoints(prev_pyr, cur_pyr, pts_u, pts_init, valid_u,
                                           win=kw["win"], iters=kw["iters"],
                                           eps=kw["eps"], border=kw["border"])
        bp = jnp.where(valid_u[:, None], bear_u, jnp.array([0.0, 0.0, 1.0], bear.dtype))
        gate_b, gate_st, gate_nt = jtracker._post_klt_gates(
            key, nxt_k, st_k, bp, Kinv, rot_thresh_deg=kw["rot_thresh_deg"],
            mis_thresh_deg=kw["mis_thresh_deg"])
        k1, k2 = jax.random.split(key)
        idx_e = jcore.sample_minimal(k1, 64, C, 5, st_k)
        idx_r = jcore.sample_minimal(k2, 128, C, 2, gate_st)
        vals = (pts, valid, bear, upd_keep, upd_pts, upd_mask, upd_bear, R_pred, K, Kinv,
                pts_u, valid_u, pts_init, nxt_k, st_k, idx_e, idx_r, gate_b, gate_st,
                gate_nt, *out)
        steps.append({k: np.asarray(v) for k, v in zip(STEP_KEYS, vals)}
                     | {"pair": np.asarray(pair["now"])})
        return out

    def finish_track(self, tracker_map, prev, frame, vals):
        status = np.asarray(vals["status"])
        lengths = np.zeros((C,), np.int64)
        live = np.zeros((C,), bool)
        for i in np.nonzero(status & (prev.track_ids >= 0))[0]:
            tr = tracker_map.get_track(prev, int(i))
            if tr is not None and not tr.trash:
                lengths[i], live[i] = len(tr.obs), True
        pend = _pending_arrays(self._pending_new)
        keep = orig_track(self, tracker_map, prev, frame, vals)
        accept = np.zeros((C,), bool)
        for i in np.nonzero(frame.track_ids >= 0)[0]:
            tr = tracker_map.get_track(frame, int(i))
            accept[i] = prev.id in tr.obs
        hosts.append({"nxt": np.asarray(vals["nxt"]), "status": status,
                      "lengths": lengths, "live": live, "pend_mask": pend[0],
                      "pend_uv": pend[1], "pend_b": pend[2], "accept": accept,
                      "keep": np.asarray(keep)})
        return keep

    def finish_detect(self, tracker_map, frame, vals, keep):
        used = np.nonzero(frame.track_ids >= 0)[0]
        free = np.zeros((C,), bool)
        free[frame.track_ids < 0] = True
        rec = hosts[-1]
        rec.update(used_pts=frame._pts[used].copy(), free=free,
                   cand=np.asarray(vals["cand"]), cvalid=np.asarray(vals["cvalid"]),
                   R_last=np.asarray(self._last_R), shape=np.asarray(self._prev._pyr[0].shape))
        orig_detect(self, tracker_map, frame, vals, keep)
        _, upts, umask, ubear = self._slot_upd
        new = _pending_arrays(self._pending_new)
        rec.update(upts=upts, umask=umask, ubear=ubear, new_mask=new[0], new_uv=new[1],
                   new_b=new[2])

    jtracker._chained_track_step = step
    jtracker.KLTFeatureTracker._track_frame_chained = track_frame_chained
    jtracker.KLTFeatureTracker._finish_track_chained = finish_track
    jtracker.KLTFeatureTracker._finish_detect_chained = finish_detect
    jax.clear_caches()
    try:
        cfg = JConfig(**{**convert.config_to_dict(seq["config"]), **CHAINED})
        ts, ps = run_sequence(japi, japi.XRSLAM(config=cfg), seq)
    finally:
        jtracker._chained_track_step = orig_step
        jtracker.KLTFeatureTracker._track_frame_chained = orig_frame
        jtracker.KLTFeatureTracker._finish_track_chained = orig_track
        jtracker.KLTFeatureTracker._finish_detect_chained = orig_detect
        jax.clear_caches()
    assert all("upts" in h for h in hosts), "a chained frame did not detect"
    # the used points of a finish vary in number: stored padded with
    # their count
    n_used = np.asarray([len(h["used_pts"]) for h in hosts])
    for h in hosts:
        pad = np.zeros((C, 2))
        pad[:len(h["used_pts"])] = h["used_pts"]
        h["used_pts"] = pad
    out = {f"step_{k}": np.stack([s[k] for s in steps]) for k in STEP_KEYS}
    out |= {f"host_{k}": np.stack([h[k] for h in hosts]) for k in HOST_KEYS}
    out |= {"host_n_used": n_used, "ts": np.asarray(ts), "ps": np.asarray(ps),
            "ate": np.asarray(ate(seq, ts, ps))}
    return out


def write_jax_file(path: str = JAX_CHAINED) -> None:
    os.environ["XR_LK_BACKEND"] = "mxu"
    try:
        rec = record_jax_drive(render_sequence(n_frames=N_FRAMES))
    finally:
        os.environ.pop("XR_LK_BACKEND")
    np.savez_compressed(path, **rec)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def record():
    with np.load(JAX_CHAINED) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def seq():
    return render_sequence(n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def pyramids(seq, record):
    """JAX-preprocessed pyramids of every frame a recorded step uses (the
    same pyramids the JAX tracker built)."""
    import jax.numpy as jnp

    from xrslam_tpu.frontend.tracker import _preprocess_image as jpreprocess

    cfg = seq["config"]
    args = (float(cfg.feature_tracker_clahe_clip_limit), int(cfg.feature_tracker_clahe_width),
            int(cfg.feature_tracker_clahe_height), 3)
    return {int(i): [torch.as_tensor(np.asarray(x)) for x in
                     jpreprocess(jnp.asarray(seq["images"][i]), *args)]
            for i in np.unique(record["step_pair"])}


def T(x):
    return torch.as_tensor(np.asarray(x))


def _klt_agree(what, nxt, status, ref_nxt, ref_status):
    nxt, status = np.asarray(nxt), np.asarray(status)
    agree = np.mean(status == ref_status)
    assert agree >= STATUS_AGREE, f"{what}: status agrees on {agree:.4f} of the slots"
    live = status & ref_status
    if live.any():
        err = np.abs(nxt[live] - ref_nxt[live]).max()
        assert err <= PX_TOL, f"{what}: max position error {err:.2e} px"


def test_record_covers_the_drive(record):
    n = len(record["step_pair"])
    assert n == N_FRAMES - 1, n      # frame 0 seeds, every later frame chains
    assert len(record["host_keep"]) >= n - 1
    assert record["step_valid_u"].sum(axis=1).min() >= 50
    # dead slots keep stale positions: the scattered-slot input K1 takes
    assert (~record["step_valid_u"]).any(axis=1).all()


def _steps(record):
    return {k: record[f"step_{k}"] for k in STEP_KEYS}


def test_step_matches_jax(record, pyramids):
    """(a), every step: the slot update, the initial flow and the gates;
    K1 and the whole step on every KLT_STRIDE-th (all of them: the
    `slow` test below)."""
    r = _steps(record)
    for j in range(len(r["pair"])):
        what = f"step {j} (frames {tuple(r['pair'][j])})"
        cur_pyr = pyramids[int(r["pair"][j][1])]
        pts, valid, bear = ttracker._apply_slot_update(
            T(r["pts"][j]), T(r["valid"][j]), T(r["bear"][j]), T(r["upd_keep"][j]),
            T(r["upd_pts"][j]), T(r["upd_mask"][j]), T(r["upd_bear"][j]))
        np.testing.assert_array_equal(valid.numpy(), r["valid_u"][j], err_msg=what)
        np.testing.assert_array_equal(pts.numpy(), r["pts_u"][j], err_msg=what)
        init = ttracker._rotation_predicted_flow(pts, valid, bear, T(r["R_pred"][j]),
                                                 T(r["K"][j]), cur_pyr[0].shape)
        np.testing.assert_allclose(init.numpy(), r["pts_init"][j], rtol=0, atol=PX_TOL,
                                   err_msg=what)
        bp = np.where(r["valid_u"][j][:, None], bear.numpy(), np.array([0.0, 0.0, 1.0]))
        b, gst, gnt = ttracker._post_klt_gates(
            None, T(r["klt_nxt"][j]), T(r["klt_status"][j]), T(bp), T(r["Kinv"][j]),
            ROT_DEG, MIS_DEG, idx_e=T(r["idx_e"][j]), idx_r=T(r["idx_r"][j]))
        np.testing.assert_allclose(b.numpy(), r["gate_b"][j], rtol=FLOAT_TOL,
                                   atol=FLOAT_TOL, err_msg=what)
        np.testing.assert_array_equal(gst.numpy(), r["gate_status"][j], err_msg=what)
        assert bool(gnt) == bool(r["gate_nt"][j]), what
        # JAX's gates on its KLT outputs are its step's
        np.testing.assert_array_equal(r["gate_status"][j], r["out_status"][j], err_msg=what)
    _check_klt_steps(r, pyramids, range(0, len(r["pair"]), KLT_STRIDE))


def _check_klt_steps(r, pyramids, steps):
    """K1 on JAX's inputs, and the whole chained step with JAX's draws
    injected, each at K1's limits against JAX's outputs."""
    for j in steps:
        what = f"step {j} (frames {tuple(r['pair'][j])})"
        prev_pyr, cur_pyr = (pyramids[int(i)] for i in r["pair"][j])
        nxt, st = klt.track_keypoints(prev_pyr, cur_pyr, T(r["pts_u"][j]),
                                      T(r["pts_init"][j]), T(r["valid_u"][j]))
        _klt_agree(what + " K1", nxt, st, r["klt_nxt"][j], r["klt_status"][j])
        out = ttracker._chained_track_step(
            None, prev_pyr, cur_pyr, T(r["pts"][j]), T(r["valid"][j]), T(r["bear"][j]),
            T(r["upd_keep"][j]), T(r["upd_pts"][j]), T(r["upd_mask"][j]),
            T(r["upd_bear"][j]), T(r["R_pred"][j]), T(r["K"][j]), T(r["Kinv"][j]),
            ROT_DEG, MIS_DEG, idx_e=T(r["idx_e"][j]), idx_r=T(r["idx_r"][j]))
        _klt_agree(what + " step", out[0], out[1], r["out_nxt"][j], r["out_status"][j])


@pytest.mark.slow
def test_klt_on_every_step(record, pyramids):
    """(a)'s K1 and whole-step checks on every recorded step."""
    r = _steps(record)
    _check_klt_steps(r, pyramids, range(len(r["pair"])))


def test_host_half_matches_jax(record, seq):
    """(b)"""
    h = {k: record[f"host_{k}"] for k in HOST_KEYS + ("n_used",)}
    cfg = seq["config"]
    dist = cfg.feature_tracker_min_keypoint_distance
    for j in range(len(h["keep"])):
        what = f"finish {j}"
        pending = np.nonzero(h["pend_mask"][j])[0]
        accept, keep, placed = ttracker.chained_keep(
            h["nxt"][j], h["status"][j], h["lengths"][j], h["live"][j], pending, dist)
        np.testing.assert_array_equal(accept, h["accept"][j], err_msg=what)
        np.testing.assert_array_equal(keep, h["keep"][j], err_msg=what)
        assert placed == [s for s in pending if not h["accept"][j][s]], what
        upts, umask, ubear, news = ttracker.chained_injection(
            h["used_pts"][j][:h["n_used"][j]], np.nonzero(h["free"][j])[0], h["cand"][j],
            h["cvalid"][j], record["step_K"][0], h["R_last"][j],
            tuple(h["shape"][j]), cfg.feature_tracker_max_keypoint_detection, dist, C)
        np.testing.assert_array_equal(umask, h["umask"][j], err_msg=what)
        np.testing.assert_allclose(upts, h["upts"][j], rtol=0, atol=FLOAT_TOL, err_msg=what)
        np.testing.assert_allclose(ubear, h["ubear"][j], rtol=0, atol=FLOAT_TOL,
                                   err_msg=what)
        mask, uv, b = _pending_arrays(news)
        np.testing.assert_array_equal(mask, h["new_mask"][j], err_msg=what)
        np.testing.assert_allclose(uv, h["new_uv"][j], rtol=0, atol=FLOAT_TOL, err_msg=what)
        np.testing.assert_allclose(b, h["new_b"][j], rtol=0, atol=FLOAT_TOL, err_msg=what)
        assert [s for s, _, _ in news] == sorted(s for s, _, _ in news), what


def test_chained_drive_matches_jax(record, seq):
    """(c)"""
    from xrslam_tpu_torch import api

    slam = api.XRSLAM(config=seq["config"].replace(**CHAINED), device="cpu")
    ts, ps = run_sequence(api, slam, seq)
    tracker = slam.pipeline.tracker
    n_jax, ate_jax = len(record["ts"]), float(record["ate"])
    assert abs(len(ts) - n_jax) <= 2, (len(ts), n_jax)
    err = ate(seq, ts, ps)
    assert err <= 0.25 and err <= 2 * ate_jax + 0.01, (err, ate_jax)
    assert tracker.stats["chained_frames"] >= N_FRAMES - 1 - 3, tracker.stats
    assert tracker.stats["chained_frames"] + tracker.stats["standard_frames"] == N_FRAMES
    assert tracker._pending is None and tracker._dev is None   # flushed


def test_flush_drops_the_staged_update(seq):
    """A flush (as a checkpoint save makes) lands the frame in flight and
    drops the staged slot update and first observations; the next frame
    takes the standard route and re-seeds, the one after chains again."""
    from xrslam_tpu_torch import api

    slam = api.XRSLAM(config=seq["config"].replace(**CHAINED), device="cpu")
    run_sequence(api, slam, seq, stop=4)
    tracker = slam.pipeline.tracker
    assert tracker._slot_upd is None and tracker._pending_new == [] and tracker._dev is None
    assert tracker.stats == {"chained_frames": 3, "standard_frames": 1, "reseeds": 1}
    run_sequence(api, slam, seq, start=4, stop=7)
    assert tracker.stats == {"chained_frames": 5, "standard_frames": 2, "reseeds": 2}


def _jax_drive(seq: dict, flags: dict) -> tuple:
    """The JAX package's drive of `seq` under `flags`, its KLT on the TPU
    level tracker (XR_LK_BACKEND=mxu, which K1 implements): (tracked,
    ATE)."""
    from xrslam_tpu import api as japi
    from xrslam_tpu.config import Config as JConfig
    from xrslam_tpu_torch import convert

    os.environ["XR_LK_BACKEND"] = "mxu"
    try:
        slam = japi.XRSLAM(config=JConfig(**{**convert.config_to_dict(seq["config"]),
                                             **flags}))
        ts, ps = run_sequence(japi, slam, seq)
    finally:
        os.environ.pop("XR_LK_BACKEND")
    return len(ts), ate(seq, ts, ps)


@pytest.mark.slow
def test_chained_route_ate_on_the_bench_scene(capsys):
    """The chained route's ATE on the card's benchmark scene
    (`chip_smoke.py` phases 12-12c: 752x480, focal 458, 75 frames), in
    float64 in both packages beside their pipelined route: the port's
    drive of each route tracked within 2 of the JAX package's, ATE <=
    0.25 m and <= 2x JAX's + 0.01 m, as (c) holds it. Then the port's two
    routes at Config.random 648-653 (the initializer's draws), each ATE
    <= 0.25 m; the table is printed: the chained route's ATE spreads with
    the draws."""
    from xrslam_tpu_torch import api

    seq = render_sequence(n_frames=75, width=752, height=480, focal=458.0)
    routes = {"chained": CHAINED,
              "pipelined": dict(worker_overlap=True, pipelined_writeback=True)}
    rows = []
    for name, flags in routes.items():
        n_jax, ate_jax = _jax_drive(seq, flags)
        rows.append(("jax", name, 648, n_jax, ate_jax))
        for seed in range(648, 654):
            cfg = seq["config"].replace(random=seed, **flags)
            slam = api.XRSLAM(config=cfg, device="cpu")
            ts, ps = run_sequence(api, slam, seq)
            err = ate(seq, ts, ps)
            rows.append(("port", name, seed, len(ts), err))
            assert err <= 0.25, rows[-1]
            if seed == 648:
                assert abs(len(ts) - n_jax) <= 2 and err <= 2 * ate_jax + 0.01, rows
    with capsys.disabled():
        for row in rows:
            print("chained route ATE, 752x480 75 frames, f64: %s %s random=%d: %d/75 "
                  "tracked, ATE %.6f m" % row)


@pytest.mark.slow
def test_committed_jax_file_matches_fresh_jax_run(tmp_path):
    path = str(tmp_path / "chained.npz")
    write_jax_file(path)
    with np.load(path) as fresh, np.load(JAX_CHAINED) as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_allclose(fresh[k].astype(float), committed[k].astype(float),
                                       rtol=0, atol=1e-12, err_msg=k)


if __name__ == "__main__" and "--write" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_jax_file()
    print("wrote", JAX_CHAINED)
