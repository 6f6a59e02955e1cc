"""Depth-camera input of the port held to the JAX package, on the CPU in
float64. The JAX package runs with `worker_overlap=False` and
`pipelined_writeback=False` (with the pipelined write-back it reads
poses one solve stale on this path, ROADMAP queue 3):

- `window_builder.triangulate_track`'s depth seed: one observation with
  a measured z gives the point through the frame's camera pose, 1e-12;
- the initializer's metric rescale of the two-view SfM on the same
  8-keyframe input, both packages given the exact homography and
  essential matrix in place of their RANSAC draws: the rescaled
  two-view poses and points within 1e-9, the whole init_sfm within
  1e-6; the scale is the true baseline with depths, unit without;
- the tracker's depth sampling at the final keypoints (nearest pixel,
  out of bounds -> 0, the image released), exactly;
- one depth-path keyframe step (localize_newframe, manage_keyframe,
  track_landmark, refine_window, slide_window) from one window state of
  a bearing-fed drive with measured keypoint depths, a seeded 30% of the
  new keyframe's tracks untriangulated first so that some are seeded
  from depth: every window frame's state and every landmark within
  1e-8, the same tags;
- the API's DEPTH_CAMERA input: uint16 mm -> float32 m, and the pairing
  with camera frames (within 0.02 s, stale dropped, leading held), the
  same as the JAX package's;
- `clone_shallow` copies `kp_depth`;
- `slow`: the 60-frame rendered depth dataset through both
  `run_sequence`s: tracked within 3 of each other, both ATE <= 0.25 m
  and no collapsed scale.
"""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu import api as japi
from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core import initializer as jinit
from xrslam_tpu.core import map as jmap
from xrslam_tpu.core import sliding_window as jsw
from xrslam_tpu.core import window_builder as jwb
from xrslam_tpu.estimation.window import MargPrior as JMargPrior
from xrslam_tpu.frontend import tracker as jtracker
from xrslam_tpu_torch import api, convert
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.core import initializer as tinit
from xrslam_tpu_torch.core import map as tmap
from xrslam_tpu_torch.core import nputil
from xrslam_tpu_torch.core import sliding_window as tsw
from xrslam_tpu_torch.core import window_builder as twb
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.frontend import tracker as ttracker
from xrslam_tpu_torch.io import synthetic
from xrslam_tpu_torch.tools.make_dataset import camera_extrinsics

K260 = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(M, fid, q, p, C=4, kp_depth=None, q_bc=(1.0, 0, 0, 0), p_bc=(0, 0, 0)):
    return M.FrameRec(
        id=fid, t=0.05 * fid, q=np.asarray(q, float), p=np.asarray(p, float),
        v=np.zeros(3), bg=np.zeros(3), ba=np.zeros(3),
        q_bc=np.asarray(q_bc, float), p_bc=np.asarray(p_bc, float),
        q_bi=np.array([1.0, 0, 0, 0]), p_bi=np.zeros(3), K=K260.copy(),
        sqrt_inv_cov2=np.eye(2), bearings=np.zeros((C, 3)),
        track_ids=np.full((C,), -1, np.int64), kp_depth=kp_depth)


def test_triangulate_track_depth_seed_matches_jax():
    rng = np.random.default_rng(0)
    q_bc = nputil.quat_normalize(rng.normal(size=4))
    p_bc = rng.normal(size=3) * 0.05
    out = {}
    for name, M, wb in (("jax", jmap, jwb), ("port", tmap, twb)):
        r = np.random.default_rng(1)
        frames = {}
        tr = M.TrackRec(id=1)
        for fid in range(3):
            q, p = nputil.quat_normalize(r.normal(size=4)), r.normal(size=3)
            Xc = np.array([0.3, -0.2, 2.5]) + r.normal(size=3) * 0.1
            # frame 0 has no depth, frame 1 a zero depth, frame 2 the seed
            kd = None if fid == 0 else np.array([0.0, 0.0 if fid == 1 else Xc[2], 0, 0])
            f = _frame(M, fid, q, p, kp_depth=kd, q_bc=q_bc, p_bc=p_bc)
            f.bearings[1] = Xc / np.linalg.norm(Xc)
            tr.obs[fid] = 1
            frames[fid] = f
        out[name] = (wb.triangulate_track(tr, frames), frames[2], Xc)
    p_j, (p_t, seeded) = out["jax"][0], out["port"][0]
    assert seeded
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-12)
    f2, Xc = out["port"][1], out["port"][2]
    q_wc, p_wc = f2.camera_pose()
    np.testing.assert_allclose(p_t, nputil.quat_rotate(q_wc, Xc) + p_wc, atol=1e-12)
    # one observation suffices; without a depth the DLT refuses it
    single = tmap.TrackRec(id=2, obs={2: 1})
    assert twb.triangulate_track(single, {2: f2})[1]
    f2.kp_depth = None
    assert twb.triangulate_track(single, {2: f2}) == (None, False)


def _init_map(M, with_depth: bool, n_frames=8, n_lm=60, seed=5):
    """8 keyframes moving along x, `n_lm` landmarks seen in all of them,
    exact bearings; frame 0 carries the measured depths."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0], (n_lm, 3))
    pmap = M.PipelineMap()
    C = n_lm + 4
    for i in range(n_frames):
        p_i = np.array([0.08 * i, 0.01 * i, 0.0])
        q_i = nputil.expmap(np.array([0.0, 0.01 * i, 0.0]))
        f = _frame(M, 1000 + i, [1.0, 0, 0, 0], [0, 0, 0], C=C)
        R_cw = nputil.quat_to_matrix(q_i).T
        Xc = (R_cw @ (X - p_i).T).T
        f.bearings[:n_lm] = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
        f.bearings[n_lm:, 2] = 1.0
        if i == 0 and with_depth:
            f.kp_depth = np.concatenate([Xc[:, 2], np.zeros(4)])
        f._truth = (q_i, p_i)
        pmap.frames.append(f)
    for k in range(n_lm):
        tr = pmap.get_track(pmap.frames[0], k, create=True)
        for f in pmap.frames[1:]:
            pmap.add_observation(tr, f, k)
    return pmap, X


def _exact_two_view(pmap):
    """The true homography (of the plane z = 4.5 in frame 0) and
    essential matrix from the first to the last keyframe."""
    q7, p7 = pmap.frames[-1]._truth
    R = nputil.quat_to_matrix(q7).T
    t = -R @ p7
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return R + np.outer(t, [0.0, 0.0, 1.0]) / 4.5, tx @ R


@pytest.mark.parametrize("with_depth", [True, False])
def test_initializer_depth_rescale_matches_jax(with_depth, monkeypatch):
    """Both packages' init_sfm on the same 8 keyframes, each given the
    exact homography and essential matrix in place of its RANSAC draws
    (the hypotheses then agree): the two-view result after the rescale
    (the state when the first middle frame is localized) within 1e-9,
    the whole init_sfm within 1e-6."""
    from xrslam_tpu.ransac import stereo as jstereo
    from xrslam_tpu_torch.ransac import stereo as tstereo

    res = {}
    for name, M, I in (("jax", jmap, jinit), ("port", tmap, tinit)):
        pmap, _ = _init_map(M, with_depth)
        H, E = _exact_two_view(pmap)
        if name == "jax":
            init = I.Initializer(JConfig())
            arr, stereo = jnp.asarray, jstereo
        else:
            init = I.Initializer(Config(), "cpu")
            arr, stereo = convert.to_torch, tstereo
        monkeypatch.setattr(stereo, "find_homography_matrix",
                            lambda *a, _m=arr(H), **k: (_m, None, None))
        monkeypatch.setattr(stereo, "find_essential_matrix",
                            lambda *a, _m=arr(E), **k: (_m, None, None))
        seed = []
        pnp = I.Initializer._solve_pnp_prior

        def first_pnp(self, frame, anchor_frame, _pnp=pnp, _seed=seed):
            if not _seed:
                # points by their slot in frame 0 (track ids come from a
                # process-wide counter)
                f0 = self.map.frames[0].id
                _seed.append(copy.deepcopy((self.map.frames[-1].q, self.map.frames[-1].p,
                                            {t.obs[f0]: t.p_w for t in self.map.tracks.values()
                                             if f0 in t.obs})))
            _pnp(self, frame, anchor_frame)

        monkeypatch.setattr(I.Initializer, "_solve_pnp_prior", first_pnp)
        init.map = pmap
        assert init.init_sfm(), name
        res[name] = (init, pmap, seed[0])
    ti, tm_, (tq, tp, tpts) = res["port"]
    _, jm_, (jq, jp, jpts) = res["jax"]
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
    assert tpts.keys() == jpts.keys() and len(tpts) == 60
    for k in tpts:
        assert (tpts[k] is None) == (jpts[k] is None)
        if tpts[k] is not None:
            np.testing.assert_allclose(tpts[k], jpts[k], rtol=0, atol=1e-9)
    for fj, ft in zip(jm_.frames, tm_.frames):
        np.testing.assert_allclose(ft.p, fj.p, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ft.q, fj.q, rtol=0, atol=1e-6)
    # metric with depths (frame 0 is the truth's origin), unit baseline
    # without
    true_base = np.linalg.norm(tm_.frames[-1]._truth[1])
    if with_depth:
        assert ti.depth_ratios == 60
        np.testing.assert_allclose(ti.depth_scale, true_base, rtol=1e-9)
        np.testing.assert_allclose(np.linalg.norm(tp), true_base, rtol=1e-9)
    else:
        assert ti.depth_scale is None
        np.testing.assert_allclose(np.linalg.norm(tp), 1.0, rtol=1e-9)


def test_tracker_depth_sampling_matches_jax():
    C = 8
    dimg = np.random.default_rng(3).uniform(0.5, 4.0, (24, 32)).astype(np.float32)
    pts = np.array([[0.0, 0.0], [31.4, 23.4], [10.5, 3.5], [11.5, 4.5],
                    [-0.6, 5.0], [32.0, 1.0], [5.0, 23.6], [7.2, 9.9]])
    kd = {}
    for name, M, mod in (("jax", jmap, jtracker), ("port", tmap, ttracker)):
        f = _frame(M, 1, [1.0, 0, 0, 0], [0, 0, 0], C=C)
        f.track_ids[:7] = np.arange(7)  # slot 7 holds no keypoint
        f._pts = pts.copy()
        f._depth_img = dimg
        f._image = np.zeros((24, 32), np.float32)
        me = types.SimpleNamespace(capacity=C)
        if name == "jax":
            mod.KLTFeatureTracker._finalize_frame(me, M.PipelineMap(), f, f._image)
        else:
            mod.KLTFeatureTracker._finalize_frame(me, M.PipelineMap(), f)
        assert f._depth_img is None and f._image is None
        kd[name] = f.kp_depth
    np.testing.assert_array_equal(kd["port"], kd["jax"])
    # nearest pixel; outside the image (u = -1 after rounding, u = 32,
    # v = 24) and the empty slot give 0
    expect = [dimg[0, 0], dimg[23, 31], dimg[4, 10], dimg[4, 12], 0, 0, 0, 0]
    np.testing.assert_array_equal(kd["port"], np.asarray(expect, np.float64))


class _DepthTracker(SyntheticTracker):
    """SyntheticTracker that also gives each keypoint its true camera
    z-depth (the frame's hint indexes the landmark)."""

    def __init__(self, depth_by_t, **kw):
        super().__init__(**kw)
        self.depth_by_t = depth_by_t

    def track_frame(self, tracker_map, frame, **kw):
        super().track_frame(tracker_map, frame, **kw)
        hint = frame._hint
        z = self.depth_by_t[round(frame.t, 6)]
        frame.kp_depth = np.where(hint >= 0, z[np.maximum(hint, 0)], 0.0)


def _bearing_drive_until_depth_keyframe():
    """Drive the wave scene (bearings, 96 landmarks, measured depths)
    through the port until the first keyframe of the depth path; return
    a deep copy of the tracker's state just before that track()."""
    n_frames = 40
    q_bc, p_bc = camera_extrinsics()
    cfg = Config(
        camera_intrinsic=np.array([[450.0, 0, 376.0], [0, 450.0, 240.0], [0, 0, 1]]),
        camera_to_body_rotation=q_bc, camera_to_body_translation=p_bc,
        initializer_keyframe_gap=2, initializer_min_matches=30,
        initializer_min_triangulation=30, initializer_min_landmarks=20,
        window_landmark_slots=96, init_landmark_slots=96,
        sliding_window_force_keyframe_landmarks=20)
    scene = synthetic.wave_scene(n_frames=n_frames, n_landmarks=96, seed=0)
    b, mask = synthetic.bearings_of(scene, convert.to_torch(q_bc), convert.to_torch(p_bc))
    b, mask = b.numpy(), mask.numpy()
    lms = scene.landmarks.numpy()
    depth_by_t = {}
    for k in range(n_frames):
        q_wc = nputil.quat_mul(scene.q[k].numpy(), q_bc)
        p_wc = scene.p[k].numpy() + nputil.quat_rotate(scene.q[k].numpy(), p_bc)
        R_cw = nputil.quat_to_matrix(q_wc).T
        depth_by_t[round(float(scene.t[k]), 6)] = (R_cw @ (lms - p_wc).T).T[:, 2]
    pipe = VIOPipeline(cfg, _DepthTracker(depth_by_t, device="cpu"), device="cpu")
    snaps = []
    track = tsw.SlidingWindowTracker.track

    def snapshotting(self):
        if not snaps and self._keyframe_decision() != "subframe" and \
                any(f.kp_depth is not None for f in self.map.all_frames()):
            snaps.append(copy.deepcopy({"map": self.map, "marg": self.marg,
                                        "pred": self._pred_frame.id}))
        return track(self)

    ts = scene.t.numpy()
    imu_t, imu_w, imu_a = (x.numpy() for x in (scene.imu_t, scene.imu_w, scene.imu_a))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsw.SlidingWindowTracker, "track", snapshotting)
        for k in range(n_frames):
            if k > 0:
                for s in range(imu_t.shape[1]):
                    pipe.track_gyroscope(float(imu_t[k - 1, s]), imu_w[k - 1, s])
                    pipe.track_accelerometer(float(imu_t[k - 1, s]), imu_a[k - 1, s])
            pipe.track_gyroscope(float(ts[k]) + 1e-6, imu_w[min(k, n_frames - 2), 0])
            pipe.track_accelerometer(float(ts[k]) + 1e-6, imu_a[min(k, n_frames - 2), 0])
            C = 96
            kp = np.zeros((C, 3))
            kp[:, 2] = 1.0
            hint = np.full((C,), -1, np.int64)
            for slot, lm in enumerate(np.nonzero(mask[k])[0][:C]):
                kp[slot] = b[k, lm]
                hint[slot] = lm
            pipe.track_camera(float(ts[k]), kp, hint)
            if snaps:
                break
    assert snaps, "the drive reached no keyframe of the depth path"
    return cfg, snaps[0]


def _as_jax_map(pmap):
    pmap = copy.deepcopy(pmap)
    pmap.__class__ = jmap.PipelineMap
    for tr in pmap.tracks.values():
        tr.__class__ = jmap.TrackRec
    stack = list(pmap.frames)
    while stack:
        f = stack.pop()
        f.__class__ = jmap.FrameRec
        stack.extend(f.subframes)
    return pmap


def _states(pmap):
    frames = []
    for f in pmap.frames:
        frames += [f] + list(f.subframes)
    return ({f.id: np.concatenate([f.q, f.p, f.v, f.bg, f.ba]) for f in frames},
            {tid: tr.p_w for tid, tr in pmap.tracks.items() if tr.p_w is not None},
            {tid: (tr.valid, tr.triangulated, tr.static) for tid, tr in pmap.tracks.items()})


def test_depth_keyframe_step_matches_jax():
    cfg, snap = _bearing_drive_until_depth_keyframe()
    # every track of the new keyframe is triangulated by now: untriangulate
    # a seeded 30% of them so that track_landmark seeds them from depth
    new = snap["map"].frames[-1]
    rng = np.random.default_rng(0)
    for tid in sorted(int(t) for t in new.track_ids[new.track_ids >= 0]):
        tr = snap["map"].tracks.get(tid)
        if tr is not None and rng.random() < 0.3:
            tr.triangulated = tr.valid = False
            tr.p_w = None
    # port
    t_map = copy.deepcopy(snap["map"])
    ts = tsw.SlidingWindowTracker(t_map, cfg, "cpu")
    ts.marg = copy.deepcopy(snap["marg"])
    ts._pred_frame = next(f for f in t_map.frames if f.id == snap["pred"])
    assert ts.track()
    ts.materialize_pending()
    assert ts.stats["depth_keyframes"] == 1 and ts.stats["depth_seeded"] > 0
    # JAX, from the same state
    j_map = _as_jax_map(snap["map"])
    jcfg = JConfig(**convert.config_to_dict(cfg)).replace(
        worker_overlap=False, pipelined_writeback=False)
    js = jsw.SlidingWindowTracker(j_map, jcfg)
    if snap["marg"] is not None:
        js.marg = JMargPrior(*(jnp.asarray(x) for x in convert.to_numpy(snap["marg"])))
    js._pred_frame = next(f for f in j_map.frames if f.id == snap["pred"])
    assert js.track()
    js.materialize_pending()
    (fs_t, lm_t, tags_t), (fs_j, lm_j, tags_j) = _states(t_map), _states(j_map)
    assert fs_t.keys() == fs_j.keys() and lm_t.keys() == lm_j.keys()
    assert tags_t == tags_j
    for fid in fs_t:
        np.testing.assert_allclose(fs_t[fid], fs_j[fid], rtol=0, atol=1e-8)
    for tid in lm_t:
        np.testing.assert_allclose(lm_t[tid], lm_j[tid], rtol=0, atol=1e-8)


def test_api_depth_input_and_pairing_match_jax(monkeypatch):
    """The same stream of depth and camera samples: each package's
    run_one_frame hands the pipeline the same depth for each frame."""
    d16 = np.full((6, 8), 25, np.uint16)
    stream = [("depth", 0.10), ("cam", 0.10),            # paired
              ("depth", 0.14), ("cam", 0.20),            # stale: dropped
              ("depth", 0.30), ("cam", 0.25),            # leads: held
              ("cam", 0.305),                            # ... paired here
              ("cam", 0.35)]                             # no depth
    got = {}
    for name, A, kw in (("jax", japi, {}), ("port", api, {"device": "cpu"})):
        slam = A.XRSLAM(config=(JConfig if name == "jax" else Config)(), **kw)
        seen = []
        monkeypatch.setattr(slam.pipeline, "track_camera_image",
                            lambda t, img, depth=None: seen.append((t, depth)))
        monkeypatch.setattr(slam.pipeline, "predict_pose", lambda t: None)
        for kind, t in stream:
            if kind == "depth":
                slam.push_sensor_data(A.SensorType.DEPTH_CAMERA, t, d16 * int(t * 100))
            else:
                slam.push_sensor_data(A.SensorType.CAMERA, t, np.zeros((6, 8), np.float32))
                slam.run_one_frame()
        got[name] = seen
    assert [t for t, _ in got["port"]] == [t for t, _ in got["jax"]]
    for (_, dt), (_, dj) in zip(got["port"], got["jax"]):
        assert (dt is None) == (dj is None)
        if dt is not None:
            assert dt.dtype == dj.dtype == np.float32
            np.testing.assert_array_equal(dt, dj)
    paired = [d is not None for _, d in got["port"]]
    assert paired == [True, False, False, True, False]
    assert float(got["port"][0][1][0, 0]) == pytest.approx(0.25)  # 250 mm
    # float metres pass through unchanged
    slam = api.XRSLAM(config=Config(), device="cpu")
    slam.push_sensor_data(api.SensorType.DEPTH_CAMERA, 0.5, np.full((2, 2), 1.25, np.float32))
    assert slam._cur_depth[1].dtype == np.float32 and slam._cur_depth[1][0, 0] == 1.25


def test_clone_copies_kp_depth():
    kd = np.array([1.0, 0.0, 2.0, 0.0])
    f = _frame(tmap, 0, [1, 0, 0, 0], [0, 0, 0], kp_depth=kd)
    g = f.clone_shallow()
    assert g.kp_depth is not None and g.kp_depth is not f.kp_depth
    np.testing.assert_array_equal(g.kp_depth, kd)


@pytest.mark.slow
def test_depth_dataset_pair_drive(tmp_path):
    from xrslam_tpu.config import load_config as jload
    from xrslam_tpu.tools.run_dataset import run_sequence as jrun
    from xrslam_tpu_torch.config import load_config
    from xrslam_tpu_torch.eval import trajectory as traj
    from xrslam_tpu_torch.io.dataset import load_euroc_groundtruth
    from xrslam_tpu_torch.tools.make_dataset import render_dataset
    from xrslam_tpu_torch.tools.run_dataset import run_sequence

    paths = render_dataset(str(tmp_path), n_frames=60, n_landmarks=500, width=320,
                           height=240, focal=260.0, with_depth=True)
    uri = "euroc://" + paths["root"]
    jcfg = jload(paths["slam_yaml"], paths["device_yaml"]).replace(
        worker_overlap=False, pipelined_writeback=False)
    out = {"jax": jrun(uri, jcfg, async_reader=False),
           "port": run_sequence(uri, load_config(paths["slam_yaml"], paths["device_yaml"]),
                                async_reader=False, device="cpu")}
    gt_t, gt_p, _ = load_euroc_groundtruth(paths["root"])
    for name, (ts, _, ps, *_) in out.items():
        assert len(ts) >= 20, (name, len(ts))
        ia, ib = traj.associate(ts, gt_t)
        assert traj.ate_rmse(ps[ia], gt_p[ib]) <= 0.25, name
        assert np.ptp(ps[ia], axis=0).max() > 0.5 * np.ptp(gt_p[ib], axis=0).max(), name
    assert abs(len(out["port"][0]) - len(out["jax"][0])) <= 3
