"""The port's public API surface beyond poses, AR anchoring, inspection
and logging, held to the JAX package on the CPU:

- the engine's lifecycle and the module-level singleton (`create` /
  `push_sensor_data` / `run_one_frame` / `get_result` / `destroy`), on
  the card by default (which raises here) or on the CPU when asked;
- LANDMARKS, FEATURES (pixel keypoints from the tracker frame's `_pts`,
  bearings through K on the bearing-fed path), INTRINSICS, VERSION and
  BIAS of both packages' engines on the same window and tracker maps,
  exactly; and a short image drive of the port: non-empty landmarks and
  features once tracking;
- AR anchoring as in tests/test_api_extras.py: the object's pose equal
  to the JAX package's to 1e-12, column 0 = -up, -1 with too few
  landmarks, and mapped to the global frame and `isolated` once a
  localizer has registered;
- the inspection slots (CURRENT_BG / CURRENT_BA from BIAS, the
  tracker's painter tap, FEATURE_TRACKER_FPS from run_dataset) and the
  logging message queue.
"""

import logging
import types

import numpy as np
import pytest
import torch

import xrslam_tpu
from xrslam_tpu import api as japi
from xrslam_tpu.ar import VirtualObjectManager as JManager
from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core import map as jmap
from xrslam_tpu.localizer import SE3 as JSE3
from xrslam_tpu.localizer import LocalizerBase as JLocalizerBase
from xrslam_tpu_torch import api
from xrslam_tpu_torch.ar import VirtualObjectManager
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.core import map as tmap
from xrslam_tpu_torch.core import nputil
from xrslam_tpu_torch.localizer import SE3, LocalizerBase
from xrslam_tpu_torch.utils import inspection
from xrslam_tpu_torch.utils import logging as xlog


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lifecycle_and_singleton():
    with pytest.raises(RuntimeError, match="call create"):
        api.get_result(api.ResultType.STATE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.create(config=Config())
        assert api._instance is None
    slam = api.create(config=Config(), device="cpu")
    assert api._instance is slam
    assert api.get_result(api.ResultType.STATE) == api.State.INITIALIZING
    assert api.get_result(api.ResultType.BODY_POSE).timestamp == 0.0
    assert set(api.get_result(api.ResultType.INTRINSICS)) == {"fx", "fy", "cx", "cy"}
    assert api.get_result(api.ResultType.VERSION) == xrslam_tpu.__version__
    assert api.get_result(api.ResultType.LANDMARKS).shape == (0, 3)
    assert api.get_result(api.ResultType.FEATURES).shape == (0, 2)
    bias = api.get_result(api.ResultType.BIAS)
    assert np.allclose(bias.acc_bias, 0) and np.allclose(bias.gyr_bias, 0)
    for i in range(10):
        api.push_sensor_data(api.SensorType.GYROSCOPE, 0.005 * i, np.zeros(3))
        api.push_sensor_data(api.SensorType.ACCELERATION, 0.005 * i,
                             np.array([0.0, 0.0, 9.80665]))
    with pytest.raises(ValueError):
        api.push_sensor_data(api.SensorType.GRAVITY, 0.0, np.zeros(3))
    with pytest.raises(ValueError):
        api.get_result(api.ResultType.DEBUG_LOGS)
    with pytest.raises(RuntimeError, match="CAMERA"):
        api.run_one_frame()
    api.push_sensor_data(api.SensorType.CAMERA, 0.05, np.zeros((48, 64), np.float32))
    api.run_one_frame()
    api.destroy()
    assert api._instance is None and slam.pipeline is None
    with pytest.raises(RuntimeError, match="call create"):
        api.run_one_frame()
    api.destroy()  # idempotent


def _frame(M, fid, C=12, K=np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])):
    return M.FrameRec(
        id=fid, t=0.1 * fid, q=np.array([1.0, 0, 0, 0]), p=np.zeros(3),
        v=np.zeros(3), bg=np.full(3, 0.01 * fid), ba=np.full(3, -0.02 * fid),
        q_bc=np.array([1.0, 0, 0, 0]), p_bc=np.zeros(3),
        q_bi=np.array([1.0, 0, 0, 0]), p_bi=np.zeros(3), K=K,
        sqrt_inv_cov2=np.eye(2), bearings=np.zeros((C, 3)),
        track_ids=np.full((C,), -1, np.int64))


def _maps(M, with_pts: bool):
    """A window map with triangulated, untriangulated and point-less
    tracks, and a tracker map whose newest frame has 7 keypoints."""
    rng = np.random.default_rng(0)
    window = M.PipelineMap()
    f = _frame(M, 1)
    window.attach_frame(f)
    for k in range(9):
        tr = window.get_track(f, k, create=True)
        tr.triangulated = k % 3 != 0
        tr.p_w = rng.normal(size=3) if k != 4 else None
    tracker = M.PipelineMap()
    g = _frame(M, 2)
    tracker.attach_frame(g)
    b = rng.normal(size=(12, 3)) + [0, 0, 4.0]
    g.bearings[:] = b / np.linalg.norm(b, axis=1, keepdims=True)
    for k in (0, 1, 2, 4, 6, 9, 11):
        tracker.get_track(g, k, create=True)
    if with_pts:
        g._pts = rng.uniform(0, 300, (12, 2))
    return window, tracker


@pytest.mark.parametrize("with_pts", [True, False])
def test_results_match_jax(with_pts):
    kw = dict(camera_intrinsic=np.array([[300.0, 0, 150], [0, 310.0, 110], [0, 0, 1]]))
    out = {}
    for name, A, M, cfg, dev in (("jax", japi, jmap, JConfig(**kw), {}),
                                 ("port", api, tmap, Config(**kw), {"device": "cpu"})):
        slam = A.XRSLAM(config=cfg, **dev)
        window, tracker = _maps(M, with_pts)
        f = window.frames[-1]
        slam.pipeline.swt = types.SimpleNamespace(
            map=window, get_latest_state=lambda f=f: (f.t, f.q, f.p, f.v, f.bg, f.ba))
        slam.pipeline.tracker_map = tracker
        out[name] = [slam.get_result(A.ResultType[r]) for r in
                     ("LANDMARKS", "FEATURES", "INTRINSICS", "VERSION", "BIAS")]
    (lj, fj, ij, vj, bj), (lt, ft, it, vt, bt) = out["jax"], out["port"]
    assert lt.shape == (5, 3) and ft.shape == (7, 2)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ft, fj)
    assert it == ij and vt == vj
    np.testing.assert_array_equal(bt.acc_bias, bj.acc_bias)
    np.testing.assert_array_equal(bt.gyr_bias, bj.gyr_bias)
    # BIAS publishes the inspection slots
    np.testing.assert_array_equal(inspection.inspect_get(inspection.CURRENT_BG), bt.gyr_bias)
    np.testing.assert_array_equal(inspection.inspect_get(inspection.CURRENT_BA), bt.acc_bias)


def test_short_image_drive_results():
    from xrslam_tpu_torch.tools.make_dataset import render_sequence, run_sequence

    seq = render_sequence(n_frames=34)
    slam = api.XRSLAM(config=seq["config"], device="cpu")
    seen = []

    def on_frame(i, s):
        if s.get_result(api.ResultType.STATE) == api.State.TRACKING_SUCCESS:
            seen.append((s.get_result(api.ResultType.LANDMARKS),
                         s.get_result(api.ResultType.FEATURES)))

    run_sequence(api, slam, seq, on_frame=on_frame)
    assert seen, "never tracking"
    for lms, feats in seen:
        assert lms.ndim == 2 and lms.shape[1] == 3 and len(lms) > 20
        assert np.isfinite(lms).all()
        assert feats.shape[1] == 2 and len(feats) > 20
        assert (feats >= 0).all() and (feats[:, 0] < 320).all() and (feats[:, 1] < 240).all()


def _ar_map(M, n=8):
    pmap = M.PipelineMap()
    frame = M.FrameRec(
        id=1, t=0.0, q=np.array([1.0, 0, 0, 0]), p=np.zeros(3), v=np.zeros(3),
        bg=np.zeros(3), ba=np.zeros(3), q_bc=np.array([1.0, 0, 0, 0]), p_bc=np.zeros(3),
        q_bi=np.array([1.0, 0, 0, 0]), p_bi=np.zeros(3), K=np.eye(3),
        sqrt_inv_cov2=np.eye(2), bearings=np.zeros((32, 3)),
        track_ids=np.full((32,), -1, dtype=np.int64))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.2, 0.2, (n, 3)) + np.array([0, 0, 5.0])
    for i, pw in enumerate(pts):
        frame.bearings[i] = pw / np.linalg.norm(pw)
        tr = M.TrackRec(id=100 + i, p_w=pw, triangulated=True, valid=True)
        tr.obs[frame.id] = i
        frame.track_ids[i] = tr.id
        pmap.tracks[tr.id] = tr
    # one landmark outside the central cone, one untriangulated
    frame.bearings[n] = np.array([0.6, 0.0, 0.8])
    tr = M.TrackRec(id=100 + n, p_w=np.array([3.0, 0, 4.0]), triangulated=True)
    tr.obs[frame.id] = n
    frame.track_ids[n] = tr.id
    pmap.tracks[tr.id] = tr
    pmap.attach_frame(frame)
    return pmap, pts


@pytest.mark.parametrize("registered", [False, True])
def test_ar_anchoring_matches_jax(registered):
    T = (nputil.quat_normalize(np.array([0.9, 0.1, -0.2, 0.3])), np.array([5.0, -2.0, 1.5]))
    objs = {}
    for name, M, Mgr, Loc, SE in (("jax", jmap, JManager, JLocalizerBase, JSE3),
                                  ("port", tmap, VirtualObjectManager, LocalizerBase, SE3)):
        pmap, pts = _ar_map(M)
        loc = Loc()
        if registered:
            loc.slam_to_global = SE(*T)
            loc._init = True
        mgr = Mgr(pmap, localizer=loc)
        oid = mgr.create_virtual_object()
        assert oid > 0
        objs[name] = mgr.get_virtual_object_pose(oid)
    jo, to = objs["jax"], objs["port"]
    np.testing.assert_allclose(to.q, jo.q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(to.p, jo.p, rtol=0, atol=1e-12)
    assert to.isolated == jo.isolated == registered
    for a, b in zip(to.local_landmarks, jo.local_landmarks):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    R = nputil.quat_to_matrix(to.q)
    if registered:
        R = nputil.quat_to_matrix(nputil.quat_mul(nputil.quat_conj(T[0]), to.q))
        np.testing.assert_allclose(to.p, SE3(*T).apply(pts.mean(axis=0)), atol=1e-12)
    else:
        np.testing.assert_allclose(to.p, pts.mean(axis=0), atol=1e-12)
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(R[:, 0], [0, 0, -1.0], atol=1e-12)
    # too few landmarks in the central cone: -1
    pmap, _ = _ar_map(tmap, n=4)
    assert VirtualObjectManager(pmap).create_virtual_object() == -1


def test_inspection_painter_and_fps(tmp_path):
    from xrslam_tpu_torch.tools.make_dataset import render_dataset
    from xrslam_tpu_torch.tools.run_dataset import main

    inspection.InspectionSupport.clear()
    got = []
    inspection.subscribe("foo", got.append)
    inspection.inspect("foo", 42)
    assert inspection.inspect_get("foo") == 42 and got == [42]
    inspection.unsubscribe("foo", got.append)
    inspection.inspect("foo", 43)
    assert got == [42]

    paths = render_dataset(str(tmp_path), n_frames=3, n_landmarks=500, width=320,
                           height=240, focal=260.0)
    frames = []
    inspection.subscribe(inspection.PAINTER_FRAME, frames.append)
    inspection.inspect(inspection.PAINTER_ENABLE, True)
    try:
        out = main(["euroc://" + paths["root"], "--slam-config", paths["slam_yaml"],
                    "--device-config", paths["device_yaml"], "--sync", "--device", "cpu"])
    finally:
        inspection.inspect(inspection.PAINTER_ENABLE, False)
        inspection.unsubscribe(inspection.PAINTER_FRAME, frames.append)
    assert len(frames) == 3
    for fr in frames:
        assert fr["image"].shape == (240, 320) and fr["image"].dtype == np.float32
        assert len(fr["pts"]) == len(fr["lengths"]) > 20
    assert [fr["lengths"].max() for fr in frames] == [1, 2, 3]
    assert out["frames_tracked"] == 0 and out["fps"] > 0
    assert inspection.inspect_get(inspection.FEATURE_TRACKER_FPS) == out["fps"]
    assert "decode_time" in out["timings"] and "read_image_time" in out["timings"]


def test_logging_queue_and_sink(caplog):
    q = xlog.Logger.instance()
    assert q is xlog.Logger.instance()
    q.get_all_messages()
    q.push_message("a")
    q.push_message("b")
    assert q.get_all_messages() == ["a", "b"] and q.get_all_messages() == []
    logger = logging.getLogger("XRSLAM")
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            xlog.log_warning("value %d", 7)
            xlog.log_debug("hidden %d", 1)
        assert [r.message for r in caplog.records] == ["value 7"]
    finally:
        logger.propagate = False
    with pytest.raises(AssertionError, match="boom"):
        xlog.runtime_assert(False, "boom")
