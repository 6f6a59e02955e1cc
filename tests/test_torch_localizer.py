"""The port's visual localizer (`xrslam_tpu_torch/localizer.py`) held to
the JAX package's, on the CPU in float64:

- `SE3` algebra and `_screen_rotation` for every screen state, 1e-12;
- `_update_transform` and `transform`, 1e-12;
- `MapLocalizer` with the JAX package's minimal samples injected as
  `idx=` registers the same transform, 1e-9 (the PnP tolerance of
  tests/test_torch_pnp.py); without them its own draws register the
  true transform;
- the query throttle and `query_frame`;
- `HttpLocalizer` against the stub XRLocalization server of
  tests/test_localizer_http.py: the request shape, a JPEG Pillow
  decodes, the registered transform and its use in `predict_pose`,
  the `/pose` upload, the `ninlier` gate and a logged connection
  failure;
- the SyntheticTracker pipeline of tests/test_localizer_pipeline.py in
  both packages: both register, and both meet its bounds (median
  global error of the last 5 outputs < 0.5 m, newest output > 1 m from
  the SLAM-frame ground truth);
- a tracking frame offers the localizer its image and pose only with
  `visual_localization_enable`; an HTTP endpoint in the config installs
  an `HttpLocalizer`.
"""

import base64
import io
import json
import logging
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp

import numpy as np
import pytest
import torch
from PIL import Image

from xrslam_tpu import localizer as jloc
from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core import detail as jdetail
from xrslam_tpu.io import synthetic as jsyn
from xrslam_tpu.ransac import core as jcore
from xrslam_tpu_torch import convert
from xrslam_tpu_torch import localizer as tloc
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.core import nputil
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.io import synthetic as tsyn
from xrslam_tpu_torch.tools.make_dataset import camera_extrinsics

STATES = ["PORTRAIT", "RIGHT", "LEFT", "DOWN"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q(rng):
    return nputil.quat_normalize(rng.normal(size=4))


@pytest.mark.parametrize("state", STATES)
def test_se3_and_screen_rotation_match_jax(state):
    rng = np.random.default_rng(STATES.index(state))
    a = (_q(rng), rng.normal(size=3))
    b = (_q(rng), rng.normal(size=3))
    x = rng.normal(size=3)
    Ta, Tb = tloc.SE3(*a), tloc.SE3(*b)
    Ja, Jb = jloc.SE3(*a), jloc.SE3(*b)
    for t, j in (((Ta @ Tb).q, (Ja @ Jb).q), ((Ta @ Tb).p, (Ja @ Jb).p),
                 (Ta.inverse().q, Ja.inverse().q), (Ta.inverse().p, Ja.inverse().p),
                 (Ta.apply(x), Ja.apply(x))):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    I = Ta @ Ta.inverse()
    np.testing.assert_allclose(I.p, 0, atol=1e-12)
    np.testing.assert_allclose(
        tloc._screen_rotation(a[0], tloc.ScreenState[state]),
        jloc._screen_rotation(a[0], jloc.ScreenState[state]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("state", STATES)
def test_update_transform_matches_jax(state):
    rng = np.random.default_rng(10 + STATES.index(state))
    kw = dict(output_to_body_rotation=_q(rng),
              output_to_body_translation=rng.normal(size=3))
    t = tloc.LocalizerBase(Config(**kw))
    j = jloc.LocalizerBase(JConfig(**kw))
    args = (_q(rng), rng.normal(size=3), _q(rng), rng.normal(size=3))
    t._update_transform(*args, tloc.ScreenState[state])
    j._update_transform(*args, jloc.ScreenState[state])
    assert t.is_initialized() and j.is_initialized()
    np.testing.assert_allclose(t.slam_to_global.q, j.slam_to_global.q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.slam_to_global.p, j.slam_to_global.p, rtol=0, atol=1e-12)
    q, p = _q(rng), rng.normal(size=3)
    for a, b in zip(t.transform(q, p), j.transform(q, p)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _pnp_problem(seed=7, n=60, outliers=8):
    """tests/test_api_extras.py's scene: world points seen from a SLAM
    body pose, expressed in a global frame offset by T_gs, a few
    correspondences corrupted."""
    rng = np.random.default_rng(seed)
    T_gs = tloc.SE3(nputil.quat_normalize(np.array([0.9, 0.1, -0.2, 0.3])),
                    np.array([5.0, -2.0, 1.0]))
    q_sb = nputil.quat_normalize(np.array([0.8, 0.0, 0.4, 0.2]))
    p_sb = np.array([0.5, 0.2, -0.1])
    Xs = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 4.0])
    Xg = np.stack([T_gs.apply(nputil.quat_rotate(q_sb, x) + p_sb) for x in Xs])
    x = Xs[:, :2] / Xs[:, 2:3]
    x[:outliers] += rng.normal(0, 0.2, (outliers, 2))
    valid = np.ones(n, bool)
    return T_gs, q_sb, p_sb, Xg, x, valid


def test_map_localizer_matches_jax():
    T_gs, q_sb, p_sb, Xg, x, valid = _pnp_problem()

    def matcher(_):
        return Xg, x, valid

    j = jloc.MapLocalizer(config=JConfig(), matcher=matcher, query_interval=0.0)
    assert j.query_localization(10.0, None, q_sb, p_sb)
    # JAX's first query draws with PRNGKey(1)
    idx = np.asarray(jcore.sample_minimal(jax.random.PRNGKey(1), 256, len(Xg), 6,
                                          jnp.asarray(valid)))
    t = tloc.MapLocalizer(config=Config(), matcher=matcher, query_interval=0.0,
                          device="cpu")
    assert t.query_localization(10.0, None, q_sb, p_sb, idx=idx)
    np.testing.assert_allclose(t.slam_to_global.q, j.slam_to_global.q, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.slam_to_global.p, j.slam_to_global.p, rtol=0, atol=1e-9)
    # its own draws: the true slam -> global within the noise-free fit
    own = tloc.MapLocalizer(config=Config(), matcher=matcher, query_interval=0.0,
                            device="cpu")
    assert own.query_localization(10.0, None, q_sb, p_sb)
    q_out, p_out = own.transform(q_sb, p_sb)
    np.testing.assert_allclose(p_out, T_gs.apply(p_sb), atol=1e-6)
    dq = nputil.quat_mul(nputil.quat_conj(nputil.quat_mul(T_gs.q, q_sb)), q_out)
    assert abs(abs(dq[0]) - 1.0) < 1e-9


def test_map_localizer_throttle_and_query_frame():
    calls = []

    def matcher(_):
        calls.append(1)
        return None

    for cls, kw in ((tloc.MapLocalizer, dict(device="cpu")), (jloc.MapLocalizer, {})):
        calls.clear()
        loc = cls(config=None, matcher=matcher, query_interval=3.0, **kw)
        q0, p0 = np.array([1.0, 0, 0, 0]), np.zeros(3)
        for t in (0.0, 1.0, 4.0):
            loc.query_localization(t, None, q0, p0)
        assert len(calls) == 2  # t=1.0 throttled
        loc.query_frame()
        loc.query_localization(4.5, None, q0, p0)
        assert len(calls) == 3  # query_frame lets it through
        # too few correspondences: no PnP, no registration
        loc.matcher = lambda _: (np.zeros((10, 3)), np.zeros((10, 2)), np.ones(10, bool))
        assert not loc.query_localization(10.0, None, q0, p0)
        assert not loc.is_initialized()


class _StubLocServer:
    """The stdlib stub XRLocalization server of
    tests/test_localizer_http.py: answers /loc with a fixed pose and
    records every request."""

    def __init__(self, qvec, tvec, ninlier=50):
        self.requests = []
        self.pose_bodies = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                if self.path == "/loc":
                    outer.requests.append(body)
                    out = {"qvec": list(qvec), "tvec": list(tvec), "ninlier": ninlier}
                elif self.path == "/pose":
                    outer.pose_bodies.append(body)
                    out = {"success": True}
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                payload = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self._th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._th.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _http_config(**kw):
    f = 450.0
    return Config(
        camera_intrinsic=np.array([[f, 0.0, 160.0], [0.0, f, 120.0], [0.0, 0.0, 1.0]]),
        camera_distortion=np.array([-0.28, 0.07, 1e-5, 2e-5]),
        output_to_body_rotation=nputil.quat_normalize(np.array([0.8, 0.1, -0.3, 0.2])),
        output_to_body_translation=np.array([0.02, -0.01, 0.03]),
        visual_localization_enable=True,
        visual_localization_config_ip="127.0.0.1",
        visual_localization_config_port=1, **kw)


def test_http_localizer_wire_protocol_and_transform():
    cfg = _http_config()
    q_sb = nputil.quat_normalize(np.array([0.9, -0.2, 0.1, 0.3]))
    p_sb = np.array([0.5, -1.0, 0.25])
    T_true = tloc.SE3(nputil.quat_normalize(np.array([0.7, 0.3, -0.1, 0.4])),
                      np.array([5.0, -2.0, 1.5]))
    T_slam_cam = tloc.SE3(nputil.quat_mul(q_sb, cfg.output_to_body_rotation),
                          p_sb + nputil.quat_rotate(q_sb, cfg.output_to_body_translation))
    T_g_cam = T_true @ T_slam_cam
    srv = _StubLocServer(qvec=T_g_cam.q.tolist(), tvec=T_g_cam.p.tolist())
    try:
        pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
        assert isinstance(pipe.localizer, tloc.HttpLocalizer)
        loc = tloc.HttpLocalizer(cfg, ip="127.0.0.1", port=srv.port, min_inliers=20)
        pipe.set_localizer(loc)
        # a float image in [0, 1], as the tracking loop passes it
        img = np.random.default_rng(3).random((120, 160)).astype(np.float32)
        loc.query_localization(10.0, img, q_sb, p_sb, block=True)
        assert len(srv.requests) == 1
        req = srv.requests[0]
        assert set(req) == {"image", "intrinsic"}
        intr = req["intrinsic"]
        assert intr["model"] == "OPENCV" and intr["width"] == 160 and intr["height"] == 120
        np.testing.assert_allclose(intr["params"][:4], [450.0, 450.0, 160.0, 120.0])
        np.testing.assert_allclose(intr["params"][4:], cfg.camera_distortion, atol=1e-12)
        decoded = Image.open(io.BytesIO(base64.b64decode(req["image"])))
        assert decoded.format == "JPEG" and decoded.size == (160, 120)
        assert decoded.mode == "L"
        err = np.abs(np.asarray(decoded, float) - np.clip(img * 255.0, 0, 255).astype(np.uint8))
        assert err.mean() < 40  # lossy, but the same picture

        assert loc.is_initialized()
        T = loc.slam_to_global
        qd = nputil.quat_mul(nputil.quat_conj(T.q), T_true.q)
        assert abs(abs(qd[0]) - 1.0) < 1e-9
        np.testing.assert_allclose(T.p, T_true.p, atol=1e-9)

        pipe._prop = dict(t=10.0, q=q_sb.copy(), p=p_sb.copy(), v=np.zeros(3),
                          bg=np.zeros(3), ba=np.zeros(3))
        out = pipe.predict_pose(10.0)
        np.testing.assert_allclose(out.p, T_true.p + nputil.quat_rotate(T_true.q, p_sb),
                                   atol=1e-9)

        loc.add_pose_message(10.0, q_sb, p_sb)
        loc.send_pose()
        assert srv.pose_bodies[0]["pose"] == pytest.approx(
            [p_sb[0], p_sb[1], p_sb[2], q_sb[1], q_sb[2], q_sb[3], q_sb[0]])
        assert loc._pose_buf == []
    finally:
        srv.close()


def test_http_localizer_ninlier_gate_and_failure_logging(caplog):
    cfg = _http_config()
    q0, p0 = np.array([1.0, 0, 0, 0]), np.zeros(3)
    img = np.zeros((24, 32), dtype=np.uint8)
    logger = logging.getLogger("XRSLAM")
    logger.propagate = True  # let caplog's root handler see the sink
    try:
        srv = _StubLocServer(qvec=[1, 0, 0, 0], tvec=[0, 0, 0], ninlier=5)
        try:
            loc = tloc.HttpLocalizer(cfg, ip="127.0.0.1", port=srv.port, min_inliers=20)
            with caplog.at_level(logging.WARNING):
                loc.query_localization(0.0, img, q0, p0, block=True)
            assert not loc.is_initialized() and len(srv.requests) == 1
            assert any("ninlier" in r.message for r in caplog.records)
        finally:
            srv.close()
        caplog.clear()
        loc2 = tloc.HttpLocalizer(cfg, ip="127.0.0.1", port=srv.port, min_inliers=20)
        with caplog.at_level(logging.WARNING):
            loc2.query_localization(0.0, img, q0, p0, block=True)
        assert not loc2.is_initialized()
        assert any("query failed" in r.message for r in caplog.records)
    finally:
        logger.propagate = False


def _pipeline_config(cls, **kw):
    q_bc, p_bc = camera_extrinsics()
    f = 450.0
    defaults = dict(
        camera_intrinsic=np.array([[f, 0.0, 376.0], [0.0, f, 240.0], [0.0, 0.0, 1.0]]),
        camera_to_body_rotation=q_bc, camera_to_body_translation=p_bc,
        output_to_body_rotation=q_bc, output_to_body_translation=p_bc,
        initializer_keyframe_gap=2, initializer_min_matches=30,
        initializer_min_triangulation=30, initializer_min_landmarks=20,
        window_landmark_slots=96, init_landmark_slots=96,
        sliding_window_force_keyframe_landmarks=20,
        visual_localization_enable=True)
    defaults.update(kw)
    return cls(**defaults)


def _drive_localized(pipe, scene, bearings, mask, n_frames, C=96):
    """tests/test_localizer_pipeline.py's drive: IMU then the frame's
    bearings with the landmark index as its track hint; the tracking
    outputs at each frame time."""
    ts = np.asarray(scene.t)
    imu_t, imu_w, imu_a = (np.asarray(x) for x in (scene.imu_t, scene.imu_w, scene.imu_a))
    outs = []
    for k in range(n_frames):
        if k > 0:
            for s in range(imu_t.shape[1]):
                t = float(imu_t[k - 1, s])
                pipe.track_gyroscope(t, imu_w[k - 1, s])
                pipe.track_accelerometer(t, imu_a[k - 1, s])
        pipe.track_gyroscope(float(ts[k]) + 1e-6, imu_w[min(k, n_frames - 2), 0])
        pipe.track_accelerometer(float(ts[k]) + 1e-6, imu_a[min(k, n_frames - 2), 0])
        kp = np.zeros((C, 3))
        kp[:, 2] = 1.0
        hint = np.full((C,), -1, dtype=np.int64)
        for slot, lm in enumerate(np.nonzero(mask[k])[0][:C]):
            kp[slot] = bearings[k, lm]
            hint[slot] = lm
        pipe.track_camera(float(ts[k]), kp, hint)
        if pipe.state == "tracking":
            out = pipe.predict_pose(float(ts[k]))
            if out is not None:
                outs.append((k, out))
    return outs


def _matcher(T_g, lms):
    def matcher(frame):
        hint = getattr(frame, "_hint", None)
        if hint is None:
            return None
        C = frame.bearings.shape[0]
        X, x, valid = np.zeros((C, 3)), np.zeros((C, 2)), np.zeros((C,), bool)
        for k in np.nonzero(hint >= 0)[0]:
            b = frame.bearings[k]
            if b[2] <= 1e-6:
                continue
            X[k] = T_g.apply(lms[int(hint[k])])
            x[k] = b[:2] / b[2]
            valid[k] = True
        return X, x, valid
    return matcher


@pytest.mark.slow
def test_localizer_pipeline_pair():
    n_frames = 40
    T_g = tloc.SE3(nputil.quat_normalize(np.array([0.9, 0.1, -0.2, 0.3])),
                   np.array([5.0, -2.0, 1.5]))
    jscene = jsyn.wave_scene(n_frames=n_frames, n_landmarks=64)
    jcfg = _pipeline_config(JConfig)
    jb, jm = jsyn.bearings_of(jscene, jnp.asarray(jcfg.camera_to_body_rotation),
                              jnp.asarray(jcfg.camera_to_body_translation))
    # the port commits no draw for (seed 0, 64 landmarks): take JAX's
    tscene = tsyn.wave_scene(n_frames=n_frames, n_landmarks=64, seed=0,
                             landmarks=np.asarray(jscene.landmarks))
    tcfg = _pipeline_config(Config)
    tb, tm = tsyn.bearings_of(tscene, convert.to_torch(tcfg.camera_to_body_rotation),
                              convert.to_torch(tcfg.camera_to_body_translation))
    runs = {}
    jpipe = jdetail.VIOPipeline(jcfg, jdetail.SyntheticTracker())
    jpipe.set_localizer(jloc.MapLocalizer(jcfg, matcher=_matcher(T_g, np.asarray(jscene.landmarks)),
                                          query_interval=0.5))
    runs["jax"] = (jpipe, jscene, _drive_localized(jpipe, jscene, np.asarray(jb),
                                                   np.asarray(jm), n_frames))
    tpipe = VIOPipeline(tcfg, SyntheticTracker(device="cpu"), device="cpu")
    tpipe.set_localizer(tloc.MapLocalizer(tcfg, matcher=_matcher(T_g, tscene.landmarks.numpy()),
                                          query_interval=0.5, device="cpu"))
    runs["port"] = (tpipe, tscene, _drive_localized(tpipe, tscene, tb.numpy(), tm.numpy(),
                                                    n_frames))
    for name, (pipe, scene, outs) in runs.items():
        assert pipe.localizer.is_initialized(), name
        gt_p = np.asarray(scene.p)
        errs = [np.linalg.norm(out.p - T_g.apply(gt_p[k])) for k, out in outs[-5:]]
        assert np.median(errs) < 0.5, (name, errs)
        k, out = outs[-1]
        assert np.linalg.norm(out.p - gt_p[k]) > 1.0, name


@pytest.mark.parametrize("enabled", [False, True])
def test_localizer_query_follows_config(enabled):
    """A tracking frame offers the localizer its pose only with
    `visual_localization_enable` (the backend is stubbed out: a
    tracking state, one frame past the backend's decimation)."""
    cfg = _pipeline_config(Config, visual_localization_enable=enabled,
                           sliding_window_tracker_frequent=1000)
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    assert pipe.localizer is None  # no endpoint configured, nothing installed
    calls = []

    class Spy(tloc.MapLocalizer):
        def query_localization(self, t, frame, q, p, *a, **k):
            calls.append((t, q.copy(), p.copy()))
            return False

    pipe.set_localizer(Spy(cfg, matcher=None, device="cpu"))
    # tracking; the decimation keeps the backend idle (no write-back to
    # ride the tracker's read)
    pipe.swt = types.SimpleNamespace(collect_riders=lambda: [])
    pipe._frame_count = 1
    pipe._prop = dict(t=0.0, q=np.array([1.0, 0, 0, 0]), p=np.array([1.0, 2, 3]),
                      v=np.zeros(3), bg=np.zeros(3), ba=np.zeros(3))
    for t in (0.01, 0.02):
        pipe.track_gyroscope(t, np.zeros(3))
        pipe.track_accelerometer(t, np.array([0.0, 0.0, 9.80665]))
    kp = np.zeros((8, 3))
    kp[:, 2] = 1.0
    pipe.track_camera(0.015, kp, np.full((8,), -1, np.int64))
    assert pipe.state == "tracking"
    if enabled:
        assert len(calls) == 1 and calls[0][0] == 0.015
        np.testing.assert_allclose(calls[0][2], [1.0, 2, 3], atol=1e-3)
    else:
        assert calls == []
