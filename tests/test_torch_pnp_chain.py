"""The camera-rate PnP pose chain of the port's `core/detail.py`
(`visual_pnp_enable`, with the backend every `sliding_window_tracker_frequent`
frames), held to the plain reference's IMU propagation
(`vio_bench/reference.propagate`), on the CPU in float64.

A PnP frame publishes its pose as the propagation's start; the next
backend refresh may restart the propagation from an anchor older than
that frame (the deferred write-back's anchor, one backend frame back).
Every published pose must be the propagation, through every sample, of
the state it starts from.

- the chain without a backend or a renderer: an anchor, a PnP publish
  four frames on, a refresh to an anchor three frames back from the PnP
  frame, then `predict_pose`; the skipped PnP (too few landmarks) and the
  published one in the record (tags and counters); the samples kept
  bounded while tracking is lost, the poses unchanged;
- the departure from the JAX package, which drops the samples up to each
  PnP frame (`xrslam_tpu/core/detail.py:468`): both packages load the JAX
  checkpoint `tests/data/jax_circle_ckpt30.npz` with the PnP on and the
  backend every 3rd frame and drive it across a refresh to an anchor
  older than the last PnP frame. The JAX package's pose skips the span
  between them; the port's is within 1e-11 m of the reference. Both are
  asserted, so the test records the departure (ROADMAP.md, the
  reference's known defects) without holding the port to the trim.
"""

import types

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import (CUT, JAX_CKPT, JAX_TAIL, drive, make_config,
                                         scene_inputs)
from vio_bench import reference
from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core.detail import SyntheticTracker as JSyntheticTracker
from xrslam_tpu.utils import checkpoint as jck
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.core import nputil
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.utils import checkpoint as ck

POSE_TOL_M = 1e-11     # the benchmark's pose_gap_m limit
S = 10                 # IMU samples a frame: 200 Hz against 20 Hz
DT = 0.005


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def imu_stream(n_frames: int, seed: int = 3):
    """(t, w, a) of a smooth made-up IMU stream, S samples a frame after
    t = 0: a turning, accelerating body."""
    rng = np.random.default_rng(seed)
    t = DT * np.arange(1, n_frames * S + 1)
    c = rng.normal(size=(2, 3, 3))
    w = c[0, 0] * 0.3 + np.sin(t[:, None] * c[0, 1] * 3) * c[0, 2] * 0.5
    a = np.array([0.0, 0.0, 9.80665]) + c[1, 0] * 0.5 + np.sin(t[:, None] * c[1, 1] * 3) * c[1, 2]
    return t, w, a


def anchor_at(t: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    return dict(t=t, q=q / np.linalg.norm(q), p=rng.normal(size=3), v=rng.normal(size=3) * 0.5,
                bg=rng.normal(size=3) * 1e-3, ba=rng.normal(size=3) * 1e-2)


class Backend:
    """The sliding window as `_refresh_prop_state` sees it: a latest
    state and an empty map (the keymap is set by the test)."""

    def __init__(self, state: dict):
        self.state = state
        self.map = types.SimpleNamespace(all_frames=lambda: [], tracks={})

    def get_latest_state(self):
        s = self.state
        return s["t"], s["q"], s["p"], s["v"], s["bg"], s["ba"]


def pnp_frame(pipe, t: float, n_points: int, seed: int = 5):
    """A frame at `t` that sees `n_points` keymap landmarks from 2 cm off
    the pose the IMU propagates to."""
    _, q_b, p_b, _ = pipe._propagate_full(t)
    f = pipe._make_frame(t, np.zeros((64, 3)))
    q_wc = nputil.quat_mul(q_b, f.q_bc)
    p_wc = p_b + nputil.quat_rotate(q_b, f.p_bc) + np.array([0.02, -0.01, 0.01])
    rng = np.random.default_rng(seed)
    y = np.stack([rng.uniform(-1, 1, n_points), rng.uniform(-1, 1, n_points),
                  rng.uniform(2, 5, n_points)], 1)
    X = p_wc + np.stack([nputil.quat_rotate(q_wc, yi) for yi in y])
    f.bearings[:, 2] = 1.0
    f.bearings[:n_points] = y / np.linalg.norm(y, axis=1, keepdims=True)
    f.track_ids[:n_points] = 1000 + np.arange(n_points)
    pipe._keymap = {1000 + k: X[k] for k in range(n_points)}
    return f


def chain_pipeline():
    return VIOPipeline(Config(visual_pnp_enable=True), SyntheticTracker(device="cpu"),
                       device="cpu")


def test_pnp_then_older_anchor_propagates_every_sample():
    t, w, a = imu_stream(6)
    pipe = chain_pipeline()
    pipe.swt = Backend(anchor_at(0.0, 1))
    pipe._refresh_prop_state()
    for k in range(4 * S):                      # frames 1..4
        pipe._track_imu(t[k], w[k], a[k])
    f4 = pnp_frame(pipe, t[4 * S - 1], 20)
    pipe._solve_pnp_highrate(f4)
    assert pipe.pnp_frames == 1 and pipe._prop["t"] == f4.t
    for k in range(4 * S, 6 * S):               # frames 5..6
        pipe._track_imu(t[k], w[k], a[k])
    anchor = anchor_at(t[S - 1], 2)             # frame 1: three frames back from f4
    pipe.swt = Backend(anchor)
    pipe._refresh_prop_state()
    pose = pipe.predict_pose(t[-1])
    q_ref, p_ref = reference.propagate(anchor, t, w, a, t[-1])
    assert pose.t == t[-1]
    assert np.linalg.norm(pose.p - p_ref) < POSE_TOL_M
    assert np.linalg.norm(pose.q - q_ref) < 1e-12
    # the samples kept are those after the anchor the refresh installed
    assert [s[0] for s in pipe._imu_since_opt] == list(t[S:])


def test_pnp_publish_and_skip_in_the_record():
    t, w, a = imu_stream(3)
    pipe = chain_pipeline()
    pipe.swt = Backend(anchor_at(0.0, 1))
    pipe._prop = anchor_at(0.0, 1)
    for k in range(3 * S):
        pipe._track_imu(t[k], w[k], a[k])
    n_min = pipe.config.visual_pnp_min_landmarks
    # the second frame's keymap: the first sees one landmark too few of it
    frames = [pnp_frame(pipe, t[S - 1], n_min - 1), pnp_frame(pipe, t[2 * S - 1], n_min)]
    keymap = pipe._keymap
    pipe.times.record(True)
    with pipe.times.frame(0, kind="track"), pipe.times.stage("backend_time"):
        pipe._refresh_prop_state()
    pipe._keymap = keymap
    for f in frames:
        with pipe.times.frame(f.id, kind="track"), pipe.times.stage("visual_pnp_time"):
            pipe._solve_pnp_highrate(f)
    # a pose published between frames: counted with the newest frame
    pipe._last_frame_id = frames[1].id
    pipe.predict_pose(t[-1])
    rec = pipe.times.export()
    pipe.times.record(False)
    tags = {s["frame"]: s["tags"].get("pnp") for s in rec["spans"] if s["name"] == "frame"}
    assert tags == {0: None, frames[0].id: "skipped", frames[1].id: "published"}
    # each propagation walked the samples since the one before
    assert rec["frames"][frames[0].id] == {"pnp_skipped": 1, "imu_samples_replayed": S}
    assert rec["frames"][frames[1].id] == {"pnp_published": 1, "imu_samples_replayed": 2 * S}
    frame_spans = {s["frame"]: s for s in rec["spans"] if s["name"] == "frame"}
    assert frame_spans[frames[1].id]["counters"] == {"imu_samples_replayed": S}
    by_id = {s["id"]: s for s in rec["spans"]}
    spans = [s for s in rec["spans"] if s["name"] == "pnp_keymap_time"]
    assert len(spans) == 1 and by_id[spans[0]["parent"]]["name"] == "backend_time"
    assert pipe.pnp_frames == 1


def test_samples_bounded_while_lost():
    """Tracking lost after a refresh, the initializer failing frame after
    frame: the samples stay within the tracker's frames, and every pose
    is still the propagation of the last anchor through every sample."""
    n_frames = 150
    t, w, a = imu_stream(n_frames)
    pipe = chain_pipeline()
    anchor = anchor_at(0.0, 1)
    pipe._prop = dict(anchor)
    pipe.initializer = types.SimpleNamespace(mirror_keyframe_map=lambda m, fid: None, map=None)
    cap = pipe.config.feature_tracker_max_init_frames
    longest = 0
    for i in range(n_frames):
        for k in range(i * S, (i + 1) * S):
            pipe.track_gyroscope(t[k], w[k])
            pose = pipe.track_accelerometer(t[k], a[k])
        pipe.track_camera(t[(i + 1) * S - 1], np.tile([0.0, 0.0, 1.0], (8, 1)))
        longest = max(longest, len(pipe._imu_since_opt))
    assert pipe.state == "initializing" and len(pipe.tracker_map.frames) == cap
    assert longest <= (cap + 1) * S
    q_ref, p_ref = reference.propagate(anchor, t, w, a, pose.t)
    assert np.linalg.norm(pose.p - p_ref) < 1e-9 * max(1.0, np.linalg.norm(p_ref))
    assert np.linalg.norm(pose.q - q_ref) < 1e-12


def checkpoint_pipelines():
    """Both packages load the JAX checkpoint with the camera-rate PnP on
    and the backend every 3rd frame; returns the port's and the JAX
    package's pipelines and the samples the port's takes in."""
    ref = np.load(JAX_TAIL)
    id_map = dict(zip(ref["hints"].tolist(), ref["track_ids"].tolist()))
    cfg = make_config().replace(visual_pnp_enable=True, sliding_window_tracker_frequent=3)
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = dict(id_map)
    pipe = ck.load_pipeline(JAX_CKPT, cfg, tracker, device="cpu")
    jtracker = JSyntheticTracker()
    jtracker._id_map = dict(id_map)
    jpipe = jck.load_pipeline(JAX_CKPT, JConfig(**convert.config_to_dict(cfg)), jtracker)
    samples = []
    take = pipe._track_imu

    def logged(t, w, a):
        if t > pipe.last_imu_t:
            samples.append((t, w, a))
        take(t, w, a)

    pipe._track_imu = logged
    return pipe, jpipe, samples


def test_pnp_chain_departs_from_jax():
    pipe, jpipe, samples = checkpoint_pipelines()
    inputs = scene_inputs(make_config())
    k, pnp_t = CUT, None
    while True:
        assert k < CUT + 6, "no refresh to an anchor older than a PnP frame"
        n_pnp = pipe.pnp_frames
        drive(pipe, inputs, k, k + 1)
        drive(jpipe, inputs, k, k + 1)
        if pipe.pnp_frames > n_pnp:
            pnp_t = float(inputs[2][k])
        k += 1
        if pnp_t is not None and pipe._prop["t"] < pnp_t:
            break
    anchor, janchor = pipe._prop, jpipe._prop
    assert janchor["t"] == anchor["t"] < pnp_t
    t_end = samples[-1][0]
    imu_t = np.array([s[0] for s in samples])
    imu_w = np.stack([s[1] for s in samples])
    imu_a = np.stack([s[2] for s in samples])

    def gap(p, start):
        pose = p.predict_pose(t_end)
        _, p_ref = reference.propagate(start, imu_t, imu_w, imu_a, t_end)
        return float(np.linalg.norm(np.asarray(pose.p) - p_ref))

    assert gap(pipe, anchor) < POSE_TOL_M
    # the JAX package's pose misses the motion between the anchor and the
    # PnP frame: millimetres on this slow scene
    assert gap(jpipe, janchor) > 1e-4
