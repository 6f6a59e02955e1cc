"""Checkpoint/resume of the port (`xrslam_tpu_torch/utils/checkpoint.py`)
held to itself and to the JAX package, on the CPU in float64.

The drive is `tests/test_checkpoint.py`'s: a `circle_scene` of 40 frames
and 64 landmarks (the JAX package's, as numpy), fed as bearings through
the `SyntheticTracker`, checkpoint after frame 30, the tracker's hint ->
track map carried over. Runs are compared by time and position, never
by id (a save draws one value of each id counter).

- the tree format round-trips, and files load across the packages: a
  port file through JAX's `load_tree` and a JAX file through the port's
  give equal trees;
- resume: the port's resumed tail is within 1e-6 m of the saved
  pipeline's own run on (a save changes nothing in it but the ids),
  with PARSAC off and on; with PARSAC on, the bin confidences of both
  PARSAC stages (`bin_conf_2d2d` set to seeded values before the save,
  since the judge does not fire on this static scene) and m_th agree
  within 1e-12 after the last frame, and the generators' states are
  equal;
- a frame still waiting for its IMU at the save is saved with its
  inputs and processed by the restored pipeline as by the saved one;
- cross: a JAX checkpoint at frame 30 (`tests/data/jax_circle_ckpt30.npz`),
  loaded and finished by the port: every frame of the final window
  within 1e-6 m of the JAX package loading and finishing it
  (`tests/data/jax_circle_tail.npz`), PARSAC off so that no draw is
  taken. Both files are written by the JAX
  package; `slow` regenerates them and checks the committed ones:

      JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
          python tests/test_torch_checkpoint.py --write

The restore onto the card, and its refusal of a generator state of the
other device type, are `tests/test_torch_cuda.py`'s (which runs on the
card without jax).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core.detail import SyntheticTracker as JSyntheticTracker
from xrslam_tpu.core.detail import VIOPipeline as JVIOPipeline
from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.io.synthetic import bearings_of, circle_scene, euler_consistent
from xrslam_tpu.utils import checkpoint as jck
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.ransac import parsac
from xrslam_tpu_torch.utils import checkpoint as ck

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
JAX_CKPT = os.path.join(DATA, "jax_circle_ckpt30.npz")
JAX_TAIL = os.path.join(DATA, "jax_circle_tail.npz")
N_FRAMES, CUT, SLOTS = 40, 30, 96
TAIL_TOL_M = 1e-6    # resumed tail against the reference tail
STATE_TOL = 1e-12    # PARSAC bin confidences and m_th


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_config(parsac_flag: bool = False) -> Config:
    """`tests/test_checkpoint.py`'s configuration, as the port's Config."""
    f = 450.0
    q_bc = np.asarray(jlie.expmap(jnp.array([-jnp.pi / 2, 0.0, 0.0],
                                            dtype=jnp.float64)))
    return Config(
        camera_intrinsic=np.array([[f, 0.0, 376.0], [0.0, f, 240.0], [0.0, 0.0, 1.0]]),
        camera_to_body_rotation=q_bc,
        camera_to_body_translation=np.array([0.02, -0.01, 0.03]),
        initializer_keyframe_gap=2, initializer_min_matches=30,
        initializer_min_triangulation=30, initializer_min_landmarks=20,
        window_landmark_slots=SLOTS, init_landmark_slots=SLOTS,
        sliding_window_force_keyframe_landmarks=20, parsac_flag=parsac_flag)


def scene_inputs(cfg: Config):
    """(bearings, mask, t, imu_t, imu_w, imu_a) of the JAX package's
    circle scene, as numpy."""
    scene = euler_consistent(circle_scene(n_frames=N_FRAMES, n_landmarks=64,
                                          omega=0.25))
    bearings, mask = bearings_of(scene, jnp.asarray(cfg.camera_to_body_rotation),
                                 jnp.asarray(cfg.camera_to_body_translation))
    return tuple(np.asarray(x) for x in (bearings, mask, scene.t, scene.imu_t,
                                         scene.imu_w, scene.imu_a))


def drive(pipe, inputs, k0: int, k1: int):
    """Frames k0..k1-1 into `pipe` (either package's VIOPipeline);
    returns (t, p) of the latest window state after each tracking frame."""
    bearings, mask, ts, imu_t, imu_w, imu_a = inputs
    outs = []
    for k in range(k0, k1):
        if k > 0:
            for s in range(imu_t.shape[1]):
                t = float(imu_t[k - 1, s])
                pipe.track_gyroscope(t, imu_w[k - 1, s])
                pipe.track_accelerometer(t, imu_a[k - 1, s])
        pipe.track_gyroscope(float(ts[k]) + 1e-6, imu_w[min(k, N_FRAMES - 2), 0])
        pipe.track_accelerometer(float(ts[k]) + 1e-6, imu_a[min(k, N_FRAMES - 2), 0])
        kp = np.zeros((SLOTS, 3))
        kp[:, 2] = 1.0
        hint = np.full((SLOTS,), -1, dtype=np.int64)
        for slot, lm in enumerate(np.nonzero(mask[k])[0][:SLOTS]):
            kp[slot] = bearings[k, lm]
            hint[slot] = lm
        pipe.track_camera(float(ts[k]), kp, hint)
        if pipe.state == "tracking":
            t, _, p, _, _, _ = pipe.swt.get_latest_state()
            outs.append((float(t), np.asarray(p).copy()))
    return outs


def tail_error(ref, out, t_cut: float) -> float:
    """Largest position difference over the outputs from `t_cut` on,
    matched by time (with deferred write-backs the first output after a
    cut is the anchor at the cut's frame)."""
    ref = {t: p for t, p in ref if t >= t_cut}
    out = dict(out)
    assert len(ref) >= 5 and set(ref) == set(out), (sorted(ref), sorted(out))
    return max(float(np.linalg.norm(ref[t] - out[t])) for t in ref)


def assert_trees_equal(a, b, path="r"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_tree_roundtrip(tmp_path):
    tree = {
        "a": np.arange(6).reshape(2, 3).astype(np.float64),
        "b": [1, 2.5, None, "hi", True],
        "nested": {"x": torch.ones((3,)), 7: np.array([1, 2], dtype=np.int64)},
        "state": torch.arange(5, dtype=torch.uint8),
        "empty": [],
    }
    p = str(tmp_path / "t.npz")
    ck.save_tree(p, tree)
    out = ck.load_tree(p)
    assert np.array_equal(out["a"], tree["a"])
    assert out["b"] == [1, 2.5, None, "hi", True]
    assert out["nested"]["x"].dtype == np.float32 and np.all(out["nested"]["x"] == 1.0)
    assert np.array_equal(out["nested"][7], [1, 2])
    assert out["state"].dtype == np.uint8 and np.array_equal(out["state"], np.arange(5))
    assert out["empty"] == []


def test_tree_files_load_across_packages(tmp_path):
    tree = {"a": np.linspace(0.0, 1.0, 7), "ids": np.arange(4, dtype=np.int64),
            "flags": [True, False, None], "s": "x", 3: {"f": 1.5, "i": 2},
            "mask": np.array([True, False])}
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.save_tree(mine, tree)
    jck.save_tree(theirs, tree)
    assert_trees_equal(jck.load_tree(mine), ck.load_tree(mine))
    assert_trees_equal(ck.load_tree(theirs), jck.load_tree(theirs))
    assert_trees_equal(ck.load_tree(mine), ck.load_tree(theirs))


@pytest.mark.parametrize("parsac_flag", [False, True], ids=["parsac_off", "parsac_on"])
def test_resume_matches_straight_run(parsac_flag, tmp_path):
    cfg = make_config(parsac_flag)
    inputs = scene_inputs(cfg)
    # the straight run is the pipeline that is saved, driven on: a save
    # changes nothing in it but the ids
    straight = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    outs_a = drive(straight, inputs, 0, CUT)
    assert straight.swt is not None
    if parsac_flag:
        # the judge never returns True on this static scene, so the 2D-2D
        # confidences would stay initial: give them other values
        conf = np.random.default_rng(0).uniform(0.2, 0.9, parsac.N_BINS)
        straight.swt.bin_conf_2d2d = torch.as_tensor(conf)
    path = str(tmp_path / "state.npz")
    ck.save_pipeline(path, straight)
    if not parsac_flag:
        assert_trees_equal(jck.load_tree(path), ck.load_tree(path))

    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = dict(straight.tracker._id_map)
    resumed = ck.load_pipeline(path, cfg, tracker, device="cpu")
    assert resumed.device == torch.device("cpu")
    outs_a += drive(straight, inputs, CUT, N_FRAMES)
    outs_c = drive(resumed, inputs, CUT, N_FRAMES)
    assert tail_error(outs_a, outs_c, float(inputs[2][CUT - 1])) < TAIL_TOL_M
    a, c = straight.swt, resumed.swt
    if parsac_flag:
        assert a.stats["judge_calls"] > 0 and a.stats == c.stats
        assert float((a.bin_conf - c.bin_conf).abs().max()) <= STATE_TOL
        assert float((a.bin_conf_2d2d - c.bin_conf_2d2d).abs().max()) <= STATE_TOL
        assert float((c.bin_conf_2d2d - torch.as_tensor(conf)).abs().max()) <= STATE_TOL
        assert abs(a.m_th - c.m_th) <= STATE_TOL
    assert torch.equal(a.generator.get_state(), c.generator.get_state())
    assert c.bin_conf.device == c.bin_conf_2d2d.device == torch.device("cpu")


def test_pending_frame_survives_a_save(tmp_path):
    """A camera frame pushed before the IMU has passed it waits in the
    pipeline; a save then keeps it with its bearings and hints, and the
    restored pipeline processes it when the IMU arrives, as the saved
    one does."""
    cfg = make_config()
    bearings, mask, ts, imu_t, imu_w, imu_a = inputs = scene_inputs(cfg)
    k = 6
    first = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    drive(first, inputs, 0, k)
    for s_ in range(imu_t.shape[1]):
        first.track_gyroscope(float(imu_t[k - 1, s_]), imu_w[k - 1, s_])
        first.track_accelerometer(float(imu_t[k - 1, s_]), imu_a[k - 1, s_])
    kp = np.zeros((SLOTS, 3))
    kp[:, 2] = 1.0
    hint = np.full((SLOTS,), -1, dtype=np.int64)
    vis = np.nonzero(mask[k])[0][:SLOTS]
    kp[:len(vis)], hint[:len(vis)] = bearings[k, vis], vis
    first.track_camera(float(ts[k]), kp, hint)
    assert len(first.frame_pending) == 1 and first.frames_processed == k
    path = str(tmp_path / "pending.npz")
    ck.save_pipeline(path, first)
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = dict(first.tracker._id_map)
    resumed = ck.load_pipeline(path, cfg, tracker, device="cpu")
    assert len(resumed.frame_pending) == 1
    for p in (first, resumed):
        p.track_gyroscope(float(ts[k]) + 1e-6, imu_w[k, 0])
        p.track_accelerometer(float(ts[k]) + 1e-6, imu_a[k, 0])
        assert not p.frame_pending and p.frames_processed == k + 1
    a, c = first.tracker_map.frames[-1], resumed.tracker_map.frames[-1]
    assert a.t == c.t == float(ts[k]) and a.n_keypoints() == c.n_keypoints() == len(vis)
    np.testing.assert_array_equal(a.bearings, c.bearings)
    np.testing.assert_array_equal(a.imu_t, c.imu_t)


def jax_config() -> JConfig:
    return JConfig(**convert.config_to_dict(make_config()))


def window_positions(pipe):
    """(t, p) of every frame of the final window, keyframes and
    subframes (the JAX package's deferred subframe write-back landed
    first: its reported latest state lags one subframe behind)."""
    swt = pipe.swt
    if hasattr(swt, "materialize_pending"):
        swt.materialize_pending()
    return [(float(f.t), np.asarray(f.p).copy()) for f in swt.map.all_frames()]


def jax_checkpoint_run(ckpt_path: str):
    """The JAX package: drive to the cut, save to `ckpt_path`, load it
    into a fresh pipeline and finish. Returns (the final window's (t, p),
    the saved tracker's hint -> track map)."""
    cfg = jax_config()
    inputs = scene_inputs(make_config())
    first = JVIOPipeline(cfg, JSyntheticTracker())
    drive(first, inputs, 0, CUT)
    jck.save_pipeline(ckpt_path, first)
    tracker = JSyntheticTracker()
    tracker._id_map = dict(first.tracker._id_map)
    resumed = jck.load_pipeline(ckpt_path, cfg, tracker)
    drive(resumed, inputs, CUT, N_FRAMES)
    return window_positions(resumed), dict(first.tracker._id_map)


def write_jax_files(ckpt_path: str = JAX_CKPT, tail_path: str = JAX_TAIL) -> None:
    window, id_map = jax_checkpoint_run(ckpt_path)
    hints = np.array(sorted(id_map), dtype=np.int64)
    np.savez(tail_path, t=np.array([t for t, _ in window]),
             p=np.stack([p for _, p in window]), hints=hints,
             track_ids=np.array([id_map[h] for h in hints], dtype=np.int64))


def port_finishes(ckpt_path: str, tail_path: str):
    """The port loads the JAX checkpoint and finishes the drive; returns
    the JAX package's final window and the port's, as (t, p) lists."""
    ref = np.load(tail_path)
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = dict(zip(ref["hints"].tolist(), ref["track_ids"].tolist()))
    pipe = ck.load_pipeline(ckpt_path, make_config(), tracker, device="cpu")
    assert pipe.swt is not None and pipe.initializer is None
    drive(pipe, scene_inputs(make_config()), CUT, N_FRAMES)
    return list(zip(ref["t"].tolist(), ref["p"])), window_positions(pipe)


def test_jax_checkpoint_finished_by_port():
    assert_trees_equal(ck.load_tree(JAX_CKPT), jck.load_tree(JAX_CKPT))
    jax_window, port_window = port_finishes(JAX_CKPT, JAX_TAIL)
    assert max(t for t, _ in jax_window) == pytest.approx(1.95)
    assert tail_error(jax_window, port_window, -np.inf) < TAIL_TOL_M


@pytest.mark.slow
def test_committed_jax_files_match_fresh_jax_run(tmp_path):
    ckpt, tail = str(tmp_path / "ckpt.npz"), str(tmp_path / "tail.npz")
    write_jax_files(ckpt, tail)
    fresh, committed = np.load(tail), np.load(JAX_TAIL)
    np.testing.assert_array_equal(fresh["t"], committed["t"])
    np.testing.assert_allclose(fresh["p"], committed["p"], rtol=0, atol=1e-12)
    jax_window, port_window = port_finishes(ckpt, tail)
    assert tail_error(jax_window, port_window, -np.inf) < TAIL_TOL_M


if __name__ == "__main__" and "--write" in sys.argv:
    write_jax_files()
    print("wrote", JAX_CKPT, JAX_TAIL)
