"""The dynamic-object scene, fed to the pipeline as bearings: a wave
trajectory over 96 static landmarks plus an 80-point rigidly-moving
object (`io.synthetic.moving_object`), with 0.5 px observation noise,
through `VIOPipeline.track_camera` and the `SyntheticTracker`. This is
the scene of the JAX package's `test_dynamic_object_parsac_e2e`, with
its config, noise draw and criteria.

    scene = object_scene()
    cfg = object_config(scene, parsac_flag=True)
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    est_t, est_p = drive(pipe, scene)
    print(scene_ate(scene, est_t, est_p), object_verdict(pipe, scene))
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..eval.trajectory import ate_rmse
from ..geometry import lie
from ..io.synthetic import (bearings_of_points, euler_consistent, moving_object,
                            wave_scene)

N_STATIC = 96
N_OBJECT = 80


def base_config(**kw) -> Config:
    """The bearing-fed e2e tests' config: focal 450 on a 752x480 grid,
    the camera looking along body +y with a small lever arm."""
    f = 450.0
    q_bc = lie.expmap(torch.tensor([-np.pi / 2, 0.0, 0.0], dtype=torch.float64)).numpy()
    defaults = dict(
        camera_intrinsic=np.array([[f, 0.0, 376.0], [0.0, f, 240.0], [0.0, 0.0, 1.0]]),
        camera_to_body_rotation=q_bc,
        camera_to_body_translation=np.array([0.02, -0.01, 0.03]),
        initializer_keyframe_gap=2, initializer_min_matches=30,
        initializer_min_triangulation=30, initializer_min_landmarks=20,
        window_landmark_slots=96, init_landmark_slots=96,
        sliding_window_force_keyframe_landmarks=20)
    defaults.update(kw)
    return Config(**defaults)


def object_scene(n_frames: int = 60, noise_px: float = 0.5,
                 noise_seed: int = 11) -> dict:
    """Returns {scene, bearings (F,L,3), mask (F,L), n_static, capacity}:
    L = 96 static landmarks then the 80 object points."""
    cfg = base_config()
    q_bc = torch.as_tensor(cfg.camera_to_body_rotation)
    p_bc = torch.as_tensor(cfg.camera_to_body_translation)
    # seed 0: the JAX package's wave_scene default, which its test takes
    scene = euler_consistent(wave_scene(n_frames=n_frames, n_landmarks=N_STATIC,
                                        seed=0))
    obj = moving_object(scene, n_points=N_OBJECT, vel=(-0.12, 0.08, 0.03),
                        omega_obj=(0.0, 0.0, 0.2))
    pts = torch.cat([scene.landmarks.expand((n_frames,) + tuple(scene.landmarks.shape)),
                     obj], dim=1)
    bearings, mask = bearings_of_points(scene.q, scene.p, pts, q_bc, p_bc)
    bearings = bearings.numpy().copy()
    rng = np.random.default_rng(noise_seed)
    nz = rng.normal(0.0, noise_px / 450.0, bearings[..., :2].shape)
    bearings[..., 0] += nz[..., 0] * bearings[..., 2]
    bearings[..., 1] += nz[..., 1] * bearings[..., 2]
    bearings /= np.linalg.norm(bearings, axis=-1, keepdims=True)
    return {"scene": scene, "bearings": bearings, "mask": mask.numpy(),
            "n_static": N_STATIC, "capacity": N_STATIC + N_OBJECT}


def object_config(scene: dict, **kw) -> Config:
    """base_config with landmark slots for every point of the scene and
    the JAX test's PARSAC settings."""
    C = scene["capacity"]
    kw = dict(dict(parsac_dynamic_probability=0.2, parsac_norm_scale=1.5,
                   window_landmark_slots=C, init_landmark_slots=C), **kw)
    return base_config(**kw)


def drive(pipe, scene: dict, max_frames=None, on_frame=None, start: int = 0):
    """Push the scene's frames `start`.. through `pipe` (a VIOPipeline
    with a SyntheticTracker): each interval's IMU samples, one sample
    just past the frame time, then the frame's bearings with the
    landmark index as the track hint. Returns (est_t, est_p (N,3)) of
    the latest optimized state on every frame while tracking; the drive
    stops before frame `max_frames`. `on_frame(k, pipe)` runs after each
    frame and may return True to stop."""
    sc = scene["scene"]
    ts = sc.t.numpy()
    imu_t, imu_w, imu_a = sc.imu_t.numpy(), sc.imu_w.numpy(), sc.imu_a.numpy()
    bearings, mask, C = scene["bearings"], scene["mask"], scene["capacity"]
    n = len(ts) if max_frames is None else min(max_frames, len(ts))
    est_t, est_p = [], []
    for k in range(start, n):
        if k > 0:
            for s in range(imu_t.shape[1]):
                t = float(imu_t[k - 1, s])
                pipe.track_gyroscope(t, imu_w[k - 1, s])
                pipe.track_accelerometer(t, imu_a[k - 1, s])
        j = min(k, len(ts) - 2)
        pipe.track_gyroscope(float(ts[k]) + 1e-6, imu_w[j, 0])
        pipe.track_accelerometer(float(ts[k]) + 1e-6, imu_a[j, 0])
        kp = np.zeros((C, 3))
        kp[:, 2] = 1.0
        hint = np.full((C,), -1, dtype=np.int64)
        vis = np.nonzero(mask[k])[0][:C]
        kp[:len(vis)] = bearings[k, vis]
        hint[:len(vis)] = vis
        pipe.track_camera(float(ts[k]), kp, hint)
        if pipe.state == "tracking":
            t, _, p, _, _, _ = pipe.swt.get_latest_state()
            est_t.append(t)
            est_p.append(p.copy())
        if on_frame is not None and on_frame(k, pipe):
            break
    return np.asarray(est_t), (np.stack(est_p) if est_p else np.zeros((0, 3)))


def scene_ate(scene: dict, est_t, est_p) -> float:
    """ATE RMSE (m, SE3 alignment) against the nearest ground-truth
    frame."""
    ts = scene["scene"].t.numpy()
    gt = scene["scene"].p.numpy()
    gt_p = np.stack([gt[int(np.argmin(np.abs(ts - t)))] for t in est_t])
    return ate_rmse(est_p, gt_p)


def object_verdict(pipe, scene: dict) -> dict:
    """Static tags in the tracker map: of the object's tracks how many
    are non-static, of the static landmarks' tracks how many are
    static."""
    n_static = scene["n_static"]
    out = {"object_nonstatic": 0, "object_total": 0, "static_static": 0,
           "static_total": 0}
    for h, tid in pipe.tracker._id_map.items():
        tr = pipe.tracker_map.tracks.get(tid)
        if tr is None:
            continue
        if h >= n_static:
            out["object_total"] += 1
            out["object_nonstatic"] += int(not tr.static)
        else:
            out["static_total"] += 1
            out["static_static"] += int(tr.static)
    return out


def criteria_failures(stats: dict, verdict: dict, ate: float) -> list:
    """The JAX e2e test's criteria that a run misses (empty when all
    hold): tracks_unstatic >= 10; more than half of the object's tracks
    non-static (of at least 10); more than 60% of the static tracks
    static (of at least 20); ATE < 0.15 m."""
    v = verdict
    bad = []
    if stats["tracks_unstatic"] < 10:
        bad.append(f"tracks_unstatic {stats['tracks_unstatic']} < 10")
    if not (v["object_total"] >= 10
            and v["object_nonstatic"] / v["object_total"] > 0.5):
        bad.append(f"object non-static {v['object_nonstatic']}/{v['object_total']}")
    if not (v["static_total"] >= 20 and v["static_static"] / v["static_total"] > 0.6):
        bad.append(f"static kept {v['static_static']}/{v['static_total']}")
    if not ate < 0.15:
        bad.append(f"ATE {ate} m >= 0.15")
    return bad
