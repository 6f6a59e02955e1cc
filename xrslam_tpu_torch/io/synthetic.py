"""Synthetic VIO scene: smooth analytic trajectory, landmark cloud and
ideal IMU (port of `wave_scene` and `euler_consistent` from
`xrslam_tpu/io/synthetic.py`), and `reproj_window`, a seeded window for
the reprojection factors alone.

Velocity, acceleration and body rate come from `torch.func.jacfwd` of
the analytic pose, as the JAX package takes them from `jax.jacfwd`.
The landmarks of the JAX scene are drawn with `jax.random`, which torch
cannot reproduce: `wave_scene` takes them as `landmarks=`, and the
default scene (seed 3, 500 landmarks) reads the draw committed in
`io/data/wave_seed3_l500.npy`.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry import lie
from ..imu import preintegration as pre

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEFAULT_LANDMARKS = {(3, 500): "wave_seed3_l500.npy"}


class Scene(NamedTuple):
    """Ground truth sampled at camera rate."""

    t: torch.Tensor          # (F,) frame timestamps
    q: torch.Tensor          # (F,4) body-to-world
    p: torch.Tensor          # (F,3)
    v: torch.Tensor          # (F,3)
    landmarks: torch.Tensor  # (L,3) world points
    imu_t: torch.Tensor      # (F,S) per-interval IMU stamps
    imu_w: torch.Tensor      # (F,S,3) gyro (body)
    imu_a: torch.Tensor      # (F,S,3) accel (body, includes -gravity)


def committed_landmarks(seed: int, n_landmarks: int) -> np.ndarray:
    """The JAX package's landmark draw for (seed, n_landmarks), read
    from io/data; raises for a draw that is not committed."""
    name = DEFAULT_LANDMARKS.get((seed, n_landmarks))
    if name is None:
        raise ValueError(f"no committed landmark draw for seed={seed}, "
                         f"n_landmarks={n_landmarks}: pass landmarks=")
    return np.load(os.path.join(DATA_DIR, name))


def wave_scene(n_frames: int = 60, n_landmarks: int = 500, cam_hz: float = 20.0,
               imu_hz: float = 200.0, radius: float = 3.0, omega: float = 0.25,
               height: float = 1.5, seed: int = 3, pause=None, landmarks=None,
               dtype=torch.float64) -> Scene:
    """Excitation-rich trajectory: a circle with modulated angular rate,
    breathing radius and vertical bobbing (monocular VI initialization
    is observable). `pause=(t_center, width)` inserts a pure-rotation
    segment via an erf time warp of the position."""
    g = torch.tensor([0.0, 0.0, -pre.GRAVITY_NOMINAL], dtype=dtype)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype)

    if pause is not None:
        t_c, w_p = pause
        c_p = w_p * math.sqrt(math.pi) / 2.0

        def gamma(t):
            return t - c_p * (torch.special.erf((t - t_c) / w_p)
                              + math.erf(t_c / w_p))
    else:
        def gamma(t):
            return t

    def theta(t):
        return omega * t + 0.35 * torch.sin(1.9 * t)

    def p_of(t):
        tt = gamma(t)
        th = theta(tt)
        r = radius + 0.25 * torch.sin(1.3 * tt)
        return torch.stack([r * torch.cos(th), r * torch.sin(th),
                            height + 0.2 * torch.sin(1.7 * tt)])

    def q_of(t):
        yaw = lie.expmap(ez * (theta(t) + math.pi / 2))
        wob = lie.expmap(torch.stack([0.08 * torch.sin(1.1 * t),
                                      0.06 * torch.sin(0.9 * t + 1.0),
                                      torch.zeros((), dtype=dtype)]))
        return lie.quat_mul(yaw, wob)

    v_of = jacfwd(p_of)
    a_of = jacfwd(v_of)
    dq_of = jacfwd(q_of)

    def imu(t):
        q = q_of(t)
        a_b = lie.quat_rotate_inv(q, a_of(t) - g)
        wq = 2.0 * lie.quat_mul(lie.quat_conj(q), dq_of(t))
        return wq[1:4], a_b

    ts = torch.arange(n_frames, dtype=dtype) / cam_hz
    qs, ps, vs = vmap(q_of)(ts), vmap(p_of)(ts), vmap(v_of)(ts)
    spf = int(imu_hz / cam_hz)
    imu_t = ts[:, None] + torch.arange(spf, dtype=dtype)[None, :] / imu_hz
    imu_w, imu_a = vmap(vmap(imu))(imu_t)
    if landmarks is None:
        landmarks = committed_landmarks(seed, n_landmarks)
    landmarks = torch.as_tensor(np.asarray(landmarks), dtype=dtype)
    return Scene(t=ts, q=qs, p=ps, v=vs, landmarks=landmarks, imu_t=imu_t,
                 imu_w=imu_w, imu_a=imu_a)


def euler_consistent(scene: Scene, noise=None) -> Scene:
    """Replace the analytic frame states by dead-reckoned ones (the
    preintegrator's Euler scheme), so preintegration residuals are
    exactly zero at the returned states."""
    dt = scene.p.dtype
    noise = noise or pre.ImuNoise.isotropic(1e-4, 1e-2, 1e-8, 1e-6, dtype=dt)
    zero = torch.zeros(3, dtype=dt)
    q, p, v = scene.q[0], scene.p[0], scene.v[0]
    qs, ps, vs = [q], [p], [v]
    for k in range(scene.t.shape[0] - 1):
        d = pre.integrate(scene.imu_t[k], scene.imu_w[k], scene.imu_a[k],
                          scene.t[k + 1], zero, zero, noise,
                          compute_sqrt_inv=False)
        q, p, v, _, _ = pre.predict(q, p, v, zero, zero, d)
        qs.append(q)
        ps.append(p)
        vs.append(v)
    return scene._replace(q=torch.stack(qs), p=torch.stack(ps), v=torch.stack(vs))


def reproj_window(K: int, L: int, seed: int = 0, n_guard: int = 0,
                  dtype=torch.float64, device=None):
    """A numpy-seeded (WindowState, WindowData) that exercises every
    branch of the reprojection factors: K cameras along a line looking
    at L points 3-8 m ahead, ~15% of the observations missing (their
    bearings hold garbage), ~1/4 of the landmarks masked out, a few
    held fixed, landmark l < K anchored at frame l and the rest at a
    random observing frame, per-frame extrinsics and a non-diagonal
    `sqrt_inv_cov2`, and a state perturbed off the truth. The first
    `n_guard` valid landmarks get inverse depth 0 (the 1e-12 guard).
    Preintegration and the prior are left empty."""
    from ..estimation.window import WindowData, WindowState

    rng = np.random.default_rng(seed)

    def expmap(w):
        return lie.expmap(torch.as_tensor(w, dtype=torch.float64)).numpy()

    def rotate(q, v, inverse=False):
        fn = lie.quat_rotate_inv if inverse else lie.quat_rotate
        return fn(torch.as_tensor(q), torch.as_tensor(v)).numpy()

    q = expmap(rng.normal(0, 0.08, (K, 3)))
    p = np.stack([0.15 * np.arange(K), np.zeros(K), np.zeros(K)], 1) \
        + rng.normal(0, 0.05, (K, 3))
    q_bc = expmap(np.array([0.02, -0.01, 0.03]) + rng.normal(0, 0.01, (K, 3)))
    p_bc = np.array([0.02, -0.01, 0.03]) + rng.normal(0, 0.005, (K, 3))
    X = rng.uniform([-2.0, -2.0, 3.0], [2.0 + 0.15 * K, 2.0, 8.0], (L, 3))
    x_b = rotate(q[:, None], X[None] - p[:, None], inverse=True)
    x_c = rotate(q_bc[:, None], x_b - p_bc[:, None], inverse=True)   # (K,L,3)
    rng_c = np.linalg.norm(x_c, axis=-1)
    b = x_c / rng_c[..., None] + rng.normal(0, 1e-3, (K, L, 3))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    obs = (rng.uniform(size=(K, L)) > 0.15) & (b[..., 2] > 0.2)
    ref = np.zeros(L, np.int32)
    for l in range(L):
        if l < K:
            obs[l, l] = True
            ref[l] = l
        elif obs[:, l].any():
            ref[l] = rng.choice(np.nonzero(obs[:, l])[0])
    lm = (obs.sum(0) >= 2) & (rng.uniform(size=L) > 0.25)
    ref = np.where(lm, ref, 0).astype(np.int32)
    b = np.where(obs[..., None], b, rng.normal(0, 1e3, (K, L, 3)))
    invd = np.where(lm, 1.0 / rng_c[ref, np.arange(L)], 0.0) \
        * (1 + rng.normal(0, 0.05, L))
    invd[np.nonzero(lm)[0][:n_guard]] = 0.0
    w2 = 458.0 * (np.eye(2) + rng.normal(0, 0.05, (K, 2, 2)))

    def T(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    q_est = lie.quat_mul(torch.as_tensor(q),
                         torch.as_tensor(expmap(rng.normal(0, 0.01, (K, 3)))))
    state = WindowState.zeros(K, L, dtype=dtype, device=device)._replace(
        q=T(q_est.numpy()), p=T(p + rng.normal(0, 0.02, (K, 3))),
        inv_depth=T(invd))
    data = WindowData.empty(K, L, dtype=dtype, device=device)._replace(
        q_bc=T(q_bc), p_bc=T(p_bc), bearings=T(b), obs_mask=T(obs, torch.bool),
        ref_idx=T(ref, torch.int32), sqrt_inv_cov2=T(w2),
        frame_mask=T(np.ones(K, bool), torch.bool),
        landmark_mask=T(lm, torch.bool),
        fix_landmark=T(rng.uniform(size=L) < 0.05, torch.bool))
    return state, data
