"""Synthetic VIO scene: smooth analytic trajectory, landmark cloud and
ideal IMU, a rigidly-moving object and the projection of both into the
camera (port of `circle_scene`, `wave_scene`, `euler_consistent`,
`moving_object`, `bearings_of_points`, `bearings_of`, `window_problem`
and `demo_window_problem` from `xrslam_tpu/io/synthetic.py`), and
`reproj_window`, a seeded window for the reprojection factors alone.

Velocity, acceleration and body rate come from `torch.func.jacfwd` of
the analytic pose, as the JAX package takes them from `jax.jacfwd`.
The landmarks and the object's points of the JAX scenes are drawn with
`jax.random`, which torch cannot reproduce: `wave_scene` and
`moving_object` take them as `landmarks=` / `local=`, and the draws the
drives use are committed in `io/data` (`wave_seed3_l500.npy`,
`wave_seed0_l96.npy`, the multi-sequence drive's `wave_seed{5,...}_l500.npy`;
`object_seed7_n80.npy`, the object's unit draw). `circle_scene` takes
its landmarks as `landmarks=` too; its committed float64 draws at seed 0
(`circle_seed0_l{24,248,376,1016,2040}.npy`) are the sizes that
`demo_window_problem` is called with by `tools/run_scaling.py` (L = 32,
256), `tools/ab_assemble.py` (L = 32, 384, 1024) and `chip_smoke.py`
(K=12, L=384 and K=32, L=2048). Every committed
draw is written from the JAX package by
`PYTHONPATH=. python tests/test_torch_convert.py --write` (wave and
object) and `PYTHONPATH=. python tests/test_torch_synthetic.py --write`
(circle).
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
from ..utils.tree import tree_map

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the bench scene, the dynamic-object scene's static landmarks and the
# multi-sequence drive's seeds (tools/multiseq.py)
DEFAULT_LANDMARKS = {(3, 500): "wave_seed3_l500.npy",
                     (0, 96): "wave_seed0_l96.npy",
                     **{(s, 500): f"wave_seed{s}_l500.npy"
                        for s in (5, 11, 32, 7, 13, 21, 29)}}
# moving_object's jax.random.uniform draw on [0, 1), keyed (seed, n_points)
DEFAULT_OBJECT_DRAWS = {(7, 80): "object_seed7_n80.npy"}
# circle_scene's float64 landmarks, keyed (seed, n_landmarks)
DEFAULT_CIRCLE_LANDMARKS = {(0, n): f"circle_seed0_l{n}.npy"
                            for n in (24, 248, 376, 1016, 2040)}


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


def _committed(table: dict, seed: int, n: int, what: str) -> np.ndarray:
    name = table.get((seed, n))
    if name is None:
        raise ValueError(f"no committed {what} draw for seed={seed}, n={n}: "
                         f"pass it in")
    return np.load(os.path.join(DATA_DIR, name))


def committed_landmarks(seed: int, n_landmarks: int) -> np.ndarray:
    """The JAX package's landmark draw for (seed, n_landmarks), read
    from io/data; raises for a draw that is not committed."""
    return _committed(DEFAULT_LANDMARKS, seed, n_landmarks, "landmark")


def circle_scene(n_frames: int = 32, n_landmarks: int = 64, cam_hz: float = 20.0,
                 imu_hz: float = 200.0, radius: float = 3.0, omega: float = 0.6,
                 height: float = 1.5, seed: int = 0, landmarks=None,
                 dtype=torch.float64) -> Scene:
    """Body flies a circle at constant angular rate, x-axis tangent,
    z-axis up; landmarks in a shell around the circle (by default the
    JAX package's float64 draw for (seed, n_landmarks), from io/data).
    A constant twist: scale and gravity are unobservable to the VI
    initializer, so this is a solver fixture, not an end-to-end scene."""
    g = torch.tensor([0.0, 0.0, -pre.GRAVITY_NOMINAL], dtype=dtype)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype)
    ts = torch.arange(n_frames, dtype=dtype) / cam_hz
    th = omega * ts
    zero = torch.zeros_like(th)
    qs = lie.expmap(ez * (th + math.pi / 2)[:, None])
    ps = torch.stack([radius * torch.cos(th), radius * torch.sin(th),
                      torch.full_like(th, height)], dim=-1)
    vs = torch.stack([-radius * omega * torch.sin(th),
                      radius * omega * torch.cos(th), zero], dim=-1)

    spf = int(imu_hz / cam_hz)
    imu_t = ts[:, None] + torch.arange(spf, dtype=dtype)[None, :] / imu_hz
    th_i = omega * imu_t
    a_w = torch.stack([-radius * omega ** 2 * torch.cos(th_i),
                       -radius * omega ** 2 * torch.sin(th_i),
                       torch.zeros_like(th_i)], dim=-1)
    q_i = lie.expmap(ez * (th_i + math.pi / 2)[..., None])
    imu_a = lie.quat_rotate_inv(q_i, a_w - g)
    imu_w = torch.tensor([0.0, 0.0, omega], dtype=dtype).expand(imu_a.shape).clone()
    if landmarks is None:
        landmarks = _committed(DEFAULT_CIRCLE_LANDMARKS, seed, n_landmarks,
                               "circle landmark")
    landmarks = torch.as_tensor(np.asarray(landmarks), dtype=dtype)
    return Scene(t=ts, q=qs, p=ps, v=vs, landmarks=landmarks, imu_t=imu_t,
                 imu_w=imu_w, imu_a=imu_a)


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


def moving_object(scene: Scene, n_points: int = 48, center=(0.8, 0.8, 1.2),
                  vel=(-0.25, 0.15, 0.05), omega_obj=(0.0, 0.0, 0.4),
                  extent: float = 0.45, seed: int = 7, local=None,
                  dtype=torch.float64) -> torch.Tensor:
    """Per-frame positions (F, n_points, 3) of a rigidly-moving object: a
    point cluster translating at `vel` and spinning at `omega_obj`, the
    dynamic-outlier scene of RD-VIO. Its tracks are consistent frame to
    frame but violate the static-world model. `local` (n_points, 3)
    gives the cluster's points; by default they are the JAX draw for
    (seed, n_points) from io/data, scaled to [-extent, extent) with the
    arithmetic of `jax.random.uniform`."""
    if local is None:
        u = torch.as_tensor(_committed(DEFAULT_OBJECT_DRAWS, seed, n_points,
                                       "object"), dtype=dtype)
        local = torch.clamp(u * (extent - (-extent)) + (-extent), min=-extent)
    local = torch.as_tensor(local, dtype=dtype)
    c0, v, w = (torch.as_tensor(a, dtype=dtype) for a in (center, vel, omega_obj))
    t = scene.t.to(dtype)
    R = lie.quat_to_matrix(lie.expmap(w[None, :] * t[:, None]))     # (F,3,3)
    return c0 + v * t[:, None, None] + torch.einsum("lj,fij->fli", local, R)


def bearings_of_points(q, p, pts, q_bc, p_bc, fov_cos: float = 0.2):
    """Project per-frame world points pts (F,L,3) into each frame's
    camera (body poses q (F,4), p (F,3); extrinsics q_bc, p_bc). Returns
    (bearings (F,L,3) unit camera-frame vectors, mask (F,L): in front of
    the camera and inside the field-of-view cone)."""
    x_b = lie.quat_rotate_inv(q[:, None, :], pts - p[:, None, :])
    x_c = lie.quat_rotate_inv(q_bc, x_b - p_bc)
    norm = torch.linalg.vector_norm(x_c, dim=-1)
    bearings = x_c / torch.clamp(norm, min=1e-12)[..., None]
    mask = (x_c[..., 2] > 0.2) & (bearings[..., 2] > fov_cos)
    return bearings, mask


def bearings_of(scene: Scene, q_bc, p_bc, frame_idx=None, fov_cos: float = 0.2):
    """Project the scene's landmarks into every (selected) frame's
    camera; returns (bearings (F,L,3), mask (F,L)) as
    `bearings_of_points`."""
    q = scene.q if frame_idx is None else scene.q[frame_idx]
    p = scene.p if frame_idx is None else scene.p[frame_idx]
    pts = scene.landmarks.expand((q.shape[0],) + tuple(scene.landmarks.shape))
    return bearings_of_points(q, p, pts, q_bc, p_bc, fov_cos)


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


def window_problem(scene: Scene, frame_idx, L: int = 64, q_bc=None, p_bc=None,
                   reproj_weight: float = 400.0, noise=None, dtype=torch.float64,
                   device=None):
    """Ground-truth (WindowState, WindowData) of the scene frames
    `frame_idx` with L landmark slots (the scene's landmarks first): each
    landmark seen in two or more of the frames is anchored at the first,
    its inverse depth the anchor camera's 1/range; the frames are
    chained by preintegration. Built on the CPU, then moved to
    `device`."""
    from ..estimation.window import MargPrior, WindowData, WindowState

    noise = noise or pre.ImuNoise.isotropic(1e-4, 1e-2, 1e-8, 1e-6, dtype=dtype)
    frame_idx = torch.as_tensor(list(frame_idx), dtype=torch.long)
    K = frame_idx.shape[0]
    q_bc = lie.quat_identity(dtype=dtype) if q_bc is None else torch.as_tensor(q_bc).to(dtype)
    p_bc = torch.zeros(3, dtype=dtype) if p_bc is None else torch.as_tensor(p_bc).to(dtype)

    bearings, mask = bearings_of(scene, q_bc, p_bc, frame_idx)
    n_lm = scene.landmarks.shape[0]
    if n_lm > L:
        raise ValueError(f"{n_lm} landmarks do not fit {L} slots")

    seen = mask.numpy()
    ref_idx = np.zeros(L, dtype=np.int32)
    lm_mask = np.zeros(L, dtype=bool)
    for l in range(n_lm):
        obs = np.nonzero(seen[:, l])[0]
        if len(obs) >= 2:
            ref_idx[l] = obs[0]
            lm_mask[l] = True

    q_w, p_w = scene.q[frame_idx], scene.p[frame_idx]
    x_b = lie.quat_rotate_inv(q_w[:, None, :], scene.landmarks[None] - p_w[:, None, :])
    x_c = lie.quat_rotate_inv(q_bc, x_b - p_bc)
    rng = torch.linalg.vector_norm(x_c, dim=-1).numpy()       # (K, n_lm)
    invd = np.zeros(L)
    for l in range(n_lm):
        if lm_mask[l]:
            invd[l] = 1.0 / float(rng[ref_idx[l], l])

    bearings_p = torch.zeros((K, L, 3), dtype=dtype)
    bearings_p[:, :n_lm] = bearings.to(dtype)
    mask_p = torch.zeros((K, L), dtype=torch.bool)
    mask_p[:, :n_lm] = mask

    zero = torch.zeros(3, dtype=dtype)
    deltas = [pre.PreintDelta.identity(dtype=dtype)]
    for j in range(1, K):
        i0, i1 = int(frame_idx[j - 1]), int(frame_idx[j])
        deltas.append(pre.integrate(
            scene.imu_t[i0:i1].reshape(-1).to(dtype),
            scene.imu_w[i0:i1].reshape(-1, 3).to(dtype),
            scene.imu_a[i0:i1].reshape(-1, 3).to(dtype),
            scene.t[i1].to(dtype), zero, zero, noise))
    preint = pre.PreintDelta(*(torch.stack(xs) for xs in zip(*deltas)))

    state = WindowState(q=scene.q[frame_idx].to(dtype), p=scene.p[frame_idx].to(dtype),
                        v=scene.v[frame_idx].to(dtype),
                        bg=torch.zeros((K, 3), dtype=dtype),
                        ba=torch.zeros((K, 3), dtype=dtype),
                        inv_depth=torch.as_tensor(invd, dtype=dtype))
    preint_mask = torch.ones((K,), dtype=torch.bool)
    preint_mask[0] = False
    data = WindowData(
        q_bc=q_bc.expand(K, 4).clone(), p_bc=p_bc.expand(K, 3).clone(),
        q_bi=lie.quat_identity((K,), dtype=dtype), p_bi=torch.zeros((K, 3), dtype=dtype),
        bearings=bearings_p, obs_mask=mask_p, ref_idx=torch.as_tensor(ref_idx),
        sqrt_inv_cov2=(reproj_weight * torch.eye(2, dtype=dtype)).expand(K, 2, 2).clone(),
        preint=preint, preint_mask=preint_mask,
        bg_lin=torch.zeros((K, 3), dtype=dtype), ba_lin=torch.zeros((K, 3), dtype=dtype),
        frame_mask=torch.ones((K,), dtype=torch.bool),
        fix_pose=torch.zeros((K,), dtype=torch.bool),
        fix_motion=torch.zeros((K,), dtype=torch.bool),
        landmark_mask=torch.as_tensor(lm_mask), fix_landmark=torch.zeros((L,), dtype=torch.bool),
        marg=MargPrior.zeros(K, L, dtype=dtype), use_marg=torch.tensor(False))
    return tree_map(lambda x: x.to(device), state), tree_map(lambda x: x.to(device), data)


def demo_window_problem(K: int, L: int, dtype=torch.float64, stride: int = 2,
                        n_lm=None, device=None):
    """The benchmark and scaling fixture: a `circle_scene` window of K
    frames `stride` apart with n_lm = L - 8 landmarks by default (a
    committed draw) and the standard camera extrinsics
    (`tools/run_scaling.py`, `chip_smoke.py`)."""
    n_lm = n_lm or (L - 8)
    scene = euler_consistent(circle_scene(n_frames=K * stride + 1, n_landmarks=n_lm,
                                          dtype=dtype))
    q_bc = lie.expmap(torch.tensor([-math.pi / 2, 0.0, 0.0], dtype=dtype))
    p_bc = torch.tensor([0.02, -0.01, 0.03], dtype=dtype)
    return window_problem(scene, range(0, K * stride, stride), L=L, q_bc=q_bc,
                          p_bc=p_bc, dtype=dtype, device=device)


def perturbed_demo_window(K: int, L: int, seed: int, device=None):
    """`demo_window_problem(K, L)` in float64, its state perturbed off
    the truth from a numpy seed (frame 0 kept; tests/helpers.perturb_state's
    scales): rotation 0.01 rad, position and velocity 0.02, biases 0.002,
    inverse depths 2%. The truth's residuals are rounding noise; these
    are O(1), so b, the cost and a solve mean something."""
    state, data = demo_window_problem(K, L)
    rng = np.random.default_rng(seed)
    keep = np.ones((K, 1))
    keep[0] = 0.0

    def d(scale):
        return torch.as_tensor(scale * rng.normal(size=(K, 3)) * keep)

    q = lie.quat_normalize(lie.quat_mul(state.q, lie.expmap(d(0.01))))
    p, v, bg, ba = (state.p + d(0.02), state.v + d(0.02), state.bg + d(0.002),
                    state.ba + d(0.002))
    invd = state.inv_depth * torch.as_tensor(1.0 + 0.02 * rng.normal(size=L))
    state = state._replace(q=q, p=p, v=v, bg=bg, ba=ba, inv_depth=invd)
    return tree_map(lambda x: x.to(device), state), tree_map(lambda x: x.to(device), data)


def scattered_slots(pyr0, pts, init, ok, seed: int = 0):
    """The chained frontend's K1 input made from a standard one (live
    slots a prefix): the slots permuted from a numpy seed, a third of them
    dead, and the dead slots holding stale positions outside the image of
    `pyr0`'s level 0 (beside it, below it, or far away) in both pts and
    init, as a chained tracker leaves them."""
    H, W = pyr0[0].shape
    rng = np.random.default_rng(seed)
    N = pts.shape[0]
    perm = torch.as_tensor(rng.permutation(N), device=pts.device)
    pts, init, ok = pts[perm].clone(), init[perm].clone(), ok[perm].clone()
    dead = torch.as_tensor(rng.permutation(N)[:N // 3], device=pts.device)
    ok[dead] = False
    stale = rng.choice([-75.0, -1.5, W + 0.5, W + 300.0, 1e5], size=(len(dead), 2))
    stale[:, 1] = np.where(stale[:, 1] > W, H + 40.0, stale[:, 1])
    pts[dead] = torch.as_tensor(stale, dtype=torch.float32, device=pts.device)
    init[dead] = pts[dead] + 3.0
    return pts.contiguous(), init.contiguous(), ok.contiguous()
