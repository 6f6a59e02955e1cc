"""The general traffic generator: one recorded camera + IMU stream,
made from a traffic file's parameters, the configuration's camera and
the run's seed.

The scene is the repository's synthetic "wave" scene, rewritten here so
that the yardstick does not depend on the program under test: the body
flies a circle of breathing radius with a modulated angular rate and a
vertical bob (so monocular visual-inertial initialization is
observable), an ideal IMU samples it, and the frame states are replaced
by the IMU dead-reckoned with the preintegrator's Euler scheme, so that
the ground truth and the IMU agree exactly. The camera looks along the
body's +y axis. The landmark field (a shell inside the circle), the
blob amplitudes and the screen-space background texture are drawn with
numpy from the seed; the trajectory, the sizes and the rates are the
same for every seed. The frames are rendered on the card in float64
and handed to the host as uint8, as a camera gives them, a chunk at a
time, so the card never holds the whole stream.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jacfwd, vmap

from . import geom

GRAVITY = 9.80665
TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load_traffic(name: str) -> dict:
    """The traffic file `traffic/<name>.json`."""
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as f:
        return json.load(f)


@dataclass
class Stream:
    """One stream, on the host. Times are seconds; frame i's IMU
    samples are imu_t[i*S:(i+1)*S], the first of them at t_cam[i]."""

    images: np.ndarray     # (F, H, W) uint8
    t_cam: np.ndarray      # (F,)
    imu_t: np.ndarray      # (F*S,)
    imu_w: np.ndarray      # (F*S, 3) body rate, rad/s
    imu_a: np.ndarray      # (F*S, 3) specific force, m/s^2
    gt_q: np.ndarray       # (F, 4) body-to-world, [w, x, y, z]
    gt_p: np.ndarray       # (F, 3)
    landmarks: np.ndarray  # (N, 3) world points, the blobs' centres
    blob_uv: np.ndarray    # (F, N, 2) blob centres in pixels (nan: not drawn)

    @property
    def samples_per_frame(self) -> int:
        return self.imu_t.shape[0] // self.t_cam.shape[0]


def camera_extrinsics(dtype=torch.float64):
    """(q_bc, p_bc) of the rendered rig: the optical axis along body
    +y, a small lever arm."""
    q_bc = geom.expmap(torch.tensor([-math.pi / 2, 0.0, 0.0], dtype=dtype))
    return q_bc, torch.tensor([0.02, -0.01, 0.03], dtype=dtype)


def _trajectory(tr: dict, n_frames: int):
    """Analytic poses at the frames and the ideal IMU at every sample."""
    R, om, h = tr["radius_m"], tr["omega_rad_s"], tr["height_m"]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float64)

    def theta(t):
        return om * t + 0.35 * torch.sin(1.9 * t)

    def p_of(t):
        r = R + 0.25 * torch.sin(1.3 * t)
        th = theta(t)
        return torch.stack([r * torch.cos(th), r * torch.sin(th),
                            h + 0.2 * torch.sin(1.7 * t)])

    def q_of(t):
        yaw = geom.expmap(ez * (theta(t) + math.pi / 2))
        wob = geom.expmap(torch.stack([0.08 * torch.sin(1.1 * t),
                                       0.06 * torch.sin(0.9 * t + 1.0),
                                       torch.zeros((), dtype=t.dtype)]))
        return geom.qmul(yaw, wob)

    v_of = jacfwd(p_of)
    a_of = jacfwd(v_of)
    dq_of = jacfwd(q_of)

    def imu(t):
        q = q_of(t)
        w = 2.0 * geom.qmul(geom.qconj(q), dq_of(t))[1:]
        return w, geom.rotate_inv(q, a_of(t) - g)

    S = int(round(tr["imu_hz"] / tr["cam_hz"]))
    ts = torch.arange(n_frames, dtype=torch.float64) / tr["cam_hz"]
    imu_t = (ts[:, None] + torch.arange(S, dtype=torch.float64)[None] / tr["imu_hz"])
    w, a = vmap(imu)(imu_t.reshape(-1))
    return ts, vmap(q_of)(ts), vmap(p_of)(ts), vmap(v_of)(ts), imu_t, w, a


def _dead_reckon(q0, p0, v0, ts, imu_t, w, a):
    """Frame states from the IMU by the preintegrator's Euler scheme:
    each interval's delta from its samples (per sample: position, then
    velocity, then orientation), then the frames one after another with
    gravity added per interval."""
    F, S = imu_t.shape
    w = w.reshape(F, S, 3)[:-1]
    a = a.reshape(F, S, 3)[:-1]
    t_next = torch.cat([imu_t[:-1, 1:], ts[1:, None]], dim=1)
    dts = t_next - imu_t[:-1]
    dq = torch.zeros((F - 1, 4), dtype=torch.float64)
    dq[:, 0] = 1.0
    dp = torch.zeros((F - 1, 3), dtype=torch.float64)
    dv = torch.zeros((F - 1, 3), dtype=torch.float64)
    for s in range(S):
        dt = dts[:, s, None]
        aw = geom.rotate(dq, a[:, s])
        dp = dp + dt * dv + 0.5 * dt * dt * aw
        dv = dv + dt * aw
        dq = geom.qnormalize(geom.qmul(dq, geom.expmap(w[:, s] * dt)))
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float64)
    T = (ts[1:] - ts[:-1]).tolist()
    qs, ps = [q0], [p0]
    q, p, v = q0, p0, v0
    for k in range(F - 1):
        R = geom.qmatrix(q)
        p = p + 0.5 * g * T[k] * T[k] + v * T[k] + R @ dp[k]
        v = v + g * T[k] + R @ dv[k]
        q = geom.qmul(q, dq[k])
        qs.append(q)
        ps.append(p)
    return torch.stack(qs), torch.stack(ps)


def _background(rng, tr: dict, W: int, H: int, device) -> torch.Tensor:
    """A low-contrast screen-space texture: a random grid of cells,
    box-filtered `bg_passes` times along each axis."""
    c = tr["bg_cell_px"]
    bg = rng.uniform(0, 1, (H // c + 1, W // c + 1))
    bg = torch.from_numpy(np.kron(bg, np.ones((c, c)))[:H, :W]).to(device)
    k = tr["bg_box_px"]
    box = torch.full((1, 1, k), 1.0 / k, dtype=torch.float64, device=device)
    for _ in range(tr["bg_passes"]):
        bg = torch.nn.functional.conv1d(bg[:, None], box, padding=k // 2)[:, 0]
        bg = torch.nn.functional.conv1d(bg.T[:, None], box, padding=k // 2)[:, 0].T
    return bg * tr["bg_gain"] + tr["bg_offset"]


def _render(qs, ps, lms, amps, bg, K, tr: dict, chunk: int = 32):
    """Blob frames (F, H, W) uint8, rendered on the card `chunk` frames
    at a time and each chunk handed to the host, and the drawn blob
    centres (F, N, 2): each visible landmark adds a Gaussian blob of
    `blob_sigma_px` over the (2r+1)^2 pixels around its truncated pixel
    position, on top of the background."""
    dev = bg.device
    H, W = bg.shape
    r = tr["blob_radius_px"]
    sig2 = 2.0 * tr["blob_sigma_px"] ** 2
    q_bc, p_bc = (x.to(dev) for x in camera_extrinsics())
    off = torch.arange(-r, r + 1, device=dev, dtype=torch.float64)
    F = qs.shape[0]
    images = np.empty((F, H, W), dtype=np.uint8)
    uv_all = torch.empty((F, lms.shape[0], 2), dtype=torch.float64, device=dev)
    for f0 in range(0, F, chunk):
        q_wc = geom.qmul(qs[f0:f0 + chunk], q_bc)
        p_wc = ps[f0:f0 + chunk] + geom.rotate(qs[f0:f0 + chunk], p_bc)
        n = q_wc.shape[0]
        Xc = geom.rotate_inv(q_wc[:, None], lms[None] - p_wc[:, None])  # (n,N,3)
        z = Xc[..., 2]
        u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
        v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
        drawn = (z > tr["min_depth_m"]) & (u >= -r) & (u < W + r) & (v >= -r) & (v < H + r)
        uv_all[f0:f0 + n] = torch.where(drawn[..., None], torch.stack([u, v], -1),
                                        float("nan"))
        fi, li = torch.nonzero(drawn, as_tuple=True)
        uu, vv = u[fi, li], v[fi, li]
        xs = torch.trunc(uu)[:, None, None] + off[None, None, :]     # (B,1,2r+1)
        ys = torch.trunc(vv)[:, None, None] + off[None, :, None]     # (B,2r+1,1)
        val = amps[li][:, None, None] * torch.exp(
            -((xs - uu[:, None, None]) ** 2 + (ys - vv[:, None, None]) ** 2) / sig2)
        inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        flat = (fi[:, None, None] * H + ys.clamp(0, H - 1).long()) * W \
            + xs.clamp(0, W - 1).long()
        flat, val = torch.broadcast_tensors(flat, torch.where(inside, val, 0.0))
        img = bg.expand(n, H, W).reshape(-1).clone()
        img.index_put_((flat.reshape(-1),), val.reshape(-1), accumulate=True)
        images[f0:f0 + n] = (img.view(n, H, W).clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    return images, uv_all


def make_stream(traffic: dict, config, seed: int, n_frames: int, device) -> Stream:
    """The stream of `n_frames` frames for `config`'s camera (its
    resolution and intrinsics) from `seed`."""
    W, H = (int(x) for x in config.camera_resolution)
    K = torch.as_tensor(np.asarray(config.camera_intrinsic), dtype=torch.float64,
                        device=device)
    rng = np.random.default_rng(seed)
    ts, q_a, p_a, v_a, imu_t, w, a = _trajectory(traffic, n_frames)
    qs, ps = _dead_reckon(q_a[0], p_a[0], v_a[0], ts, imu_t, w, a)

    n = traffic["landmarks"]
    R = traffic["radius_m"]
    lo, hi = traffic["landmark_shell"]
    z0, z1 = traffic["landmark_z_m"]
    r_lm = rng.uniform(lo * R, hi * R, n)
    th_lm = rng.uniform(0.0, 2 * np.pi, n)
    z_lm = rng.uniform(z0, z1, n)
    lms = np.stack([r_lm * np.cos(th_lm), r_lm * np.sin(th_lm), z_lm], axis=-1)
    a0, a1 = traffic["blob_amplitude"]
    amps = rng.uniform(a0, a1, n) * rng.choice([-1.0, 1.0], n)
    bg = _background(rng, traffic, W, H, device)

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)     # the same seed, the same pixels
    try:
        images, uv = _render(qs.to(device), ps.to(device),
                             torch.from_numpy(lms).to(device),
                             torch.from_numpy(amps).to(device), bg, K, traffic)
    finally:
        torch.use_deterministic_algorithms(prev)
    return Stream(images=images, t_cam=ts.numpy(),
                  imu_t=imu_t.reshape(-1).numpy(), imu_w=w.numpy(), imu_a=a.numpy(),
                  gt_q=qs.numpy(), gt_p=ps.numpy(), landmarks=lms,
                  blob_uv=uv.cpu().numpy())
