"""IMU preintegration with 15×15 covariance propagation and bias
Jacobians (port of `xrslam_tpu/imu/preintegration.py`).

Error-state order (q, p, v, bg, ba) at offsets (0, 3, 6, 9, 12).
Sample buffers have a fixed capacity padded with dt == 0 entries. Every
function takes leading batch dimensions, so one call integrates all of
a window's intervals at once.

`integrate_batch` is kernel K4 of the port (csrc/preint_scan.cu): the
JAX `lax.scan` over the samples is `integrate_batch_plain`, a Python
loop that stops after the last valid sample of the batch (later padded
steps keep dt = 0), taken for CPU tensors; `integrate_batch_cuda` runs
the same recurrence for CUDA tensors in one launch a call and raises on
what the kernel does not take.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import lie
from ..kernels import build as kbuild

GRAVITY_NOMINAL = 9.80665
GRAVITY = np.array([0.0, 0.0, -GRAVITY_NOMINAL])

ES_Q, ES_P, ES_V, ES_BG, ES_BA, ES_SIZE = 0, 3, 6, 9, 12, 15


class PreintDelta(NamedTuple):
    """Preintegrated IMU delta between two frames; every field
    broadcasts over leading batch dims."""

    t: torch.Tensor        # () total integration time
    q: torch.Tensor        # (4,) Δq [w,x,y,z]
    p: torch.Tensor        # (3,)
    v: torch.Tensor        # (3,)
    cov: torch.Tensor      # (15,15) error-state covariance (q,p,v,bg,ba)
    sqrt_inv_cov: torch.Tensor  # (15,15) U with UᵀU = cov⁻¹
    dq_dbg: torch.Tensor   # (3,3)
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float64,
                 device=None) -> "PreintDelta":
        b = tuple(batch_shape)

        def z(*s):
            return torch.zeros(b + s, dtype=dtype, device=device)

        return PreintDelta(
            t=z(), q=lie.quat_identity(b, dtype=dtype, device=device),
            p=z(3), v=z(3), cov=z(15, 15), sqrt_inv_cov=z(15, 15),
            dq_dbg=z(3, 3), dp_dbg=z(3, 3), dp_dba=z(3, 3), dv_dbg=z(3, 3),
            dv_dba=z(3, 3))


class ImuNoise(NamedTuple):
    """Continuous-time noise covariances (3×3 each)."""

    cov_w: torch.Tensor
    cov_a: torch.Tensor
    cov_bg: torch.Tensor
    cov_ba: torch.Tensor

    @staticmethod
    def isotropic(sigma_w2, sigma_a2, sigma_bg2, sigma_ba2,
                  dtype=torch.float64, device=None) -> "ImuNoise":
        eye = torch.eye(3, dtype=dtype, device=device)
        return ImuNoise(sigma_w2 * eye, sigma_a2 * eye, sigma_bg2 * eye,
                        sigma_ba2 * eye)

    @staticmethod
    def from_config(config, dtype=torch.float64, device=None) -> "ImuNoise":
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        return ImuNoise(t(config.gyroscope_noise_cov),
                        t(config.accelerometer_noise_cov),
                        t(config.gyroscope_bias_noise_cov),
                        t(config.accelerometer_bias_noise_cov))


def _increment(delta: PreintDelta, dt, w_raw, a_raw, bg, ba,
               noise: ImuNoise) -> PreintDelta:
    """One Euler step for a batch of intervals: dt (B,), w_raw/a_raw/
    bg/ba (B,3). dt == 0 leaves the delta unchanged."""
    w = w_raw - bg
    a = a_raw - ba
    dtc = dt[..., None, None]
    dq_step = lie.expmap(w * dt[..., None])
    R_delta = lie.quat_to_matrix(delta.q)
    R_step_T = lie.quat_to_matrix(dq_step).transpose(-1, -2)
    Rhat = R_delta @ lie.hat(a)
    eye3 = torch.eye(3, dtype=delta.cov.dtype, device=delta.cov.device)
    Jr = lie.right_jacobian(w * dt[..., None])

    B_ = dt.shape
    A = torch.zeros(B_ + (9, 9), dtype=delta.cov.dtype, device=dt.device)
    A[..., 0:3, 0:3] = R_step_T
    A[..., 3:6, 0:3] = -0.5 * dtc * dtc * Rhat
    A[..., 3:6, 3:6] = eye3
    A[..., 3:6, 6:9] = dtc * eye3
    A[..., 6:9, 0:3] = -dtc * Rhat
    A[..., 6:9, 6:9] = eye3

    Bm = torch.zeros(B_ + (9, 6), dtype=delta.cov.dtype, device=dt.device)
    Bm[..., 0:3, 0:3] = dtc * Jr
    Bm[..., 3:6, 3:6] = 0.5 * dtc * dtc * R_delta
    Bm[..., 6:9, 3:6] = dtc * R_delta

    inv_dt = (1.0 / torch.clamp(dt, min=1.0e-7))[..., None, None]
    W = torch.zeros(B_ + (6, 6), dtype=delta.cov.dtype, device=dt.device)
    W[..., 0:3, 0:3] = noise.cov_w * inv_dt
    W[..., 3:6, 3:6] = noise.cov_a * inv_dt

    At = A.transpose(-1, -2)
    cov = delta.cov.clone()
    cov[..., :9, :9] = A @ delta.cov[..., :9, :9] @ At \
        + Bm @ W @ Bm.transpose(-1, -2)
    cov[..., 9:12, 9:12] += noise.cov_bg * dtc
    cov[..., 12:15, 12:15] += noise.cov_ba * dtc

    dp_dbg = delta.dp_dbg + dtc * delta.dv_dbg \
        - 0.5 * dtc * dtc * Rhat @ delta.dq_dbg
    dp_dba = delta.dp_dba + dtc * delta.dv_dba - 0.5 * dtc * dtc * R_delta
    dv_dbg = delta.dv_dbg - dtc * Rhat @ delta.dq_dbg
    dv_dba = delta.dv_dba - dtc * R_delta
    dq_dbg = R_step_T @ delta.dq_dbg - dtc * Jr

    a_world = lie.quat_rotate(delta.q, a)
    dtv = dt[..., None]
    p = delta.p + dtv * delta.v + 0.5 * dtv * dtv * a_world
    v = delta.v + dtv * a_world
    q = lie.quat_normalize(lie.quat_mul(delta.q, dq_step))
    return delta._replace(t=delta.t + dt, q=q, p=p, v=v, cov=cov,
                          dq_dbg=dq_dbg, dp_dbg=dp_dbg, dp_dba=dp_dba,
                          dv_dbg=dv_dbg, dv_dba=dv_dba)


def sample_dts(ts: torch.Tensor, t_end, count) -> torch.Tensor:
    """Per-sample spans (...,N): sample i covers [t_i, t_{i+1}), the
    last valid sample runs to t_end; samples >= count get dt = 0."""
    n = ts.shape[-1]
    idx = torch.arange(n, device=ts.device)
    t_next = torch.cat([ts[..., 1:], ts[..., -1:]], dim=-1)
    count = torch.as_tensor(count, device=ts.device)[..., None]
    t_end = torch.as_tensor(t_end, dtype=ts.dtype, device=ts.device)[..., None]
    dts = torch.where(idx == count - 1, t_end - ts, t_next - ts)
    return torch.where(idx < count, torch.clamp(dts, min=0.0), 0.0)


def integrate_batch_plain(ts, ws, accs, t_end, bg, ba, noise: ImuNoise, count,
                          compute_sqrt_inv: bool = True,
                          steps: Optional[int] = None) -> PreintDelta:
    """K4 in plain PyTorch: integrate K fixed-capacity buffers at once:
    ts (K,S), ws/accs (K,S,3), t_end (K,), bg/ba (K,3), count (K,).
    `steps` bounds the loop (default: the largest count, read once from
    `count`)."""
    dts = sample_dts(ts, t_end, count)
    if steps is None:
        steps = int(torch.as_tensor(count).max()) if ts.shape[-1] else 0
    delta = PreintDelta.identity(ts.shape[:-1], dtype=ws.dtype,
                                 device=ws.device)
    for s in range(min(steps, ts.shape[-1])):
        delta = _increment(delta, dts[..., s], ws[..., s, :], accs[..., s, :],
                           bg, ba, noise)
    if compute_sqrt_inv:
        ok = (torch.as_tensor(count, device=ws.device) > 0)[..., None, None]
        delta = delta._replace(sqrt_inv_cov=torch.where(
            ok, sqrt_inv_from_cov(delta.cov), 0.0))
    return delta


# an interval's fields in the kernel's output, in PreintDelta's order
_FIELD_SHAPES = ((), (4,), (3,), (3,), (15, 15), (15, 15),
                 (3, 3), (3, 3), (3, 3), (3, 3), (3, 3))


def integrate_batch_cuda(ts, ws, accs, t_end, bg, ba, noise: ImuNoise, count,
                         compute_sqrt_inv: bool = True,
                         steps: Optional[int] = None) -> PreintDelta:
    """K4 on the card: `integrate_batch_plain`'s recurrence for every
    interval of the batch (any leading dimensions) in one launch; the
    square-root information after it in PyTorch. `count` is an int64
    tensor on the card."""
    batch, S = tuple(ts.shape[:-1]), ts.shape[-1]
    dt, dev = ws.dtype, ws.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"preint_scan kernel takes float32/float64, got {dt}")
    if dev.type != "cuda":
        raise ValueError(f"the preint_scan kernel's tensors must be on a CUDA "
                         f"device, got {dev}")
    if steps is None:
        steps = int(torch.as_tensor(count).max()) if S else 0
    steps = max(0, min(int(steps), S))
    args = [kbuild.check_arg(name, x, shape, dt, dev) for name, x, shape in (
        ("ts", ts, batch + (S,)), ("ws", ws, batch + (S, 3)),
        ("accs", accs, batch + (S, 3)), ("t_end", t_end, batch),
        ("bg", bg, batch + (3,)), ("ba", ba, batch + (3,)))]
    args.append(kbuild.check_arg("count", count, batch, torch.int64, dev))
    args += [kbuild.check_arg(f"noise.{name}", x, (3, 3), dt, dev)
             for name, x in zip(noise._fields, noise)]
    N = int(torch.Size(batch).numel())
    sizes = [N * int(torch.Size(s).numel()) for s in _FIELD_SHAPES]
    out = torch.empty((sum(sizes),), dtype=dt, device=dev)
    if N:
        err = kbuild.PREINT_SCAN.fn()(
            *(x.data_ptr() for x in args), out.data_ptr(), N, S, steps,
            1 if dt == torch.float64 else 0, torch.cuda.current_stream(dev).cuda_stream)
        kbuild.check(err, "integrate_batch")
        kbuild.PREINT_SCAN.count(windows=N)
    delta = PreintDelta(*(x.view(batch + s) for x, s in
                          zip(torch.split(out, sizes), _FIELD_SHAPES)))
    if compute_sqrt_inv:
        ok = (args[6] > 0)[..., None, None]
        delta = delta._replace(sqrt_inv_cov=torch.where(
            ok, sqrt_inv_from_cov(delta.cov), 0.0))
    return delta


def integrate_batch(ts, ws, accs, t_end, bg, ba, noise: ImuNoise, count,
                    compute_sqrt_inv: bool = True,
                    steps: Optional[int] = None) -> PreintDelta:
    """K4 (`integrate_batch_plain`'s arguments and result): the plain
    loop for CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = kbuild.dispatch(ws, "integrate_batch", integrate_batch_cuda,
                         integrate_batch_plain)
    return fn(ts, ws, accs, t_end, bg, ba, noise, count,
              compute_sqrt_inv=compute_sqrt_inv, steps=steps)


def integrate(ts, ws, accs, t_end, bg, ba, noise: ImuNoise, count=None,
              compute_sqrt_inv: bool = True) -> PreintDelta:
    """Integrate one buffer (ts (N,), ws/accs (N,3)) into a delta."""
    n = ts.shape[0]
    count = n if count is None else int(count)
    d = integrate_batch(ts[None], ws[None], accs[None],
                        torch.as_tensor(t_end, dtype=ts.dtype,
                                        device=ts.device)[None],
                        bg[None], ba[None], noise,
                        torch.tensor([count], device=ts.device),
                        compute_sqrt_inv=False, steps=count)
    d = PreintDelta(*(x[0] for x in d))
    if compute_sqrt_inv:
        d = d._replace(sqrt_inv_cov=sqrt_inv_from_cov(d.cov))
    return d


def sqrt_inv_from_cov(cov: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """U = chol(cov⁻¹)ᵀ, upper triangular with UᵀU = cov⁻¹. A singular
    covariance gives a non-finite U (as in the JAX package), never an
    exception or a host sync."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    inv, _ = torch.linalg.inv_ex(cov + eps * eye)
    inv = 0.5 * (inv + inv.transpose(-1, -2))
    L, info = torch.linalg.cholesky_ex(inv)
    L = torch.where((info == 0)[..., None, None], L, float("nan"))
    return L.transpose(-1, -2)


def predict(pose_q, pose_p, v, bg, ba, delta: PreintDelta):
    """Gravity-forward prediction of the next frame's pose/motion.
    Returns (q_new, p_new, v_new, bg, ba)."""
    g = torch.as_tensor(GRAVITY, dtype=pose_p.dtype, device=pose_p.device)
    dt = delta.t[..., None]
    v_new = v + g * dt + lie.quat_rotate(pose_q, delta.v)
    p_new = pose_p + 0.5 * g * dt * dt + v * dt \
        + lie.quat_rotate(pose_q, delta.p)
    q_new = lie.quat_mul(pose_q, delta.q)
    return q_new, p_new, v_new, bg, ba
