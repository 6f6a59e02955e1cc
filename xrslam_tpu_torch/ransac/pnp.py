"""Batched PnP: the 6-point DLT minimal solver with its RANSAC / PARSAC /
IMU-PARSAC wrappers, and the pose-only robust refine of the camera-rate
visual-PnP path (port of `xrslam_tpu/ransac/pnp.py`).

The minimal solver is a DLT of the 12×12 projection-matrix system with
R re-orthonormalized by SVD. Error model: squared normalized-plane
reprojection error ‖x − hnorm(R·X + t)‖², threshold 2·5.99·σ².

Every entry takes a `torch.Generator` and optionally the minimal index
sets (`idx`, (n_hyp, 6)) to use instead of drawing them.
"""

from __future__ import annotations

import torch

from ..geometry import lie
from . import core, parsac

CHI2_2DOF = 5.99


def solve_pnp_dlt(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """T (...,4,4) with [R|t] on top from n ≥ 6 correspondences X (...,n,3)
    world → x (...,n,2) normalized image, via DLT + orthonormalization.

    The null vector's sign is arbitrary (LAPACK and cuSOLVER alike); the
    det(M) sign normalization removes it. torch has no cbrt: the scale
    is |det M|^(1/3) by `pow`, within a few ulp of a true cube root."""
    dt = X.dtype
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)   # (...,n,4)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -x[..., 0:1] * Xh], dim=-1)         # (...,n,12)
    r2 = torch.cat([z, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                              # (...,2n,12)
    _, _, vh = torch.linalg.svd(A, full_matrices=True)
    P = vh[..., -1, :].reshape(vh.shape[:-2] + (3, 4))
    det = torch.linalg.det(P[..., :3, :3])
    s = torch.sign(det) / torch.pow(torch.abs(det) + 1e-30, 1.0 / 3.0)
    P = P * s[..., None, None]
    U, sv, Vh = torch.linalg.svd(P[..., :3, :3])
    R = U @ Vh
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    t = P[..., :, 3] * 3.0 / torch.clamp(torch.sum(sv, dim=-1), min=1e-12)[..., None]
    T = torch.zeros(X.shape[:-2] + (4, 4), dtype=dt, device=X.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def pnp_reproject_error(T: torch.Tensor, X: torch.Tensor, x: torch.Tensor):
    """Squared normalized-plane reprojection errors (..., N) of poses T
    (...,4,4); points behind the camera get +inf."""
    Xc = torch.einsum("...ij,nj->...ni", T[..., :3, :3], X) + T[..., None, :3, 3]
    z = Xc[..., 2]
    proj = Xc[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)[..., None]
    err = torch.sum((x - proj) ** 2, dim=-1)
    return torch.where(z > 0, err, float("inf"))


def _solver(idx, X, x):
    return solve_pnp_dlt(X[idx], x[idx])


def find_pnp_matrix(generator, X, x, valid=None, threshold: float = 1.0,
                    n_hyp: int = 256, idx=None):
    """RANSAC PnP. Returns (T, inlier_mask, count)."""
    thr = 2.0 * CHI2_2DOF * threshold * threshold
    return core.ransac(generator, _solver, pnp_reproject_error, (X, x),
                       X.shape[0], 6, thr, n_hyp=n_hyp, valid=valid, idx=idx)


def find_pnp_matrix_parsac(generator, X, x, bin_conf, valid=None,
                           threshold: float = 1.0, norm_scale: float = 1.0,
                           n_hyp: int = 256, idx=None):
    """PARSAC PnP: spatial-bin-confidence weighted sampling + coverage
    scoring. Returns (T, inlier_mask, count, new_bin_conf)."""
    thr = 2.0 * CHI2_2DOF * threshold * threshold
    return parsac.parsac(generator, _solver, pnp_reproject_error, (X, x), x,
                         bin_conf, X.shape[0], 6, thr, valid=valid,
                         norm_scale=norm_scale, n_hyp=n_hyp, idx=idx)


def find_pnp_matrix_parsac_imu(generator, X, x, lens, prior_T, bin_conf,
                               dynamic_prob, valid=None,
                               threshold: float = 1.0,
                               norm_scale: float = 1.0, n_hyp: int = 256,
                               idx=None):
    """IMU-PARSAC PnP, the RD-VIO dynamic-outlier rejector: the
    IMU-propagated prior pose gates hypotheses by inlier overlap; track
    lengths and the dynamic probability weight the bin confidences.

    Returns (T, inlier_mask, count, new_bin_conf, ok). When the prior
    inlier set is too small (ratio < 0.15 or < 20), T is the prior pose,
    every valid point is an inlier and ok is False."""
    thr = 2.0 * CHI2_2DOF * threshold * threshold
    return parsac.imu_parsac(generator, _solver, pnp_reproject_error, (X, x),
                             x, lens, prior_T, bin_conf, dynamic_prob,
                             X.shape[0], 6, thr, valid=valid,
                             norm_scale=norm_scale, n_hyp=n_hyp, idx=idx)


def quat_rotate_inv_rows(q, v):
    """Rotate rows v (N,3) by q⁻¹ (q (4,) [w,x,y,z])."""
    return v @ lie.quat_to_matrix(q)


def refine_pose_pnp(q_wc, p_wc, X, bearings, valid, sqrt_inv_cov2,
                    iters: int = 10, damping: float = 1e-6):
    """Pose-only robust Gauss-Newton against known 3D landmarks: the
    camera-rate visual-PnP solve. For each observed unit bearing b with
    landmark X, r = W · Tb(b)ᵀ · normalize(R_wcᵀ(X − p_wc)), with Tb the
    S² tangent basis of b and W the K-scaled pixel-noise whitening; IRLS
    with Cauchy(1.0) weights; pose increment q ⊞ δθ = q·exp(δθ),
    p ⊞ δp = p + δp.

    The Jacobian is closed-form (the JAX package differentiates with
    `jax.jacfwd`): with y = R_wcᵀ(X − p_wc) and n = y/|y|, at δ = 0
    ∂y/∂δθ = [y]×, ∂y/∂δp = −R_wcᵀ, ∂n/∂y = (I − n nᵀ)/|y|.

    Args: q_wc (4,) camera-to-world [w,x,y,z]; p_wc (3,); X (N,3) world
    points; bearings (N,3) observed unit bearings (camera frame); valid
    (N,) bool; sqrt_inv_cov2 (2,2). Returns (q_wc, p_wc) refined."""
    dt = X.dtype
    # W · Tbᵀ per observation, zero rows for invalid ones: (N,2,3)
    WTb = torch.where(valid[:, None, None],
                      sqrt_inv_cov2 @ lie.s2_tangential_basis(bearings).transpose(-1, -2),
                      0.0)
    eye3 = torch.eye(3, dtype=dt, device=X.device)
    eye6 = torch.eye(6, dtype=dt, device=X.device)
    q = torch.as_tensor(q_wc, dtype=dt, device=X.device)
    p = torch.as_tensor(p_wc, dtype=dt, device=X.device)
    for _ in range(iters):
        R = lie.quat_to_matrix(q)
        y = quat_rotate_inv_rows(q, X - p)                         # (N,3)
        ny = torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
        n = y / ny
        r = torch.einsum("nij,nj->ni", WTb, n)                     # (N,2)
        dn = (eye3 - n[:, :, None] * n[:, None, :]) / ny[:, :, None]
        dy = torch.cat([lie.hat(y), -R.T.expand(y.shape[0], 3, 3)], dim=-1)   # (N,3,6)
        J = WTb @ dn @ dy                                          # (N,2,6)
        # Cauchy(1.0) IRLS weight per observation
        w = 1.0 / (1.0 + torch.sum(r * r, dim=-1))
        Jw = J * w[:, None, None]
        H = torch.einsum("nki,nkj->ij", Jw, J) + damping * eye6
        g = torch.einsum("nki,nk->i", Jw, r)
        delta = -torch.linalg.solve_ex(H, g)[0]
        q = lie.quat_normalize(lie.quat_mul(q, lie.expmap(delta[:3])))
        p = p + delta[3:]
    return q, p
