"""Factor residuals and Jacobian blocks over the window (port of
`xrslam_tpu/estimation/factors.py`).

Jacobians are exact autodiff of each residual composed with the
error-state retraction at δ = 0, `torch.func.jacrev`/`jacfwd` under
`torch.func.vmap` where the JAX package uses `jax.jacrev`/`jax.jacfwd`
under `jax.vmap`. The preintegration factor (30 inputs, 15 outputs)
uses reverse mode: PyTorch's forward mode under vmap runs several
elementwise ops through Python reference decompositions, ~10x slower
per call here. `reproj_residual_jac_closed` and
`preint_residual_jac_closed` write two of them out in closed form, the
arithmetic of kernels K2 and K3 (estimation/gram.py).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, jacrev, vmap

from ..geometry import lie
from ..imu.preintegration import GRAVITY, PreintDelta
from .window import ES_SIZE, WindowData, WindowState, state_error


def _safe_bearings(data: WindowData) -> torch.Tensor:
    """Masked observations may hold garbage: substitute unit-z so the
    masked-out math stays finite."""
    e_z = torch.zeros_like(data.bearings)
    e_z[..., 2] = 1.0
    return torch.where(data.obs_mask[..., None], data.bearings, e_z)


def _active_mask(data: WindowData) -> torch.Tensor:
    """(K,L) observation valid ∧ landmark valid ∧ not the anchor."""
    K = data.obs_mask.shape[0]
    ref = data.ref_idx.long()
    k = torch.arange(K, device=ref.device)
    return data.obs_mask & data.landmark_mask[None, :] & (k[:, None] != ref[None, :])


def _reproj_residual_core(q_tgt, p_tgt, q_ref, p_ref, inv_depth, z_ref,
                          local_tangent, q_bc_ref, p_bc_ref, q_bc_tgt,
                          p_bc_tgt, sqrt_inv_cov2):
    """2-residual bearing reprojection in the observed bearing's S²
    tangent frame (local_tangent columns [b1 b2 z_tgt])."""
    y_ref = z_ref / inv_depth
    y_ref_center = lie.quat_rotate(q_bc_ref, y_ref) + p_bc_ref
    x = lie.quat_rotate(q_ref, y_ref_center) + p_ref
    y_tgt_center = lie.quat_rotate_inv(q_tgt, x - p_tgt)
    y_tgt = lie.quat_rotate_inv(q_bc_tgt, y_tgt_center - p_bc_tgt)
    u = local_tangent.transpose(-1, -2) @ y_tgt
    r = u[:2] / u[2]
    return sqrt_inv_cov2 @ r


def reproj_residual_jac(state: WindowState, data: WindowData):
    """All (K,L) reprojection residuals + Jacobian blocks.

    Returns (r (K,L,2), J_t (K,L,2,6), J_r (K,L,2,6), J_d (K,L,2),
    m (K,L)), zeroed where the observation is inactive.
    """
    K, L = data.obs_mask.shape
    ref = data.ref_idx.long()
    bearings = _safe_bearings(data)
    invd_raw = state.inv_depth
    invd = torch.where(
        data.landmark_mask,
        torch.where(torch.abs(invd_raw) < 1e-12, 1e-12, invd_raw), 1.0)

    ar = torch.arange(L, device=ref.device)
    q_ref = state.q[ref]
    p_ref = state.p[ref]
    q_bc_ref = data.q_bc[ref]
    p_bc_ref = data.p_bc[ref]
    z_ref = bearings[ref, ar]
    b12 = lie.s2_tangential_basis(bearings)
    local_tangent = torch.cat([b12, bearings[..., None]], dim=-1)
    zero13 = torch.zeros(13, dtype=state.p.dtype, device=state.p.device)

    def obs_rj(q_t, p_t, qr, pr, d, zr, lt, qbr, pbr, qbt, pbt, w2):
        def f(dx):
            r = _reproj_residual_core(
                lie.quat_mul(q_t, lie.expmap(dx[0:3])), p_t + dx[3:6],
                lie.quat_mul(qr, lie.expmap(dx[6:9])), pr + dx[9:12],
                d + dx[12], zr, lt, qbr, pbr, qbt, pbt, w2)
            return r, r

        J, r = jacrev(f, has_aux=True)(zero13)
        return r, J

    per_lm = vmap(obs_rj, in_dims=(None, None, 0, 0, 0, 0, 0, 0, 0,
                                   None, None, None))
    per_frame = vmap(per_lm, in_dims=(0, 0, None, None, None, None, 0,
                                      None, None, 0, 0, 0))
    r, J = per_frame(state.q, state.p, q_ref, p_ref, invd, z_ref,
                     local_tangent, q_bc_ref, p_bc_ref, data.q_bc,
                     data.p_bc, data.sqrt_inv_cov2)
    m = _active_mask(data)
    mf = m.to(r.dtype)
    r = r * mf[..., None]
    J = J * mf[..., None, None]
    return r, J[..., 0:6], J[..., 6:12], J[..., 12], m


def reproj_residual_jac_closed(state: WindowState, data: WindowData):
    """`reproj_residual_jac` in closed form: the same residual and the
    chain rule of its retraction written out over the (K,L) batch, no
    `torch.func`. It is the arithmetic of the fused kernel's factor
    stage (csrc/reproj_gram.cu).

    With a = R(q_bc[ref])·z_ref/d + p_bc[ref], x = R(q_ref)·a + p_ref,
    y_c = R(q_t)ᵀ(x − p_t), y = R(q_bc[t])ᵀ(y_c − p_bc[t]), u = LTᵀ·y and
    r = W2·(u[:2]/u[2]), every Jacobian row is a rotated copy of the row
    h of ∂r/∂y (camera frame): A = R(q_bc[t])·h is the row against y_c,
    G = R(q_t)·A against x, G_r = R(q_ref)ᵀ·G against a. Then
    ∂r/∂θ_t = A × y_c, ∂r/∂p_t = −G, ∂r/∂θ_ref = −G_r × a, ∂r/∂p_ref = G
    and ∂r/∂d = −G_r·(a − p_bc[ref])/d.
    """
    L = data.obs_mask.shape[1]
    ref = data.ref_idx.long()
    bearings = _safe_bearings(data)
    invd_raw = state.inv_depth
    invd = torch.where(
        data.landmark_mask,
        torch.where(torch.abs(invd_raw) < 1e-12, 1e-12, invd_raw), 1.0)
    z_ref = bearings[ref, torch.arange(L, device=ref.device)]
    q_ref = state.q[ref]
    w = lie.quat_rotate(data.q_bc[ref], z_ref / invd[:, None])     # (L,3)
    a = w + data.p_bc[ref]
    x = lie.quat_rotate(q_ref, a) + state.p[ref]
    q_t = state.q[:, None, :]
    q_bt = data.q_bc[:, None, :]
    y_c = lie.quat_rotate_inv(q_t, x[None] - state.p[:, None, :])  # (K,L,3)
    y = lie.quat_rotate_inv(q_bt, y_c - data.p_bc[:, None, :])
    b12 = lie.s2_tangential_basis(bearings)
    b1, b2 = b12[..., 0], b12[..., 1]
    u2 = torch.sum(bearings * y, dim=-1)
    n0 = torch.sum(b1 * y, dim=-1) / u2
    n1 = torch.sum(b2 * y, dim=-1) / u2
    W = data.sqrt_inv_cov2[:, None]                                # (K,1,2,2)
    r = torch.stack([W[..., 0, 0] * n0 + W[..., 0, 1] * n1,
                     W[..., 1, 0] * n0 + W[..., 1, 1] * n1], dim=-1)
    e0 = (b1 - n0[..., None] * bearings) / u2[..., None]
    e1 = (b2 - n1[..., None] * bearings) / u2[..., None]
    h = torch.stack([W[..., 0, 0, None] * e0 + W[..., 0, 1, None] * e1,
                     W[..., 1, 0, None] * e0 + W[..., 1, 1, None] * e1],
                    dim=-2)                                        # (K,L,2,3)
    A = lie.quat_rotate(q_bt[..., None, :], h)
    G = lie.quat_rotate(q_t[..., None, :], A)
    Gr = lie.quat_rotate_inv(q_ref[None, :, None, :], G)
    Jt = torch.cat([lie.cross(A, y_c[..., None, :]), -G], dim=-1)
    Jr = torch.cat([-lie.cross(Gr, a[None, :, None, :]), G], dim=-1)
    Jd = -torch.sum(Gr * (w / invd[:, None])[None, :, None, :], dim=-1)
    m = _active_mask(data)
    mf = m.to(r.dtype)
    return (r * mf[..., None], Jt * mf[..., None, None],
            Jr * mf[..., None, None], Jd * mf[..., None], m)


def cauchy_weights(r: torch.Tensor, active: torch.Tensor):
    """IRLS weights for CauchyLoss(1.0): weight sqrt(1/(1+s)) and the
    robust cost 0.5·log(1+s) with s = ||r||²."""
    s = torch.sum(r * r, dim=-1)
    w = torch.sqrt(1.0 / (1.0 + s))
    cost = 0.5 * torch.log1p(s) * active.to(r.dtype)
    return w, cost


def _preint_residual_core(q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j,
                          ba_j, delta: PreintDelta, bg_lin, ba_lin, q_bi_i,
                          p_bi_i, q_bi_j, p_bi_j, g):
    """15-residual preintegration error weighted by the delta's sqrt
    information."""
    qi = lie.quat_mul(q_i, q_bi_i)
    pi = p_i + lie.quat_rotate(q_i, p_bi_i)
    qj = lie.quat_mul(q_j, q_bi_j)
    pj = p_j + lie.quat_rotate(q_j, p_bi_j)
    dt = delta.t
    dbg = bg_i - bg_lin
    dba = ba_i - ba_lin
    q_corr = lie.quat_mul(delta.q, lie.expmap(delta.dq_dbg @ dbg))
    r_q = lie.logmap(lie.quat_mul(lie.quat_conj(q_corr),
                                  lie.quat_mul(lie.quat_conj(qi), qj)))
    r_p = lie.quat_rotate_inv(qi, pj - pi - dt * v_i - 0.5 * dt * dt * g) - (
        delta.p + delta.dp_dbg @ dbg + delta.dp_dba @ dba)
    r_v = lie.quat_rotate_inv(qi, v_j - v_i - dt * g) - (
        delta.v + delta.dv_dbg @ dbg + delta.dv_dba @ dba)
    r = torch.cat([r_q, r_p, r_v, bg_j - bg_i, ba_j - ba_i])
    return delta.sqrt_inv_cov @ r


def preint_residual_jac(state: WindowState, data: WindowData):
    """Residuals + Jacobians of the K-1 consecutive preintegration
    factors (entry j connects j-1 → j).

    Returns (r (K,15), J_i (K,15,15), J_j (K,15,15), mask (K,)).
    """
    K = state.q.shape[0]
    dev = state.p.device
    g = torch.as_tensor(GRAVITY, dtype=state.p.dtype, device=dev)
    zero30 = torch.zeros(30, dtype=state.p.dtype, device=dev)

    def pair_rj(qi, pi, vi, bgi, bai, qj, pj, vj, bgj, baj, delta, bglin,
                balin, qbii, pbii, qbij, pbij):
        def f(dx):
            r = _preint_residual_core(
                lie.quat_mul(qi, lie.expmap(dx[0:3])), pi + dx[3:6],
                vi + dx[6:9], bgi + dx[9:12], bai + dx[12:15],
                lie.quat_mul(qj, lie.expmap(dx[15:18])), pj + dx[18:21],
                vj + dx[21:24], bgj + dx[24:27], baj + dx[27:30],
                delta, bglin, balin, qbii, pbii, qbij, pbij, g)
            return r, r

        J, r = jacrev(f, has_aux=True)(zero30)
        return r, J

    idx_j = torch.arange(K, device=dev)
    idx_i = torch.clamp(idx_j - 1, min=0)
    r, J = vmap(pair_rj)(
        state.q[idx_i], state.p[idx_i], state.v[idx_i], state.bg[idx_i],
        state.ba[idx_i], state.q, state.p, state.v, state.bg, state.ba,
        data.preint, data.bg_lin, data.ba_lin, data.q_bi[idx_i],
        data.p_bi[idx_i], data.q_bi, data.p_bi)
    m = preint_pair_mask(data)
    mf = m.to(r.dtype)
    r = r * mf[:, None]
    J = J * mf[:, None, None]
    return r, J[..., 0:15], J[..., 15:30], m


def preint_pair_mask(data: WindowData) -> torch.Tensor:
    """(..., K) the preintegration pairs that are factors: entry j > 0
    with its preintegration valid."""
    K = data.preint_mask.shape[-1]
    return data.preint_mask & (torch.arange(K, device=data.preint_mask.device) > 0)


def preint_residual_jac_closed(state: WindowState, data: WindowData):
    """`preint_residual_jac` in closed form: the same residual and the
    Jacobians of its retraction written out over the K pairs, no
    `torch.func`. It is the arithmetic of kernel K3 (csrc/preint_gram.cu).

    Pair j couples i = j-1 and j. With the IMU frames R_qi = R_i·R_bi,
    R_qj = R_j·R_bj, the bias correction φ0 = dq_dbg·(bg_i − bg_lin),
    E = q_corr*·qi*·qj and r_q = log(E): a rotation perturbation of body
    frame i is one of R_biᵀδ of the IMU frame, so
    ∂r_q/∂θ_i = −Jr⁻¹(r_q)·R_qjᵀ·R_i, ∂r_q/∂θ_j = Jr⁻¹(r_q)·R_bjᵀ and
    ∂r_q/∂bg_i = −Jr⁻¹(r_q)·R(E)ᵀ·Jr(φ0)·dq_dbg. With y_p = R_qiᵀ·a_p and
    y_v = R_qiᵀ·a_v (the bracketed vectors of r_p and r_v),
    ∂r_p/∂θ_i = [y_p]×·R_biᵀ + R_biᵀ·[p_bi,i]×, ∂r_v/∂θ_i = [y_v]×·R_biᵀ,
    ∂r_p/∂θ_j = −R_qiᵀ·R_j·[p_bi,j]×; the rest are R_qiᵀ, dt·R_qiᵀ, the
    bias Jacobians of the delta and ±I. The sqrt information multiplies
    residual and Jacobians last.
    """
    K = state.q.shape[0]
    dev, dt = state.p.device, state.p.dtype
    g = torch.as_tensor(GRAVITY, dtype=dt, device=dev)
    idx_i = torch.clamp(torch.arange(K, device=dev) - 1, min=0)
    d = data.preint
    q_i, p_i, v_i, bg_i, ba_i = (x[idx_i] for x in state[:5])
    q_bi, p_bi = data.q_bi[idx_i], data.p_bi[idx_i]
    R_i, R_j = lie.quat_to_matrix(q_i), lie.quat_to_matrix(state.q)
    R_bi, R_bj = lie.quat_to_matrix(q_bi), lie.quat_to_matrix(data.q_bi)
    qi = lie.quat_mul(q_i, q_bi)
    qj = lie.quat_mul(state.q, data.q_bi)
    R_qiT = lie.quat_to_matrix(qi).transpose(-1, -2)
    R_qjT = lie.quat_to_matrix(qj).transpose(-1, -2)
    pi = p_i + lie.quat_rotate(q_i, p_bi)
    pj = state.p + lie.quat_rotate(state.q, data.p_bi)
    t = d.t[:, None]
    dbg = (bg_i - data.bg_lin)[..., None]
    dba = (ba_i - data.ba_lin)[..., None]
    phi0 = (d.dq_dbg @ dbg)[..., 0]
    q_corr = lie.quat_mul(d.q, lie.expmap(phi0))
    E = lie.quat_mul(lie.quat_conj(q_corr), lie.quat_mul(lie.quat_conj(qi), qj))
    r_q = lie.logmap(E)
    y_p = (R_qiT @ (pj - pi - t * v_i - 0.5 * t * t * g)[..., None])[..., 0]
    y_v = (R_qiT @ (state.v - v_i - t * g)[..., None])[..., 0]
    r_p = y_p - (d.p + (d.dp_dbg @ dbg + d.dp_dba @ dba)[..., 0])
    r_v = y_v - (d.v + (d.dv_dbg @ dbg + d.dv_dba @ dba)[..., 0])
    r = torch.cat([r_q, r_p, r_v, state.bg - bg_i, state.ba - ba_i], dim=-1)

    Jr_inv = lie.right_jacobian_inv(r_q)
    R_biT, R_bjT = R_bi.transpose(-1, -2), R_bj.transpose(-1, -2)
    eye = torch.eye(3, dtype=dt, device=dev).expand(K, 3, 3)
    Ji = state.p.new_zeros((K, 15, 15))
    Jj = state.p.new_zeros((K, 15, 15))
    Ji[:, 0:3, 0:3] = -Jr_inv @ R_qjT @ R_i
    Ji[:, 0:3, 9:12] = -(Jr_inv @ lie.quat_to_matrix(E).transpose(-1, -2)
                        @ lie.right_jacobian(phi0) @ d.dq_dbg)
    Ji[:, 3:6, 0:3] = lie.hat(y_p) @ R_biT + R_biT @ lie.hat(p_bi)
    Ji[:, 3:6, 3:6] = -R_qiT
    Ji[:, 3:6, 6:9] = -t[..., None] * R_qiT
    Ji[:, 3:6, 9:12] = -d.dp_dbg
    Ji[:, 3:6, 12:15] = -d.dp_dba
    Ji[:, 6:9, 0:3] = lie.hat(y_v) @ R_biT
    Ji[:, 6:9, 6:9] = -R_qiT
    Ji[:, 6:9, 9:12] = -d.dv_dbg
    Ji[:, 6:9, 12:15] = -d.dv_dba
    Ji[:, 9:12, 9:12] = -eye
    Ji[:, 12:15, 12:15] = -eye
    Jj[:, 0:3, 0:3] = Jr_inv @ R_bjT
    Jj[:, 3:6, 0:3] = -R_qiT @ R_j @ lie.hat(data.p_bi)
    Jj[:, 3:6, 3:6] = R_qiT
    Jj[:, 6:9, 6:9] = R_qiT
    Jj[:, 9:12, 9:12] = eye
    Jj[:, 12:15, 12:15] = eye
    U = d.sqrt_inv_cov
    m = preint_pair_mask(data)
    mf = m.to(dt)
    return ((U @ r[..., None])[..., 0] * mf[:, None], (U @ Ji) * mf[:, None, None],
            (U @ Jj) * mf[:, None, None], m)


def rotation_residual_jac(state: WindowState, data: WindowData):
    """2-residual rotation-only bearing alignment per observation;
    only the target orientation is optimized.

    Returns (r (K,L,2), J_t (K,L,2,3), mask (K,L)).
    """
    K, L = data.obs_mask.shape
    ref = data.ref_idx.long()
    bearings = _safe_bearings(data)
    ar = torch.arange(L, device=ref.device)
    q_ref = state.q[ref]
    q_bc_ref = data.q_bc[ref]
    p_bc_ref = data.p_bc[ref]
    z_ref = bearings[ref, ar]
    b12 = lie.s2_tangential_basis(bearings)
    local_tangent = torch.cat([b12, bearings[..., None]], dim=-1)
    zero3 = torch.zeros(3, dtype=state.p.dtype, device=state.p.device)

    def obs_rj(q_tgt, qr, zr, lt, qbr, pbr, qbt, pbt, w2):
        def f(dtheta):
            qt = lie.quat_mul(q_tgt, lie.expmap(dtheta))
            z_ref_center = lie.quat_rotate(qbr, zr) + pbr
            z_tgt_center = lie.quat_rotate_inv(
                qt, lie.quat_rotate(qr, z_ref_center))
            z_tgt = lie.quat_rotate_inv(qbt, z_tgt_center - pbt)
            u = lt.transpose(-1, -2) @ z_tgt
            r = w2 @ (u[:2] / u[2])
            return r, r

        J, r = jacfwd(f, has_aux=True)(zero3)
        return r, J

    per_lm = vmap(obs_rj, in_dims=(None, 0, 0, 0, 0, 0, None, None, None))
    per_frame = vmap(per_lm, in_dims=(0, None, None, 0, None, None, 0, 0, 0))
    r, J = per_frame(state.q, q_ref, z_ref, local_tangent, q_bc_ref,
                     p_bc_ref, data.q_bc, data.p_bc, data.sqrt_inv_cov2)
    m = _active_mask(data)
    mf = m.to(r.dtype)
    return r * mf[..., None], J * mf[..., None, None], m


def marg_residual_jac(state: WindowState, data: WindowData):
    """Residual (K*15,) and Jacobian (K*15, K*15) of the dense prior:
    r = U·e + iv with the q-block local Jacobian Jr(e_q)⁻¹."""
    K = state.q.shape[0]
    e = state_error(state, data.marg.lin)
    U = data.marg.sqrt_inv_cov
    r = U @ e.reshape(-1) + data.marg.infovec
    Jr_inv = lie.right_jacobian_inv(e[:, 0:3])
    Dk = U.new_zeros((K, ES_SIZE, ES_SIZE))  # batched under vmap, as U
    Dk[:, 0:3, 0:3] = Jr_inv
    Dk[:, 3:, 3:] = torch.eye(ES_SIZE - 3, dtype=U.dtype, device=U.device)
    D = torch.block_diag(*Dk)
    J = U @ D
    mf = data.use_marg.to(r.dtype)
    return r * mf, J * mf, data.use_marg
