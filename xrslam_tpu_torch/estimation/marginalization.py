"""Sliding-window marginalization (port of
`xrslam_tpu/estimation/marginalization.py`): fold the victim frame (and
the landmarks observed by it) into a dense prior over the remaining
frames.

Information comes from (a) the existing prior at the current states,
(b) the preintegration factors adjacent to the victim, (c) the
unweighted reprojection factors of every landmark the victim observes
with scalar landmark Schur elimination; the victim's 15×15 block is
Schur-eliminated, and an eigendecomposition clamped at 1e-8 gives the
new (sqrt_inv_cov, infovec). Arrays come back in the post-slide slot
layout (slot i > victim moves to i-1; the last slot is inactive).
"""

from __future__ import annotations

import torch

from . import factors, gram
from .gram import anchor_onehot
from .window import ES_SIZE, MargPrior, WindowData, WindowState
from ..utils.tree import tree_map


def _perm(K: int, victim: int, last: int):
    return list(range(victim)) + list(range(victim + 1, K)) + [last]


def _roll_state(state: WindowState, victim: int) -> WindowState:
    """Remove frame slot `victim`, shift later frames left, keep the
    last slot as an inert copy of the previous last."""
    K = state.q.shape[0]
    idx = torch.as_tensor(_perm(K, victim, K - 1), device=state.q.device)
    return WindowState(q=state.q[idx], p=state.p[idx], v=state.v[idx],
                       bg=state.bg[idx], ba=state.ba[idx],
                       inv_depth=state.inv_depth)


def _roll_mask(mask: torch.Tensor, victim: int) -> torch.Tensor:
    K = mask.shape[0]
    out = mask[torch.as_tensor(_perm(K, victim, K - 1), device=mask.device)]
    out[K - 1] = False
    return out


def marginalize_frame(state: WindowState, data: WindowData, victim: int = 0,
                      eig_clamp: float = 1.0e-8) -> MargPrior:
    """The new marginalization prior after removing `victim`, in the
    post-slide slot layout."""
    K = state.q.shape[0]
    KM = K * ES_SIZE
    dt = state.p.dtype
    dev = state.p.device

    # (a) existing prior at current states
    rm, Jm, _ = factors.marg_residual_jac(state, data)
    H = Jm.T @ Jm
    b = Jm.T @ rm

    # (b) preintegration factors j = victim and victim+1 (kernel K3)
    adj = torch.zeros((K,), dtype=torch.bool, device=dev)
    if victim >= 1:
        adj[victim] = True
    if victim + 1 < K:
        adj[victim + 1] = True
    Hb, bb, _ = gram.preint_factor_gram(state, data,
                                        adj & factors.preint_pair_mask(data))
    H = H + Hb.reshape(KM, KM)
    b = b + bb.reshape(-1)

    # (c) unweighted reprojection factors of the victim's landmarks,
    # scalar landmark Schur elimination
    r, Jt, Jr6, Jd, m = factors.reproj_residual_jac(state, data)
    lm_sel = (data.obs_mask[victim] & data.landmark_mask).to(dt)
    msel = m.to(dt) * lm_sel[None, :]
    r = r * msel[..., None]
    Jt = Jt * msel[..., None, None]
    Jr6 = Jr6 * msel[..., None, None]
    Jd = Jd * msel[..., None]
    R1 = anchor_onehot(data, K, dt)
    ar = torch.arange(K, device=dev)
    P = torch.zeros((K, 6, K, 6), dtype=dt, device=dev)
    P[ar, :, ar, :] = torch.einsum("klri,klrj->kij", Jt, Jt)
    Htr = torch.einsum("klij,lm->kimj",
                       torch.einsum("klri,klrj->klij", Jt, Jr6), R1)
    P = P + Htr + Htr.permute(2, 3, 0, 1)
    P = P + torch.einsum("lij,lm,ln->minj",
                         torch.einsum("klri,klrj->lij", Jr6, Jr6), R1, R1)
    bp = (torch.einsum("klri,klr->ki", Jt, r)
          + torch.einsum("li,lm->mi", torch.einsum("klri,klr->li", Jr6, r), R1))
    Hfl = (torch.einsum("klri,klr->kil", Jt, Jd)
           + torch.einsum("li,lm->mil", torch.einsum("klri,klr->li", Jr6, Jd), R1))
    Hll = torch.einsum("klr,klr->l", Jd, Jd)
    bl = torch.einsum("klr,klr->l", Jd, r)
    inv_Hll = torch.where(Hll > 1e-12, 1.0 / torch.where(Hll > 0, Hll, 1.0), 0.0)
    P = P - torch.einsum("kil,l,mjl->kimj", Hfl, inv_Hll, Hfl)
    bp = bp - torch.einsum("kil,l,l->ki", Hfl, inv_Hll, bl)
    Hp = torch.zeros((K, ES_SIZE, K, ES_SIZE), dtype=dt, device=dev)
    Hp[:, 0:6, :, 0:6] = P
    bpf = torch.zeros((K, ES_SIZE), dtype=dt, device=dev)
    bpf[:, 0:6] = bp
    H = H + Hp.reshape(KM, KM)
    b = b + bpf.reshape(-1)

    # Schur-eliminate the victim frame's 15x15 block
    v0 = victim * ES_SIZE
    Hvv_inv, _ = torch.linalg.inv_ex(H[v0:v0 + ES_SIZE, v0:v0 + ES_SIZE])
    Hv_row = H[v0:v0 + ES_SIZE, :]
    Hv_col = H[:, v0:v0 + ES_SIZE]
    bv = b[v0:v0 + ES_SIZE]
    H = H - Hv_col @ Hvv_inv @ Hv_row
    b = b - Hv_col @ (Hvv_inv @ bv)

    # zero the victim rows/cols, shift remaining blocks left, drop the
    # vacated last slot and never-valid frames
    keep = torch.ones((K,), dtype=torch.bool, device=dev)
    keep[victim] = False
    keepv = torch.repeat_interleave(keep, ES_SIZE).to(dt)
    H = H * keepv[:, None] * keepv[None, :]
    b = b * keepv
    perm = torch.as_tensor(_perm(K, victim, victim), device=dev)
    pidx = (torch.repeat_interleave(perm * ES_SIZE, ES_SIZE)
            + torch.arange(ES_SIZE, device=dev).repeat(K))
    H = H[pidx][:, pidx]
    b = b[pidx]
    lastv = torch.ones((KM,), dtype=dt, device=dev)
    lastv[(K - 1) * ES_SIZE:] = 0.0
    fmv = torch.repeat_interleave(_roll_mask(data.frame_mask, victim),
                                  ES_SIZE).to(dt) * lastv
    H = H * fmv[:, None] * fmv[None, :]
    b = b * fmv

    # eigendecompose, clamp, sqrt information + information vector
    H = 0.5 * (H + H.T)
    lam, V = torch.linalg.eigh(H)
    pos = lam > eig_clamp
    lam_c = torch.where(pos, lam, 0.0)
    lam_inv = torch.where(pos, 1.0 / torch.where(pos, lam, 1.0), 0.0)
    U = torch.sqrt(lam_c)[:, None] * V.T
    iv = torch.sqrt(lam_inv)[:, None] * V.T @ b
    return MargPrior(sqrt_inv_cov=U, infovec=iv,
                     lin=_roll_state(state, victim))


def landmark_world_points(state: WindowState, data: WindowData) -> torch.Tensor:
    """World positions of all landmarks from their anchored inverse
    depths."""
    from ..geometry import lie

    L = state.inv_depth.shape[0]
    ref = data.ref_idx.long()
    z_ref = data.bearings[ref, torch.arange(L, device=ref.device)]
    invd = torch.where(torch.abs(state.inv_depth) < 1e-12, 1e-12,
                       state.inv_depth)
    y_b = lie.quat_rotate(data.q_bc[ref], z_ref / invd[:, None]) + data.p_bc[ref]
    return lie.quat_rotate(state.q[ref], y_b) + state.p[ref]


def slide_window(state: WindowState, data: WindowData, new_prior: MargPrior,
                 victim: int = 0):
    """Shift the window arrays after marginalizing `victim`: frames roll
    left, the victim's observation row is dropped, landmarks anchored at
    the victim re-anchor to their next observing frame (inverse depth
    recomputed from the current estimate), landmarks left with < 2
    observations are invalidated, preintegration entries shift, and the
    new prior is installed. Returns (state, data)."""
    from ..geometry import lie

    K = state.q.shape[0]
    dev = state.q.device
    perm = torch.as_tensor(_perm(K, victim, K - 1), device=dev)
    x_w = landmark_world_points(state, data)
    state2 = _roll_state(state, victim)
    obs_mask = data.obs_mask[perm]
    obs_mask[K - 1] = False
    frame_mask = _roll_mask(data.frame_mask, victim)
    old_ref = data.ref_idx
    first_obs = torch.argmax(obs_mask.to(torch.int8), dim=0).to(torch.int32)
    n_obs = torch.sum(obs_mask, dim=0)
    was_victim_anchor = old_ref == victim
    shifted = torch.where(old_ref > victim, old_ref - 1, old_ref).to(torch.int32)
    ref_idx = torch.where(was_victim_anchor, first_obs, shifted)
    landmark_mask = data.landmark_mask & (n_obs >= 2)
    refl = ref_idx.long()
    q_bc = data.q_bc[perm][refl]
    p_bc = data.p_bc[perm][refl]
    x_b = lie.quat_rotate_inv(state2.q[refl], x_w - state2.p[refl])
    x_c = lie.quat_rotate_inv(q_bc, x_b - p_bc)
    invd_new = 1.0 / torch.clamp(torch.linalg.norm(x_c, dim=-1), min=1e-12)
    state2 = state2._replace(inv_depth=torch.where(
        was_victim_anchor & landmark_mask, invd_new, state2.inv_depth))

    pre_perm = torch.as_tensor(list(range(victim + 1))
                               + list(range(victim + 2, K)) + [K - 1],
                               device=dev)
    preint = tree_map(lambda x: x[pre_perm], data.preint)
    preint_mask = data.preint_mask[pre_perm]
    preint_mask[victim] = False
    preint_mask[K - 1] = False

    def rolled_flag(x):
        out = x[perm]
        out[K - 1] = False
        return out

    data2 = data._replace(
        q_bc=data.q_bc[perm], p_bc=data.p_bc[perm], q_bi=data.q_bi[perm],
        p_bi=data.p_bi[perm], bearings=data.bearings[perm], obs_mask=obs_mask,
        ref_idx=ref_idx, sqrt_inv_cov2=data.sqrt_inv_cov2[perm],
        preint=preint, preint_mask=preint_mask,
        bg_lin=data.bg_lin[pre_perm], ba_lin=data.ba_lin[pre_perm],
        frame_mask=frame_mask, fix_pose=rolled_flag(data.fix_pose),
        fix_motion=rolled_flag(data.fix_motion), landmark_mask=landmark_mask,
        marg=new_prior, use_marg=torch.ones((), dtype=torch.bool, device=dev))
    return state2, data2
