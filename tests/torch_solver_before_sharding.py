"""The port's window solver as it stood before the sharded mode
(xrslam_tpu_torch/estimation/solver.py at commit 412ef17: `assemble`,
`compute_cost`, `_solve_from`, `_lm`, `solve_window_core`,
`assemble_batch`, `_solve_from_batch` and `solve_window_batch` copied
unchanged; the helpers the sharded mode left as they were are
imported, `_preint_blocks` from `gram.preint_blocks`, where it moved
unchanged). `tests/test_torch_sharded.py` holds
the present solver with `group=None` to it bit for bit, in one process,
so that the comparison does not depend on the host's math libraries.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from xrslam_tpu_torch.estimation import factors, gram
from xrslam_tpu_torch.estimation.gram import preint_blocks as _preint_blocks
from xrslam_tpu_torch.estimation.solver import SolveOptions, _free_masks, _select
from xrslam_tpu_torch.estimation.window import ES_SIZE, WindowData, WindowState, retract
from xrslam_tpu_torch.utils.tree import tree_map


def assemble(state: WindowState, data: WindowData, opts: SolveOptions,
             reproj=None):
    """Build the GN normal equations. `reproj` is K2's result for this
    window when the caller computed it (`assemble_batch`).

    Returns (H (K,15,K,15), b (K,15), Hll (L,), Hfl (K,15,L), bl (L,),
    cost ()) with fixed/masked entries eliminated (zero rows/cols, unit
    diagonal).
    """
    K = state.q.shape[0]
    L = state.inv_depth.shape[0]
    # new_zeros: under vmap (assemble_batch) the accumulators are batched
    zeros = state.p.new_zeros
    H = zeros((K, ES_SIZE, K, ES_SIZE))
    b = zeros((K, ES_SIZE))
    Hll = zeros((L,))
    Hfl = zeros((K, ES_SIZE, L))
    bl = zeros((L,))
    cost = zeros(())
    dt = state.p.dtype

    if opts.use_reproj:
        P, b6, Hll_c, Hfl6, bl_c, c = (gram.reproj_factor_gram(state, data)
                                       if reproj is None else reproj)
        cost = cost + c
        H[:, 0:6, :, 0:6] += P
        b[:, 0:6] += b6
        Hfl[:, 0:6, :] += Hfl6
        Hll = Hll + Hll_c
        bl = bl + bl_c

    if opts.use_rotation:
        r, Jq, m = factors.rotation_residual_jac(state, data)
        w, c = factors.cauchy_weights(r, m)
        cost = cost + torch.sum(c)
        r = r * w[..., None]
        Jq = Jq * w[..., None, None]
        # H[k, 0:3, k, 0:3] += ..., through a diagonal view (vmap's
        # index_put rule mis-places this indexing pattern)
        torch.diagonal(H[:, 0:3, :, 0:3], dim1=0, dim2=2).add_(
            torch.einsum("klri,klrj->kij", Jq, Jq).permute(1, 2, 0))
        b[:, 0:3] += torch.einsum("klri,klr->ki", Jq, r)

    if opts.use_preint:
        rp, Ji, Jj, _ = factors.preint_residual_jac(state, data)
        cost = cost + 0.5 * torch.sum(rp * rp)
        H, b = _preint_blocks(H, b, rp, Ji, Jj, K)

    rm, Jm, _ = factors.marg_residual_jac(state, data)
    cost = cost + 0.5 * torch.sum(rm * rm)
    KM = K * ES_SIZE
    H = H + (Jm.T @ Jm).reshape(K, ES_SIZE, K, ES_SIZE)
    b = b + (Jm.T @ rm).reshape(K, ES_SIZE)

    # eliminate fixed/invalid entries; free entries no factor touches
    # get a unit diagonal so the solve stays nonsingular
    f, flm = _free_masks(data, dt)
    H = H * f[:, :, None, None] * f[None, None, :, :]
    Hd = H.reshape(KM, KM)
    fv = f.reshape(-1)
    Hd = Hd + torch.diag(1.0 - fv)
    zero_info = (torch.diagonal(Hd) < 1e-12) & (fv > 0)
    Hd = Hd + torch.diag(zero_info.to(dt))
    H = Hd.reshape(K, ES_SIZE, K, ES_SIZE)
    b = b * f
    flm = flm * (Hll > 1e-12).to(dt)
    Hfl = Hfl * f[:, :, None] * flm[None, None, :]
    Hll = torch.where(flm > 0, Hll, 1.0)
    bl = bl * flm
    return H, b, Hll, Hfl, bl, cost


def compute_cost(state: WindowState, data: WindowData,
                 opts: SolveOptions) -> torch.Tensor:
    """Total robustified cost (residuals only)."""
    cost = torch.zeros((), dtype=state.p.dtype, device=state.p.device)
    if opts.use_reproj:
        r, _, _, _, m = factors.reproj_residual_jac(state, data)
        cost = cost + torch.sum(factors.cauchy_weights(r, m)[1])
    if opts.use_rotation:
        r, _, m = factors.rotation_residual_jac(state, data)
        cost = cost + torch.sum(factors.cauchy_weights(r, m)[1])
    if opts.use_preint:
        rp = factors.preint_residual_jac(state, data)[0]
        cost = cost + 0.5 * torch.sum(rp * rp)
    rm = factors.marg_residual_jac(state, data)[0]
    return cost + 0.5 * torch.sum(rm * rm)


def _solve_from(sys, state: WindowState, lam) -> WindowState:
    """One damped-GN step from an assembled system: Schur-eliminate
    landmarks, Jacobi-scaled Cholesky solve of the reduced camera
    system, back-substitute, retract. A non-positive-definite system
    gives a non-finite candidate (rejected by the LM test), never an
    exception or a host sync."""
    H, b, Hll, Hfl, bl, _ = sys
    K = state.q.shape[0]
    KM = K * ES_SIZE
    Hd = H.reshape(KM, KM)
    Hfl2 = Hfl.reshape(KM, -1)
    Hd = Hd + lam * torch.diag(torch.diagonal(Hd))
    inv_Hll = 1.0 / (Hll * (1.0 + lam))
    S = Hd - (Hfl2 * inv_Hll[None, :]) @ Hfl2.T
    rhs = -(b.reshape(-1) - Hfl2 @ (inv_Hll * bl))
    # Jacobi scaling: the gauge prior puts ~1e16 on some diagonal
    # entries; unscaled Cholesky at that conditioning returns garbage
    d = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-30))
    Sn = S * d[:, None] * d[None, :]
    Lc, info = torch.linalg.cholesky_ex(Sn)
    y = torch.cholesky_solve((d * rhs)[:, None], Lc)[:, 0]
    df = torch.where(info == 0, d * y, float("nan"))
    dl = -(bl + Hfl2.T @ df) * inv_Hll
    return retract(state, df.reshape(K, ES_SIZE), dl)


def _lm(state: WindowState, data: WindowData, opts: SolveOptions, assemble_fn,
        step_fn):
    """LM with deferred accept/reject over `assemble_fn` and `step_fn`
    (one window, or a batch whose rows each keep their own cost, λ and
    accept/reject)."""
    sys_best = assemble_fn(state, data, opts)
    cost0 = sys_best[5]
    cost_best = cost0
    lam = torch.full_like(cost0, opts.lm_init)
    st_best = state
    cand = step_fn(sys_best, state, lam)
    hist = []
    for it in range(opts.iterations):
        sys_cand = assemble_fn(cand, data, opts)
        cost_cand = sys_cand[5]
        good = torch.isfinite(cost_cand) & (cost_cand < cost_best)

        def sel(a, c):
            return _select(good, a, c)

        st_best = tree_map(sel, st_best, cand)
        sys_best = tree_map(sel, sys_best, sys_cand)
        cost_best = torch.where(good, cost_cand, cost_best)
        lam = torch.clamp(torch.where(good, lam * opts.lm_down,
                                      lam * opts.lm_up),
                          opts.lm_min, opts.lm_max)
        hist.append(cost_best)
        if it + 1 < opts.iterations:  # the last candidate is never judged
            cand = step_fn(sys_best, st_best, lam)
    cost_hist = torch.stack(hist) if hist else cost0[None][:0]
    return st_best, {"cost0": cost0, "cost": cost_best,
                     "cost_history": cost_hist, "lambda": lam}


def solve_window_core(state: WindowState, data: WindowData,
                      opts: SolveOptions = SolveOptions()):
    """LM with deferred accept/reject: one assembly per iteration; the
    candidate of iteration i is judged by iteration i+1's assembly, a
    rejected step reuses the accepted system with more damping.

    Returns (state, info) with info = {cost0, cost, cost_history (iters,),
    lambda}."""
    return _lm(state, data, opts, assemble, _solve_from)


def assemble_batch(state: WindowState, data: WindowData, opts: SolveOptions):
    """`assemble` over a batch of N windows (every field with a leading
    axis of N): K2 in one call over the batch, the other factors and the
    elimination under `torch.func.vmap`."""
    reproj = gram.reproj_factor_gram(state, data) if opts.use_reproj else None
    return vmap(lambda s, d, r: assemble(s, d, opts, r))(state, data, reproj)


_solve_from_batch = vmap(_solve_from)


def solve_window_batch(state: WindowState, data: WindowData,
                       opts: SolveOptions = SolveOptions()):
    """`solve_window_core` on a batch of N windows of one shape; every
    row keeps its own accept/reject and λ. info's entries lead with N
    (cost_history is (iters, N))."""
    return _lm(state, data, opts, assemble_batch, _solve_from_batch)

