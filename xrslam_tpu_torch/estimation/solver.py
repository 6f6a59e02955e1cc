"""Batched Gauss-Newton/Levenberg-Marquardt window solver with an
explicit Schur complement over landmarks (port of
`xrslam_tpu/estimation/solver.py`).

Per iteration: residuals + Jacobian blocks per factor class
(factors.py), the reprojection factors and their block of the normal
equations in one call of kernel K2 (gram.reproj_factor_gram), the
preintegration factors and theirs in one call of kernel K3
(gram.preint_factor_gram), scalar
Schur elimination of the inverse depths, a Jacobi-scaled Cholesky solve
of the reduced camera system, and LM's accept/reject — kept on the
device with `torch.where`, so an iteration needs no host sync.

`solve_chained_batch` runs N windows' chained solves as one program on
a leading batch axis (the JAX package's `jax.vmap`): K2 and K3 take the
batch in one call each, the rest of `assemble` and the step run under
`torch.func.vmap`, and LM's accept/reject, λ and the slot injection are
per row.

Sharded mode (`group`, a `torch.distributed` process group over
landmark shards; `parallel/sharded.py` is the entry point): each rank
holds a contiguous block of the landmark columns and the whole frame
state. The frame-block H, b and the landmark factors' cost are summed
over the group after the reprojection and rotation factors, before the
frame-only preintegration and prior (JAX `solver.py`:152-155); the
Schur term Hfl·Hll⁻¹·Hflᵀ and its right-hand side before the reduced
camera solve (:245-247); the landmark cost in `compute_cost` (:209-210).
Each point packs its tensors into one flat buffer and makes one
`all_reduce` (`parallel.mesh.all_reduce_sum`), two per LM iteration.
Every rank then holds the same reduced system, takes the same frame
step and the same accept/reject, and back-substitutes its own landmark
block. A collective cannot run inside `torch.func.vmap`, so `assemble`
and `_solve_from` are each split at their reduction point into a
landmark-local half and a frame half: the batched path vmaps each half
and reduces the stacked partials between them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence, Tuple

import torch
from torch.func import vmap

from . import factors, gram
from .window import ES_SIZE, WindowData, WindowState, retract
from ..utils import timing
from ..utils.tree import tree_map


@dataclass(frozen=True)
class SolveOptions:
    iterations: int = 10
    use_reproj: bool = True
    use_preint: bool = True
    use_rotation: bool = False   # rotation-only subwindow mode
    lm_init: float = 1e-4
    lm_up: float = 10.0
    lm_down: float = 0.5
    lm_min: float = 1e-10
    lm_max: float = 1e10


def _free_masks(data: WindowData, dtype):
    """Per-entry free masks: (K,15) frame entries, (L,) landmarks."""
    pose_free = data.frame_mask & ~data.fix_pose
    motion_free = data.frame_mask & ~data.fix_motion
    idx = torch.arange(ES_SIZE, device=pose_free.device)
    f = torch.where(idx[None, :] < 6, pose_free[:, None],
                    motion_free[:, None]).to(dtype)
    flm = (data.landmark_mask & ~data.fix_landmark).to(dtype)
    return f, flm


def _all_reduce(group, *tensors):
    """The tensors summed over `group`'s ranks in one collective."""
    from ..parallel.mesh import all_reduce_sum

    return all_reduce_sum(tensors, group)


def _assemble_landmarks(state: WindowState, data: WindowData, opts: SolveOptions,
                        reproj=None):
    """The landmark-indexed half of `assemble`: the reprojection (K2's
    result `reproj` when the caller computed it) and rotation factors.
    Returns (H, b, Hll, Hfl, bl, cost); with landmark shards, H, b and
    cost are this shard's partial sums."""
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
    return H, b, Hll, Hfl, bl, cost


def _add_preint(sys, state: WindowState, data: WindowData, opts: SolveOptions):
    """The preintegration factors added to the (reduced) landmark half
    `sys` by K3 (`gram.preint_factor_gram`): one window, or a batch with
    a leading axis in one call (a C call cannot run under vmap)."""
    if not opts.use_preint:
        return sys
    H, b, Hll, Hfl, bl, cost = sys
    H, b, c = gram.preint_factor_gram(state, data, factors.preint_pair_mask(data),
                                      H, b)
    return H, b, Hll, Hfl, bl, cost + c


def _assemble_frames(sys, state: WindowState, data: WindowData, opts: SolveOptions):
    """The rest of the frame half of `assemble`: adds the prior to
    `sys` (which holds the preintegration factors), then eliminates
    fixed and masked entries."""
    H, b, Hll, Hfl, bl, cost = sys
    K = state.q.shape[0]
    dt = state.p.dtype
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


def assemble(state: WindowState, data: WindowData, opts: SolveOptions,
             reproj=None, group=None):
    """Build the GN normal equations. `reproj` is K2's result for this
    window when the caller computed it (`assemble_batch`). With `group`
    the landmark-indexed inputs are this rank's shard, and H, b and the
    landmark cost are summed over the group before the frame factors.

    Returns (H (K,15,K,15), b (K,15), Hll (L,), Hfl (K,15,L), bl (L,),
    cost ()) with fixed/masked entries eliminated (zero rows/cols, unit
    diagonal).
    """
    H, b, Hll, Hfl, bl, cost = _assemble_landmarks(state, data, opts, reproj)
    if group is not None:
        H, b, cost = _all_reduce(group, H, b, cost)
    sys = _add_preint((H, b, Hll, Hfl, bl, cost), state, data, opts)
    return _assemble_frames(sys, state, data, opts)


def compute_cost(state: WindowState, data: WindowData, opts: SolveOptions,
                 group=None) -> torch.Tensor:
    """Total robustified cost (residuals only); with `group`, the
    landmark factors' cost is summed over the landmark shards."""
    cost = torch.zeros((), dtype=state.p.dtype, device=state.p.device)
    if opts.use_reproj:
        r, _, _, _, m = factors.reproj_residual_jac(state, data)
        cost = cost + torch.sum(factors.cauchy_weights(r, m)[1])
    if opts.use_rotation:
        r, _, m = factors.rotation_residual_jac(state, data)
        cost = cost + torch.sum(factors.cauchy_weights(r, m)[1])
    if group is not None:
        (cost,) = _all_reduce(group, cost)
    if opts.use_preint:
        rp = factors.preint_residual_jac(state, data)[0]
        cost = cost + 0.5 * torch.sum(rp * rp)
    rm = factors.marg_residual_jac(state, data)[0]
    return cost + 0.5 * torch.sum(rm * rm)


def _schur_landmarks(sys, lam):
    """The landmark-indexed half of `_solve_from`: the damped inverse
    landmark diagonal and the Schur terms Hfl·Hll⁻¹·Hflᵀ and
    Hfl·Hll⁻¹·bl (with landmark shards, this shard's partial sums).
    Returns (S_lm (KM,KM), rhs_lm (KM,), inv_Hll (L,))."""
    _, _, Hll, Hfl, bl, _ = sys
    Hfl2 = Hfl.reshape(-1, Hfl.shape[-1])
    inv_Hll = 1.0 / (Hll * (1.0 + lam))
    return (Hfl2 * inv_Hll[None, :]) @ Hfl2.T, Hfl2 @ (inv_Hll * bl), inv_Hll


def _schur_frames(sys, state: WindowState, lam, S_lm, rhs_lm, inv_Hll) -> WindowState:
    """The frame half of `_solve_from`: the damped reduced camera system
    from the (reduced) Schur terms, its Jacobi-scaled Cholesky solve,
    the landmark back-substitution and the retraction."""
    H, b, _, Hfl, bl, _ = sys
    K = state.q.shape[0]
    KM = K * ES_SIZE
    Hd = H.reshape(KM, KM)
    Hfl2 = Hfl.reshape(KM, -1)
    Hd = Hd + lam * torch.diag(torch.diagonal(Hd))
    S = Hd - S_lm
    rhs = -(b.reshape(-1) - rhs_lm)
    # Jacobi scaling: the gauge prior puts ~1e16 on some diagonal
    # entries; unscaled Cholesky at that conditioning returns garbage
    d = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-30))
    Sn = S * d[:, None] * d[None, :]
    Lc, info = torch.linalg.cholesky_ex(Sn)
    y = torch.cholesky_solve((d * rhs)[:, None], Lc)[:, 0]
    df = torch.where(info == 0, d * y, float("nan"))
    dl = -(bl + Hfl2.T @ df) * inv_Hll
    return retract(state, df.reshape(K, ES_SIZE), dl)


def _solve_from(sys, state: WindowState, lam, group=None) -> WindowState:
    """One damped-GN step from an assembled system: Schur-eliminate
    landmarks, Jacobi-scaled Cholesky solve of the reduced camera
    system, back-substitute, retract. With `group`, the Schur terms are
    summed over the landmark shards. A non-positive-definite system
    gives a non-finite candidate (rejected by the LM test), never an
    exception or a host sync."""
    S_lm, rhs_lm, inv_Hll = _schur_landmarks(sys, lam)
    if group is not None:
        S_lm, rhs_lm = _all_reduce(group, S_lm, rhs_lm)
    return _schur_frames(sys, state, lam, S_lm, rhs_lm, inv_Hll)


def _lm_step(state: WindowState, data: WindowData, opts: SolveOptions, lam):
    """One damped-GN step: assemble + _solve_from. Returns
    (candidate_state, cost_at_state)."""
    sys = assemble(state, data, opts)
    return _solve_from(sys, state, lam), sys[5]


def _select(good, a, c):
    """torch.where(good, c, a), with `good` () or (N,) against leaves
    that lead with the same axes."""
    return torch.where(good.reshape(good.shape + (1,) * (c.dim() - good.dim())), c, a)


def _lm(state: WindowState, data: WindowData, opts: SolveOptions, assemble_fn,
        step_fn):
    """LM with deferred accept/reject over `assemble_fn` and `step_fn`
    (one window, or a batch whose rows each keep their own cost, λ and
    accept/reject). Inside a frame the loop is the stage `lm_solve` of
    the frame's record, which counts its `lm_iterations`."""
    rec = timing.active()
    if rec is None:
        return _lm_loop(state, data, opts, assemble_fn, step_fn)
    with rec.stage("lm_solve"):
        rec.count("lm_iterations", opts.iterations)
        return _lm_loop(state, data, opts, assemble_fn, step_fn)


def _lm_loop(state, data, opts, assemble_fn, step_fn):
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
                      opts: SolveOptions = SolveOptions(), group=None):
    """LM with deferred accept/reject: one assembly per iteration; the
    candidate of iteration i is judged by iteration i+1's assembly, a
    rejected step reuses the accepted system with more damping. With
    `group` the landmark-indexed fields are this rank's shard (see the
    module docstring).

    Returns (state, info) with info = {cost0, cost, cost_history (iters,),
    lambda}."""
    return _lm(state, data, opts, partial(assemble, group=group),
               partial(_solve_from, group=group))


def assemble_batch(state: WindowState, data: WindowData, opts: SolveOptions,
                   group=None):
    """`assemble` over a batch of N windows (every field with a leading
    axis of N): K2 and K3 in one call each over the batch, the other
    factors and the elimination under `torch.func.vmap`. With `group`,
    the stacked (N, ...) partials of H, b and the cost are summed between
    the vmapped landmark half and K3."""
    reproj = gram.reproj_factor_gram(state, data) if opts.use_reproj else None
    H, b, Hll, Hfl, bl, cost = vmap(
        lambda s, d, r: _assemble_landmarks(s, d, opts, r))(state, data, reproj)
    if group is not None:
        H, b, cost = _all_reduce(group, H, b, cost)
    sys = _add_preint((H, b, Hll, Hfl, bl, cost), state, data, opts)
    return vmap(lambda y, s, d: _assemble_frames(y, s, d, opts))(sys, state, data)


def _solve_from_batch(sys, state: WindowState, lam, group=None) -> WindowState:
    """`_solve_from` over a batch; with `group`, the stacked Schur terms
    are summed between the two vmapped halves."""
    S_lm, rhs_lm, inv_Hll = vmap(_schur_landmarks)(sys, lam)
    if group is not None:
        S_lm, rhs_lm = _all_reduce(group, S_lm, rhs_lm)
    return vmap(_schur_frames)(sys, state, lam, S_lm, rhs_lm, inv_Hll)


def solve_window_batch(state: WindowState, data: WindowData,
                       opts: SolveOptions = SolveOptions(), group=None):
    """`solve_window_core` on a batch of N windows of one shape; every
    row keeps its own accept/reject and λ. info's entries lead with N
    (cost_history is (iters, N)). `group` as in `solve_window_core`."""
    return _lm(state, data, opts, partial(assemble_batch, group=group),
               partial(_solve_from_batch, group=group))


def solve_window(state: WindowState, data: WindowData,
                 opts: SolveOptions = SolveOptions()):
    """Solve one window. Returns (state, info with cost trajectory)."""
    return solve_window_core(state, data, opts)


def _inject(state2: WindowState, st1: WindowState, s1: int, s2: int,
            inject: bool = True) -> WindowState:
    """Copy window-1 slot s1's frame state into window-2 slot s2."""
    if not inject:
        return state2

    def put(dst, src):
        out = dst.clone()
        out[s2] = src[s1].to(dst.dtype)
        return out

    return state2._replace(q=put(state2.q, st1.q), p=put(state2.p, st1.p),
                           v=put(state2.v, st1.v), bg=put(state2.bg, st1.bg),
                           ba=put(state2.ba, st1.ba))


def solve_chained(state1: WindowState, data1: WindowData, opts1: SolveOptions,
                  state2: WindowState, data2: WindowData, opts2: SolveOptions,
                  s1: int, s2: int):
    """Solve window 1 (the new-frame localization), inject its slot-s1
    state into window 2's slot s2, solve window 2 (the subwindow
    refine). Returns (st1, st2, info2)."""
    st1, _ = solve_window_core(state1, data1, opts1)
    st2, info2 = solve_window_core(_inject(state2, st1, s1, s2), data2, opts2)
    return st1, st2, info2


def _inject_rows(state2: WindowState, st1: WindowState,
                 slots: torch.Tensor) -> WindowState:
    """`_inject` per row of a batch: row i's window-1 slot slots[i] into
    its window-2 slot slots[i]."""
    N, K = state2.q.shape[:2]
    rows = torch.arange(N, device=slots.device)
    at = (torch.arange(K, device=slots.device)[None, :] == slots[:, None])[..., None]

    def put(dst, src):
        return torch.where(at, src[rows, slots][:, None, :].to(dst.dtype), dst)

    return state2._replace(q=put(state2.q, st1.q), p=put(state2.p, st1.p),
                           v=put(state2.v, st1.v), bg=put(state2.bg, st1.bg),
                           ba=put(state2.ba, st1.ba))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def solve_chained_batch(states1: Sequence[WindowState], datas1: Sequence[WindowData],
                        opts1: SolveOptions, states2: Sequence[WindowState],
                        datas2: Sequence[WindowData], opts2: SolveOptions,
                        slots) -> Tuple[WindowState, ...]:
    """`solve_chained` over N sequences in one program (port of the JAX
    package's `solve_chained_batch`): takes tuples of N per-sequence
    (state, data) windows of one shape, stacks them on a leading axis,
    runs the localize solve, the per-row injection of slot slots[i]
    into slot slots[i] and the subwindow solve on the batch, and returns
    the N solved subwindow states. `slots` holds N ints (or an (N,)
    integer tensor)."""
    st1, d1 = _stack(states1), _stack(datas1)
    st2, d2 = _stack(states2), _stack(datas2)
    slots = torch.as_tensor(slots, dtype=torch.long, device=st1.q.device)
    out1, _ = solve_window_batch(st1, d1, opts1)
    out2, _ = solve_window_batch(_inject_rows(st2, out1, slots), d2, opts2)
    return tuple(tree_map(lambda x, i=i: x[i], out2) for i in range(len(states1)))


def solve_keyframe_chain(state1: WindowState, data1: WindowData,
                         opts1: SolveOptions, state2: WindowState,
                         data2: WindowData, opts2: SolveOptions,
                         s1: int, s2: int, inject: bool, cand, fuv):
    """The keyframe backend step: localize the new frame (window 1),
    inject it into the full window (unless the target is not a window
    slot), triangulate the candidate landmarks from the window poses,
    full-window VI-BA over window 2, then the landmark depth/RPE gates.

    Returns (st1, st2, (gate_ok, mean_rpe), tri_ok)."""
    from .triangulate import triangulate_landmarks

    st1, _ = solve_window_core(state1, data1, opts1)
    state2 = _inject(state2, st1, s1, s2, inject)
    tri_invd, tri_ok = triangulate_landmarks(state2, data2, cand)
    state2 = state2._replace(
        inv_depth=torch.where(tri_ok, tri_invd, state2.inv_depth))
    data2 = data2._replace(landmark_mask=data2.landmark_mask | tri_ok)
    st2, _ = solve_window_core(state2, data2, opts2)
    return st1, st2, landmark_gates(st2, data2, fuv), tri_ok


def landmark_gates(state: WindowState, data: WindowData, fuv: torch.Tensor):
    """Post-solve landmark re-validation: depth at every observing
    window frame in (1e-3, 50] and mean reprojection error < 3 px.
    fuv (K,2) focal lengths. Returns (ok (L,) bool, mean_rpe (L,))."""
    from ..geometry import lie

    ref = data.ref_idx.long()
    L = state.inv_depth.shape[0]
    q_wc = lie.quat_mul(state.q, data.q_bc)
    p_wc = state.p + lie.quat_rotate(state.q, data.p_bc)
    bref = data.bearings[ref, torch.arange(L, device=ref.device)]
    d = torch.clamp(state.inv_depth, min=1e-9)
    p_w = lie.quat_rotate(q_wc[ref], bref / d[:, None]) + p_wc[ref]
    rel = p_w[None, :, :] - p_wc[:, None, :]
    y = lie.quat_rotate_inv(q_wc[:, None, :], rel)
    m = data.obs_mask & data.landmark_mask[None, :]
    z = torch.where(torch.abs(y[..., 2]) > 1e-12, y[..., 2], 1e-12)
    bb = data.bearings
    bz = torch.where(torch.abs(bb[..., 2]) > 1e-12, bb[..., 2], 1e-12)
    du = (y[..., 0] / z - bb[..., 0] / bz) * fuv[:, None, 0]
    dv = (y[..., 1] / z - bb[..., 1] / bz) * fuv[:, None, 1]
    rpe = torch.hypot(du, dv)
    cnt = torch.sum(m, dim=0)
    mean_rpe = torch.sum(torch.where(m, rpe, 0.0), dim=0) / torch.clamp(cnt, min=1)
    depth_ok = torch.all(torch.where(m, (y[..., 2] > 1.0e-3) & (y[..., 2] <= 50.0),
                                     True), dim=0)
    return depth_ok & (mean_rpe < 3.0), mean_rpe
