"""The reprojection block of the Gauss-Newton normal equations (port of
`xrslam_tpu/estimation/gram.py`): kernel K2 of the port, with two
entries that share one CUDA source (csrc/reproj_gram.cu).

1. `reproj_gram(r, Jt, Jr6, Jd, R1) -> (P (K,6,K,6), b6 (K,6), Hll (L,),
   Hfl6 (K,6,L), bl (L,))` keeps the JAX signature: already
   Cauchy-weighted inputs (factors.reproj_residual_jac) and the masked
   anchor one-hot R1 (L,K).
2. `reproj_factor_gram(state, data) -> (P, b6, Hll, Hfl6, bl, cost)` is
   what `solver.assemble` calls: the residuals, their Jacobians in
   closed form, the active mask, the Cauchy weights and robust cost and
   the Gram block in one call; on the card nothing between the window
   and the outputs reaches device memory. It also takes a batch of N
   windows of one shape (every state and data field with a leading
   axis of N, as `solver.solve_chained_batch` stacks them) and returns
   every output with that leading axis, in the same two launches: the
   port's counterpart of `jax.vmap` over the Pallas kernel.

`reproj_gram_matmul` is the JAX package's augmented-Jacobian Gram
form (`reproj_gram_xla`), the frame block as one `torch.matmul`
(cuBLAS on the card). It is K2's library yardstick in `chip_smoke.py`,
not a route of the port: `assemble` never calls it.

Each entry has a plain version (`reproj_gram_plain`: the einsum branch
of the JAX `solver.assemble`, solver.py:119-136;
`reproj_factor_gram_plain`: closed-form factors + weights + that), taken
for CPU tensors only, and a wrapper that launches the kernel
(`reproj_gram_cuda`, `reproj_factor_gram_cuda`), taken for CUDA tensors.
A wrapper raises on any input the kernel does not take; there is no
fallback.

`preint_factor_gram(state, data, mask, H, b) -> (H, b, cost)` is kernel
K3 (csrc/preint_gram.cu), the preintegration factor's part of the same
normal equations: the K-1 pairs' weighted residuals and Jacobians in
closed form (`factors.preint_residual_jac_closed`), masked by `mask`,
their Gram blocks added to the block-tridiagonal part of H and to b, and
0.5·Σ|r|². Its plain version `preint_factor_gram_plain` is the autodiff
composition `assemble` and `marginalize_frame` ran before it
(`factors.preint_residual_jac` + `preint_blocks` + the cost), taken for
CPU tensors; `preint_factor_gram_cuda` launches K3 for CUDA tensors,
one window or a batch with a leading axis, in one launch.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from . import factors
from .window import WindowData, WindowState
from ..kernels import build as kbuild
from ..utils.tree import tree_map

MAX_FRAMES = 32   # one lane per frame (csrc/reproj_gram.cu)
TARGET_CTAS = 132  # the H100's SMs: splits * K CTAs, one for nearly each
COL_ROWS, ANCHOR_ROWS = 63, 27  # a CTA's partial (kCol, kAnchor)
ENTRY_GRAM, ENTRY_FACTOR = kbuild.REPROJ_GRAM.entries


def anchor_onehot(data: WindowData, K: int, dtype) -> torch.Tensor:
    """R1 (L,K): one-hot of each landmark's anchor frame, masked."""
    R1 = torch.nn.functional.one_hot(data.ref_idx.long(), K).to(dtype)
    return R1 * data.landmark_mask[:, None].to(dtype)


def reproj_gram_plain(r, Jt, Jr6, Jd, R1):
    """The einsum formulation of the JAX solver's default branch."""
    K = r.shape[0]
    tt = torch.einsum("klri,klrj->kij", Jt, Jt)
    P = torch.zeros((K, 6, K, 6), dtype=r.dtype, device=r.device)
    ar = torch.arange(K, device=r.device)
    P[ar, :, ar, :] = tt
    Htr = torch.einsum("klij,lm->kimj",
                       torch.einsum("klri,klrj->klij", Jt, Jr6), R1)
    P = P + Htr + Htr.permute(2, 3, 0, 1)
    rr = torch.einsum("klri,klrj->lij", Jr6, Jr6)
    P = P + torch.einsum("lij,lm,ln->minj", rr, R1, R1)
    b6 = (torch.einsum("klri,klr->ki", Jt, r)
          + torch.einsum("li,lm->mi", torch.einsum("klri,klr->li", Jr6, r), R1))
    Hfl6 = (torch.einsum("klri,klr->kil", Jt, Jd)
            + torch.einsum("li,lm->mil", torch.einsum("klri,klr->li", Jr6, Jd), R1))
    Hll = torch.einsum("klr,klr->l", Jd, Jd)
    bl = torch.einsum("klr,klr->l", Jd, r)
    return P, b6, Hll, Hfl6, bl


def reproj_gram_matmul(r, Jt, Jr6, Jd, R1):
    """Entry 1's function in the augmented-Jacobian Gram form (port of
    `xrslam_tpu/estimation/gram.py:56` `reproj_gram_xla`): the pose
    Jacobian of every residual over all K frames, Ap (K·L·2, K·6), so
    that P = Apᵀ·Ap and b6 = Apᵀ·r are one matrix product each, with the
    landmark terms per column. Same inputs and outputs as
    `reproj_gram_plain`."""
    K, L = r.shape[:2]
    eyeK = torch.eye(K, dtype=r.dtype, device=r.device)
    # Ap[k,l,r,m,i]: d r_klr / d pose entry (m,i)
    Ap = (torch.einsum("km,klri->klrmi", eyeK, Jt)
          + torch.einsum("lm,klri->klrmi", R1, Jr6))
    Ap2 = Ap.reshape(K * L * 2, K * 6)
    P = (Ap2.T @ Ap2).reshape(K, 6, K, 6)
    b6 = (Ap2.T @ r.reshape(-1)).reshape(K, 6)
    Hfl6 = torch.einsum("klrmi,klr->mil", Ap, Jd)
    Hll = torch.einsum("klr,klr->l", Jd, Jd)
    bl = torch.einsum("klr,klr->l", Jd, r)
    return P, b6, Hll, Hfl6, bl


def reproj_factor_gram_plain(state: WindowState, data: WindowData,
                             jac=factors.reproj_residual_jac_closed):
    """Entry 2 in plain PyTorch: closed-form factors, Cauchy weights,
    the einsum Gram block. Returns (P, b6, Hll, Hfl6, bl, cost).
    `jac=factors.reproj_residual_jac` gives the autodiff composition
    that the closed form and the kernel are held against. A batch
    (leading axis N) is the N single-window results stacked."""
    if state.q.dim() == 3:
        rows = [reproj_factor_gram_plain(tree_map(lambda x, i=i: x[i], state),
                                         tree_map(lambda x, i=i: x[i], data), jac)
                for i in range(state.q.shape[0])]
        return tuple(torch.stack(outs) for outs in zip(*rows))
    r, Jt, Jr6, Jd, m = jac(state, data)
    w, c = factors.cauchy_weights(r, m)
    wf = w[..., None]
    out = reproj_gram_plain(r * wf, Jt * wf[..., None], Jr6 * wf[..., None],
                            Jd * wf, anchor_onehot(data, r.shape[0], r.dtype))
    return (*out, torch.sum(c))


def rounding_ratios(out, state: WindowState, data: WindowData):
    """How far a low-precision result of entry 2 is from the exact one,
    in units of its own rounding: per output, the largest
    |out − exact| / (eps · Σ|term|), where `exact` is the plain version
    in float64 on the same inputs (upcast), Σ|term| the Gram block of
    the absolute weighted factors (the sum of the magnitudes that each
    entry adds up) and eps that of `out`'s dtype. An entry whose terms
    are all zero must be zero (else inf). A float32 kernel is held to a
    small multiple of the float32 plain version's ratios."""
    f64 = torch.float64
    s = state._replace(q=state.q.to(f64), p=state.p.to(f64),
                       inv_depth=state.inv_depth.to(f64))
    d = data._replace(q_bc=data.q_bc.to(f64), p_bc=data.p_bc.to(f64),
                      bearings=data.bearings.to(f64),
                      sqrt_inv_cov2=data.sqrt_inv_cov2.to(f64))
    exact = reproj_factor_gram_plain(s, d)
    r, Jt, Jr6, Jd, m = factors.reproj_residual_jac_closed(s, d)
    w, c = factors.cauchy_weights(r, m)
    wf = w[..., None]
    scale = (*reproj_gram_plain((r * wf).abs(), (Jt * wf[..., None]).abs(),
                                (Jr6 * wf[..., None]).abs(), (Jd * wf).abs(),
                                anchor_onehot(d, r.shape[0], f64)),
             torch.sum(c))
    eps = torch.finfo(out[0].dtype).eps
    ratios = []
    for o, e, sc in zip(out, exact, scale):
        err = (o.to(f64) - e).abs()
        stray = torch.where(err > 0, torch.full_like(err, float("inf")),
                            torch.zeros_like(err))
        ratio = torch.where(sc > 0, err / (eps * sc).clamp_min(1e-300), stray)
        ratios.append(float(ratio.max()) if ratio.numel() else 0.0)
    return ratios


def grid(K: int, L: int):
    """(splits, K): CTA (s, a) takes the landmarks of slice s anchored
    at frame a."""
    return max(1, min(TARGET_CTAS // K, (L + 3) // 4)), K


_check = kbuild.check_arg


def _check_frames(K: int, dtype, device) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"reproj_gram kernel takes float32/float64, got {dtype}")
    if not 1 <= K <= MAX_FRAMES:
        raise ValueError(f"reproj_gram kernel takes 1 <= K <= {MAX_FRAMES} "
                         f"frames, got K={K}")
    if device.type != "cuda":
        raise ValueError(f"the reproj_gram kernel's tensors must be on a CUDA "
                         f"device, got {device}")


def _carve(K: int, L: int, S: int, dtype, device, with_cost: bool,
           batch: tuple = ()):
    """One allocation for every output and the CTA partials; `batch` is
    () or (N,), the leading axis of every array."""
    shapes = [batch + s for s in (
        (K, 6, K, 6), (K, 6), (L,), (K, 6, L), (L,), (),
        (K * S, COL_ROWS, K), (K * S, ANCHOR_ROWS), (K * S if with_cost else 0,))]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    buf = torch.empty((sum(sizes),), dtype=dtype, device=device)
    return [v.view(s) for v, s in zip(torch.split(buf, sizes), shapes)]


def reproj_gram_cuda(r, Jt, Jr6, Jd, R1):
    """Entry 1 on the card: three launches (anchors from R1, CTA
    partials, their ordered sum)."""
    if r.dim() != 3 or r.shape[2] != 2:
        raise ValueError(f"r must be (K,L,2), got {tuple(r.shape)}")
    K, L = r.shape[:2]
    dt, dev = r.dtype, r.device
    _check_frames(K, dt, dev)
    r = _check("r", r, (K, L, 2), dt, dev)
    Jt = _check("Jt", Jt, (K, L, 2, 6), dt, dev)
    Jr6 = _check("Jr6", Jr6, (K, L, 2, 6), dt, dev)
    Jd = _check("Jd", Jd, (K, L, 2), dt, dev)
    R1 = _check("R1", R1, (L, K), dt, dev)
    S, _ = grid(K, L)
    P, b6, Hll, Hfl6, bl, _, colpart, anchorpart, _ = _carve(K, L, S, dt, dev, False)
    ref_idx = torch.empty((L,), dtype=torch.int32, device=dev)
    lm_mask = torch.empty((L,), dtype=torch.uint8, device=dev)
    err = kbuild.REPROJ_GRAM.fn(ENTRY_GRAM)(
        r.data_ptr(), Jt.data_ptr(), Jr6.data_ptr(), Jd.data_ptr(),
        R1.data_ptr(), ref_idx.data_ptr(), lm_mask.data_ptr(),
        colpart.data_ptr(), anchorpart.data_ptr(), P.data_ptr(), b6.data_ptr(),
        Hll.data_ptr(), Hfl6.data_ptr(), bl.data_ptr(), K, L, S,
        1 if dt == torch.float64 else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "reproj_gram")
    kbuild.REPROJ_GRAM.count(ENTRY_GRAM)
    return P, b6, Hll, Hfl6, bl


def reproj_factor_gram_cuda(state: WindowState, data: WindowData):
    """Entry 2 on the card: two launches (CTA partials with the factor
    stage in registers, their ordered sum), for one window or a batch
    of N (a leading axis on every field; the outputs take it too)."""
    if state.q.dim() not in (2, 3) or data.bearings.dim() != state.q.dim() + 1:
        raise ValueError("reproj_factor_gram takes one window (q (K,4), bearings "
                         "(K,L,3)) or a batch (q (N,K,4), bearings (N,K,L,3))")
    batch = tuple(state.q.shape[:-2])
    N = batch[0] if batch else 1
    K, L = data.bearings.shape[-3:-1]
    dt, dev = state.p.dtype, state.p.device
    _check_frames(K, dt, dev)
    if N < 1:
        raise ValueError(f"reproj_factor_gram takes a batch of N >= 1, got {N}")
    q = _check("state.q", state.q, batch + (K, 4), dt, dev)
    p = _check("state.p", state.p, batch + (K, 3), dt, dev)
    invd = _check("state.inv_depth", state.inv_depth, batch + (L,), dt, dev)
    q_bc = _check("data.q_bc", data.q_bc, batch + (K, 4), dt, dev)
    p_bc = _check("data.p_bc", data.p_bc, batch + (K, 3), dt, dev)
    bearings = _check("data.bearings", data.bearings, batch + (K, L, 3), dt, dev)
    w2 = _check("data.sqrt_inv_cov2", data.sqrt_inv_cov2, batch + (K, 2, 2), dt, dev)
    obs_mask = _check("data.obs_mask", data.obs_mask, batch + (K, L), torch.bool, dev)
    lm_mask = _check("data.landmark_mask", data.landmark_mask, batch + (L,),
                     torch.bool, dev)
    ref_idx = _check("data.ref_idx", data.ref_idx, batch + (L,), torch.int32, dev)
    S, _ = grid(K, L)
    (P, b6, Hll, Hfl6, bl, cost, colpart, anchorpart,
     costpart) = _carve(K, L, S, dt, dev, True, batch)
    err = kbuild.REPROJ_GRAM.fn(ENTRY_FACTOR)(
        q.data_ptr(), p.data_ptr(), invd.data_ptr(), q_bc.data_ptr(),
        p_bc.data_ptr(), bearings.data_ptr(), obs_mask.data_ptr(),
        ref_idx.data_ptr(), w2.data_ptr(), lm_mask.data_ptr(),
        colpart.data_ptr(), anchorpart.data_ptr(), costpart.data_ptr(),
        P.data_ptr(), b6.data_ptr(), Hll.data_ptr(), Hfl6.data_ptr(),
        bl.data_ptr(), cost.data_ptr(), K, L, S, N,
        1 if dt == torch.float64 else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "reproj_factor_gram")
    kbuild.REPROJ_GRAM.count(ENTRY_FACTOR, windows=N)
    return P, b6, Hll, Hfl6, bl, cost


_dispatch = kbuild.dispatch


def reproj_gram(r, Jt, Jr6, Jd, R1):
    """K2, entry 1: plain PyTorch for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    fn = _dispatch(r, "reproj_gram", reproj_gram_cuda, reproj_gram_plain)
    return fn(r, Jt, Jr6, Jd, R1)


def reproj_factor_gram(state: WindowState, data: WindowData):
    """K2, entry 2 (one window, or a batch with a leading axis): plain
    PyTorch for CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = _dispatch(state.p, "reproj_factor_gram", reproj_factor_gram_cuda,
                   reproj_factor_gram_plain)
    return fn(state, data)


# ---- K3: the preintegration factor ----------------------------------------


def preint_blocks(H, b, rp, Ji, Jj, K):
    """Scatter the preintegration factor blocks (entry j couples frames
    j-1 and j) into H (K,15,K,15) and b (K,15)."""
    dt = rp.dtype
    idx_j = torch.arange(K, device=rp.device)
    oh_j = torch.eye(K, dtype=dt, device=rp.device)
    oh_i = torch.nn.functional.one_hot(torch.clamp(idx_j - 1, min=0), K).to(dt)
    for Ja, oha in ((Ji, oh_i), (Jj, oh_j)):
        b = b + torch.einsum("na,nk->ka", torch.einsum("nra,nr->na", Ja, rp), oha)
        for Jb, ohb in ((Ji, oh_i), (Jj, oh_j)):
            JJ = torch.einsum("nra,nrb->nab", Ja, Jb)
            H = H + torch.einsum("nab,nk,nm->kamb", JJ, oha, ohb)
    return H, b


def preint_factor_gram_plain(state: WindowState, data: WindowData, mask, H=None,
                             b=None, jac=factors.preint_residual_jac):
    """K3 in plain PyTorch: the factors of `jac` (the autodiff composition
    by default; `factors.preint_residual_jac_closed` gives the kernel's
    arithmetic), masked by `mask` (K,) (entry 0 is never a factor), their
    blocks added to H (K,15,K,15) and b (K,15) (zeros where None) by
    `preint_blocks`. Returns (H, b, 0.5·Σ|r|²). A batch (a leading axis
    on every field, the mask, H and b) runs the single-window version
    under `torch.func.vmap`."""
    K = state.q.shape[-2]
    batch = tuple(state.q.shape[:-2])
    H = state.p.new_zeros(batch + (K, 15, K, 15)) if H is None else H
    b = state.p.new_zeros(batch + (K, 15)) if b is None else b
    if batch:
        return vmap(lambda s, d, m, h, g: preint_factor_gram_plain(s, d, m, h, g, jac))(
            state, data, mask, H, b)
    r, Ji, Jj, _ = jac(state, data)
    mf = (mask & (torch.arange(K, device=mask.device) > 0)).to(r.dtype)
    r = r * mf[:, None]
    H, b = preint_blocks(H, b, r, Ji * mf[:, None, None], Jj * mf[:, None, None], K)
    return H, b, 0.5 * torch.sum(r * r)


def preint_factor_gram_cuda(state: WindowState, data: WindowData, mask, H=None,
                            b=None):
    """K3 on the card: one launch for one window or a batch of N (a
    leading axis on every field, the mask, H and b; the outputs take it
    too). H and b are copied and the copies updated; the caller's are
    left as they were."""
    if state.q.dim() not in (2, 3):
        raise ValueError("preint_factor_gram takes one window (q (K,4)) or a batch "
                         f"(q (N,K,4)), got q {tuple(state.q.shape)}")
    batch = tuple(state.q.shape[:-2])
    N = batch[0] if batch else 1
    K = state.q.shape[-2]
    dt, dev = state.p.dtype, state.p.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"preint_gram kernel takes float32/float64, got {dt}")
    if dev.type != "cuda":
        raise ValueError(f"the preint_gram kernel's tensors must be on a CUDA "
                         f"device, got {dev}")
    if K < 1 or N < 1:
        raise ValueError(f"preint_gram kernel takes K >= 1 frames and N >= 1 "
                         f"windows, got K={K}, N={N}")
    d = data.preint
    f3, m3 = batch + (K, 3), batch + (K, 3, 3)
    args = [_check(name, x, shape, dt, dev) for name, x, shape in (
        ("state.q", state.q, batch + (K, 4)), ("state.p", state.p, f3),
        ("state.v", state.v, f3), ("state.bg", state.bg, f3), ("state.ba", state.ba, f3),
        ("data.q_bi", data.q_bi, batch + (K, 4)), ("data.p_bi", data.p_bi, f3),
        ("preint.t", d.t, batch + (K,)), ("preint.q", d.q, batch + (K, 4)),
        ("preint.p", d.p, f3), ("preint.v", d.v, f3),
        ("preint.sqrt_inv_cov", d.sqrt_inv_cov, batch + (K, 15, 15)),
        ("preint.dq_dbg", d.dq_dbg, m3), ("preint.dp_dbg", d.dp_dbg, m3),
        ("preint.dp_dba", d.dp_dba, m3), ("preint.dv_dbg", d.dv_dbg, m3),
        ("preint.dv_dba", d.dv_dba, m3), ("data.bg_lin", data.bg_lin, f3),
        ("data.ba_lin", data.ba_lin, f3))]
    args.append(_check("mask", mask, batch + (K,), torch.bool, dev))
    H = (torch.zeros(batch + (K, 15, K, 15), dtype=dt, device=dev) if H is None
         else _check("H", H, batch + (K, 15, K, 15), dt, dev).clone())
    b = (torch.zeros(batch + (K, 15), dtype=dt, device=dev) if b is None
         else _check("b", b, batch + (K, 15), dt, dev).clone())
    cost = torch.empty(batch, dtype=dt, device=dev)
    err = kbuild.PREINT_GRAM.fn()(
        *(x.data_ptr() for x in args), H.data_ptr(), b.data_ptr(), cost.data_ptr(),
        K, N, 1 if dt == torch.float64 else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "preint_factor_gram")
    kbuild.PREINT_GRAM.count(windows=N)
    return H, b, cost


def preint_factor_gram(state: WindowState, data: WindowData, mask, H=None, b=None):
    """K3 (one window, or a batch with a leading axis): plain PyTorch for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = _dispatch(state.p, "preint_factor_gram", preint_factor_gram_cuda,
                   preint_factor_gram_plain)
    return fn(state, data, mask, H, b)
