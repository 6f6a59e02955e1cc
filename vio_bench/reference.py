"""The plain reference that decides `correct`, in PyTorch and numpy.

It imports nothing of the program under test and takes none of its
prepared data: it gets the inputs that the benchmark made (the IMU
samples, the ground truth) and, where the check follows the program
step by step, the state that the program held before the step and the
answer that it gave after it.

- `solve_window`: a window solve. The window's cost (robust
  reprojection factors in the observed bearing's tangent plane,
  rotation-only factors, IMU preintegration factors and the dense
  marginalization prior) is written out here, its Jacobian taken by
  forward-mode autodiff over the whole error state, and the same
  Levenberg-Marquardt schedule run on the dense normal equations: the
  same damping, the same accept test and the same fixed count of
  iterations.
- `refine_pnp`: the camera-rate pose-only PnP refine, by autodiff.
- `propagate`: a published pose, the IMU forward-propagation of the
  solved state it starts from.
- `ate`: the published trajectory against the ground truth after a
  rigid alignment.

Every function takes a `dtype`: float64 is the reference, float32 the
control that has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geom

GRAVITY = (0.0, 0.0, -9.80665)
ES = 15   # error state of a frame: theta, p, v, bg, ba


# --------------------------------------------------------------------------
# the window solve
# --------------------------------------------------------------------------

def _retract(st: dict, dx: torch.Tensor, K: int) -> dict:
    f = dx[:K * ES].reshape(K, ES)
    return dict(q=geom.qnormalize(geom.qmul(st["q"], geom.expmap(f[:, 0:3]))),
                p=st["p"] + f[:, 3:6], v=st["v"] + f[:, 6:9],
                bg=st["bg"] + f[:, 9:12], ba=st["ba"] + f[:, 12:15],
                inv_depth=st["inv_depth"] + dx[K * ES:])


def _state_error(st: dict, lin: dict) -> torch.Tensor:
    return torch.cat([geom.logmap(geom.qmul(geom.qconj(lin["q"]), st["q"])),
                      st["p"] - lin["p"], st["v"] - lin["v"],
                      st["bg"] - lin["bg"], st["ba"] - lin["ba"]], dim=-1)


def _observations(d: dict):
    """Active (k, l) pairs, the bearings with unit-z in the inactive
    slots, and each landmark's anchor bearing."""
    K, L = d["obs_mask"].shape
    ref = d["ref_idx"].long()
    ez = torch.zeros_like(d["bearings"])
    ez[..., 2] = 1.0
    b = torch.where(d["obs_mask"][..., None], d["bearings"], ez)
    k = torch.arange(K, device=ref.device)
    active = d["obs_mask"] & d["landmark_mask"][None] & (k[:, None] != ref[None])
    z_ref = b[ref, torch.arange(L, device=ref.device)]
    return ref, b, active, z_ref


def _project(tb: torch.Tensor, W2: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W2 · (u[:2] / u[2]), u the camera point y in the observed
    bearing's frame [t1 t2 b]."""
    u = (tb * y[..., :, None]).sum(-2)
    n = u[..., :2] / u[..., 2:3]
    return (W2 * n[..., None, :]).sum(-1)


def _residuals(dx, st: dict, d: dict, opts: dict, weights=None):
    """The window's residuals at st ⊞ dx, one vector: reprojection
    rows (times their IRLS weights when `weights` is given), rotation
    rows, preintegration rows, prior rows; with the robust costs of the
    reprojection and rotation rows."""
    K, L = d["obs_mask"].shape
    # the inverse depths are guarded at the linearization point, and
    # landmarks outside the window read 1
    d0 = st["inv_depth"]
    d0 = torch.where(d["landmark_mask"],
                     torch.where(torch.abs(d0) < 1e-12, 1e-12, d0), 1.0)
    x = _retract(dict(st, inv_depth=d0), dx, K)
    ref, b, active, z_ref = _observations(d)
    basis = torch.cat([geom.tangent_basis(b), b[..., None]], dim=-1)   # (K,L,3,3)
    W2 = d["sqrt_inv_cov2"][:, None].expand(K, L, 2, 2)
    rows, costs = [], []
    if opts["use_reproj"]:
        di = x["inv_depth"]
        y_ref = geom.rotate(d["q_bc"][ref], z_ref / di[:, None]) + d["p_bc"][ref]
        X = geom.rotate(x["q"][ref], y_ref) + x["p"][ref]                 # (L,3)
        yc = geom.rotate_inv(x["q"][:, None], X[None] - x["p"][:, None])
        y = geom.rotate_inv(d["q_bc"][:, None], yc - d["p_bc"][:, None])
        r = _project(basis, W2, y) * active[..., None]
        rows.append(r)
        costs.append(r)
    if opts["use_rotation"]:
        q_ref = st["q"][ref]          # only the target's orientation moves
        zc = geom.rotate(d["q_bc"][ref], z_ref) + d["p_bc"][ref]
        yc = geom.rotate_inv(x["q"][:, None], geom.rotate(q_ref, zc)[None])
        y = geom.rotate_inv(d["q_bc"][:, None], yc - d["p_bc"][:, None])
        r = _project(basis, W2, y) * active[..., None]
        rows.append(r)
        costs.append(r)
    robust = torch.stack([0.5 * torch.log1p(torch.sum(r * r, -1)) * active
                          for r in costs]).sum() if costs else dx.new_zeros(())
    if weights is not None:
        rows = [r * w[..., None] for r, w in zip(rows, weights)]
    out = [r.reshape(-1) for r in rows]
    quad = []
    if opts["use_preint"]:
        rp = _preint(x, d)
        out.append(rp.reshape(-1))
        quad.append(rp.reshape(-1))
    rm = _prior(x, d)
    out.append(rm)
    quad.append(rm)
    return torch.cat(out), robust + 0.5 * sum(torch.sum(r * r) for r in quad), rows


def _preint(x: dict, d: dict) -> torch.Tensor:
    """(K, 15) whitened preintegration residuals; entry j ties frame
    j-1 to frame j."""
    K = x["q"].shape[0]
    j = torch.arange(K, device=x["q"].device)
    i = torch.clamp(j - 1, min=0)
    g = x["p"].new_tensor(GRAVITY)
    pr = d["preint"]
    qi = geom.qmul(x["q"][i], d["q_bi"][i])
    pi = x["p"][i] + geom.rotate(x["q"][i], d["p_bi"][i])
    qj = geom.qmul(x["q"], d["q_bi"])
    pj = x["p"] + geom.rotate(x["q"], d["p_bi"])
    dt = pr["t"][:, None]
    dbg = x["bg"][i] - d["bg_lin"]
    dba = x["ba"][i] - d["ba_lin"]

    def mv(m, v):
        return torch.einsum("kij,kj->ki", m, v)

    q_corr = geom.qmul(pr["q"], geom.expmap(mv(pr["dq_dbg"], dbg)))
    r_q = geom.logmap(geom.qmul(geom.qconj(q_corr), geom.qmul(geom.qconj(qi), qj)))
    r_p = geom.rotate_inv(qi, pj - pi - dt * x["v"][i] - 0.5 * dt * dt * g) - (
        pr["p"] + mv(pr["dp_dbg"], dbg) + mv(pr["dp_dba"], dba))
    r_v = geom.rotate_inv(qi, x["v"] - x["v"][i] - dt * g) - (
        pr["v"] + mv(pr["dv_dbg"], dbg) + mv(pr["dv_dba"], dba))
    r = torch.cat([r_q, r_p, r_v, x["bg"] - x["bg"][i], x["ba"] - x["ba"][i]], -1)
    m = d["preint_mask"] & (j > 0)
    return mv(pr["sqrt_inv_cov"], r) * m[:, None]


def _prior(x: dict, d: dict) -> torch.Tensor:
    e = _state_error(x, d["marg_lin"]).reshape(-1)
    return (d["marg_U"] @ e + d["marg_infovec"]) * d["use_marg"]


def _free(d: dict, dtype) -> torch.Tensor:
    """1 for each error-state entry the solve may move."""
    pose = d["frame_mask"] & ~d["fix_pose"]
    motion = d["frame_mask"] & ~d["fix_motion"]
    f = torch.cat([pose[:, None].expand(-1, 6), motion[:, None].expand(-1, 9)], 1)
    lm = d["landmark_mask"] & ~d["fix_landmark"]
    return torch.cat([f.reshape(-1), lm]).to(dtype)


def _system(st: dict, d: dict, opts: dict, chunk: int = 96):
    """The masked Gauss-Newton system (H, b) at st and the cost there:
    forward-mode Jacobian of the weighted residuals, the IRLS weights
    sqrt(1/(1+|r|^2)) held fixed."""
    K, L = d["obs_mask"].shape
    n = K * ES + L
    zero = st["p"].new_zeros(n)
    r0, cost, rows = _residuals(zero, st, d, opts)
    weights = [torch.sqrt(1.0 / (1.0 + torch.sum(r * r, -1))) for r in rows]

    def f(dx):
        return _residuals(dx, st, d, opts, weights)[0]

    r = f(zero)
    eye = torch.eye(n, dtype=zero.dtype, device=zero.device)
    jcols = [torch.func.vmap(lambda t: torch.func.jvp(f, (zero,), (t,))[1])(
        eye[c:c + chunk]) for c in range(0, n, chunk)]
    J = torch.cat(jcols).T.to(zero.dtype)                       # (rows, n)
    H = J.T @ J
    b = J.T @ r
    free = _free(d, zero.dtype)
    nf = K * ES
    # landmarks the factors do not see are held, as fixed ones are
    lm_seen = torch.diagonal(H)[nf:] > 1e-12
    free = torch.cat([free[:nf], free[nf:] * lm_seen.to(free.dtype)])
    H = H * free[:, None] * free[None, :]
    diag = torch.diagonal(H).clone()
    diag[:nf] += 1.0 - free[:nf]
    diag[:nf] += ((torch.diagonal(H)[:nf] < 1e-12) & (free[:nf] > 0)).to(H.dtype)
    diag[nf:] = torch.where(free[nf:] > 0, diag[nf:], 1.0)
    H = H - torch.diag(torch.diagonal(H)) + torch.diag(diag)
    return H, b * free, cost


def _step(sys, st: dict, lam, K: int) -> dict:
    """One damped step: (H + lam diag H) dx = -b by a Jacobi-scaled
    Cholesky solve; a system that is not positive definite gives a
    non-finite candidate, which the accept test rejects."""
    H, b, _ = sys
    A = H + lam * torch.diag(torch.diagonal(H))
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    Lc, info = torch.linalg.cholesky_ex(A * s[:, None] * s[None, :])
    dx = s * torch.cholesky_solve((-b * s)[:, None], Lc)[:, 0]
    dx = torch.where(info == 0, dx, float("nan"))
    return _retract(st, dx, K)


def solve_window(state: dict, data: dict, opts: dict, dtype=torch.float64) -> dict:
    """The window solve: `opts["iterations"]` LM iterations from
    `state`; the candidate of iteration i is judged by the cost at the
    start of iteration i+1, a rejected step is retried from the best
    state with ten times the damping, an accepted one halves it.
    Returns the best state."""
    st = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    d = _cast(data, dtype)
    K = st["q"].shape[0]
    sys_best = _system(st, d, opts)
    cost_best = sys_best[2]
    lam = torch.full_like(cost_best, opts["lm_init"])
    best = st
    cand = _step(sys_best, st, lam, K)
    for it in range(opts["iterations"]):
        sys_c = _system(cand, d, opts)
        good = bool(torch.isfinite(sys_c[2])) and bool(sys_c[2] < cost_best)
        if good:
            best, sys_best, cost_best = cand, sys_c, sys_c[2]
        lam = torch.clamp(lam * (opts["lm_down"] if good else opts["lm_up"]),
                          opts["lm_min"], opts["lm_max"])
        if it + 1 < opts["iterations"]:
            cand = _step(sys_best, best, lam, K)
    return best


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return x.to(dtype) if x.is_floating_point() else x


def cost(state: dict, data: dict, opts: dict) -> float:
    """The window's cost at `state`, in float64."""
    st = _cast(state, torch.float64)
    d = _cast(data, torch.float64)
    K, L = d["obs_mask"].shape
    return float(_residuals(st["p"].new_zeros(K * ES + L), st, d, opts)[1])


def solve_gap(out: dict, ref: dict, data: dict, opts: dict) -> float:
    """How far the program's solved window lies from the reference's:
    |cost(out) - cost(ref)| / cost(ref), both costs by the reference.
    Solves that agree reach the same cost to rounding, whatever they do
    along directions the data leave unconstrained, where a window that
    has converged may drift by rounding alone."""
    c_ref = cost(ref, data, opts)
    gap = abs(cost(out, data, opts) - c_ref) / max(c_ref, 1e-300)
    return gap if np.isfinite(gap) else float("inf")


# --------------------------------------------------------------------------
# the camera-rate PnP refine
# --------------------------------------------------------------------------

def refine_pnp(q_wc, p_wc, X, bearings, valid, W2, iters: int, damping: float = 1e-6,
               dtype=torch.float64):
    """Pose-only robust Gauss-Newton against known world points: the
    residual W2 · Tbᵀ · (y/|y|), y the point in the camera, Tb the
    observed bearing's tangent basis; Cauchy IRLS weights 1/(1+|r|^2)
    on the Jacobian's rows of the normal matrix and the gradient; the
    step on q ⊗ exp(dθ), p + dp."""
    q, p, X, bearings, W2 = (t.to(dtype) for t in (q_wc, p_wc, X, bearings, W2))
    m = valid.to(dtype)
    Tb = geom.tangent_basis(bearings)
    eye6 = torch.eye(6, dtype=dtype, device=X.device)

    WTb = W2 @ Tb.transpose(-1, -2) * m[:, None, None]          # (N,2,3)
    for _ in range(iters):
        def res(dx, q=q, p=p):
            y = geom.rotate_inv(geom.qmul(q, geom.expmap(dx[:3])), X - (p + dx[3:]))
            n = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(min=1e-12)
            return (WTb * n[:, None, :]).sum(-1)

        zero = X.new_zeros(6)
        r = res(zero)
        J = torch.func.jacfwd(res)(zero).to(dtype)      # (N,2,6)
        w = 1.0 / (1.0 + torch.sum(r * r, -1))
        H = torch.einsum("nki,nkj->ij", J * w[:, None, None], J) + damping * eye6
        g = torch.einsum("nki,nk->i", J * w[:, None, None], r)
        dx = -torch.linalg.solve_ex(H, g)[0]
        q = geom.qnormalize(geom.qmul(q, geom.expmap(dx[:3])))
        p = p + dx[3:]
    return q, p


# --------------------------------------------------------------------------
# published poses
# --------------------------------------------------------------------------

def propagate(start: dict, imu_t, imu_w, imu_a, t_end: float, dtype=np.float64):
    """(q, p) at the last IMU sample at or before t_end, from the solved
    state `start` (t, q, p, v, bg, ba), one Euler step a sample after
    start["t"]: v += dt (R(q)(a - ba) + g), p += dt v,
    q = normalize(q ⊗ exp((w - bg) dt))."""
    t = dtype(start["t"])
    q = np.asarray(start["q"], dtype)
    p = np.asarray(start["p"], dtype)
    v = np.asarray(start["v"], dtype)
    bg = np.asarray(start["bg"], dtype)
    ba = np.asarray(start["ba"], dtype)
    g = np.asarray(GRAVITY, dtype)
    sel = np.nonzero((imu_t > start["t"]) & (imu_t <= t_end))[0]
    for i in sel:
        ti = dtype(imu_t[i])
        dt = ti - t
        qt = torch.from_numpy(q)
        v = v + dt * (geom.rotate(qt, torch.from_numpy(imu_a[i].astype(dtype) - ba))
                      .numpy() + g)
        p = p + dt * v
        dq = geom.expmap(torch.from_numpy((imu_w[i].astype(dtype) - bg) * dt))
        q = geom.qnormalize(geom.qmul(qt, dq)).numpy()
        t = ti
    return q, p


def pose_gap(published: dict, start: dict, stream, t_due: float) -> float:
    """Distance (m) between a published position and the reference's
    propagation of the state it was propagated from, up to `t_due`, the
    time of the newest sample pushed before the pose was read."""
    _, p = propagate(start, stream.imu_t, stream.imu_w, stream.imu_a, t_due)
    return float(np.linalg.norm(np.asarray(published["p"]) - p))


def ate(t_pub, p_pub, t_gt, p_gt) -> float:
    """RMSE (m) of the published positions against the ground truth at
    the same times, after the rigid motion (rotation and translation,
    no scale: the system is metric) that fits them best."""
    idx = np.searchsorted(t_gt, t_pub)
    idx = np.clip(idx, 0, len(t_gt) - 1)
    ok = np.abs(t_gt[idx] - t_pub) < 1e-6
    A = np.asarray(p_pub)[ok]
    B = np.asarray(p_gt)[idx[ok]]
    if len(A) < 3:
        return float("inf")
    ca, cb = A.mean(0), B.mean(0)
    U, _, Vt = np.linalg.svd((B - cb).T @ (A - ca))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    err = (R @ (A - ca).T).T + cb - B
    return float(np.sqrt(np.mean(np.sum(err * err, 1))))


# --------------------------------------------------------------------------
# the frontend: CLAHE, the pyramid, pyramidal Lucas-Kanade (K1)
# --------------------------------------------------------------------------

GAUSS5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
SCHARR_D = (-1.0, 0.0, 1.0)
SCHARR_S = (3 / 32, 10 / 32, 3 / 32)
MIN_EIG = 1e-4       # the smallest eigenvalue of a window's gradient matrix, per pixel
SEARCH, SEARCH_LO = 64, 32


def clahe(img_u8: torch.Tensor, clip: float, tiles_x: int, tiles_y: int, dtype):
    """Contrast-limited adaptive histogram equalization of a uint8
    image: a 256-bin histogram per tile clipped at clip·area/256, the
    excess spread evenly, the rounded CDF as the tile's lookup table,
    and each pixel blended bilinearly between the tables of the four
    tiles around it."""
    H, W = img_u8.shape
    th, tw = H // tiles_y, W // tiles_x
    area = th * tw
    v = img_u8.long()
    ty = torch.clamp(torch.arange(H, device=v.device) // th, max=tiles_y - 1)
    tx = torch.clamp(torch.arange(W, device=v.device) // tw, max=tiles_x - 1)
    tile = ty[:, None] * tiles_x + tx[None, :]
    hist = torch.zeros(tiles_y * tiles_x * 256, dtype=dtype, device=v.device)
    hist.index_put_(((tile * 256 + v).reshape(-1),),
                    torch.ones(H * W, dtype=dtype, device=v.device), accumulate=True)
    hist = hist.reshape(tiles_y, tiles_x, 256)
    limit = max(1.0, clip * area / 256.0)
    kept = torch.clamp(hist, max=limit)
    cdf = torch.cumsum(kept + (hist - kept).sum(-1, keepdim=True) / 256.0, dim=-1)
    lut = torch.clamp(torch.round(cdf * (255.0 / area)), 0, 255)

    def axis(n, t, size):
        f = (torch.arange(n, device=v.device, dtype=dtype) + 0.5) / size - 0.5
        i0 = torch.clamp(torch.floor(f).long(), 0, t - 1)
        return i0, torch.clamp(i0 + 1, max=t - 1), torch.clamp(f - i0, 0.0, 1.0)

    y0, y1, wy = axis(H, tiles_y, th)
    x0, x1, wx = axis(W, tiles_x, tw)
    wy, wx = wy[:, None], wx[None, :]
    Y0, Y1, X0, X1 = y0[:, None], y1[:, None], x0[None], x1[None]
    left = (1 - wy) * lut[Y0, X0, v] + wy * lut[Y1, X0, v]
    right = (1 - wy) * lut[Y0, X1, v] + wy * lut[Y1, X1, v]
    return (1 - wx) * left + wx * right


def _correlate(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable correlation with a replicated border: along y with
    `ky`, then along x with `kx`."""
    rx, ry = len(kx) // 2, len(ky) // 2
    H, W = img.shape[-2:]
    p = torch.nn.functional.pad(img[None, None], (rx, rx, ry, ry), mode="replicate")[0, 0]
    cols = sum(w * p[i:i + H, :] for i, w in enumerate(ky) if w != 0.0)
    return sum(w * cols[:, j:j + W] for j, w in enumerate(kx) if w != 0.0)


def pyramid(img_u8: torch.Tensor, levels: int, clip: float, tiles_x: int, tiles_y: int,
            dtype=torch.float64):
    """The tracker's image pyramid: CLAHE, then `levels` times a 5-tap
    Gaussian blur and 2x decimation."""
    pyr = [clahe(img_u8, clip, tiles_x, tiles_y, dtype)]
    for _ in range(levels):
        pyr.append(_correlate(pyr[-1], GAUSS5, GAUSS5)[::2, ::2])
    return pyr


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img at real positions (x, y), zero outside the image."""
    H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()

    def at(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return torch.where(inside, img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)], 0.0)

    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
            + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))


def _template(img: torch.Tensor, pts: torch.Tensor, win: int):
    """(N, win, win) windows of img around pts, their corner clamped
    inside the image."""
    H, W = img.shape
    r = win // 2
    x0 = pts[:, 0] - r
    y0 = pts[:, 1] - r
    ix = torch.clamp(torch.floor(x0), 0, max(W - win - 1, 0))
    iy = torch.clamp(torch.floor(y0), 0, max(H - win - 1, 0))
    t = torch.arange(win, device=img.device, dtype=img.dtype)
    xs = ix[:, None, None] + (x0 - ix)[:, None, None] + t[None, None, :]
    ys = iy[:, None, None] + (y0 - iy)[:, None, None] + t[None, :, None]
    return _bilinear(img, xs, ys)


def _lk_level(prev, nxt, pts, guess, valid, win, iters, eps, final, search):
    """One pyramid level of Lucas-Kanade for every point: the template
    and its Scharr gradients around pts in prev; the window in nxt
    within a (search x search) block around the guess (zero past the
    image), its corner held inside the block; Gauss-Newton steps until
    a step is shorter than eps. Returns (guess, valid, err)."""
    H, W = prev.shape
    r = win // 2
    ix, iy = _correlate(prev, SCHARR_D, SCHARR_S), _correlate(prev, SCHARR_S, SCHARR_D)
    T, Ix, Iy = (_template(a, pts, win) for a in (prev, ix, iy))
    gxx, gxy, gyy = ((a * b).sum((1, 2)) for a, b in ((Ix, Ix), (Ix, Iy), (Iy, Iy)))
    det = gxx * gyy - gxy * gxy
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy * gxy))
    good = ((gxx + gyy) > 0) & (min_eig / (win * win) > MIN_EIG) & (det > 1e-12)
    inv_det = torch.where(det > 1e-12, 1.0 / torch.where(det > 0, det, 1.0), 0.0)
    inside = ((pts[:, 0] >= r) & (pts[:, 0] < W - r)
              & (pts[:, 1] >= r) & (pts[:, 1] < H - r))
    cx = torch.clamp(torch.floor(guess[:, 0]) - search // 2, 0, max(W - search, 0))
    cy = torch.clamp(torch.floor(guess[:, 1]) - search // 2, 0, max(H - search, 0))
    top = float(search - win - 1)
    t = torch.arange(win, device=prev.device, dtype=prev.dtype)

    def window(lx, ly):
        x = cx + torch.clamp(lx - r, 0.0, top)
        y = cy + torch.clamp(ly - r, 0.0, top)
        xs = x[:, None, None] + t[None, None, :]
        ys = y[:, None, None] + t[None, :, None]
        # the block's own edge: zero past it, as past the image
        blk = (xs <= cx[:, None, None] + search - 1) & (ys <= cy[:, None, None] + search - 1)
        return torch.where(blk, _bilinear(nxt, xs, ys), 0.0)

    lx, ly = guess[:, 0] - cx, guess[:, 1] - cy
    done = ~(good & inside & valid)
    for _ in range(iters):
        diff = window(lx, ly) - T
        bx, by = (diff * Ix).sum((1, 2)), (diff * Iy).sum((1, 2))
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        lx = torch.where(done, lx, lx + dx)
        ly = torch.where(done, ly, ly + dy)
        done = done | ((dx * dx + dy * dy) < eps * eps)
    use = valid & good & inside
    out = torch.stack([torch.where(use, lx + cx, guess[:, 0]),
                       torch.where(use, ly + cy, guess[:, 1])], dim=-1)
    err = torch.abs(window(lx, ly) - T).mean((1, 2)) if final else torch.zeros_like(lx)
    return out, (use if final else valid), err


def _lk(prev_pyr, next_pyr, pts, init, valid, win, iters, eps, search_top):
    levels = len(prev_pyr)
    guess = init / float(2 ** (levels - 1))
    err = None
    for lev in range(levels - 1, -1, -1):
        s = float(2 ** lev)
        guess, valid, err = _lk_level(prev_pyr[lev], next_pyr[lev], pts / s, guess, valid,
                                      win, iters, eps, lev == 0,
                                      search_top if lev == levels - 1 else SEARCH_LO)
        if lev > 0:
            guess = guess * 2.0
    return guess, valid, err


def track(prev_pyr, next_pyr, pts, init, valid, win=21, iters=30, eps=0.01, border=20,
          reverse_thresh=0.5, max_residual=25.0, dtype=torch.float64):
    """Pyramidal LK of a frame pair from pts (seeded at init), kept
    where the track ends `border` px inside the image, moved at most a
    quarter of the image's height, matches its template to a mean
    residual of max_residual and tracks back from level 0 to within
    reverse_thresh px. Returns (positions, kept): untracked points
    keep their seed."""
    prev_pyr = [p.to(dtype) for p in prev_pyr]
    next_pyr = [p.to(dtype) for p in next_pyr]
    pts, init = pts.to(dtype), init.to(dtype)
    H, W = prev_pyr[0].shape
    fwd, ok, err = _lk(prev_pyr, next_pyr, pts, init, valid, win, iters, eps, SEARCH)
    ok = (ok & (fwd[:, 0] >= border) & (fwd[:, 0] < W - border)
          & (fwd[:, 1] >= border) & (fwd[:, 1] < H - border)
          & (torch.linalg.vector_norm(fwd - pts, dim=-1) <= H / 4.0) & (err <= max_residual))
    back, ok_b, _ = _lk(next_pyr[:1], prev_pyr[:1], fwd, pts, ok, win, iters, eps, SEARCH_LO)
    ok = ok & ok_b & (torch.linalg.vector_norm(back - pts, dim=-1) <= reverse_thresh)
    return torch.where(ok[:, None], fwd, init), ok


def track_gap(out_pts, out_ok, ref_pts, ref_ok, valid) -> tuple:
    """(share, px): over the slots given to the tracker, the share whose
    kept/lost verdicts differ between the program and the reference;
    over the slots both keep, the largest distance (px) between their
    tracked positions."""
    differ = (out_ok != ref_ok)[valid]
    share = int(differ.sum()) / differ.numel() if differ.numel() else 0.0
    both = valid & out_ok & ref_ok
    d = torch.linalg.vector_norm(out_pts.double() - ref_pts.double(), dim=-1)[both]
    return share, (float(d.max()) if d.numel() else 0.0)


# --------------------------------------------------------------------------
# marginalization
# --------------------------------------------------------------------------

def marginalize(state: dict, data: dict, victim: int, clamp: float = 1e-8,
                dtype=torch.float64):
    """The prior left when frame `victim` leaves the window: the
    information of the current prior, of the preintegration factors
    that touch the victim and of the unweighted reprojection factors of
    every landmark the victim observes (landmarks Schur-eliminated),
    with the victim's block Schur-eliminated, the later frames moved
    one slot down, the last slot and absent frames dropped. Returns
    the information matrix and vector (H, b) over the new slots, from
    an eigendecomposition with eigenvalues under `clamp` dropped."""
    st = _cast(state, dtype)
    d = _cast(data, dtype)
    K, L = d["obs_mask"].shape
    n = K * ES + L
    nf = K * ES
    opts = dict(use_reproj=True, use_rotation=False, use_preint=True)
    zero = st["p"].new_zeros(n)

    def f(dx):
        return _residuals(dx, st, d, opts)[0]

    r = f(zero)
    eye = torch.eye(n, dtype=dtype, device=zero.device)
    J = torch.cat([torch.func.vmap(lambda t: torch.func.jvp(f, (zero,), (t,))[1])(
        eye[c:c + 96]) for c in range(0, n, 96)]).T.to(dtype)
    # rows: reprojection (K, L, 2), preintegration (K, 15), prior (K*15)
    lm = (d["obs_mask"][victim] & d["landmark_mask"])
    rows_rep = lm[None, :, None].expand(K, L, 2).reshape(-1)
    j = torch.arange(K, device=zero.device)
    rows_pre = ((j == victim) & (victim >= 1)) | (j == victim + 1)
    rows = torch.cat([rows_rep, rows_pre[:, None].expand(K, ES).reshape(-1),
                      torch.ones(nf, dtype=torch.bool, device=zero.device)]).to(dtype)
    J = J * rows[:, None]
    r = r * rows
    H, b = J.T @ J, J.T @ r
    Hff, Hfl, Hll, bf, bl = H[:nf, :nf], H[:nf, nf:], torch.diagonal(H)[nf:], b[:nf], b[nf:]
    inv = torch.where(Hll > 1e-12, 1.0 / torch.where(Hll > 0, Hll, 1.0), 0.0)
    H = Hff - (Hfl * inv) @ Hfl.T
    b = bf - Hfl @ (inv * bl)
    v = slice(victim * ES, (victim + 1) * ES)
    Hvv_inv = torch.linalg.inv(H[v, v])
    b = b - H[:, v] @ (Hvv_inv @ b[v])
    H = H - H[:, v] @ Hvv_inv @ H[v, :]
    order = [s for s in range(K) if s != victim] + [victim]
    idx = torch.tensor([s * ES + e for s in order for e in range(ES)], device=zero.device)
    H, b = H[idx][:, idx], b[idx]
    fm = d["frame_mask"][torch.tensor(order, device=zero.device)].clone()
    fm[K - 1] = False
    keep = fm[:, None].expand(K, ES).reshape(-1).to(dtype)
    H = H * keep[:, None] * keep[None, :]
    b = b * keep
    lam, V = torch.linalg.eigh(0.5 * (H + H.T))
    pos = lam > clamp
    Hc = (V * torch.where(pos, lam, 0.0)) @ V.T
    bc = V @ (torch.where(pos, 1.0, 0.0) * (V.T @ b))
    return Hc, bc


def marg_gap(H, b, H_ref, b_ref) -> float:
    """Relative distance of a prior's information matrix and vector
    (H = Uᵀ U and b = Uᵀ iv of a sqrt-information prior) from the
    reference's: the larger of the two."""
    gH = torch.linalg.norm(H.double() - H_ref) / torch.linalg.norm(H_ref).clamp(min=1e-300)
    gb = torch.linalg.norm(b.double() - b_ref) / torch.linalg.norm(b_ref).clamp(min=1e-300)
    return float(torch.maximum(gH, gb))
