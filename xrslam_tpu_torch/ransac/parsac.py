"""PARSAC / IMU-PARSAC: prior-guided spatial-bin RANSAC as fixed-shape
masked reductions (port of `xrslam_tpu/ransac/parsac.py`).

  - 20×20 bins over [-scale, scale]² image coordinates; the per-bin
    confidence is state carried from frame to frame by the caller,
  - prior confidences floored at 0.5, each bin's weight spread over its
    members, for the confidence-weighted minimal-sample draw,
  - hypothesis score = spatial coverage of inliers × confidence sum:
    per-bin inlier fraction c_b, confidence-weighted location
    covariance C, score = sqrt(det C)·Σc_b·Σc_b/((Σc_b)²−Σc_b²),
  - IMU variant: prior-pose inlier gate at 2× threshold, hypothesis
    admission by overlap with the prior inlier set, per-bin mean track
    length and dynamic-probability weight t = 1 − p^(0.1·len).

Every per-bin sum is a product with the (N, 400) one-hot bin matrix in
the points' dtype, not a scatter-add: on CUDA, `index_add_`,
`scatter_add_` and `bincount` with float weights use atomics, whose
summation order changes from run to run. The bin confidences are
carried from frame to frame and the best hypothesis is an argmax over
near-equal scores, so one flipped bit would change later frames; a
matrix product sums in a fixed order and repeats are bit-equal.

The best hypothesis is picked with `core.take` (no device sync), and
the only host value an entry takes is the dynamic probability.

Solvers and evaluators are batched as in `core.ransac`:
solver(idx (H,dof), *data) -> models with leading H (optionally (H,V));
evaluator(models, *data) -> errors (H,N) or (H,V,N).
"""

from __future__ import annotations

import torch

from ..utils.tree import tree_map
from . import core

N_BINS_X = 20
N_BINS_Y = 20
N_BINS = N_BINS_X * N_BINS_Y
MIN_PRIOR_BIN_CONFIDENCE = 0.5


def initial_bin_confidences(dtype=torch.float64, device=None) -> torch.Tensor:
    """The reference's `binConfidences(400, 0.5)` initial state."""
    return torch.full((N_BINS,), 0.5, dtype=dtype, device=device)


def bucket_points(pts: torch.Tensor, norm_scale: float = 1.0) -> torch.Tensor:
    """Bin index (N,) of each 2-d point over the 20×20 grid spanning
    [-norm_scale, norm_scale]² (truncation toward zero, then clip)."""
    bw = 2.0 * norm_scale / N_BINS_X
    bh = 2.0 * norm_scale / N_BINS_Y
    ix = torch.clamp(((pts[..., 0] + norm_scale) / bw).to(torch.int64), 0, N_BINS_X - 1)
    iy = torch.clamp(((pts[..., 1] + norm_scale) / bh).to(torch.int64), 0, N_BINS_Y - 1)
    return ix + N_BINS_X * iy


def bin_locations(norm_scale: float = 1.0, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    """Bin-center coordinates (400, 2), x fastest."""
    bw = 2.0 * norm_scale / N_BINS_X
    bh = 2.0 * norm_scale / N_BINS_Y
    xs = (torch.arange(N_BINS_X, dtype=dtype, device=device) + 0.5) * bw - norm_scale
    ys = (torch.arange(N_BINS_Y, dtype=dtype, device=device) + 0.5) * bh - norm_scale
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def _onehot(bin_idx: torch.Tensor, dtype) -> torch.Tensor:
    """(N, 400) one-hot bin matrix."""
    bins = torch.arange(N_BINS, device=bin_idx.device)
    return (bin_idx[:, None] == bins[None, :]).to(dtype)


def _bin_sum(values: torch.Tensor, bin_idx: torch.Tensor) -> torch.Tensor:
    """Per-bin sums (..., 400) of values (..., N), in a fixed order."""
    return values @ _onehot(bin_idx, values.dtype)


def _bin_stats(bin_idx, valid, dtype):
    """(count per bin, bin-has-data mask)."""
    cnt = _bin_sum(valid.to(dtype), bin_idx)
    return cnt, cnt > 0


def point_weights(bin_idx, bin_conf, valid, dtype=torch.float64):
    """Per-point sampling weight: its bin's prior confidence, floored at
    0.5, spread over the bin's members (each bin, not each datum, has
    prior-proportional mass)."""
    conf = torch.clamp(bin_conf.to(dtype), min=MIN_PRIOR_BIN_CONFIDENCE)
    cnt, has = _bin_stats(bin_idx, valid, dtype)
    conf = torch.where(has, conf, 0.0)
    per_point = conf[bin_idx] / torch.clamp(cnt[bin_idx], min=1.0)
    return torch.where(valid, per_point, 0.0)


def parsac_score(inlier_mask, valid, bin_idx, locations, bin_count,
                 bin_has_data, len_weight=None):
    """Coverage × confidence score of each hypothesis and the per-bin
    confidences it implies. inlier_mask (..., N) -> (score (...,),
    c (..., 400))."""
    dt = locations.dtype
    inl_per_bin = _bin_sum((inlier_mask & valid).to(dt), bin_idx)
    c = torch.where(bin_has_data, inl_per_bin / torch.clamp(bin_count, min=1.0), 0.0)
    if len_weight is not None:
        c = c * len_weight
    csum = torch.sum(c, dim=-1)
    csq = torch.sum(c * c, dim=-1)
    mean = torch.sum(locations * c[..., None], dim=-2) \
        / torch.clamp(csum, min=1e-12)[..., None]
    d = locations - mean[..., None, :]
    Cxx = torch.sum(d[..., 0] * d[..., 0] * c, dim=-1)
    Cxy = torch.sum(d[..., 0] * d[..., 1] * c, dim=-1)
    Cyy = torch.sum(d[..., 1] * d[..., 1] * c, dim=-1)
    norm = csum / torch.clamp(csum * csum - csq, min=1e-12)
    img_ratio = norm * torch.sqrt(torch.clamp(Cxx * Cyy - Cxy * Cxy, min=0.0))
    return img_ratio * csum, c


def _finish_confidences(best_c, bin_has_data):
    """New cross-frame bin-confidence state: score-implied confidences
    on bins with data, 0 elsewhere."""
    return torch.where(bin_has_data, best_c, 0.0)


def parsac(generator, solver, evaluator, data, pts2, bin_conf, n_points, dof,
           threshold, valid=None, norm_scale: float = 1.0, n_hyp: int = 256,
           idx=None):
    """Batched PARSAC. `idx` (n_hyp, dof) replaces the weighted draw.
    Returns (model, inlier_mask, inlier_count, new_bin_conf)."""
    dt = pts2.dtype
    valid = core.all_valid(valid, n_points, pts2.device)
    bin_idx = bucket_points(pts2, norm_scale)
    locs = bin_locations(norm_scale, dtype=dt, device=pts2.device)
    bin_count, bin_has = _bin_stats(bin_idx, valid, dt)
    weights = point_weights(bin_idx, bin_conf, valid, dtype=dt)
    models, errors = core.hypotheses(generator, solver, evaluator, data,
                                     n_points, dof, n_hyp, valid, weights, idx)
    inl = (errors <= threshold) & valid[None, :]
    scores, cs = parsac_score(inl, valid, bin_idx, locs, bin_count, bin_has)
    counts = torch.sum(inl, dim=-1)
    # score primary, inlier count tie-break
    best = torch.argmax(scores + 1e-9 * counts.to(dt))
    model = tree_map(lambda m: core.take(m, best), models)
    return (model, core.take(inl, best), core.take(counts, best),
            _finish_confidences(core.take(cs, best), bin_has))


def imu_parsac(generator, solver, evaluator, data, pts2, lens, prior_T,
               bin_conf, dynamic_prob, n_points, dof, threshold, valid=None,
               norm_scale: float = 1.0, n_hyp: int = 256,
               min_prior_inliers: int = 20, min_prior_ratio: float = 0.15,
               idx=None):
    """Batched IMU-PARSAC; the model is one tensor (PnP's T). Returns
    (model, inlier_mask, overlap_count, new_bin_conf, ok). When the
    prior gate fails or no hypothesis is admissible, the model is
    `prior_T`, every valid point is an inlier, the bin state is kept and
    ok is False (the reference's behaviour)."""
    dt = pts2.dtype
    valid = core.all_valid(valid, n_points, pts2.device)
    n_valid = torch.sum(valid)
    bin_idx = bucket_points(pts2, norm_scale)
    locs = bin_locations(norm_scale, dtype=dt, device=pts2.device)
    bin_count, bin_has = _bin_stats(bin_idx, valid, dt)
    weights = point_weights(bin_idx, bin_conf, valid, dtype=dt)

    # prior inlier distribution at 2× threshold
    prior_err = evaluator(prior_T[None], *data)[0]
    prior_inl = (prior_err <= 2.0 * threshold) & valid
    n_prior = torch.sum(prior_inl)
    prior_ok = (n_prior >= min_prior_inliers) & (
        n_prior.to(dt) >= min_prior_ratio * torch.clamp(n_valid.to(dt), min=1.0))

    # per-bin mean track length -> dynamic weight t = 1 - p^(0.1·len)
    bin_len = _bin_sum(lens.to(dt) * valid.to(dt), bin_idx)
    bin_len = torch.where(bin_has, bin_len / torch.clamp(bin_count, min=1.0), 0.0)
    p = min(max(float(dynamic_prob), 0.0), 1.0 - 1e-6)
    len_w = 1.0 - torch.pow(p, 0.10 * bin_len)

    models, errors = core.hypotheses(generator, solver, evaluator, data,
                                     n_points, dof, n_hyp, valid, weights, idx)
    inl = (errors <= threshold) & valid[None, :]
    overlap = torch.sum(inl & prior_inl[None, :], dim=-1)
    admissible = overlap >= dof
    scores, cs = parsac_score(inl, valid, bin_idx, locs, bin_count, bin_has, len_w)
    scores = torch.where(admissible, scores, float("-inf"))
    best = torch.argmax(scores + 1e-9 * overlap.to(dt))
    best_overlap = core.take(overlap, best)
    found = torch.isfinite(core.take(scores, best)) & (best_overlap >= dof) & prior_ok

    model = torch.where(found, core.take(models, best), prior_T)
    mask = torch.where(found, core.take(inl, best), valid)  # fallback: all valid inliers
    new_conf = torch.where(found, _finish_confidences(core.take(cs, best), bin_has),
                           bin_conf)
    return model, mask, best_overlap, new_conf, prior_ok & found
