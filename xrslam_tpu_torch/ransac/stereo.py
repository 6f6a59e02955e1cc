"""Two-view robust estimators: essential (5-pt), homography (4-pt) and
rotation (2-pt) RANSAC and the PARSAC variants of the first two (port
of `xrslam_tpu/ransac/stereo.py`).

Thresholds: essential 2·3.84·σ² on the symmetric squared epipolar
error; homography 2·5.99·σ² on the symmetric squared transfer error;
rotation 5.99·σ² on the angular error (radians, not squared).

Each estimator takes a `torch.Generator` and optionally the minimal
index sets (`idx`, (n_hyp, dof)) to use instead of drawing them.
"""

from __future__ import annotations

import torch

from ..geometry import essential as ess
from ..geometry import homography as homo
from ..geometry import wahba
from . import core
from . import parsac as parsac_mod

CHI2_1DOF = 3.84
CHI2_2DOF = 5.99


def _essential_solver(idx, x1, x2):
    return ess.solve_essential_5pt(x1[idx], x2[idx])      # ((H,R,3,3), (H,R))


def _essential_errors(model, x1, x2):
    E, rv = model                                           # (H,R,3,3), (H,R)
    errs = (ess.essential_geometric_error(E, x1, x2)
            + ess.essential_geometric_error(E.transpose(-1, -2), x2, x1))
    return torch.where(rv[..., None], errs, float("inf"))


def _homography_solver(idx, p1, p2):
    return homo.solve_homography_4pt(p1[idx], p2[idx])


def _homography_errors(Hs, p1, p2):
    Hi, _ = torch.linalg.inv_ex(Hs)
    return (homo.homography_geometric_error(Hs, p1, p2)
            + homo.homography_geometric_error(Hi, p2, p1))


def find_essential_matrix(generator, x1, x2, valid=None, threshold: float = 1.0,
                          n_hyp: int = 64, idx=None):
    """5-pt essential RANSAC; x1, x2 (N,3) homogeneous normalized points
    (z=1). Returns (E, inlier_mask, count)."""
    N = x1.shape[0]
    thr = 2.0 * CHI2_1DOF * threshold * threshold
    model, mask, count = core.ransac(
        generator, _essential_solver, _essential_errors, (x1, x2), N, 5, thr,
        n_hyp=n_hyp, valid=core.all_valid(valid, N, x1.device), idx=idx)
    return model[0], mask, count


def find_homography_matrix(generator, p1, p2, valid=None,
                           threshold: float = 1.0, n_hyp: int = 128, idx=None):
    """4-pt homography RANSAC; p1, p2 (N,2). Returns (H, inlier_mask,
    count)."""
    N = p1.shape[0]
    thr = 2.0 * CHI2_2DOF * threshold * threshold
    return core.ransac(generator, _homography_solver, _homography_errors,
                       (p1, p2), N, 4, thr, n_hyp=n_hyp,
                       valid=core.all_valid(valid, N, p1.device), idx=idx)


def find_essential_matrix_parsac(generator, x1, x2, bin_conf, valid=None,
                                 threshold: float = 1.0,
                                 norm_scale: float = 1.0, n_hyp: int = 64,
                                 idx=None):
    """PARSAC 5-pt essential: the minimal solver and evaluator of
    `find_essential_matrix` with spatial-bin-confidence weighted
    sampling and coverage scoring; binning uses x2's normalized-plane
    coordinates. x1, x2: (N,3) homogeneous z=1 points. Returns
    (E, inlier_mask, count, new_bin_conf)."""
    thr = 2.0 * CHI2_1DOF * threshold * threshold
    model, mask, count, new_conf = parsac_mod.parsac(
        generator, _essential_solver, _essential_errors, (x1, x2), x2[..., :2],
        bin_conf, x1.shape[0], 5, thr, valid=valid, norm_scale=norm_scale,
        n_hyp=n_hyp, idx=idx)
    return model[0], mask, count, new_conf


def find_homography_matrix_parsac(generator, p1, p2, bin_conf, valid=None,
                                  threshold: float = 1.0,
                                  norm_scale: float = 1.0, n_hyp: int = 128,
                                  idx=None):
    """PARSAC 4-pt homography; p1, p2 (N,2) normalized-plane points.
    Returns (H, inlier_mask, count, new_bin_conf)."""
    thr = 2.0 * CHI2_2DOF * threshold * threshold
    return parsac_mod.parsac(
        generator, _homography_solver, _homography_errors, (p1, p2), p2,
        bin_conf, p1.shape[0], 4, thr, valid=valid, norm_scale=norm_scale,
        n_hyp=n_hyp, idx=idx)


def _rotation_solver(idx, b1, b2):
    return wahba.solve_rotation(b1[idx], b2[idx])


def find_rotation_matrix(generator, b1, b2, valid=None, threshold: float = 1.0,
                         n_hyp: int = 128, idx=None):
    """2-pt rotation RANSAC; b1, b2 (N,3) unit bearings, b2 ≈ R b1.
    Returns (R, inlier_mask, count)."""
    N = b1.shape[0]
    thr = CHI2_2DOF * threshold * threshold
    return core.ransac(generator, _rotation_solver, wahba.rotation_angular_error,
                       (b1, b2), N, 2, thr, n_hyp=n_hyp,
                       valid=core.all_valid(valid, N, b1.device), idx=idx)
