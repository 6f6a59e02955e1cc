"""Jacobian validator: autodiff / finite-difference checking of factor
Jacobians (port of `xrslam_tpu/estimation/validator.py`).

Replaces the reference's CostFunctionValidator (reference:
xrslam/src/xrslam/estimation/ceres/cost_function_validator.h:9-377 —
finite-difference checks with `Options{fd_epsilon,max_jacobian_error}`
under the quaternion ⊞) with `torch.func.jacfwd` through the error-state
retraction (`window.retract`): the same on-manifold derivative, exact
instead of finite-differenced. `fd_frame_jacobian` keeps the reference's
central differences as an oracle independent of autodiff. It checks a
hand-written Jacobian against the residual function it belongs to; it
does not validate landmarks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jacfwd

from .window import ES_SIZE, WindowData, WindowState, retract


@dataclass
class Options:
    """reference CostFunctionValidator::Options."""
    max_jacobian_error: float = 2e-6
    fd_epsilon: float = 1e-7  # used only by the finite-difference mode


def autodiff_frame_jacobian(residual_fn, state: WindowState,
                            data: WindowData) -> torch.Tensor:
    """d residual / d frame-error-states via jacfwd through retract:
    residual_fn(state, data) -> (R,) flat residual vector. Returns
    (R, K*15)."""
    K = state.q.shape[0]

    def at(dx_flat):
        dx = dx_flat.reshape(K, ES_SIZE)
        dd = torch.zeros_like(state.inv_depth)
        return residual_fn(retract(state, dx, dd), data)

    return jacfwd(at)(torch.zeros((K * ES_SIZE,), dtype=state.p.dtype,
                                  device=state.p.device))


def autodiff_landmark_jacobian(residual_fn, state: WindowState,
                               data: WindowData) -> torch.Tensor:
    """d residual / d inverse-depths, (R, L)."""
    K = state.q.shape[0]

    def at(dd):
        dx = torch.zeros((K, ES_SIZE), dtype=state.p.dtype, device=state.p.device)
        return residual_fn(retract(state, dx, dd), data)

    return jacfwd(at)(torch.zeros_like(state.inv_depth))


def fd_frame_jacobian(residual_fn, state: WindowState, data: WindowData,
                      eps: float = 1e-7) -> np.ndarray:
    """Central finite differences through the retraction — the literal
    mechanism of the reference validator, kept as an independent oracle
    for the autodiff path itself."""
    K = state.q.shape[0]
    n = K * ES_SIZE
    r0 = residual_fn(state, data).detach().cpu().numpy()
    J = np.zeros((r0.size, n))
    dd = torch.zeros_like(state.inv_depth)
    for i in range(n):
        dx = torch.zeros((n,), dtype=state.p.dtype, device=state.p.device)
        dx[i] = eps
        dx = dx.reshape(K, ES_SIZE)
        rp = residual_fn(retract(state, dx, dd), data)
        rm = residual_fn(retract(state, -dx, dd), data)
        J[:, i] = ((rp - rm).reshape(-1) / (2 * eps)).detach().cpu().numpy()
    return J


def validate(residual_fn, analytic_J, state: WindowState, data: WindowData,
             options: Options = Options()) -> float:
    """Max abs deviation between `analytic_J` (R, K*15) and the autodiff
    Jacobian; raises if it exceeds options.max_jacobian_error (the
    reference's Validate() contract)."""
    J_ref = autodiff_frame_jacobian(residual_fn, state, data)
    J = torch.as_tensor(analytic_J, dtype=J_ref.dtype, device=J_ref.device)
    err = float((J - J_ref).abs().max())
    if err > options.max_jacobian_error:
        raise AssertionError(
            f"Jacobian error {err:.3e} > {options.max_jacobian_error:.3e}")
    return err


def _frame_columns(J: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Place per-row Jacobian blocks J (..., w) of the frame that
    `onehot` (..., K) selects into the (..., K, 15) frame columns."""
    out = torch.einsum("...w,...k->...kw", J, onehot.to(J.dtype))
    return torch.nn.functional.pad(out, (0, ES_SIZE - J.shape[-1]))


def analytic_frame_jacobians(state: WindowState, data: WindowData) -> dict:
    """The port's hand-written frame Jacobians, each as
    (residual_fn, J (R, K*15)) for `validate`:

    - "reproj_closed": `factors.reproj_residual_jac_closed`, the closed
      form that K2's fused entry computes in its body (target and
      anchor pose columns);
    - "preint": `factors.preint_residual_jac` (frames j-1 and j);
    - "rotation": `factors.rotation_residual_jac`, which optimizes the
      target orientation only, so its residual_fn holds each row's
      anchor orientation constant (`detach`);
    - "marg": `factors.marg_residual_jac`, the dense prior.
    """
    from . import factors

    K, L = data.obs_mask.shape
    eye = torch.eye(K, dtype=torch.bool, device=state.p.device)
    ref_oh = eye[data.ref_idx.long()]                        # (L, K)
    out = {}

    def reproj(st, d):
        return factors.reproj_residual_jac_closed(st, d)[0].reshape(-1)

    _, Jt, Jr, _, _ = factors.reproj_residual_jac_closed(state, data)
    J = (_frame_columns(Jt, eye[:, None, None, :].expand(K, L, 2, K))
         + _frame_columns(Jr, ref_oh[None, :, None, :].expand(K, L, 2, K)))
    out["reproj_closed"] = (reproj, J.reshape(K * L * 2, K * ES_SIZE))

    def preint(st, d):
        return factors.preint_residual_jac(st, d)[0].reshape(-1)

    _, Ji, Jj, _ = factors.preint_residual_jac(state, data)
    prev_oh = eye[torch.clamp(torch.arange(K, device=eye.device) - 1, min=0)]
    J = (_frame_columns(Ji, prev_oh[:, None, :].expand(K, ES_SIZE, K))
         + _frame_columns(Jj, eye[:, None, :].expand(K, ES_SIZE, K)))
    out["preint"] = (preint, J.reshape(K * ES_SIZE, K * ES_SIZE))

    def rotation(st, d):
        # target k's rows with every other orientation held constant: an
        # active row's anchor is never its target
        rows = []
        for k in range(K):
            q = torch.where(eye[k][:, None], st.q, st.q.detach())
            rows.append(factors.rotation_residual_jac(st._replace(q=q), d)[0][k])
        return torch.stack(rows).reshape(-1)

    _, Jq, _ = factors.rotation_residual_jac(state, data)
    J = _frame_columns(Jq, eye[:, None, None, :].expand(K, L, 2, K))
    out["rotation"] = (rotation, J.reshape(K * L * 2, K * ES_SIZE))

    def marg(st, d):
        return factors.marg_residual_jac(st, d)[0]

    out["marg"] = (marg, factors.marg_residual_jac(state, data)[1])
    return out
