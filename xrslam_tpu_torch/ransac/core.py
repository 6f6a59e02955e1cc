"""Batched-hypothesis RANSAC (port of `xrslam_tpu/ransac/core.py`):
draw every hypothesis's minimal sample up front, solve the minimal
problems as one batch, score with masked reductions, pick the best.

Randomness comes from an explicit `torch.Generator` on the compute
device (seeded from `Config.random` by the caller). It cannot reproduce
the JAX package's `jax.random` stream, so every entry also takes
precomputed index sets (`idx`), which is how the tests inject the
samples JAX drew.
"""

from __future__ import annotations

import torch

from ..utils.tree import tree_map


def sample_minimal(generator: torch.Generator, n_hyp: int, n_points: int,
                   dof: int, valid=None, weights=None,
                   device=None) -> torch.Tensor:
    """(n_hyp, dof) index sets drawn without replacement per hypothesis
    (Gumbel top-k); invalid points are never drawn when ≥ dof are
    valid. `weights` (N,) biases the draw (PARSAC's prior confidence):
    log(clip(w, 1e-20)) is added to the Gumbel keys."""
    device = device if device is not None else generator.device
    u = torch.rand((n_hyp, n_points), generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    if weights is not None:
        g = g + torch.log(torch.clamp(weights, min=1e-20)).to(g.dtype)[None, :]
    if valid is not None:
        g = torch.where(valid[None, :], g, float("-inf"))
    return torch.topk(g, dof, dim=-1).indices


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor `i` without a device sync (indexing
    with a 0-dim tensor reads it back to the host)."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def all_valid(valid, n: int, device) -> torch.Tensor:
    """`valid`, or an all-True (n,) mask when it is None."""
    return torch.ones((n,), dtype=torch.bool, device=device) if valid is None \
        else valid


def select_best(errors: torch.Tensor, threshold, valid=None, scores=None):
    """Score hypotheses by inlier count, or by `scores` (H,) when given;
    errors (H,N). Returns (best_index, best_inlier_mask (N,),
    best_count)."""
    inl = errors <= threshold
    if valid is not None:
        inl = inl & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts if scores is None else scores)
    return best, take(inl, best), take(counts, best)


def hypotheses(generator, solver, evaluator, data, n_points: int, dof: int,
               n_hyp: int, valid=None, weights=None, idx=None):
    """Draw the minimal samples (or take `idx`), solve and evaluate them;
    a variant axis is folded into the hypothesis axis. Returns
    (models, errors (H', N))."""
    if idx is None:
        idx = sample_minimal(generator, n_hyp, n_points, dof, valid, weights)
    models = solver(idx, *data)
    errors = evaluator(models, *data)
    if errors.dim() == 3:
        Hh, V, N = errors.shape
        errors = errors.reshape(Hh * V, N)
        models = tree_map(lambda m: m.reshape((Hh * V,) + m.shape[2:]), models)
    return models, errors


def ransac(generator, solver, evaluator, data, n_points: int, dof: int,
           threshold, n_hyp: int = 256, valid=None, idx=None):
    """Generic batched RANSAC.

    solver(idx (H,dof), *data) -> batched model (a tensor or a tuple of
    tensors with leading H, optionally (H,V,...) variants);
    evaluator(model, *data) -> errors (H,N) or (H,V,N). `idx` replaces
    the random draw. Returns (model, inlier_mask (N,), inlier_count).
    """
    models, errors = hypotheses(generator, solver, evaluator, data, n_points,
                                dof, n_hyp, valid, idx=idx)
    best, mask, count = select_best(errors, threshold, valid)
    return tree_map(lambda m: take(m, best), models), mask, count
