"""A/B the reprojection block of the port's normal-equation assembly
(port of `xrslam_tpu/tools/ab_assemble.py`).

Times `solver.assemble` (one window's whole normal-equation build) and
a 10-iteration `solver.solve_window` with the reprojection block
computed three ways, and checks that the assembled systems agree at
rtol/atol 1e-9 (float64), the rtol relative to each entry's bound on
the terms summed into it (`entry_scales`: an entry that cancels to ~0
keeps the rounding of its terms, whatever the summation order):

  - `kernel`: K2's fused entry (`gram.reproj_factor_gram_cuda`), what
    `assemble` runs on the card;
  - `plain`: its plain PyTorch version (`gram.reproj_factor_gram_plain`),
    what `assemble` runs on the CPU;
  - `gram_form`: the closed-form factors (`factors.reproj_residual_jac_closed`),
    `factors.cauchy_weights` and the augmented-Jacobian Gram form
    (`gram.reproj_gram_matmul`, a cuBLAS product on the card).

The route is swapped in this tool only, for the span of its
measurement: `assemble` has no backend switch, and the JAX package's
`XR_ASSEMBLE_BACKEND` has no counterpart. The window is
`io.synthetic.demo_window_problem(K, L)` (committed draws cover
L = 32, 256, 384, 1024 and 2048) with its state perturbed off the truth
from seed 0 (`io.synthetic.perturbed_demo_window`): at the truth the
residuals, b and bl are rounding noise, which the routes compute in
different orders. On the card the kernel route
launches or raises; with `--device cpu` it is reported as
"not run: cpu" and the other two are compared with each other.

    python -m xrslam_tpu_torch.tools.ab_assemble [--K 12] [--L 384] [--reps 50]
        [--device cuda|cpu]

Prints one JSON line; exits 1 if two systems disagree.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from ..core.detail import compute_device
from ..estimation import factors, gram, solver
from ..io.synthetic import perturbed_demo_window
from ..utils.timing import mean_ms

RTOL = ATOL = 1e-9
SOLVE_ITERS = 10


def gram_form(state, data):
    """The reprojection block as closed-form factors, Cauchy weights and
    the augmented-Jacobian Gram form: (P, b6, Hll, Hfl6, bl, cost)."""
    r, Jt, Jr6, Jd, m = factors.reproj_residual_jac_closed(state, data)
    w, c = factors.cauchy_weights(r, m)
    wf = w[..., None]
    out = gram.reproj_gram_matmul(r * wf, Jt * wf[..., None], Jr6 * wf[..., None],
                                  Jd * wf, gram.anchor_onehot(data, r.shape[0], r.dtype))
    return (*out, torch.sum(c))


ROUTES = {"kernel": gram.reproj_factor_gram_cuda,
          "plain": gram.reproj_factor_gram_plain,
          "gram_form": gram_form}


@contextlib.contextmanager
def reproj_route(fn):
    """`solver.assemble` takes its reprojection block from `fn` inside
    the block."""
    saved = gram.reproj_factor_gram
    gram.reproj_factor_gram = fn
    try:
        yield
    finally:
        gram.reproj_factor_gram = saved


NAMES = ("H", "b", "Hll", "Hfl", "bl", "cost")


def entry_scales(sys_):
    """Each entry's bound on the magnitude of the terms summed into it,
    by Cauchy-Schwarz over the Gram form of every factor: |H_ij| terms
    <= sqrt(H_ii H_jj) (a diagonal entry sums squares, with no
    cancellation), Hfl likewise against Hll, b and bl against the
    squared residuals, whose sum is <= 2 cost (x / (1 + x) <= log(1 + x)
    for the Cauchy-weighted ones). Summation order moves an entry by a
    few ulps of its scale, not of the entry, which may cancel to ~0."""
    H, b, Hll, Hfl, bl, cost = sys_
    K, E = b.shape
    d = torch.diagonal(H.reshape(K * E, K * E)).abs().reshape(K, E)
    r2 = 2.0 * cost.abs()
    return (torch.sqrt(d[:, :, None, None] * d[None, None]), torch.sqrt(d * r2),
            Hll.abs(), torch.sqrt(d[:, :, None] * Hll.abs()), torch.sqrt(Hll.abs() * r2),
            cost.abs())


def max_rel_excess(a, b) -> float:
    """Largest |a - b| - (ATOL + RTOL * scale) over two systems, the scale
    of each entry that of `entry_scales(b)` (at least |b|): <= 0 where
    they agree at rtol/atol 1e-9."""
    return max(float(torch.max((x - y).abs() - (ATOL + RTOL * torch.maximum(s, y.abs()))))
               for x, y, s in zip(a, b, entry_scales(b)) if x.numel())


def worst_entry(a, b) -> dict:
    """Where two systems differ most against their tolerance: the
    output, the entry, the reference value, the difference, the scale."""
    best = None
    for name, x, y, s in zip(NAMES, a, b, entry_scales(b)):
        if not x.numel():
            continue
        tol = ATOL + RTOL * torch.maximum(s, y.abs())
        ex = ((x - y).abs() - tol).reshape(-1)
        i = int(torch.argmax(ex))
        if best is None or float(ex[i]) > best["excess"]:
            idx = [int(v) for v in torch.unravel_index(torch.tensor(i), y.shape)]
            best = {"output": name, "index": idx, "plain": float(y.reshape(-1)[i]),
                    "diff": float((x - y).reshape(-1)[i]),
                    "scale": float(s.reshape(-1)[i]), "excess": float(ex[i])}
    return best


def run(K: int = 12, L: int = 384, reps: int = 50, device="cuda") -> dict:
    dev = compute_device(device)
    state, data = perturbed_demo_window(K, L, seed=0, device=dev)
    opts1 = solver.SolveOptions(iterations=1)
    opts = solver.SolveOptions(iterations=SOLVE_ITERS)
    out = {"device": dev.type, "K": K, "L": L, "dtype": "float64", "reps": reps,
           "solve_iterations": SOLVE_ITERS, "reference": "plain"}
    systems = {}
    for name, fn in ROUTES.items():
        if name == "kernel" and dev.type != "cuda":
            out[name] = "not run: cpu"
            continue
        with reproj_route(fn):
            systems[name] = solver.assemble(state, data, opts1)
            out[name] = {
                "assemble_ms": mean_ms(lambda: solver.assemble(state, data, opts1), reps, dev),
                "solve10_ms": mean_ms(lambda: solver.solve_window(state, data, opts),
                                      max(1, reps // 10), dev)}
    ref = systems["plain"]
    for name, sys_ in systems.items():
        d = max(float(torch.max((x - y).abs())) for x, y in zip(sys_, ref) if x.numel())
        out[name]["max_abs_diff_vs_plain"] = d
        out[name]["worst_entry"] = worst_entry(sys_, ref)
        out[name]["agree"] = max_rel_excess(sys_, ref) <= 0.0
    out["agree"] = all(r["agree"] for r in out.values() if isinstance(r, dict))
    if dev.type == "cuda":
        from .bench_pipeline import card_line

        out["card"] = card_line()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--K", type=int, default=12)
    ap.add_argument("--L", type=int, default=384)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = run(args.K, args.L, args.reps, args.device)
    print(json.dumps(out))
    if not out["agree"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
