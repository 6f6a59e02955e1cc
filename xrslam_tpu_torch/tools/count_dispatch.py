"""Count the ATen operations that one call of each solver stage, and
of the IMU preintegration, dispatches (each is one kernel launch, or a
few, on a CUDA device).

    python -m xrslam_tpu_torch.tools.count_dispatch [--frames 6 --landmarks 64]
                                                    [--device cuda|cpu]

Counts with a `TorchDispatchMode`. The counts depend on the code path,
not on the window's size; the path depends on the device: on the card
(the default), `assemble` takes K2's fused kernel and K3 and
`integrate_batch` K4 (one C call each, which the mode does not see;
their launches are listed beside the counts), and with `--device cpu`
their plain versions. The preintegration is counted on one call of 12
intervals at 44 steps (`io.synthetic.imu_intervals`); the plain loop's
count grows with the steps. Views and reshapes are dispatched but launch
nothing, so a count is an upper bound on launches.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..estimation import factors, gram, solver
from ..imu import preintegration as pre
from ..io.synthetic import imu_intervals, imu_noise, reproj_window
from ..kernels import build

PREINT_N, PREINT_S, PREINT_STEPS = 12, 128, 44


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with _Count() as c:
        fn()
    return c.n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    state, data = reproj_window(args.frames, args.landmarks, seed=0, device=dev)
    opts = solver.SolveOptions()
    sys0 = solver.assemble(state, data, opts)
    lam = torch.as_tensor(1e-4, dtype=state.p.dtype, device=dev)
    r, Jt, Jr6, Jd, _ = factors.reproj_residual_jac_closed(state, data)
    R1 = gram.anchor_onehot(data, args.frames, r.dtype)
    pmask = factors.preint_pair_mask(data)
    build.reset_launch_counts()
    n_assemble = count(lambda: solver.assemble(state, data, opts))
    k2_calls, k3_calls = build.REPROJ_GRAM.launches, build.PREINT_GRAM.launches
    imu = imu_intervals(PREINT_N, PREINT_S, PREINT_STEPS, seed=0, device=dev)
    noise = imu_noise(device=dev)

    def integrate(fn):
        return lambda: fn(*imu[:6], noise, imu[6], steps=PREINT_STEPS)

    k4_before = build.PREINT_SCAN.launches
    n_integrate = count(integrate(pre.integrate_batch))
    k4_calls = build.PREINT_SCAN.launches - k4_before
    out = {
        "reproj_residual_jac (autodiff)": count(
            lambda: factors.reproj_residual_jac(state, data)),
        "reproj_residual_jac_closed": count(
            lambda: factors.reproj_residual_jac_closed(state, data)),
        "reproj_gram_plain": count(lambda: gram.reproj_gram_plain(r, Jt, Jr6, Jd, R1)),
        "reproj_factor_gram_plain": count(
            lambda: gram.reproj_factor_gram_plain(state, data)),
        "reproj_factor_gram (what assemble takes)": count(
            lambda: gram.reproj_factor_gram(state, data)),
        "preint_residual_jac": count(lambda: factors.preint_residual_jac(state, data)),
        "preint_residual_jac_closed": count(
            lambda: factors.preint_residual_jac_closed(state, data)),
        "preint_factor_gram_plain": count(
            lambda: gram.preint_factor_gram_plain(state, data, pmask)),
        "preint_factor_gram (what assemble takes)": count(
            lambda: gram.preint_factor_gram(state, data, pmask)),
        "marg_residual_jac": count(lambda: factors.marg_residual_jac(state, data)),
        "assemble": n_assemble,
        "_solve_from": count(lambda: solver._solve_from(sys0, state, lam)),
        "solve_window (10 iterations)": count(
            lambda: solver.solve_window(state, data, opts)),
        "integrate_batch_plain": count(integrate(pre.integrate_batch_plain)),
        "integrate_batch (what the window builder takes)": n_integrate,
    }
    print(json.dumps({"frames": args.frames, "landmarks": args.landmarks,
                      "device": str(dev), "dispatched_ops": out,
                      "k2_calls_per_assemble": k2_calls,
                      "k3_calls_per_assemble": k3_calls,
                      "preintegration": {"intervals": PREINT_N, "capacity": PREINT_S,
                                         "steps": PREINT_STEPS},
                      "k4_calls_per_integrate_batch": k4_calls},
                     indent=1))


if __name__ == "__main__":
    main()
