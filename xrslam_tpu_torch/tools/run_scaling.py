"""Scaling harness for the landmark-sharded Schur BA (port of
`xrslam_tpu/tools/run_scaling.py`).

Measures sliding-window solve throughput (windows/s) on groups of
1/2/4/8 ranks and reports the speedup and parallel efficiency against
the first size. Each size runs as its own `torch.distributed` group of n
ranks, spawned by this process (`parallel.mesh.run_ranks`, with a join
timeout); rank r runs on cuda:(r % cards), or on the CPU with
`--device cpu`. The backend is NCCL when every rank has a card of its
own, gloo otherwise (`parallel.mesh.backend_for`). n ranks that share
fewer than n cards measure the collectives' and the processes' cost,
not multi-card scaling: the table says so.

Three modes per size:
  - data:   B windows split over the data axis (throughput),
  - model:  ONE window's landmark columns split over the model axis
            (latency; the large-window deployment),
  - single: the unsharded solve on rank 0 (the reference).

The window is `io.synthetic.demo_window_problem` in float64 (the port's
solver precision; the JAX harness used float32 for the TPU), with
L - 8 landmarks: the committed draws cover L = 32 and 256.

Usage:
  python -m xrslam_tpu_torch.tools.run_scaling [--devices 1 2 4 8]
      [--batch 8] [--frames 8] [--landmarks 256] [--iters 10]
      [--reps 5] [--modes data model] [--match-batch]
      [--device cuda|cpu] [--json out.json]

Prints one JSON line per size, the efficiency table on stderr, then all
results as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

RANK_TIMEOUT_S = 1200.0


def _rank(rank: int, n: int, mode: str, a: dict):
    """One rank's timed solves; rank 0 returns the size's row."""
    import torch.distributed as dist

    from ..estimation.solver import SolveOptions, solve_window
    from ..io.synthetic import demo_window_problem
    from ..parallel import mesh as pmesh
    from ..parallel import sharded
    from ..utils.tree import tree_map

    dev = pmesh.rank_device(rank, a["device"])
    opts = SolveOptions(iterations=a["iters"])
    state, data = demo_window_problem(a["frames"], a["landmarks"], device=dev)
    if mode == "data":
        mesh = pmesh.make_mesh(shape=(n, 1), device_type=dev.type)
        B = a["batch"]
        bs, bd = (tree_map(lambda x: x.expand((B,) + tuple(x.shape)).contiguous(), t)
                  for t in (state, data))

        def run():
            return sharded.solve_batch_sharded(mesh, bs, bd, opts)[1]
        work = B
    elif mode == "model":
        mesh = pmesh.make_mesh(shape=(1, n), device_type=dev.type)
        s_sh, d_sh = sharded.shard_window(mesh, state, data)

        def run():
            return sharded.solve_window_sharded(mesh, s_sh, d_sh, opts)[1]
        work = 1
    else:
        if rank:
            return None

        def run():
            return solve_window(state, data, opts)[1]
        work = 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()                       # warm
    sync()
    pmesh.reset_counts()
    t0 = time.perf_counter()
    for _ in range(a["reps"]):
        info = run()
    sync()
    dt = (time.perf_counter() - t0) / a["reps"]
    if rank:
        return None
    return {"devices": n, "mode": mode, "windows_per_s": work / dt, "solve_ms": dt * 1e3,
            "cost_finite": bool(torch.isfinite(info["cost"]).all()),
            "backend": dist.get_backend(), "device": str(dev),
            "cards": torch.cuda.device_count() if dev.type == "cuda" else 0,
            "collectives_per_solve": pmesh.COLLECTIVES["calls"] / a["reps"],
            "collective_bytes_per_solve": pmesh.COLLECTIVES["bytes"] / a["reps"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="group sizes (ranks) to measure")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--modes", nargs="+", choices=["data", "model", "single"],
                    default=["data", "model"])
    ap.add_argument("--match-batch", action="store_true",
                    help="data mode: batch = rank count (weak scaling, one "
                         "window per rank)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--json", help="write all results to this path")
    args = ap.parse_args(argv)

    from ..core.detail import compute_device
    from ..parallel.mesh import run_ranks

    compute_device(args.device)               # no card: raise, never fall back
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    where = (f"{cards} card(s): {torch.cuda.get_device_name(0)}" if cards
             else "the CPU")
    print(f"run_scaling: ranks on {where}", file=sys.stderr)

    results = {}
    for mode in args.modes:
        rows = []
        for n in args.devices:
            a = dict(vars(args))
            if args.match_batch and mode == "data":
                a["batch"] = n
            r = run_ranks(_rank, n, args=(mode, a), device=args.device,
                          timeout_s=RANK_TIMEOUT_S)[0]
            base = rows[0] if rows else r
            r["speedup"] = r["windows_per_s"] / base["windows_per_s"]
            r["efficiency"] = r["speedup"] / (r["devices"] / base["devices"])
            r["ranks_share_cards"] = bool(cards) and n > cards
            rows.append(r)
            print(json.dumps(r), flush=True)
            shared = (f"  ({n} ranks sharing {cards} card(s): no multi-card scaling)"
                      if r["ranks_share_cards"] else "")
            print(f"[{mode}] {n} ranks, {r['backend']}: {r['windows_per_s']:.1f} windows/s"
                  f"  speedup {r['speedup']:.2f}x  efficiency {r['efficiency']:.0%}{shared}",
                  file=sys.stderr)
        results[mode] = rows

    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
