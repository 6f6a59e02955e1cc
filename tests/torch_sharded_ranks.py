"""Rank functions for `tests/test_torch_sharded.py`, run by
`xrslam_tpu_torch.parallel.mesh.run_ranks` in spawned processes on the
CPU over gloo (importable without jax)."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from xrslam_tpu_torch import convert
from xrslam_tpu_torch.estimation import solver
from xrslam_tpu_torch.parallel import mesh as pmesh
from xrslam_tpu_torch.parallel import sharded


def _info(info) -> dict:
    return {k: v.numpy() for k, v in info.items()}


def checks(rank: int, n: int, window, batch, iters: dict) -> dict:
    """On a group of 4 ranks: the window `window` (the port's
    (state, data) of numpy leaves) solved with its landmark columns on a
    (1, 4) mesh, `iters["model"]` and `iters["long"]` iterations, the
    batch `batch` on a (2, 2) mesh, and a one-rank subgroup's solve on
    rank 0 beside the unsharded one; shard_window's refusal of L that W
    does not divide, and shard_window + gather_window as the identity.
    Returns numpy results of this rank."""
    state, data = (convert.to_torch(x) for x in window)
    out = {}
    m1 = pmesh.make_mesh(shape=(1, n), device_type="cpu")
    s_sh, d_sh = sharded.shard_window(m1, state, data)
    out["shard_width"] = int(s_sh.inv_depth.shape[0])
    back = sharded.gather_window(m1, s_sh)
    out["gather_identity"] = bool(torch.equal(back.inv_depth, state.inv_depth))
    try:
        sharded.shard_window(m1, state._replace(inv_depth=state.inv_depth[:-2]), data)
        out["odd_L_raised"] = False
    except ValueError:
        out["odd_L_raised"] = True
    for key in ("model", "long"):
        pmesh.reset_counts()
        res, info = sharded.solve_window_sharded(
            m1, s_sh, d_sh, solver.SolveOptions(iterations=iters[key]))
        out[key] = {"state": convert.to_numpy(sharded.gather_window(m1, res)),
                    "local": convert.to_numpy(res), "info": _info(info),
                    "collectives": dict(pmesh.COLLECTIVES)}

    states, datas = (convert.to_torch(x) for x in batch)
    m2 = pmesh.make_mesh(shape=(2, 2), device_type="cpu")
    res, info = sharded.solve_batch_sharded(m2, states, datas,
                                            solver.SolveOptions(iterations=iters["batch"]))
    out["batch"] = {"state": convert.to_numpy(sharded.gather_window(m2, res)),
                    "info": _info(info), "data_rank": m2["data"].get_local_rank()}

    solo = dist.new_group([0])
    if rank == 0:
        opts = solver.SolveOptions(iterations=iters["model"])
        a, ia = solver.solve_window_core(state, data, opts, group=solo)
        b, ib = solver.solve_window_core(state, data, opts)
        out["solo_equal"] = all(torch.equal(x, y) for x, y in zip(a, b)) and all(
            torch.equal(ia[k], ib[k]) for k in ia)
    return out


def rank_row_equal(results, key: str) -> list:
    """Names of the frame fields and info entries of `results[r][key]`
    that are not bit-equal to rank 0's, over every rank."""
    bad = []
    ref = results[0][key]
    for r, res in enumerate(results[1:], 1):
        for f in ("q", "p", "v", "bg", "ba"):
            if not np.array_equal(getattr(res[key]["state"], f), getattr(ref["state"], f)):
                bad.append(f"rank {r} {f}")
        for k, v in res[key]["info"].items():
            if not np.array_equal(v, ref["info"][k]):
                bad.append(f"rank {r} info {k}")
    return bad
