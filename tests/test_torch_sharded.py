"""The landmark-sharded Schur BA of the port (`parallel/mesh.py`,
`parallel/sharded.py`, the solver's `group=`) on 4 CPU ranks over
gloo, against the JAX package (`tests/test_parallel.py`'s problem:
K = 6, L = 64):

- at W = 4 model shards, against the JAX package's
  `solve_window_sharded` on a (1, 4) virtual-device mesh (the same
  partition) to 1e-9, and against its unsharded `solve_window` at
  `test_parallel.py`'s tolerances (5 iterations);
- `solve_batch_sharded` on a (2, 2) mesh against `jax.vmap(solve_window)`
  (B = 4, 3 iterations);
- the cost decreases at W = 4 with a finite history, and two
  collectives are made per LM iteration;
- every rank's frame state and info bit-equal to rank 0's;
- a one-rank group bit-equal to no group, and `group=None` bit-equal to
  the solver before the sharded mode (`torch_solver_before_sharding.py`)
  on `io.synthetic.reproj_window` and on a batch of 3;
- `shard_window` refuses an L that W does not divide, and
  `shard_window` followed by `gather_window` is the identity.

The ranks run in one spawned group (`tests/torch_sharded_ranks.py`),
one intra-op thread each, with a 120 s join timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.estimation.solver import SolveOptions as JOpts
from xrslam_tpu.estimation.solver import solve_window as jsolve
from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.io.synthetic import circle_scene, euler_consistent, window_problem
from xrslam_tpu.parallel import sharded as jsharded
from xrslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.estimation import solver
from xrslam_tpu_torch.io.synthetic import reproj_window
from xrslam_tpu_torch.parallel import mesh as pmesh

import torch_sharded_ranks as ranks
import torch_solver_before_sharding as before
from helpers import perturb_state

K, L, B = 6, 64, 4
ITERS = {"model": 5, "long": 6, "batch": 3}


def _problem():
    """`tests/test_parallel.py`'s window."""
    scene = euler_consistent(circle_scene(n_frames=K * 2 + 1, n_landmarks=L - 8))
    q_bc = jlie.expmap(jnp.array([-jnp.pi / 2, 0.0, 0.0]))
    p_bc = jnp.array([0.02, -0.01, 0.03])
    return window_problem(scene, list(range(0, K * 2, 2)), L=L, q_bc=q_bc, p_bc=p_bc)


def _np(tree):
    """A JAX state container as the port's, with numpy leaves."""
    return convert.to_numpy(convert.to_torch(jax.tree.map(np.asarray, tree)))


@pytest.fixture(scope="module")
def run():
    state, data = _problem()
    state = perturb_state(state, jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    states = jax.vmap(lambda k: perturb_state(state, k))(keys)
    datas = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), data)
    results = pmesh.run_ranks(ranks.checks, 4, args=((_np(state), _np(data)),
                                                    (_np(states), _np(datas)), ITERS),
                              device="cpu", timeout_s=120.0)
    return {"state": state, "data": data, "states": states, "datas": datas,
            "results": results}


def _close(out, ref, names, rtol, atol):
    for name in names:
        np.testing.assert_allclose(getattr(out, name), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_sharded_matches_jax_sharded(run):
    mesh = jmake_mesh(4, shape=(1, 4))
    s_sh, d_sh = jsharded.shard_window(mesh, run["state"], run["data"])
    ref, info_ref = jsharded.solve_window_sharded(mesh, s_sh, d_sh,
                                                  JOpts(iterations=ITERS["model"]))
    out = run["results"][0]["model"]
    np.testing.assert_allclose(out["info"]["cost"], np.asarray(info_ref["cost"]),
                               rtol=1e-9, atol=1e-9)
    _close(out["state"], ref, ("q", "p", "v", "bg", "ba", "inv_depth"), 1e-9, 1e-9)


def test_sharded_matches_jax_single(run):
    ref, info_ref = jsolve(run["state"], run["data"], JOpts(iterations=ITERS["model"]))
    out = run["results"][0]["model"]
    np.testing.assert_allclose(out["info"]["cost"], np.asarray(info_ref["cost"]),
                               rtol=1e-9, atol=1e-12)
    _close(out["state"], ref, ("q", "p", "v", "inv_depth"), 1e-7, 1e-9)


def test_batch_sharded_matches_jax_vmap(run):
    ref, info_ref = jax.vmap(lambda s, d: jsolve(s, d, JOpts(iterations=ITERS["batch"])))(
        run["states"], run["datas"])
    for res in run["results"]:
        rows = slice(2 * res["batch"]["data_rank"], 2 * res["batch"]["data_rank"] + 2)
        np.testing.assert_allclose(res["batch"]["info"]["cost"],
                                   np.asarray(info_ref["cost"])[rows], rtol=1e-9, atol=1e-12)
        for name in ("p", "inv_depth"):
            np.testing.assert_allclose(getattr(res["batch"]["state"], name),
                                       np.asarray(getattr(ref, name))[rows],
                                       rtol=1e-7, atol=1e-9, err_msg=name)


def test_cost_decreases_under_sharding(run):
    out = run["results"][0]["long"]
    assert float(out["info"]["cost"]) < float(out["info"]["cost0"])
    assert np.isfinite(out["info"]["cost_history"]).all()
    # an assemble (H, b, cost) before the loop and one per iteration; a
    # step (S_lm, rhs_lm) before the loop and one per iteration but the
    # last, whose candidate is never judged
    n = ITERS["long"]
    assert out["collectives"]["calls"] == 2 * n + 1
    schur = (K * 15) ** 2 + K * 15
    assert out["collectives"]["bytes"] == 8 * ((schur + 1) * (n + 1) + schur * n)


def test_ranks_bit_equal(run):
    results = run["results"]
    for key in ("model", "long"):
        assert not ranks.rank_row_equal(results, key), key
    for d in (0, 1):
        group = [res for res in results if res["batch"]["data_rank"] == d]
        assert len(group) == 2 and not ranks.rank_row_equal(group, "batch")
    assert results[0]["solo_equal"]


def test_shard_and_gather(run):
    w = L // 4
    for r, res in enumerate(run["results"]):
        assert res["shard_width"] == w
        assert res["gather_identity"] and res["odd_L_raised"]
        # each rank solved its own columns; the gather put them in place
        np.testing.assert_array_equal(res["model"]["local"].inv_depth,
                                      res["model"]["state"].inv_depth[w * r:w * (r + 1)])


def _bits_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _bits_equal(x, y)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("batch", [False, True])
def test_group_none_matches_solver_before_sharding(batch):
    opts = solver.SolveOptions(iterations=4)
    if batch:
        wins = [reproj_window(6, 48, seed=s) for s in (3, 4, 5)]
        state, data = (solver._stack(x) for x in zip(*wins))
        new, old = solver.solve_window_batch, before.solve_window_batch
        sys_new = solver.assemble_batch(state, data, opts)
        sys_old = before.assemble_batch(state, data, opts)
    else:
        state, data = reproj_window(6, 48, seed=3)
        new, old = solver.solve_window_core, before.solve_window_core
        sys_new = solver.assemble(state, data, opts)
        sys_old = before.assemble(state, data, opts)
        assert torch.equal(solver.compute_cost(state, data, opts),
                           before.compute_cost(state, data, opts))
    _bits_equal(sys_new, sys_old)
    a, ia = new(state, data, opts)
    b, ib = old(state, data, opts)
    _bits_equal(a, b)
    for k in ia:
        assert torch.equal(ia[k], ib[k]), k
