"""K2 (estimation/gram.py): the port's reprojection Gram block against
the JAX package's three formulations — the Pallas kernel run in the
Pallas interpreter, the XLA Gram reformulation, and the einsum branch
of solver.assemble — on the same Cauchy-weighted inputs, in float64;
and the port's Gram form (`reproj_gram_matmul`, K2's library
yardstick) against the JAX package's `reproj_gram_xla`.

Tolerance rtol = atol = 1e-9 (the JAX package's own Pallas parity
limit): the formulations differ only in summation order.

The CUDA kernel itself runs only on the card; tests/test_torch_cuda.py
holds it to the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.estimation import factors as jfactors
from xrslam_tpu.estimation import gram as jgram
from xrslam_tpu.estimation import solver as jsolver
from xrslam_tpu.io.synthetic import demo_window_problem
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.estimation import gram, solver

TOL = dict(rtol=1e-9, atol=1e-9)
NAMES = ["P", "b6", "Hll", "Hfl6", "bl"]


def _weighted_inputs(K, L):
    st, data = demo_window_problem(K, L, jnp.float64)
    # perturb off the optimum so residuals and weights are nontrivial
    rng = np.random.default_rng(K * 1000 + L)
    st = st._replace(
        p=st.p + jnp.asarray(rng.normal(0, 0.02, st.p.shape)),
        inv_depth=st.inv_depth * jnp.asarray(1 + rng.normal(0, 0.05, L)))
    r, Jt, Jr6, Jd, m = jfactors.reproj_residual_jac(st, data)
    w, _ = jfactors.cauchy_weights(r, m)
    wf = w[..., None]
    args = (r * wf, Jt * wf[..., None], Jr6 * wf[..., None], Jd * wf)
    dt = st.p.dtype
    R1 = (jax.nn.one_hot(data.ref_idx, K, dtype=dt)
          * data.landmark_mask[:, None].astype(dt))
    return st, data, args + (R1,)


@pytest.fixture(scope="module", params=[(6, 128), (12, 384)],
                ids=["K6_L128", "K12_L384"])
def problem(request):
    return _weighted_inputs(*request.param)


def _port(args):
    return gram.reproj_gram(*(torch.as_tensor(np.array(a)) for a in args))


def test_plain_gram_matches_pallas_interpret(problem):
    _, _, args = problem
    ref = jgram.reproj_gram_pallas(*args, interpret=True)
    for n, a, b in zip(NAMES, ref, _port(args)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=n, **TOL)


def test_plain_gram_matches_xla_gram(problem):
    _, _, args = problem
    ref = jgram.reproj_gram_xla(*args)
    for n, a, b in zip(NAMES, ref, _port(args)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=n, **TOL)


def test_gram_matmul_matches_xla_gram(problem):
    _, _, args = problem
    ref = jgram.reproj_gram_xla(*args)
    out = gram.reproj_gram_matmul(*(torch.as_tensor(np.array(a)) for a in args))
    for n, a, b in zip(NAMES, ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=n, **TOL)


def test_assemble_matches_jax_einsum_branch(problem):
    """The port's assemble (which calls K2) against the JAX default
    (einsum) assemble: the whole system, not just the Gram block."""
    st, data, _ = problem
    ref = jax.jit(jsolver.assemble, static_argnums=2)(
        st, data, jsolver.SolveOptions())
    out = solver.assemble(convert.to_torch(st), convert.to_torch(data),
                          solver.SolveOptions())
    for n, a, b in zip(["H", "b", "Hll", "Hfl", "bl", "cost"], ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=n, **TOL)


def test_gram_plain_on_cpu_only(problem):
    """The dispatching wrapper takes the plain version for CPU tensors
    and never counts a kernel launch there."""
    from xrslam_tpu_torch.kernels import build

    _, _, args = problem
    K, L = args[0].shape[:2]
    before = build.REPROJ_GRAM.launches
    out = _port(args)
    assert build.REPROJ_GRAM.launches == before
    assert out[0].shape == (K, 6, K, 6) and out[3].shape == (K, 6, L)
