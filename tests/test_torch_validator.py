"""The port's Jacobian validator (`xrslam_tpu_torch/estimation/validator.py`,
the reference's CostFunctionValidator replacement) held to the JAX
package's on the CPU in float64, on `tests/test_validator_logging.py`'s
window problem (circle scene, frames 0, 2, 4, 6, 32 landmark slots),
perturbed by the JAX test helper:

- the port's autodiff frame Jacobian agrees with its central finite
  differences within 1e-5 (the JAX test's bound);
- the port's `autodiff_frame_jacobian` and `autodiff_landmark_jacobian`
  equal the JAX package's on the same inputs within 1e-9;
- `validate` passes each of the port's four analytic frame Jacobians
  (`analytic_frame_jacobians`: the closed-form reprojection Jacobian of
  K2's fused entry, preintegration, rotation, the dense prior, here with
  a seeded prior linearized at the unperturbed state) at
  `max_jacobian_error` 2e-6, and rejects each with one entry moved by
  1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import perturb_state
from xrslam_tpu.estimation import factors as jfactors
from xrslam_tpu.estimation import validator as jvalidator
from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.io.synthetic import circle_scene, euler_consistent, window_problem
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.estimation import factors
from xrslam_tpu_torch.estimation import validator
from xrslam_tpu_torch.estimation.window import ES_SIZE, MargPrior

JAX_TOL = 1e-9
FD_TOL = 1e-5
NAMES = ["reproj_closed", "preint", "rotation", "marg"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tonp(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def problem():
    """(JAX state, JAX data, port state, port data): the perturbed window
    problem; the port's data carries a seeded dense prior."""
    scene = euler_consistent(circle_scene(n_frames=9, n_landmarks=24))
    q_bc = jlie.expmap(jnp.array([-jnp.pi / 2, 0.0, 0.0], dtype=jnp.float64))
    state0, data = window_problem(scene, [0, 2, 4, 6], L=32, q_bc=q_bc,
                                  p_bc=jnp.array([0.02, -0.01, 0.03]),
                                  dtype=jnp.float64)
    state = perturb_state(state0, jax.random.PRNGKey(1))
    st, dt = convert.to_torch(tonp(state)), convert.to_torch(tonp(data))
    n = st.q.shape[0] * ES_SIZE
    rng = np.random.default_rng(0)
    U = torch.as_tensor(np.triu(rng.normal(0, 1, (n, n))) + 3 * np.eye(n))
    prior = MargPrior(sqrt_inv_cov=U, infovec=torch.as_tensor(rng.normal(0, 0.1, n)),
                      lin=convert.to_torch(tonp(state0)))
    dt = dt._replace(marg=prior, use_marg=torch.ones((), dtype=torch.bool))
    return state, data, st, dt


def _preint_residual(state, data):
    return factors.preint_residual_jac(state, data)[0].reshape(-1)


def _jax_preint_residual(state, data):
    return jfactors.preint_residual_jac(state, data)[0].reshape(-1)


def test_autodiff_matches_fd(problem):
    _, _, st, dt = problem
    J_ad = validator.autodiff_frame_jacobian(_preint_residual, st, dt).numpy()
    J_fd = validator.fd_frame_jacobian(_preint_residual, st, dt, eps=1e-6)
    assert np.abs(J_ad - J_fd).max() < FD_TOL


def test_autodiff_frame_jacobian_matches_jax(problem):
    js, jd, st, dt = problem
    J = validator.autodiff_frame_jacobian(_preint_residual, st, dt).numpy()
    J_jax = np.asarray(jax.jit(lambda s, d: jvalidator.autodiff_frame_jacobian(
        _jax_preint_residual, s, d))(js, jd))
    assert J.shape == J_jax.shape == (4 * 15, 4 * 15)
    assert np.abs(J).max() > 1.0
    np.testing.assert_allclose(J, J_jax, rtol=0, atol=JAX_TOL)


def test_autodiff_landmark_jacobian_matches_jax(problem):
    js, jd, st, dt = problem

    def reproj(state, data):
        return factors.reproj_residual_jac(state, data)[0].reshape(-1)

    def jax_reproj(state, data):
        return jfactors.reproj_residual_jac(state, data)[0].reshape(-1)

    J = validator.autodiff_landmark_jacobian(reproj, st, dt).numpy()
    J_jax = np.asarray(jax.jit(lambda s, d: jvalidator.autodiff_landmark_jacobian(
        jax_reproj, s, d))(js, jd))
    assert J.shape == J_jax.shape == (4 * 32 * 2, 32)
    assert np.abs(J).max() > 1.0
    np.testing.assert_allclose(J, J_jax, rtol=0, atol=JAX_TOL)


@pytest.fixture(scope="module")
def analytic(problem):
    _, _, st, dt = problem
    return validator.analytic_frame_jacobians(st, dt)


@pytest.mark.parametrize("name", NAMES)
def test_validate_passes_analytic_jacobian(name, problem, analytic):
    _, _, st, dt = problem
    fn, J = analytic[name]
    assert float(J.abs().max()) > 1.0
    err = validator.validate(fn, J, st, dt, validator.Options(max_jacobian_error=2e-6))
    assert err < 2e-6


@pytest.mark.parametrize("name", NAMES)
def test_validate_rejects_perturbed_jacobian(name, problem, analytic):
    _, _, st, dt = problem
    fn, J = analytic[name]
    bad = J.clone()
    r, c = np.unravel_index(int(J.abs().argmax()), tuple(J.shape))
    bad[r, c] += 1e-3
    with pytest.raises(AssertionError, match="Jacobian error"):
        validator.validate(fn, bad, st, dt)
