"""K2's fused entry on the CPU: the closed-form reprojection Jacobian
(`factors.reproj_residual_jac_closed`) and `gram.reproj_factor_gram_plain`
against the port's autodiff factors and against the JAX package (its
autodiff factors, the einsum branch of `solver.assemble`, and the Pallas
kernel in the Pallas interpreter fed from the JAX factors), in float64.

Inputs are the port's numpy-seeded `io.synthetic.reproj_window`: missing
observations with garbage bearings, masked and fixed landmarks, a
landmark anchored at every frame, per-frame extrinsics, a non-diagonal
`sqrt_inv_cov2`, and (where asked) landmarks at inverse depth 0, which
take the 1e-12 guard. The same arrays go to JAX.

Tolerances: residuals and Jacobians rtol = atol = 1e-10 (same math in
another order); the Gram block rtol = atol = 1e-9 (the JAX package's own
Pallas parity limit). At the guard the inverse-depth Jacobian is
conditioned like 1e12 (a point 1e12 m away): the two autodiff versions
agree there, and the closed form is held to 1e-3 of its largest entry
(both have lost the digits below that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.estimation import factors as jfactors
from xrslam_tpu.estimation import gram as jgram
from xrslam_tpu.estimation import solver as jsolver
from xrslam_tpu.estimation import window as jwindow
from xrslam_tpu.imu import preintegration as jpre
from xrslam_tpu_torch import api
from xrslam_tpu_torch.estimation import factors, gram, solver
from xrslam_tpu_torch.io.synthetic import reproj_window
from xrslam_tpu_torch.kernels import build

JCLASSES = {"WindowState": jwindow.WindowState, "WindowData": jwindow.WindowData,
            "MargPrior": jwindow.MargPrior, "PreintDelta": jpre.PreintDelta}
FACTOR_NAMES = ["r", "Jt", "Jr6", "Jd", "mask"]
GRAM_NAMES = ["P", "b6", "Hll", "Hfl6", "bl"]


def to_jax(x):
    """The port's window NamedTuples as the JAX package's."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    return JCLASSES[type(x).__name__](*(to_jax(f) for f in x))


@pytest.fixture(scope="module", params=[(6, 128, 0), (12, 256, 0), (5, 128, 3)],
                ids=["K6_L128", "K12_L256", "K5_L128_guard"])
def window(request):
    """L is a multiple of the Pallas kernel's 128-landmark tile."""
    K, L, n_guard = request.param
    state, data = reproj_window(K, L, seed=K * 100 + L, n_guard=n_guard)
    guard = (state.inv_depth == 0) & data.landmark_mask
    assert int(guard.sum()) == n_guard
    # every frame anchors a landmark, and every kind of slot is present
    assert set(data.ref_idx[data.landmark_mask].tolist()) == set(range(K))
    assert 0 < int(data.landmark_mask.sum()) < L
    assert bool(data.fix_landmark.any()) and not bool(data.obs_mask.all())
    return state, data, guard.numpy()


def _assert_factors(out, ref, guard, tol=1e-10):
    for n, a, b in zip(FACTOR_NAMES, ref, out):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        if n == "Jd" and guard.any():
            np.testing.assert_allclose(
                b[:, guard], a[:, guard], rtol=0,
                atol=1e-3 * np.abs(a[:, guard]).max(), err_msg=n)
            a, b = a[:, ~guard], b[:, ~guard]
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=n)


def test_closed_form_matches_port_autodiff(window):
    state, data, guard = window
    ref = factors.reproj_residual_jac(state, data)
    out = factors.reproj_residual_jac_closed(state, data)
    _assert_factors([x.numpy() for x in out], [x.numpy() for x in ref], guard)
    assert bool(ref[4].any()) and not bool(ref[4].all())


def test_closed_form_matches_jax_factors(window):
    state, data, guard = window
    ref = jfactors.reproj_residual_jac(to_jax(state), to_jax(data))
    out = factors.reproj_residual_jac_closed(state, data)
    _assert_factors([x.numpy() for x in out], ref, guard)


def _jax_weighted(state, data):
    """The JAX assemble's inputs to its Gram block, and its cost."""
    js, jd = to_jax(state), to_jax(data)
    r, Jt, Jr6, Jd, m = jfactors.reproj_residual_jac(js, jd)
    w, c = jfactors.cauchy_weights(r, m)
    wf = w[..., None]
    K = r.shape[0]
    R1 = (jax.nn.one_hot(jd.ref_idx, K, dtype=r.dtype)
          * jd.landmark_mask[:, None].astype(r.dtype))
    return (r * wf, Jt * wf[..., None], Jr6 * wf[..., None], Jd * wf, R1), jnp.sum(c)


def _assert_gram(out, ref, guard, tol=1e-9):
    for n, a, b in zip(GRAM_NAMES, ref, out):
        a, b = np.asarray(a), b.numpy()
        if n in ("Hll", "Hfl6", "bl") and guard.any():
            assert np.isfinite(b).all(), n
            a, b = a[..., ~guard], b[..., ~guard]
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=n)


def test_factor_gram_plain_matches_pallas_interpret(window):
    state, data, guard = window
    args, cost = _jax_weighted(state, data)
    ref = jgram.reproj_gram_pallas(*args, interpret=True)
    out = gram.reproj_factor_gram_plain(state, data)
    _assert_gram(out[:5], ref, guard)
    np.testing.assert_allclose(float(out[5]), float(cost), rtol=1e-12)


def test_factor_gram_plain_matches_jax_assemble(window):
    """The whole reprojection-only system: the port's assemble (which
    takes the fused entry's plain version here) against the einsum
    branch of the JAX assemble."""
    state, data, guard = window
    ref = jax.jit(jsolver.assemble, static_argnums=2)(
        to_jax(state), to_jax(data), jsolver.SolveOptions(use_preint=False))
    out = solver.assemble(state, data, solver.SolveOptions(use_preint=False))
    _assert_gram(out[:5], ref[:5], guard)
    np.testing.assert_allclose(float(out[5]), float(ref[5]), rtol=1e-12)


def test_factor_gram_plain_matches_autodiff_composition(window):
    """Closed form against autodiff through the whole entry: what
    `solver.assemble` composed from `reproj_residual_jac`,
    `cauchy_weights` and `reproj_gram_plain`."""
    state, data, guard = window
    ref = gram.reproj_factor_gram_plain(state, data, jac=factors.reproj_residual_jac)
    out = gram.reproj_factor_gram_plain(state, data)
    _assert_gram(out[:5], [x.numpy() for x in ref[:5]], guard)
    np.testing.assert_allclose(float(out[5]), float(ref[5]), rtol=1e-12)


def test_factor_gram_dispatch_on_cpu(window):
    """CPU tensors take the plain version, count no launch and reach no
    kernel; the outputs have the JAX shapes."""
    state, data, _ = window
    K, L = data.obs_mask.shape
    before = build.REPROJ_GRAM.launches, dict(build.REPROJ_GRAM.entry_launches)
    out = gram.reproj_factor_gram(state, data)
    assert (build.REPROJ_GRAM.launches, build.REPROJ_GRAM.entry_launches) == before
    assert [tuple(x.shape) for x in out] == [(K, 6, K, 6), (K, 6), (L,),
                                             (K, 6, L), (L,), ()]
    ref = gram.reproj_factor_gram_plain(state, data)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_rounding_ratios_judge_a_float32_result():
    """`gram.rounding_ratios` (how the float32 kernel is judged on the
    card): the float32 plain version lies within 1e4 eps * sum|term| of
    the float64 result, entry by entry (the factors' conditioning); the float64
    plain version is exact in those units; and one small block of P
    that is wrong by 1e-3 of the output's largest entry, far inside a
    tolerance scaled by that entry, stands out."""
    state, data = reproj_window(12, 96, seed=5, dtype=torch.float32)
    out = gram.reproj_factor_gram_plain(state, data)
    ratios = gram.rounding_ratios(out, state, data)
    assert len(ratios) == 6 and all(np.isfinite(ratios)), ratios
    assert max(ratios) < 1e4, ratios
    s64, d64 = reproj_window(12, 96, seed=5)
    assert max(gram.rounding_ratios(gram.reproj_factor_gram_plain(s64, d64),
                                    s64, d64)) == 0.0
    P = out[0].clone()
    P[3, :, 7, :] += 1e-3 * P.abs().max()
    bad = gram.rounding_ratios((P, *out[1:]), state, data)
    assert bad[0] > 4 * max(ratios[0], 1.0) and bad[1:] == ratios[1:]
    # an entry with no terms must be exactly zero
    Hll = out[2].clone()
    Hll[~data.landmark_mask] = 1e-30
    assert gram.rounding_ratios((*out[:2], Hll, *out[3:]), state, data)[2] == np.inf


def test_wrappers_raise_off_the_card():
    """The kernel wrappers take CUDA tensors only, and say so before
    they reach the library."""
    state, data = reproj_window(4, 16)
    with pytest.raises(ValueError, match="must be on"):
        gram.reproj_factor_gram_cuda(state, data)
    r, Jt, Jr6, Jd, _ = factors.reproj_residual_jac_closed(state, data)
    with pytest.raises(ValueError, match="must be on"):
        gram.reproj_gram_cuda(r, Jt, Jr6, Jd, gram.anchor_onehot(data, 4, r.dtype))
    with pytest.raises(ValueError, match="K <= 32"):
        gram.reproj_factor_gram_cuda(*reproj_window(33, 8))


@pytest.mark.parametrize("K,L,want", [(12, 384, (11, 12)), (32, 2048, (4, 32)),
                                      (5, 7, (2, 5)), (4, 0, (1, 4))])
def test_grid_fills_the_card(K, L, want):
    """splits * K CTAs: at least 100 of the 132 SMs get one whenever
    there are landmarks enough."""
    assert gram.grid(K, L) == want
    for k in range(1, gram.MAX_FRAMES + 1):
        s, kk = gram.grid(k, 4096)
        assert kk == k and 100 <= s * k <= 132


def test_xrslam_defaults_to_the_card():
    """`api.XRSLAM` runs on the card unless the caller asks for the
    CPU: without a CUDA device the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.XRSLAM()
    assert api.XRSLAM(device="cpu").device.type == "cpu"
