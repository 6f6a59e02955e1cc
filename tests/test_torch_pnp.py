"""`xrslam_tpu_torch.ransac.pnp` against `xrslam_tpu.ransac.pnp` on inputs
made with numpy from a seed, in float64, with the minimal samples JAX
drew injected as `idx`: the 6-point DLT, the reprojection error, RANSAC,
PARSAC and IMU-PARSAC PnP (the same best hypothesis, masks, counts;
T <= 1e-9, bin confidences <= 1e-12) and the IRLS pose refine (<= 1e-9).

The DLT's null vector comes from an SVD on both sides (LAPACK); the
port's cube root is `pow(x, 1/3)` against `jnp.cbrt`, a few ulp apart,
so T is held to 1e-9 and not to the 1e-12 of plain arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.ransac import core as jcore
from xrslam_tpu.ransac import parsac as jparsac
from xrslam_tpu.ransac import pnp as jpnp
from xrslam_tpu_torch.ransac import core, parsac, pnp

T = torch.as_tensor
FU = 450.0


def _np(x):
    return np.array(x)


def _rot(w):
    return _np(jlie.quat_to_matrix(jlie.expmap(jnp.asarray(w, dtype=jnp.float64))))


def pnp_scene(seed, N=256, n_valid=200, noise=1e-3):
    """World points, their normalized projections under a seeded pose
    with pixel-level noise, a rigidly shifted cluster (a dynamic object:
    the points right of x = 0.15), track lengths and the valid prefix.
    Returns (X, x, lens, valid, T_true)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3.0, -2.0, 4.0], [3.0, 2.0, 9.0], (N, 3))
    R = _rot(rng.normal(0, 0.1, 3))
    t = rng.normal(0, 0.3, 3)
    Xc = X @ R.T + t
    x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, noise, (N, 2))
    obj = x[:, 0] > 0.15
    x[obj] += np.array([0.03, -0.02])
    lens = rng.integers(0, 25, N)
    valid = np.arange(N) < n_valid
    T_true = np.eye(4)
    T_true[:3, :3], T_true[:3, 3] = R, t
    return X, x, lens, valid, T_true


def jax_weights(x, conf, valid, norm_scale):
    b = jparsac.bucket_points(jnp.asarray(x), norm_scale)
    return jparsac.point_weights(b, jnp.asarray(conf), jnp.asarray(valid),
                                 dtype=jnp.float64)


def best_of(models, T_out):
    """Index of the hypothesis whose model is T_out (exact match)."""
    hit = np.nonzero(np.all(models == T_out[None], axis=(1, 2)))[0]
    assert len(hit) >= 1
    return int(hit[0])


def score_gap(X, x, idx, thr, valid, norm_scale, lens=None, prior_T=None,
              p_dyn=0.0):
    """Gap between the best score and the best score of a hypothesis
    with another inlier set (port side); identical inlier sets score
    identically in both packages and argmax takes the first."""
    Xt, xt, vt = T(X), T(x), T(valid)
    models, errors = core.hypotheses(None, pnp._solver, pnp.pnp_reproject_error,
                                     (Xt, xt), len(X), 6, len(idx), vt, idx=T(idx))
    inl = (errors <= thr) & vt[None]
    b = parsac.bucket_points(xt, norm_scale)
    cnt, has = parsac._bin_stats(b, vt, torch.float64)
    locs = parsac.bin_locations(norm_scale)
    lw = None
    if lens is not None:
        bl = parsac._bin_sum(T(lens).double() * vt.double(), b)
        bl = torch.where(has, bl / torch.clamp(cnt, min=1.0), 0.0)
        lw = 1.0 - torch.pow(min(max(p_dyn, 0.0), 1.0 - 1e-6), 0.1 * bl)
    s, _ = parsac.parsac_score(inl, vt, b, locs, cnt, has, lw)
    if prior_T is not None:
        pe = pnp.pnp_reproject_error(T(prior_T)[None], Xt, xt)[0]
        ov = torch.sum(inl & ((pe <= 2 * thr) & vt)[None], dim=-1)
        s = torch.where(ov >= 6, s, float("-inf"))
    s = s.numpy()
    inl = inl.numpy()
    top = int(np.argmax(s))
    other = [s[h] for h in range(len(s)) if not np.array_equal(inl[h], inl[top])
             and np.isfinite(s[h])]
    return s[top] - max(other) if other else np.inf


def test_solve_pnp_dlt_matches():
    rng = np.random.default_rng(0)
    X, x, _, _, T_true = pnp_scene(1, N=64, noise=0.0)
    x = (X @ T_true[:3, :3].T + T_true[:3, 3])
    x = x[:, :2] / x[:, 2:3]
    # exact minimal samples (the pose itself) and noisy batched ones
    out = pnp.solve_pnp_dlt(T(X[:6]), T(x[:6])).numpy()
    np.testing.assert_allclose(out, T_true, atol=1e-9)
    np.testing.assert_allclose(out, _np(jpnp.solve_pnp_dlt(jnp.asarray(X[:6]),
                                                           jnp.asarray(x[:6]))),
                               rtol=0, atol=1e-9)
    idx = np.stack([rng.choice(64, 6, replace=False) for _ in range(32)])
    xn = x + rng.normal(0, 1e-3, x.shape)
    batch = pnp.solve_pnp_dlt(T(X[idx]), T(xn[idx])).numpy()
    ref = _np(jax.vmap(jpnp.solve_pnp_dlt)(jnp.asarray(X[idx]), jnp.asarray(xn[idx])))
    np.testing.assert_allclose(batch, ref, rtol=0, atol=1e-9)
    # more than 6 points, and a rotation that is proper (det +1)
    many = pnp.solve_pnp_dlt(T(X), T(xn)).numpy()
    np.testing.assert_allclose(many, _np(jpnp.solve_pnp_dlt(jnp.asarray(X),
                                                            jnp.asarray(xn))),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.linalg.det(batch[:, :3, :3]), 1.0, atol=1e-12)


def test_pnp_reproject_error_matches():
    X, x, _, _, T_true = pnp_scene(2, N=40)
    X[:5, 2] = -X[:5, 2] - 10.0          # behind the camera
    e = pnp.pnp_reproject_error(T(T_true), T(X), T(x)).numpy()
    ref = _np(jpnp.pnp_reproject_error(jnp.asarray(T_true), jnp.asarray(X),
                                       jnp.asarray(x)))
    assert np.isinf(e[:5]).all() and np.isinf(ref[:5]).all()
    np.testing.assert_allclose(e[5:], ref[5:], rtol=1e-12, atol=1e-15)
    batch = pnp.pnp_reproject_error(T(np.stack([T_true, np.eye(4)])), T(X), T(x))
    np.testing.assert_allclose(batch[0].numpy(), e, rtol=1e-12, atol=0)


def test_find_pnp_matrix_matches():
    X, x, _, valid, _ = pnp_scene(3)
    key = jax.random.PRNGKey(5)
    idx = _np(jcore.sample_minimal(key, 256, len(X), 6, jnp.asarray(valid)))
    T_j, m_j, c_j = jpnp.find_pnp_matrix(key, jnp.asarray(X), jnp.asarray(x),
                                         valid=jnp.asarray(valid), threshold=1.0 / FU)
    T_t, m_t, c_t = pnp.find_pnp_matrix(None, T(X), T(x), valid=T(valid),
                                        threshold=1.0 / FU, idx=T(idx))
    np.testing.assert_array_equal(m_t.numpy(), _np(m_j))
    assert int(c_t) == int(c_j) and int(c_j) > 100
    np.testing.assert_allclose(T_t.numpy(), _np(T_j), rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [4, 6])
def test_find_pnp_matrix_parsac_matches(seed):
    X, x, _, valid, _ = pnp_scene(seed)
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.0, 1.0, parsac.N_BINS)
    ns = 1.0
    thr = 2 * pnp.CHI2_2DOF / FU ** 2
    key = jax.random.PRNGKey(seed)
    idx = _np(jcore.sample_minimal(key, 256, len(X), 6, jnp.asarray(valid),
                                   jax_weights(x, conf, valid, ns)))
    assert score_gap(X, x, idx, thr, valid, ns) > 1e-6
    T_j, m_j, c_j, conf_j = jpnp.find_pnp_matrix_parsac(
        key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(conf),
        valid=jnp.asarray(valid), threshold=1.0 / FU, norm_scale=ns)
    T_t, m_t, c_t, conf_t = pnp.find_pnp_matrix_parsac(
        None, T(X), T(x), T(conf), valid=T(valid), threshold=1.0 / FU,
        norm_scale=ns, idx=T(idx))
    models_t = pnp.solve_pnp_dlt(T(X)[T(idx)], T(x)[T(idx)]).numpy()
    models_j = _np(jax.vmap(jpnp.solve_pnp_dlt)(jnp.asarray(X[idx]), jnp.asarray(x[idx])))
    h = best_of(models_t, T_t.numpy())
    np.testing.assert_allclose(models_j[h], _np(T_j), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(m_t.numpy(), _np(m_j))
    assert int(c_t) == int(c_j)
    np.testing.assert_allclose(T_t.numpy(), _np(T_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(conf_t.numpy(), _np(conf_j), rtol=0, atol=1e-12)
    assert (_np(conf_j) > 0).sum() > 20


@pytest.mark.parametrize("p_dyn", [0.0, 0.2])
def test_find_pnp_matrix_parsac_imu_matches(p_dyn):
    X, x, lens, valid, T_true = pnp_scene(7)
    rng = np.random.default_rng(8)
    conf = rng.uniform(0.0, 1.0, parsac.N_BINS)
    ns = 1.5
    thr = 2 * pnp.CHI2_2DOF / FU ** 2
    prior = T_true.copy()
    prior[:3, :3] = _rot([0.002, -0.001, 0.001]) @ T_true[:3, :3]
    prior[:3, 3] += [0.003, -0.002, 0.002]
    key = jax.random.PRNGKey(9)
    idx = _np(jcore.sample_minimal(key, 256, len(X), 6, jnp.asarray(valid),
                                   jax_weights(x, conf, valid, ns)))
    assert score_gap(X, x, idx, thr, valid, ns, lens=lens, prior_T=prior,
                     p_dyn=p_dyn) > 1e-6
    out_j = jpnp.find_pnp_matrix_parsac_imu(
        key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(lens), jnp.asarray(prior),
        jnp.asarray(conf), p_dyn, valid=jnp.asarray(valid), threshold=1.0 / FU,
        norm_scale=ns)
    out_t = pnp.find_pnp_matrix_parsac_imu(
        None, T(X), T(x), T(lens), T(prior), T(conf), p_dyn, valid=T(valid),
        threshold=1.0 / FU, norm_scale=ns, idx=T(idx))
    T_j, m_j, c_j, conf_j, ok_j = (_np(a) for a in out_j)
    T_t, m_t, c_t, conf_t, ok_t = (a.numpy() for a in out_t)
    assert bool(ok_t) and bool(ok_j)
    models_t = pnp.solve_pnp_dlt(T(X)[T(idx)], T(x)[T(idx)]).numpy()
    models_j = _np(jax.vmap(jpnp.solve_pnp_dlt)(jnp.asarray(X[idx]), jnp.asarray(x[idx])))
    h = best_of(models_t, T_t)
    np.testing.assert_allclose(models_j[h], T_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(m_t, m_j)
    assert int(c_t) == int(c_j)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(conf_t, conf_j, rtol=0, atol=1e-12)
    # the object (shifted cluster) is rejected, most static points kept
    obj = (x[:, 0] > 0.15) & valid
    assert m_t[obj].mean() < 0.05 and m_t[valid & ~obj].mean() > 0.9


def test_imu_parsac_prior_gate_fallback_matches():
    """A prior pose far off fails the 2x-threshold gate: the model is
    the prior, every valid point an inlier, the bin state unchanged."""
    X, x, lens, valid, T_true = pnp_scene(10)
    conf = np.full(parsac.N_BINS, 0.5)
    prior = T_true.copy()
    prior[:3, 3] += [0.5, 0.0, 0.0]
    key = jax.random.PRNGKey(11)
    idx = _np(jcore.sample_minimal(key, 256, len(X), 6, jnp.asarray(valid),
                                   jax_weights(x, conf, valid, 1.0)))
    out_j = jpnp.find_pnp_matrix_parsac_imu(
        key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(lens), jnp.asarray(prior),
        jnp.asarray(conf), 0.2, valid=jnp.asarray(valid), threshold=1.0 / FU)
    out_t = pnp.find_pnp_matrix_parsac_imu(
        None, T(X), T(x), T(lens), T(prior), T(conf), 0.2, valid=T(valid),
        threshold=1.0 / FU, idx=T(idx))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert not bool(out_t[4])
    np.testing.assert_array_equal(out_t[0].numpy(), prior)
    np.testing.assert_array_equal(out_t[1].numpy(), valid)
    np.testing.assert_array_equal(out_t[3].numpy(), conf)


def test_refine_pose_pnp_matches():
    """The scene of tests/test_visual_pnp.py: 10% of the bearings are
    outliers, the prior is off by ~4 degrees and ~0.18 m."""
    rng = np.random.default_rng(3)
    N = 64
    X = rng.uniform(-2, 2, (N, 3))
    X[:, 2] += 6.0
    q_true = _np(jlie.quat_normalize(jnp.asarray([0.9, 0.1, -0.2, 0.15])))
    p_true = np.array([0.3, -0.2, 0.5])
    R = _np(jlie.quat_to_matrix(jnp.asarray(q_true)))
    y = (X - p_true) @ R
    b = y / np.linalg.norm(y, axis=1, keepdims=True)
    valid = np.ones(N, bool)
    valid[50:] = False
    b[45:50] = rng.normal(size=(5, 3))
    b[45:50] /= np.linalg.norm(b[45:50], axis=1, keepdims=True)
    W = np.diag([450.0 / np.sqrt(0.5)] * 2)
    q0 = _np(jlie.quat_normalize(jlie.quat_mul(
        jnp.asarray(q_true), jlie.expmap(jnp.asarray([0.05, -0.03, 0.04])))))
    p0 = p_true + np.array([0.1, -0.08, 0.12])
    for iters in (1, 10):
        q_j, p_j = jpnp.refine_pose_pnp(jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(X),
                                        jnp.asarray(b), jnp.asarray(valid),
                                        jnp.asarray(W), iters=iters)
        q_t, p_t = pnp.refine_pose_pnp(T(q0), T(p0), T(X), T(b), T(valid), T(W),
                                       iters=iters)
        np.testing.assert_allclose(q_t.numpy(), _np(q_j), rtol=0, atol=1e-9)
        np.testing.assert_allclose(p_t.numpy(), _np(p_j), rtol=0, atol=1e-9)
    assert np.linalg.norm(p_t.numpy() - p_true) < 1e-3
    v = rng.normal(size=(7, 3))
    np.testing.assert_allclose(pnp.quat_rotate_inv_rows(T(q_true), T(v)).numpy(),
                               _np(jpnp.quat_rotate_inv_rows(jnp.asarray(q_true),
                                                             jnp.asarray(v))),
                               rtol=0, atol=1e-12)
