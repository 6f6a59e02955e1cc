"""`xrslam_tpu_torch.ransac.parsac` and the PARSAC entries of
`ransac/stereo.py` against the JAX package, on inputs made with numpy
from a seed in float64, with JAX's minimal samples injected as `idx`.

Tolerances: bin indices, counts and masks exactly; bin confidences,
point weights and scores 1e-12 absolute (the port sums bins as a
one-hot product, JAX by scatter-add: summation order only); the stereo
models 1e-9 (minimal solvers through SVD/eigen decompositions; E up to
the sign the 5-point solver leaves free).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.ransac import core as jcore
from xrslam_tpu.ransac import parsac as jparsac
from xrslam_tpu.ransac import stereo as jstereo
from xrslam_tpu_torch.ransac import core, parsac, stereo

T = torch.as_tensor


def _np(x):
    return np.array(x)


def _points(seed, N=256, scale=1.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.1 * scale, 1.1 * scale, (N, 2))   # some past the grid
    valid = rng.uniform(size=N) < 0.8
    return rng, pts, valid


@pytest.mark.parametrize("norm_scale", [1.0, 1.5])
def test_bins_and_weights_match(norm_scale):
    rng, pts, valid = _points(0, scale=norm_scale)
    pts[:3] = [[-norm_scale, -norm_scale], [0.0, 0.0], [norm_scale, norm_scale]]
    b_t = parsac.bucket_points(T(pts), norm_scale).numpy()
    b_j = _np(jparsac.bucket_points(jnp.asarray(pts), norm_scale))
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_allclose(parsac.bin_locations(norm_scale).numpy(),
                               _np(jparsac.bin_locations(norm_scale, jnp.float64)),
                               rtol=0, atol=1e-15)
    cnt_t, has_t = parsac._bin_stats(T(b_t), T(valid), torch.float64)
    cnt_j, has_j = jparsac._bin_stats(jnp.asarray(b_j), jnp.asarray(valid), jnp.float64)
    np.testing.assert_array_equal(cnt_t.numpy(), _np(cnt_j))
    np.testing.assert_array_equal(has_t.numpy(), _np(has_j))
    conf = rng.uniform(0.0, 1.0, parsac.N_BINS)
    w_t = parsac.point_weights(T(b_t), T(conf), T(valid)).numpy()
    w_j = _np(jparsac.point_weights(jnp.asarray(b_j), jnp.asarray(conf),
                                    jnp.asarray(valid), jnp.float64))
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-12)
    assert (w_t[~valid] == 0).all() and (w_t[valid] > 0).all()
    np.testing.assert_array_equal(parsac.initial_bin_confidences().numpy(),
                                  _np(jparsac.initial_bin_confidences(jnp.float64)))


@pytest.mark.parametrize("with_len", [False, True])
def test_parsac_score_matches(with_len):
    rng, pts, valid = _points(1)
    b = parsac.bucket_points(T(pts))
    cnt, has = parsac._bin_stats(b, T(valid), torch.float64)
    locs = parsac.bin_locations()
    masks = rng.uniform(size=(32, len(pts))) < rng.uniform(0.2, 0.9, (32, 1))
    masks[0] = False                                  # an empty hypothesis
    lw = rng.uniform(0, 1, parsac.N_BINS) if with_len else None
    s_t, c_t = parsac.parsac_score(T(masks), T(valid), b, locs, cnt, has,
                                   None if lw is None else T(lw))
    bj, cj, hj = jnp.asarray(b.numpy()), jnp.asarray(cnt.numpy()), jnp.asarray(has.numpy())
    ref = [jparsac.parsac_score(jnp.asarray(m), jnp.asarray(valid), bj,
                                jparsac.bin_locations(1.0, jnp.float64), cj, hj,
                                None if lw is None else jnp.asarray(lw))
           for m in masks]
    np.testing.assert_allclose(s_t.numpy(), np.array([_np(r[0]) for r in ref]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(c_t.numpy(), np.stack([_np(r[1]) for r in ref]),
                               rtol=0, atol=1e-12)
    assert s_t[0] == 0 and (s_t[1:] > 0).all()


def test_weighted_draw_and_scored_selection():
    """sample_minimal's weights bias the draw (a point of weight 1e-30
    is never drawn while six heavier ones remain), and select_best
    picks by `scores` when they are given."""
    gen = torch.Generator().manual_seed(3)
    w = torch.ones(64, dtype=torch.float64)
    w[:32] = 1e-30
    idx = core.sample_minimal(gen, 512, 64, 6, weights=w)
    assert (idx >= 32).all()
    valid = torch.ones(64, dtype=torch.bool)
    valid[40:] = False
    idx = core.sample_minimal(gen, 512, 64, 6, valid=valid, weights=w)
    assert ((idx >= 32) & (idx < 40)).all()
    errors = torch.tensor([[0.0, 0.0, 9.0], [0.0, 9.0, 9.0], [0.0, 0.0, 0.0]])
    best, mask, count = core.select_best(errors, 1.0)
    assert int(best) == 2 and int(count) == 3
    best, mask, count = core.select_best(errors, 1.0, scores=torch.tensor([0.1, 0.7, 0.2]))
    assert int(best) == 1 and int(count) == 1
    assert mask.tolist() == [True, False, False]


def _two_view(seed, n=256, noise=3e-4):
    """Normalized two-view correspondences (z = 1) with a shifted
    cluster (a dynamic object) and the valid prefix."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3))
    R = _np(jlie.quat_to_matrix(jlie.expmap(jnp.array([0.05, -0.1, 0.08]))))
    t = np.array([0.4, 0.05, -0.1])
    x1 = X / X[:, 2:3]
    X2 = X @ R.T + t
    x2 = X2 / X2[:, 2:3]
    x2[:, :2] += rng.normal(0, noise, (n, 2))
    obj = (x1[:, 0] > 0.1) & (x1[:, 1] > -0.1)
    x2[obj, :2] += np.array([0.02, 0.015])
    valid = np.arange(n) < 220
    return rng, x1, x2, valid


def test_essential_parsac_matches():
    rng, x1, x2, valid = _two_view(2)
    conf = rng.uniform(0, 1, parsac.N_BINS)
    key = jax.random.PRNGKey(4)
    b = jparsac.bucket_points(jnp.asarray(x2[:, :2]), 1.0)
    w = jparsac.point_weights(b, jnp.asarray(conf), jnp.asarray(valid), jnp.float64)
    idx = _np(jcore.sample_minimal(key, 32, len(x1), 5, jnp.asarray(valid), w))
    E_j, m_j, c_j, conf_j = jstereo.find_essential_matrix_parsac(
        key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(conf),
        valid=jnp.asarray(valid), threshold=1e-3, n_hyp=32)
    E_t, m_t, c_t, conf_t = stereo.find_essential_matrix_parsac(
        None, T(x1), T(x2), T(conf), valid=T(valid), threshold=1e-3, n_hyp=32,
        idx=T(idx))
    np.testing.assert_array_equal(m_t.numpy(), _np(m_j))
    assert int(c_t) == int(c_j) > 100
    E_t, E_j = E_t.numpy(), _np(E_j)
    assert min(np.abs(E_t - E_j).max(), np.abs(E_t + E_j).max()) < 1e-9
    np.testing.assert_allclose(conf_t.numpy(), _np(conf_j), rtol=0, atol=1e-12)
    obj = (x1[:, 0] > 0.1) & (x1[:, 1] > -0.1) & valid
    assert not m_t.numpy()[obj].any()


def test_homography_parsac_matches():
    rng = np.random.default_rng(5)
    n = 200
    p1 = rng.uniform(-0.8, 0.8, (n, 2))
    H = np.array([[1.02, 0.03, 0.05], [-0.02, 0.98, -0.03], [0.01, -0.02, 1.0]])
    ph = np.concatenate([p1, np.ones((n, 1))], 1) @ H.T
    p2 = ph[:, :2] / ph[:, 2:3] + rng.normal(0, 1e-4, (n, 2))
    out = rng.uniform(size=n) < 0.25
    p2[out] += rng.uniform(-0.2, 0.2, (out.sum(), 2))
    valid = np.ones(n, bool)
    conf = np.full(parsac.N_BINS, 0.5)
    key = jax.random.PRNGKey(6)
    b = jparsac.bucket_points(jnp.asarray(p2), 1.0)
    w = jparsac.point_weights(b, jnp.asarray(conf), jnp.asarray(valid), jnp.float64)
    idx = _np(jcore.sample_minimal(key, 128, n, 4, jnp.asarray(valid), w))
    H_j, m_j, c_j, conf_j = jstereo.find_homography_matrix_parsac(
        key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(conf), threshold=1e-3)
    H_t, m_t, c_t, conf_t = stereo.find_homography_matrix_parsac(
        None, T(p1), T(p2), T(conf), threshold=1e-3, idx=T(idx))
    np.testing.assert_array_equal(m_t.numpy(), _np(m_j))
    assert int(c_t) == int(c_j) >= (~out).sum() - 3
    np.testing.assert_allclose(H_t.numpy() / H_t.numpy()[2, 2],
                               _np(H_j) / _np(H_j)[2, 2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(conf_t.numpy(), _np(conf_j), rtol=0, atol=1e-12)
