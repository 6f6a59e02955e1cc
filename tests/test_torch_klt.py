"""K1 (frontend/klt.py): the port's level tracker and pyramidal KLT
against the JAX package, in float32 on a rendered frame pair (the
make_dataset scene at 320x240).

The JAX package's Pallas kernel `klt_pallas.track_level_pallas` has no
interpret mode, so its TPU twin `klt._track_level_mxu` — the level
tracker the JAX package runs on its chip, with the same search-block
confinement and level-0 residual — stands in for it.

Targets (float32): status equal on >= 99% of slots; positions within
1e-3 px on the slots live on both sides.

The fused entry's gradient stage (`klt.scharr_windows`: Scharr on each
point's clamped (win+3)² block, then the bilinear blend) is held to
`image.scharr` + `klt._sample_window` of the JAX package at rtol 1e-5,
atol 1e-4 (summation order).

The CUDA kernel itself runs only on the card; tests/test_torch_cuda.py
holds both entries to their plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.frontend import image as jimage
from xrslam_tpu.frontend import klt as jklt
from xrslam_tpu.frontend.tracker import _preprocess_image as jpreprocess
from xrslam_tpu_torch.frontend import klt
from xrslam_tpu_torch.tools.make_dataset import render_sequence

N_PTS = 256


@pytest.fixture(scope="module")
def pair():
    """JAX-preprocessed pyramids of frames 0 and 1, GFTT points of
    frame 0 and a perturbed initial flow."""
    seq = render_sequence(n_frames=2)
    pyr = [jpreprocess(jnp.asarray(im), 6.0, 8, 8, 3) for im in seq["images"]]
    cand, _, ok = jimage.gftt_candidates(pyr[0][0], max_candidates=N_PTS)
    pts = np.asarray(cand, dtype=np.float32)
    valid = np.asarray(ok)
    rng = np.random.default_rng(0)
    init = (pts + rng.normal(0, 1.0, pts.shape)).astype(np.float32)
    return [[np.asarray(x) for x in p] for p in pyr], pts, init, valid


def _compare(g_t, v_t, g_j, v_j, what):
    v_j = np.asarray(v_j)
    v_t = v_t.numpy()
    agree = np.mean(v_t == v_j)
    assert agree >= 0.99, f"{what}: status agrees on {agree:.4f} of slots"
    live = v_t & v_j
    assert live.sum() > 50, what
    err = np.abs(g_t.numpy()[live] - np.asarray(g_j)[live]).max()
    assert err <= 1e-3, f"{what}: max position error {err:.2e} px"


def test_level_tracker_matches_mxu_twin(pair):
    """Every level of the forward chain (search 64 on top, 32 below)
    and the level-0 backward pass, each from identical inputs."""
    pyrs, pts, init, valid = pair
    guess = init / 8.0
    v = valid
    for lev in (3, 2, 1, 0):
        s = float(2 ** lev)
        prev = pyrs[0][lev]
        ix, iy = (np.asarray(a) for a in jimage.scharr(jnp.asarray(prev)))
        search = 64 if lev == 3 else 32
        args = (prev, ix, iy, pyrs[1][lev], pts / s, guess, v)
        g_j, v_j, e_j = jklt._track_level_mxu(
            *(jnp.asarray(a) for a in args), win=21, iters=30, eps=0.01,
            final=(lev == 0), search=search)
        g_t, v_t, e_t = klt.track_level_plain(
            *(torch.as_tensor(a) for a in args), win=21, iters=30, eps=0.01,
            final=(lev == 0), search=search)
        _compare(g_t, v_t, g_j, v_j, f"level {lev}")
        if lev == 0:
            live = np.asarray(v_j)
            np.testing.assert_allclose(e_t.numpy()[live], np.asarray(e_j)[live],
                                       rtol=1e-4, atol=1e-3)
        guess = np.asarray(g_j) * (2.0 if lev > 0 else 1.0)
        v = np.asarray(v_j)
    # backward pass: level 0 only, seeded at the original points
    prev = pyrs[1][0]
    ix, iy = (np.asarray(a) for a in jimage.scharr(jnp.asarray(prev)))
    args = (prev, ix, iy, pyrs[0][0], guess, pts, v)
    g_j, v_j, _ = jklt._track_level_mxu(*(jnp.asarray(a) for a in args),
                                        win=21, iters=30, eps=0.01, final=True,
                                        search=32)
    g_t, v_t, _ = klt.track_level_plain(*(torch.as_tensor(a) for a in args),
                                        win=21, iters=30, eps=0.01, final=True,
                                        search=32)
    _compare(g_t, v_t, g_j, v_j, "backward")


def test_track_keypoints_matches_jax_mxu(pair, monkeypatch):
    """The whole forward + backward KLT with its gates; the JAX side is
    forced onto the mxu level tracker (read at trace time, so the jit
    caches are cleared around the switch)."""
    pyrs, pts, init, valid = pair
    monkeypatch.setenv("XR_LK_BACKEND", "mxu")
    jax.clear_caches()
    try:
        n_j, s_j = jklt.track_keypoints(
            [jnp.asarray(a) for a in pyrs[0]], [jnp.asarray(a) for a in pyrs[1]],
            jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid))
        n_j, s_j = np.asarray(n_j), np.asarray(s_j)
    finally:
        monkeypatch.delenv("XR_LK_BACKEND")
        jax.clear_caches()
    n_t, s_t = klt.track_keypoints(
        [torch.as_tensor(a) for a in pyrs[0]], [torch.as_tensor(a) for a in pyrs[1]],
        torch.as_tensor(pts), torch.as_tensor(init), torch.as_tensor(valid))
    _compare(n_t, s_t, n_j, s_j, "track_keypoints")


def test_track_level_plain_on_cpu_only(pair):
    """The dispatching wrapper takes the plain version for CPU tensors
    and counts no kernel launch there."""
    from xrslam_tpu_torch.kernels import build

    pyrs, pts, init, valid = pair
    before = build.KLT_LEVEL.launches
    prev = torch.as_tensor(pyrs[0][0])
    g, v, e = klt.track_level(prev, prev, prev, prev, torch.as_tensor(pts),
                              torch.as_tensor(init), torch.as_tensor(valid),
                              win=21, iters=2, eps=0.01, final=True)
    assert build.KLT_LEVEL.launches == before
    assert g.shape == (N_PTS, 2) and v.dtype == torch.bool and e.shape == (N_PTS,)


def test_scharr_windows_match_jax(pair):
    """The window-local Scharr at all four levels, with points on the
    first and last pixel of the 10 px window margin (the last one clamps
    the sample block's corner) and a few past it."""
    pyrs, _, _, _ = pair
    rng = np.random.default_rng(2)
    for lev in range(4):
        img = pyrs[0][lev]
        H, W = img.shape
        q = 8
        lo = 10.0 + rng.uniform(0, 1, q)
        xs = np.concatenate([lo, W - 11.0 + rng.uniform(0, 0.99, q),
                             rng.uniform(10, W - 10, 2 * q), [3.5, W - 2.5]])
        ys = np.concatenate([rng.uniform(10, H - 10, 2 * q), lo,
                             H - 11.0 + rng.uniform(0, 0.99, q), [H - 4.25, 1.75]])
        c = np.stack([xs, ys], 1).astype(np.float32)
        ix, iy = jimage.scharr(jnp.asarray(img))
        want = [np.asarray(jax.vmap(lambda p, a=a: jklt._sample_window(a, p, 21))(
            jnp.asarray(c))) for a in (jnp.asarray(img), ix, iy)]
        got = klt.scharr_windows(torch.as_tensor(img), torch.as_tensor(c), 21)
        for name, g, w in zip(("T", "Ix", "Iy"), got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4,
                                       err_msg=f"level {lev} {name}")


def test_track_keypoints_on_cpu_takes_plain(pair):
    """On CPU tensors the dispatcher returns `track_keypoints_plain`'s
    result and launches neither entry of K1."""
    from xrslam_tpu_torch.kernels import build

    pyrs, pts, init, valid = pair
    args = ([torch.as_tensor(a) for a in pyrs[0]], [torch.as_tensor(a) for a in pyrs[1]],
            torch.as_tensor(pts), torch.as_tensor(init), torch.as_tensor(valid))
    before = dict(build.KLT_LEVEL.entry_launches)
    n_d, s_d = klt.track_keypoints(*args)
    assert build.KLT_LEVEL.entry_launches == before
    n_p, s_p = klt.track_keypoints_plain(*args)
    assert torch.equal(n_d, n_p) and torch.equal(s_d, s_p)
    assert n_d.shape == (N_PTS, 2) and s_d.dtype == torch.bool and int(s_d.sum()) > 50
