"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither jax nor the JAX package, so it runs on
a machine with a CUDA device and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`tests/conftest.py` imports jax, hence `--noconftest` there). Every
test skips without a CUDA device.

K1's fused entry also runs on the device-chained frontend's input
(scattered live slots, dead slots at stale positions outside the
image), and a chained dispatch syncs no more than a standard one.

K2's fused entry also runs on one rank's landmark shard of the sharded
solve (K=32, L/W columns), and the cuBLAS Gram form
(`gram.reproj_gram_matmul`) is held to entry 1's plain version.

K2's fused entry also takes a batch of windows (a leading axis): one
call against the plain version, each row bit-equal to a single-window
call, the N=1 batch bit-equal to the single-window call; and the batched
chained solve against single solves within 1e-9.

Tolerances, both from summation order alone: K1 (float32, both
entries) status equal on >= 99% of slots and positions within 1e-3 px
on the slots live on both sides; K2 rtol = atol = 1e-9 in float64 and 1e-4 in float32. The
fused entry in float32 is judged against the float64 plain result,
entry by entry in units of eps * sum|term| (`gram.rounding_ratios`): it
may be at most 4x as far off as the float32 plain version is.

PARSAC and PnP are plain PyTorch on the card (no kernel of their own):
their card tests hold the scores and per-bin sums to the CPU at 1e-12
and to themselves bit for bit on repeat, and the PnP DLT and refine to
the CPU at 1e-9.
"""

import numpy as np
import pytest
import torch

from xrslam_tpu_torch.estimation import factors, gram
from xrslam_tpu_torch.frontend import image as img_ops
from xrslam_tpu_torch.frontend import klt
from xrslam_tpu_torch.frontend.tracker import _preprocess_image
from xrslam_tpu_torch.kernels import build
from xrslam_tpu_torch.io.synthetic import reproj_window, scattered_slots
from xrslam_tpu_torch.tools.make_dataset import render_sequence

pytestmark = pytest.mark.gpu

NAMES = ["P", "b6", "Hll", "Hfl6", "bl"]
KW = dict(win=21, iters=30, eps=0.01)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pair(dev):
    """CLAHE'd pyramids of a rendered 320x240 frame pair on the card
    and 256 GFTT points of the first frame."""
    seq = render_sequence(n_frames=2)
    pyrs = [_preprocess_image(torch.from_numpy(im).to(dev), 6.0, 8, 8, 3)
            for im in seq["images"]]
    cand, _, ok = img_ops.gftt_candidates(pyrs[0][0], max_candidates=256)
    return pyrs, cand.contiguous(), ok


def _agree(out, ref, what) -> int:
    agree = float((out[1] == ref[1]).float().mean()) if len(ref[1]) else 1.0
    assert agree >= 0.99, f"{what}: status agrees on {agree:.4f} of slots"
    live = out[1] & ref[1]
    if bool(live.any()):
        err = float((out[0] - ref[0]).abs()[live].max())
        assert err <= 1e-3, f"{what}: max position error {err:.2e} px"
    return int(live.sum())


def test_klt_level_matches_plain(dev, pair):
    """Every level of the forward chain (search 64 on top, 32 below;
    level 3 is shorter than the block) and the level-0 backward pass,
    each launched through the dispatching wrapper."""
    pyrs, pts, ok = pair
    rng = np.random.default_rng(0)
    init = pts + torch.as_tensor(rng.normal(0, 1.5, tuple(pts.shape)),
                                 dtype=torch.float32, device=dev)
    guess, v = init / 8.0, ok
    before = build.KLT_LEVEL.launches
    for lev in (3, 2, 1, 0):
        ix, iy = img_ops.scharr(pyrs[0][lev])
        args = (pyrs[0][lev], ix, iy, pyrs[1][lev], pts / 2.0 ** lev, guess, v)
        kw = dict(KW, final=lev == 0, search=64 if lev == 3 else 32)
        ref = klt.track_level_plain(*args, **kw)
        out = klt.track_level(*args, **kw)
        torch.cuda.synchronize()
        assert _agree(out, ref, f"level {lev}") > 50
        if lev == 0:
            live = out[1] & ref[1]
            torch.testing.assert_close(out[2][live], ref[2][live],
                                       rtol=1e-4, atol=1e-3)
        guess, v = ref[0] * (2.0 if lev > 0 else 1.0), ref[1]
    ix, iy = img_ops.scharr(pyrs[1][0])
    args = (pyrs[1][0], ix, iy, pyrs[0][0], guess, pts, v)
    ref = klt.track_level_plain(*args, **KW, final=True, search=32)
    out = klt.track_level(*args, **KW, final=True, search=32)
    assert _agree(out, ref, "backward") > 50
    assert build.KLT_LEVEL.launches == before + 5
    # the step count: none for a dead slot, 1..iters for a live one
    steps = torch.full((pts.shape[0],), -1, dtype=torch.int32, device=dev)
    out = klt.track_level_cuda(*args, **KW, final=True, search=32, steps_out=steps)
    assert bool((steps[~v] == 0).all())
    assert bool(((steps[out[1]] >= 1) & (steps[out[1]] <= KW["iters"])).all())
    with pytest.raises(ValueError, match="steps_out"):
        klt.track_level_cuda(*args, **KW, final=True, search=32,
                             steps_out=steps.long())


def test_klt_level_edges_and_empty(dev, pair):
    """Points in the first and last pixel of the window margin (the
    last one clamps the template corner), guesses thrown up to ~75 px
    past every image edge (the search block and iterate clamps), and no
    points.

    One LK step only: from guesses that far off, LK does not converge
    in 30 steps, and a non-converging iterate is chaotic in the
    summation order, so the two versions' 30th iterates legitimately
    differ (the tracker's 0.5 px round-trip gate drops such points).
    After one step they agree to rounding: rtol 1e-5 (a step can be
    large where the structure tensor is weak), atol 1e-3 px."""
    pyrs, _, _ = pair
    prev, nxt = pyrs[0][0], pyrs[1][0]
    H, W = prev.shape
    ix, iy = img_ops.scharr(prev)
    rng = np.random.default_rng(1)
    q = 32
    lo = 10.0 + rng.uniform(0, 1, q)
    hi_x, hi_y = W - 11.0 + rng.uniform(0, 0.99, q), H - 11.0 + rng.uniform(0, 0.99, q)
    xs = np.concatenate([lo, hi_x, rng.uniform(10, W - 10, 2 * q)])
    ys = np.concatenate([rng.uniform(10, H - 10, 2 * q), lo, hi_y])
    p = np.stack([xs, ys], 1)
    g = p + rng.normal(0, 25.0, p.shape)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    valid = torch.ones(4 * q, dtype=torch.bool, device=dev)
    kw = dict(KW, iters=1, final=True)
    for search in (32, 64):
        args = (prev, ix, iy, nxt, T(p), T(g), valid)
        ref = klt.track_level_plain(*args, **kw, search=search)
        out = klt.track_level(*args, **kw, search=search)
        agree = float((out[1] == ref[1]).float().mean())
        assert agree >= 0.99, f"search {search}: status agrees on {agree:.4f}"
        live = out[1] & ref[1]
        assert int(live.sum()) > q, f"search {search}: {int(live.sum())} live"
        torch.testing.assert_close(out[0][live], ref[0][live], rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(out[2][live], ref[2][live], rtol=1e-4, atol=1e-3)
    empty = torch.zeros((0, 2), dtype=torch.float32, device=dev)
    g0, v0, e0 = klt.track_level(prev, ix, iy, nxt, empty, empty,
                                 valid[:0], **KW, final=True)
    assert g0.shape == (0, 2) and v0.shape == (0,) and e0.shape == (0,)


def _track_inputs(dev, width=320, height=240, focal=260.0, n=256):
    """CLAHE'd pyramids of a rendered frame pair, n GFTT points of the
    first frame and seeds perturbed by 1.5 px."""
    seq = render_sequence(n_frames=2, width=width, height=height, focal=focal)
    pyrs = [_preprocess_image(torch.from_numpy(im).to(dev), 6.0, 8, 8, 3)
            for im in seq["images"]]
    cand, _, ok = img_ops.gftt_candidates(pyrs[0][0], max_candidates=n)
    rng = np.random.default_rng(n)
    init = cand + torch.as_tensor(rng.normal(0, 1.5, tuple(cand.shape)),
                                  dtype=torch.float32, device=dev)
    return pyrs[0], pyrs[1], cand.contiguous(), init.contiguous(), ok


def _check_track(args, min_live):
    """The fused entry against `track_keypoints_plain`, its step counts,
    and a bit-equal repeat. Returns the fused result."""
    levels, N = len(args[0]), args[2].shape[0]
    before = dict(build.KLT_LEVEL.entry_launches)
    steps = torch.full((N, levels + 1), -1, dtype=torch.int32, device=args[2].device)
    out = klt.track_keypoints_cuda(*args, steps_out=steps)
    ref = klt.track_keypoints_plain(*args)
    torch.cuda.synchronize()
    assert build.KLT_LEVEL.entry_launches[klt.ENTRY_TRACK] \
        == before[klt.ENTRY_TRACK] + (1 if N else 0)
    assert build.KLT_LEVEL.entry_launches[klt.ENTRY_LEVEL] == before[klt.ENTRY_LEVEL]
    assert out[0].shape == (N, 2) and out[1].shape == (N,) and out[1].dtype == torch.bool
    assert _agree(out, ref, "klt_track") >= min_live
    assert bool(torch.isfinite(out[0]).all())
    assert torch.equal(out[0][~out[1]], args[3][~out[1]]), "dead slots keep pts_init"
    if N:
        assert bool((steps[~args[4]] == 0).all()), "a dead slot took LK steps"
        assert bool(((steps >= 0) & (steps <= KW["iters"])).all())
        # a tracked point ran level 0 and the backward pass
        assert bool((steps[out[1]][:, -2:] >= 1).all())
    again = klt.track_keypoints_cuda(*args)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    return out


@pytest.mark.parametrize("size", [(320, 240, 260.0), (752, 480, 458.0)],
                         ids=["320x240", "752x480"])
def test_klt_track_matches_plain(dev, size):
    """K1's fused entry (the main path's) against the per-level plain
    composition, through the dispatcher too."""
    args = _track_inputs(dev, *size)
    _check_track(args, min_live=50)
    before = build.KLT_LEVEL.entry_launches[klt.ENTRY_TRACK]
    klt.track_keypoints(*args)
    assert build.KLT_LEVEL.entry_launches[klt.ENTRY_TRACK] == before + 1


@pytest.mark.parametrize("n", [0, 1, 257])
def test_klt_track_point_counts(dev, n):
    """No points (no launch), one point (its status agrees; at this seed
    both versions drop it), and one more than 256 (a CTA with an idle
    warp)."""
    if n == 0:
        pyr0, pyr1, pts, init, ok = _track_inputs(dev)
        args = (pyr0, pyr1, pts[:0], init[:0], ok[:0])
    else:
        args = _track_inputs(dev, n=n)
    _check_track(args, min_live=50 if n > 50 else 0)


def test_klt_track_seeds_past_edges(dev):
    """Seeds thrown 60 px past every image edge (the search block's
    clamps and zero fill, on every level) and points on the window
    margin (the sample block's clamped corner)."""
    pyr0, pyr1, pts, init, ok = _track_inputs(dev)
    H, W = pyr0[0].shape
    init = init.clone()
    q = 16
    init[0:q, 0] = -60.0
    init[q:2 * q, 0] = W + 60.0
    init[2 * q:3 * q, 1] = -60.0
    init[3 * q:4 * q, 1] = H + 60.0
    pts = pts.clone()
    pts[4 * q:5 * q, 0] = 10.25
    pts[5 * q:6 * q, 1] = H - 10.5
    init[4 * q:6 * q] = pts[4 * q:6 * q]
    out = _check_track((pyr0, pyr1, pts, init, ok), min_live=50)
    assert not bool(out[1][4 * q:6 * q].any()), "the 20 px border gate"


@pytest.mark.parametrize("size", [(320, 240, 260.0), (752, 480, 458.0)],
                         ids=["320x240", "752x480"])
def test_klt_track_on_scattered_slots(dev, size):
    """K1's fused entry on the chained frontend's input (live slots
    scattered, dead slots at stale positions outside the image) against
    the plain version, dead slots untouched and taking no LK step, two
    launches bit-equal (`_check_track`)."""
    pyr0, pyr1, pts, init, ok = _track_inputs(dev, *size)
    pts, init, ok = scattered_slots(pyr0, pts, init, ok)
    out = _check_track((pyr0, pyr1, pts, init, ok), min_live=30)
    assert not bool(out[1][~ok].any())


def _dispatch_syncs(dev, monkeypatch, method: str, **flags) -> list:
    """Device syncs (torch's sync debug mode) in each call of the
    tracker's `method` over a 4-frame rendered image drive on the card."""
    import warnings

    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.frontend.tracker import KLTFeatureTracker
    from xrslam_tpu_torch.tools.make_dataset import run_sequence

    seq = render_sequence(n_frames=4)
    syncs = []
    orig = getattr(KLTFeatureTracker, method)

    def counted(self, *args, **kwargs):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return orig(self, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.append(sum("synchroniz" in str(w.message) for w in seen))

    monkeypatch.setattr(KLTFeatureTracker, method, counted)
    run_sequence(api, api.XRSLAM(config=seq["config"].replace(
        worker_overlap=True, pipelined_writeback=True, **flags), device=dev), seq)
    return syncs


def test_chained_dispatch_adds_no_sync(dev, monkeypatch):
    """A chained dispatch (its slot update and flow rotation in one
    copy from pinned memory) syncs no more than the standard dispatch of
    the same frame pair (frames 1 -> 2; the pairs' first dispatches
    also cache K^-1)."""
    chained = _dispatch_syncs(dev, monkeypatch, "_dispatch_chained", chained_frontend=True)
    standard = _dispatch_syncs(dev, monkeypatch, "_dispatch_track")
    assert len(chained) >= 2 and len(standard) >= 2, (chained, standard)
    assert chained[1] <= standard[1], (chained, standard)


def test_klt_track_graph_capture(dev):
    """The fused wrapper allocates, launches and never syncs: it can be
    captured in a CUDA graph, whose replay gives the eager result."""
    args = _track_inputs(dev)
    eager = klt.track_keypoints_cuda(*args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = klt.track_keypoints_cuda(*args)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0]) and torch.equal(captured[1], eager[1])


def test_klt_track_wrapper_raises(dev):
    pyr0, pyr1, pts, init, ok = _track_inputs(dev)
    with pytest.raises(ValueError, match="float32"):
        klt.track_keypoints_cuda([x.double() for x in pyr0], [x.double() for x in pyr1],
                                 pts, init, ok)
    with pytest.raises(ValueError, match="must be on"):
        klt.track_keypoints(pyr0, pyr1, pts.cpu(), init, ok)
    with pytest.raises(ValueError, match="pyramid level 2"):
        klt.track_keypoints(pyr0, pyr1[:2] + [pyr1[2][:-1].contiguous()] + pyr1[3:],
                            pts, init, ok)
    with pytest.raises(ValueError, match="contiguous"):
        klt.track_keypoints(pyr0, pyr1, pts.t().contiguous().t(), init, ok)
    with pytest.raises(ValueError, match="steps_out"):
        klt.track_keypoints_cuda(pyr0, pyr1, pts, init, ok, steps_out=torch.zeros(
            (pts.shape[0], 5), dtype=torch.int64, device=dev))


def _gram_inputs(K, L, seed, dt, dev):
    """Seeded inputs with a valid anchor one-hot and ~1/4 of the
    landmarks masked out."""
    rng = np.random.default_rng(seed)
    ref_idx = rng.integers(0, K, L)
    mask = rng.uniform(size=L) > 0.25
    R1 = np.eye(K)[ref_idx] * mask[:, None]
    host = [rng.normal(0, 0.1, (K, L, 2)), rng.normal(0, 0.1, (K, L, 2, 6)),
            rng.normal(0, 0.1, (K, L, 2, 6)), rng.normal(0, 0.1, (K, L, 2)), R1]
    return [torch.as_tensor(a, dtype=dt, device=dev) for a in host]


def _check_gram(xs, tol):
    before = build.REPROJ_GRAM.launches
    out = gram.reproj_gram(*xs)
    ref = gram.reproj_gram_plain(*xs)
    torch.cuda.synchronize()
    assert build.REPROJ_GRAM.launches == before + 1
    for n, a, b in zip(NAMES, ref, out):
        assert b.shape == a.shape, n
        torch.testing.assert_close(b, a, rtol=tol, atol=tol, msg=n)
    for a, b in zip(out, gram.reproj_gram(*xs)):
        assert torch.equal(a, b), "two launches differ"


SHAPES = [(12, 384), (32, 2048), (5, 7), (6, 130), (3, 1), (4, 0)]
SHAPE_IDS = ["path", "large_window", "small", "ragged", "one", "no_landmarks"]
DTYPES = [(torch.float64, 1e-9), (torch.float32, 1e-4)]


@pytest.mark.parametrize("K,L", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dt,tol", DTYPES, ids=["f64", "f32"])
def test_reproj_gram_matches_plain(dev, K, L, dt, tol):
    """Entry 1 against its plain version, and bit-equal on a repeat."""
    _check_gram(_gram_inputs(K, L, K * 1000 + L, dt, dev), tol)


def test_reproj_gram_float32_large_window_and_strided_input(dev):
    """K=32 in float32, with Jt handed in as a non-contiguous view and r
    at an address that is not 16-byte aligned."""
    xs = _gram_inputs(32, 64, 7, torch.float32, dev)
    xs[1] = xs[1].permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    assert not xs[1].is_contiguous()
    pad = torch.zeros(xs[0].numel() + 1, dtype=torch.float32, device=dev)
    pad[1:] = xs[0].reshape(-1)
    xs[0] = pad[1:].view(xs[0].shape)
    assert xs[0].data_ptr() % 16 != 0
    _check_gram(xs, 1e-4)


@pytest.mark.parametrize("K,L", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dt,tol", DTYPES, ids=["f64", "f32"])
def test_reproj_factor_gram_matches_plain(dev, K, L, dt, tol):
    """Entry 2 against its plain version (and, in float64 on the small
    windows, the autodiff composition), bit-equal on a repeat."""
    state, data = reproj_window(K, L, seed=K * 1000 + L, dtype=dt, device=dev)
    before = dict(build.REPROJ_GRAM.entry_launches)
    out = gram.reproj_factor_gram(state, data)
    torch.cuda.synchronize()
    assert build.REPROJ_GRAM.entry_launches[gram.ENTRY_FACTOR] \
        == before[gram.ENTRY_FACTOR] + 1
    assert build.REPROJ_GRAM.entry_launches[gram.ENTRY_GRAM] \
        == before[gram.ENTRY_GRAM]
    refs = [gram.reproj_factor_gram_plain(state, data)]
    for n, a, b in zip(NAMES + ["cost"], refs[0], out):
        assert b.shape == a.shape, n
    if dt == torch.float32:
        rk = gram.rounding_ratios(out, state, data)
        rp = gram.rounding_ratios(refs[0], state, data)
        for n, a, b in zip(NAMES + ["cost"], rk, rp):
            assert a <= 4.0 * max(b, 1.0), \
                f"{n}: rounding ratio {a:.3g}, the plain version's {b:.3g}"
        refs = []
    elif 0 < K * L <= 12 * 384:  # vmap takes no empty batch
        refs.append(gram.reproj_factor_gram_plain(
            state, data, jac=factors.reproj_residual_jac))
    for ref in refs:
        for n, a, b in zip(NAMES + ["cost"], ref, out):
            torch.testing.assert_close(b, a, rtol=tol, atol=tol, msg=n)
    for a, b in zip(out, gram.reproj_factor_gram(state, data)):
        assert torch.equal(a, b), "two launches differ"


@pytest.mark.parametrize("W", [2, 4])
def test_reproj_factor_gram_on_a_landmark_shard(dev, W):
    """Entry 2 on each rank's block of L/W columns of the sharded phase's
    K=32, L=2048 window (`parallel.sharded.take_block`), f64, against its
    plain version: a shard is a window of L/W columns."""
    from xrslam_tpu_torch.io.synthetic import demo_window_problem
    from xrslam_tpu_torch.parallel import sharded

    state, data = demo_window_problem(32, 2048, device=dev)
    state = state._replace(inv_depth=state.inv_depth * 1.02)   # off the optimum
    n = 2048 // W
    for r in range(W):
        s, d = (sharded.take_block(x, 0, None, slice(r * n, (r + 1) * n))
                for x in (state, data))
        before = build.REPROJ_GRAM.launches
        out = gram.reproj_factor_gram(s, d)
        ref = gram.reproj_factor_gram_plain(s, d)
        torch.cuda.synchronize()
        assert build.REPROJ_GRAM.launches == before + 1
        for name, a, b in zip(NAMES + ["cost"], ref, out):
            assert b.shape == a.shape, name
            torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=name)


@pytest.mark.parametrize("K,L", [(12, 384), (32, 2048)], ids=["path", "large_window"])
def test_reproj_gram_matmul_matches_plain(dev, K, L):
    """The cuBLAS Gram form (K2's library yardstick) against entry 1's
    plain version on the card, f64; it launches no kernel of the port."""
    xs = _gram_inputs(K, L, K * 1000 + L, torch.float64, dev)
    before = build.REPROJ_GRAM.launches
    out = gram.reproj_gram_matmul(*xs)
    ref = gram.reproj_gram_plain(*xs)
    torch.cuda.synchronize()
    assert build.REPROJ_GRAM.launches == before
    for n, a, b in zip(NAMES, ref, out):
        assert b.shape == a.shape, n
        torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=n)


def _stack(trees):
    from xrslam_tpu_torch.utils.tree import tree_map

    return tree_map(lambda *x: torch.stack(x), *trees)


@pytest.mark.parametrize("K,L,N", [(11, 384, 4), (12, 384, 3), (5, 7, 2), (4, 0, 2),
                                   (32, 256, 2)],
                         ids=["subframe", "path", "small", "no_landmarks", "k32"])
@pytest.mark.parametrize("dt,tol", DTYPES, ids=["f64", "f32"])
def test_reproj_factor_gram_batch(dev, K, L, N, dt, tol):
    """The fused entry on a batch of N windows: one call (2 launches)
    against the plain version, every row bit-equal to a single-window
    call on it, and the N=1 batch bit-equal to the single-window call."""
    pairs = [reproj_window(K, L, seed=100 * i + K, dtype=dt, device=dev)
             for i in range(N)]
    state, data = _stack([p[0] for p in pairs]), _stack([p[1] for p in pairs])
    before = (build.REPROJ_GRAM.launches, dict(build.REPROJ_GRAM.batched))
    out = gram.reproj_factor_gram(state, data)
    torch.cuda.synchronize()
    assert build.REPROJ_GRAM.launches == before[0] + 1
    assert build.REPROJ_GRAM.batched["windows"] == before[1]["windows"] + N
    for n, a, b in zip(NAMES + ["cost"], gram.reproj_factor_gram_plain(state, data), out):
        assert b.shape == a.shape == (N,) + a.shape[1:], n
        if dt == torch.float64:
            torch.testing.assert_close(b, a, rtol=tol, atol=tol, msg=n)
    for i, (s1, d1) in enumerate(pairs):
        for n, a, b in zip(NAMES + ["cost"], gram.reproj_factor_gram(s1, d1), out):
            assert torch.equal(a, b[i]), f"row {i} {n}"
    one = gram.reproj_factor_gram(*[_stack([x]) for x in pairs[0]])
    for n, a, b in zip(NAMES + ["cost"], gram.reproj_factor_gram(*pairs[0]), one):
        assert b.shape == (1,) + a.shape and torch.equal(a, b[0]), n


def test_reproj_factor_gram_batch_graph_capture(dev):
    """The batched call allocates and synchronises nothing in its C call:
    it captures into a CUDA graph, and the replay gives the eager result."""
    state, data = _stack([reproj_window(11, 384, seed=s, device=dev)[0] for s in (1, 2)]), \
        _stack([reproj_window(11, 384, seed=s, device=dev)[1] for s in (1, 2)])
    ref = gram.reproj_factor_gram(state, data)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = gram.reproj_factor_gram(state, data)
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(ref, out):
        assert torch.equal(a, b)


def test_solve_chained_batch_on_the_card(dev):
    """`solver.solve_chained_batch` on the card (K2 over the batch)
    against single `solve_chained` calls, within 1e-9 (f64)."""
    from xrslam_tpu_torch.estimation import solver
    from xrslam_tpu_torch.estimation.solver import SolveOptions
    from xrslam_tpu_torch.estimation.window import WindowData

    wins = []
    for s in (1, 2, 3):
        st, d = reproj_window(6, 64, seed=s, device=dev)
        fix = torch.ones(6, dtype=torch.bool, device=dev)
        fix[5] = False
        d1 = d._replace(fix_pose=fix, fix_motion=fix,
                        fix_landmark=torch.ones_like(d.fix_landmark),
                        frame_mask=torch.ones(6, dtype=torch.bool, device=dev))
        d2 = d1._replace(fix_pose=torch.arange(6, device=dev) == 0,
                         fix_motion=torch.arange(6, device=dev) == 0,
                         fix_landmark=torch.zeros_like(d.fix_landmark))
        assert isinstance(d2, WindowData)
        wins.append((st, d1, d2))
    o1, o2 = SolveOptions(iterations=3, use_preint=False), \
        SolveOptions(iterations=4, use_preint=False)
    before = dict(build.REPROJ_GRAM.batched)
    out = solver.solve_chained_batch([w[0] for w in wins], [w[1] for w in wins], o1,
                                     [w[0] for w in wins], [w[2] for w in wins], o2,
                                     [5, 5, 5])
    assert build.REPROJ_GRAM.batched["launches"] > before["launches"]
    for (st, d1, d2), got in zip(wins, out):
        _, ref, _ = solver.solve_chained(st, d1, o1, st, d2, o2, 5, 5)
        for n, a, b in zip(ref._fields, ref, got):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-9, msg=n)


def test_reproj_factor_gram_inverse_depth_guard(dev):
    """Landmarks at inverse depth 0 take the 1e-12 guard. The
    inverse-depth Jacobian of a point 1e12 m away is conditioned like
    1e12, so the Hll, bl and Hfl6 entries of those landmarks are held to
    1e-3 of the largest such entry of the plain version (as the closed
    form is held to autodiff there on the CPU); everything else at
    rtol = atol = 1e-9."""
    state, data = reproj_window(6, 48, seed=1, n_guard=3, dtype=torch.float64,
                                device=dev)
    out = gram.reproj_factor_gram(state, data)
    ref = gram.reproj_factor_gram_plain(state, data)
    guard = (state.inv_depth == 0) & data.landmark_mask
    assert int(guard.sum()) == 3
    for n, a, b in zip(NAMES + ["cost"], ref, out):
        assert bool(torch.isfinite(b).all()), n
        if n in ("Hll", "bl", "Hfl6"):
            big = float(a[..., guard].abs().max())
            assert big > 0, n
            torch.testing.assert_close(b[..., guard], a[..., guard], rtol=0,
                                       atol=1e-3 * big, msg=n)
            a, b = a[..., ~guard], b[..., ~guard]
        torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=n)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev, pair):
    with pytest.raises(ValueError, match="K <= 32"):
        gram.reproj_gram(*_gram_inputs(33, 16, 0, torch.float64, dev))
    xs = _gram_inputs(4, 16, 0, torch.float64, dev)
    with pytest.raises(ValueError, match="dtype"):
        gram.reproj_gram(*xs[:1], xs[1].float(), *xs[2:])
    with pytest.raises(ValueError, match="must be on"):
        gram.reproj_gram(*xs[:4], xs[4].cpu())
    with pytest.raises(ValueError, match="K <= 32"):
        gram.reproj_factor_gram(*reproj_window(33, 16, device=dev))
    state, data = reproj_window(4, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        gram.reproj_factor_gram(state, data._replace(ref_idx=data.ref_idx.long()))
    with pytest.raises(ValueError, match="dtype"):
        gram.reproj_factor_gram(state, data._replace(bearings=data.bearings.float()))
    with pytest.raises(ValueError, match="must be on"):
        gram.reproj_factor_gram(state, data._replace(obs_mask=data.obs_mask.cpu()))
    with pytest.raises(ValueError, match="must be"):
        gram.reproj_factor_gram(state._replace(inv_depth=state.inv_depth[:-1]), data)
    pyrs, pts, ok = pair
    img = pyrs[0][0]
    with pytest.raises(ValueError, match="float32"):
        klt.track_level(img.double(), img.double(), img.double(), img.double(),
                        pts, pts, ok, **KW)
    with pytest.raises(ValueError, match="search"):
        klt.track_level(img, img, img, img, pts, pts, ok, **KW, search=128)
    with pytest.raises(ValueError, match="must be on"):
        klt.track_level(img, img, img, img, pts.cpu(), pts, ok, **KW)


def _pnp_inputs(seed=0, N=256):
    """A seeded PnP problem with a shifted cluster (a dynamic object),
    the valid prefix, track lengths and bin confidences."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3.0, -2.0, 4.0], [3.0, 2.0, 9.0], (N, 3))
    x = X[:, :2] / X[:, 2:3] + rng.normal(0, 1e-3, (N, 2))
    x[x[:, 0] > 0.15] += [0.03, -0.02]
    return (X, x, rng.integers(0, 25, N), np.eye(4), rng.uniform(0, 1, 400),
            np.arange(N) < 200)


def _imu_pnp(device, inputs, idx=None):
    from xrslam_tpu_torch.ransac import pnp

    X, x, lens, prior, conf, valid = (torch.as_tensor(a, device=device) for a in inputs)
    gen = torch.Generator(device=device).manual_seed(648)
    return pnp.find_pnp_matrix_parsac_imu(gen, X, x, lens, prior, conf, 0.2, valid=valid,
                                          threshold=1.0 / 450.0, norm_scale=1.5, idx=idx)


def test_parsac_scoring_on_the_card(dev):
    """PARSAC's per-bin sums, weights and scores on the card against the
    CPU (1e-12) and bit-equal on repeat; IMU-PARSAC PnP bit-equal on
    repeat and, on the card's minimal samples, equal to the CPU (T 1e-9,
    masks and counts exactly, confidences 1e-12)."""
    from xrslam_tpu_torch.ransac import core, parsac

    X, x, lens, prior, conf, valid = inputs = _pnp_inputs()
    rng = np.random.default_rng(1)
    masks = rng.uniform(size=(256, len(x))) < 0.6

    def scores(device):
        pts = torch.as_tensor(x, device=device)
        v = torch.as_tensor(valid, device=device)
        b = parsac.bucket_points(pts, 1.5)
        cnt, has = parsac._bin_stats(b, v, torch.float64)
        w = parsac.point_weights(b, torch.as_tensor(conf, device=device), v)
        lw = torch.full((400,), 0.5, dtype=torch.float64, device=device)
        s, c = parsac.parsac_score(torch.as_tensor(masks, device=device), v, b,
                                   parsac.bin_locations(1.5, device=device), cnt, has, lw)
        return cnt, w, s, c

    on_card, again, cpu = scores(dev), scores(dev), scores(torch.device("cpu"))
    for a, b, c in zip(on_card, again, cpu):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=0, atol=1e-12)

    a, b = _imu_pnp(dev, inputs), _imu_pnp(dev, inputs)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    gen = torch.Generator(device=dev).manual_seed(648)
    pts = torch.as_tensor(x, device=dev)
    vd = torch.as_tensor(valid, device=dev)
    w = parsac.point_weights(parsac.bucket_points(pts, 1.5),
                             torch.as_tensor(conf, device=dev), vd)
    idx = core.sample_minimal(gen, 256, len(x), 6, vd, w)
    ref = _imu_pnp(torch.device("cpu"), inputs, idx=idx.cpu())
    np.testing.assert_allclose(a[0].cpu().numpy(), ref[0].numpy(), rtol=0, atol=1e-9)
    assert torch.equal(a[1].cpu(), ref[1]) and int(a[2]) == int(ref[2])
    np.testing.assert_allclose(a[3].cpu().numpy(), ref[3].numpy(), rtol=0, atol=1e-12)
    assert bool(a[4]) and bool(ref[4])


def test_pnp_dlt_and_refine_on_the_card(dev):
    """solve_pnp_dlt (256 batched minimal problems) and refine_pose_pnp
    on the card against the CPU: 1e-9."""
    from xrslam_tpu_torch.geometry import lie
    from xrslam_tpu_torch.ransac import pnp

    X, x, *_ = _pnp_inputs(2)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(200, 6, replace=False) for _ in range(256)])
    out = pnp.solve_pnp_dlt(torch.as_tensor(X[idx], device=dev),
                            torch.as_tensor(x[idx], device=dev))
    ref = pnp.solve_pnp_dlt(torch.as_tensor(X[idx]), torch.as_tensor(x[idx]))
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-9)

    q_true = lie.quat_normalize(torch.tensor([0.9, 0.1, -0.2, 0.15], dtype=torch.float64))
    p_true = torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64)
    Xw = torch.as_tensor(X[:64])
    y = (Xw - p_true) @ lie.quat_to_matrix(q_true)
    b = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    valid = torch.ones(64, dtype=torch.bool)
    W = torch.eye(2, dtype=torch.float64) * 450.0 / 0.5 ** 0.5
    q0 = lie.quat_normalize(lie.quat_mul(q_true, lie.expmap(
        torch.tensor([0.05, -0.03, 0.04], dtype=torch.float64))))
    p0 = p_true + torch.tensor([0.1, -0.08, 0.12], dtype=torch.float64)
    args = (q0, p0, Xw, b, valid, W)
    q_c, p_c = pnp.refine_pose_pnp(*(a.to(dev) for a in args), iters=10)
    q_h, p_h = pnp.refine_pose_pnp(*args, iters=10)
    np.testing.assert_allclose(q_c.cpu().numpy(), q_h.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p_c.cpu().numpy(), p_h.numpy(), rtol=0, atol=1e-9)
    assert float(torch.linalg.vector_norm(p_h - p_true)) < 1e-6


def test_checkpoint_restore_stays_on_its_device_type(dev, tmp_path):
    """A checkpoint restores onto the device it is asked for, its
    generators' states with it; a state saved from one device type does
    not load into a generator on the other (ValueError, never a silent
    reseed). The window state is the committed JAX checkpoint's
    (`tests/data/jax_circle_ckpt30.npz`, its configuration the
    bearing-fed tests' `object_scene.base_config`)."""
    import os

    from xrslam_tpu_torch.core.detail import SyntheticTracker
    from xrslam_tpu_torch.tools.object_scene import base_config
    from xrslam_tpu_torch.utils import checkpoint

    jax_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                            "jax_circle_ckpt30.npz")
    cfg = base_config()
    paths = {}
    for d in ("cpu", dev):
        pipe = checkpoint.load_pipeline(jax_file, cfg, SyntheticTracker(device=d), device=d)
        assert pipe.swt.bin_conf.device.type == torch.device(d).type
        assert pipe.swt.marg.sqrt_inv_cov.device.type == torch.device(d).type
        torch.rand((3,), generator=pipe.swt.generator, device=pipe.device)
        paths[torch.device(d).type] = str(tmp_path / f"{torch.device(d).type}.npz")
        checkpoint.save_pipeline(paths[torch.device(d).type], pipe)
    same = checkpoint.load_pipeline(paths["cuda"], cfg, SyntheticTracker(device=dev), device=dev)
    assert same.swt.generator.device.type == "cuda"
    with pytest.raises(ValueError, match="cpu generator state"):
        checkpoint.load_pipeline(paths["cpu"], cfg, SyntheticTracker(device=dev), device=dev)
    with pytest.raises(ValueError, match="cuda generator state"):
        checkpoint.load_pipeline(paths["cuda"], cfg, SyntheticTracker(device="cpu"),
                                 device="cpu")


def test_budget_calibration_syncs_only_at_start_up(dev, monkeypatch):
    """The solver time budget on the card: `_note_solve` on a solve's
    CUDA result synchronizes the device on calls 1-3 of each variant
    and never again (steady state adds no sync), and the estimate it
    keeps is the median of those three."""
    from xrslam_tpu_torch.config import Config
    from xrslam_tpu_torch.core.map import PipelineMap
    from xrslam_tpu_torch.core.sliding_window import SlidingWindowTracker
    from xrslam_tpu_torch.estimation.solver import SolveOptions
    from xrslam_tpu_torch.io.synthetic import demo_window_problem

    swt = SlidingWindowTracker(PipelineMap(), Config(solver_time_limit=0.1), dev)
    state, data = demo_window_problem(4, 32, device=dev)
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), real(*a, **k))[1])
    for variant in ("subwindow", "chained:subwindow", "kf_chain"):
        before = len(syncs)
        for call in range(10):
            st, _ = swt._solve_timed(variant, state, data, SolveOptions(iterations=2))
            assert st.p.is_cuda
            assert len(syncs) - before == min(call, 3)
        samples = swt._solve_samples[variant]
        assert len(samples) == 3 and swt._iter_seconds[variant] == sorted(samples)[1] > 0
    assert swt.stats["budget_syncs"] == len(syncs) == 9


def test_packed_read_is_pinned_and_asynchronous(dev):
    """`utils.fetch`: a handle's copy goes into pinned memory and returns
    before its event completes (queued behind a long matrix product), and
    every dtype lands bit-equal to a plain `.cpu()`."""
    from xrslam_tpu_torch.utils.fetch import fetch_packed_start

    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"f64": torch.randn((5, 3), dtype=torch.float64, device=dev, generator=g),
            "f32": torch.randn((7,), device=dev, generator=g),
            "i64": torch.randint(-2 ** 62, 2 ** 62, (3,), device=dev, generator=g),
            "b": torch.rand((9,), device=dev, generator=g) > 0.5,
            "none": None, "empty": torch.zeros((0, 4), device=dev)}
    a = torch.randn((4096, 4096), device=dev, generator=g)
    torch.cuda.synchronize(dev)
    for _ in range(8):
        a = a @ a / 64.0
    h = fetch_packed_start(tree)
    assert not h.ready(), "the copy waited for the device"
    assert h._host.is_pinned()
    out = h.get()
    assert h.ready() and h.arrived and out["none"] is None
    for k, x in tree.items():
        if x is not None:
            ref = x.cpu().numpy()
            assert out[k].dtype == ref.dtype and out[k].shape == ref.shape
            assert out[k].tobytes() == ref.tobytes(), k
