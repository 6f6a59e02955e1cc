"""Kernel K3, the preintegration factor's block of the normal equations
(`gram.preint_factor_gram`, csrc/preint_gram.cu).

On the CPU: the closed-form Jacobian (`factors.preint_residual_jac_closed`,
the kernel's arithmetic) against the autodiff factors; the plain version
(`gram.preint_factor_gram_plain`) bit for bit the composition that
`solver.assemble` and `marginalize_frame` ran before K3; and the solver's
callers going through `gram.preint_factor_gram` once a call. On the card
(marked `gpu`, skipped without a CUDA device; this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_preint_gram.py -q

K3 against the plain version, repeats bit-equal, H exactly symmetric, a
batch against single calls, the marginalization's mask, one launch per
`assemble`, and the wrapper's refusals.

Windows are `demo_window_problem`'s circle scene: at its ground truth
(residuals of rounding size, the logmap's and expmap's Taylor branches at
0), a small perturbation (rotation residuals ~1e-3 rad, inside the
logmap's Taylor branch), and IMU extrinsics, biases away from their
linearization points and a masked pair (rotation residuals 0.1-1 rad),
once more with one frame turned by 1.7 rad.

Tolerances are in units of each entry's Σ|term|. A factor entry's is
|U|·(|its unweighted value| + 1) (U, the sqrt information, mixes the rows
and its products cancel; the 1, where the entry depends on the state,
for the rounding of the O(1) states and rotations it is computed from,
which is all a residual at the truth holds); a Gram entry's is the Gram
block of those added to the absolute accumulators. Factors, closed form against autodiff: 1e-10 (the
autodiff derivative of the logmap's Taylor branch and the closed form's
Jr⁻¹ part by ~2|v|⁴ of the unweighted entry, 2e-12 at the branch's edge).
Gram outputs: 1e-12 for the kernel against the closed-form plain version
in float64, 1e-10 against the autodiff one; in float32 the kernel may be
4x as far from the float64 result as the float32 plain version is.
"""

import numpy as np
import pytest
import torch

from xrslam_tpu_torch.estimation import factors, gram, marginalization, solver
from xrslam_tpu_torch.geometry import lie
from xrslam_tpu_torch.io.synthetic import demo_window_problem
from xrslam_tpu_torch.kernels import build
from xrslam_tpu_torch.utils.tree import tree_map

KS = [2, 5, 12, 32]
KINDS = ["truth", "small", "extrinsics", "large"]


def window(K, kind, dtype=torch.float64, device=None):
    """`demo_window_problem(K, 32)` moved off its truth as `kind` says
    (module docstring), from a numpy seed."""
    state, data = demo_window_problem(K, 32)
    rng = np.random.default_rng(K * 10 + KINDS.index(kind))

    def T(scale, *shape):
        return torch.as_tensor(scale * rng.normal(size=shape or (K, 3)))

    if kind == "small":
        state = state._replace(
            q=lie.quat_normalize(lie.quat_mul(state.q, lie.expmap(T(5e-4)))),
            p=state.p + T(1e-3), v=state.v + T(1e-3), bg=T(1e-4), ba=T(1e-3))
        data = data._replace(bg_lin=T(1e-4), ba_lin=T(1e-3))
    elif kind != "truth":
        q = lie.quat_normalize(lie.quat_mul(state.q, lie.expmap(T(0.02))))
        if kind == "large":
            q[K - 1] = lie.quat_mul(q[K - 1], lie.expmap(torch.tensor([1.1, -0.9, 0.9],
                                                                      dtype=q.dtype)))
        state = state._replace(q=q, p=state.p + T(0.05), v=state.v + T(0.05),
                               bg=T(1e-3), ba=T(1e-2))
        pm = data.preint_mask.clone()
        if K > 3:
            pm[2] = False   # a masked pair, where there is one to spare
        data = data._replace(q_bi=lie.expmap(T(0.3)), p_bi=T(0.05), bg_lin=T(1e-3),
                             ba_lin=T(1e-2), preint_mask=pm)
    return tuple(tree_map(lambda x: x.to(device=device, dtype=dtype) if x.is_floating_point()
                          else x.to(device), t) for t in (state, data))


def accumulators(K, seed, dtype=torch.float64, device=None):
    """A symmetric H (K,15,K,15) and a b (K,15) to add to."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K * 15, K * 15))
    H = torch.as_tensor((A + A.T).reshape(K, 15, K, 15), dtype=dtype, device=device)
    return H, torch.as_tensor(rng.normal(size=(K, 15)), dtype=dtype, device=device)


def _blocks(*rows):
    """(15,15) pattern of 3x3 blocks: rows[a] lists the column blocks of
    residual block a (q, p, v, bg, ba) that depend on the state."""
    pat = torch.zeros(15, 15, dtype=torch.float64)
    for a, cols in enumerate(rows):
        for c in cols:
            pat[3 * a:3 * a + 3, 3 * c:3 * c + 3] = 1.0
    return pat


# which (theta, p, v, bg, ba) of frame i and of frame j each residual block reads
PATTERN_I = _blocks((0, 3), (0, 1, 2, 3, 4), (0, 2, 3, 4), (3,), (4,))
PATTERN_J = _blocks((0,), (0, 1), (2,), (3,), (4,))


def factor_scales(state, data):
    """Each closed-form factor entry's Σ|term| over its sqrt information:
    |U|·(|unweighted| + 1), the 1 for the rounding of the O(1) states and
    rotations an unweighted entry is computed from (all a residual at the
    truth holds), only where the entry depends on the state; masked, in
    float64 on the CPU."""
    s, d = (tree_map(lambda x: x.cpu().double() if x.is_floating_point() else x.cpu(), t)
            for t in (state, data))
    K = s.q.shape[0]
    eye = torch.eye(15, dtype=torch.float64).expand(K, 15, 15)
    r, Ji, Jj, m = factors.preint_residual_jac_closed(
        s, d._replace(preint=d.preint._replace(sqrt_inv_cov=eye)))
    U = d.preint.sqrt_inv_cov.abs() * m.double()[:, None, None]
    return ((U @ (r.abs() + 1.0)[..., None])[..., 0], U @ (Ji.abs() + PATTERN_I),
            U @ (Jj.abs() + PATTERN_J))


def term_scales(state, data, mask, H, b):
    """Each Gram output's Σ|term|: the blocks of the factors'
    `factor_scales` added to the absolute accumulators."""
    r, Ji, Jj = factor_scales(state, data)
    mf = (mask.cpu() & (torch.arange(r.shape[0]) > 0)).double()
    r, Ji, Jj = r * mf[:, None], Ji * mf[:, None, None], Jj * mf[:, None, None]
    Hs, bs = gram.preint_blocks(H.cpu().double().abs(), b.cpu().double().abs(),
                                r, Ji, Jj, r.shape[0])
    return Hs, bs, 0.5 * torch.sum(r * r)


def term_ratio(out, ref, scales) -> float:
    """The largest |out - ref| over the entry's Σ|term| (inf where an
    entry with no terms is not exactly equal)."""
    worst = 0.0
    for o, e, s in zip(out, ref, scales):
        err = (o.cpu().double() - e.cpu().double()).abs()
        r = torch.where(s > 0, err / s.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
        worst = max(worst, float(r.max()))
    return worst


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", KS)
def test_closed_form_matches_autodiff(K, kind):
    state, data = window(K, kind)
    ref = factors.preint_residual_jac(state, data)
    out = factors.preint_residual_jac_closed(state, data)
    assert torch.equal(out[3], ref[3])
    if kind in ("extrinsics", "large") and K > 3:
        assert not bool(ref[3][2])
    if kind == "large":   # the unweighted rotation residual of the turned pair
        r_q = torch.linalg.solve(data.preint.sqrt_inv_cov[K - 1], ref[0][K - 1])[:3]
        assert float(torch.linalg.norm(r_q)) > 1.0, r_q
    for name, a, b, sc in zip(("r", "J_i", "J_j"), ref, out, factor_scales(state, data)):
        ratio = term_ratio([b], [a], [sc])
        assert ratio <= 1e-10, f"{name}: |Δ| {ratio:.3e} of its Σ|term|"


@pytest.mark.parametrize("K", KS)
def test_plain_is_the_former_composition(K):
    """`preint_factor_gram_plain` equals bit for bit what `assemble` (the
    pair mask, onto accumulators) and `marginalize_frame` (the victim's
    pairs, onto zeros) ran before K3."""
    state, data = window(K, "extrinsics")
    H0, b0 = accumulators(K, K)
    rp, Ji, Jj, mp = factors.preint_residual_jac(state, data)
    H, b = gram.preint_blocks(H0, b0, rp, Ji, Jj, K)
    out = gram.preint_factor_gram_plain(state, data, factors.preint_pair_mask(data), H0, b0)
    for a, c in zip((H, b, 0.5 * torch.sum(rp * rp)), out):
        assert torch.equal(a, c)
    adj = torch.zeros(K, dtype=torch.bool)
    adj[1:3] = True   # the victim 1's pairs
    sel = (adj & mp).double()
    Hm, bm = gram.preint_blocks(torch.zeros((K, 15, K, 15), dtype=torch.float64),
                                torch.zeros((K, 15), dtype=torch.float64),
                                rp * sel[:, None], Ji * sel[:, None, None],
                                Jj * sel[:, None, None], K)
    outm = gram.preint_factor_gram_plain(state, data, adj & factors.preint_pair_mask(data))
    assert torch.equal(Hm, outm[0]) and torch.equal(bm, outm[1])


@pytest.mark.parametrize("kind", KINDS)
def test_closed_form_gram_matches_autodiff_gram(kind):
    """The plain version on the closed-form factors against the autodiff
    one, K=12, in units of each entry's Σ|term|."""
    state, data = window(12, kind)
    mask = factors.preint_pair_mask(data)
    H0, b0 = accumulators(12, 3)
    ref = gram.preint_factor_gram_plain(state, data, mask, H0, b0)
    out = gram.preint_factor_gram_plain(state, data, mask, H0, b0,
                                        jac=factors.preint_residual_jac_closed)
    assert term_ratio(out, ref, term_scales(state, data, mask, H0, b0)) <= 1e-10


def test_plain_batch_is_the_single_windows():
    """A batch (leading axis) through the plain version: each row within
    1e-13 of its Σ|term| of the single-window call (vmap's batched
    reductions may sum in another order)."""
    rows = [window(5, k) for k in KINDS]
    st = tree_map(lambda *xs: torch.stack(xs), *[r[0] for r in rows])
    dd = tree_map(lambda *xs: torch.stack(xs), *[r[1] for r in rows])
    mask = factors.preint_pair_mask(dd)
    acc = [accumulators(5, i) for i in range(4)]
    H0, b0 = torch.stack([a[0] for a in acc]), torch.stack([a[1] for a in acc])
    out = gram.preint_factor_gram_plain(st, dd, mask, H0, b0)
    assert [tuple(x.shape) for x in out] == [(4, 5, 15, 5, 15), (4, 5, 15), (4,)]
    for i, (s, d) in enumerate(rows):
        one = gram.preint_factor_gram_plain(s, d, mask[i], H0[i], b0[i])
        assert term_ratio([x[i] for x in out], one,
                          term_scales(s, d, mask[i], H0[i], b0[i])) <= 1e-13


def test_dispatch_on_cpu():
    """CPU tensors take the plain version and count no launch; the CUDA
    wrapper refuses them."""
    state, data = window(5, "extrinsics")
    mask = factors.preint_pair_mask(data)
    before = build.PREINT_GRAM.launches
    out = gram.preint_factor_gram(state, data, mask)
    assert build.PREINT_GRAM.launches == before
    ref = gram.preint_factor_gram_plain(state, data, mask)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        gram.preint_factor_gram_cuda(state, data, mask)


def test_solver_callers_take_k3_once(monkeypatch):
    """`assemble`, `assemble_batch` and `marginalize_frame` each call
    `gram.preint_factor_gram` once, `assemble` with the pair mask;
    `use_preint=False` never."""
    calls = []
    plain = gram.preint_factor_gram

    def counted(state, data, mask, H=None, b=None):
        calls.append((tuple(state.q.shape), mask.clone()))
        return plain(state, data, mask, H, b)

    monkeypatch.setattr(gram, "preint_factor_gram", counted)
    state, data = window(5, "extrinsics")
    opts = solver.SolveOptions()
    solver.assemble(state, data, opts)
    assert len(calls) == 1 and torch.equal(calls[0][1], factors.preint_pair_mask(data))
    solver.assemble(state, data, solver.SolveOptions(use_preint=False))
    assert len(calls) == 1
    st = tree_map(lambda *xs: torch.stack(xs), state, state)
    dd = tree_map(lambda *xs: torch.stack(xs), data, data)
    solver.assemble_batch(st, dd, opts)
    assert len(calls) == 2 and calls[1][0] == (2, 5, 4)
    marginalization.marginalize_frame(state, data, victim=2)
    want = torch.tensor([False, False, True, True, False]) & factors.preint_pair_mask(data)
    assert len(calls) == 3 and torch.equal(calls[2][1], want)


# ---- on the card -----------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", KS)
def test_card_matches_plain(dev, K, kind):
    """f64: K3 within 1e-12 of each entry's Σ|term| of the closed-form
    plain version and 1e-10 of the autodiff one; a repeat bit-equal; H
    exactly symmetric; one launch counted."""
    state, data = window(K, kind, device=dev)
    mask = factors.preint_pair_mask(data)
    H0, b0 = accumulators(K, K + 7, device=dev)
    before = build.PREINT_GRAM.launches
    out = gram.preint_factor_gram(state, data, mask, H0, b0)
    torch.cuda.synchronize()
    assert build.PREINT_GRAM.launches == before + 1
    scales = term_scales(state, data, mask, H0, b0)
    closed = gram.preint_factor_gram_plain(state, data, mask, H0, b0,
                                           jac=factors.preint_residual_jac_closed)
    assert term_ratio(out, closed, scales) <= 1e-12
    assert term_ratio(out, gram.preint_factor_gram_plain(state, data, mask, H0, b0),
                      scales) <= 1e-10
    H = out[0].reshape(K * 15, K * 15)
    assert torch.equal(H, H.T)
    again = gram.preint_factor_gram(state, data, mask, H0, b0)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(H0, accumulators(K, K + 7, device=dev)[0]), "H0 was written"


@pytest.mark.gpu
def test_card_float32(dev):
    """The float32 instantiation, K=12: as far from the float64 result,
    in units of Σ|term|, as 4x the float32 plain version at most."""
    s64, d64 = window(12, "extrinsics", device=dev)
    s32, d32 = window(12, "extrinsics", dtype=torch.float32, device=dev)
    mask = factors.preint_pair_mask(d64)
    H64, b64 = accumulators(12, 5, device=dev)
    H32, b32 = H64.float(), b64.float()
    exact = gram.preint_factor_gram_plain(s64, d64, mask, H64, b64,
                                          jac=factors.preint_residual_jac_closed)
    scales = term_scales(s64, d64, mask, H64, b64)
    k = term_ratio(gram.preint_factor_gram(s32, d32, mask, H32, b32), exact, scales)
    p = term_ratio(gram.preint_factor_gram_plain(s32, d32, mask, H32, b32,
                                                 jac=factors.preint_residual_jac_closed),
                   exact, scales)
    eps = torch.finfo(torch.float32).eps
    assert k <= 4 * max(p, eps), (k, p)


@pytest.mark.gpu
def test_card_batch_is_the_single_calls(dev):
    """N=4 windows in one launch, each row bit-equal to its single call."""
    rows = [window(12, k, device=dev) for k in KINDS]
    st = tree_map(lambda *xs: torch.stack(xs), *[r[0] for r in rows])
    dd = tree_map(lambda *xs: torch.stack(xs), *[r[1] for r in rows])
    mask = factors.preint_pair_mask(dd)
    acc = [accumulators(12, i, device=dev) for i in range(4)]
    H0, b0 = torch.stack([a[0] for a in acc]), torch.stack([a[1] for a in acc])
    before = dict(build.PREINT_GRAM.batched)
    out = gram.preint_factor_gram(st, dd, mask, H0, b0)
    assert build.PREINT_GRAM.batched["windows"] == before["windows"] + 4
    for i, (s, d) in enumerate(rows):
        one = gram.preint_factor_gram(s, d, mask[i], H0[i], b0[i])
        assert all(torch.equal(x[i], y) for x, y in zip(out, one))


@pytest.mark.gpu
@pytest.mark.parametrize("victim", [0, 4, 11])
def test_card_marginalization_mask(dev, victim):
    """The victim's pairs onto zeros (H and b None), as
    `marginalize_frame` calls K3, against the plain version; the
    marginalization launches K3 once."""
    state, data = window(12, "extrinsics", device=dev)
    adj = torch.zeros(12, dtype=torch.bool, device=dev)
    adj[victim] = victim >= 1
    if victim + 1 < 12:
        adj[victim + 1] = True
    mask = adj & factors.preint_pair_mask(data)
    out = gram.preint_factor_gram(state, data, mask)
    ref = gram.preint_factor_gram_plain(state, data, mask,
                                        jac=factors.preint_residual_jac_closed)
    zeros = (torch.zeros((12, 15, 12, 15), dtype=torch.float64, device=dev),
             torch.zeros((12, 15), dtype=torch.float64, device=dev))
    assert term_ratio(out, ref, term_scales(state, data, mask, *zeros)) <= 1e-12
    before = build.PREINT_GRAM.launches
    marginalization.marginalize_frame(state, data, victim=victim)
    assert build.PREINT_GRAM.launches == before + 1


@pytest.mark.gpu
def test_card_one_launch_per_assemble(dev):
    """`assemble` launches K3 once, `assemble_batch` once for its batch,
    a 10-iteration solve 11 times."""
    state, data = window(12, "extrinsics", device=dev)
    opts = solver.SolveOptions()
    build.reset_launch_counts()
    solver.assemble(state, data, opts)
    assert build.PREINT_GRAM.launches == 1
    st = tree_map(lambda *xs: torch.stack(xs), state, state)
    dd = tree_map(lambda *xs: torch.stack(xs), data, data)
    solver.assemble_batch(st, dd, opts)
    assert build.PREINT_GRAM.launches == 2
    assert build.PREINT_GRAM.batched == {"launches": 1, "windows": 2}
    solver.solve_window(state, data, opts)
    assert build.PREINT_GRAM.launches == 2 + opts.iterations + 1


@pytest.mark.gpu
def test_card_wrapper_raises(dev):
    """Wrong shape, dtype or device: a ValueError before the library."""
    state, data = window(5, "extrinsics", device=dev)
    mask = factors.preint_pair_mask(data)
    with pytest.raises(ValueError, match=r"state.v must be \(5, 3\)"):
        gram.preint_factor_gram_cuda(state._replace(v=state.v[:4]), data, mask)
    with pytest.raises(ValueError, match="preint.sqrt_inv_cov dtype"):
        gram.preint_factor_gram_cuda(state, data._replace(preint=data.preint._replace(
            sqrt_inv_cov=data.preint.sqrt_inv_cov.float())), mask)
    with pytest.raises(ValueError, match="float32/float64"):
        gram.preint_factor_gram_cuda(*window(5, "extrinsics", dtype=torch.float16,
                                             device=dev), mask)
    with pytest.raises(ValueError, match="data.bg_lin must be on"):
        gram.preint_factor_gram_cuda(state, data._replace(bg_lin=data.bg_lin.cpu()), mask)
    with pytest.raises(ValueError, match="mask dtype"):
        gram.preint_factor_gram_cuda(state, data, mask.double())
    with pytest.raises(ValueError, match=r"H must be \(5, 15, 5, 15\)"):
        gram.preint_factor_gram_cuda(state, data, mask,
                                     torch.zeros((4, 15, 4, 15), dtype=torch.float64,
                                                 device=dev))
