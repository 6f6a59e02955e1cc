"""Kernel K4, IMU preintegration in one launch a call
(`preintegration.integrate_batch`, csrc/preint_scan.cu).

On the CPU: `integrate_batch` takes the plain loop and counts no launch,
and its output is bit for bit that of a frozen copy of the loop as the
port ran it before K4 (`frozen_integrate_batch` below); every caller of
the port reaches `integrate_batch` once a call. On the card (marked
`gpu`, skipped without a CUDA device; this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_preint_scan.py -q

K4 against the plain loop in float64 at N in {1, 2, 11, 12, 48}
intervals, buffer capacities S in {64, 128, 192, 2048} and steps in {1,
11, 33, 44, 132}; repeats bit-equal; float32; a singular covariance; one
launch a call, in a drive too; the wrapper's refusals.

The buffers are those of `io.synthetic.imu_intervals`: 200 Hz samples on a
jittered clock, zero past each count, the intervals taking turns: count =
steps; count < steps (dt = 0 steps after it); count = 0 (sqrt_inv_cov
0); gyro rates whose rotation a step stays in the small-angle branches
of `lie.expmap` and `lie.right_jacobian`; count > steps at ~3 rad/s.

Tolerance, K4 against the loop in float64: 1e-13 of each entry's scale,
which is the largest |entry| of its field in its interval, and for the
covariance sqrt(|cov_ii cov_jj|), its Cauchy-Schwarz bound. An entry
whose scale is 0 must be 0. Only the order of the small products' sums
and the device's sin/cos differ, which read ~1e-15 at 132 steps.
"""

import collections

import pytest
import torch

from xrslam_tpu_torch.geometry import lie
from xrslam_tpu_torch.imu import preintegration as pre
from xrslam_tpu_torch.io.synthetic import imu_intervals, imu_noise
from xrslam_tpu_torch.kernels import build

FIELDS = pre.PreintDelta._fields
TOL = 1e-13


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes side
    by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the loop as the port ran it before K4 (frozen) --------------------------


def _frozen_increment(delta, dt, w_raw, a_raw, bg, ba, noise):
    w = w_raw - bg
    a = a_raw - ba
    dtc = dt[..., None, None]
    dq_step = lie.expmap(w * dt[..., None])
    R_delta = lie.quat_to_matrix(delta.q)
    R_step_T = lie.quat_to_matrix(dq_step).transpose(-1, -2)
    Rhat = R_delta @ lie.hat(a)
    eye3 = torch.eye(3, dtype=delta.cov.dtype, device=delta.cov.device)
    Jr = lie.right_jacobian(w * dt[..., None])

    B_ = dt.shape
    A = torch.zeros(B_ + (9, 9), dtype=delta.cov.dtype, device=dt.device)
    A[..., 0:3, 0:3] = R_step_T
    A[..., 3:6, 0:3] = -0.5 * dtc * dtc * Rhat
    A[..., 3:6, 3:6] = eye3
    A[..., 3:6, 6:9] = dtc * eye3
    A[..., 6:9, 0:3] = -dtc * Rhat
    A[..., 6:9, 6:9] = eye3

    Bm = torch.zeros(B_ + (9, 6), dtype=delta.cov.dtype, device=dt.device)
    Bm[..., 0:3, 0:3] = dtc * Jr
    Bm[..., 3:6, 3:6] = 0.5 * dtc * dtc * R_delta
    Bm[..., 6:9, 3:6] = dtc * R_delta

    inv_dt = (1.0 / torch.clamp(dt, min=1.0e-7))[..., None, None]
    W = torch.zeros(B_ + (6, 6), dtype=delta.cov.dtype, device=dt.device)
    W[..., 0:3, 0:3] = noise.cov_w * inv_dt
    W[..., 3:6, 3:6] = noise.cov_a * inv_dt

    At = A.transpose(-1, -2)
    cov = delta.cov.clone()
    cov[..., :9, :9] = A @ delta.cov[..., :9, :9] @ At \
        + Bm @ W @ Bm.transpose(-1, -2)
    cov[..., 9:12, 9:12] += noise.cov_bg * dtc
    cov[..., 12:15, 12:15] += noise.cov_ba * dtc

    dp_dbg = delta.dp_dbg + dtc * delta.dv_dbg \
        - 0.5 * dtc * dtc * Rhat @ delta.dq_dbg
    dp_dba = delta.dp_dba + dtc * delta.dv_dba - 0.5 * dtc * dtc * R_delta
    dv_dbg = delta.dv_dbg - dtc * Rhat @ delta.dq_dbg
    dv_dba = delta.dv_dba - dtc * R_delta
    dq_dbg = R_step_T @ delta.dq_dbg - dtc * Jr

    a_world = lie.quat_rotate(delta.q, a)
    dtv = dt[..., None]
    p = delta.p + dtv * delta.v + 0.5 * dtv * dtv * a_world
    v = delta.v + dtv * a_world
    q = lie.quat_normalize(lie.quat_mul(delta.q, dq_step))
    return delta._replace(t=delta.t + dt, q=q, p=p, v=v, cov=cov,
                          dq_dbg=dq_dbg, dp_dbg=dp_dbg, dp_dba=dp_dba,
                          dv_dbg=dv_dbg, dv_dba=dv_dba)


def _frozen_sample_dts(ts, t_end, count):
    n = ts.shape[-1]
    idx = torch.arange(n, device=ts.device)
    t_next = torch.cat([ts[..., 1:], ts[..., -1:]], dim=-1)
    count = torch.as_tensor(count, device=ts.device)[..., None]
    t_end = torch.as_tensor(t_end, dtype=ts.dtype, device=ts.device)[..., None]
    dts = torch.where(idx == count - 1, t_end - ts, t_next - ts)
    return torch.where(idx < count, torch.clamp(dts, min=0.0), 0.0)


def frozen_integrate_batch(ts, ws, accs, t_end, bg, ba, noise, count,
                           compute_sqrt_inv=True, steps=None):
    dts = _frozen_sample_dts(ts, t_end, count)
    if steps is None:
        steps = int(torch.as_tensor(count).max()) if ts.shape[-1] else 0
    delta = pre.PreintDelta.identity(ts.shape[:-1], dtype=ws.dtype, device=ws.device)
    for s in range(min(steps, ts.shape[-1])):
        delta = _frozen_increment(delta, dts[..., s], ws[..., s, :], accs[..., s, :],
                                  bg, ba, noise)
    if compute_sqrt_inv:
        ok = (torch.as_tensor(count, device=ws.device) > 0)[..., None, None]
        delta = delta._replace(sqrt_inv_cov=torch.where(
            ok, pre.sqrt_inv_from_cov(delta.cov), 0.0))
    return delta


def scale_ratio(out, ref) -> dict:
    """Each field's largest |out - ref| over its entry's scale (module
    docstring; inf where an entry of scale 0 is not 0), float64."""
    res = {}
    for name in FIELDS:
        if name == "sqrt_inv_cov":
            continue
        o, r = (getattr(x, name).detach().cpu().double() for x in (out, ref))
        if name == "cov":
            d = torch.diagonal(r, dim1=-2, dim2=-1).abs().sqrt()
            sc = d[..., :, None] * d[..., None, :]
        else:
            sc = r.reshape(r.shape[:1] + (-1,)).abs().amax(-1)
            sc = sc.reshape(sc.shape + (1,) * (r.dim() - 1)).expand_as(r)
        err = (o - r).abs()
        res[name] = float(torch.where(sc > 0, err / sc.clamp_min(1e-300),
                                      torch.where(err > 0, float("inf"), 0.0)).max())
    return res


# ---- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("N,S,steps", [(1, 64, 1), (2, 64, 11), (11, 128, 33),
                                       (12, 192, 44), (12, 192, 132)])
def test_cpu_takes_the_frozen_loop(N, S, steps):
    """CPU tensors take the plain loop, bit for bit the former one, with
    and without the square-root information and with `steps` read from
    `count`; no launch is counted."""
    args = imu_intervals(N, S, steps, seed=N * 1000 + steps)
    noise = imu_noise(N)
    before = build.PREINT_SCAN.launches
    for kw in (dict(steps=steps), dict(steps=steps, compute_sqrt_inv=False), {}):
        out = pre.integrate_batch(*args[:6], noise, args[6], **kw)
        ref = frozen_integrate_batch(*args[:6], noise, args[6], **kw)
        for name in FIELDS:   # NaN where the covariance is singular (one step)
            torch.testing.assert_close(getattr(out, name), getattr(ref, name), rtol=0,
                                       atol=0, equal_nan=True, msg=f"{kw} {name}")
    assert build.PREINT_SCAN.launches == before


def test_cuda_entry_refuses_cpu_tensors():
    args = imu_intervals(2, 64, 11, seed=1)
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        pre.integrate_batch_cuda(*args[:6], imu_noise(), args[6], steps=11)


CALLERS = ("extract_window", "slide_window", "_inject_solved", "_stage_prediction",
           "_preintegrate")


def test_callers_reach_integrate_batch_once(monkeypatch):
    """A 40-frame bearing drive of the two-frame schedule on the CPU,
    then one PARSAC prediction: every `integrate_batch` call comes from
    one of `CALLERS`, each call of `extract_window` and
    `Initializer._preintegrate` makes one, `_inject_solved` and
    `_stage_prediction` at most one (none without samples or frames to
    re-linearize), and `slide_window` one per frame it marginalizes
    (through its re-integration or an extraction)."""
    from xrslam_tpu_torch.core import initializer, sliding_window as sw
    from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
    from xrslam_tpu_torch.tools import object_scene as osc

    scene = osc.object_scene(n_frames=40)   # its own preintegrations: before the count
    active, done, strays = [], [], []
    plain = pre.integrate_batch

    def counted(*a, **k):
        if active:
            active[-1]["integrate"] += 1
        else:
            strays.append(1)
        return plain(*a, **k)

    def wrap(owner, name, key=None):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            if key is not None:     # counted in the caller that is running
                if active:
                    active[-1][key] += 1
                return fn(*a, **k)
            if name == "extract_window" and active:
                active[-1]["extract"] += 1
            active.append({"caller": name, "integrate": 0, "extract": 0, "marg": 0})
            try:
                return fn(*a, **k)
            finally:
                done.append(active.pop())

        monkeypatch.setattr(owner, name, wrapped)

    monkeypatch.setattr(pre, "integrate_batch", counted)
    for owner, name in ((sw, "extract_window"), (initializer, "extract_window"),
                        (sw.SlidingWindowTracker, "slide_window"),
                        (sw.SlidingWindowTracker, "_inject_solved"),
                        (sw.SlidingWindowTracker, "_stage_prediction"),
                        (initializer.Initializer, "_preintegrate")):
        wrap(owner, name)
    wrap(sw, "marginalize_frame", key="marg")

    cfg = osc.object_config(scene, worker_overlap=True, pipelined_writeback=True)
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    osc.drive(pipe, scene)
    frames = list(pipe.swt.map.frames)
    pipe.swt._stage_prediction(frames[-2], frames[-1])

    assert not strays, f"{len(strays)} integrate_batch calls from no known caller"
    by = collections.defaultdict(list)
    for c in done:
        by[c["caller"]].append(c)
    assert set(by) == set(CALLERS), set(by)
    for name, cs in by.items():
        n = [c["integrate"] for c in cs]
        if name in ("extract_window", "_preintegrate"):
            assert set(n) == {1}, (name, collections.Counter(n))
        elif name == "slide_window":
            assert all(c["integrate"] + c["extract"] == c["marg"] for c in cs), cs
            assert sum(c["marg"] for c in cs) > 0
        else:
            assert set(n) <= {0, 1} and 1 in n, (name, collections.Counter(n))


# ---- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_pair(dev, N, S, steps, seed=0, dtype=torch.float64, **kw):
    args = imu_intervals(N, S, steps, seed, dtype=dtype, device=dev)
    noise = imu_noise(seed, dtype=dtype, device=dev)
    out = pre.integrate_batch(*args[:6], noise, args[6], steps=steps, **kw)
    ref = pre.integrate_batch_plain(*args[:6], noise, args[6], steps=steps, **kw)
    return out, ref, args


def check_sqrt_inv(out, count):
    """sqrt_inv_cov: 0 where count is 0, else the PyTorch factor of the
    kernel's covariance (within 1e-12 of its largest entry: the factor
    may take another path for another alignment of its input), NaN
    where that covariance is singular."""
    want = torch.where((count > 0)[..., None, None], pre.sqrt_inv_from_cov(out.cov), 0.0)
    assert bool((out.sqrt_inv_cov[count == 0] == 0).all())
    ok = torch.isfinite(want).flatten(1).all(1)
    assert torch.equal(torch.isfinite(out.sqrt_inv_cov).flatten(1).all(1), ok)
    err = (out.sqrt_inv_cov - want)[ok].abs().amax((-2, -1))
    assert bool((err <= 1e-12 * want[ok].abs().amax((-2, -1))).all()), err


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 11, 33, 44, 132])
@pytest.mark.parametrize("N", [1, 2, 11, 12, 48])
def test_card_matches_plain(dev, N, steps):
    """S = 192: every field within 1e-13 of its entry's scale."""
    out, ref, args = card_pair(dev, N, 192, steps, seed=N + steps)
    ratio = scale_ratio(out, ref)
    assert max(ratio.values()) <= TOL, ratio
    check_sqrt_inv(out, args[6])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 128, 192, 2048])
def test_card_capacities(dev, S):
    """N = 12 at each bucket capacity, steps = min(S, 132)."""
    out, ref, args = card_pair(dev, 12, S, min(S, 132), seed=S)
    ratio = scale_ratio(out, ref)
    assert max(ratio.values()) <= TOL, ratio
    check_sqrt_inv(out, args[6])


@pytest.mark.gpu
def test_card_repeat_and_one_launch(dev):
    """Two calls on the same inputs: bit-equal, one launch each, N
    intervals counted as served."""
    args = imu_intervals(12, 192, 132, seed=3, device=dev)
    noise = imu_noise(3, device=dev)
    before, served = build.PREINT_SCAN.launches, build.PREINT_SCAN.batched["windows"]
    a = pre.integrate_batch(*args[:6], noise, args[6], steps=132)
    b = pre.integrate_batch(*args[:6], noise, args[6], steps=132)
    torch.cuda.synchronize()
    assert build.PREINT_SCAN.launches == before + 2
    assert build.PREINT_SCAN.batched["windows"] == served + 24
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    one = pre.integrate(args[0][0], args[1][0], args[2][0], args[3][0], args[4][0],
                        args[5][0], noise, count=int(args[6][0]))
    assert build.PREINT_SCAN.launches == before + 3
    assert max(scale_ratio(pre.PreintDelta(*(x[None] for x in one)),
                           pre.PreintDelta(*(x[:1] for x in a))).values()) <= TOL


@pytest.mark.gpu
def test_card_float32(dev):
    """float32, N=12, 132 steps: in units of each entry's scale, K4 is
    as far from the float64 loop as 4x the float32 loop at most."""
    exact = card_pair(dev, 12, 192, 132, seed=5)[1]
    out, ref, _ = card_pair(dev, 12, 192, 132, seed=5, dtype=torch.float32,
                            compute_sqrt_inv=False)
    k, p = scale_ratio(out, exact), scale_ratio(ref, exact)
    eps = torch.finfo(torch.float32).eps
    assert max(k.values()) <= 4 * max(max(p.values()), eps), (k, p)


@pytest.mark.gpu
def test_card_singular_covariance(dev):
    """Zero noise: every covariance is 0, so sqrt_inv_cov is non-finite
    where count > 0, as the loop's, and 0 where count is 0."""
    args = imu_intervals(5, 64, 44, seed=7, device=dev)
    noise = imu_noise(device=dev, scale=0.0)
    out = pre.integrate_batch(*args[:6], noise, args[6], steps=44)
    ref = pre.integrate_batch_plain(*args[:6], noise, args[6], steps=44)
    live = args[6] > 0
    for d in (out, ref):
        bad = ~torch.isfinite(d.sqrt_inv_cov).flatten(1).all(1)
        assert torch.equal(bad, live)
        assert bool((d.sqrt_inv_cov[~live] == 0).all())
    assert bool((out.cov == 0).all())


@pytest.mark.gpu
def test_card_drive_launches_once_per_call(dev, monkeypatch):
    """A 40-frame bearing drive of the two-frame schedule on the card:
    K4 launches as often as `integrate_batch` is called, and the plain
    loop never runs."""
    from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
    from xrslam_tpu_torch.tools import object_scene as osc

    scene = osc.object_scene(n_frames=40)
    calls, plain_calls = [0], [0]
    fn, plain = pre.integrate_batch, pre.integrate_batch_plain

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    def counted_plain(*a, **k):
        plain_calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(pre, "integrate_batch", counted)
    monkeypatch.setattr(pre, "integrate_batch_plain", counted_plain)
    cfg = osc.object_config(scene, worker_overlap=True, pipelined_writeback=True)
    pipe = VIOPipeline(cfg, SyntheticTracker(device=dev), device=dev)
    build.reset_launch_counts()
    osc.drive(pipe, scene)
    pipe.flush()
    assert calls[0] > 50 and plain_calls[0] == 0
    assert build.PREINT_SCAN.launches == calls[0]


@pytest.mark.gpu
def test_card_wrapper_raises(dev):
    """Wrong dtype, shape or device: a ValueError before the library."""
    args = list(imu_intervals(3, 64, 11, seed=9, device=dev))
    noise = imu_noise(device=dev)

    def call(a=None, nz=noise):
        a = args if a is None else a
        return pre.integrate_batch_cuda(*a[:6], nz, a[6], steps=11)

    def swap(i, x):
        return args[:i] + [x] + args[i + 1:]

    with pytest.raises(ValueError, match="float32/float64"):
        pre.integrate_batch_cuda(*(x.half() for x in args[:6]), noise, args[6])
    with pytest.raises(ValueError, match=r"ws must be \(3, 64, 3\)"):
        call(swap(1, args[1][:, :32]))
    with pytest.raises(ValueError, match="t_end dtype"):
        call(swap(3, args[3].float()))
    with pytest.raises(ValueError, match="count dtype"):
        call(swap(6, args[6].int()))
    with pytest.raises(ValueError, match="bg must be on"):
        call(swap(4, args[4].cpu()))
    with pytest.raises(ValueError, match="noise.cov_a must be on"):
        call(nz=noise._replace(cov_a=noise.cov_a.cpu()))
