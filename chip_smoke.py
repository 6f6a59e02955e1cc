"""Smoke run of the PyTorch/CUDA port (`xrslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--out FILE.json]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from `xrslam_tpu_torch/csrc` (nvcc);
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes, times both with CUDA events, and computes
   each kernel's bound (the larger of its bytes over 3.35 TB/s and its
   operations over the card's peak rate for their type, both counted
   as what this run's data needs):
   - K1 klt_level, entry 1 (`klt.track_level`, one level): a rendered
     752x480 frame pair, 256 GFTT points, the 4 forward levels and the
     level-0 backward pass; status equal on >= 99% of slots, positions
     within 1e-3 px on live slots;
   - K1, entry 2 (`klt.track_keypoints_cuda`, the main path's: the whole
     forward + backward KLT of the pair in one launch) against
     `track_keypoints_plain` on the same pair, with the same limits; two
     launches bit-equal; timed beside the plain version and the
     five-launch chain of entry 1 with its image-wide Scharr calls; the
     longest chain of LK steps one point took and, from a second launch
     at iters=1, the time of one step alone and the latency floor
     (longest chain x one step);
   - K2 reproj_gram, entry 1 (`gram.reproj_gram`): K=12, L=384, seeded
     inputs with a valid anchor one-hot and ~1/4 of the landmarks
     masked; rtol/atol 1e-9 in float64 and 1e-4 in float32 (summation
     order only); K=32, L=2048 in float64 at 1e-9; two launches
     bit-equal;
   - K2, entry 2 (`gram.reproj_factor_gram`, the one `solver.assemble`
     takes): a seeded K=12, L=384 window (`io.synthetic.reproj_window`:
     ~1/4 of the landmarks masked, a few fixed, ~15% of the
     observations missing) against `reproj_factor_gram_plain` and
     against the autodiff composition (`reproj_residual_jac` +
     `cauchy_weights` + `reproj_gram_plain`), both rtol/atol 1e-9 in
     float64; in float32 the kernel and the plain version are each held
     against the float64 plain result, entry by entry in units of
     eps * sum|term|, and the kernel may be at most 4x as far off as the
     plain version; two launches bit-equal; landmarks at inverse depth 0
     (the 1e-12 guard) within 1e-3 of their largest entry;
4. drives the main path — a rendered 120-frame wave scene at EuRoC
   geometry (752x480, focal 458, 500 landmarks, seed 3) through
   `api.XRSLAM` with IMU and images — once to warm up (40 frames), then
   timed with the kernel launch counts reset just before it; fails
   unless both kernels launched, the fused K2 entry among them, K1's
   fused entry once per tracked frame pair and its entry 1 never, no
   image-wide Scharr call, >= 60 frames tracked and ATE <= 0.25 m.

The second-to-last lines are a JSON object {"kernels": [...]} and the
nvidia-smi line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line. Needs a CUDA device and
the repository around this file; imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 120  # the JAX records' bench scene length
WARM_FRAMES = 40

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
# device memory rate, float32 outside the tensor cores, and float64
# outside the tensor cores (half the float32 rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 33.5e12}

# Operations per observation, counted from the kernels' arithmetic:
# the Gram stage adds (21 + 6) entries of 4 operations, the 6 + 2
# landmark entries of 3, for every observation, and (36 + 21 + 6)
# entries of 4 plus 6 of 4 for those of an unmasked landmark; the
# factor stage is 10 quaternion rotations of 30, the tangent basis,
# the projection, its two derivative rows and the Cauchy weight.
GRAM_FLOPS_ALL = 27 * 4 + 8 * 3
GRAM_FLOPS_ANCHORED = 63 * 4 + 6 * 4
FACTOR_FLOPS = 490
# K1: a bilinear tap (7), the difference and two multiply-adds (5) per
# window pixel and LK step; three sampled windows per point up front
# (7 each). The fused entry also filters each pass's (win+1)^2 sample
# block: per pixel, x: three column smoothings (5) and a difference, y:
# three row differences and a smoothing (5).
KLT_FLOPS_PER_TAP = 12
KLT_WINDOW_FLOPS = 21
KLT_SCHARR_FLOPS = 24
# The float32 fused kernel may be this many times as far from the
# float64 result as the float32 plain version is (both in units of
# eps * sum|term|, `gram.rounding_ratios`): another summation order.
F32_ROUNDING_FACTOR = 4.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Milliseconds per call of fn() with the host taken out: `calls`
    calls captured into a CUDA graph, replayed `reps` times. A wrapper
    that allocates or synchronises inside its C call, or launches off
    the current stream, cannot be captured, and the run fails."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
    except RuntimeError as e:
        fail(f"CUDA-graph capture of a kernel wrapper was refused: {e}")
    return cuda_ms(g.replay, reps=reps) / calls


def bound(n_bytes: float, flops: float, itemsize: int) -> dict:
    """The least time the card could take: bytes over the memory rate
    against operations over the peak rate of their type."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[itemsize] * 1e3
    return {"bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f
            else "operations", "bytes": n_bytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(what: str, names, ref, out, tol: float) -> float:
    """Fail unless |out - ref| <= tol + tol*|ref| elementwise. Returns
    the largest |out - ref|."""
    err = 0.0
    for n, a, b in zip(names, ref, out):
        if a.shape != b.shape:
            fail(f"{what} {n}: shape {tuple(b.shape)} != {tuple(a.shape)}")
        if a.numel() == 0:
            continue
        d = (b - a).abs()
        err = max(err, float(d.max()))
        if not bool((d <= tol + tol * a.abs()).all()):
            fail(f"{what} {n} disagrees: max |Δ| {float(d.max()):.3e}, "
                 f"max |ref| {float(a.abs().max()):.3e}")
    return err


@contextlib.contextmanager
def counting(module, name: str):
    """Counts the calls of `module.name` while the block runs."""
    fn = getattr(module, name)
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def check_repeat(what: str, fn) -> None:
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{what}: two launches on the same inputs differ")


def klt_phase(dev) -> dict:
    """K1 against its plain version on a rendered EuRoC-geometry pair."""
    import torch

    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.frontend.tracker import _preprocess_image
    from xrslam_tpu_torch.tools.make_dataset import render_sequence

    seq = render_sequence(n_frames=2, width=752, height=480, focal=458.0)
    pyrs = [_preprocess_image(torch.from_numpy(im).to(dev), 6.0, 8, 8, 3)
            for im in seq["images"]]
    cand, _, ok = img_ops.gftt_candidates(pyrs[0][0], max_candidates=256)
    pts = cand.contiguous()
    rng = np.random.default_rng(0)
    init = pts + torch.as_tensor(rng.normal(0, 1.5, tuple(pts.shape)),
                                 dtype=torch.float32, device=dev)
    # the 5 calls of one frame (4 forward levels, level-0 backward),
    # each from the plain chain's inputs
    calls = []
    guess, v = init / 8.0, ok
    for lev in (3, 2, 1, 0):
        s = float(2 ** lev)
        ix, iy = img_ops.scharr(pyrs[0][lev])
        args = (pyrs[0][lev], ix, iy, pyrs[1][lev], pts / s, guess, v)
        kw = dict(win=21, iters=30, eps=0.01, final=(lev == 0),
                  search=64 if lev == 3 else 32)
        calls.append((args, kw))
        g, v, _ = klt.track_level_plain(*args, **kw)
        guess = g * (2.0 if lev > 0 else 1.0)
    ix, iy = img_ops.scharr(pyrs[1][0])
    calls.append(((pyrs[1][0], ix, iy, pyrs[0][0], guess, pts, v),
                  dict(win=21, iters=30, eps=0.01, final=True, search=32)))

    worst_agree, max_err, steps = 1.0, 0.0, []
    for args, kw in calls:
        ref = klt.track_level_plain(*args, **kw)
        n_steps = torch.empty(pts.shape[0], dtype=torch.int32, device=dev)
        out = klt.track_level_cuda(*args, **kw, steps_out=n_steps)
        torch.cuda.synchronize()
        steps.append(int(n_steps.sum()))
        agree = float((out[1] == ref[1]).float().mean())
        live = out[1] & ref[1]
        err = float((out[0] - ref[0]).abs()[live].max()) if bool(live.any()) else 0.0
        worst_agree = min(worst_agree, agree)
        max_err = max(max_err, err)
    print(f"K1 klt_level: status agreement >= {worst_agree:.4f} (limit 0.99), "
          f"max |Δpos| on live slots {max_err:.3e} px (limit 1e-3)", flush=True)
    if worst_agree < 0.99 or max_err > 1e-3:
        fail("K1 disagrees with its plain version")

    def run(fn):
        return lambda: [fn(*a, **k) for a, k in calls]

    plain_ms = cuda_ms(run(klt.track_level_plain), reps=5)
    ms = cuda_ms(run(klt.track_level_cuda))
    plain_ms2 = cuda_ms(run(klt.track_level_plain), reps=5)
    ms2 = cuda_ms(run(klt.track_level_cuda))
    print(f"K1 time per frame (5 launches, 256 points): kernel {ms:.4f} / "
          f"{ms2:.4f} ms, plain {plain_ms:.4f} / {plain_ms2:.4f} ms", flush=True)
    # bound of the 5 calls. Bytes: what the function needs, so per image
    # the smaller of the whole image and the points' windows (the three
    # (win+1)^2 blocks of the previous image and its gradients, the
    # search^2 block of the next image), plus points, guesses, validity
    # and the outputs. Operations: at the LK steps this run's points took
    # (the kernel reports them), not at the 30-step ceiling.
    n_pts = pts.shape[0]
    moved = flops = 0
    for (a, k), n_steps in zip(calls, steps):
        img_bytes = nbytes(a[0])
        moved += 3 * min(img_bytes, n_pts * (k["win"] + 1) ** 2 * 4)
        moved += min(img_bytes, n_pts * k["search"] ** 2 * 4)
        moved += nbytes(*a[4:]) + n_pts * (2 * 4 + 1 + 4)
        flops += k["win"] ** 2 * (n_steps * KLT_FLOPS_PER_TAP + n_pts * KLT_WINDOW_FLOPS)
    bnd = bound(moved, flops, 4)
    print(f"K1 bound: {bnd['bound_ms'] * 1e3:.2f} us by {bnd['bound_by']} "
          f"({moved / 1e6:.2f} MB; {flops / 1e9:.4f} GFLOP at the "
          f"{sum(steps)} LK steps taken, {sum(steps) / (len(calls) * n_pts):.2f} "
          f"per point and launch of at most 30)", flush=True)
    return {"max_abs_err": max_err, "ms": (ms + ms2) / 2,
            "plain_ms": (plain_ms + plain_ms2) / 2, "status_agreement": worst_agree,
            "lk_steps": steps, **bnd}


def klt_track_phase(dev, width: int = 752, height: int = 480,
                    focal: float = 458.0) -> dict:
    """K1's fused entry against `track_keypoints_plain` on a rendered
    frame pair, 256 GFTT points with perturbed seeds."""
    import torch

    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.frontend.tracker import _preprocess_image
    from xrslam_tpu_torch.tools.make_dataset import render_sequence

    seq = render_sequence(n_frames=2, width=width, height=height, focal=focal)
    pyrs = [_preprocess_image(torch.from_numpy(im).to(dev), 6.0, 8, 8, 3)
            for im in seq["images"]]
    cand, _, ok = img_ops.gftt_candidates(pyrs[0][0], max_candidates=256)
    pts = cand.contiguous()
    rng = np.random.default_rng(0)
    init = pts + torch.as_tensor(rng.normal(0, 1.5, tuple(pts.shape)),
                                 dtype=torch.float32, device=dev)
    args = (pyrs[0], pyrs[1], pts, init, ok)
    win, iters, levels, n_pts = 21, 30, len(pyrs[0]), pts.shape[0]

    ref = klt.track_keypoints_plain(*args)
    steps = torch.zeros((n_pts, levels + 1), dtype=torch.int32, device=dev)
    out = klt.track_keypoints_cuda(*args, steps_out=steps)
    torch.cuda.synchronize()
    agree = float((out[1] == ref[1]).float().mean())
    live = out[1] & ref[1]
    err = float((out[0] - ref[0]).abs()[live].max()) if bool(live.any()) else 0.0
    check_repeat("K1 fused entry", lambda: klt.track_keypoints_cuda(*args))
    print(f"K1 klt_track (fused) {width}x{height}: status agreement {agree:.4f} "
          f"(limit 0.99), {int(live.sum())} live on both, max |Δpos| {err:.3e} px "
          f"(limit 1e-3), repeat bit-equal", flush=True)
    if agree < 0.99 or err > 1e-3:
        fail("K1's fused entry disagrees with track_keypoints_plain")
    if bool((steps[~ok] != 0).any()) or bool((steps < 0).any()) \
            or bool((steps > iters).any()):
        fail("K1's fused entry: LK steps out of [0, iters], or on a dead slot")

    def fused():
        return klt.track_keypoints_cuda(*args)

    def plain():
        return klt.track_keypoints_plain(*args)

    def chain():  # entry 1 per level and pass, with image-wide Scharr
        return klt.track_keypoints_plain(*args, level_fn=klt.track_level_cuda)

    p1, c1 = cuda_ms(plain, reps=5), cuda_ms(chain)
    k1, k2 = cuda_ms(fused, reps=100), cuda_ms(fused, reps=100)
    c2, p2 = cuda_ms(chain), cuda_ms(plain, reps=5)
    res = {"max_abs_err": err, "status_agreement": agree, "live": int(live.sum()),
           "ms": (k1 + k2) / 2, "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2,
           "plain_ms_runs": [p1, p2], "chain_ms": (c1 + c2) / 2,
           "chain_ms_runs": [c1, c2], "device_ms": device_ms(fused),
           "device_ms_iters_1": device_ms(lambda: klt.track_keypoints_cuda(*args, iters=1)),
           "chain_device_ms": device_ms(chain)}
    # a launch lasts about its longest chain of LK steps plus each pass's
    # loads and windows; at iters=1 every pass takes one step at most, so
    # the two launches' difference over their chains' is one step alone
    steps_1 = torch.zeros_like(steps)
    klt.track_keypoints_cuda(*args, iters=1, steps_out=steps_1)
    torch.cuda.synchronize()
    chain_1 = int(steps_1.sum(1).max()) if n_pts else 0

    # bound. Bytes: each input read once, as much of it as the function
    # needs: per image the smaller of the image and the blocks read from
    # it (a (win+3)^2 block of the previous image per pass, a search^2
    # block of the next; the backward pass reads level 0 of each the
    # other way round), plus points, validity and the outputs.
    # Operations: at the LK steps this run's points took, plus each
    # pass's Scharr and windows.
    n_fwd = int(ok.sum())
    n_bwd = int((steps[:, -1] > 0).sum())
    blk = (win + 3) ** 2 * 4
    moved = nbytes(pts, init, ok) + n_pts * (2 * 4 + 1)
    for lev in range(levels):
        search = klt.SEARCH if lev == levels - 1 else klt.SEARCH_LO
        prev_need = n_fwd * blk + (n_bwd * klt.SEARCH_LO ** 2 * 4 if lev == 0 else 0)
        next_need = n_fwd * search ** 2 * 4 + (n_bwd * blk if lev == 0 else 0)
        moved += min(nbytes(pyrs[0][lev]), prev_need) + min(nbytes(pyrs[1][lev]), next_need)
    n_steps = int(steps.sum())
    passes = n_fwd * levels + n_bwd
    flops = (win ** 2 * (n_steps * KLT_FLOPS_PER_TAP + passes * KLT_WINDOW_FLOPS)
             + passes * (win + 1) ** 2 * KLT_SCHARR_FLOPS)
    res.update(bound(moved, flops, 4))
    res["lk_steps"] = n_steps
    res["lk_steps_per_pass"] = [int(x) for x in steps.sum(0)]
    res["longest_chain"] = int(steps.sum(1).max()) if n_pts else 0
    res["us_per_step"] = res["latency_floor_us"] = None
    if res["longest_chain"] > chain_1:
        res["us_per_step"] = ((res["device_ms"] - res["device_ms_iters_1"]) * 1e3
                              / (res["longest_chain"] - chain_1))
        res["latency_floor_us"] = res["longest_chain"] * res["us_per_step"]
    print(f"K1 klt_track per frame pair: kernel {res['ms']:.4f} ms with the wrapper "
          f"({k1:.4f} / {k2:.4f}), {res['device_ms']:.4f} ms on the device alone; "
          f"five-launch chain of entry 1 with its Scharr calls {res['chain_ms']:.4f} ms "
          f"({c1:.4f} / {c2:.4f}), {res['chain_device_ms']:.4f} ms on the device; "
          f"plain {res['plain_ms']:.4f} ms ({p1:.4f} / {p2:.4f})", flush=True)
    print(f"K1 klt_track bound: {res['bound_ms'] * 1e3:.2f} us by {res['bound_by']} "
          f"({moved / 1e6:.2f} MB; {flops / 1e9:.4f} GFLOP at the {n_steps} LK steps "
          f"taken, by pass {res['lk_steps_per_pass']}); longest chain "
          f"{res['longest_chain']} steps at {res['us_per_step']} us a step alone "
          f"(at iters=1 {res['device_ms_iters_1']:.4f} ms for a chain of {chain_1}): "
          f"latency floor {res['latency_floor_us']} us", flush=True)
    return res


GRAM_NAMES = ["P", "b6", "Hll", "Hfl6", "bl"]


def gram_inputs(K: int, L: int, seed: int, dt, dev):
    """Seeded entry-1 inputs with a valid anchor one-hot and ~1/4 of
    the landmarks masked."""
    import torch

    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=L) > 0.25
    R1 = np.eye(K)[rng.integers(0, K, L)] * mask[:, None]
    host = [rng.normal(0, 0.1, (K, L, 2)), rng.normal(0, 0.1, (K, L, 2, 6)),
            rng.normal(0, 0.1, (K, L, 2, 6)), rng.normal(0, 0.1, (K, L, 2)), R1]
    return [torch.as_tensor(a, dtype=dt, device=dev) for a in host], int(mask.sum())


def timed_pair(kernel_fn, plain_fn) -> dict:
    """plain, kernel, kernel, plain (CUDA events around 20 calls each),
    and the kernel with the host taken out."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn, reps=100)
    k2 = cuda_ms(kernel_fn, reps=100)
    p2 = cuda_ms(plain_fn)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "device_ms": device_ms(kernel_fn)}


def gram_phase(dev) -> dict:
    """K2 entry 1 against its plain version at K=12, L=384 (float64 and
    float32) and at K=32, L=2048 (float64)."""
    import torch

    from xrslam_tpu_torch.estimation import gram

    res = {}
    for K, L, dt, tol in ((12, 384, torch.float64, 1e-9),
                          (12, 384, torch.float32, 1e-4),
                          (32, 2048, torch.float64, 1e-9)):
        xs, n_ok = gram_inputs(K, L, 1, dt, dev)
        ref = gram.reproj_gram_plain(*xs)
        out = gram.reproj_gram_cuda(*xs)
        torch.cuda.synchronize()
        tag = f"K={K} L={L} {str(dt)[6:]}"
        err = check_close(f"K2 entry 1 {tag}", GRAM_NAMES, ref, out, tol)
        check_repeat(f"K2 entry 1 {tag}", lambda: gram.reproj_gram_cuda(*xs))
        print(f"K2 reproj_gram {tag}: max |Δ| {err:.3e} (rtol/atol {tol:g}), "
              f"repeat bit-equal, grid {gram.grid(K, L)}", flush=True)
        one = {"max_abs_err": err, "grid": gram.grid(K, L)}
        if dt == torch.float64:
            one.update(timed_pair(lambda: gram.reproj_gram_cuda(*xs),
                                  lambda: gram.reproj_gram_plain(*xs)))
            one.update(bound(nbytes(*xs, *out),
                             K * L * GRAM_FLOPS_ALL + K * n_ok * GRAM_FLOPS_ANCHORED,
                             xs[0].element_size()))
            print(f"K2 reproj_gram {tag} per call: kernel {one['ms']:.4f} ms "
                  f"(device alone {one['device_ms']}), plain {one['plain_ms']:.4f} ms, "
                  f"bound {one['bound_ms'] * 1e3:.3f} us by {one['bound_by']}",
                  flush=True)
        res[tag] = one
    return res


def factor_gram_phase(dev) -> dict:
    """K2 entry 2 (the fused entry) at the main path's K=12, L=384
    against its plain version and the autodiff composition."""
    import torch

    from xrslam_tpu_torch.estimation import factors, gram
    from xrslam_tpu_torch.io.synthetic import reproj_window

    def autodiff(state, data):
        return gram.reproj_factor_gram_plain(state, data,
                                             jac=factors.reproj_residual_jac)

    K, L = 12, 384
    names = GRAM_NAMES + ["cost"]
    res = {"grid": gram.grid(K, L)}
    for dt in (torch.float64, torch.float32):
        state, data = reproj_window(K, L, seed=2, dtype=dt, device=dev)
        out = gram.reproj_factor_gram_cuda(state, data)
        plain = gram.reproj_factor_gram_plain(state, data)
        torch.cuda.synchronize()
        tag = str(dt)[6:]
        check_repeat(f"K2 entry 2 {tag}",
                     lambda: gram.reproj_factor_gram_cuda(state, data))
        if dt == torch.float32:
            # float32: kernel and plain version each against the float64
            # plain result, in units of eps * sum|term| per entry
            rk = gram.rounding_ratios(out, state, data)
            rp = gram.rounding_ratios(plain, state, data)
            res["rounding_f32"] = {n: {"kernel": a, "plain": b}
                                   for n, a, b in zip(names, rk, rp)}
            print("K2 reproj_factor_gram float32, largest |out - f64| / (eps * "
                  "sum|term|) per output, kernel / plain: " + ", ".join(
                      f"{n} {a:.2f} / {b:.2f}" for n, a, b in zip(names, rk, rp))
                  + f" (limit {F32_ROUNDING_FACTOR:g} x max(plain, 1)), repeat "
                  "bit-equal", flush=True)
            for n, a, b in zip(names, rk, rp):
                if not a <= F32_ROUNDING_FACTOR * max(b, 1.0):
                    fail(f"K2 entry 2 float32 {n}: rounding ratio {a:.3g} against "
                         f"the plain version's {b:.3g}")
            continue
        res["max_abs_err"] = check_close("K2 entry 2 float64 vs plain", names,
                                         plain, out, 1e-9)
        res["max_abs_err_autodiff"] = check_close(
            "K2 entry 2 float64 vs autodiff", names, autodiff(state, data), out, 1e-9)
        m = factors._active_mask(data)
        res["active_observations"] = int(m.sum())
        res["largest_entry"] = float(plain[0].abs().max())
        print(f"K2 reproj_factor_gram float64: max |Δ| {res['max_abs_err']:.3e} vs "
              f"plain, {res['max_abs_err_autodiff']:.3e} vs autodiff (rtol/atol "
              f"1e-9; largest entry {res['largest_entry']:.3e}), repeat bit-equal, "
              f"{res['active_observations']} active observations, grid "
              f"{res['grid']} CTAs of 128 threads", flush=True)
        res.update(timed_pair(lambda: gram.reproj_factor_gram_cuda(state, data),
                              lambda: gram.reproj_factor_gram_plain(state, data)))
        a1 = cuda_ms(lambda: autodiff(state, data), reps=5)
        a2 = cuda_ms(lambda: autodiff(state, data), reps=5)
        res["autodiff_ms"] = (a1 + a2) / 2
        ins = (state.q, state.p, state.inv_depth, data.q_bc, data.p_bc,
               data.bearings, data.obs_mask, data.ref_idx, data.sqrt_inv_cov2,
               data.landmark_mask)
        n_act = res["active_observations"]
        res.update(bound(nbytes(*ins, *out),
                         n_act * (FACTOR_FLOPS + GRAM_FLOPS_ALL + GRAM_FLOPS_ANCHORED)
                         + (K * L - n_act) * 8 * 3, state.p.element_size()))
        print(f"K2 reproj_factor_gram per call (K=12, L=384, f64): kernel "
              f"{res['ms']:.4f} ms (device alone {res['device_ms']}), plain "
              f"{res['plain_ms']:.4f} ms, autodiff composition "
              f"{res['autodiff_ms']:.4f} ms, bound {res['bound_ms'] * 1e3:.3f} us "
              f"by {res['bound_by']}", flush=True)
    res["guard"] = guard_check(dev)
    return res


def guard_check(dev) -> dict:
    """Entry 2 on landmarks at inverse depth 0 (the 1e-12 guard): their
    Hll, bl and Hfl6 entries within 1e-3 of the largest such entry of
    the plain version (the inverse-depth column is conditioned like
    1e12 there), everything else at rtol/atol 1e-9."""
    import torch

    from xrslam_tpu_torch.estimation import gram
    from xrslam_tpu_torch.io.synthetic import reproj_window

    state, data = reproj_window(6, 48, seed=1, n_guard=3, dtype=torch.float64,
                                device=dev)
    out = gram.reproj_factor_gram_cuda(state, data)
    ref = gram.reproj_factor_gram_plain(state, data)
    torch.cuda.synchronize()
    guard = (state.inv_depth == 0) & data.landmark_mask
    res = {}
    for n, a, b in zip(GRAM_NAMES + ["cost"], ref, out):
        if n in ("Hll", "bl", "Hfl6"):
            big = float(a[..., guard].abs().max())
            d = float((b - a)[..., guard].abs().max())
            res[n] = {"largest": big, "max_abs_err": d}
            if not (bool(torch.isfinite(b).all()) and d <= 1e-3 * big):
                fail(f"K2 entry 2 at the inverse-depth guard, {n}: max |Δ| "
                     f"{d:.3e} on entries up to {big:.3e}")
            a, b = a[..., ~guard], b[..., ~guard]
        check_close("K2 entry 2 beside the guard", [n], [a], [b], 1e-9)
    print("K2 reproj_factor_gram at the inverse-depth guard (3 landmarks, K=6, "
          "L=48, f64), max |Δ| / largest entry: " + ", ".join(
              f"{n} {v['max_abs_err']:.3e} / {v['largest']:.3e}"
              for n, v in res.items()) + " (limit 1e-3 of the largest)", flush=True)
    return res


def drive_phase(dev, n_frames: int) -> dict:
    """The main path, warm pass then the timed, counted pass."""
    import torch

    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools.make_dataset import render_sequence, timed_run

    t0 = time.perf_counter()
    seq = render_sequence(n_frames=n_frames, width=752, height=480, focal=458.0)
    print(f"rendered {n_frames} frames 752x480 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    warm = timed_run(api.XRSLAM(config=seq["config"], device=dev), seq, dev,
                     max_frames=WARM_FRAMES)
    print(f"warm pass: {warm['frames_tracked']}/{WARM_FRAMES} tracked, "
          f"ATE {warm['ate_m']:.4f} m, {warm['frames_per_s']:.3f} frames/s",
          flush=True)
    slam = api.XRSLAM(config=seq["config"], device=dev)
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls:
        res = timed_run(slam, seq, dev)
    res["launches"] = {k.name: k.launches for k in build.KERNELS}
    res["entry_launches"] = {k.name: dict(k.entry_launches) for k in build.KERNELS}
    res["frame_pairs_tracked"] = pairs[0]
    res["scharr_calls"] = scharr_calls[0]
    res["peak_mem_mb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    res["warm_pass"] = {k: warm[k] for k in ("frames_tracked", "ate_m",
                                             "frames_per_s")}
    print(f"timed pass: {res['frames_tracked']}/{n_frames} tracked, ATE "
          f"{res['ate_m']:.4f} m, {res['frames_per_s']:.3f} frames/s "
          f"({res['seconds']:.1f} s), launches {res['launches']} (by entry: "
          f"{res['entry_launches']}) over {res['frame_pairs_tracked']} frame pairs "
          f"tracked, {res['scharr_calls']} image-wide Scharr calls, peak "
          f"{res['peak_mem_mb']:.0f} MiB", flush=True)
    print("stage means (ms): " + json.dumps(
        {k: round(v, 2) for k, v in res["stage_ms"].items()}), flush=True)
    for k in build.KERNELS:
        if res["launches"][k.name] == 0:
            fail(f"kernel {k.name} was not launched by the main path")
    if res["entry_launches"]["reproj_gram"]["reproj_factor_gram_launch"] == 0:
        fail("the main path did not launch the fused K2 entry")
    k1 = res["entry_launches"]["klt_level"]
    if res["frame_pairs_tracked"] == 0 \
            or k1[klt.ENTRY_TRACK] != res["frame_pairs_tracked"]:
        fail(f"K1's fused entry launched {k1[klt.ENTRY_TRACK]} times for "
             f"{res['frame_pairs_tracked']} frame pairs tracked")
    if k1[klt.ENTRY_LEVEL] != 0 or res["scharr_calls"] != 0:
        fail(f"the main path launched K1's entry 1 {k1[klt.ENTRY_LEVEL]} times and "
             f"the image-wide Scharr {res['scharr_calls']} times (both must be 0)")
    if res["frames_tracked"] < 60:
        fail(f"only {res['frames_tracked']} of {n_frames} frames tracked (< 60)")
    if not res["ate_m"] <= 0.25:
        fail(f"ATE {res['ate_m']} m above 0.25 m")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every measured number to this JSON file")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from xrslam_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info()
    print(f"kernel build: {info.get('nvcc', 'cached')} "
          f"{time.perf_counter() - t0:.1f} s ({os.path.basename(info['library'])})",
          flush=True)

    k1_level = klt_phase(dev)
    k1 = klt_track_phase(dev)
    k2_gram = gram_phase(dev)
    k2 = factor_gram_phase(dev)
    drive = drive_phase(dev, N_FRAMES)

    # one record per kernel, from its main-path entry (K1's and K2's
    # fused entries), with entry 1's numbers beside it
    kernels = []
    for k, r in ((build.KLT_LEVEL, k1), (build.REPROJ_GRAM, k2)):
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": drive["launches"][k.name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "device_ms": r["device_ms"],
                        "entry_launches": drive["entry_launches"][k.name]})
    kernels[0]["longest_chain"] = k1["longest_chain"]
    kernels[0]["latency_floor_us"] = k1["latency_floor_us"]
    kernels[0]["chain_ms"] = k1["chain_ms"]
    kernels[0]["entry_klt_level"] = {
        key: k1_level[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")}
    e1 = k2_gram["K=12 L=384 float64"]
    kernels[1]["entry_reproj_gram"] = {
        key: e1[key] for key in ("max_abs_err", "ms", "plain_ms", "device_ms",
                                 "bound_ms", "bound_by")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "build": {k: v for k, v in info.items()},
                       "k1_klt_level": k1_level, "k1_klt_track": k1,
                       "k2_reproj_gram": k2_gram,
                       "k2_reproj_factor_gram": k2, "drive": drive,
                       "kernels": kernels}, f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
