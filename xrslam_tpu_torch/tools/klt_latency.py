"""Latency of one LK step of K1 on the card, at the main path's shapes.

    python -m xrslam_tpu_torch.tools.klt_latency [--out FILE.json]
    PYTHONPATH=<checkout> python xrslam_tpu_torch/tools/klt_latency.py

On a rendered 752x480 frame pair with 256 GFTT points and seeds
perturbed by 1.5 px (`chip_smoke.py`'s inputs), each of entry 1's five
calls of a frame (the 4 forward levels, the level-0 backward pass, each
from the plain chain's inputs) is timed on the device alone (20
launches captured in a CUDA graph and replayed), at iters=30 and at
iters=1, beside the most LK steps one point took in it (`steps_out`). A
launch lasts about as long as its longest chain plus its loads and
windows, so the difference of the two times over the difference of the
two chains is the cost of one LK step alone. Last, the whole stage,
`klt.track_keypoints` of the pair (the fused entry, or in an older tree
the five launches of entry 1 with their image-wide Scharr calls), is
timed with its Python (CUDA events around 20 calls) and on the device
alone. `chip_smoke.py` splits the fused entry the same way.

Run as a file with another checkout first on PYTHONPATH, it times that
checkout's kernel (entry 1's wrapper takes the same arguments since the
port began), so two trees compare on one card in one call.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from xrslam_tpu_torch.frontend import image as img_ops
from xrslam_tpu_torch.frontend import klt
from xrslam_tpu_torch.frontend.tracker import _preprocess_image
from xrslam_tpu_torch.tools.make_dataset import render_sequence


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn(), host included."""
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
    """Milliseconds per call of fn() replayed from a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return cuda_ms(g.replay, reps=reps, warmup=0) / calls


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("klt_latency times the kernel on a CUDA device; none found")
    dev = torch.device("cuda", 0)
    seq = render_sequence(n_frames=2, width=752, height=480, focal=458.0)
    pyrs = [_preprocess_image(torch.from_numpy(im).to(dev), 6.0, 8, 8, 3)
            for im in seq["images"]]
    cand, _, ok = img_ops.gftt_candidates(pyrs[0][0], max_candidates=256)
    pts = cand.contiguous()
    rng = np.random.default_rng(0)
    init = pts + torch.as_tensor(rng.normal(0, 1.5, tuple(pts.shape)),
                                 dtype=torch.float32, device=dev)
    kw = dict(win=21, iters=30, eps=0.01)
    calls, guess, v = [], init / 8.0, ok
    for lev in (3, 2, 1, 0):
        ix, iy = img_ops.scharr(pyrs[0][lev])
        a = (pyrs[0][lev], ix, iy, pyrs[1][lev], pts / 2.0 ** lev, guess, v)
        k = dict(kw, final=lev == 0, search=64 if lev == 3 else 32)
        calls.append((f"level {lev}", a, k))
        g, v, _ = klt.track_level_plain(*a, **k)
        guess = g * (2.0 if lev > 0 else 1.0)
    ix, iy = img_ops.scharr(pyrs[1][0])
    calls.append(("backward", (pyrs[1][0], ix, iy, pyrs[0][0], guess, pts, v),
                  dict(kw, final=True, search=32)))

    out = {"package": os.path.dirname(os.path.dirname(os.path.abspath(klt.__file__))),
           "card": torch.cuda.get_device_name(0), "entry_1": []}
    for name, a, k in calls:
        one = {"call": name}
        for iters in (30, 1):
            kw_i = dict(k, iters=iters)
            steps = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
            klt.track_level_cuda(*a, **kw_i, steps_out=steps)
            one[f"most_steps_{iters}"] = int(steps.max())
            one[f"device_us_{iters}"] = 1e3 * device_ms(
                lambda a=a, kw_i=kw_i: klt.track_level_cuda(*a, **kw_i))
        d_steps = one["most_steps_30"] - one["most_steps_1"]
        one["us_per_step"] = ((one["device_us_30"] - one["device_us_1"]) / d_steps
                              if d_steps else None)
        out["entry_1"].append(one)
    out["entry_1_device_us_per_frame"] = sum(c["device_us_30"] for c in out["entry_1"])
    args_t = (pyrs[0], pyrs[1], pts, init, ok)

    def stage():
        return klt.track_keypoints(*args_t)

    out["track_keypoints"] = {"ms_with_python": cuda_ms(stage),
                              "device_ms": device_ms(stage)}
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
