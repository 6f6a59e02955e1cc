"""A/B the arithmetic precision of the port's pyramidal KLT on rendered
frames (the port's counterpart of `xrslam_tpu/tools/ab_klt_precision.py`).

The JAX tool compares the matmul precision modes of its TPU level
tracker (XR_KLT_MM: f32, mixed, bf16), each in a process of its own.
Those modes have no counterpart here: K1 (`csrc/klt_level.cu`) computes
in f32 on the CUDA cores, and the port turns TF32 off
(`xrslam_tpu_torch/__init__.py`), so no reduced-precision product is
left to choose. What remains is how far f32 itself is from exact
arithmetic. On frames 0 and 1 of the rendered wave scene (CLAHE +
pyramid in f32 as the tracker builds them; the frame's first 256 GFTT
candidates tracked from their own positions, `run`'s sizes) the
forward + backward KLT with its gates runs by three routes:

  - `kernel_f32`: K1's fused entry (`klt.track_keypoints_cuda`), the
    main path's route on the card;
  - `plain_f32`: `klt.track_keypoints_plain` in f32, its route on the
    CPU;
  - `plain_f64`: the same on the pyramid and points cast to float64,
    the reference.

Per route: the survivors of the gates (the 0.5 px reverse-consistency
gate is the one reduced precision loses tracks to, the JAX package's
finding), their ratio to the float64 survivors, the largest px
difference from float64 on the common survivors, and the time of a
pair. A route agrees with float64 when its survivors are within 1% of
float64's and its common survivors within 1e-3 px
(`tests/test_torch_klt.py`'s limit). On the card the kernel route
launches or raises; with `--device cpu` it is reported as "not run:
cpu".

    python -m xrslam_tpu_torch.tools.ab_klt_precision [--reps 20] [--device cuda|cpu]

Prints one JSON line; exits 1 if a route disagrees with float64.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core.detail import compute_device
from ..frontend import klt
from ..utils.timing import mean_ms
from .ab_lk_backend import rendered_pair

ROUTES = {"kernel_f32": (klt.track_keypoints_cuda, torch.float32),
          "plain_f32": (klt.track_keypoints_plain, torch.float32),
          "plain_f64": (klt.track_keypoints_plain, torch.float64)}
SURVIVOR_TOL = 0.01
PX_TOL = 1e-3


def run(width: int = 752, height: int = 480, focal: float = 458.0, points: int = 256,
        reps: int = 20, device="cuda", levels: int = 3) -> dict:
    dev = compute_device(device)
    pyrs, pts, valid = rendered_pair(width, height, focal, points, dev, levels)
    out = {"device": dev.type, "width": width, "height": height, "levels": levels,
           "points": int(pts.shape[0]), "valid": int(valid.sum()), "reps": reps,
           "reference": "plain_f64"}
    results = {}
    for name, (fn, dt) in ROUTES.items():
        if name == "kernel_f32" and dev.type != "cuda":
            out[name] = "not run: cpu"
            continue
        args = ([x.to(dt) for x in pyrs[0]], [x.to(dt) for x in pyrs[1]], pts.to(dt),
                pts.to(dt), valid)
        nxt, st = fn(*args)
        results[name] = (nxt.double().cpu().numpy(), st.cpu().numpy())
        out[name] = {"ms_per_pair": mean_ms(lambda fn=fn, args=args: fn(*args), reps, dev),
                     "survivors": int(st.sum())}
    ref_nxt, ref_st = results["plain_f64"]
    for name, (nxt, st) in results.items():
        both = st & ref_st
        ratio = float(st.sum()) / max(float(ref_st.sum()), 1.0)
        px = float(np.abs(nxt[both] - ref_nxt[both]).max()) if both.any() else 0.0
        out[name].update(survivor_ratio_vs_f64=ratio, common_survivors=int(both.sum()),
                         max_px_vs_f64=px,
                         agree=abs(ratio - 1.0) <= SURVIVOR_TOL and px <= PX_TOL)
    out["agree"] = all(r["agree"] for r in out.values() if isinstance(r, dict))
    if dev.type == "cuda":
        from .bench_pipeline import card_line

        out["card"] = card_line()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = run(reps=args.reps, device=args.device)
    print(json.dumps(out))
    if not out["agree"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
