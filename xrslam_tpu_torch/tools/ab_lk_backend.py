"""A/B the routes of the port's pyramidal KLT (port of
`xrslam_tpu/tools/ab_lk_backend.py`).

Times the whole forward + backward KLT of a frame pair with its gates
(`frontend/klt.py`) by three routes and checks that each agrees with the
plain version at `tests/test_torch_klt.py`'s limits (status equal on
>= 99% of the slots, positions within 1e-3 px on the slots both keep):

  - `fused`: K1's fused entry, `klt.track_keypoints_cuda` (one launch a
    pair; the main path's route on the card);
  - `chain`: K1's entry 1, `klt.track_keypoints_plain` with
    `level_fn=klt.track_level_cuda` (five launches with their
    image-wide Scharr calls);
  - `plain`: `klt.track_keypoints_plain` (the main path's route on the
    CPU).

The pair is frames 0 and 1 of the rendered wave scene
(`tools.make_dataset.render_sequence`, CLAHE + pyramid as the tracker
builds them), with the frame's first 256 GFTT candidates tracked from
their own positions (`run`'s sizes; the tests call it smaller). The JAX package's backends (XR_LK_BACKEND)
have no counterpart. On the card the two kernel routes launch or raise;
with `--device cpu` they are reported as "not run: cpu".

    python -m xrslam_tpu_torch.tools.ab_lk_backend [--reps 20] [--device cuda|cpu]

Prints one JSON line; exits 1 if a route disagrees with the plain one.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from ..core.detail import compute_device
from ..frontend import image as img_ops
from ..frontend import klt
from ..frontend.tracker import _preprocess_image
from ..utils.timing import mean_ms
from .make_dataset import render_sequence

STATUS_AGREE = 0.99
PX_TOL = 1e-3
ROUTES = {"fused": klt.track_keypoints_cuda,
          "chain": functools.partial(klt.track_keypoints_plain,
                                     level_fn=klt.track_level_cuda),
          "plain": klt.track_keypoints_plain}


def rendered_pair(width: int, height: int, focal: float, points: int, device,
                  levels: int = 3):
    """Pyramids (`levels` above the image, the tracker's 3 by default) of
    frames 0 and 1 of the rendered scene and frame 0's first `points`
    GFTT candidates (positions, valid)."""
    seq = render_sequence(n_frames=2, width=width, height=height, focal=focal)
    pyrs = [_preprocess_image(torch.from_numpy(im).to(device), 6.0, 8, 8, levels)
            for im in seq["images"]]
    cand, _, ok = img_ops.gftt_candidates(pyrs[0][0], max_candidates=points)
    return pyrs, cand.contiguous(), ok.contiguous()


def agreement(nxt, status, ref_nxt, ref_status) -> dict:
    """Status agreement and the largest position difference on the slots
    both keep, against the reference route."""
    nxt, status = nxt.cpu().numpy(), status.cpu().numpy()
    ref_nxt, ref_status = ref_nxt.cpu().numpy(), ref_status.cpu().numpy()
    both = status & ref_status
    px = float(np.abs(nxt[both] - ref_nxt[both]).max()) if both.any() else 0.0
    agree = float(np.mean(status == ref_status))
    return {"status_agree": agree, "max_px_vs_plain": px,
            "agree": agree >= STATUS_AGREE and px <= PX_TOL}


def run(width: int = 752, height: int = 480, focal: float = 458.0, points: int = 256,
        reps: int = 20, device="cuda", levels: int = 3) -> dict:
    dev = compute_device(device)
    pyrs, pts, valid = rendered_pair(width, height, focal, points, dev, levels)
    args = (pyrs[0], pyrs[1], pts, pts, valid)
    out = {"device": dev.type, "width": width, "height": height, "levels": levels,
           "points": int(pts.shape[0]),
           "valid": int(valid.sum()), "reps": reps, "reference": "plain"}
    results = {}
    for name, fn in ROUTES.items():
        if name != "plain" and dev.type != "cuda":
            out[name] = "not run: cpu"
            continue
        results[name] = fn(*args)
        out[name] = {"ms_per_pair": mean_ms(lambda fn=fn: fn(*args), reps, dev),
                     "tracked": int(results[name][1].sum())}
    for name, res in results.items():
        out[name].update(agreement(*res, *results["plain"]))
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
