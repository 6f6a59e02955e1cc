"""Pipeline benchmark of the port: the sequence drive, end to end (the
port's counterpart of the repository's root `bench_pipeline.py`).

Renders the synthetic EuRoC-layout dataset once
(`tools.make_dataset.render_dataset`, cached under `--dir`, one
directory per frame count, landmark count, size and focal length), then
plays it `--passes` times through `tools.run_dataset.run_sequence` (PNG
decode, the reader, `api.XRSLAM`: CLAHE/GFTT/KLT, initializer, sliding
window, marginalization) on the card, or on the CPU with
`--device cpu`. The first pass is a warm-up; the fastest of the others
is reported. `--schedule` picks the backend's schedule
(`core/detail.py`): `sync` (the default, the reference's PC default:
each frame's backend stage within its own push), `overlap`
(`worker_overlap`, the one-frame lag), `pipelined` (`worker_overlap`
+ `pipelined_writeback`, the two-frame lag the JAX package's root
`bench_pipeline.py` runs by default) or `chained` (`pipelined` with the
device-chained KLT frontend, `chained_frontend`: the counterpart of the
JAX root bench's `XR_CHAINED=1`).

    python -m xrslam_tpu_torch.tools.bench_pipeline --width 752 --height 480 --focal 458 \
        [--schedule pipelined]

Prints ONE JSON line: frames/s of the fastest timed pass and of every
pass (warm-up first), frames tracked and ATE of that pass, its per-stage
means (`StageTimes`, ms), its tracker's frames by route (chained,
standard, re-seeds: `KLTFeatureTracker.stats`), the per-frame latency
(host clock from a frame's image push to the end of the push that
processed it, which ends in a host read of its pose: median and p90,
ms), and on the card
its name and power limit as nvidia-smi gives them. `main` returns the
line's values; `bench` returns them with the reported pass (its output
times `ts`, positions `ps` and final window after `flush`, `window`: t,
q, p, v of every frame).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..config import load_config
from ..core.detail import compute_device
from .make_dataset import render_dataset
from .run_dataset import evaluate_ate, run_sequence

# the Config flags of each schedule
SCHEDULES = {"sync": {},
             "overlap": {"worker_overlap": True},
             "pipelined": {"worker_overlap": True, "pipelined_writeback": True},
             "chained": {"worker_overlap": True, "pipelined_writeback": True,
                         "chained_frontend": True}}


def dataset_dir(base: str, frames: int, landmarks: int, width: int, height: int,
                focal: float) -> str:
    """The cache directory of one render: every parameter of the scene
    is in its name, so two renders never share one."""
    return os.path.join(base, f"f{frames}_l{landmarks}_{width}x{height}_focal{focal:g}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    return bench(argv)[0]


def bench(argv=None):
    """Run the benchmark and print its line; returns (the line's values,
    the reported pass)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--landmarks", type=int, default=500)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "xrslam_torch_bench_seq"))
    ap.add_argument("--passes", type=int, default=3,
                    help="passes over the sequence, the first --warmup of them "
                         "warm-ups")
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed warm-up passes (default 1; 0 where the process "
                         "has already run the pipeline)")
    # EuRoC geometry: --width 752 --height 480 --focal 458
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--focal", type=float, default=None,
                    help="focal length in pixels (default 260 * width / 320)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the card)")
    ap.add_argument("--schedule", choices=tuple(SCHEDULES), default="sync",
                    help="the backend's schedule (default: sync)")
    args = ap.parse_args(argv)
    if not 0 <= args.warmup < args.passes:
        ap.error("--passes must exceed --warmup (>= 0): one pass at least is timed")
    dev = compute_device(args.device)

    focal = args.focal if args.focal is not None else 260.0 * args.width / 320.0
    ds_dir = dataset_dir(args.dir, args.frames, args.landmarks, args.width,
                         args.height, focal)
    root = os.path.join(ds_dir, "mav0")
    if not os.path.exists(os.path.join(ds_dir, "slam.yaml")):
        render_dataset(ds_dir, n_frames=args.frames, n_landmarks=args.landmarks,
                       width=args.width, height=args.height, focal=focal)
    config = load_config(os.path.join(ds_dir, "slam.yaml"),
                         os.path.join(ds_dir, "device.yaml")).replace(
                             **SCHEDULES[args.schedule])

    uri = "euroc://" + root
    passes = []
    for _ in range(args.passes):
        latency = []
        t0 = time.perf_counter()
        ts, _, ps, slam = run_sequence(uri, config, max_frames=args.frames,
                                       async_reader=False, device=dev,
                                       latency=latency)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        swt = slam.pipeline.swt
        window = [] if swt is None else [(f.t, f.q, f.p, f.v) for f in swt.map.all_frames()]
        passes.append({"seconds": dt, "ts": ts, "ps": ps, "latency": latency, "window": window,
                       "routes": dict(slam.pipeline.tracker.stats),
                       "stage_ms": {k: v * 1e3 for k, v in sorted(slam.times.means().items())}})
    best = min(passes[args.warmup:], key=lambda r: r["seconds"])
    lat_ms = np.asarray(best["latency"]) * 1e3
    out = {
        "metric": "pipeline_frames_per_s",
        "frames_per_s": args.frames / best["seconds"],
        "unit": f"frames/s (sequence drive, {args.frames} frames, "
                f"{args.width}x{args.height}, focal {focal:g}: reader, image KLT "
                "frontend, initializer, sliding window, marginalization)",
        "device": dev.type,
        "schedule": args.schedule,
        "card": card_line() if dev.type == "cuda" else None,
        "frames": args.frames,
        "pass_frames_per_s": [args.frames / r["seconds"] for r in passes],
        "warmup_passes": args.warmup,
        "frames_tracked": len(best["ts"]),
        "ate_rmse_m": evaluate_ate(root, best["ts"], best["ps"]) if len(best["ts"])
        else float("nan"),
        "latency_ms": {"median": float(np.median(lat_ms)),
                       "p90": float(np.percentile(lat_ms, 90)),
                       "frames": int(lat_ms.size)},
        "timings_ms": best["stage_ms"],
        "tracker_routes": best["routes"],
        "dataset": ds_dir,
    }
    print(json.dumps(out))
    return out, best


if __name__ == "__main__":
    main()
