"""Profile a steady stretch of the main path on one GPU.

    python -m xrslam_tpu_torch.tools.profile_drive [--frames 80 --start 60
        --stop 66 --out FILE.json]

Renders the wave scene at EuRoC geometry (752x480, focal 458), drives
`api.XRSLAM` over `--frames` frames, and traces frames start+1..stop
with `torch.profiler` (CPU and CUDA activities, a device sync at both
ends). Prints per frame: device kernels, device time, the device idle
share of the traced wall time, host synchronisations and copies, the
hand-written kernels' launches and share, and the largest rows by
device time. The untraced frames before the window give frames/s
without the profiler's overhead.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import api
from .make_dataset import render_sequence, run_sequence

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def _device_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--start", type=int, default=60)
    ap.add_argument("--stop", type=int, default=66)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_drive needs a CUDA device")
    dev = torch.device("cuda", 0)
    seq = render_sequence(n_frames=args.frames, width=752, height=480, focal=458.0)
    slam = api.XRSLAM(config=seq["config"], device=dev)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_frame(i, _slam):
        n = i + 1
        if n == 1:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
        if n == args.start:
            torch.cuda.synchronize()
            marks["t_start"] = time.perf_counter()
            prof.start()
        elif n == args.stop:
            torch.cuda.synchronize()
            marks["t_stop"] = time.perf_counter()
            prof.stop()

    ts, _ = run_sequence(api, slam, seq, on_frame=on_frame)
    n_traced = args.stop - args.start
    wall_s = marks["t_stop"] - marks["t_start"]
    rows = prof.key_averages()
    kernels = [e for e in rows if str(e.device_type).endswith("CUDA")]
    ops = [e for e in rows if not str(e.device_type).endswith("CUDA")]
    dev_us = sum(_device_us(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels
                    if not e.key.startswith(("Memcpy", "Memset")))
    own = {tag: {"launches_per_frame": sum(e.count for e in kernels if tag in e.key)
                 / n_traced,
                 "device_us_per_frame": sum(_device_us(e) for e in kernels
                                            if tag in e.key) / n_traced,
                 "share_of_device_time": sum(_device_us(e) for e in kernels
                                             if tag in e.key) / max(dev_us, 1e-9)}
           for tag in ("gram_main_kernel", "gram_reduce_kernel",
                       "onehot_ref_kernel", "klt_track_kernel",
                       "klt_level_kernel")}
    res = {
        "card": torch.cuda.get_device_name(0),
        "frames_traced": [args.start + 1, args.stop],
        "frames_tracked_whole_drive": len(ts),
        "untraced_frames_per_s_before_window":
            (args.start - 1) / (marks["t_start"] - marks["t0"]),
        "traced_wall_s_per_frame": wall_s / n_traced,
        "device_kernels_per_frame": n_kernels / n_traced,
        "device_s_per_frame": dev_us * 1e-6 / n_traced,
        "device_idle_share_traced": 1.0 - dev_us * 1e-6 / wall_s,
        "host_calls_per_frame": {k: sum(e.count for e in ops if e.key == k) / n_traced
                                 for k in SYNC_CALLS},
        "hand_written_kernels": own,
        "top_ops_by_device_time": [
            {"op": e.key, "calls_per_frame": e.count / n_traced,
             "share": _device_us(e) / max(dev_us, 1e-9)}
            for e in sorted(ops, key=_device_us, reverse=True)[:10]],
        "top_kernels_by_device_time": [
            {"kernel": e.key[:90], "calls_per_frame": e.count / n_traced,
             "share": _device_us(e) / max(dev_us, 1e-9)}
            for e in sorted(kernels, key=_device_us, reverse=True)[:10]],
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
