"""Multi-sequence benchmark sweep (port of
`xrslam_tpu/tools/run_benchmark.py`): the EuRoC 11-sequence evaluation.

Reproduces the reference's benchmark table workflow (reference:
docs/en/benchmark.md — per-sequence EuRoC ATE RMSE + average, produced
there by manual PC-player runs + external evo) as one command with
built-in Umeyama/ATE. Sequences run back-to-back on the card (or the
CPU with `--device cpu`); per-sequence results stream as JSON lines, a
sequence that fails becomes an `error` record and the sweep goes on, and
the final line is the aggregate.

Usage:
  python -m xrslam_tpu_torch.tools.run_benchmark \
      --slam-config euroc_slam.yaml --device-config euroc_sensor.yaml \
      euroc:///data/MH_01_easy/mav0 euroc:///data/MH_02_easy/mav0 ...
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..config import Config, load_config
from ..core.detail import compute_device
from .run_dataset import evaluate_ate, run_sequence


def run_benchmark(uris, config: Config, max_frames=None, tum_prefix=None,
                  device="cuda"):
    device = compute_device(device)
    results = []
    for uri in uris:
        t0 = time.perf_counter()
        name = uri.rstrip("/").split("/")[-2 if uri.endswith("mav0") else -1]
        tum = f"{tum_prefix}_{name}.tum" if tum_prefix else None
        try:
            ts, qs, ps, _ = run_sequence(uri, config, tum_out=tum,
                                         max_frames=max_frames, device=device)
            seq_path = uri.split("://", 1)[-1]
            ate = evaluate_ate(seq_path, ts, ps) if len(ts) else float("nan")
            rec = {"sequence": name, "ate_rmse_m": ate,
                   "frames_tracked": int(len(ts)),
                   "wall_s": round(time.perf_counter() - t0, 1)}
        except Exception as e:  # a failed sequence must not kill the sweep
            rec = {"sequence": name, "error": f"{type(e).__name__}: {e}"}
        results.append(rec)
        print(json.dumps(rec, default=float), flush=True)

    ates = [r["ate_rmse_m"] for r in results
            if np.isfinite(r.get("ate_rmse_m", float("nan")))]
    summary = {"sequences": len(results),
               "evaluated": len(ates),
               "ate_rmse_mean_m": float(np.mean(ates)) if ates else None}
    print(json.dumps(summary, default=float), flush=True)
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("datasets", nargs="+", help="euroc://PATH ...")
    ap.add_argument("--slam-config")
    ap.add_argument("--device-config")
    ap.add_argument("--max-frames", type=int)
    ap.add_argument("--tum-prefix", help="write per-sequence TUM files")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the card)")
    args = ap.parse_args(argv)
    config = (load_config(args.slam_config, args.device_config)
              if args.slam_config and args.device_config else Config())
    return run_benchmark(args.datasets, config, max_frames=args.max_frames,
                         tum_prefix=args.tum_prefix, device=args.device)


if __name__ == "__main__":
    main()
