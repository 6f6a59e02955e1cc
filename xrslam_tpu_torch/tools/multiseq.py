"""Data-parallel multi-sequence evaluation on one device (port of
`xrslam_tpu/tools/multiseq.py`).

Renders N distinct synthetic EuRoC-layout sequences (different seeds:
different trajectories and landmark fields), then drives them two ways:

1. sequential — full pipelines one after another (the reference's
   benchmark driver loop, xrslam-pc/player/src/main.cpp:116-169, run
   once per sequence);
2. batched — all N pipelines advance frame by frame in lockstep; each
   frame, every sequence on the subframe path hands its fused
   localize + subwindow solve to a `ChainedSolveBroker`, which solves
   them in one `solver.solve_chained_batch` on a leading batch axis (K2
   takes the N windows in one call). Frontends and keyframe steps stay
   per sequence.

Prints one JSON line: each mode's frames, wall time, aggregate frames/s,
per-sequence tracked counts and ATE, K1 and K2 launches per
sequence-frame; the batched mode's dispatches and the solves they
replaced; the speedup; the first frame at which the two modes'
trajectories part, if they do.

Usage (the card by default; `--device cpu` runs on the CPU):
  python -m xrslam_tpu_torch.tools.multiseq --width 752 --height 480 \\
      --focal 458 --n 4 [--frames 60] [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..config import load_config
from ..core.detail import VIOPipeline, compute_device
from ..estimation import solver
from ..frontend.tracker import KLTFeatureTracker
from ..io.dataset import DataType, create_reader
from ..kernels import build
from .make_dataset import render_dataset
from .run_dataset import evaluate_ate

# the JAX package's multi-sequence seeds: scenes that initialize and
# track (a VI scene can be degenerate for any estimator: seed 18 never
# gathers an init baseline, seed 25 diverges in every mode)
SEEDS = (3, 5, 11, 32, 7, 13, 21, 29)
BACKEND_START = 28  # frames before the backend starts, at 20 Hz


class ChainedSolveBroker:
    """Collects `prepare_fused_subframe` contexts from N lockstepped
    trackers and solves them as one batched program per (l_opts, s_opts)
    group, each group padded to the fleet size (one batch shape per
    options pair), then finishes each tracker's step.

    With `check_first`, the first flush that batches more than one
    sequence also solves each window alone with `solver.solve_chained`
    and records the largest |batched − single| over the solved states in
    `first_check` (max_abs_err, windows)."""

    def __init__(self, fleet: int, check_first: bool = False):
        self.fleet = fleet
        self.pending = []
        self.batched_calls = 0
        self.solo_equiv = 0
        self.check_first = check_first
        self.first_check: Optional[dict] = None

    def submit(self, swt, ctx: dict) -> None:
        self.pending.append((swt, ctx))

    def flush(self) -> list:
        """Solve and finish every pending step; returns the trackers."""
        groups = {}
        for swt, ctx in self.pending:
            groups.setdefault((ctx["l_opts"], ctx["s_opts"]), []).append((swt, ctx))
        done = [swt for swt, _ in self.pending]
        self.pending = []
        for (l_opts, s_opts), items in groups.items():
            n = len(items)
            self.solo_equiv += n
            padded = items + [items[-1]] * (self.fleet - n)

            def grab(key):
                return tuple(c[key] for _, c in padded)

            outs = solver.solve_chained_batch(
                grab("l_state"), grab("l_data"), l_opts, grab("s_state"),
                grab("s_data"), s_opts, [c["s2"] for _, c in padded])
            self.batched_calls += 1
            if self.check_first and self.first_check is None and n > 1:
                self.first_check = self._check(items, outs)
            for (swt, ctx), st2 in zip(items, outs):
                swt.finish_fused_subframe(ctx, st2)
        return done

    @staticmethod
    def _check(items, outs) -> dict:
        err = 0.0
        for (_, c), st2 in zip(items, outs):
            _, ref, _ = solver.solve_chained(
                c["l_state"], c["l_data"], c["l_opts"], c["s_state"], c["s_data"],
                c["s_opts"], c["s2"], c["s2"])
            err = max(err, max(float((a - b).abs().max()) for a, b in zip(ref, st2)))
        return {"max_abs_err": err, "windows": len(items)}


def _step_until_frame(pipe: VIOPipeline, reader) -> bool:
    """Feed sensor events until one camera frame is processed."""
    while (kind := reader.next()) != DataType.END:
        if kind == DataType.GYROSCOPE:
            pipe.track_gyroscope(*reader.read_gyroscope())
        elif kind == DataType.ACCELEROMETER:
            pipe.track_accelerometer(*reader.read_accelerometer())
        elif kind == DataType.DEPTH:
            reader.read_depth()
        else:
            pipe.track_camera_image(*reader.read_image())
            return True
    return False


def render(out_dir: str, n_seq: int, n_frames: int, width: int, height: int,
           focal: float, seeds=SEEDS):
    """The N sequences under `out_dir` (reused when already there), the
    s-th from seeds[s % len(seeds)]: (directories, configs)."""
    dirs, configs = [], []
    for s in range(n_seq):
        seed = seeds[s % len(seeds)]
        d = os.path.join(out_dir, f"seq{s}_s{seed}_f{n_frames}_{width}x{height}")
        if not os.path.exists(os.path.join(d, "slam.yaml")):
            render_dataset(d, n_frames=n_frames, n_landmarks=500, width=width,
                           height=height, focal=focal, seed=seed)
        dirs.append(d)
        configs.append(load_config(os.path.join(d, "slam.yaml"),
                                   os.path.join(d, "device.yaml")))
    return dirs, configs


def drive(dirs, configs, device, batched: bool, check_first: bool = False) -> dict:
    """One mode over every sequence; kernel launch counts are set to 0
    before and read after. Poses: each tracking frame's latest window
    state, (frame index, t, p)."""
    n_seq = len(dirs)
    pipes = [VIOPipeline(cfg, KLTFeatureTracker(cfg, device), device) for cfg in configs]
    readers = [create_reader("euroc://" + os.path.join(d, "mav0"), cfg)
               for d, cfg in zip(dirs, configs)]
    broker = ChainedSolveBroker(n_seq, check_first) if batched else None
    ests = [[] for _ in pipes]
    build.reset_launch_counts()
    frames = 0
    t0 = time.perf_counter()

    def collect(i, pipe, n):
        if pipe.state == "tracking":
            t, _, p, _, _, _ = pipe.swt.get_latest_state()
            ests[i].append((n, t, np.asarray(p, dtype=float).copy()))

    if batched:
        alive, n = [True] * n_seq, 0
        while any(alive):
            for i, (p, r) in enumerate(zip(pipes, readers)):
                if not alive[i]:
                    continue
                if p.swt is not None:
                    p.swt.solve_broker = broker
                alive[i] = _step_until_frame(p, r)
                frames += alive[i]
            for swt in broker.flush():
                # the step's write-back landed only now: refresh what the
                # pipeline read from the window after swt.track()
                next(p for p in pipes if p.swt is swt)._refresh_prop_state()
            for i, p in enumerate(pipes):
                if alive[i]:
                    collect(i, p, n)
            n += 1
    else:
        for i, (p, r) in enumerate(zip(pipes, readers)):
            n = 0
            while _step_until_frame(p, r):
                frames += 1
                collect(i, p, n)
                n += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    res = {"frames": frames, "wall_s": dt, "agg_fps": frames / dt,
           "k2_launches": build.REPROJ_GRAM.launches,
           "k1_launches": build.KLT_LEVEL.launches,
           "k2_per_seq_frame": build.REPROJ_GRAM.launches / max(frames, 1),
           "k1_per_seq_frame": build.KLT_LEVEL.launches / max(frames, 1),
           "k2_batched": dict(build.REPROJ_GRAM.batched), "poses": ests}
    if broker is not None:
        res.update(batched_dispatches=broker.batched_calls,
                   solo_solves_replaced=broker.solo_equiv,
                   first_flush_check=broker.first_check)
    return res


def _outcomes(dirs, ests, n_frames: int) -> list:
    out = []
    for d, est in zip(dirs, ests):
        ts = np.asarray([e[1] for e in est])
        ps = np.asarray([e[2] for e in est]).reshape(-1, 3)
        after = sum(1 for e in est if e[0] >= BACKEND_START)
        out.append({"tracked": len(est), "tracked_after_start": after,
                    "frames_after_start": max(n_frames - BACKEND_START, 0),
                    "ate_m": float(evaluate_ate(os.path.join(d, "mav0"), ts, ps))
                    if len(est) >= 10 else float("nan")})
    return out


def first_divergence(a: list, b: list, tol: float = 1e-6):
    """First frame index at which two runs' tracked sets or positions
    (beyond `tol` m) differ, or None."""
    pa = {e[0]: e[2] for e in a}
    pb = {e[0]: e[2] for e in b}
    for n in sorted(set(pa) | set(pb)):
        if n not in pa or n not in pb or np.abs(pa[n] - pb[n]).max() > tol:
            return n
    return None


def run(n_seq: int = 4, n_frames: int = 60, width: int = 752, height: int = 480,
        focal: float = 458.0, device="cuda", out_dir: Optional[str] = None,
        check_first: bool = False, seeds=SEEDS) -> dict:
    """Render, drive sequential then batched; the JSON-able result."""
    device = compute_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dirs, configs = render(out_dir or tmp, n_seq, n_frames, width, height, focal,
                               seeds)
        render_s = time.perf_counter() - t0
        modes = {}
        for name, batched in (("sequential", False), ("batched", True)):
            r = drive(dirs, configs, device, batched, check_first)
            r["sequences"] = _outcomes(dirs, r["poses"], n_frames)
            modes[name] = r
    div = [first_divergence(a, b) for a, b in zip(modes["sequential"]["poses"],
                                                  modes["batched"]["poses"])]
    for r in modes.values():
        del r["poses"]
    res = {"sequences": n_seq, "seeds": [seeds[s % len(seeds)] for s in range(n_seq)],
           "frames_per_seq": n_frames, "size": [width, height], "focal": focal,
           "device": str(device), "render_s": render_s, **modes,
           "speedup": modes["sequential"]["wall_s"] / modes["batched"]["wall_s"],
           "first_divergence": div}
    if device.type == "cuda":
        res["device_name"] = torch.cuda.get_device_name(device)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4, help="sequences")
    ap.add_argument("--frames", type=int, default=60, help="frames per sequence")
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--focal", type=float, required=True)
    ap.add_argument("--device", default="cuda",
                    help='torch device (default "cuda"; "cpu" to run on the CPU)')
    ap.add_argument("--dir", help="where to render (default: a temporary directory)")
    args = ap.parse_args(argv)
    res = run(args.n, args.frames, args.width, args.height, args.focal, args.device,
              args.dir)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
