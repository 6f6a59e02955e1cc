"""Benchmark of `xrslam_tpu_torch`, the PyTorch/CUDA port of the VIO
system, on the card.

    python -m vio_bench.run --workload euroc.stream1 --seed 7 --seconds 45 --trace 0

Runs one cell of `BENCHMARK.json`: its configuration
(`configs/<config>.json`) under its traffic (`traffic/<traffic>.json`).
Set-up renders the stream from the seed on the card, builds the
engine (`api.XRSLAM`) and drives the stream's first frames untimed
until it has initialized and settled. The window then replays the
following frames in a closed loop, each frame pushed (its IMU samples,
its image, `run_one_frame`, the sample that closes it) once the
previous frame's pose has been read back with `get_result`, for
`--seconds`. With `--trace 1` the run reports the cell's per-layer
metrics instead of its end-to-end ones: the stage timers over the
window, and a device trace of a fixed stretch of it. After the window
the run compares what the window produced with the plain reference
(`check.py`) and prints, as the last line of its standard output, one
JSON object: correct, attempted, failed, metrics, device
[, breakdown], checks.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

# one process with one thread of host arithmetic: the program's host work
# is serial, and thread pools that spin beside it add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "xrslam_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, ".vio_bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(name: str):
    """The configuration file `configs/<name>.json` as the program's
    Config: every key of its "config" object, arrays as numpy."""
    from xrslam_tpu_torch.config import Config

    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        spec = json.load(f)
    kw = {k: np.asarray(v, dtype=float) if isinstance(v, list) and k != "camera_resolution"
          else tuple(v) if k == "camera_resolution" else v
          for k, v in spec["config"].items()}
    return Config(**kw), spec


def metric_reader(name: str):
    """The reader `metrics/<name>.py` of a per-layer metric."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vio_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


class Driver:
    """Pushes one stream through the engine a frame at a time: frame i's
    IMU samples after frame i-1's, its image and `run_one_frame`, then
    the gyroscope and accelerometer samples at its own time, which
    close it; then its pose is read back."""

    def __init__(self, api, slam, stream):
        self.api = api
        self.slam = slam
        self.stream = stream
        self.S = stream.samples_per_frame
        self.images = stream.images

    def frame(self, i: int):
        """Drive frame i; returns (seconds, published pose or None)."""
        A, slam, st, S = self.api, self.slam, self.stream, self.S
        t0 = time.perf_counter()
        for j in range(max(0, (i - 1) * S + 1), i * S):
            slam.push_sensor_data(A.SensorType.GYROSCOPE, st.imu_t[j], st.imu_w[j])
            slam.push_sensor_data(A.SensorType.ACCELERATION, st.imu_t[j], st.imu_a[j])
        slam.push_sensor_data(A.SensorType.CAMERA, st.t_cam[i],
                              self.images[i].astype(np.float32) / 255.0)
        slam.run_one_frame()
        j = i * S
        slam.push_sensor_data(A.SensorType.GYROSCOPE, st.imu_t[j], st.imu_w[j])
        slam.push_sensor_data(A.SensorType.ACCELERATION, st.imu_t[j], st.imu_a[j])
        pose = None
        if slam.get_result(A.ResultType.STATE) == A.State.TRACKING_SUCCESS:
            p = slam.get_result(A.ResultType.BODY_POSE)
            pose = dict(t=p.timestamp, q=p.quaternion, p=p.translation)
        return time.perf_counter() - t0, pose


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str, setup_start: float, n_frames=None, camera=None) -> dict:
    """Set up, run the window, check it; returns the result line's
    values. For tests on the CPU: `n_frames` shortens the stream and
    `camera` (width, height, focal) shrinks the frames."""
    import torch

    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.core import sliding_window
    from xrslam_tpu_torch.estimation import gram, solver
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.ransac import pnp

    from . import check, reference, stream as streams, taps
    from .trace import K1_KERNEL, K2_KERNELS, Trace

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = cell["name"]
    cfg, cfg_spec = load_config(cell["config"])
    if camera is not None:
        w_, h_, f_ = camera
        cfg = cfg.replace(camera_resolution=(w_, h_), camera_intrinsic=np.array(
            [[f_, 0, w_ / 2], [0, f_, h_ / 2], [0, 0, 1.0]]))
    traffic = streams.load_traffic(cell["traffic"])
    # what the driver below implements: one stream, each frame pushed once
    # the previous frame's pose is read; a mix that asks for more needs a
    # driver of its own, not a silent single stream
    for key, runs in (("streams", 1), ("loop", "closed")):
        if traffic.get(key, runs) != runs:
            raise RunError(f"{name}: traffic {cell['traffic']} sets {key}="
                           f"{traffic[key]!r}; this harness drives {key}={runs!r} only")
    total = n_frames or traffic["max_setup_frames"] + traffic["window_frames"]
    st = streams.make_stream(traffic, cfg, seed, total, device)
    slam = api.XRSLAM(config=cfg, device=device)
    drv = Driver(api, slam, st)

    # set-up: initialize, then settle
    i, tracked_since = 0, None
    while True:
        if i >= min(total, traffic["max_setup_frames"]):
            raise RunError(f"{name}: seed {seed} did not initialize within "
                           f"{i} frames of set-up")
        _, pose = drv.frame(i)
        i += 1
        tracked_since = (tracked_since or i) if pose is not None else None
        if (i >= traffic["setup_frames"] and tracked_since is not None
                and i - tracked_since >= traffic["settle_frames"]):
            break
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - setup_start
    frame0 = i
    if device == "cuda":
        # the peak from here on is what the engine holds while it serves,
        # not what set-up (the render) held for a moment
        torch.cuda.reset_peak_memory_stats()

    # the window
    lo, hi = traffic["trace_frames"]
    rng = np.random.default_rng(seed)
    n_check = traffic["check_samples"]
    solves, margs = taps.Solves(rng), taps.Marginalizations(rng, n_check)
    pnps = taps.PnP(rng, n_check)
    kcalls = taps.KernelCalls(int(x) for x in rng.choice(np.arange(1, lo), n_check,
                                                          replace=False))
    spans = taps.Spans()
    spans.install(slam.times)
    with_pnp = bool(cfg.visual_pnp_enable)
    frames, prof, tr, traced = [], None, None, False
    gc.freeze()     # what set-up made stays: collections in the window skip it
    t_start = time.perf_counter()
    with taps.patched(solver, "solve_window_core", solves), \
            taps.patched(sliding_window, "marginalize_frame", margs), \
            (taps.patched(pnp, "refine_pose_pnp", pnps) if with_pnp
             else contextlib.nullcontext()), \
            taps.patched(klt, "track_keypoints", kcalls.klt), \
            taps.patched(gram, "reproj_factor_gram", kcalls.gram):
        w = 0
        while True:
            if frame0 + w >= total:
                raise RunError(f"{name}: the stream ended after {w} frames of the window "
                               f"({total} frames in all): lengthen window_frames of "
                               f"traffic {cell['traffic']}")
            if trace and w == lo:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                kcalls.on = True
                t_tr0 = time.time_ns()
                off_ns = t_tr0 - time.perf_counter_ns()
            solves.frame = margs.frame = pnps.frame = kcalls.frame = spans.frame = w
            dt, pose = drv.frame(frame0 + w)
            frames.append(dict(seconds=dt, pose=pose, prop=slam.pipeline._prop,
                               t_due=float(st.t_cam[frame0 + w])))
            if trace and w == hi:
                torch.cuda.synchronize()
                t_tr1 = time.time_ns()
                kcalls.on = False
                prof.__exit__(None, None, None)
                traced = True
            w += 1
            if time.perf_counter() - t_start >= seconds and (not trace or traced):
                break
        if device == "cuda":
            torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    if trace:
        tr = Trace.from_profile(prof, t_tr0, t_tr1)
    mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # free the engine before the reference runs
    del slam, drv
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    n = len(frames)
    lat_ms = [f["seconds"] * 1e3 for f in frames]
    res = dict(cell=name, frames=n, window_s=window_s, setup_s=setup_s,
               failed=sum(f["pose"] is None for f in frames), frame0=frame0, mem_peak=mem_peak,
               latency_ms=lat_ms)

    # the comparison with the reference
    t_check = time.perf_counter()
    published = [f for f in frames if f["pose"] is not None]
    cap = dict(solves=solves.calls(n_check), margs=margs.calls(1), pnp=pnps.calls(1),
               tracks=kcalls.tracks, poses=published, stream=st, frame0=frame0,
               pyramid=(float(cfg.feature_tracker_clahe_clip_limit),
                        int(cfg.feature_tracker_clahe_width),
                        int(cfg.feature_tracker_clahe_height)))
    checks = check.readings(cap)
    if published:
        checks["ate_m"] = reference.ate(np.array([f["pose"]["t"] for f in published]),
                                        np.array([f["pose"]["p"] for f in published]),
                                        st.t_cam, st.gt_p)
    limits = dict(check.LIMITS, ate_m=cfg_spec["guarantees"]["ate_rmse_m"])
    due = ["solve_gap", "marg_gap", "track_lost_share", "track_gap_px", "pyramid_gap",
           "pose_gap_m", "ate_m"]
    if cfg.visual_pnp_enable:
        due.append("pnp_gap_m")
    res["checks"] = {k: dict(value=checks.get(k, float("nan")), limit=limits[k]) for k in due}
    res["correct"] = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                         for c in res["checks"].values())
    res["captured"] = cap
    res["check_s"] = time.perf_counter() - t_check
    res["samples"] = dict(solves=len(cap["solves"]), solves_in_window=solves.count,
                          margs=len(cap["margs"]), margs_in_window=margs.count,
                          pnp=len(cap["pnp"]), pnp_in_window=pnps.count,
                          track_pairs=len(kcalls.tracks), poses=len(published))

    # per-layer readings
    if trace:
        res["spans"] = spans.spans
        res["trace"] = tr
        res["k1_calls"] = kcalls.k1
        res["k2_calls"] = kcalls.k2
        res["trace_frames"] = (lo, hi)
        res["off_ns"] = off_ns
        res["K1_KERNEL"], res["K2_KERNELS"] = K1_KERNEL, K2_KERNELS
    return res


def e2e_metrics(res: dict) -> dict:
    lat = res["latency_ms"]
    return {"frames_per_s": res["frames"] / res["window_s"],
            "frame_latency_p90_ms": float(np.percentile(lat, 90)),
            "setup_s": res["setup_s"]}


def result_line(bench: dict, cell: dict, res: dict, trace: bool, device_info: dict) -> dict:
    """The last line: the cell's end-to-end metrics (trace 0) or its
    per-layer metrics (trace 1); `checks` comes last."""
    name = cell["name"]

    def for_cell(m):
        return name in m.get("workloads", [name])

    metrics = {}
    if not trace:
        values = e2e_metrics(res)
        for m in bench["end_to_end"]:
            if for_cell(m) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if for_cell(m):
                v = metric_reader(m["name"])(res)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(res["correct"]), "attempted": res["frames"],
           "failed": res["failed"], "metrics": metrics, "device": device_info}
    if trace and res.get("trace") is not None:
        tr = res["trace"]
        out["device"] = dict(device_info, busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(res["spans"], res["off_ns"], 10)}
    out["checks"] = {k: [c["value"], c["limit"]] for k, c in res["checks"].items()}
    return out


def roofline_bounds(res: dict) -> dict:
    """Which bound (bytes or operations) sets each kernel's least time
    in a traced run."""
    if res.get("trace") is None:
        return {}
    from . import layers

    return {"k1_bound": layers.k1_least(res)[1], "k2_bound": layers.k2_least(res)[1],
            "peaks": "3.35 TB/s; 67 TFLOP/s f32, 33.5 TFLOP/s f64, at 700 W"}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    setup_start = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(description="Benchmark of xrslam_tpu_torch on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    bench = load_benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        res = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                       setup_start)
    except RunError as e:
        print(str(e), file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 5
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": int(res["mem_peak"])}
    line = result_line(bench, cell, res, bool(args.trace), device_info)
    lat = res["latency_ms"]
    print(json.dumps({"cell": cell["name"], "seed": args.seed, "card": card_line(),
                      "setup_frames": res["frame0"], "frames": res["frames"],
                      "window_s": res["window_s"],
                      "latency_ms": {"median": statistics.median(lat),
                                     "p90": float(np.percentile(lat, 90)),
                                     "samples": len(lat)},
                      "samples": res["samples"], "check_s": res["check_s"],
                      **roofline_bounds(res)}))
    for k, (v, lim) in line["checks"].items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
