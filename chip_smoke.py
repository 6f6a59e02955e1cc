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
     (longest chain x one step); then on the chained frontend's input
     (the pair's slots permuted, a third of them dead at stale positions
     outside the image) held to `track_keypoints_plain` at the same
     limits, the dead slots untouched, two launches bit-equal;
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
4. holds one IMU-PARSAC PnP call (256 points, 256 hypotheses, f64) on
   the card to itself (two calls from equally seeded generators,
   bit-equal) and to the CPU on the card's minimal samples (T 1e-9,
   mask and count equal, bin confidences 1e-12);
5. drives the main path — a rendered 120-frame wave scene at EuRoC
   geometry (752x480, focal 458, 500 landmarks, seed 3) through
   `api.XRSLAM` with IMU and images — once to warm up (20 frames), then
   timed with the kernel launch counts reset just before it; fails
   unless both kernels launched, the fused K2 entry among them, K1's
   fused entry once per tracked frame pair and its entry 1 never, no
   image-wide Scharr call, >= 60 frames tracked and ATE <= 0.25 m;
   then holds the four analytic frame Jacobians
   (`estimation.validator.analytic_frame_jacobians`: the closed-form
   reprojection Jacobian of K2's fused entry, preintegration, rotation,
   the marginalization prior) to autodiff through the retraction by
   `validator.validate` on the drive's last keyframe window (re-extracted
   at its end, f64 on the card), each within `max_jacobian_error`;
6. drives the same scene's first 60 frames with `parsac_flag`
   (IMU-PARSAC judge and the 2D-2D update chain), with the same kernel
   checks, >= 20 frames tracked (the backend starts near frame 29) and
   ATE <= 0.25 m; prints frames/s,
   the `parsac_time` mean, how often the judge ran, passed the prior
   gate and returned True, `tracks_unstatic`, the host reads and the
   device syncs per PARSAC frame, and the judge's refusals by gate;
   fails if the judge never ran or a frame read the device more than
   twice (on this static scene the judge does not return True, in the
   JAX package either);
7. drives its first 60 frames with the camera-rate visual PnP and the
   backend every third frame (`configs/iphone_slam.yaml`'s values);
   fails unless at least 10 frames were tracked, the PnP pose was
   published on at least half of them and the camera-rate ATE is
   <= 0.25 m;
7b. drives the reference's mobile profile: the same wave scene (seed 3,
   500 landmarks) written to disk at the iPhone 12's 640x480, focal 478
   (`configs/iphone12_sensor.yaml`), 60 frames, played by
   `tools.run_dataset.run_sequence` with the shipped
   `configs/iphone_slam.yaml` (window 5, the backend every third frame,
   visual PnP, 300 detections on the tracker's 256 slots, the solver time
   budget `time_limit: 0.1`), the rendered device file and the rendered
   slam file's initializer section (the profile sets none; the
   reference's defaults need 50 tracks across 35 frames, which the scene
   does not keep); prints the card line, frames/s, tracked, the
   camera-rate ATE (the published body pose against the ground-truth
   body: the profile's q_bo/p_bo moves only the localizer's output),
   each solve variant's time per iteration, the iteration counts chosen
   after calibration, the budget's device waits and each chain's mean
   time before and after calibration against the 0.1 s budget; fails
   unless the kernels launched as in 5, every calibrated variant waited
   on the device exactly 3 times, every chain solve took the counts the
   budget's rule (restated here) gives for its tracker's estimates, one
   solve at least ran after calibration, >= 10 frames were tracked, the
   PnP pose was published on half of them at least and the ATE is
   <= 0.25 m;
8. drives the dynamic-object scene (60 frames, 96 static landmarks and
   an 80-point moving object, 0.5 px noise, bearings through the
   `SyntheticTracker`, PARSAC on) at eight `Config.random` seeds, the
   first in this process and seven in processes of their own beside
   it, and holds each to the JAX package's
   `test_dynamic_object_parsac_e2e` criteria (tracks_unstatic >= 10,
   more than half of the object's tracks non-static, more than 60% of
   the static tracks static, ATE < 0.15 m): fails unless they all hold
   at one seed at least; then, from the first seed's state before its
   first judge call that returned True, runs the PARSAC chain (judge,
   then update) on the card and on the CPU with the card's minimal
   samples and fails unless the two agree: the judge's value, every
   track's tags in both maps, tracks_unstatic, and m_th, the landed
   pose and the bin confidences within 1e-12.

9. writes the main path's scene to disk as an EuRoC-layout dataset
   with aligned depth images (`tools.make_dataset.render_dataset`,
   752x480, 75 frames) and, in a process of its own beside 8 (as 10
   runs), plays it back through
   `tools.run_dataset.run_sequence` (the PNG reader, the YAML pair,
   `api.XRSLAM` with DEPTH_CAMERA and the depth-camera keyframe path:
   localize, host triangulation seeded from depth, refine); fails
   unless >= 37 frames were tracked, ATE <= 0.25 m, the estimated span
   > half the ground truth's, the initializer's depth rescale ran,
   landmarks were depth-seeded, LANDMARKS and FEATURES came back
   non-empty while tracking, and the kernels launched as in 5; prints
   frames/s with the reader and without it, the reader's and the PNG
   decode's (Pillow's) time and the stage means; then runs the CLI
   (`run_dataset.main`) on its first 40 frames with `--gt` and
   `--viz`, which must write one overlay PNG per frame the tracker
   processed and the trajectory plot;
10. plays the dataset's first 60 frames with `visual_localization_enable`
   and a `MapLocalizer` (query interval 0.5 s) whose matcher serves the
   frame's ground-truth 2D-3D correspondences (0.5 px noise, the points
   in a global frame offset by a fixed T_g), found by the hash of the
   image it receives; fails unless the transform registered, the
   median |p_out - T_g p_gt| over the last 5 outputs is < 0.5 m and the
   newest output is > 1 m from the SLAM-frame ground truth, a
   `VirtualObjectManager` anchored an object that is `isolated` (in the
   global frame), and one blocking `HttpLocalizer` query against an
   in-process stub server sent a JPEG and registered the stub's
   transform. Its keyframes take the depth path of 9, and it prints
   their device syncs, counted by torch's sync debug mode (so that
   9's time holds none of the counting's cost);
11. checkpoint/resume (`utils.checkpoint`): the bench scene's first 60
   frames as bearings through the `SyntheticTracker` at the dataset's
   slam config (K2 runs, K1 not), with PARSAC off and on, each driven
   straight and, in a second pipeline, to frame 45, saved, restored onto
   the card and finished (four drives in processes of their own); fails
   unless each resumed tail is within 1e-6 m of the straight run's and,
   with PARSAC, both stages' bin confidences and m_th within 1e-12;
   beside them, the main path's image stream cut at frame 60, restored
   into a fresh engine (its tracker re-detects) and played to 90, held
   to the main drive's kernel checks, >= 45 tracked and ATE <= 0.25 m;
   prints the file sizes and the save and load times;
12. the benchmark (`tools.bench_pipeline.main`) at 752x480, focal 458,
   one timed pass of 75 frames (no warm-up pass); fails unless its JSON
   line parses, >= 60% of the frames were tracked, ATE <= 0.25 m and
   both kernels launched as in 5; prints the line (frames/s, per-frame
   latency median and p90, stage means).
12b. the schedules, in processes of their own started beside 11: (a)
   the same benchmark pass with `--schedule pipelined` (`worker_overlap`
   + `pipelined_writeback`, the two-frame lag), warmed on 20 frames and
   then held until 12's timed pass starts, so that the passes run side
   by side, and held to 12's synchronous pass: frames tracked within 1,
   the same last output time, the final window after `flush` within
   1e-9 (q, p, v), positions on common output times within 2e-2 m, ATE
   <= 0.25 m and the kernels launched as in 5; prints both passes'
   frames/s and latency median and p90. (b) the bearing scene of 11
   (60 frames, PARSAC on) straight and with `worker_overlap`: the final
   windows after `flush` within 1e-9, K2 launched and K1 not; prints
   the device syncs a frame of both drives, counted by torch's sync
   debug mode.
12c. the chained frontend: the same benchmark pass with `--schedule
   chained` (`chained_frontend` on the two-frame lag), in a process of
   its own started and warmed with 12b's, so that its timed pass runs
   beside 12's and 12b(a)'s; fails unless >= 60% of its frames
   tracked, ATE <= 0.25 m, the kernels launched as in 5 (K1 once per frame
   pair dispatched), and the chained route (the tracker's counter) took
   every frame pair after the first two less the re-seeds it reports;
   prints its frames/s, latency median and p90, the tracker's split
   (preprocess, dispatch, fetch) and its route counters beside 12's and
   12b(a)'s.
12d. the A/B tools, once each with 5 repetitions: `tools.ab_assemble`
   (K2's fused entry, its plain version and the Gram form inside
   `assemble` and a 10-iteration solve, at K=12, L=384 and K=32, L=1024,
   the systems within rtol/atol 1e-9), `tools.ab_lk_backend` (K1's fused
   entry, entry 1's five-launch chain and the plain version on the
   752x480 pair, within the K1 phase's limits) and
   `tools.ab_klt_precision` (K1 in f32 against the plain version in f32
   and f64: survivors within 1% of f64's, 1e-3 px from f64); fails if a
   route of the tool's ROUTES does not run or a route's or the line's
   `agree` is not true, and prints each tool's JSON line.

Beside these:
- K2's fused entry on a batch of 4 windows (K_sub=11, L=384, f64) in
  one call (2 launches), after phase 3: against its plain version at
  rtol/atol 1e-9, each row bit-equal to a single-window call, the N=1
  batch bit-equal to the single-window call; timed beside 4 single
  calls, with its bound;
- the native host runtime (`xrslam_tpu_torch.native`, g++ from
  native/xr_host.cpp), after phase 5: built, `poisson_filter` called at
  least once per tracked frame pair of the main drive and equal to the
  Python `_poisson_accept` on every call it recorded (both timed); the
  tracker's stage split; in phase 9 every camera PNG decoded by
  `png_load_gray`;
- the C ABI, in a process of its own beside phase 8: the port's shim (`native.build_capi`)
  loaded with ctypes drives the main scene's first 45 frames at 752x480
  through XRSLAMCreate / XRSLAMPushSensorData / XRSLAMRunOneFrame /
  XRSLAMGetResult on the card; fails unless half of the frames after
  frame 28 tracked, ATE <= 0.25 m and both kernels launched as in 5;
  then `tests/data/capi_roundtrip.c`, compiled against native/XRSLAM.h
  and the shim, runs as a process on the card and must print every
  CAPI_* line (where Python is not a shared library the link cannot
  work, and the line says so instead);
- the ROS node (`tools.ros_node.RosVioNode`) on the card, the dataset's
  first 20 frames with the distortion flag on: every image drained into
  the engine, each remapped by the native runtime;
- in a process of its own beside phases 6, 7 and 7b, `tools.multiseq`
  at 752x480: 2 sequences (seeds 3 and
  5) of 45 frames, sequential then batched (`solve_chained_batch`,
  K2 over the batch); fails unless every sequence in both modes tracked
  half of its frames after frame 28 at ATE <= 0.25 m, a K2 call served
  more than one window, and the first batched flush's windows solved
  one by one agree with their rows within 1e-9; prints both modes'
  frames/s, the speedup, K1/K2 launches per sequence-frame and where
  the modes part, if they do;
- in a process of its own beside phases 6, 7 and 7b, the landmark-sharded
  Schur BA
  (`parallel.sharded`, ranks spawned by `parallel.mesh.run_ranks` with
  a join timeout, sharing the card over gloo): a K=32, L=2048 f64
  window (`io.synthetic.demo_window_problem`, numpy-seeded
  perturbation, 3 LM iterations) solved here and with its columns over
  W = 2 and 4 ranks, each held to the unsharded solve (cost rtol/atol
  1e-8/1e-10, q, p, inv_depth 1e-6/1e-8), the cost decreasing, every
  rank's frame state bit-equal and K2 launched on every rank in every
  assemble over L/W columns; four K=12, L=384 windows on a 2 x 2 mesh
  against the batched solve (1e-9/1e-12, 1e-7/1e-9), each rank's K2
  call taking its 2 windows; the window in a one-rank NCCL group,
  bit-equal to the unsharded solve; prints ms a solve at W = 1, 2, 4
  and the collectives a solve and their bytes; K2's fused entry on every
  rank's shard of that window (L/W = 2048, 1024, 512 columns) held to
  its plain version at rtol/atol 1e-9, timed beside it and bounded;
  and `tools.run_scaling --devices 1 2 --modes data model --reps 1` in
  a process of its own beside phases 6, 7 and 7b, with its table,
  labeled as ranks sharing the card;
- the phases beside others are those whose checks do not depend on
  time (their times are taken under that load); the kernels' phases,
  the main drive, 12 with 12b(a) and 12c, and the A/B tools run with
  nothing else beside them;
- in the K2 entry 1 phase, K2's library yardstick: the cuBLAS Gram
  form (`gram.reproj_gram_matmul`) held to the plain version and timed
  beside entry 1 at K=12, L=384 and K=32, L=2048 (f64), with its
  number of kernel calls;
- after the main drive, the 5-point solver's null-space basis for 64
  hypotheses by the port's route (AᵀA to the host, scipy's LAPACK) and
  by cuSOLVER's `eigh` on the card, both checked and timed, with the
  main drive's count of such calls.

Each drive sets the launch counts to 0 just before it and reads them
just after; the `kernels` line gives the main path's as `launches` and
every drive's in `launches_by_path`.

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
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 120  # the JAX records' bench scene length
WARM_FRAMES = 20
PNP_FRAMES = 60
# cut from 120 frames when phases 9-10 took the script past 600 s
PARSAC_FRAMES = 60
LOC_FRAMES = 60
# the dataset drive with depth (phase 9): cut from 120 frames to 90 with the
# sharded phases, then to 75 (PERF.md section 4); held to half of them
# tracked, as the main drive is
DATASET_FRAMES = 75
# the dataset CLI's run with --viz: long enough to track (the backend
# starts near frame 29) so that the trajectory plot has an estimate
CLI_FRAMES = 40
# checkpoint phase: the bearing-fed runs (straight, and cut + resumed)
# and the image run (cut + resumed)
CKPT_FRAMES = 60
CKPT_CUT = 45
# cut from 120 frames when the script took 713.6 s, past the 650 s set
# for it (PERF.md section 4)
CKPT_IMAGE_FRAMES = 90
CKPT_IMAGE_CUT = 60
CKPT_TAIL_TOL_M = 1e-6
CKPT_STATE_TOL = 1e-12
# benchmark phase: frames of each of its two passes; 60% of them tracked
# needs about 70 (the backend starts near frame 29); cut from 80 with
# the image checkpoint run
BENCH_FRAMES = 75
# one timed pass and no warm-up: the main drive has warmed the process
BENCH_MIN_TRACKED_SHARE = 0.6
# phase 12b, the schedules: tests/test_worker_overlap.py's bounds (the
# final window after flush, positions on common output times)
SCHEDULE_WINDOW_TOL = 1e-9
SCHEDULE_POS_TOL_M = 2e-2
# The dynamic-object scene's outcome turns on which frame the judge
# first returns True, a matter of the RANSAC draws: over Config.random
# seeds the JAX package met its e2e criteria in about half of the runs
# and the port in about 0.4 (PERF.md). So the criteria are required at
# one seed of eight (at a rate of 0.4, eight misses in a row have odds
# near 1%), each seed in a process of its own beside the first (648,
# the default), and the chain itself is held to the CPU on the same
# draws (`chain_check`).
OBJECT_SEEDS = tuple(range(648, 656))
# phase 7b, the mobile profile: the shipped slam file, the initializer
# section of the rendered scene's own slam file (the profile sets none),
# phase 7's limits
MOBILE_FRAMES = 60
MOBILE_MIN_TRACKED = 10
MOBILE_SLAM_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                "iphone_slam.yaml")
MOBILE_INITIALIZER_FIELDS = (
    "initializer_keyframe_num", "initializer_keyframe_gap", "initializer_min_matches",
    "initializer_min_parallax", "initializer_min_triangulation",
    "initializer_min_landmarks")
# the solver time budget's rule, restated from the JAX package
# (xrslam_tpu/core/sliding_window.py:212-242): the iteration counts a
# clamped solve may take, and the device waits that calibrate a variant
BUDGET_LADDER = (1, 2, 3, 5, 8, 15, 30)
CALIB_SYNCS = 3
OBJECT_MIN_PASSED = 1
OBJECT_TIMEOUT_S = 600

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
# The sharded phases (PERF.md section 4): the JAX package's large-window
# deployment, one window of K=32 frames and L=2048 landmark slots in
# float64 (tests/test_large_window.py), its columns split over W ranks
# that share cuda:0, 3 LM iterations from a numpy-seeded perturbation;
# held to the unsharded solve at that test's tolerances.
SHARD_K, SHARD_L = 32, 2048
SHARD_WIDTHS = (2, 4)
SHARD_ITERS = 3
SHARD_TIMED = 3
SHARD_SEED = 8
SHARD_COST_TOL = (1e-8, 1e-10)
SHARD_STATE_TOL = (1e-6, 1e-8)
# data x model: four main-path windows on a 2 x 2 mesh of 4 ranks, held
# to the batched solve at tests/test_parallel.py's tolerances
DXM_K, DXM_L = 12, 384
DXM_SEEDS = (21, 22, 23, 24)
DXM_ITERS = 3
DXM_COST_TOL = (1e-9, 1e-12)
DXM_STATE_TOL = (1e-7, 1e-9)
RANK_TIMEOUT_S = 300
# cut from (1, 2, 4) when the sharded phases took the script past the
# 800 s set for it (PERF.md section 4)
SCALING_DEVICES = (1, 2)
# cut from 2 for the script's time; run_scaling runs in a process of its
# own beside the checkpoint phase (PERF.md section 4)
SCALING_REPS = 1
# the A/B tools (after phase 12): repetitions per timing; ab_assemble's
# sizes, the JAX record AB_ASSEMBLE_r05.json's
AB_REPS = 5
AB_ASSEMBLE_SIZES = ((12, 384), (32, 1024))

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
    scattered = scattered_slot_check(pyrs, pts, init, ok)

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
           "scattered_slots": scattered,
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


def scattered_slot_check(pyrs, pts, init, ok) -> dict:
    """K1's fused entry on the chained frontend's input
    (`io.synthetic.scattered_slots`: the slots permuted, a third of them
    dead, the dead slots at stale positions outside the image in both pts
    and init). Fails unless it agrees with `track_keypoints_plain` at the
    K1 phase's limits, the dead slots keep their init and stay dead, and
    two launches are bit-equal."""
    import torch

    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.io.synthetic import scattered_slots

    N, dead = pts.shape[0], pts.shape[0] // 3
    pts, init, ok = scattered_slots(pyrs[0], pts, init, ok, seed=1)
    args = (pyrs[0], pyrs[1], pts, init, ok)
    ref = klt.track_keypoints_plain(*args)
    out = klt.track_keypoints_cuda(*args)
    torch.cuda.synchronize()
    agree = float((out[1] == ref[1]).float().mean())
    live = out[1] & ref[1]
    err = float((out[0] - ref[0]).abs()[live].max()) if bool(live.any()) else 0.0
    check_repeat("K1 fused entry on scattered slots",
                 lambda: klt.track_keypoints_cuda(*args))
    print(f"K1 klt_track on scattered slots ({dead} of {N} dead at stale positions "
          f"outside the image): status agreement {agree:.4f} (limit 0.99), "
          f"{int(live.sum())} live on both, max |Δpos| {err:.3e} px (limit 1e-3), "
          f"repeat bit-equal", flush=True)
    if agree < 0.99 or err > 1e-3 or not bool(live.any()):
        fail("K1's fused entry disagrees with track_keypoints_plain on scattered slots")
    if bool(out[1][~ok].any()) or not torch.equal(out[0][~ok], init[~ok]):
        fail("K1's fused entry moved or revived a dead slot")
    return {"dead": dead, "status_agreement": agree, "live": int(live.sum()),
            "max_abs_err": err}


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
            one["library_gram_form"] = gram_form_yardstick(tag, xs, ref, tol, one)
        res[tag] = one
    return res


def torch_calls(fn) -> dict:
    """The PyTorch operators one call of fn() dispatches: all of them,
    and those that are not views (each of which runs a kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {"operators": 0, "kernel_calls": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen["operators"] += 1
            seen["kernel_calls"] += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return seen


def gram_form_yardstick(tag: str, xs, ref, tol: float, entry1: dict) -> dict:
    """K2's library yardstick: the same five outputs from the same
    inputs by the JAX package's augmented-Jacobian Gram form
    (`gram.reproj_gram_matmul`: the frame block as one cuBLAS matrix
    product), held to the plain version and timed beside entry 1."""
    import torch

    from xrslam_tpu_torch.estimation import gram

    out = gram.reproj_gram_matmul(*xs)
    torch.cuda.synchronize()
    res = {"max_abs_err": check_close(f"K2 Gram form {tag}", GRAM_NAMES, ref, out, tol)}
    fn = lambda: gram.reproj_gram_matmul(*xs)  # noqa: E731
    res.update(torch_calls(fn))
    res["ms"] = (cuda_ms(fn) + cuda_ms(fn)) / 2
    res["device_ms"] = device_ms(fn)
    print(f"K2 library yardstick {tag}: the cuBLAS Gram form (reproj_gram_matmul, "
          f"{res['kernel_calls']} kernel calls of {res['operators']} torch operators) "
          f"{res['ms']:.4f} ms (device alone {res['device_ms']:.4f}), max |Δ| "
          f"{res['max_abs_err']:.3e} vs plain; K2 entry 1 {entry1['ms']:.4f} ms "
          f"(device alone {entry1['device_ms']:.4f})", flush=True)
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
        res.update(factor_gram_bound(state, data, out))
        print(f"K2 reproj_factor_gram per call (K=12, L=384, f64): kernel "
              f"{res['ms']:.4f} ms (device alone {res['device_ms']}), plain "
              f"{res['plain_ms']:.4f} ms, autodiff composition "
              f"{res['autodiff_ms']:.4f} ms, bound {res['bound_ms'] * 1e3:.3f} us "
              f"by {res['bound_by']}", flush=True)
    res["guard"] = guard_check(dev)
    return res


def factor_gram_bound(state, data, out) -> dict:
    """K2 entry 2's bound on one window's inputs: each input read once
    and each output written once; the factor and Gram operations of the
    active observations, and 3 a coordinate of the others."""
    from xrslam_tpu_torch.estimation import factors

    K, L = state.q.shape[-2], state.inv_depth.shape[-1]
    ins = (state.q, state.p, state.inv_depth, data.q_bc, data.p_bc,
           data.bearings, data.obs_mask, data.ref_idx, data.sqrt_inv_cov2,
           data.landmark_mask)
    n_act = int(factors._active_mask(data).sum())
    return bound(nbytes(*ins, *out),
                 n_act * (FACTOR_FLOPS + GRAM_FLOPS_ALL + GRAM_FLOPS_ANCHORED)
                 + (K * L - n_act) * 8 * 3, state.p.element_size())


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


@contextlib.contextmanager
def recording(module, name: str):
    """Keeps the arguments of every call of `module.name` while the block
    runs (references, no copies: the callers pass fresh arrays)."""
    fn = getattr(module, name)
    calls = []

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def counted_drive(slam, seq, dev, max_frames=None, poisson_args=None) -> dict:
    """`timed_run` of `seq` through `slam` with every kernel launch count
    and the native runtime's call counts set to 0 just before and read
    just after, and the frame pairs the tracker tracked, the image-wide
    Scharr calls and the 5-point solver's null-space bases counted. A
    list `poisson_args` receives the arguments of every
    `native.poisson_filter` call."""
    from xrslam_tpu_torch import native
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.geometry import essential
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools.make_dataset import timed_run

    build.reset_launch_counts()
    native.reset_counts()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls, \
            counting(essential, "nullspace_basis") as bases, \
            recording(native, "poisson_filter") as poisson:
        res = timed_run(slam, seq, dev, max_frames=max_frames)
    res["launches"] = {k.name: k.launches for k in build.KERNELS}
    res["entry_launches"] = {k.name: dict(k.entry_launches) for k in build.KERNELS}
    res["frame_pairs_tracked"] = pairs[0]
    res["scharr_calls"] = scharr_calls[0]
    res["nullspace_calls"] = bases[0]
    res["native_calls"] = dict(native.CALLS)
    if poisson_args is not None:
        poisson_args.extend(poisson)
    return res


def check_image_path(res: dict, what: str, min_tracked: int = 60) -> None:
    """Fail unless an image drive went through both kernels: K2's fused
    entry, K1's fused entry once per tracked frame pair, K1's entry 1
    and the image-wide Scharr never; and >= `min_tracked` frames
    tracked."""
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.kernels import build

    for k in build.KERNELS:
        if res["launches"][k.name] == 0:
            fail(f"{what}: kernel {k.name} was not launched")
    if res["entry_launches"]["reproj_gram"]["reproj_factor_gram_launch"] == 0:
        fail(f"{what}: the fused K2 entry was not launched")
    k1 = res["entry_launches"]["klt_level"]
    if res["frame_pairs_tracked"] == 0 \
            or k1[klt.ENTRY_TRACK] != res["frame_pairs_tracked"]:
        fail(f"{what}: K1's fused entry launched {k1[klt.ENTRY_TRACK]} times for "
             f"{res['frame_pairs_tracked']} frame pairs tracked")
    if k1[klt.ENTRY_LEVEL] != 0 or res["scharr_calls"] != 0:
        fail(f"{what}: K1's entry 1 launched {k1[klt.ENTRY_LEVEL]} times and the "
             f"image-wide Scharr {res['scharr_calls']} times (both must be 0)")
    if res["frames_tracked"] < min_tracked:
        fail(f"{what}: only {res['frames_tracked']} of {res['frames']} frames tracked "
             f"(< {min_tracked})")


def check_ate(res: dict, what: str) -> None:
    if not res["ate_m"] <= 0.25:
        fail(f"{what}: ATE {res['ate_m']} m above 0.25 m")


def drive_phase(dev, seq) -> dict:
    """The main path, warm pass then the timed, counted pass."""
    import torch

    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.tools.make_dataset import timed_run

    n_frames = len(seq["t_cam"])
    warm = timed_run(api.XRSLAM(config=seq["config"], device=dev), seq, dev,
                     max_frames=WARM_FRAMES)
    print(f"warm pass: {warm['frames_tracked']}/{WARM_FRAMES} tracked, "
          f"ATE {warm['ate_m']:.4f} m, {warm['frames_per_s']:.3f} frames/s",
          flush=True)
    slam = api.XRSLAM(config=seq["config"], device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    poisson_args = []
    res = counted_drive(slam, seq, dev, poisson_args=poisson_args)
    res["poisson_args"] = poisson_args
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
    check_image_path(res, "the main path")
    check_ate(res, "the main path")
    return res, slam


@contextlib.contextmanager
def counting_syncs(cls, names):
    """Counts the device syncs (uploads from pageable memory, reads)
    made inside the methods `names` of `cls` while the block runs, by
    torch's sync debug mode."""
    import warnings

    import torch

    syncs = [0]
    saved = {n: getattr(cls, n) for n in names}

    def wrap(fn):
        def counted(*args, **kwargs):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    syncs[0] += sum("synchroniz" in str(w.message) for w in seen)
        return counted

    for n in names:
        setattr(cls, n, wrap(saved[n]))
    try:
        yield syncs
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def parsac_drive_phase(dev, seq) -> dict:
    """The main path's scene, its first `PARSAC_FRAMES` frames, with
    `parsac_flag`: IMU-PARSAC judge and the 2D-2D update chain on every
    backend frame."""
    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.core.sliding_window import SlidingWindowTracker

    slam = api.XRSLAM(config=seq["config"].replace(parsac_flag=True), device=dev)
    with counting_syncs(SlidingWindowTracker,
                        ("judge_track_status", "update_track_status")) as syncs:
        res = counted_drive(slam, seq, dev, max_frames=PARSAC_FRAMES)
    swt = slam.pipeline.swt
    if swt is None:
        fail("PARSAC drive: the pipeline never initialized")
    st = dict(swt.stats)
    calls = max(st["judge_calls"], 1)
    res.update(parsac=st, parsac_ms=res["stage_ms"].get("parsac_time"),
               host_reads_per_frame=st["parsac_host_reads"] / calls,
               syncs_per_frame=syncs[0] / calls)
    print(f"PARSAC drive: {res['frames_tracked']}/{res['frames']} tracked, ATE "
          f"{res['ate_m']:.4f} m, {res['frames_per_s']:.3f} frames/s, parsac_time "
          f"mean {res['parsac_ms']:.2f} ms, judge True {st['judge_true']} of "
          f"{st['judge_calls']} calls (prior gate passed in {st['judge_prior_ok']}; "
          f"refused with < 20 tracks {st['judge_refused_points']}, < 40 keyframe "
          f"matches {st['judge_refused_matches']}, < 20 inliers "
          f"{st['judge_refused_inliers']}, < 20 outliers {st['judge_refused_outliers']}, "
          f"ambiguous {st['judge_refused_ambiguous']}), "
          f"tracks_unstatic {st['tracks_unstatic']}, "
          f"launches {res['launches']} (by entry {res['entry_launches']}) over "
          f"{res['frame_pairs_tracked']} frame pairs, host reads per PARSAC frame "
          f"{res['host_reads_per_frame']:.3f}, device syncs per PARSAC frame "
          f"{res['syncs_per_frame']:.3f}", flush=True)
    print("PARSAC drive stage means (ms): " + json.dumps(
        {k: round(v, 2) for k, v in res["stage_ms"].items()}), flush=True)
    check_image_path(res, "PARSAC drive", min_tracked=20)
    check_ate(res, "PARSAC drive")
    # on this static scene the judge does not return True, in the JAX
    # package either (PERF.md): that is required of the dynamic-object
    # drive, not here
    if st["judge_calls"] == 0:
        fail("PARSAC drive: judge_track_status never ran")
    if res["host_reads_per_frame"] > 2:
        fail(f"PARSAC drive: {res['host_reads_per_frame']} host reads per frame (> 2)")
    return res


def visual_pnp_phase(dev, seq) -> dict:
    """The main path's scene with the camera-rate visual PnP and the
    backend every third frame (configs/iphone_slam.yaml's values)."""
    from xrslam_tpu_torch import api

    cfg = seq["config"].replace(visual_pnp_enable=True, visual_pnp_min_landmarks=10,
                                sliding_window_tracker_frequent=3)
    slam = api.XRSLAM(config=cfg, device=dev)
    res = counted_drive(slam, seq, dev, max_frames=PNP_FRAMES)
    res["pnp_frames"] = slam.pipeline.pnp_frames
    print(f"visual-PnP drive: {res['frames_tracked']}/{res['frames']} tracked, PnP "
          f"pose published on {res['pnp_frames']} frames, camera-rate ATE "
          f"{res['ate_m']:.4f} m, {res['frames_per_s']:.3f} frames/s, launches "
          f"{res['launches']} over {res['frame_pairs_tracked']} frame pairs", flush=True)
    print("visual-PnP drive stage means (ms): " + json.dumps(
        {k: round(v, 2) for k, v in res["stage_ms"].items()}), flush=True)
    # the backend initializes on about frame 28 of 60 (every frame until
    # then), so 10 tracked frames (tests/test_visual_pnp.py's floor)
    check_image_path(res, "visual-PnP drive", min_tracked=10)
    check_ate(res, "visual-PnP drive")
    if 2 * res["pnp_frames"] < res["frames_tracked"]:
        fail(f"visual-PnP drive: the PnP pose was published on {res['pnp_frames']} "
             f"of {res['frames_tracked']} tracked frames (< half)")
    return res


def budgeted_iterations(limit: float, est, base: int, share: int = 0) -> int:
    """The iteration count the solver time budget gives a solve, or the
    second share of a chained solve whose first share takes `share`
    iterations, when its variant was timed at `est` seconds an
    iteration: the ladder value at or below max(1, int(limit / est) -
    share) where that is below `base`, else `base`."""
    if not est or not 0 < limit < 1.0e5:
        return base
    fit = max(1, int(limit / est) - share)
    if fit >= base:
        return base
    return max([v for v in BUDGET_LADDER if v <= fit] or [1])


@contextlib.contextmanager
def budget_recording():
    """Records, while the block runs, every fused chain solve of the
    sliding window: its variant, its two iteration counts, the estimates
    its tracker held when it was budgeted and the host time of its step
    (extraction, solve, write-back); and the budget's device waits by
    tracker and variant."""
    from xrslam_tpu_torch.core import sliding_window as sw

    cls = sw.SlidingWindowTracker
    rec = {"solves": [], "waits": {}, "trackers": {}}
    current = {}
    methods = {n: getattr(cls, n) for n in
               ("_fused_subframe_step", "_fused_keyframe_step", "_note_solve")}
    solvers = {n: getattr(sw, n) for n in ("solve_chained", "solve_keyframe_chain")}

    def step(fn):
        def timed(self, *args):
            rec["trackers"][id(self)] = self
            current.update(swt=self, est=dict(self._iter_seconds), solve=None)
            t0 = time.perf_counter()
            fn(self, *args)
            if current["solve"] is not None:
                current["solve"]["seconds"] = time.perf_counter() - t0
        return timed

    def solve(fn, keyframe: bool):
        def recorded(*args, **kwargs):
            l_opts, s_opts = args[2], args[5]
            swt = current["swt"]
            base = "refine" if keyframe else (
                "subwindow_rot" if s_opts.use_rotation else "subwindow")
            one = {"variant": "kf_chain" if keyframe else "chained:" + base,
                   "base": base, "l": l_opts.iterations, "s": s_opts.iterations,
                   "est": current["est"], "tracker": id(swt),
                   "limit": swt.config.solver_time_limit,
                   "iteration_limit": swt.config.solver_iteration_limit}
            current["solve"] = one
            rec["solves"].append(one)
            return fn(*args, **kwargs)
        return recorded

    def note(self, variant, result, iterations, t0):
        rec["trackers"][id(self)] = self
        before = self.stats["budget_syncs"]
        methods["_note_solve"](self, variant, result, iterations, t0)
        key = (id(self), variant)
        rec["waits"][key] = rec["waits"].get(key, 0) + self.stats["budget_syncs"] - before

    cls._fused_subframe_step = step(methods["_fused_subframe_step"])
    cls._fused_keyframe_step = step(methods["_fused_keyframe_step"])
    cls._note_solve = note
    sw.solve_chained = solve(solvers["solve_chained"], False)
    sw.solve_keyframe_chain = solve(solvers["solve_keyframe_chain"], True)
    try:
        yield rec
    finally:
        for n, fn in methods.items():
            setattr(cls, n, fn)
        for n, fn in solvers.items():
            setattr(sw, n, fn)


def check_budget(rec: dict, what: str) -> dict:
    """Fail unless every recorded chain solve took the iteration counts
    the budget's rule gives for the estimates its tracker held, at least
    one solve ran after its variant's calibration, and every calibrated
    variant waited on the device exactly CALIB_SYNCS times. Returns the
    per-variant summary."""
    after = []
    for one in rec["solves"]:
        est, lim, base = one["est"], one["limit"], one["iteration_limit"]
        want_l = budgeted_iterations(lim, est.get("localize"), base)
        want_s = budgeted_iterations(lim, est.get(one["variant"]),
                                     budgeted_iterations(lim, est.get(one["base"]), base),
                                     want_l)
        if (one["l"], one["s"]) != (want_l, want_s):
            fail(f"{what}: a {one['variant']} solve took {one['l']} + {one['s']} "
                 f"iterations where the budget gives {want_l} + {want_s} (estimates "
                 f"{est})")
        if one["variant"] in est:
            after.append(one)
    if not after:
        fail(f"{what}: no chain solve ran after its variant's calibration "
             f"({len(rec['solves'])} solves)")
    def mean_ms(solves):
        ts = [s["seconds"] for s in solves if "seconds" in s]
        return 1e3 * sum(ts) / len(ts) if ts else None

    out = {}
    for (tid, variant), waits in sorted(rec["waits"].items(), key=str):
        swt = rec["trackers"][tid]
        calibrated = variant in swt._iter_seconds
        if calibrated and waits != CALIB_SYNCS:
            fail(f"{what}: calibrated variant {variant} waited on the device {waits} "
                 f"times (!= {CALIB_SYNCS})")
        mine = [s for s in rec["solves"] if s["variant"] == variant and s["tracker"] == tid]
        clamped = [s for s in mine if variant in s["est"]]
        before = [s for s in mine if variant not in s["est"]]
        out[variant] = {
            "est_ms_per_iter": 1e3 * swt._iter_seconds[variant] if calibrated else None,
            "samples_ms": [1e3 * x for x in swt._solve_samples.get(variant, [])],
            "budget_syncs": waits, "solves": len(mine),
            "iterations_after": sorted({(s["l"], s["s"]) for s in clamped}),
            "solves_after": len(clamped),
            "chain_ms_before": mean_ms(before), "chain_ms_after": mean_ms(clamped)}
    return out


def mobile_phase(dev, out_dir: str, n_frames: int = MOBILE_FRAMES, width: int = 640,
                 height: int = 480, focal: float = 478.0,
                 min_tracked: int = MOBILE_MIN_TRACKED) -> dict:
    """Phase 7b: the reference's mobile profile end to end. The wave
    scene rendered to disk at the iPhone 12's 640x480 and focal 478
    (configs/iphone12_sensor.yaml) and played by
    `tools.run_dataset.run_sequence` with the shipped
    configs/iphone_slam.yaml (window 5, backend every 3rd frame, visual
    PnP, 300 detections, a 0.1 s solver time budget), the rendered
    device file, and the rendered slam file's initializer section (the
    profile sets none, and the reference's defaults need 50 tracks across
    35 frames, which this scene does not keep). Fails unless the kernels
    ran as in 5, >= `min_tracked` frames tracked, the PnP pose was
    published on half of them, the camera-rate ATE (the published body
    pose against the ground-truth body; the profile's q_bo/p_bo moves
    only the localizer's output) is <= 0.25 m, and the budget held
    (`check_budget`)."""
    import torch

    from xrslam_tpu_torch import native
    from xrslam_tpu_torch.config import load_config
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import run_dataset
    from xrslam_tpu_torch.tools.make_dataset import render_dataset

    card = card_line() if torch.device(dev).type == "cuda" else None
    paths = render_dataset(out_dir, n_frames=n_frames, n_landmarks=500, width=width,
                           height=height, focal=focal, seed=3)
    scene_cfg = load_config(paths["slam_yaml"], paths["device_yaml"])
    cfg = load_config(MOBILE_SLAM_YAML, paths["device_yaml"]).replace(**{
        k: getattr(scene_cfg, k) for k in MOBILE_INITIALIZER_FIELDS})
    build.reset_launch_counts()
    native.reset_counts()
    t0 = time.perf_counter()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls, budget_recording() as rec:
        ts, _, ps, slam = run_dataset.run_sequence("euroc://" + paths["root"], cfg,
                                                   async_reader=False, device=dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    res = {"card": card, "frames": n_frames, "frames_tracked": len(ts),
           "seconds": seconds, "frames_per_s": n_frames / seconds,
           "ate_m": run_dataset.evaluate_ate(paths["root"], ts, ps),
           "pnp_frames": slam.pipeline.pnp_frames,
           "launches": {k.name: k.launches for k in build.KERNELS},
           "entry_launches": {k.name: dict(k.entry_launches) for k in build.KERNELS},
           "frame_pairs_tracked": pairs[0], "scharr_calls": scharr_calls[0],
           "solver_time_limit": cfg.solver_time_limit,
           "stage_ms": {k: v * 1e3 for k, v in sorted(slam.times.means().items())}}
    print(f"mobile-profile drive ({width}x{height}, focal {focal}, {n_frames} frames, "
          f"configs/iphone_slam.yaml; card {card}): {res['frames_tracked']}/{n_frames} "
          f"tracked, PnP pose published on {res['pnp_frames']} frames, camera-rate ATE "
          f"{res['ate_m']:.4f} m, {res['frames_per_s']:.3f} frames/s, launches "
          f"{res['launches']} over {res['frame_pairs_tracked']} frame pairs", flush=True)
    print("mobile-profile drive stage means (ms): " + json.dumps(
        {k: round(v, 2) for k, v in res["stage_ms"].items()}), flush=True)
    check_image_path(res, "mobile-profile drive", min_tracked=min_tracked)
    check_ate(res, "mobile-profile drive")
    if 2 * res["pnp_frames"] < res["frames_tracked"]:
        fail(f"mobile-profile drive: the PnP pose was published on {res['pnp_frames']} "
             f"of {res['frames_tracked']} tracked frames (< half)")
    res["budget"] = check_budget(rec, "mobile-profile drive")
    res["budget_syncs"] = sum(t.stats["budget_syncs"] for t in rec["trackers"].values())
    if res["budget_syncs"] != sum(v["budget_syncs"] for v in res["budget"].values()):
        fail(f"mobile-profile drive: {res['budget_syncs']} budget syncs counted, "
             f"{res['budget']} recorded")
    limit_ms = 1e3 * cfg.solver_time_limit
    for variant, b in res["budget"].items():
        def ms(x):
            return "none" if x is None else f"{x:.1f}"
        print(f"solver time budget {variant}: estimate {ms(b['est_ms_per_iter'])} ms an "
              f"iteration (samples {[round(x, 2) for x in b['samples_ms']]}), "
              f"{b['budget_syncs']} device waits; {b['solves']} solves, {b['solves_after']} "
              f"after calibration at iterations (localize, second share) "
              f"{b['iterations_after']}; chain mean {ms(b['chain_ms_before'])} ms before "
              f"calibration, {ms(b['chain_ms_after'])} ms after, against the "
              f"{limit_ms:.0f} ms budget", flush=True)
    print(f"mobile-profile drive: budget_syncs {res['budget_syncs']}", flush=True)
    return res


def render_euroc(out_dir: str, n_frames: int = DATASET_FRAMES, width: int = 752,
                 height: int = 480, focal: float = 458.0) -> dict:
    """Phase 9's dataset: the bench scene as an EuRoC-layout dataset with
    aligned depth images; returns `render_dataset`'s paths."""
    from xrslam_tpu_torch.tools.make_dataset import render_dataset

    return render_dataset(out_dir, n_frames=n_frames, n_landmarks=500, width=width,
                          height=height, focal=focal, seed=3, with_depth=True)


def dataset_phase(dev, out_dir: str, n_frames: int = DATASET_FRAMES, width: int = 752,
                  height: int = 480, focal: float = 458.0,
                  min_tracked: int = DATASET_FRAMES // 2, cli_frames: int = CLI_FRAMES,
                  paths: dict | None = None) -> dict:
    """Phase 9: the bench scene written to disk as an EuRoC-layout
    dataset with aligned depth images (here, or before: `paths`, as
    `render_euroc` returns them) and played back through
    `tools.run_dataset` (the reader, the YAML pair, `api.XRSLAM` with
    DEPTH_CAMERA and the depth-camera keyframe path); then the CLI on
    its first `cli_frames` frames with `--viz`, which must write one
    overlay per frame the tracker processed and the trajectory plot.
    The drive is timed without the sync counting
    of `counting_syncs`: the localizer drive counts the syncs of the same
    keyframe path."""
    import torch

    from xrslam_tpu_torch import api, native
    from xrslam_tpu_torch.config import load_config
    from xrslam_tpu_torch.eval import trajectory as traj
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.io.dataset import load_euroc_groundtruth, load_gray_pillow
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import run_dataset

    t0 = time.perf_counter()
    if paths is None:
        paths = render_euroc(out_dir, n_frames, width, height, focal)
    render_s = time.perf_counter() - t0
    cfg = load_config(paths["slam_yaml"], paths["device_yaml"])
    seen = {"results": []}

    def on_frame(n, slam):
        if slam.get_result(api.ResultType.STATE) == api.State.TRACKING_SUCCESS:
            seen["results"].append((len(slam.get_result(api.ResultType.LANDMARKS)),
                                    len(slam.get_result(api.ResultType.FEATURES))))

    build.reset_launch_counts()
    native.reset_counts()
    t0 = time.perf_counter()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls:
        ts, _, ps, slam = run_dataset.run_sequence("euroc://" + paths["root"], cfg,
                                                   async_reader=False, device=dev,
                                                   on_frame=on_frame)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    tot = slam.times.totals()
    reader_s = tot.get("read_image_time", 0.0) + tot.get("read_depth_time", 0.0)
    res = {"frames": n_frames, "frames_tracked": len(ts), "seconds": seconds,
           "frames_per_s": n_frames / seconds, "reader_s": reader_s,
           # the main drive's frames come from memory: without the reader
           # the two drives differ by the depth input and keyframe path
           "frames_per_s_no_reader": n_frames / (seconds - reader_s),
           "render_s": render_s,
           "launches": {k.name: k.launches for k in build.KERNELS},
           "entry_launches": {k.name: dict(k.entry_launches) for k in build.KERNELS},
           "frame_pairs_tracked": pairs[0], "scharr_calls": scharr_calls[0],
           "native_calls": dict(native.CALLS),
           "stage_ms": {k: v * 1e3 for k, v in sorted(slam.times.means().items())}}
    gt_t, gt_p, _ = load_euroc_groundtruth(paths["root"])
    ia, ib = traj.associate(ts, gt_t)
    res["ate_m"] = traj.ate_rmse(ps[ia], gt_p[ib]) if len(ia) >= 10 else float("nan")
    res["span_m"] = float(np.ptp(ps[ia], axis=0).max()) if len(ia) else 0.0
    res["gt_span_m"] = float(np.ptp(gt_p[ib], axis=0).max()) if len(ia) else 0.0
    init, swt = slam.pipeline.initializer, slam.pipeline.swt
    res["depth_scale"] = init.depth_scale
    res["depth_ratios"] = init.depth_ratios
    st = dict(swt.stats) if swt is not None else {}
    res["depth_keyframes"] = st.get("depth_keyframes", 0)
    res["depth_seeded"] = st.get("depth_seeded", 0)
    res["landmarks_features"] = seen["results"][:1] + seen["results"][-1:]
    sm = res["stage_ms"]
    print(f"dataset drive ({width}x{height}, {n_frames} frames with depth, rendered in "
          f"{render_s:.1f} s): {res['frames_tracked']}/{n_frames} tracked, ATE "
          f"{res['ate_m']:.4f} m, span {res['span_m']:.3f} m of the ground truth's "
          f"{res['gt_span_m']:.3f} m, {res['frames_per_s']:.3f} frames/s with the reader, "
          f"{res['frames_per_s_no_reader']:.3f} without; reader per frame "
          f"{sm.get('read_image_time', float('nan')):.2f} ms (image) + "
          f"{sm.get('read_depth_time', float('nan')):.2f} ms (depth), PNG decode "
          f"{sm.get('decode_time', float('nan')):.2f} ms a file; initializer depth "
          f"rescale x{res['depth_scale']} from {res['depth_ratios']} ratios; "
          f"{res['depth_keyframes']} depth-path keyframes, {res['depth_seeded']} "
          f"landmarks depth-seeded; LANDMARKS/FEATURES "
          f"at the first and last tracking frame {res['landmarks_features']}; launches "
          f"{res['launches']} (by entry {res['entry_launches']}) over "
          f"{res['frame_pairs_tracked']} frame pairs", flush=True)
    print("dataset drive stage means (ms): " + json.dumps(
        {k: round(v, 2) for k, v in sm.items()}), flush=True)
    check_image_path(res, "dataset drive", min_tracked=min_tracked)
    check_ate(res, "dataset drive")
    if not res["span_m"] > 0.5 * res["gt_span_m"]:
        fail(f"dataset drive: estimated span {res['span_m']} m <= half the ground "
             f"truth's {res['gt_span_m']} m (collapsed scale)")
    if res["depth_scale"] is None:
        fail("dataset drive: the initializer's depth rescale did not run")
    if res["depth_seeded"] == 0 or res["depth_keyframes"] == 0:
        fail("dataset drive: no keyframe took the depth path or no landmark was "
             "depth-seeded")
    if not seen["results"] or min(min(r) for r in seen["results"]) == 0:
        fail("dataset drive: LANDMARKS or FEATURES came back empty while tracking")
    if res["native_calls"]["png_load_gray"] != n_frames:
        fail(f"dataset drive: {res['native_calls']['png_load_gray']} native PNG decodes "
             f"for {n_frames} camera images")
    # the camera PNG decode alone: native and Pillow in turns on the same files
    cam_dir = os.path.join(paths["root"], "cam0", "data")
    files = sorted(os.path.join(cam_dir, f) for f in os.listdir(cam_dir))[:20]
    t_dec = {"native": 0.0, "pillow": 0.0}
    for rep in range(2):
        for name, fn in (("native", native.png_load_gray), ("pillow", load_gray_pillow))[
                ::1 - 2 * rep]:
            t0 = time.perf_counter()
            for f in files:
                fn(f)
            t_dec[name] += (time.perf_counter() - t0) / (2 * len(files)) * 1e3
    res["png_decode_ms"] = t_dec
    print(f"dataset drive: {res['native_calls']['png_load_gray']} camera PNGs of "
          f"{n_frames} decoded by the native runtime (png_load_gray); one "
          f"{width}x{height} camera PNG: native {t_dec['native']:.3f} ms, Pillow "
          f"{t_dec['pillow']:.3f} ms (20 files, twice each, in turns; host)", flush=True)

    viz_dir = os.path.join(out_dir, "viz")
    cli = run_dataset.main(["euroc://" + paths["root"], "--slam-config", paths["slam_yaml"],
                            "--device-config", paths["device_yaml"], "--max-frames",
                            str(cli_frames), "--gt", "--sync", "--viz", viz_dir,
                            "--device", torch.device(dev).type])
    if not ({"frames_tracked", "fps", "timings"} <= set(cli) and cli["fps"] > 0):
        fail(f"run_dataset's CLI printed {cli}")
    pngs = sorted(f for f in os.listdir(viz_dir) if f.startswith("frame_"))
    plot = os.path.join(viz_dir, "trajectory.png")
    print(f"run_dataset --viz on {cli_frames} frames: {len(pngs)} overlay PNGs for "
          f"{cli['frames_processed']} frames the tracker processed, "
          f"{cli['frames_tracked']} tracked, trajectory plot "
          f"{os.path.getsize(plot) if os.path.exists(plot) else 'missing'} bytes", flush=True)
    if not (len(pngs) == cli["overlays"] == cli["frames_processed"] > 0):
        fail(f"run_dataset --viz wrote {len(pngs)} overlays ({cli['overlays']} counted) for "
             f"{cli['frames_processed']} frames")
    if cli["frames_tracked"] == 0 or not os.path.exists(plot):
        fail("run_dataset --viz: no frame tracked or no trajectory plot written")
    res["cli"] = cli
    res["paths"] = paths
    return res


class StubLocServer:
    """A stdlib XRLocalization stub on 127.0.0.1: answers /loc with a
    fixed global camera pose and records the requests."""

    def __init__(self, qvec, tvec, ninlier: int = 50):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.requests = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                outer.requests.append((self.path, body))
                payload = json.dumps({"qvec": list(qvec), "tvec": list(tvec),
                                      "ninlier": ninlier}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def localizer_phase(dev, dataset: dict, n_frames: int = LOC_FRAMES,
                    min_tracked: int = 10) -> dict:
    """Phase 10: the dataset's first `n_frames` frames with
    `visual_localization_enable` and a `MapLocalizer` (query interval
    0.5 s) whose matcher serves each frame's ground-truth 2D-3D
    correspondences (0.5 px noise, the 3D points in a global frame
    offset by T_g), found by the hash of the image it receives; an AR
    object anchored once registered; then one `HttpLocalizer` query
    against a stub server. The device syncs per depth-path keyframe
    (localize, triangulation, refine) are counted here."""
    import hashlib

    import torch

    from xrslam_tpu_torch.ar import VirtualObjectManager
    from xrslam_tpu_torch.config import load_config
    from xrslam_tpu_torch.core import nputil
    from xrslam_tpu_torch.core.sliding_window import SlidingWindowTracker
    from xrslam_tpu_torch.eval import trajectory as traj
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.io.dataset import _read_camera_csv, load_euroc_groundtruth, load_gray
    from xrslam_tpu_torch.io.synthetic import euler_consistent, wave_scene
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.localizer import SE3, MapLocalizer
    from xrslam_tpu_torch.tools import run_dataset
    from xrslam_tpu_torch.tools.make_dataset import camera_extrinsics

    paths = dataset["paths"]
    root = paths["root"]
    q_bc, p_bc = camera_extrinsics()
    cfg = load_config(paths["slam_yaml"], paths["device_yaml"]).replace(
        visual_localization_enable=True,
        # the localizer anchors the transform at the output pose: the camera
        output_to_body_rotation=q_bc, output_to_body_translation=p_bc)
    K = cfg.camera_intrinsic
    W, H = cfg.camera_resolution
    scene = euler_consistent(wave_scene(n_frames=dataset["frames"], n_landmarks=500, seed=3))
    qs, ps_gt, lms = scene.q.numpy(), scene.p.numpy(), scene.landmarks.numpy()
    T_g = SE3(nputil.quat_normalize(np.array([0.9, 0.1, -0.2, 0.3])),
              np.array([5.0, -2.0, 1.5]))
    X_g = np.stack([T_g.apply(x) for x in lms])
    images = [os.path.join(root, "cam0", "data", fn)
              for _, fn in _read_camera_csv(os.path.join(root, "cam0", "data.csv"))]
    by_hash = {hashlib.sha1(load_gray(fn).tobytes()).hexdigest(): i
               for i, fn in enumerate(images[:n_frames])}
    rng = np.random.default_rng(0)
    served = []

    def matcher(frame_data):
        i = by_hash.get(hashlib.sha1(np.ascontiguousarray(
            frame_data, dtype=np.float32).tobytes()).hexdigest())
        if i is None:
            return None
        q_wc = nputil.quat_mul(qs[i], q_bc)
        p_wc = ps_gt[i] + nputil.quat_rotate(qs[i], p_bc)
        Xc = (nputil.quat_to_matrix(q_wc).T @ (lms - p_wc).T).T
        z = np.where(Xc[:, 2] > 0.3, Xc[:, 2], 1.0)
        uv = (K @ (Xc / z[:, None]).T).T[:, :2]
        vis = (Xc[:, 2] > 0.3) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < H)
        uv = uv[vis] + rng.normal(0.0, 0.5, (int(vis.sum()), 2))
        x = (uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
        served.append(i)
        return X_g[vis], x, np.ones(len(x), bool)

    loc = MapLocalizer(cfg, matcher=matcher, query_interval=0.5, device=dev)
    ar = {}

    def on_frame(n, slam):
        if n == 1:
            slam.pipeline.set_localizer(loc)
        swt = slam.pipeline.swt
        if "id" not in ar and swt is not None and loc.is_initialized():
            mgr = VirtualObjectManager(swt.map, localizer=loc)
            oid = mgr.create_virtual_object()
            ar["tries"] = ar.get("tries", 0) + 1
            if oid > 0:
                ar["id"], ar["object"] = oid, mgr.get_virtual_object_pose(oid)

    build.reset_launch_counts()
    t0 = time.perf_counter()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls, \
            counting_syncs(SlidingWindowTracker, ("localize_newframe", "track_landmark",
                                                  "refine_window")) as syncs:
        ts, _, ps, slam = run_dataset.run_sequence("euroc://" + root, cfg,
                                                   max_frames=n_frames, async_reader=False,
                                                   device=dev, on_frame=on_frame)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    swt = slam.pipeline.swt
    depth_keyframes = swt.stats["depth_keyframes"] if swt is not None else 0
    res = {"frames": n_frames, "frames_tracked": len(ts), "seconds": seconds,
           "frames_per_s": n_frames / seconds,
           "launches": {k.name: k.launches for k in build.KERNELS},
           "entry_launches": {k.name: dict(k.entry_launches) for k in build.KERNELS},
           "frame_pairs_tracked": pairs[0], "scharr_calls": scharr_calls[0],
           "queries_served": len(served), "registered": loc.is_initialized(),
           "depth_keyframes": depth_keyframes,
           "syncs_per_depth_keyframe": syncs[0] / max(depth_keyframes, 1),
           "stage_ms": {k: v * 1e3 for k, v in sorted(slam.times.means().items())}}
    gt_t, gt_p, _ = load_euroc_groundtruth(root)
    ia, ib = traj.associate(ts, gt_t)
    # the outputs switch from the SLAM frame to the global frame at the
    # registration, so an ATE over them says nothing; the errors below
    # hold them to the global ground truth
    errs = [float(np.linalg.norm(ps[a] - T_g.apply(gt_p[b]))) for a, b in zip(ia[-5:], ib[-5:])]
    res["global_err_m"] = float(np.median(errs)) if errs else float("inf")
    res["slam_frame_dist_m"] = (float(np.linalg.norm(ps[ia[-1]] - gt_p[ib[-1]]))
                                if len(ia) else 0.0)
    res["ar_object"] = ar.get("id")
    res["ar_tries"] = ar.get("tries", 0)
    print(f"localizer drive ({n_frames} frames): {res['frames_tracked']}/{n_frames} "
          f"tracked, {res['queries_served']} queries served, registered "
          f"{res['registered']}, median |p_out - T_g p_gt| over the last 5 outputs "
          f"{res['global_err_m']:.4f} m, newest output {res['slam_frame_dist_m']:.3f} m from "
          f"the SLAM-frame ground truth, {res['frames_per_s']:.3f} frames/s, AR object "
          f"{res.get('ar_object')} after {res['ar_tries']} tries; "
          f"{res['syncs_per_depth_keyframe']:.2f} device syncs per depth-path keyframe "
          f"(localize, triangulation, refine; {depth_keyframes} keyframes); launches "
          f"{res['launches']} over {res['frame_pairs_tracked']} frame pairs", flush=True)
    # the outputs switch to the global frame at the registration, so the
    # drive is held to the global errors below, not to an ATE
    check_image_path(res, "localizer drive", min_tracked=min_tracked)
    if not res["registered"]:
        fail("localizer drive: the SLAM -> global transform never registered")
    if not res["global_err_m"] < 0.5:
        fail(f"localizer drive: median global error {res['global_err_m']} m (>= 0.5)")
    if not res["slam_frame_dist_m"] > 1.0:
        fail(f"localizer drive: the newest output is {res['slam_frame_dist_m']} m from "
             f"the SLAM-frame ground truth (<= 1 m: not in the global frame)")
    if "id" not in ar:
        fail(f"AR: no virtual object anchored in {ar.get('tries', 0)} tries once registered")
    obj = ar["object"]
    res["ar_isolated"] = obj.isolated
    print(f"AR object {ar['id']}: p {obj.p}, isolated {obj.isolated}", flush=True)
    if not obj.isolated:
        fail("AR: the object was not mapped to the global frame (isolated is False)")
    res["http"] = http_check(slam, cfg, images[n_frames - 1])
    return res


def http_check(slam, cfg, image_path: str) -> dict:
    """One blocking `HttpLocalizer` query, with a frame's image and the
    pipeline's latest pose, against the stub server: the JPEG request
    goes out and the stub's transform registers."""
    import base64

    from xrslam_tpu_torch.core import nputil
    from xrslam_tpu_torch.io.dataset import load_gray
    from xrslam_tpu_torch.localizer import SE3, HttpLocalizer

    t_last, q_sb, p_sb, _ = slam.pipeline._propagate_full(slam.pipeline.last_imu_t)
    T_true = SE3(nputil.quat_normalize(np.array([0.7, 0.3, -0.1, 0.4])),
                 np.array([5.0, -2.0, 1.5]))
    T_slam_cam = SE3(nputil.quat_mul(q_sb, cfg.output_to_body_rotation),
                     p_sb + nputil.quat_rotate(q_sb, cfg.output_to_body_translation))
    T_g_cam = T_true @ T_slam_cam
    srv = StubLocServer(T_g_cam.q.tolist(), T_g_cam.p.tolist())
    try:
        http = HttpLocalizer(cfg, ip="127.0.0.1", port=srv.port)
        http.query_localization(t_last, load_gray(image_path), q_sb, p_sb, block=True)
    finally:
        srv.close()
    out = {"requests": len(srv.requests)}
    jpeg = base64.b64decode(srv.requests[0][1]["image"]) if srv.requests else b""
    out["jpeg_bytes"] = len(jpeg)
    out["registered"] = http.is_initialized()
    T = http.slam_to_global
    out["T_err"] = float(max(np.abs(np.abs(nputil.quat_mul(nputil.quat_conj(T.q), T_true.q)[0]) - 1),
                             np.abs(T.p - T_true.p).max()))
    print(f"HttpLocalizer against the stub server: {out['requests']} request, JPEG "
          f"{out['jpeg_bytes']} bytes, registered {out['registered']}, transform "
          f"error {out['T_err']:.3e}", flush=True)
    if not (out["requests"] == 1 and jpeg[:2] == b"\xff\xd8" and out["registered"]
            and out["T_err"] < 1e-9):
        fail(f"HttpLocalizer query against the stub failed: {out}")
    return out


def object_drive(seed: int, dev, chain_snapshots: bool = False):
    """The dynamic-object scene (bearings through the SyntheticTracker,
    PARSAC on, `Config.random` = seed) on `dev`; returns its record and,
    with `chain_snapshots`, the chain's snapshots before every judge
    call (`tools.parsac_chain`)."""
    import torch

    from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
    from xrslam_tpu_torch.tools import object_scene as osc
    from xrslam_tpu_torch.tools import parsac_chain as chain

    scene = osc.object_scene()
    pipe = VIOPipeline(osc.object_config(scene, parsac_flag=True, random=seed),
                       SyntheticTracker(device=dev), device=dev)
    t0 = time.perf_counter()
    with chain.snapshotting() if chain_snapshots else contextlib.nullcontext([]) as snaps:
        est_t, est_p = osc.drive(pipe, scene)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    res = {"seed": seed, "frames": len(scene["bearings"]), "frames_tracked": len(est_t),
           "seconds": time.perf_counter() - t0, "initialized": pipe.swt is not None}
    if res["initialized"]:
        res.update(ate_m=osc.scene_ate(scene, est_t, est_p), parsac=dict(pipe.swt.stats),
                   verdict=osc.object_verdict(pipe, scene),
                   stage_ms={k: v * 1e3 for k, v in sorted(pipe.times.means().items())})
        res["misses"] = osc.criteria_failures(res["parsac"], res["verdict"], res["ate_m"])
    else:
        res["misses"] = ["never initialized"]
    return res, snaps, pipe.config


def object_seed_worker(seed: int, dev: str) -> dict:
    """One seed of the dynamic-object study, in a process of its own."""
    import torch

    torch.set_num_threads(1)
    return object_drive(seed, torch.device(dev))[0]


def chain_check(dev, snaps, cfg) -> dict:
    """The PARSAC chain from the drive's state before the first judge
    call that returned True (the last call's if none did): judge then
    update on the card, from the drive's generator state, and on the
    CPU with the card's minimal samples; the same value, tags of every
    track in both maps and tracks_unstatic, m_th, landed pose and bin
    confidences within 1e-12."""
    from xrslam_tpu_torch.core.map import PipelineMap
    from xrslam_tpu_torch.core.sliding_window import SlidingWindowTracker
    from xrslam_tpu_torch.tools import parsac_chain as chain

    picked = chain.first_fired(snaps)
    if picked is None:
        fail("dynamic-object drive: judge_track_status never ran")
    snap, fired = picked
    card = SlidingWindowTracker(PipelineMap(), cfg, dev)
    card.generator.set_state(snap["generator"])
    card_snap = chain.on_device(snap, dev)
    with chain.recorded_draws() as drawn:
        card_ok = chain.run_chain(card, card_snap)
    host = SlidingWindowTracker(PipelineMap(), cfg, "cpu")
    host_snap = chain.on_device(snap, "cpu")
    with chain.replayed_draws(drawn):
        host_ok = chain.run_chain(host, host_snap)
    bad = chain.differences(card_ok, card, card_snap, host_ok, host, host_snap)
    res = {"from_first_true": fired, "judge": card_ok, "draws": len(drawn),
           "tracks_unstatic": card.stats["tracks_unstatic"] - snap["stats"]["tracks_unstatic"],
           "differences": bad}
    print(f"PARSAC chain on the card against the CPU ({'first judge True' if fired else 'no judge True in the drive: its last call'}, "
          f"{len(drawn)} minimal-sample draws): judge {card_ok}, "
          f"{res['tracks_unstatic']} tracks un-static'd, "
          f"{'agree' if not bad else 'DIFFER: ' + '; '.join(bad)}", flush=True)
    if card_ok != fired:
        fail(f"PARSAC chain: the replay's judge returned {card_ok}, the drive's {fired}")
    if bad:
        fail("PARSAC chain on the card disagrees with the CPU: " + "; ".join(bad))
    return res


def object_phase(dev) -> dict:
    """The dynamic-object scene at OBJECT_SEEDS[0] in this process (its
    kernel launches counted, the chain's snapshots kept for
    `chain_check`), and at the other OBJECT_SEEDS in processes of their
    own beside it, each held to the JAX package's e2e criteria."""
    import concurrent.futures
    import multiprocessing

    from xrslam_tpu_torch.kernels import build

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(OBJECT_SEEDS) - 1, mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(object_seed_worker, s, str(dev)) for s in OBJECT_SEEDS[1:]]
        build.reset_launch_counts()
        res, snaps, cfg = object_drive(OBJECT_SEEDS[0], dev, chain_snapshots=True)
        res["launches"] = {k.name: k.launches for k in build.KERNELS}
        seeds = [res] + [f.result(timeout=OBJECT_TIMEOUT_S) for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for r in seeds:
        print(f"dynamic-object drive, random {r['seed']}: {r['frames_tracked']}/"
              f"{r['frames']} tracked, ATE {r.get('ate_m', float('nan')):.4f} m, "
              f"{r['seconds']:.1f} s, PARSAC {r.get('parsac')}, tags {r.get('verdict')}, "
              f"misses {r['misses'] or 'none'}", flush=True)
    passed = [r["seed"] for r in seeds if not r["misses"]]
    print(f"dynamic-object drive: all four e2e criteria met at {len(passed)} of "
          f"{len(seeds)} seeds ({passed}); launches at random {res['seed']} "
          f"{res['launches']}", flush=True)
    if not res["initialized"] or res["launches"]["reproj_gram"] == 0:
        fail("dynamic-object drive: the pipeline never initialized or K2 was not launched")
    if len(passed) < OBJECT_MIN_PASSED:
        fail(f"dynamic-object drive: the e2e criteria held at {len(passed)} of "
             f"{len(seeds)} seeds (< {OBJECT_MIN_PASSED})")
    res["chain"] = chain_check(dev, snaps, cfg)
    res["seeds"] = {r["seed"]: {k: r.get(k) for k in ("frames_tracked", "ate_m", "seconds",
                                                      "parsac", "verdict", "misses")}
                    for r in seeds}
    res["passed_seeds"] = passed
    return res


def parsac_repeat_phase(dev) -> dict:
    """One IMU-PARSAC PnP call (256 points, 256 hypotheses, f64) on the
    card twice from equally seeded generators: bit-equal; and against
    the CPU on the card's minimal samples: T within 1e-9, the same mask
    and count, bin confidences within 1e-12."""
    import torch

    from xrslam_tpu_torch.ransac import core, parsac, pnp

    rng = np.random.default_rng(0)
    N = 256
    X = rng.uniform([-3.0, -2.0, 4.0], [3.0, 2.0, 9.0], (N, 3))
    x = X[:, :2] / X[:, 2:3] + rng.normal(0, 1e-3, (N, 2))
    x[x[:, 0] > 0.15] += [0.03, -0.02]
    args = [X, x, rng.integers(0, 25, N), np.eye(4), rng.uniform(0, 1, parsac.N_BINS)]
    valid = np.arange(N) < 200

    def run(device, idx=None):
        gen = torch.Generator(device=device).manual_seed(648)
        t = [torch.as_tensor(a, device=device) for a in args]
        return pnp.find_pnp_matrix_parsac_imu(
            gen, t[0], t[1], t[2], t[3], t[4], 0.2,
            valid=torch.as_tensor(valid, device=device), threshold=1.0 / 450.0,
            norm_scale=1.5, idx=idx)

    a, b = run(dev), run(dev)
    torch.cuda.synchronize(dev)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        fail("IMU-PARSAC: two calls on the card from the same seed differ")
    gen = torch.Generator(device=dev).manual_seed(648)
    b_idx = parsac.bucket_points(torch.as_tensor(x, device=dev), 1.5)
    w = parsac.point_weights(b_idx, torch.as_tensor(args[4], device=dev),
                             torch.as_tensor(valid, device=dev))
    idx = core.sample_minimal(gen, 256, N, 6, torch.as_tensor(valid, device=dev), w)
    cpu = run(torch.device("cpu"), idx=idx.cpu())
    res = {"T_err": float((a[0].cpu() - cpu[0]).abs().max()),
           "conf_err": float((a[3].cpu() - cpu[3]).abs().max()),
           "mask_equal": bool(torch.equal(a[1].cpu(), cpu[1])),
           "count_equal": int(a[2]) == int(cpu[2]), "ok": bool(a[4])}
    print(f"IMU-PARSAC on the card: repeats bit-equal; against the CPU on the same "
          f"samples T max |Δ| {res['T_err']:.3e} (limit 1e-9), confidences "
          f"{res['conf_err']:.3e} (1e-12), mask equal {res['mask_equal']}, count "
          f"equal {res['count_equal']}, prior gate {res['ok']}", flush=True)
    if not (res["T_err"] <= 1e-9 and res["conf_err"] <= 1e-12 and res["mask_equal"]
            and res["count_equal"]):
        fail("IMU-PARSAC on the card disagrees with the CPU")
    return res


def validator_phase(swt) -> dict:
    """The Jacobian validator on the main drive's last window: the full
    keyframe window (K slots, L landmark slots, f64, on the window
    tracker's device) extracted at the end of the drive with its
    marginalization prior, each of the four analytic frame Jacobians
    (`validator.analytic_frame_jacobians`) held to the autodiff one by
    `validator.validate` at `Options.max_jacobian_error`."""
    import torch

    from xrslam_tpu_torch.estimation import validator

    frames = list(swt.map.frames)
    state, data, _ = swt._extract(
        frames, swt.K_slots, track_filter=swt._refine_track_filter(frames),
        all_frames_between=swt._kf_between(frames), imu_cap=128)
    data = data._replace(marg=swt.marg, use_marg=torch.ones(
        (), dtype=torch.bool, device=swt.device))
    opts = validator.Options()
    res = {"device": str(state.p.device), "dtype": str(state.p.dtype),
           "K": state.K, "L": state.L, "frames": len(frames),
           "landmarks": int(data.landmark_mask.sum()),
           "max_jacobian_error": opts.max_jacobian_error, "errors": {}, "seconds": {}}
    for name, (fn, J) in validator.analytic_frame_jacobians(state, data).items():
        t0 = time.perf_counter()
        try:
            res["errors"][name] = validator.validate(fn, J, state, data, opts)
        except AssertionError as e:
            fail(f"validator: the {name} Jacobian: {e}")
        res["seconds"][name] = time.perf_counter() - t0
    print(f"validator on the main drive's last window ({res['frames']} keyframes in "
          f"K={res['K']} slots, {res['landmarks']} of L={res['L']} landmarks, "
          f"{res['dtype']} on {res['device']}), largest |analytic - autodiff| against "
          f"max_jacobian_error {opts.max_jacobian_error:g}: " + ", ".join(
              f"{k} {v:.3e} ({res['seconds'][k]:.1f} s)" for k, v in res["errors"].items()),
          flush=True)
    return res


def bench_bearing_scene(n_frames: int) -> dict:
    """The bench scene (wave scene seed 3, 500 landmarks) as bearings for
    the `SyntheticTracker`, in `object_scene.drive`'s format: each
    frame's landmarks in front of the camera and inside the 752x480
    image (focal 458), with 0.5 px of seeded pixel noise, in at most the
    image tracker's 256 slots."""
    import torch

    from xrslam_tpu_torch.io.synthetic import bearings_of, euler_consistent, wave_scene
    from xrslam_tpu_torch.tools.make_dataset import camera_extrinsics

    width, height, focal, noise_px = 752, 480, 458.0, 0.5
    q_bc, p_bc = camera_extrinsics()
    scene = euler_consistent(wave_scene(n_frames=n_frames, n_landmarks=500, seed=3))
    b, mask = bearings_of(scene, torch.as_tensor(q_bc), torch.as_tensor(p_bc))
    b, mask = b.numpy().copy(), mask.numpy().copy()
    z = np.where(b[..., 2] > 1e-9, b[..., 2], 1e-9)
    u = focal * b[..., 0] / z + width / 2
    v = focal * b[..., 1] / z + height / 2
    mask &= (b[..., 2] > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    nz = np.random.default_rng(5).normal(0.0, noise_px / focal, b[..., :2].shape)
    b[..., :2] += nz * b[..., 2:3]
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    return {"scene": scene, "bearings": b, "mask": mask, "capacity": 256}


def checkpoint_bearing_run(parsac_flag: bool, n_frames: int, cut, dev, path=None) -> dict:
    """The bench scene's first `n_frames` frames as bearings through the
    `SyntheticTracker` at the dataset's slam config: straight through
    (`cut` None), or to frame `cut`, saved to `path`, restored onto `dev`
    with the tracker's hint map carried over, and finished. Launch
    counts are set to 0 first."""
    import torch

    from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import object_scene as osc
    from xrslam_tpu_torch.tools.make_dataset import sequence_config
    from xrslam_tpu_torch.utils import checkpoint

    dev = torch.device(dev)
    scene = bench_bearing_scene(n_frames)
    cfg = sequence_config(752, 480, 458.0).replace(parsac_flag=parsac_flag)
    build.reset_launch_counts()
    pipe = VIOPipeline(cfg, SyntheticTracker(device=dev), device=dev)
    res = {}
    if cut is None:
        t, p = osc.drive(pipe, scene)
    else:
        osc.drive(pipe, scene, max_frames=cut)
        if pipe.swt is None:
            fail(f"checkpoint: the bearing run did not initialize by frame {cut}")
        t0 = time.perf_counter()
        checkpoint.save_pipeline(path, pipe)
        res["save_s"] = time.perf_counter() - t0
        res["file_bytes"] = os.path.getsize(path)
        tracker = SyntheticTracker(device=dev)
        tracker._id_map = dict(pipe.tracker._id_map)
        t0 = time.perf_counter()
        pipe = checkpoint.load_pipeline(path, cfg, tracker, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res["load_s"] = time.perf_counter() - t0
        res["restored_on"] = str(pipe.swt.bin_conf.device)
        t, p = osc.drive(pipe, scene, start=cut)
    swt = pipe.swt
    res.update(t=t, p=p, bin_conf=swt.bin_conf.cpu().numpy(),
               bin_conf_2d2d=swt.bin_conf_2d2d.cpu().numpy(), m_th=swt.m_th,
               judge_true=swt.stats["judge_true"],
               launches={k.name: k.launches for k in build.KERNELS})
    return res


def checkpoint_bearing_worker(parsac_flag: bool, n_frames: int, cut, dev: str,
                              path) -> dict:
    """One bearing-fed checkpoint run, in a process of its own."""
    import torch

    torch.set_num_threads(1)
    return checkpoint_bearing_run(parsac_flag, n_frames, cut, dev, path)


def compare_bearing_runs(what: str, straight: dict, resumed: dict, t_cut: float,
                         parsac_flag: bool, n_frames: int, cut: int) -> dict:
    """The resumed tail against the straight run's, matched by time from
    the cut's frame on (with deferred write-backs the first output after
    the cut is the anchor at that frame): positions within
    CKPT_TAIL_TOL_M; with PARSAC both stages' bin confidences and m_th
    within CKPT_STATE_TOL."""
    ref = {float(t): p for t, p in zip(straight["t"], straight["p"]) if t >= t_cut}
    out = {float(t): p for t, p in zip(resumed["t"], resumed["p"])}
    if not ref or set(ref) != set(out):
        fail(f"checkpoint {what}: the resumed run tracked frames at {sorted(out)}, the "
             f"straight run at {sorted(ref)}")
    res = {"tail_frames": len(ref),
           "tail_err_m": max(float(np.linalg.norm(ref[t] - out[t])) for t in ref),
           "file_bytes": resumed["file_bytes"], "save_s": resumed["save_s"],
           "load_s": resumed["load_s"], "restored_on": resumed["restored_on"],
           "launches": {k: straight["launches"][k] + resumed["launches"][k]
                        for k in straight["launches"]}}
    bad = res["tail_err_m"] > CKPT_TAIL_TOL_M
    if parsac_flag:
        res.update(judge_true=straight["judge_true"], state_err={
            k: float(np.max(np.abs(np.asarray(straight[k]) - np.asarray(resumed[k]))))
            for k in ("bin_conf", "bin_conf_2d2d", "m_th")})
        bad |= max(res["state_err"].values()) > CKPT_STATE_TOL
    print(f"checkpoint, {what}: cut at frame {cut} of {n_frames}, file "
          f"{res['file_bytes']} bytes, save {res['save_s'] * 1e3:.1f} ms, load onto "
          f"{res['restored_on']} {res['load_s'] * 1e3:.1f} ms; resumed tail "
          f"{res['tail_frames']} frames, largest |dp| {res['tail_err_m']:.3e} m (limit "
          f"{CKPT_TAIL_TOL_M:g})" + (f"; judge True {res['judge_true']} times; |d bin_conf| "
                                    f"{res['state_err']['bin_conf']:.3e}, |d bin_conf_2d2d| "
                                    f"{res['state_err']['bin_conf_2d2d']:.3e}, |d m_th| "
                                    f"{res['state_err']['m_th']:.3e} (limit "
                                    f"{CKPT_STATE_TOL:g})" if parsac_flag else "")
          + f"; launches {res['launches']}", flush=True)
    if bad:
        fail(f"checkpoint {what}: the resumed run differs from the straight run")
    if res["launches"]["reproj_gram"] == 0 or res["launches"]["klt_level"] != 0:
        fail(f"checkpoint {what}: launches {res['launches']} (K2 must run, K1 not)")
    return res


def checkpoint_image_run(dev, seq, path: str, cut: int = CKPT_IMAGE_CUT,
                         n_frames: int = CKPT_IMAGE_FRAMES, min_tracked: int = 45) -> dict:
    """The main path's image stream through `api.XRSLAM` to frame `cut`,
    saved, restored onto `dev` in a fresh engine (whose image tracker
    re-detects keypoints on the first frame) and played to `n_frames`;
    held to the main drive's limits and kernel checks."""
    import torch

    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools.make_dataset import ate, run_sequence
    from xrslam_tpu_torch.utils import checkpoint

    cfg = seq["config"]
    build.reset_launch_counts()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls:
        slam = api.XRSLAM(config=cfg, device=dev)
        ts1, ps1 = run_sequence(api, slam, seq, stop=cut)
        if slam.pipeline.swt is None:
            fail(f"checkpoint image run: not tracking at frame {cut}")
        t0 = time.perf_counter()
        checkpoint.save_pipeline(path, slam.pipeline)
        save_s = time.perf_counter() - t0
        resumed = api.XRSLAM(config=cfg, device=dev)
        t0 = time.perf_counter()
        resumed.pipeline = checkpoint.load_pipeline(path, cfg, resumed.pipeline.tracker,
                                                    device=dev, times=resumed.times)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        ts2, ps2 = run_sequence(api, resumed, seq, start=cut, stop=n_frames)
    ts, ps = np.concatenate([ts1, ts2]), np.concatenate([ps1, ps2])
    res = {"frames": n_frames, "cut": cut, "frames_tracked": len(ts),
           "tracked_before_cut": len(ts1), "ate_m": ate(seq, ts, ps),
           "ate_after_cut_m": ate(seq, ts2, ps2), "file_bytes": os.path.getsize(path),
           "save_s": save_s, "load_s": load_s,
           "launches": {k.name: k.launches for k in build.KERNELS},
           "entry_launches": {k.name: dict(k.entry_launches) for k in build.KERNELS},
           "frame_pairs_tracked": pairs[0], "scharr_calls": scharr_calls[0]}
    print(f"checkpoint, image run (752x480): cut at frame {cut}, file {res['file_bytes']} "
          f"bytes, save {save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms; "
          f"{res['frames_tracked']}/{n_frames} tracked ({len(ts1)} before the cut), ATE "
          f"{res['ate_m']:.4f} m ({res['ate_after_cut_m']:.4f} m after the cut), launches "
          f"{res['launches']} over {res['frame_pairs_tracked']} frame pairs", flush=True)
    check_image_path(res, "checkpoint image run", min_tracked=min_tracked)
    check_ate(res, "checkpoint image run")
    return res


def checkpoint_phase(dev, seq, out_dir: str, frames: int = CKPT_FRAMES,
                     cut: int = CKPT_CUT, image_frames: int = CKPT_IMAGE_FRAMES,
                     image_cut: int = CKPT_IMAGE_CUT, min_image_tracked: int = 45) -> dict:
    """Checkpoint/resume on the card: the bearing-fed runs of `frames`
    frames with PARSAC off and on (straight, and cut at `cut` + resumed:
    four drives in processes of their own) beside the image run of
    `seq` (cut at `image_cut`, played to `image_frames`) in this
    process."""
    import concurrent.futures
    import multiprocessing

    runs = [(flag, c) for flag in (False, True) for c in (None, cut)]
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(runs), mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(checkpoint_bearing_worker, flag, frames, c, str(dev),
                               os.path.join(out_dir, f"bearings_{flag:d}.npz"))
                   for flag, c in runs]
        image = checkpoint_image_run(dev, seq, os.path.join(out_dir, "images.npz"),
                                     cut=image_cut, n_frames=image_frames,
                                     min_tracked=min_image_tracked)
        done = [f.result(timeout=OBJECT_TIMEOUT_S) for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    t_cut = float(bench_bearing_scene(frames)["scene"].t[cut - 1])
    return {"bearings": compare_bearing_runs("bearings, PARSAC off", done[0], done[1],
                                             t_cut, False, frames, cut),
            "parsac": compare_bearing_runs("bearings, PARSAC on", done[2], done[3],
                                           t_cut, True, frames, cut),
            "image": image}


def bench_phase(dev, out_dir: str, frames: int = BENCH_FRAMES, width: int = 752,
                height: int = 480, focal: float = 458.0,
                min_share: float = BENCH_MIN_TRACKED_SHARE, schedule: str = "sync") -> dict:
    """`tools.bench_pipeline` at the main path's geometry under
    `schedule`, one timed pass of `frames` frames and no warm-up, with
    the launch counts reset before and read after; its JSON line must
    parse, at least `min_share` of the frames tracked, ATE <= 0.25 m, and
    both kernels launched as in the main drive. The result keeps the
    pass (`run`: output times, positions, final window)."""
    import io
    import math

    import torch

    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import bench_pipeline

    argv = ["--frames", str(frames), "--width", str(width), "--height", str(height),
            "--focal", str(focal), "--passes", "1", "--warmup", "0", "--dir", out_dir,
            "--device", torch.device(dev).type, "--schedule", schedule]
    buf = io.StringIO()
    build.reset_launch_counts()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls, contextlib.redirect_stdout(buf):
        _, run = bench_pipeline.bench(argv)
    line = buf.getvalue().strip().splitlines()[-1]
    print("bench_pipeline " + " ".join(argv) + ": " + line, flush=True)
    try:
        res = json.loads(line)
    except json.JSONDecodeError as e:
        fail(f"benchmark: its line does not parse ({e}): {line}")
    res.update(ate_m=res["ate_rmse_m"], launches={k.name: k.launches for k in build.KERNELS},
               entry_launches={k.name: dict(k.entry_launches) for k in build.KERNELS},
               frame_pairs_tracked=pairs[0], scharr_calls=scharr_calls[0],
               run={k: run[k] for k in ("ts", "ps", "window")})
    what = "benchmark" + ("" if schedule == "sync" else f", {schedule}")
    check_image_path(res, what, min_tracked=math.ceil(min_share * frames))
    check_ate(res, what)
    return res


def compare_windows(what: str, a: list, b: list) -> float:
    """Largest |difference| of q, p, v over two final windows (lists of
    (t, q, p, v)), which must hold the same frames; fails beyond
    SCHEDULE_WINDOW_TOL."""
    if [w[0] for w in a] != [w[0] for w in b] or not a:
        fail(f"{what}: the final windows hold frames at {[w[0] for w in a]} and "
             f"{[w[0] for w in b]}")
    err = max(float(np.max(np.abs(np.asarray(x[i]) - np.asarray(y[i]))))
              for x, y in zip(a, b) for i in (1, 2, 3))
    if not err <= SCHEDULE_WINDOW_TOL:
        fail(f"{what}: the final windows differ by {err} (> {SCHEDULE_WINDOW_TOL})")
    return err


def schedule_bearing_run(dev, overlap: bool, frames: int = CKPT_FRAMES) -> dict:
    """The checkpoint phase's bearing scene (60 frames, the dataset's
    slam config), PARSAC on, straight or with `worker_overlap`; then
    `flush`. Launch counts set to 0 first; device syncs counted by
    torch's sync debug mode in every frame's processing and the flush."""
    import torch

    from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import object_scene as osc
    from xrslam_tpu_torch.tools.make_dataset import sequence_config

    dev = torch.device(dev)
    scene = bench_bearing_scene(frames)
    cfg = sequence_config(752, 480, 458.0).replace(parsac_flag=True, worker_overlap=overlap)
    build.reset_launch_counts()
    pipe = VIOPipeline(cfg, SyntheticTracker(device=dev), device=dev)
    with counting_syncs(VIOPipeline, ("_process_frame", "flush")) as syncs:
        t, _ = osc.drive(pipe, scene)
        pipe.flush()
    if pipe.swt is None:
        fail(f"schedules: the bearing run (worker_overlap={overlap}) is not tracking")
    return {"tracked": len(t), "frames": frames, "syncs_per_frame": syncs[0] / frames,
            "window": [(f.t, f.q, f.p, f.v) for f in pipe.swt.map.all_frames()],
            "launches": {k.name: k.launches for k in build.KERNELS}}


def schedule_bearing_worker(overlap: bool, frames: int, dev: str) -> dict:
    """One bearing drive of phase 12b, in a process of its own."""
    import torch

    torch.set_num_threads(1)
    return schedule_bearing_run(dev, overlap, frames)


def warm_bench_worker(dev: str, out_dir: str, warm_dir: str, ready, gate, frames: int,
                      schedule: str) -> dict | None:
    """A benchmark pass of phase 12b (`schedule` "pipelined") or 12c
    ("chained") in a process of its own: a WARM_FRAMES pass to warm the
    process (as the main drive warms the one phase 12 runs in), then
    `ready` is set, and the counted pass of `frames` frames runs once
    "go" comes through the `gate` queue (None on "stop")."""
    import io

    import torch

    from xrslam_tpu_torch.tools import bench_pipeline

    with contextlib.redirect_stdout(io.StringIO()):
        bench_pipeline.main(["--frames", str(WARM_FRAMES), "--width", "752", "--height",
                             "480", "--focal", "458", "--passes", "1", "--warmup", "0",
                             "--dir", warm_dir, "--device", torch.device(dev).type,
                             "--schedule", schedule])
    ready.set()
    if gate.get(timeout=OBJECT_TIMEOUT_S) != "go":
        return None
    return bench_phase(dev, out_dir, frames=frames, schedule=schedule)


def start_schedules(dev, out_dir: str, frames: int = BENCH_FRAMES,
                    bearing_frames: int = CKPT_FRAMES) -> dict:
    """Phase 12b's and 12c's drives, each in a process of its own: the
    pipelined and the chained benchmark passes (on phase 12's rendered
    scene, rendered here first), which warm up and then wait for
    `release_schedules`, and the two bearing drives, which run at once.
    Returns the pool, the manager, the warm-up events, the gate and the
    futures (pipelined pass, bearings straight, bearings overlapped,
    chained pass); `stop_schedules` ends them."""
    import concurrent.futures
    import multiprocessing

    from xrslam_tpu_torch.tools.bench_pipeline import dataset_dir
    from xrslam_tpu_torch.tools.make_dataset import render_dataset

    ds = dataset_dir(out_dir, frames, 500, 752, 480, 458.0)
    render_dataset(ds, n_frames=frames, n_landmarks=500, width=752, height=480, focal=458.0)
    ctx = multiprocessing.get_context("spawn")
    manager = ctx.Manager()
    ready = {s: manager.Event() for s in ("pipelined", "chained")}
    gate = manager.Queue()
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=4, mp_context=ctx)
    futures = {s: pool.submit(warm_bench_worker, str(dev), out_dir, f"{out_dir}_warm_{s}",
                              ready[s], gate, frames, s) for s in ready}
    futures = [futures["pipelined"]] + [
        pool.submit(schedule_bearing_worker, o, bearing_frames, str(dev))
        for o in (False, True)] + [futures["chained"]]
    return {"pool": pool, "manager": manager, "ready": ready, "gate": gate,
            "futures": futures}


def release_schedules(started: dict) -> None:
    """Waits until both image processes of `start_schedules` are warm,
    then lets their counted passes start, so that they run side by side
    with phase 12's, started right after this under the same load."""
    for s, ev in started["ready"].items():
        if not ev.wait(OBJECT_TIMEOUT_S):
            fail(f"schedules: the {s} benchmark process did not warm up")
    for _ in started["ready"]:
        started["gate"].put("go")


def stop_schedules(started: dict) -> None:
    """Ends `start_schedules`'s processes: image passes not yet released
    get "stop" (a released one runs to its end)."""
    for _ in started["ready"]:
        started["gate"].put("stop")
    started["pool"].shutdown(wait=True, cancel_futures=True)
    started["manager"].shutdown()


def schedules_phase(sync_bench: dict, pipe: dict, straight: dict, overlap: dict) -> dict:
    """Phase 12b's checks. (a) the pipelined benchmark pass (`pipe`,
    `bench_phase` with schedule "pipelined": its own limits and kernel
    checks held there) against phase 12's synchronous pass: frames
    tracked within 1, the same last output time, the final window after
    flush within SCHEDULE_WINDOW_TOL, positions on common output times
    within SCHEDULE_POS_TOL_M. (b) the bearing scene with PARSAC under
    `worker_overlap` against the straight drive (`schedule_bearing_run`):
    the final window within SCHEDULE_WINDOW_TOL, K2 launched and K1 not
    in both; device syncs a frame printed for both."""
    s_run, p_run = sync_bench["run"], pipe["run"]
    if abs(len(s_run["ts"]) - len(p_run["ts"])) > 1:
        fail(f"schedules: pipelined tracked {len(p_run['ts'])} frames, sync "
             f"{len(s_run['ts'])}")
    if not len(p_run["ts"]) or s_run["ts"][-1] != p_run["ts"][-1]:
        fail("schedules: the last output times differ")
    win_err = compare_windows("schedules, pipelined vs sync", s_run["window"],
                              p_run["window"])
    idx = {t: i for i, t in enumerate(p_run["ts"].tolist())}
    common = [(i, idx[t]) for i, t in enumerate(s_run["ts"].tolist()) if t in idx]
    pos_err = max(float(np.linalg.norm(s_run["ps"][i] - p_run["ps"][j])) for i, j in common)
    if not pos_err < SCHEDULE_POS_TOL_M:
        fail(f"schedules: positions on common output times differ by {pos_err} m "
             f"(>= {SCHEDULE_POS_TOL_M})")
    res = {"pipelined": {k: v for k, v in pipe.items() if k != "run"},
           "window_err": win_err, "pos_err_m": pos_err, "common_outputs": len(common)}
    for name, r in (("sync", sync_bench), ("pipelined", pipe)):
        print(f"schedules, {name}: {r['frames_per_s']:.3f} frames/s, latency median "
              f"{r['latency_ms']['median']:.1f} ms, p90 {r['latency_ms']['p90']:.1f} ms, "
              f"{r['frames_tracked']}/{r['frames']} tracked, ATE {r['ate_rmse_m']:.4f} m",
              flush=True)
    print(f"schedules, pipelined vs sync: final window |d| {win_err:.3e} (limit "
          f"{SCHEDULE_WINDOW_TOL:g}), positions on {len(common)} common outputs "
          f"|dp| {pos_err:.3e} m (limit {SCHEDULE_POS_TOL_M:g}); launches "
          f"{pipe['launches']}", flush=True)
    res["bearings_window_err"] = compare_windows(
        "schedules, bearings with PARSAC, overlap vs straight", straight["window"],
        overlap["window"])
    for name, r in (("straight", straight), ("overlap", overlap)):
        if r["launches"]["reproj_gram"] == 0 or r["launches"]["klt_level"] != 0:
            fail(f"schedules, bearings {name}: launches {r['launches']} (K2 must run, K1 not)")
        res[f"bearings_{name}"] = {k: v for k, v in r.items() if k != "window"}
    print(f"schedules, bearings with PARSAC ({straight['frames']} frames): final window "
          f"|d| {res['bearings_window_err']:.3e} (limit {SCHEDULE_WINDOW_TOL:g}); device "
          f"syncs a frame {straight['syncs_per_frame']:.2f} straight, "
          f"{overlap['syncs_per_frame']:.2f} overlapped; tracked {straight['tracked']} and "
          f"{overlap['tracked']}", flush=True)
    return res


def chained_phase(sync_bench: dict, pipe: dict, chained: dict) -> dict:
    """Phase 12c's checks of the chained benchmark pass (`bench_phase`
    with schedule "chained": its share tracked, ATE and kernel checks
    held there): the chained route carried every tracked frame pair after
    the first two, less the re-seeds its tracker reports, and K1 launched
    once for each frame pair dispatched by either route. Prints it beside
    phase 12's and 12b(a)'s passes."""
    from xrslam_tpu_torch.frontend import klt

    routes = chained["tracker_routes"]
    pairs = chained["frame_pairs_tracked"]
    k1 = chained["entry_launches"]["klt_level"][klt.ENTRY_TRACK]
    if routes["chained_frames"] < pairs - 2 - routes["reseeds"]:
        fail(f"chained: the chained route took {routes['chained_frames']} of {pairs} frame "
             f"pairs ({routes['reseeds']} re-seeds)")
    if not routes["chained_frames"] <= k1 <= routes["chained_frames"] \
            + routes["standard_frames"] - 1:
        fail(f"chained: K1 launched {k1} times for routes {routes}")
    res = {k: v for k, v in chained.items() if k != "run"}
    for name, r in (("sync", sync_bench), ("pipelined", pipe), ("chained", chained)):
        st = r["timings_ms"]
        print(f"chained (12c), {name} pass: {r['frames_per_s']:.3f} frames/s, latency median "
              f"{r['latency_ms']['median']:.1f} ms, p90 {r['latency_ms']['p90']:.1f} ms, "
              f"{r['frames_tracked']}/{r['frames']} tracked, ATE {r['ate_rmse_m']:.4f} m; "
              f"tracker preprocess {st.get('tracker_preprocess_time', 0.0):.2f}, dispatch "
              f"{st.get('tracker_dispatch_time', 0.0):.2f}, fetch "
              f"{st.get('tracker_fetch_time', 0.0):.2f} ms; routes {r['tracker_routes']}",
              flush=True)
    print(f"chained (12c): K1 launches {k1} for {pairs} frame pairs; launches "
          f"{chained['launches']}", flush=True)
    return res


def ab_tools_phase(dev) -> dict:
    """The three A/B tools on the card, once each with AB_REPS
    repetitions, the launch counts set to 0 before each and read after:
    `ab_assemble` at AB_ASSEMBLE_SIZES, `ab_lk_backend` and
    `ab_klt_precision` on the rendered 752x480 pair. Fails unless every
    route of the tool's ROUTES ran and each route's own `agree` and the
    line's are true: the assembled systems within rtol/atol 1e-9, the KLT
    routes within the plain one's status on >= 99% of the slots and 1e-3
    px, the f32 survivors within 1% of the f64 ones and 1e-3 px; prints
    each tool's JSON line."""
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import ab_assemble, ab_klt_precision, ab_lk_backend

    tools = {"ab_assemble": (ab_assemble, lambda: [ab_assemble.run(K, L, reps=AB_REPS,
                                                                   device=dev)
                                                   for K, L in AB_ASSEMBLE_SIZES]),
             "ab_lk_backend": (ab_lk_backend,
                               lambda: [ab_lk_backend.run(reps=AB_REPS, device=dev)]),
             "ab_klt_precision": (ab_klt_precision,
                                  lambda: [ab_klt_precision.run(reps=AB_REPS, device=dev)])}
    out = {}
    for name, (tool, fn) in tools.items():
        build.reset_launch_counts()
        lines = fn()
        out[name] = {"lines": lines, "launches": {k.name: k.launches for k in build.KERNELS}}
        for line in lines:
            print(f"{name}: {json.dumps(line)}", flush=True)
            if any(not isinstance(line.get(r), dict) for r in tool.ROUTES):
                fail(f"{name}: a route did not run: {line}")
            if line.get("agree") is not True or \
                    any(line[r].get("agree") is not True for r in tool.ROUTES):
                fail(f"{name}: the routes disagree: {line}")
        print(f"{name}: launches {out[name]['launches']}", flush=True)
    return out


# K2's batch axis: the subframe path's window (SlidingWindowTracker.K_sub:
# 1 + max(ROT_MERGE_TRIGGER 9, subframe size 3) + 1) at 4 windows
K_SUB = 11
K2_BATCH = 4
CAPI_FRAMES = 45  # cut from 60 for the script's time (PERF.md section 4)
ROS_FRAMES = 20
# cut from 4 when the script took 980.3 s on a slower host, past the
# 897.8 s it took before phase 7b (PERF.md section 4)
MULTISEQ_N = 2
MULTISEQ_FRAMES = 45  # cut from 60 for the script's time (PERF.md section 4)
MULTISEQ_TOL = 1e-9
# the main drive's tracker per frame with the Python spacing filter (PERF.md
# section 5)
TRACKER_MS_PYTHON_FILTER = 43.7


def factor_gram_batch_phase(dev) -> dict:
    """K2's fused entry on a batch of 4 windows (K_sub=11, L=384, f64,
    seeded `reproj_window`s) in one call: against its plain version at
    rtol/atol 1e-9, each row bit-equal to a single-window call on that
    window, the N=1 batch bit-equal to the single-window call; timed
    beside 4 single calls."""
    import torch

    from xrslam_tpu_torch.estimation import factors, gram
    from xrslam_tpu_torch.io.synthetic import reproj_window
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.utils.tree import tree_map

    K, L, N = K_SUB, 384, K2_BATCH
    pairs = [reproj_window(K, L, seed=s, dtype=torch.float64, device=dev)
             for s in range(2, 2 + N)]

    def stack(trees):
        return tree_map(lambda *x: torch.stack(x), *trees)

    state, data = stack([p[0] for p in pairs]), stack([p[1] for p in pairs])
    before = (build.REPROJ_GRAM.launches, dict(build.REPROJ_GRAM.batched))
    out = gram.reproj_factor_gram_cuda(state, data)
    launches = build.REPROJ_GRAM.launches - before[0]
    batched = build.REPROJ_GRAM.batched["windows"] - before[1]["windows"]
    plain = gram.reproj_factor_gram_plain(state, data)
    singles = [gram.reproj_factor_gram_cuda(s, d) for s, d in pairs]
    one = gram.reproj_factor_gram_cuda(tree_map(lambda x: x[:1], state),
                                       tree_map(lambda x: x[:1], data))
    torch.cuda.synchronize()
    names = GRAM_NAMES + ["cost"]
    if launches != 1 or batched != N:
        fail(f"K2 batched: one call counted {launches} launches for {batched} windows")
    res = {"N": N, "K": K, "L": L, "grid": [*gram.grid(K, L), N]}
    res["max_abs_err"] = check_close("K2 batched vs plain", names, plain, out, 1e-9)
    for i, single in enumerate(singles):
        for n, a, b in zip(names, single, out):
            if not torch.equal(a, b[i]):
                fail(f"K2 batched: row {i} {n} differs from the single-window call "
                     f"(max |Δ| {float((a - b[i]).abs().max()):.3e})")
    for n, a, b in zip(names, singles[0], one):
        if not torch.equal(a, b[0]):
            fail(f"K2 batched: the N=1 call's {n} differs from the single-window call")
    check_repeat("K2 batched", lambda: gram.reproj_factor_gram_cuda(state, data))
    res.update(timed_pair(lambda: gram.reproj_factor_gram_cuda(state, data),
                          lambda: gram.reproj_factor_gram_plain(state, data)))

    def four():
        for s_, d_ in pairs:
            gram.reproj_factor_gram_cuda(s_, d_)

    f1 = cuda_ms(four, reps=100)
    f2 = cuda_ms(four, reps=100)
    res["four_single_ms"] = (f1 + f2) / 2
    res["four_single_device_ms"] = device_ms(four)
    n_act = sum(int(factors._active_mask(d).sum()) for _, d in pairs)
    res["active_observations"] = n_act
    ins = (state.q, state.p, state.inv_depth, data.q_bc, data.p_bc, data.bearings,
           data.obs_mask, data.ref_idx, data.sqrt_inv_cov2, data.landmark_mask)
    res.update(bound(nbytes(*ins, *out),
                     n_act * (FACTOR_FLOPS + GRAM_FLOPS_ALL + GRAM_FLOPS_ANCHORED)
                     + (N * K * L - n_act) * 8 * 3, state.p.element_size()))
    print(f"K2 reproj_factor_gram batched (N={N} windows, K={K}, L={L}, f64, grid "
          f"{res['grid']}): max |Δ| {res['max_abs_err']:.3e} vs plain (rtol/atol 1e-9), "
          f"every row bit-equal to its single-window call, N=1 bit-equal to the "
          f"single-window call, repeat bit-equal, 1 call = 2 launches; per call "
          f"{res['ms']:.4f} ms (device alone {res['device_ms']}), plain "
          f"{res['plain_ms']:.4f} ms, 4 single calls {res['four_single_ms']:.4f} ms "
          f"(device alone {res['four_single_device_ms']}), bound "
          f"{res['bound_ms'] * 1e3:.3f} us by {res['bound_by']}", flush=True)
    return res


def native_phase(drive: dict) -> dict:
    """The native host runtime on the main drive: the library built and
    `poisson_filter` called at least once per tracked frame pair (the
    track path's filter; the detection's runs beside it); on the drive's
    recorded inputs, its accept masks equal the Python `_poisson_accept`
    and both are timed; the tracker's stage split."""
    from xrslam_tpu_torch import native
    from xrslam_tpu_torch.frontend.tracker import _poisson_accept

    info = native.build_info()
    if not info.get("library"):
        fail("native runtime: the library was not built")
    calls, pairs = drive["native_calls"]["poisson_filter"], drive["frame_pairs_tracked"]
    if calls < pairs:
        fail(f"native runtime: poisson_filter called {calls} times for {pairs} tracked "
             "frame pairs")
    args = drive.pop("poisson_args")
    t_nat = t_py = 0.0
    for a, kw in args:
        t0 = time.perf_counter()
        got = native.poisson_filter(*a, **kw)
        t1 = time.perf_counter()
        ref = _poisson_accept(*a, **kw)
        t_py += time.perf_counter() - t1
        t_nat += t1 - t0
        if not np.array_equal(got, ref):
            fail("native runtime: poisson_filter disagrees with _poisson_accept on a "
                 "call of the main drive")
    sm = drive["stage_ms"]
    split = {k: sm.get(k, float("nan")) for k in (
        "tracker_preprocess_time", "tracker_dispatch_time", "tracker_fetch_time",
        "feature_tracker_time")}
    split["rest"] = split["feature_tracker_time"] - sum(
        split[k] for k in ("tracker_preprocess_time", "tracker_dispatch_time",
                           "tracker_fetch_time"))
    res = {"build": {k: info[k] for k in ("library", "cached", "seconds")},
           "poisson_calls": calls, "frame_pairs_tracked": pairs,
           "checked_calls": len(args), "native_ms": t_nat / max(len(args), 1) * 1e3,
           "python_ms": t_py / max(len(args), 1) * 1e3, "tracker_split_ms": split}
    print(f"native runtime: {os.path.basename(info['library'])} built in "
          f"{info['seconds']:.1f} s; poisson_filter {calls} calls over {pairs} tracked "
          f"frame pairs, equal to _poisson_accept on all {len(args)} recorded calls, "
          f"{res['native_ms']:.4f} ms a call against {res['python_ms']:.4f} ms in "
          f"Python; tracker per frame (ms): preprocess "
          f"{split['tracker_preprocess_time']:.2f}, dispatch "
          f"{split['tracker_dispatch_time']:.2f}, fetch {split['tracker_fetch_time']:.2f}, "
          f"rest {split['rest']:.2f}, total {split['feature_tracker_time']:.2f} (with the "
          f"Python filter: {TRACKER_MS_PYTHON_FILTER} total)", flush=True)
    return res


class CapiEngine:
    """`api.XRSLAM`'s push/run/result surface over the port's C ABI shim
    loaded with ctypes, so that `make_dataset.run_sequence` drives the C
    entry points (XRSLAMPushSensorData, XRSLAMRunOneFrame,
    XRSLAMGetResult)."""

    def __init__(self, lib):
        import ctypes

        class Vec3(ctypes.Structure):  # XRSLAMAcceleration / XRSLAMGyroscope
            _fields_ = [("data", ctypes.c_double * 3), ("timestamp", ctypes.c_double)]

        class Image(ctypes.Structure):  # XRSLAMImage
            _fields_ = [("data", ctypes.c_void_p), ("timeStamp", ctypes.c_double),
                        ("stride", ctypes.c_int), ("camera_id", ctypes.c_int),
                        ("channel", ctypes.c_int), ("ext", ctypes.c_void_p)]

        class Pose(ctypes.Structure):  # XRSLAMPose
            _fields_ = [("quaternion", ctypes.c_double * 4),
                        ("translation", ctypes.c_double * 3),
                        ("timestamp", ctypes.c_double)]

        self.ct, self.lib = ctypes, lib
        self.Vec3, self.Image, self.Pose = Vec3, Image, Pose
        lib.XRSLAMPushSensorData.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.XRSLAMGetResult.argtypes = [ctypes.c_int, ctypes.c_void_p]

    def push_sensor_data(self, kind, t, data) -> None:
        from xrslam_tpu_torch import api

        ct = self.ct
        if kind == api.SensorType.CAMERA:
            img = np.ascontiguousarray(np.round(np.asarray(data) * 255.0).astype(np.uint8))
            msg = self.Image(img.ctypes.data, t, img.shape[1], 0, 1, None)
        else:
            msg = self.Vec3((ct.c_double * 3)(*[float(v) for v in data]), t)
        self.lib.XRSLAMPushSensorData(int(kind), ct.byref(msg))

    def run_one_frame(self) -> None:
        self.lib.XRSLAMRunOneFrame()

    def flush(self) -> None:
        """The C surface has none: XRSLAMDestroy flushes."""

    def get_result(self, rt):
        from types import SimpleNamespace

        from xrslam_tpu_torch import api

        if rt == api.ResultType.STATE:
            st = self.ct.c_int(-1)
            self.lib.XRSLAMGetResult(int(rt), self.ct.byref(st))
            return api.State(st.value)
        pose = self.Pose()
        self.lib.XRSLAMGetResult(int(rt), self.ct.byref(pose))
        return SimpleNamespace(timestamp=pose.timestamp,
                               quaternion=np.array(pose.quaternion),
                               translation=np.array(pose.translation))


def capi_phase(dev, seq, dataset: dict, out_dir: str, n_frames: int = CAPI_FRAMES) -> dict:
    """The port's C ABI: the shim (`native.build_capi`) loaded with
    ctypes into this process drives the main scene's first `n_frames`
    frames through XRSLAMCreate (the dataset drive's YAML pair, device
    $XRSLAM_TORCH_DEVICE, the card by default), XRSLAMPushSensorData,
    XRSLAMRunOneFrame and XRSLAMGetResult; fails unless half of the
    frames after the backend's start tracked, ATE <= 0.25 m and both
    kernels launched as in the main drive. Then `tests/data/capi_roundtrip.c`,
    compiled against native/XRSLAM.h and the shim, runs as a process of
    its own on the card and must print every CAPI_* line."""
    import ctypes
    import math
    import shutil
    import site

    from xrslam_tpu_torch import api, capi_host, native
    from xrslam_tpu_torch.frontend import image as img_ops
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools import multiseq
    from xrslam_tpu_torch.tools.make_dataset import ate, run_sequence

    import torch

    dev_type = torch.device(dev).type  # the card; the CPU only in a rehearsal
    os.environ[capi_host.DEVICE_ENV] = dev_type
    t0 = time.perf_counter()
    info = native.build_capi()
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(info["library"])
    lib.XRSLAMCreate.argtypes = [ctypes.c_char_p] * 4 + [ctypes.c_void_p]
    lib.XRSLAMGetLastError.restype = ctypes.c_char_p
    paths = dataset["paths"]
    if lib.XRSLAMCreate(paths["slam_yaml"].encode(), paths["device_yaml"].encode(),
                        None, None, None) != 1:
        fail(f"C ABI: XRSLAMCreate failed: {lib.XRSLAMGetLastError().decode()}")
    engine_dev = str(capi_host._engine.device)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with counting(klt, "track_keypoints") as pairs, \
            counting(img_ops, "scharr") as scharr_calls:
        ts, ps = run_sequence(api, CapiEngine(lib), seq, max_frames=n_frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lib.XRSLAMDestroy()
    res = {"frames": n_frames, "frames_tracked": len(ts), "ate_m": ate(seq, ts, ps),
           "seconds": seconds, "frames_per_s": n_frames / seconds, "device": engine_dev,
           "shim": os.path.basename(info["library"]), "build_s": build_s,
           "links_libpython": info["links_libpython"],
           "launches": {k.name: k.launches for k in build.KERNELS},
           "entry_launches": {k.name: dict(k.entry_launches) for k in build.KERNELS},
           "frame_pairs_tracked": pairs[0], "scharr_calls": scharr_calls[0]}
    need = math.ceil((n_frames - multiseq.BACKEND_START) / 2)
    h, w = seq["images"].shape[1:3]
    print(f"C ABI drive ({res['shim']}, built in {build_s:.1f} s, in this process on "
          f"{engine_dev}; {w}x{h}, {n_frames} frames): {len(ts)} tracked (need {need}), "
          f"ATE {res['ate_m']:.4f} m, {res['frames_per_s']:.3f} frames/s, launches "
          f"{res['launches']} over {pairs[0]} frame pairs", flush=True)
    if not engine_dev.startswith(dev_type):
        fail(f"C ABI: the engine ran on {engine_dev}")
    check_image_path(res, "C ABI drive", min_tracked=need)
    check_ate(res, "C ABI drive")

    # the standalone C consumer, in a process of its own
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        fail("C ABI: no C compiler to build tests/data/capi_roundtrip.c")
    repo = os.path.dirname(os.path.abspath(__file__))
    exe = os.path.join(out_dir, "capi_roundtrip")
    link = subprocess.run(
        [cc, os.path.join(repo, "tests", "data", "capi_roundtrip.c"), "-I",
         os.path.join(repo, "native"), info["library"],
         f"-Wl,-rpath,{os.path.dirname(info['library'])}", "-o", exe],
        capture_output=True, text=True)
    if link.returncode != 0:
        if info["links_libpython"]:
            fail(f"C ABI: linking capi_roundtrip.c failed: {link.stderr[-600:]}")
        res["standalone"] = {"linked": False, "reason": "this Python has no shared "
                             "libpython: " + link.stderr[-300:]}
        print(f"C ABI round trip: not linked, {res['standalone']['reason']}", flush=True)
        return res
    slam_yaml, dev_yaml = (os.path.join(out_dir, f) for f in ("rt_slam.yaml", "rt_device.yaml"))
    with open(slam_yaml, "w") as f:
        f.write("%YAML:1.0\nsliding_window:\n  size: 8\n  subframe_size: 3\n"
                "feature_tracker:\n  min_keypoint_distance: 8.0\n"
                "  max_keypoint_detection: 40\nsolver:\n  iteration_limit: 5\n")
    with open(dev_yaml, "w") as f:
        f.write("%YAML:1.0\ncam0:\n  resolution: [64, 48]\n"
                "  intrinsics: [60.0, 60.0, 32.0, 24.0]\n")
    env = dict(os.environ)
    env.pop("PYTHONHOME", None)
    env.update(PYTHONPATH=os.pathsep.join([repo, *site.getsitepackages()]),
               **{capi_host.DEVICE_ENV: dev_type})
    t0 = time.perf_counter()
    r = subprocess.run([exe, slam_yaml, dev_yaml], capture_output=True, text=True,
                       env=env, timeout=300)
    out = {}
    for line in r.stdout.splitlines():
        parts = line.split()
        if parts and parts[0].startswith("CAPI_"):
            out[parts[0]] = parts[1:]
    want = {"CAPI_OK": None, "CAPI_STATE0": ["0"], "CAPI_STATE1": ["0"]}
    ok = (r.returncode == 0 and all(k in out and (v is None or out[k] == v)
                                    for k, v in want.items())
          and bool(out.get("CAPI_VERSION")) and float(out["CAPI_FX"][0]) == 60.0
          and float(out["CAPI_FX"][2]) == 24.0 and int(out["CAPI_NFEATURES"][0]) > 0
          and int(out["CAPI_NLANDMARKS"][0]) == 0 and float(out["CAPI_BIAS"][0]) == 0.0)
    res["standalone"] = {"linked": True, "seconds": time.perf_counter() - t0,
                         "lines": {k: " ".join(v) for k, v in out.items()}}
    print(f"C ABI round trip (capi_roundtrip.c linked against the shim, its own "
          f"process on {dev_type}, {res['standalone']['seconds']:.1f} s): " + "; ".join(
              f"{k} {v}" for k, v in res["standalone"]["lines"].items()), flush=True)
    if not ok:
        fail(f"C ABI round trip: exit {r.returncode}, lines {out}, stderr "
             f"{r.stderr[-800:]}")
    return res


def ros_phase(dev, dataset: dict, n_frames: int = ROS_FRAMES) -> dict:
    """`tools.ros_node.RosVioNode` on the card, built from the dataset
    drive's config with the distortion flag on, fed the dataset's first
    `n_frames` frames and their IMU through handle_image / handle_imu:
    fails unless every image was drained into the engine and each was
    remapped by the native runtime."""
    import dataclasses

    import torch

    from xrslam_tpu_torch import api, native
    from xrslam_tpu_torch.config import load_config
    from xrslam_tpu_torch.frontend import klt
    from xrslam_tpu_torch.io.dataset import DataType, create_reader
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.tools.ros_node import RosVioNode

    paths = dataset["paths"]
    cfg = load_config(paths["slam_yaml"], paths["device_yaml"])
    node = RosVioNode(dataclasses.replace(cfg, camera_distortion_flag=True), device=dev)
    reader = create_reader("euroc://" + paths["root"], cfg)
    build.reset_launch_counts()
    native.reset_counts()
    pushed, gyro = [], {}
    n_img, t_last = 0, None
    node_push = node.slam.push_sensor_data

    def push(kind, t, data):
        pushed.append(kind)
        node_push(kind, t, data)

    node.slam.push_sensor_data = push
    t0 = time.perf_counter()
    with counting(klt, "track_keypoints") as pairs:
        while (kind := reader.next()) != DataType.END:
            if kind == DataType.GYROSCOPE:
                t, w = reader.read_gyroscope()
                gyro[t] = w
            elif kind == DataType.ACCELEROMETER:
                t, a = reader.read_accelerometer()
                node.handle_imu(t, gyro.pop(t), a)
                if n_img == n_frames and t > t_last and not node._pending_images:
                    break
            elif kind == DataType.DEPTH:  # a camera node: the depth stream is not its
                reader.read_depth()
            elif n_img < n_frames:
                t, img = reader.read_image()
                node.handle_image(t, img)
                n_img, t_last = n_img + 1, t
            else:
                reader.read_image()
    torch.cuda.synchronize()
    res = {"frames": n_img, "pending": len(node._pending_images),
           "engine_frames": sum(k == api.SensorType.CAMERA for k in pushed),
           "remaps": native.CALLS["remap_bilinear"], "device": str(node.slam.device),
           "seconds": time.perf_counter() - t0, "frame_pairs_tracked": pairs[0],
           "launches": {k.name: k.launches for k in build.KERNELS}}
    print(f"ROS node on {res['device']}: {n_img} images pushed, {res['engine_frames']} "
          f"drained into the engine, {res['pending']} pending, {res['remaps']} native "
          f"remaps, launches {res['launches']} ({res['seconds']:.1f} s)", flush=True)
    if not (n_img == n_frames == res["engine_frames"] == res["remaps"]
            and res["pending"] == 0):
        fail(f"ROS node: {res}")
    if res["device"] != str(torch.device(dev)) or res["launches"]["klt_level"] == 0:
        fail(f"ROS node: the engine ran on {res['device']} with launches {res['launches']}")
    return res


def multiseq_phase(dev, out_dir: str, n_seq: int = MULTISEQ_N,
                   frames: int = MULTISEQ_FRAMES, width: int = 752, height: int = 480,
                   focal: float = 458.0, seeds=None) -> dict:
    """`tools.multiseq` at the main path's geometry: `n_seq` sequences
    (the first of seeds 3, 5, 11, 32), `frames` frames each, sequential then batched
    (the brokered `solve_chained_batch`, K2 over the batch). Fails unless
    every sequence in both modes tracked at least half of its frames
    after the backend's start at ATE <= 0.25 m, the batched mode made a
    K2 call over more than one window, and the first batched flush's
    windows, solved one by one, agree with their batched rows within
    1e-9."""
    import math

    from xrslam_tpu_torch.tools import multiseq

    res = multiseq.run(n_seq, frames, width, height, focal, dev, out_dir,
                       check_first=True, seeds=seeds or multiseq.SEEDS)
    seq, bat = res["sequential"], res["batched"]
    for mode, r in (("sequential", seq), ("batched", bat)):
        r["launches"] = {"klt_level": r["k1_launches"], "reproj_gram": r["k2_launches"]}
        print(f"multiseq {mode} ({n_seq} sequences x {frames} frames, {width}x{height}): "
              f"{r['frames']} frames in {r['wall_s']:.1f} s, {r['agg_fps']:.3f} frames/s "
              f"in all; K2 {r['k2_launches']} calls ({r['k2_per_seq_frame']:.2f} a "
              f"sequence-frame, batched {r['k2_batched']}), K1 {r['k1_launches']} "
              f"({r['k1_per_seq_frame']:.2f}); per sequence (tracked after frame "
              f"{multiseq.BACKEND_START} / of, ATE m): " + ", ".join(
                  f"{o['tracked_after_start']}/{o['frames_after_start']} "
                  f"{o['ate_m']:.4f}" for o in r["sequences"]), flush=True)
    fc = bat["first_flush_check"]
    print(f"multiseq: speedup {res['speedup']:.3f} (sequential wall / batched wall); "
          f"{bat['batched_dispatches']} batched dispatches for "
          f"{bat['solo_solves_replaced']} subframe solves; first batched flush against "
          f"its windows solved one by one: {fc}; first frame where the modes part "
          f"(> 1e-6 m or tracked): {res['first_divergence']}", flush=True)
    for mode, r in (("sequential", seq), ("batched", bat)):
        for i, o in enumerate(r["sequences"]):
            need = math.ceil(o["frames_after_start"] / 2)
            if o["tracked_after_start"] < need or not o["ate_m"] <= 0.25:
                fail(f"multiseq {mode}, sequence {i} (seed {res['seeds'][i]}): "
                     f"{o['tracked_after_start']} tracked after frame "
                     f"{multiseq.BACKEND_START} (need {need}), ATE {o['ate_m']}")
    if bat["k2_batched"]["launches"] == 0:
        fail("multiseq batched: no K2 call served more than one window")
    if fc is None or not fc["max_abs_err"] <= MULTISEQ_TOL:
        fail(f"multiseq batched: first flush against single solves: {fc}")
    res["diverged"] = [
        {"sequence": i, "first_frame": res["first_divergence"][i]}
        for i, (a, b) in enumerate(zip(seq["sequences"], bat["sequences"]))
        if abs(a["tracked"] - b["tracked"]) > 2 or abs(a["ate_m"] - b["ate_m"]) > 0.01]
    if res["diverged"]:
        print(f"multiseq: the modes differ in outcome beyond rounding: {res['diverged']}",
              flush=True)
    return res


def sharded_rank(rank: int, n: int, jobs, device: str) -> list:
    """One rank of the sharded phases (run by `parallel.mesh.run_ranks`):
    per job (mode, mesh shape, K, L, seeds, iterations, timed solves),
    the windows `perturbed_demo_window(K, L, seed)` on this rank's device,
    sharded ("model": one window) or batched and sharded ("data"),
    solved once with the launch counts, K2's calls and the collectives
    recorded, then `timed` more times. Returns per job the gathered
    state (this rank's rows), info, counts and ms per solve."""
    import torch
    import torch.distributed as dist

    from xrslam_tpu_torch.estimation import gram, solver
    from xrslam_tpu_torch.io.synthetic import perturbed_demo_window
    from xrslam_tpu_torch.kernels import build
    from xrslam_tpu_torch.parallel import mesh as pmesh
    from xrslam_tpu_torch.parallel import sharded

    dev = pmesh.rank_device(rank, device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    for mode, shape, K, L, seeds, iters, timed in jobs:
        mesh = pmesh.make_mesh(shape=shape, device_type=dev.type)
        opts = solver.SolveOptions(iterations=iters)
        wins = [perturbed_demo_window(K, L, sd, dev) for sd in seeds]
        if mode == "model":
            st, dt = sharded.shard_window(mesh, *wins[0])

            def solve():
                return sharded.solve_window_sharded(mesh, st, dt, opts)
        else:
            states, datas = (solver._stack(x) for x in zip(*wins))

            def solve():
                return sharded.solve_batch_sharded(mesh, states, datas, opts)
        with recording(gram, "reproj_factor_gram") as calls:
            build.reset_launch_counts()
            pmesh.reset_counts()
            res, info = solve()
            sync()
            launches = {k.name: k.launches for k in build.KERNELS}
            batched = dict(build.REPROJ_GRAM.batched)
            coll = dict(pmesh.COLLECTIVES)
        full = sharded.gather_window(mesh, res)
        ms = None
        if timed:
            t0 = time.perf_counter()
            for _ in range(timed):
                solve()
            sync()
            ms = (time.perf_counter() - t0) / timed * 1e3
        out.append({
            "state": {f: getattr(full, f).cpu().numpy() for f in full._fields},
            "info": {k: v.cpu().numpy() for k, v in info.items()},
            "k2_calls": [(tuple(a[0].q.shape[:-2]), int(a[1].bearings.shape[-2]))
                         for a, _ in calls],
            "launches": launches, "batched": batched, "collectives": coll, "ms": ms,
            "backend": dist.get_backend(), "data_rank": mesh["data"].get_local_rank()})
    return out


def check_sharded(what: str, res: list, ref_state, ref_info, cost_tol, state_tol,
                  names, rows=None) -> float:
    """Fail unless rank 0's cost and states (`rows` of the reference)
    agree with the reference at (rtol, atol), and every rank's frame
    state and info are bit-equal to those of the first rank with the
    same data coordinate. Returns the largest |Δ| of the states."""
    def ref_of(x, r):
        x = x.cpu().numpy()
        return x if rows is None else x[rows(r)]

    err = 0.0
    for r in res:
        np.testing.assert_allclose(r["info"]["cost"], ref_of(ref_info["cost"], r),
                                   rtol=cost_tol[0], atol=cost_tol[1],
                                   err_msg=f"{what}: cost")
        for f in names:
            want = ref_of(getattr(ref_state, f), r)
            err = max(err, float(np.abs(r["state"][f] - want).max()))
            np.testing.assert_allclose(r["state"][f], want, rtol=state_tol[0],
                                       atol=state_tol[1], err_msg=f"{what}: {f}")
        first = next(x for x in res if x["data_rank"] == r["data_rank"])
        for f in ("q", "p", "v", "bg", "ba"):
            if not np.array_equal(r["state"][f], first["state"][f]):
                fail(f"{what}: a rank's {f} is not bit-equal to its model group's first")
        for k, v in r["info"].items():
            if not np.array_equal(v, first["info"][k]):
                fail(f"{what}: a rank's info[{k}] is not bit-equal to its model group's first")
    return err


def sharded_model_phase(dev, K: int = SHARD_K, L: int = SHARD_L, widths=SHARD_WIDTHS,
                        iters: int = SHARD_ITERS, timed: int = SHARD_TIMED,
                        nccl: bool = True, dxm=(DXM_K, DXM_L, DXM_SEEDS, DXM_ITERS)) -> dict:
    """The sharded Schur BA on ranks that share `dev`'s card: one window
    of K frames and L landmark slots solved unsharded here and with its
    columns over W ranks (gloo), each held to the unsharded solve, the
    cost decreasing and every rank's frame state bit-equal; K2 launched
    on every rank in every assemble, over L/W columns. The group of the
    largest W also runs the data x model phase (`dxm`: K, L, seeds,
    iterations; four windows on a 2 x 2 mesh) against the batched solve
    here, each rank's K2 calls taking its two windows at once. Then, on
    the card, the window in a one-rank NCCL group, bit-equal to the
    unsharded solve. Times the solves, counts the collectives, and on
    the card holds K2 on every rank's columns to its plain version
    (`k2_shard_phase`)."""
    import torch

    from xrslam_tpu_torch.estimation import gram, solver
    from xrslam_tpu_torch.io.synthetic import perturbed_demo_window
    from xrslam_tpu_torch.parallel import mesh as pmesh
    from xrslam_tpu_torch.parallel import sharded

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    opts = solver.SolveOptions(iterations=iters)
    state, data = perturbed_demo_window(K, L, SHARD_SEED, dev)
    ref, info = solver.solve_window_core(state, data, opts)
    sync()
    if not (float(info["cost"]) < float(info["cost0"])
            and bool(torch.isfinite(info["cost_history"]).all())):
        fail(f"sharded phase: the unsharded K={K}, L={L} solve did not lower the cost")
    t0 = time.perf_counter()
    for _ in range(timed):
        solver.solve_window_core(state, data, opts)
    sync()
    res = {"K": K, "L": L, "iterations": iters, "cost0": float(info["cost0"]),
           "cost": float(info["cost"]),
           "ms_per_solve": {1: (time.perf_counter() - t0) / timed * 1e3}, "widths": {}}

    dK, dL, dseeds, diters = dxm
    dstates, ddatas = (solver._stack(x) for x in
                       zip(*[perturbed_demo_window(dK, dL, sd, dev) for sd in dseeds]))
    dref, dinfo = solver.solve_window_batch(dstates, ddatas,
                                            solver.SolveOptions(iterations=diters))
    sync()
    n_assemble = iters + 1
    for W in widths:
        jobs = [("model", (1, W), K, L, (SHARD_SEED,), iters, timed)]
        if W == max(widths):
            jobs.append(("data", (2, W // 2), dK, dL, dseeds, diters, 0))
        t0 = time.perf_counter()
        out = pmesh.run_ranks(sharded_rank, W, args=(jobs, dev.type), device=dev.type,
                              timeout_s=RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        model = [o[0] for o in out]
        err = check_sharded(f"sharded K={K} L={L} W={W}", model, ref, info,
                            SHARD_COST_TOL, SHARD_STATE_TOL, ("q", "p", "inv_depth"))
        r0 = model[0]
        if not (float(r0["info"]["cost"]) < float(r0["info"]["cost0"])
                and np.isfinite(r0["info"]["cost_history"]).all()):
            fail(f"sharded W={W}: the cost did not decrease or its history is not finite")
        for m in model:
            if m["k2_calls"] != [((), L // W)] * n_assemble:
                fail(f"sharded W={W}: K2's calls on a rank were {m['k2_calls']}, not "
                     f"{n_assemble} over {L // W} columns")
            if cuda and m["launches"]["reproj_gram"] != n_assemble:
                fail(f"sharded W={W}: K2 launched {m['launches']['reproj_gram']} times "
                     f"on a rank, not once per assemble ({n_assemble})")
        coll = r0["collectives"]
        one = {"backend": r0["backend"], "max_abs_err": err, "ms_per_solve": r0["ms"],
               "collectives_per_solve": coll["calls"],
               "bytes_per_collective": coll["bytes"] / max(coll["calls"], 1),
               "launches": {k: sum(m["launches"][k] for m in model) for k in r0["launches"]},
               "group_seconds": wall}
        res["ms_per_solve"][W] = r0["ms"]
        res["widths"][W] = one
        print(f"sharded K={K} L={L} f64, W={W} ranks sharing {dev} over {one['backend']}: "
              f"cost {float(r0['info']['cost']):.6e} (unsharded {res['cost']:.6e}), "
              f"max |Δ| q/p/inv_depth {err:.3e} (rtol/atol {SHARD_STATE_TOL}), ranks "
              f"bit-equal, K2 {n_assemble} calls a rank over {L // W} columns; "
              f"{one['ms_per_solve']:.1f} ms a solve, {coll['calls']} collectives of "
              f"{one['bytes_per_collective'] / 1e6:.3f} MB a solve; group {wall:.1f} s",
              flush=True)
        if len(out[0]) > 1:
            res["data_x_model"] = data_x_model_check(
                [o[1] for o in out], dref, dinfo, cuda, dK, dL, W // 2)
    print(f"sharded K={K} L={L}, {iters} iterations, ms a solve: " + ", ".join(
        f"W={w} {ms:.1f}" for w, ms in res["ms_per_solve"].items())
        + " (W=1: unsharded, in this process)", flush=True)
    if nccl and cuda:
        res["nccl"] = nccl_check(K, L, iters, ref, info, dev)
    res["k2_shard"] = k2_shard_phase(state, data, widths) if cuda else None
    return res


def data_x_model_check(out: list, dref, dinfo, cuda: bool, K: int, L: int, W: int) -> dict:
    """The data x model ranks against the batched solve; each rank's K2
    calls took its two windows in one call, over L/W columns."""
    per = len(dinfo["cost"]) // (len(out) // W)
    err = check_sharded("sharded data x model", out, dref, dinfo, DXM_COST_TOL,
                        DXM_STATE_TOL, ("p", "inv_depth"),
                        rows=lambda r: slice(per * r["data_rank"], per * (r["data_rank"] + 1)))
    for o in out:
        if not o["k2_calls"] or any(c != ((per,), L // W) for c in o["k2_calls"]):
            fail(f"sharded data x model: K2's calls on a rank were {o['k2_calls']}")
        if cuda and (o["batched"]["launches"] != o["launches"]["reproj_gram"]
                     or o["batched"]["windows"] != per * o["launches"]["reproj_gram"]):
            fail(f"sharded data x model: K2 did not take {per} windows a launch "
                 f"({o['batched']}, {o['launches']})")
    launches = {k: sum(o["launches"][k] for o in out) for k in out[0]["launches"]}
    print(f"sharded data x model, {len(out)} ranks on a ({len(out) // W}, {W}) mesh over "
          f"{out[0]['backend']}: {len(dinfo['cost'])} windows K={K} L={L}, "
          f"max |Δ| p/inv_depth {err:.3e} vs the batched solve, each K2 call {per} "
          f"windows over {L // W} columns, launches {launches}", flush=True)
    return {"backend": out[0]["backend"], "max_abs_err": err, "launches": launches,
            "windows_per_k2_call": per}


def nccl_check(K: int, L: int, iters: int, ref, info, dev) -> dict:
    """The model-mode window in a one-rank NCCL group on the card:
    bit-equal to the unsharded solve."""
    from xrslam_tpu_torch.parallel import mesh as pmesh

    out = pmesh.run_ranks(sharded_rank, 1, args=([("model", (1, 1), K, L, (SHARD_SEED,),
                                                   iters, 0)], dev.type),
                          device=dev.type, timeout_s=RANK_TIMEOUT_S)[0][0]
    if out["backend"] != "nccl":
        fail(f"one-rank group on the card ran over {out['backend']}, not nccl")
    same = all(np.array_equal(out["state"][f], getattr(ref, f).cpu().numpy())
               for f in out["state"]) and all(
        np.array_equal(v, info[k].cpu().numpy()) for k, v in out["info"].items())
    if not same:
        fail("one-rank NCCL solve is not bit-equal to the unsharded solve")
    print(f"sharded K={K} L={L}, one-rank NCCL group: bit-equal to the unsharded solve, "
          f"{out['collectives']['calls']} collectives, K2 {out['launches']['reproj_gram']} "
          "launches", flush=True)
    return {"backend": "nccl", "bit_equal": True, "launches": out["launches"]}


def k2_shard_phase(state, data, widths) -> dict:
    """K2's fused entry on every rank's landmark shard of the sharded
    window (W = 1 and each of `widths`; L/W columns), held to its plain
    version on the same inputs at rtol/atol 1e-9; on the first shard of
    each width, timed against the plain version (the wrapper, and the
    device alone) and bounded."""
    import torch

    from xrslam_tpu_torch.estimation import gram
    from xrslam_tpu_torch.parallel import sharded

    K, L = state.q.shape[0], state.inv_depth.shape[0]
    res = {}
    for W in (1,) + tuple(widths):
        n, err, first = L // W, 0.0, None
        for b in range(W):
            cols = slice(b * n, (b + 1) * n)
            s, d = (sharded.take_block(x, 0, None, cols) for x in (state, data))
            out = gram.reproj_factor_gram_cuda(s, d)
            ref = gram.reproj_factor_gram_plain(s, d)
            torch.cuda.synchronize()
            err = max(err, check_close(f"K2 entry 2 on shard {b} of {W} (K={K}, {n} "
                                       "columns, f64) vs plain", GRAM_NAMES + ["cost"],
                                       ref, out, 1e-9))
            first = first or (s, d, out)
        s, d, out = first
        one = {"W": W, "shards_checked": W, "max_abs_err": err}
        one.update(timed_pair(lambda: gram.reproj_factor_gram_cuda(s, d),
                              lambda: gram.reproj_factor_gram_plain(s, d)))
        one.update(factor_gram_bound(s, d, out))
        res[n] = one
        print(f"K2 reproj_factor_gram on a rank's shard (K={K}, {n} columns, f64; W={W}): "
              f"max |Δ| {err:.3e} vs plain over all {W} shards (rtol/atol 1e-9); "
              f"kernel {one['ms']:.4f} ms (device alone {one['device_ms']:.4f}), plain "
              f"{one['plain_ms']:.4f} ms, bound {one['bound_ms'] * 1e3:.3f} us by "
              f"{one['bound_by']}", flush=True)
    return res


def nullspace_phase(dev, drive) -> dict:
    """The 5-point solver's null-space basis for one RANSAC call's 64
    hypotheses: the port's route (AᵀA copied to the host, scipy's
    LAPACK `syevd` a matrix) against cuSOLVER's batched `eigh` on the
    card, both checked to span the null space and timed with CUDA events
    around the call, and the difference charged to a frame of the main
    drive at its count of calls."""
    import torch

    from xrslam_tpu_torch.geometry import essential

    rng = np.random.default_rng(5)
    x1 = np.concatenate([rng.normal(0, 0.3, (64, 5, 2)), np.ones((64, 5, 1))], -1)
    w = rng.normal(0, 0.1, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    X = x1 * rng.uniform(2, 6, (64, 5, 1))
    x2 = X @ R.T + np.array([0.3, 0.05, 0.02])
    x1, x2 = (torch.as_tensor(x, dtype=torch.float64, device=dev)
              for x in (x1, x2 / x2[..., 2:]))
    A = torch.einsum("...ni,...nj->...nij", x2, x1).reshape(64, 5, 9)

    def card():
        ata = A[..., 0, :, None] * A[..., 0, None, :]
        for i in range(1, 5):
            ata = ata + A[..., i, :, None] * A[..., i, None, :]
        return torch.linalg.eigh(ata)[1][..., :, 0:4]

    def host():
        return essential.nullspace_basis(x1, x2)

    res = {}
    for name, fn in (("host", host), ("card", card)):
        resid = float((A @ fn()).abs().max())
        if not resid < 1e-9:
            fail(f"5-point null-space basis by the {name} route: |A·v| {resid:.3e}")
        res[f"{name}_max_abs_Av"] = resid
    h1, c1, c2, h2 = cuda_ms(host), cuda_ms(card), cuda_ms(card), cuda_ms(host)
    res.update(host_ms=(h1 + h2) / 2, card_ms=(c1 + c2) / 2,
               calls=drive["nullspace_calls"], frames=drive["frames"])
    res["ms_per_frame"] = (res["host_ms"] - res["card_ms"]) * res["calls"] / res["frames"]
    print(f"5-point null-space basis, 64 hypotheses, f64: host route (copy + scipy "
          f"syevd a matrix) {res['host_ms']:.4f} ms, cuSOLVER eigh on the card "
          f"{res['card_ms']:.4f} ms (host, card, card, host: {h1:.4f}, {c1:.4f}, "
          f"{c2:.4f}, {h2:.4f}); the main drive called it {res['calls']} times in "
          f"{res['frames']} frames: {res['ms_per_frame']:.4f} ms a frame more than "
          f"on the card", flush=True)
    return res


def start_scaling(dev, devices=SCALING_DEVICES, extra=()) -> dict:
    """Start `tools.run_scaling --devices ... --modes data model --reps
    SCALING_REPS` (and `extra` arguments) on `dev`'s type in a process of
    its own, writing its results to a JSON file; `finish_scaling` waits
    for it. Its groups of ranks start and solve while another phase
    runs."""
    import torch

    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    argv = ["--devices", *map(str, devices), "--modes", "data", "model", "--reps",
            str(SCALING_REPS), "--device", torch.device(dev).type, *extra]
    proc = subprocess.Popen([sys.executable, "-m", "xrslam_tpu_torch.tools.run_scaling",
                             *argv, "--json", out], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return {"proc": proc, "out": out, "argv": argv, "t0": time.perf_counter(), "dev": dev}


def finish_scaling(started: dict, timeout_s: float = RANK_TIMEOUT_S) -> dict:
    """Wait for `start_scaling`'s process (killed past `timeout_s`), then
    print its table, labeled with where the ranks ran; fails unless it
    exited 0 and every cost is finite."""
    import torch

    proc, dev = started["proc"], started["dev"]
    try:
        _, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"run_scaling did not end within {timeout_s} s")
    wall = time.perf_counter() - started["t0"]
    if proc.returncode != 0:
        fail(f"run_scaling exited {proc.returncode}: {err[-2000:]}")
    with open(started["out"]) as f:
        res = json.load(f)
    os.unlink(started["out"])
    where = (f"sharing one {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
             else "on the CPU")
    for mode, rows in res.items():
        for r in rows:
            if not r["cost_finite"]:
                fail(f"run_scaling {mode} {r['devices']} ranks: the cost is not finite")
            print(f"run_scaling [{mode}] {r['devices']} ranks {where} ({r['backend']}): "
                  f"{r['windows_per_s']:.1f} windows/s, {r['solve_ms']:.2f} ms a solve, "
                  f"speedup {r['speedup']:.2f}x, efficiency {r['efficiency']:.0%}, "
                  f"{r['collectives_per_solve']:.0f} collectives a solve", flush=True)
    print(f"run_scaling {' '.join(started['argv'])}: {wall:.1f} s from its start, in a "
          f"process of its own beside other phases (ranks {where}: no multi-card "
          f"scaling)", flush=True)
    return {"rows": res, "seconds": wall}


def beside_worker(name: str, args: tuple) -> tuple:
    """`name`(*args), a function of this script, in a process of its own
    with one intra-op thread; returns (its result, its seconds)."""
    import torch

    torch.set_num_threads(1)
    t = time.perf_counter()
    out = globals()[name](*args)
    return out, time.perf_counter() - t


@contextlib.contextmanager
def beside(*jobs):
    """Starts each job, (a function of this script, *its arguments), in a
    spawned process of its own while the block runs: for phases whose
    checks do not depend on time, beside another phase (PERF.md section
    4). Yields the futures of (result, seconds); a job's `fail` ends this
    process too when its future is read, and leaving the block waits for
    every job."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(jobs), mp_context=multiprocessing.get_context("spawn"))
    try:
        yield [pool.submit(beside_worker, fn.__name__, tuple(args)) for fn, *args in jobs]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every measured number to this JSON file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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

    # each phase's seconds on the host clock, to choose cuts by
    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    def beside_result(name, future):
        out, phase_s[name] = future.result(timeout=OBJECT_TIMEOUT_S)
        return out

    k1_level = phase("klt_level", klt_phase, dev)
    k1 = phase("klt_track", klt_track_phase, dev)
    k2_gram = phase("reproj_gram", gram_phase, dev)
    k2 = phase("reproj_factor_gram", factor_gram_phase, dev)
    k2_batch = phase("reproj_factor_gram_batch", factor_gram_batch_phase, dev)
    repeat = phase("parsac_repeat", parsac_repeat_phase, dev)

    from xrslam_tpu_torch.tools.make_dataset import render_sequence

    t0 = time.perf_counter()
    seq = render_sequence(n_frames=N_FRAMES, width=752, height=480, focal=458.0)
    print(f"rendered {N_FRAMES} frames 752x480 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    drive, main_slam = phase("main_drive", drive_phase, dev, seq)
    bases = phase("nullspace", nullspace_phase, dev, drive)
    nat = phase("native", native_phase, drive)
    valid = phase("validator", validator_phase, main_slam.pipeline.swt)
    del main_slam
    # the phases whose checks do not depend on time run in processes of
    # their own beside others (PERF.md section 4); the kernels' phases,
    # the main drive, 12 with 12b(a) and 12c, and the A/B tools run with
    # nothing else beside them
    with tempfile.TemporaryDirectory() as tmp:
        scaling_run = start_scaling(dev)
        try:
            with beside((sharded_model_phase, dev),
                        (multiseq_phase, dev, os.path.join(tmp, "multiseq"))) \
                    as (f_shard, f_mseq):
                parsac_drive = phase("parsac_drive", parsac_drive_phase, dev, seq)
                pnp_drive = phase("visual_pnp", visual_pnp_phase, dev, seq)
                mobile = phase("mobile_profile", mobile_phase, dev,
                               os.path.join(tmp, "mobile"))
                shard = beside_result("sharded (beside 6, 7, 7b)", f_shard)
                mseq = beside_result("multiseq (beside 6, 7, 7b)", f_mseq)
            scaling = phase("run_scaling_wait", finish_scaling, scaling_run)
        finally:
            if scaling_run["proc"].poll() is None:
                scaling_run["proc"].kill()
                scaling_run["proc"].communicate()
        euroc = os.path.join(tmp, "euroc")
        paths = phase("dataset_render", render_euroc, euroc)
        os.makedirs(os.path.join(tmp, "capi"))
        on_disk = {"paths": paths, "frames": DATASET_FRAMES}
        with beside((dataset_phase, dev, euroc, DATASET_FRAMES, 752, 480, 458.0,
                     DATASET_FRAMES // 2, CLI_FRAMES, paths),
                    (localizer_phase, dev, on_disk),
                    (capi_phase, dev, seq, on_disk, os.path.join(tmp, "capi"))) \
                as (f_dataset, f_loc, f_capi):
            obj = phase("dynamic_object", object_phase, dev)
            ros = phase("ros_node", ros_phase, dev, on_disk)
            dataset = beside_result("dataset (beside 8)", f_dataset)
            loc = beside_result("localizer (beside 8)", f_loc)
            capi = beside_result("capi (beside 8)", f_capi)
        # 12b's and 12c's processes run up to their warm-up beside the
        # checkpoint phase; 12's timed pass starts with theirs
        sched_run = None
        try:
            t = time.perf_counter()
            sched_run = start_schedules(dev, os.path.join(tmp, "bench"))
            phase_s["schedules_start"] = time.perf_counter() - t
            ckpt = phase("checkpoint", checkpoint_phase, dev, seq, tmp)
            phase("schedules_warm_wait", release_schedules, sched_run)
            bench = phase("benchmark", bench_phase, dev, os.path.join(tmp, "bench"))
            t = time.perf_counter()
            pipe, straight, overlap, chained_pass = (f.result(timeout=OBJECT_TIMEOUT_S)
                                                     for f in sched_run["futures"])
            phase_s["schedules_wait"] = time.perf_counter() - t
            sched = schedules_phase(bench, pipe, straight, overlap)
            chained = chained_phase(bench, pipe, chained_pass)
        finally:
            if sched_run is not None:
                stop_schedules(sched_run)
        ab = phase("ab_tools", ab_tools_phase, dev)

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
                        "entry_launches": drive["entry_launches"][k.name],
                        "launches_by_path": {
                            "main": drive["launches"][k.name],
                            "parsac": parsac_drive["launches"][k.name],
                            "visual_pnp": pnp_drive["launches"][k.name],
                            "mobile_profile": mobile["launches"][k.name],
                            "dynamic_object": obj["launches"][k.name],
                            "dataset": dataset["launches"][k.name],
                            "localizer": loc["launches"][k.name],
                            "checkpoint_bearings": ckpt["bearings"]["launches"][k.name],
                            "checkpoint_parsac": ckpt["parsac"]["launches"][k.name],
                            "checkpoint_images": ckpt["image"]["launches"][k.name],
                            "benchmark": bench["launches"][k.name],
                            "schedules_pipelined": sched["pipelined"]["launches"][k.name],
                            "schedules_bearings_straight":
                                sched["bearings_straight"]["launches"][k.name],
                            "schedules_bearings_overlap":
                                sched["bearings_overlap"]["launches"][k.name],
                            "chained_benchmark": chained["launches"][k.name],
                            "ab_assemble": ab["ab_assemble"]["launches"][k.name],
                            "ab_lk_backend": ab["ab_lk_backend"]["launches"][k.name],
                            "ab_klt_precision": ab["ab_klt_precision"]["launches"][k.name],
                            "capi": capi["launches"][k.name],
                            "ros_node": ros["launches"][k.name],
                            "multiseq_sequential": mseq["sequential"]["launches"][k.name],
                            "multiseq_batched": mseq["batched"]["launches"][k.name],
                            "sharded_model": sum(w["launches"][k.name]
                                                 for w in shard["widths"].values()),
                            "sharded_data": shard["data_x_model"]["launches"][k.name]}})
    kernels[0]["longest_chain"] = k1["longest_chain"]
    kernels[0]["latency_floor_us"] = k1["latency_floor_us"]
    kernels[0]["chain_ms"] = k1["chain_ms"]
    kernels[0]["entry_klt_level"] = {
        key: k1_level[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")}
    e1 = k2_gram["K=12 L=384 float64"]
    kernels[1]["entry_reproj_gram"] = {
        key: e1[key] for key in ("max_abs_err", "ms", "plain_ms", "device_ms",
                                 "bound_ms", "bound_by", "library_gram_form")}
    kernels[1]["entry_reproj_factor_gram_shard"] = {
        n: {key: one[key] for key in ("W", "shards_checked", "max_abs_err", "ms", "plain_ms",
                                      "device_ms", "bound_ms", "bound_by")}
        for n, one in shard["k2_shard"].items()}
    kernels[1]["entry_reproj_factor_gram_batched"] = {
        key: k2_batch[key] for key in ("N", "K", "L", "max_abs_err", "ms", "plain_ms",
                                       "device_ms", "four_single_ms",
                                       "four_single_device_ms", "bound_ms", "bound_by")}
    kernels[1]["entry_reproj_factor_gram_batched"]["launches_multiseq_batched"] = \
        mseq["batched"]["k2_batched"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "build": {k: v for k, v in info.items()},
                       "k1_klt_level": k1_level, "k1_klt_track": k1,
                       "k2_reproj_gram": k2_gram,
                       "k2_reproj_factor_gram": k2,
                       "k2_reproj_factor_gram_batched": k2_batch, "drive": drive,
                       "native": nat, "capi": capi, "ros_node": ros, "multiseq": mseq,
                       "parsac_repeat": repeat, "parsac_drive": parsac_drive,
                       "visual_pnp_drive": pnp_drive, "mobile_drive": mobile,
                       "object_drive": obj,
                       "dataset_drive": dataset, "localizer_drive": loc,
                       "validator": valid, "checkpoint": ckpt,
                       "benchmark": {k: v for k, v in bench.items() if k != "run"},
                       "schedules": sched, "chained": chained, "ab_tools": ab,
                       "sharded": shard, "run_scaling": scaling,
                       "nullspace_basis": bases, "phase_seconds": phase_s,
                       "seconds": time.perf_counter() - t_start,
                       "kernels": kernels}, f, indent=1, default=float)
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}),
          flush=True)
    print(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
