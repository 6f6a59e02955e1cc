"""CPU rehearsals of `chip_smoke.py`'s phases for K1's fused entry, the
IMU-PARSAC repeat check, and the dataset and localizer drives (phases 9
and 10).

`klt_track_phase` runs at 320x240 on CPU tensors with the kernel
wrappers patched to their plain versions (the fused entry's stand-in
also fills `steps_out`: min(iters, 3) LK steps per pass on every valid
slot), the CUDA timers stubbed (the device timer returns 0.5, 0.2 and
0.9 ms for the fused entry, the fused entry at iters=1 and the
five-launch chain) and `torch.cuda.synchronize` a no-op. So its
agreement checks, its repeat check and its bound arithmetic run here;
only the card can build and time the kernel.

Phases 9 and 10 run at 320x240 on 60 frames, the kernels' wrappers
replaced by their plain versions that count a launch as the kernel's
wrappers do, and torch's sync debug mode (CUDA only) a no-op: every
check of the two phases runs here, at the rehearsal's frame counts.

K3's phase runs at its sizes with the wrapper replaced by the
closed-form plain version and the CUDA timers stubbed; K4's with the
wrapper replaced by the plain loop.

The phases of the batched K2 entry, the native runtime, the C ABI and
the ROS node run on the CPU the same way: the batched entry at K_sub=11,
L=384, N=4 with the wrapper replaced by a counting plain version; the
native phase on a 12-frame 320x240 main drive; the C ABI drive on 42
frames at 320x240 through the shim loaded into this process (and the C
round trip as a process of its own), the kernels' plain versions
counting; the ROS node on 20 frames. `slow`: the multi-sequence phase at
320x240, seeds 3 and 32, 44 frames.

Phase 7b, the mobile profile, runs at its full size (640x480, 60
frames, the shipped `configs/iphone_slam.yaml`) with the counting plain
wrappers, its solver time budget calibrated on the CPU's solve times;
the phase's own statement of the budget's rule is held to the port's
tracker on a grid of estimates.

The validator phase runs on the window of the committed JAX checkpoint
(`tests/data/jax_circle_ckpt30.npz`) restored on the CPU. `slow`: the
checkpoint phase's runs (the bearing-fed bench scene with PARSAC, 34
frames cut at 30; the 320x240 image run, 42 frames cut at 34) and the
benchmark phase at 320x240 on 44 frames (one pass), each with the counting plain
wrappers; phase 12c (the chained benchmark pass beside the synchronous
and pipelined ones) at 752x480 on 44 frames. The A/B tools' phase fails
on the CPU, where their kernel routes do not run.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from xrslam_tpu_torch.estimation import gram  # noqa: E402
from xrslam_tpu_torch.frontend import klt  # noqa: E402
from xrslam_tpu_torch.imu import preintegration as pre  # noqa: E402
from xrslam_tpu_torch.io.synthetic import perturbed_demo_window  # noqa: E402
from xrslam_tpu_torch.kernels import build  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_klt_track_phase_rehearsal(monkeypatch):
    def fused(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, iters=30,
              steps_out=None, **kw):
        if steps_out is not None:
            steps_out.zero_()
            steps_out[valid_in] = min(iters, 3)
        return klt.track_keypoints_plain(prev_pyr, next_pyr, pts_prev, pts_init,
                                         valid_in, iters=iters, **kw)

    device_times = iter([0.5, 0.2, 0.9])

    monkeypatch.setattr(klt, "track_keypoints_cuda", fused)
    monkeypatch.setattr(klt, "track_level_cuda", klt.track_level_plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, calls=20, reps=10: (fn(), next(device_times))[1])
    before = dict(build.KLT_LEVEL.entry_launches)

    res = chip_smoke.klt_track_phase(torch.device("cpu"), width=320, height=240,
                                     focal=260.0)

    assert build.KLT_LEVEL.entry_launches == before
    assert res["status_agreement"] == 1.0 and res["max_abs_err"] == 0.0
    assert res["live"] > 50
    assert res["ms"] == res["plain_ms"] == res["chain_ms"] == 2.0
    assert (res["device_ms"], res["device_ms_iters_1"], res["chain_device_ms"]) \
        == (0.5, 0.2, 0.9)
    # 256 slots, all valid (GFTT fills them at 320x240), 3 steps per pass,
    # so chains of 15 steps, and of 5 at iters=1
    n, levels = 256, 4
    assert res["lk_steps_per_pass"] == [3 * n] * (levels + 1)
    assert res["longest_chain"] == 3 * (levels + 1)
    assert res["us_per_step"] == pytest.approx((0.5 - 0.2) * 1e3 / (15 - 5))
    assert res["latency_floor_us"] == pytest.approx(15 * res["us_per_step"])
    # at 320x240 every level's image is smaller than the blocks read from
    # it, so each image counts whole: 2 pyramids of 4 levels in float32,
    # plus pts/init (N,2) float32, valid (N,) bool, and the outputs
    image_bytes = 4 * sum((240 >> lev) * (320 >> lev) for lev in range(levels))
    assert res["bytes"] == 2 * image_bytes + n * (8 + 8 + 1) + n * (8 + 1)
    passes = n * (levels + 1)
    assert res["flops"] == (21 ** 2 * (3 * passes * chip_smoke.KLT_FLOPS_PER_TAP
                                       + passes * chip_smoke.KLT_WINDOW_FLOPS)
                            + passes * 22 ** 2 * chip_smoke.KLT_SCHARR_FLOPS)
    t_bytes = res["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = res["flops"] / chip_smoke.PEAK_FLOPS[4] * 1e3
    assert res["bound_ms"] == max(t_bytes, t_ops)
    assert res["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    # the chained frontend's input: a third of the slots dead at stale
    # positions outside the image
    sc = res["scattered_slots"]
    assert sc["dead"] == n // 3 and sc["status_agreement"] == 1.0
    assert sc["max_abs_err"] == 0.0 and sc["live"] > 30


def test_parsac_repeat_phase_rehearsal(monkeypatch):
    """`parsac_repeat_phase` on CPU tensors: the repeat is bit-equal and
    the card-vs-CPU comparison (here CPU against CPU on the same draw)
    agrees exactly, with the prior gate passed."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    res = chip_smoke.parsac_repeat_phase(torch.device("cpu"))
    assert res == {"T_err": 0.0, "conf_err": 0.0, "mask_equal": True,
                   "count_equal": True, "ok": True}


def counting_plain_kernels(monkeypatch):
    """Replace the kernels' wrappers by their plain versions, each
    counting a launch as the wrapper does on the card."""
    from xrslam_tpu_torch.frontend import image as img_ops

    scharr = img_ops.scharr

    def k1(*args, **kw):
        # the kernel computes its gradient windows itself: the plain
        # version's image-wide Scharr calls are not the drive's
        build.KLT_LEVEL.count(klt.ENTRY_TRACK)
        counted, img_ops.scharr = img_ops.scharr, scharr
        try:
            return klt.track_keypoints_plain(*args, **kw)
        finally:
            img_ops.scharr = counted

    def k2(state, data):
        # one launch serves a batch (leading axis) of windows
        build.REPROJ_GRAM.count("reproj_factor_gram_launch",
                                windows=state.q.shape[0] if state.q.dim() == 3 else 1)
        return gram.reproj_factor_gram_plain(state, data)

    def k3(state, data, mask, H=None, b=None):
        build.PREINT_GRAM.count(windows=state.q.shape[0] if state.q.dim() == 3 else 1)
        return gram.preint_factor_gram_plain(state, data, mask, H, b)

    def k4(ts, *args, **kw):
        build.PREINT_SCAN.count(windows=int(ts[..., 0].numel()))
        return pre.integrate_batch_plain(ts, *args, **kw)

    monkeypatch.setattr(klt, "track_keypoints", k1)
    monkeypatch.setattr(gram, "reproj_factor_gram", k2)
    monkeypatch.setattr(gram, "preint_factor_gram", k3)
    monkeypatch.setattr(pre, "integrate_batch", k4)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a, **k: None)


def test_dataset_and_localizer_phases_rehearsal(monkeypatch, tmp_path):
    counting_plain_kernels(monkeypatch)
    dev = torch.device("cpu")
    res = chip_smoke.dataset_phase(dev, str(tmp_path / "euroc"), n_frames=60, width=320,
                                   height=240, focal=260.0, min_tracked=20)
    assert res["frames_tracked"] >= 20 and res["ate_m"] <= 0.25
    assert res["depth_scale"] > 0 and res["depth_seeded"] > 0
    assert res["launches"]["klt_level"] == res["frame_pairs_tracked"] == 59
    assert res["entry_launches"]["reproj_gram"]["reproj_factor_gram_launch"] > 0
    assert {"read_image_time", "read_depth_time", "decode_time"} <= set(res["stage_ms"])
    assert res["frames_per_s_no_reader"] > res["frames_per_s"] > 0
    # the CLI's 40 frames with --viz: tracking from about frame 30, one
    # overlay per frame the tracker processed (the 40th waits for its IMU)
    assert res["cli"]["frames_tracked"] > 0
    assert res["cli"]["overlays"] == res["cli"]["frames_processed"] == 39
    loc = chip_smoke.localizer_phase(dev, res, n_frames=60, min_tracked=20)
    assert loc["registered"] and loc["global_err_m"] < 0.5 and loc["slam_frame_dist_m"] > 1.0
    assert loc["ar_object"] > 0 and loc["ar_isolated"]
    assert loc["http"]["registered"] and loc["http"]["T_err"] < 1e-9
    assert loc["depth_keyframes"] > 0
    # the 60th frame still waits for its IMU when the drive stops at it
    assert loc["launches"]["klt_level"] == loc["frame_pairs_tracked"] == 58


def test_validator_phase_rehearsal():
    """`validator_phase` on the window of the committed JAX checkpoint
    (K=12 slots, 96 landmark slots, a marginalization prior), restored
    on the CPU: the four analytic Jacobians pass."""
    from xrslam_tpu_torch.core.detail import SyntheticTracker
    from xrslam_tpu_torch.utils import checkpoint
    from tests.test_torch_checkpoint import JAX_CKPT, make_config

    pipe = checkpoint.load_pipeline(JAX_CKPT, make_config(), SyntheticTracker(device="cpu"),
                                    device="cpu")
    res = chip_smoke.validator_phase(pipe.swt)
    assert set(res["errors"]) == {"reproj_closed", "preint", "rotation", "marg"}
    assert max(res["errors"].values()) < res["max_jacobian_error"]
    assert res["K"] == 12 and res["L"] == 96 and res["landmarks"] > 20


@pytest.mark.slow
def test_checkpoint_phase_rehearsal(monkeypatch, tmp_path):
    """The checkpoint phase's runs on the CPU at small sizes, in this
    process (the card's phase spawns the bearing runs, whose processes
    would not see the patched wrappers): the bearing-fed bench scene
    with PARSAC on, 34 frames cut at 30, straight against resumed; and
    the image run of the 320x240 scene, 42 frames cut at 34."""
    from xrslam_tpu_torch.tools.make_dataset import render_sequence

    counting_plain_kernels(monkeypatch)
    dev = torch.device("cpu")
    frames, cut = 34, 30
    straight = chip_smoke.checkpoint_bearing_run(True, frames, None, dev)
    resumed = chip_smoke.checkpoint_bearing_run(True, frames, cut, dev,
                                                str(tmp_path / "b.npz"))
    t_cut = float(chip_smoke.bench_bearing_scene(frames)["scene"].t[cut - 1])
    res = chip_smoke.compare_bearing_runs("rehearsal", straight, resumed, t_cut, True,
                                          frames, cut)
    assert res["tail_frames"] >= 3 and res["tail_err_m"] <= chip_smoke.CKPT_TAIL_TOL_M
    assert res["restored_on"] == "cpu" and res["launches"]["klt_level"] == 0
    seq = render_sequence(n_frames=42)
    img = chip_smoke.checkpoint_image_run(dev, seq, str(tmp_path / "i.npz"), cut=34,
                                          n_frames=42, min_tracked=5)
    assert img["tracked_before_cut"] > 0 and img["frames_tracked"] > img["tracked_before_cut"]
    # the first frame after the resume has no previous pyramid
    assert img["frame_pairs_tracked"] == 40 == img["launches"]["klt_level"]


@pytest.mark.slow
def test_bench_phase_rehearsal(monkeypatch, tmp_path):
    """`bench_phase` at 320x240 on 44 frames (one timed pass, no warm-up)
    on the CPU: its line parses, the kernels count as the main drive's."""
    counting_plain_kernels(monkeypatch)
    res = chip_smoke.bench_phase(torch.device("cpu"), str(tmp_path), frames=44, width=320,
                                 height=240, focal=260.0, min_share=0.2)
    assert res["device"] == "cpu" and res["card"] is None
    assert len(res["pass_frames_per_s"]) == 1 and res["warmup_passes"] == 0
    assert res["latency_ms"]["frames"] == 43 and res["latency_ms"]["p90"] >= \
        res["latency_ms"]["median"] > 0
    # one pass of 43 processed frames: 42 frame pairs
    assert res["frame_pairs_tracked"] == 42 == res["launches"]["klt_level"]


@pytest.mark.slow
def test_schedules_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 12b's drives and checks in this process, on the CPU at the
    card's 752x480 (at 320x240 the scene tracks at ATE 0.15 m, and the
    two-frame lag's published poses part by 5 cm) on 44 frames, and the
    bearing scene on 34: the synchronous benchmark pass, the pipelined
    one held to it (tracked, last output time, final window, positions,
    kernels), and the bearing drives with PARSAC straight and
    overlapped. (On the card the drives run in processes of their own,
    `start_schedules`, whose kernel wrappers this test could not
    replace.)"""
    counting_plain_kernels(monkeypatch)
    dev = torch.device("cpu")
    size = dict(frames=44, width=752, height=480, focal=458.0, min_share=0.2)
    sync = chip_smoke.bench_phase(dev, str(tmp_path), **size)
    pipe = chip_smoke.bench_phase(dev, str(tmp_path), schedule="pipelined", **size)
    res = chip_smoke.schedules_phase(sync, pipe, *(chip_smoke.schedule_bearing_run(dev, o, 34)
                                                   for o in (False, True)))
    assert res["window_err"] <= chip_smoke.SCHEDULE_WINDOW_TOL
    assert res["pos_err_m"] < chip_smoke.SCHEDULE_POS_TOL_M and res["common_outputs"] >= 5
    assert res["pipelined"]["frame_pairs_tracked"] == 42 == \
        res["pipelined"]["launches"]["klt_level"]
    assert res["bearings_window_err"] <= chip_smoke.SCHEDULE_WINDOW_TOL
    assert res["bearings_overlap"]["launches"]["klt_level"] == 0
    assert res["bearings_overlap"]["launches"]["reproj_gram"] > 0


@pytest.mark.slow
def test_chained_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 12c's pass and checks in this process, on the CPU at
    752x480 on 44 frames beside the sync and pipelined passes of 12 and
    12b (on the card each runs in a process of its own): the chained
    route carries the frame pairs, K1 launched once for each."""
    counting_plain_kernels(monkeypatch)
    dev = torch.device("cpu")
    size = dict(frames=44, width=752, height=480, focal=458.0, min_share=0.2)
    sync, pipe, chained = (chip_smoke.bench_phase(dev, str(tmp_path), schedule=s, **size)
                           for s in ("sync", "pipelined", "chained"))
    res = chip_smoke.chained_phase(sync, pipe, chained)
    routes = res["tracker_routes"]
    assert routes == {"chained_frames": 42, "standard_frames": 1, "reseeds": 1}
    assert res["frame_pairs_tracked"] == 42 == res["launches"]["klt_level"]
    assert res["launches"]["reproj_gram"] > 0


def test_ab_tools_phase_fails_without_kernel_routes(monkeypatch):
    """On the CPU the tools report their kernel routes as not run, which
    fails the phase (on the card every route must run)."""
    monkeypatch.setattr(chip_smoke, "AB_ASSEMBLE_SIZES", ((4, 32),))
    monkeypatch.setattr(chip_smoke, "AB_REPS", 1)
    with pytest.raises(SystemExit):
        chip_smoke.ab_tools_phase(torch.device("cpu"))


@pytest.mark.parametrize("fault", [None, "no_agree", "route_disagrees", "route_missing"])
def test_ab_tools_phase_checks(monkeypatch, fault):
    """The phase passes a tool's line only if every route of the tool's
    ROUTES ran, each route says it agrees and the line says so too: a
    line without its `agree` key fails."""
    from xrslam_tpu_torch.tools import ab_assemble, ab_klt_precision, ab_lk_backend

    def fake(tool):
        def run(*a, **kw):
            line = {"device": "cuda", "reference": "plain", "agree": True}
            line.update({r: {"ms": 1.0, "agree": True} for r in tool.ROUTES})
            if tool is ab_lk_backend and fault == "no_agree":
                del line["agree"]
            if tool is ab_klt_precision and fault == "route_disagrees":
                line["kernel_f32"]["agree"] = False
            if tool is ab_assemble and fault == "route_missing":
                line["kernel"] = "not run: cpu"
            return line
        return run

    for tool in (ab_assemble, ab_lk_backend, ab_klt_precision):
        monkeypatch.setattr(tool, "run", fake(tool))
    if fault is None:
        out = chip_smoke.ab_tools_phase(torch.device("cpu"))
        assert len(out["ab_assemble"]["lines"]) == len(chip_smoke.AB_ASSEMBLE_SIZES)
    else:
        with pytest.raises(SystemExit):
            chip_smoke.ab_tools_phase(torch.device("cpu"))


def test_compare_windows():
    """Phase 12b's window check: equal windows pass with their largest
    difference; other frames, or a difference beyond 1e-9, fail the
    run."""
    q, p, v = np.array([1.0, 0, 0, 0]), np.zeros(3), np.zeros(3)
    a = [(0.1, q, p, v), (0.2, q, p + 1.0, v)]
    b = [(0.1, q, p, v), (0.2, q, p + 1.0 + 5e-10, v)]
    assert chip_smoke.compare_windows("w", a, b) == pytest.approx(5e-10, abs=1e-15)
    for other in ([(0.1, q, p, v)], [(0.1, q, p, v), (0.2, q, p + 1.0 + 2e-9, v)], []):
        with pytest.raises(SystemExit):
            chip_smoke.compare_windows("w", a if other else [], other)


def test_factor_gram_batch_phase_rehearsal(monkeypatch):
    """The batched K2 phase at K_sub=11, L=384, N=4 with the wrapper
    replaced by its plain version counting as the kernel does: its
    agreement, row and N=1 checks, the one-launch count and the bound."""
    def k2(state, data):
        build.REPROJ_GRAM.count("reproj_factor_gram_launch",
                                windows=state.q.shape[0] if state.q.dim() == 3 else 1)
        return gram.reproj_factor_gram_plain(state, data)

    monkeypatch.setattr(gram, "reproj_factor_gram_cuda", k2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, calls=20, reps=10: (fn(), 0.5)[1])
    res = chip_smoke.factor_gram_batch_phase(torch.device("cpu"))
    assert (res["N"], res["K"], res["L"]) == (4, 11, 384)
    assert res["max_abs_err"] == 0.0
    assert res["ms"] == res["four_single_ms"] == 2.0 and res["device_ms"] == 0.5
    assert res["bound_by"] == "bytes" and res["bound_ms"] > 0
    assert res["active_observations"] > 4 * 11 * 384 // 2


def test_preint_gram_phase_rehearsal(monkeypatch):
    """K3's phase at K=12, 11 and 2 with the wrapper replaced by the
    closed-form plain version: its agreement, repeat and symmetry checks
    and its bound."""
    from xrslam_tpu_torch.estimation import factors

    def k3(state, data, mask, H=None, b=None):
        return gram.preint_factor_gram_plain(state, data, mask, H, b,
                                             jac=factors.preint_residual_jac_closed)

    monkeypatch.setattr(gram, "preint_factor_gram_cuda", k3)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, calls=20, reps=10: (fn(), 0.5)[1])
    res = chip_smoke.preint_gram_phase(torch.device("cpu"))
    assert set(res) == {"K12", "K11", "K2"}
    for one in res.values():
        assert one["max_rel_err_closed"] == 0.0 and one["max_rel_err_autodiff"] < 1e-14
        assert one["ms"] == one["plain_ms"] == 2.0 and one["device_ms"] == 0.5
        assert one["bound_by"] == "bytes" and one["bound_ms"] > 0
    assert res["K12"]["flops"] == 11 * chip_smoke.PREINT_FLOPS_PER_PAIR


def test_preint_scan_phase_rehearsal(monkeypatch):
    """K4's phase at its two shapes with the wrapper replaced by the
    plain loop: its agreement and repeat checks, its timing arithmetic
    (the device timer reads 0.5 ms at the shape's steps and 0.1 ms at
    one step) and its bound."""
    times = iter([0.5, 0.1] * len(chip_smoke.PREINT_SCAN_SHAPES))
    monkeypatch.setattr(pre, "integrate_batch_cuda", pre.integrate_batch_plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, calls=20, reps=10: (fn(), next(times))[1])
    res = chip_smoke.preint_scan_phase(torch.device("cpu"))
    assert set(res) == {"N12_S192_steps132", "N11_S128_steps33"}
    for (N, S, steps), one in zip(chip_smoke.PREINT_SCAN_SHAPES, res.values()):
        assert one["max_rel_err"] == 0.0
        assert one["ms"] == one["plain_ms"] == 2.0
        assert one["device_ms"] == 0.5 and one["device_ms_one_step"] == 0.1
        assert one["latency_floor_us"] == pytest.approx(steps * 400.0 / (steps - 1))
        assert one["flops"] == N * steps * chip_smoke.PREINT_SCAN_FLOPS_PER_STEP
        assert one == dict(one, **chip_smoke.bound(one["bytes"], one["flops"], 8))
        assert one["bytes"] > N * S * 7 * 8


def test_native_and_ros_phases_rehearsal(monkeypatch, tmp_path):
    """The native phase on a 12-frame 320x240 main drive (plain kernels
    counting), then the ROS node phase on 20 frames of a rendered
    dataset, both on the CPU."""
    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.tools.make_dataset import render_dataset, render_sequence

    counting_plain_kernels(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    dev = torch.device("cpu")
    seq = render_sequence(n_frames=12)
    args = []
    drive = chip_smoke.counted_drive(api.XRSLAM(config=seq["config"], device=dev), seq,
                                     dev, poisson_args=args)
    assert drive["native_calls"]["poisson_filter"] >= drive["frame_pairs_tracked"] == 11
    res = chip_smoke.native_phase(dict(drive, poisson_args=args))
    assert res["checked_calls"] == len(args) > 11 and res["build"]["library"]
    assert set(res["tracker_split_ms"]) >= {"tracker_preprocess_time", "rest"}
    # with depth images, as the dataset drive's: the node reads past them
    paths = render_dataset(str(tmp_path / "euroc"), n_frames=24, n_landmarks=500, width=320,
                           height=240, focal=260.0, seed=3, with_depth=True)
    ros = chip_smoke.ros_phase(dev, {"paths": paths})
    assert ros["engine_frames"] == ros["remaps"] == 20 and ros["pending"] == 0
    assert ros["launches"]["klt_level"] == ros["frame_pairs_tracked"] == 19


def test_capi_phase_rehearsal(monkeypatch, tmp_path):
    """The C ABI phase at 320x240 on 42 frames on the CPU: the drive
    through the shim in this process (the plain kernels counting, since
    the shim runs this interpreter's modules), then the C round trip."""
    from xrslam_tpu_torch import capi_host
    from xrslam_tpu_torch.tools.make_dataset import render_dataset, render_sequence

    counting_plain_kernels(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv(capi_host.DEVICE_ENV, "cpu")
    dev = torch.device("cpu")
    seq = render_sequence(n_frames=42)
    paths = render_dataset(str(tmp_path / "euroc"), n_frames=2, n_landmarks=500, width=320,
                           height=240, focal=260.0, seed=3)
    res = chip_smoke.capi_phase(dev, seq, {"paths": paths}, str(tmp_path), n_frames=42)
    assert res["device"] == "cpu" and res["frames_tracked"] >= 10
    # the 42nd frame waits for its IMU when the drive stops at it
    assert res["launches"]["klt_level"] == res["frame_pairs_tracked"] == 40
    assert res["standalone"]["linked"] and "CAPI_OK" in res["standalone"]["lines"]
    assert capi_host._engine is None


@pytest.mark.slow
def test_multiseq_phase_rehearsal(monkeypatch, tmp_path):
    counting_plain_kernels(monkeypatch)
    res = chip_smoke.multiseq_phase(torch.device("cpu"), str(tmp_path), n_seq=2, frames=44,
                                    width=320, height=240, focal=260.0, seeds=(3, 32))
    assert res["batched"]["k2_batched"]["launches"] > 0
    assert res["batched"]["k3_batched"]["launches"] > 0
    assert res["batched"]["launches"]["reproj_gram"] < res["sequential"]["launches"][
        "reproj_gram"]


def test_sharded_phases_rehearsal(capsys):
    """The sharded phases on CPU ranks over gloo at K=4, L=32 (W = 2
    and 4; the data x model phase on four K=4, L=32 windows, 2
    iterations), the plain K2 standing in for the kernel: every
    agreement, bit-equality and K2-call check runs here. The one-rank
    NCCL check and K2 on the shards need the card."""
    res = chip_smoke.sharded_model_phase(torch.device("cpu"), K=4, L=32, widths=(2, 4),
                                         iters=3, timed=1, nccl=False,
                                         dxm=(4, 32, chip_smoke.DXM_SEEDS, 2))
    assert set(res["widths"]) == {2, 4} and res["cost"] < res["cost0"]
    for W, one in res["widths"].items():
        assert one["backend"] == "gloo" and one["collectives_per_solve"] == 2 * 3 + 1
        assert one["bytes_per_collective"] > 8 * (4 * 15) ** 2
        assert one["launches"]["reproj_gram"] == 0      # the plain version
    assert res["data_x_model"]["windows_per_k2_call"] == 2
    assert "nccl" not in res and res["k2_shard"] is None
    out = capsys.readouterr().out
    assert "W=4 ranks sharing cpu over gloo" in out and "data x model" in out


def test_k2_shard_phase_rehearsal(monkeypatch, capsys):
    """K2's fused entry on every shard of a K=4, L=32 window at W = 1, 2
    and 4, the plain version standing in for the kernel, each shard
    held to the plain version; the CUDA timers stubbed."""
    from xrslam_tpu_torch.estimation import gram

    calls = []

    def k2(state, data):
        calls.append(int(state.inv_depth.shape[0]))
        return gram.reproj_factor_gram_plain(state, data)

    monkeypatch.setattr(gram, "reproj_factor_gram_cuda", k2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, calls=20, reps=10: (fn(), 0.5)[1])
    state, data = perturbed_demo_window(4, 32, chip_smoke.SHARD_SEED, torch.device("cpu"))
    res = chip_smoke.k2_shard_phase(state, data, (2, 4))
    assert sorted(res) == [8, 16, 32]
    for n, one in res.items():
        assert one["shards_checked"] == 32 // n and one["max_abs_err"] == 0.0
        assert one["bound_ms"] > 0 and one["plain_ms"] == 2.0
    assert calls.count(32) >= 1 and calls.count(16) >= 2 and calls.count(8) >= 4
    assert "over all 4 shards" in capsys.readouterr().out


def test_nullspace_phase_rehearsal(monkeypatch):
    """The null-space timing phase on CPU tensors: both routes span the
    null space of the 64 hypotheses' constraints; the CUDA timer
    stubbed."""
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 1.0)[1])
    res = chip_smoke.nullspace_phase(torch.device("cpu"),
                                     {"nullspace_calls": 12, "frames": 6})
    assert res["host_max_abs_Av"] < 1e-9 and res["card_max_abs_Av"] < 1e-9
    assert res["ms_per_frame"] == 0.0 and res["calls"] == 12


def test_scaling_phase_rehearsal(capsys):
    """`run_scaling` at a toy size in a process of its own, ranks on the
    CPU, started and then awaited as `chip_smoke.main` does."""
    started = chip_smoke.start_scaling(torch.device("cpu"), devices=(1, 2),
                                       extra=("--frames", "4", "--landmarks", "32",
                                              "--iters", "2", "--batch", "2"))
    res = chip_smoke.finish_scaling(started)
    assert [r["devices"] for r in res["rows"]["model"]] == [1, 2]
    assert "run_scaling [data] 2 ranks on the CPU (gloo)" in capsys.readouterr().out


def test_beside_runs_jobs_in_processes_of_their_own():
    """`beside`, as `chip_smoke.main` runs phases beside others: each job
    in a spawned process, its result and seconds handed back; a job's
    `fail` ends the reader of its future too."""
    with chip_smoke.beside((chip_smoke.budgeted_iterations, 0.1, 0.03, 10),
                           (chip_smoke.fail, "a job failed")) as (ok, bad):
        out, seconds = ok.result(timeout=120)
        with pytest.raises(SystemExit):
            bad.result(timeout=120)
    assert out == chip_smoke.budgeted_iterations(0.1, 0.03, 10) == 3 and seconds >= 0


def test_gram_form_yardstick_rehearsal(monkeypatch):
    """K2's library yardstick on CPU tensors: the Gram form held to the
    plain version at gram_phase's tolerance, its operators counted; the
    CUDA timers stubbed."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, calls=20, reps=10: (fn(), 0.5)[1])
    xs, _ = chip_smoke.gram_inputs(12, 384, 1, torch.float64, torch.device("cpu"))
    ref = gram.reproj_gram_plain(*xs)
    res = chip_smoke.gram_form_yardstick("K=12 L=384 float64", xs, ref, 1e-9,
                                         {"ms": 1.0, "device_ms": 0.25})
    assert res["max_abs_err"] < 1e-9 and res["ms"] == 2.0 and res["device_ms"] == 0.5
    assert 0 < res["kernel_calls"] < res["operators"]


def test_mobile_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 7b at its full size (640x480, 60 frames, the shipped
    configs/iphone_slam.yaml) with the counting plain kernels: every
    check of the phase runs here, the budget calibrated on the CPU's
    solve times."""
    counting_plain_kernels(monkeypatch)
    res = chip_smoke.mobile_phase(torch.device("cpu"), str(tmp_path / "mobile"))
    assert res["frames_tracked"] >= 10 and res["ate_m"] <= 0.25
    assert 2 * res["pnp_frames"] >= res["frames_tracked"]
    assert res["solver_time_limit"] == 0.1
    assert res["launches"]["klt_level"] == res["frame_pairs_tracked"] == 59
    calibrated = {v: b for v, b in res["budget"].items() if b["est_ms_per_iter"]}
    assert calibrated and all(b["budget_syncs"] == 3 for b in calibrated.values())
    assert any(b["solves_after"] for b in calibrated.values())
    assert res["budget_syncs"] == sum(b["budget_syncs"] for b in res["budget"].values())


def test_budget_rule_restated():
    """`chip_smoke.budgeted_iterations` (the phase's own statement of the
    rule) against the port's tracker on a grid of estimates."""
    from xrslam_tpu_torch.config import Config
    from xrslam_tpu_torch.core.map import PipelineMap
    from xrslam_tpu_torch.core.sliding_window import SlidingWindowTracker
    from xrslam_tpu_torch.estimation.solver import SolveOptions

    swt = SlidingWindowTracker(PipelineMap(), Config(solver_time_limit=0.1), "cpu")
    for est in (None, 1e-4, 0.001, 0.004, 0.0065, 0.012, 0.02, 0.043, 0.051, 0.2):
        swt._iter_seconds.clear()
        if est is not None:
            swt._iter_seconds.update(v=est)
        for share in (1, 2, 10):
            want = swt._budget_chained("v", SolveOptions(iterations=share),
                                       SolveOptions(iterations=10)).iterations
            assert chip_smoke.budgeted_iterations(0.1, est, 10, share) == want
        assert chip_smoke.budgeted_iterations(0.1, est, 10) == \
            swt._budgeted_iterations("v")
