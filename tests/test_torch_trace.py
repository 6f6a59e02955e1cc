"""The port's trace record (`utils/timing.StageTimes`): spans and
counters of each frame, on the CPU over a short image drive (320x240,
two LM iterations a solve, ~20 s), and on the card a span laid over the
device trace of the kernel it launched.

With the record off nothing is kept. With it on, every stage is a child
of its frame's `frame` span and carries the program's frame id; frames
carry their `kind`; the LM loop (`lm_solve`) nests under the backend
stage that runs it; `lm_iterations` and `initializer_attempts` count
what the solver and the initializer did; the benchmark's tap over
`times.stage` (`vio_bench/taps.Spans`) still sees every stage. This file
imports neither jax nor the JAX package; its card test runs with

    python -m pytest --noconftest tests/test_torch_trace.py -q -k card
"""

import time
import warnings

import numpy as np
import pytest
import torch

from vio_bench import taps
from xrslam_tpu_torch import api
from xrslam_tpu_torch.core.initializer import Initializer
from xrslam_tpu_torch.estimation import solver
from xrslam_tpu_torch.tools.make_dataset import events, render_sequence
from xrslam_tpu_torch.utils import timing
from xrslam_tpu_torch.utils.timing import SYNC_WARNING, StageTimes

BACKEND_STAGES = {"initializer_time", "bundle_adjustor_solve_time", "subwindow_solve_time",
                  "localize_newframe_time"}
KINDS = {"init", "track", "subframe", "keyframe"}


def drive(slam, seq, n_frames):
    """The benchmark's push order: a frame's IMU samples, its image and
    `run_one_frame`, then the samples at its own time, which close it."""
    A = api
    n_img = 0
    for t, kind, i in events(seq):
        if kind == 0:
            if n_img == n_frames:
                break
            slam.push_sensor_data(A.SensorType.CAMERA, t, seq["images"][i] / np.float32(255))
            slam.run_one_frame()
            n_img += 1
        else:
            sensor = A.SensorType.GYROSCOPE if kind == 1 else A.SensorType.ACCELERATION
            slam.push_sensor_data(sensor, t, (seq["imu_w"] if kind == 1 else seq["imu_a"])[i])


@pytest.fixture(scope="module")
def seq():
    torch.set_num_threads(4)
    return render_sequence(n_frames=38, width=320, height=240, focal=260.0)


@pytest.fixture(scope="module")
def traced(seq):
    """38 frames with the record on from the engine's construction and
    the benchmark's stage tap installed; the LM loops' iteration counts
    and the initializer's calls counted beside the record."""
    cfg = seq["config"].replace(solver_iteration_limit=2)
    slam = api.XRSLAM(config=cfg, device="cpu")
    slam.times.record(True)
    tap = taps.Spans()
    tap.install(slam.times)
    seen = dict(iterations=0, initialize=0)
    mp = pytest.MonkeyPatch()
    lm, init = solver._lm, Initializer.initialize

    def counted_lm(state, data, opts, *a):
        seen["iterations"] += opts.iterations
        return lm(state, data, opts, *a)

    def counted_init(self):
        seen["initialize"] += 1
        return init(self)

    mp.setattr(solver, "_lm", counted_lm)
    mp.setattr(Initializer, "initialize", counted_init)
    try:
        drive(slam, seq, 38)
    finally:
        mp.undo()
        slam.times.record(False)
    assert slam.pipeline.swt is not None, "the drive did not initialize"
    return dict(rec=slam.times.export(), tap=tap.spans, seen=seen, times=slam.times)


def test_record_off_keeps_nothing(seq):
    t = StageTimes()
    with t.frame(7, kind="track"):
        assert timing.active() is t
        with t.stage("a"):
            t.count("c", 3)
            with timing.host_wait():
                pass
        t.tag(7, kind="keyframe")
    assert timing.active() is None
    assert t.export()["spans"] == [] and t.export()["frames"] == {}
    assert t._spans == [] and t._frames == {} and t._frame_counters == {}
    assert set(t.means()) == {"a"}
    slam = api.XRSLAM(config=seq["config"], device="cpu")
    drive(slam, seq, 4)
    out = slam.times.export()
    assert out["spans"] == [] and out["frames"] == {}
    assert slam.times.means()["feature_tracker_time"] > 0


def test_stage_spans_have_parent_and_frame(traced):
    spans = traced["rec"]["spans"]
    by_id = {s["id"]: s for s in spans}
    frames = [s for s in spans if s["name"] == "frame"]
    assert len(frames) == 38
    assert len({s["frame"] for s in frames}) == 38
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["name"] == "frame":
            assert s["parent"] is None
            continue
        assert s["parent"] is not None and s["frame"] is not None, s
        top = s
        while top["parent"] is not None:
            top = by_id[top["parent"]]
            assert top["start_ns"] <= s["start_ns"] and s["end_ns"] <= top["end_ns"]
        assert top["name"] == "frame" and top["frame"] == s["frame"]


def test_frames_carry_their_kind(traced):
    kinds = [s["tags"]["kind"] for s in traced["rec"]["spans"] if s["name"] == "frame"]
    assert set(kinds) <= KINDS
    n_init = kinds.index(next(k for k in kinds if k != "init"))
    assert n_init > 8 and "init" not in kinds[n_init:]
    assert "keyframe" in kinds[n_init:] and "subframe" in kinds[n_init:]


def test_lm_solve_nests_under_a_backend_stage(traced):
    spans = traced["rec"]["spans"]
    by_id = {s["id"]: s for s in spans}
    lm = [s for s in spans if s["name"] == "lm_solve"]
    assert lm
    assert {by_id[s["parent"]]["name"] for s in lm} <= BACKEND_STAGES
    assert {by_id[s["parent"]]["name"] for s in lm} >= {"initializer_time",
                                                      "bundle_adjustor_solve_time"}


def test_counters(traced):
    rec, seen = traced["rec"], traced["seen"]

    def total(name, spans):
        return sum(s["counters"].get(name, 0) for s in spans)

    lm = [s for s in rec["spans"] if s["name"] == "lm_solve"]
    assert seen["iterations"] > 0 and seen["initialize"] > 0
    assert total("lm_iterations", lm) == seen["iterations"]
    assert total("lm_iterations", rec["spans"]) == seen["iterations"]
    assert all(s["counters"]["lm_iterations"] == 2 for s in lm)
    inits = [s for s in rec["spans"] if s["name"] == "initializer_time"]
    assert total("initializer_attempts", inits) == seen["initialize"]
    for name in ("lm_iterations", "initializer_attempts"):
        assert sum(c.get(name, 0) for c in rec["frames"].values()) == \
            total(name, rec["spans"])
    assert None not in rec["frames"]
    # no device here: nothing waits on one
    assert total("host_syncs", rec["spans"]) == 0


def test_tap_sees_every_stage(traced):
    names = [s["name"] for s in traced["rec"]["spans"] if s["name"] != "frame"]
    tapped = [s[0] for s in traced["tap"]]
    assert sorted(tapped) == sorted(names)
    assert {"feature_tracker_time", "backend_time", "lm_solve"} <= set(tapped)
    assert set(traced["times"].means()) == set(names)


def test_sync_warnings_counted_once():
    t = StageTimes()
    t.record(True)
    try:
        warnings.warn(SYNC_WARNING)            # outside frames: not counted
        with t.frame(1):
            with t.stage("s"):
                for _ in range(2):             # one line, counted each time
                    warnings.warn(SYNC_WARNING + " (Triggered internally at x.cpp:1.)")
            with timing.host_wait():
                warnings.warn(SYNC_WARNING)    # the explicit wait counts it
            with pytest.warns(UserWarning, match="unrelated"):
                warnings.warn("unrelated")
    finally:
        t.record(False)
    rec = t.export()
    assert rec["frames"] == {1: {"host_syncs": 3}}
    s, f = rec["spans"][1], rec["spans"][0]
    assert (s["name"], s["counters"]) == ("s", {"host_syncs": 2})
    assert (f["name"], f["counters"]) == ("frame", {"host_syncs": 1})
    assert warnings.showwarning is not timing._on_warning


def test_export_on_the_unix_clock():
    t = StageTimes()
    t.record(True)
    try:
        a = time.time_ns()
        with t.stage("s"):
            time.sleep(0.002)
        b = time.time_ns()
    finally:
        t.record(False)
    s = t.export()["spans"][0]
    assert t.export()["clock"] == "unix_ns"
    assert a - 50_000 <= s["start_ns"] < s["end_ns"] <= b + 50_000
    assert s["end_ns"] - s["start_ns"] >= 2_000_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_span_contains_its_kernel(dev):
    """A span around one synchronized matmul holds the matmul's device
    interval in a torch.profiler trace, once `export()` has converted
    it; the host syncs inside it count once each."""
    from torch.autograd import DeviceType

    x = torch.randn(4096, 4096, device=dev)
    (x @ x).sum().item()
    t = StageTimes()
    t.record(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with t.frame(0), t.stage("probe"):
                y = x @ x
                with timing.host_wait():
                    torch.cuda.synchronize(dev)
            with t.frame(1):
                y.sum().item()                  # sync-debug mode counts it
                with timing.host_wait():
                    y[0, :4].cpu()
    finally:
        t.record(False)
    rec = t.export()
    probe = next(s for s in rec["spans"] if s["name"] == "probe")
    gemm = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and "gemm" in e.name().lower()]
    assert gemm, [e.name() for e in prof.profiler.kineto_results.events()]
    k = min(gemm, key=lambda e: e.start_ns())
    assert probe["start_ns"] <= k.start_ns()
    assert k.start_ns() + k.duration_ns() <= probe["end_ns"]
    assert rec["frames"] == {0: {"host_syncs": 1}, 1: {"host_syncs": 2}}
