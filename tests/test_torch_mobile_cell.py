"""The benchmark's mobile cell, `iphone.mobile1` (the reference's iOS
profile: a camera-rate visual PnP pose on every frame, the backend on
every 3rd, window 5, solves held to 0.1 s), driven on the CPU through
`vio_bench.run.run_cell` with the trace record on.

The drive runs at the profile's own 640x480 and focal 478. At 320x240
the profile's 25 px keypoint spacing leaves too few tracks to
initialize within 110 frames, and with the spacing halved the
camera-rate PnP against a young map of a few dozen landmarks drags the
trajectory past the configuration's ATE bound. Set-up settles for 4
frames, the window runs 18 frames (6 backend cycles), counted by a
stand-in clock so that the host's speed does not set the stream's
length, and the comparison draws one sample of each kind (the frontend's
from window frames 1-8, before the stretch a traced run would trace).

- every check within its limit, the camera-rate poses (`pose_gap_m`:
  every published pose against the reference's IMU propagation of the
  state it started from) and the PnP refines (`pnp_gap_m`) among them;
- the trace record holds what the mobile path adds: the `pnp` tag on
  the frames that ran the PnP, `pnp_keymap_time` inside `backend_time`,
  and the counters `pnp_published`, `imu_samples_replayed` and
  `budget_clamped` (the CPU's solves overrun the 0.1 s budget).
"""

import time
import types

import pytest
import torch

from vio_bench import check, run, stream, taps
from xrslam_tpu_torch import api

SEED = 2**31 + 101
WINDOW_FRAMES = 18


@pytest.fixture(scope="module")
def drive():
    mp = pytest.MonkeyPatch()
    clock = {"off": 0.0, "window": False, "n": 0}
    engines = []
    real = time.perf_counter
    mp.setattr(run, "time", types.SimpleNamespace(
        perf_counter=lambda: real() + clock["off"], perf_counter_ns=time.perf_counter_ns,
        time_ns=time.time_ns))
    solves_init = taps.Solves.__init__

    def window_starts(tap, *a, **kw):
        clock["window"] = True
        solves_init(tap, *a, **kw)

    frame = run.Driver.frame

    def counted(drv, i):
        out = frame(drv, i)
        if clock["window"]:
            clock["n"] += 1
            if clock["n"] >= WINDOW_FRAMES:
                clock["off"] = 1e9      # the window's seconds are up
        return out

    class Recorded(api.XRSLAM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times.record(True)
            engines.append(self)

    traffic = stream.load_traffic
    mp.setattr(taps.Solves, "__init__", window_starts)
    mp.setattr(run.Driver, "frame", counted)
    mp.setattr(api, "XRSLAM", Recorded)
    mp.setattr(stream, "load_traffic",
               lambda n: dict(traffic(n), settle_frames=4, check_samples=1,
                              trace_frames=[9, 12]))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bench = run.load_benchmark()
        cell = {c["name"]: c for c in bench["workloads"]}["iphone.mobile1"]
        res = run.run_cell(bench, cell, SEED, 1e6, False, "cpu", real(), n_frames=80)
        rec = engines[0].times.export()
        engines[0].times.record(False)
    finally:
        torch.set_num_threads(n)
        mp.undo()
    return res, rec


def test_mobile_cell_is_correct(drive):
    res, _ = drive
    assert res["frames"] == WINDOW_FRAMES and res["failed"] == 0
    assert set(res["checks"]) == {"solve_gap", "marg_gap", "track_lost_share", "track_gap_px",
                                  "pyramid_gap", "pose_gap_m", "ate_m", "pnp_gap_m"}
    assert res["correct"], res["checks"]
    assert res["checks"]["pose_gap_m"]["value"] <= check.LIMITS["pose_gap_m"] == 1e-11
    assert res["checks"]["pnp_gap_m"]["value"] <= check.LIMITS["pnp_gap_m"] == 1e-10
    assert res["samples"]["pnp"] >= 1 and res["samples"]["poses"] == WINDOW_FRAMES


def test_mobile_path_in_the_record(drive):
    res, rec = drive
    spans = rec["spans"]
    by_id = {s["id"]: s for s in spans}
    pnp_tags = [s["tags"]["pnp"] for s in spans if s["name"] == "frame" and "pnp" in s["tags"]]
    assert set(pnp_tags) <= {"published", "skipped"} and "published" in pnp_tags
    keymap = [s for s in spans if s["name"] == "pnp_keymap_time"]
    assert keymap and all(by_id[s["parent"]]["name"] == "backend_time" for s in keymap)
    assert None not in rec["frames"]       # every counter with a frame
    totals = {}
    for counters in rec["frames"].values():
        for k, v in counters.items():
            totals[k] = totals.get(k, 0) + v
    assert totals["pnp_published"] == pnp_tags.count("published")
    assert totals.get("pnp_skipped", 0) == pnp_tags.count("skipped")
    assert totals["imu_samples_replayed"] > 0 and totals["budget_clamped"] > 0
    # two frames in three run the PnP and no backend step
    pnp_only = [s for s in spans if s["name"] == "frame" and "pnp" in s["tags"]
                and s["tags"]["kind"] == "track"]
    assert len(pnp_only) >= len(pnp_tags) // 2
