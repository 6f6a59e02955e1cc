"""The mobile cell's entries and readers: `iphone.mobile1` and its
traffic against the contract, and the arithmetic of the per-layer
readers that only it reports (`pnp_keymap_ms`, `pnp_frame_ms.host`,
`budgeted_solve_ms`, beside `visual_pnp_ms`)."""

import json
import os

import pytest

from vio_bench import run, stream

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MOBILE = ("visual_pnp_ms", "pnp_keymap_ms", "pnp_frame_ms.host", "budgeted_solve_ms")
MS = 1_000_000


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_mobile_entries(bench):
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in MOBILE:
        m = per_layer[name]
        assert m["workloads"] == ["iphone.mobile1"] and m["moves"] == "frames_per_s"
    cell = {w["name"]: w for w in bench["workloads"]}["iphone.mobile1"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("iphone", "mobile1", 1)
    config = {c["name"]: c for c in bench["configs"]}["iphone"]
    assert config["file"] == "vio_bench/configs/iphone.json" and config["reduced"] == []


def test_mobile_traffic_is_stream1_longer():
    mobile, base = stream.load_traffic("mobile1"), stream.load_traffic("stream1")
    changed = {k for k in base if mobile[k] != base[k]}
    assert set(mobile) == set(base) and changed == {"why", "window_frames", "trace_frames"}
    assert mobile["window_frames"] == 1560 and mobile["trace_frames"] == [36, 47]
    # whole cycles of the backend's every-3rd-frame schedule on both sides
    lo, hi = mobile["trace_frames"]
    assert lo % 3 == 0 and (hi + 1 - lo) % 3 == 0


def mobile_res():
    """Two backend cycles before the stretch (frames 0-5; frame 6 on
    is traced and left out): frames 0 and 3 run the backend, the others
    only the PnP."""
    spans = [("visual_pnp_time", w, 0, 2 * MS) for w in range(6)]
    spans += [("backend_time", 0, 0, 1), ("pnp_keymap_time", 0, 0, 3 * MS),
              ("subwindow_solve_time", 0, 0, 90 * MS),
              ("backend_time", 3, 0, 1), ("pnp_keymap_time", 3, 0, 5 * MS),
              ("bundle_adjustor_solve_time", 3, 0, 130 * MS),
              ("visual_pnp_time", 7, 0, 99 * MS), ("backend_time", 9, 0, 1)]   # traced
    return dict(spans=spans, frames=10, trace_frames=(6, 9),
                latency_ms=[300.0, 40.0, 50.0, 200.0, 60.0, 70.0, 1.0, 1.0, 1.0, 1.0])


def test_mobile_readers():
    read = {n: run.metric_reader(n)(mobile_res()) for n in MOBILE}
    assert read["visual_pnp_ms"] == pytest.approx(2.0)
    assert read["pnp_keymap_ms"] == pytest.approx(4.0)
    assert read["pnp_frame_ms.host"] == pytest.approx(55.0)
    assert read["budgeted_solve_ms"] == pytest.approx(110.0)


def test_mobile_readers_find_nothing_elsewhere():
    """A window of the euroc cell (every frame a backend frame, no PnP)
    and one of PnP frames alone (no backend step before the stretch)."""
    euroc = dict(spans=[("feature_tracker_time", w, 0, MS) for w in range(4)]
                 + [("backend_time", w, 0, 1) for w in range(4)]
                 + [("subwindow_solve_time", w, 0, 200 * MS) for w in range(4)],
                 frames=6, trace_frames=(4, 5), latency_ms=[300.0] * 6)
    pnp_only = dict(spans=[("visual_pnp_time", w, 0, MS) for w in range(2)],
                    frames=4, trace_frames=(2, 3), latency_ms=[50.0] * 4)
    for name in ("visual_pnp_ms", "pnp_keymap_ms", "pnp_frame_ms.host"):
        assert run.metric_reader(name)(euroc) is None
    for name in ("pnp_keymap_ms", "budgeted_solve_ms"):
        assert run.metric_reader(name)(pnp_only) is None
    assert run.metric_reader("pnp_frame_ms.host")(pnp_only) == pytest.approx(50.0)
