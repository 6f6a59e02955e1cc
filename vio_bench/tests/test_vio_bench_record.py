"""The arithmetic of the readers of the program's trace record
(`vio_bench/record.py` and the six metrics over it) on synthetic
records: which frames each reads, which kernels fall in the LM loops,
and None where the run kept nothing to read."""

import pytest

from vio_bench import record, run
from vio_bench.trace import Trace

MS = 1_000_000
RECORD_METRICS = ("lm_kernels_per_iteration", "keyframe_ms", "host_syncs_per_frame",
                  "initializer_ms")
TAP_METRICS = ("lm_solve_ms", "lm_busy_pct")


def frame(fid, start, end, kind, sid):
    return dict(name="frame", id=sid, parent=None, frame=fid, tags=dict(kind=kind),
                start_ns=start, end_ns=end, counters={})


def span(name, fid, start, end, sid, parent, **counters):
    return dict(name=name, id=sid, parent=parent, frame=fid, tags={},
                start_ns=start, end_ns=end, counters=counters)


@pytest.fixture
def res():
    """Two set-up frames (ids 10, 11), then window frames 0-3 (ids 12-15)
    with the traced stretch at window frames 2-3. Tap spans are on the
    host clock, `off_ns` = 1,000 ms ahead of it on the trace's."""
    off = 1000 * MS
    tap = [("backend_time", 0, 0, 1500 * MS), ("lm_solve", 0, 100 * MS, 400 * MS),
           ("lm_solve", 0, 500 * MS, 700 * MS),
           ("backend_time", 1, 2000 * MS, 2500 * MS), ("lm_solve", 1, 2100 * MS, 2200 * MS),
           # the traced stretch: frames 2-3
           ("backend_time", 2, 3000 * MS, 3500 * MS), ("lm_solve", 2, 3000 * MS, 3010 * MS),
           ("lm_solve", 3, 3100 * MS, 3120 * MS)]
    ops = [("k", 4000 * MS, 4002 * MS), ("k", 4001 * MS, 4004 * MS),   # in frame 2's loop
           ("Memcpy DtoH", 4005 * MS, 4006 * MS),                      # a copy, not a kernel
           ("k", 4011 * MS, 4012 * MS),                                 # after the loop
           ("k", 4100 * MS, 4101 * MS), ("k", 4119 * MS, 4130 * MS)]    # frame 3's loop
    tr = Trace(ops=ops, start_ns=3900 * MS, end_ns=4200 * MS)
    t = [0, 900, 1000, 1700, 2000, 2600, 3900, 4050, 4090, 4200]
    spans = [frame(10, t[0] * MS, t[1] * MS, "init", 0),
             span("initializer_time", 10, 100 * MS, 400 * MS, 1, 0),
             frame(11, t[2] * MS, t[3] * MS, "init", 2),
             span("initializer_time", 11, 1100 * MS, 1300 * MS, 3, 2),
             span("lm_solve", 11, 1150 * MS, 1200 * MS, 4, 3, lm_iterations=10),
             frame(12, t[4] * MS, t[5] * MS, "keyframe", 5),
             frame(13, 3000 * MS, 3400 * MS, "subframe", 6),
             frame(14, t[6] * MS, t[7] * MS, "keyframe", 7),
             span("lm_solve", 14, 4000 * MS, 4010 * MS, 8, 7, lm_iterations=10),
             frame(15, t[8] * MS, t[9] * MS, "subframe", 9),
             span("lm_solve", 15, 4100 * MS, 4120 * MS, 10, 9, lm_iterations=5)]
    rec = dict(clock="unix_ns", spans=spans,
               frames={10: dict(initializer_attempts=2, host_syncs=4),
                       11: dict(initializer_attempts=1, lm_iterations=10, host_syncs=9),
                       12: dict(host_syncs=30), 13: dict(host_syncs=50),
                       14: dict(host_syncs=1000, lm_iterations=10),
                       15: dict(host_syncs=1000, lm_iterations=5)})
    return dict(spans=tap, trace=tr, trace_frames=(2, 3), off_ns=off, frames=4, frame0=2,
                record=rec)


def read(name, res):
    return run.metric_reader(name)(res)


def test_tap_readers(res):
    # (300 + 200 + 100) ms of LM loops over 2 backend frames before the stretch
    assert read("lm_solve_ms", res) == pytest.approx(300.0)
    # the loops of frames 2-3 hold 30 ms; the kernels started in them are
    # busy 4 + 1 + 11 ms (the union; the copy and the kernel after the
    # loop left out)
    assert read("lm_busy_pct", res) == pytest.approx(100 * 16 / 30)


def test_record_readers(res):
    # 4 kernels in the stretch's loops over 15 iterations
    assert read("lm_kernels_per_iteration", res) == pytest.approx(4 / 15)
    # window frames 0-1 (ids 12, 13) before the stretch: one keyframe of 600 ms
    assert read("keyframe_ms", res) == pytest.approx(600.0)
    assert read("host_syncs_per_frame", res) == pytest.approx((30 + 50) / 2)
    # set-up: 300 + 200 ms over 3 attempts
    assert read("initializer_ms", res) == pytest.approx(500 / 3)


def test_frames_in_drive_order(res):
    res["record"]["spans"].reverse()
    assert [s["frame"] for s in record.frames(res)] == [10, 11, 12, 13, 14, 15]
    assert [s["frame"] for s in record.setup_frames(res)] == [10, 11]
    assert [s["frame"] for s in record.untraced_frames(res)] == [12, 13]


@pytest.mark.parametrize("name", RECORD_METRICS + TAP_METRICS)
def test_nothing_to_read(res, name):
    """A run that kept no record (the parent's program, or the record
    off) and, for the tap readers, a program without `lm_solve`."""
    res.pop("record")
    res["spans"] = [s for s in res["spans"] if s[0] != "lm_solve"]
    assert read(name, res) is None
    res.pop("trace")
    assert read(name, res) is None
