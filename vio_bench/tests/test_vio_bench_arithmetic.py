"""The arithmetic of the metrics: the end-to-end rate and tail, the
per-layer readers, the trace reduction, and the roofline counts held
against the values `chip_smoke.py` printed at the main shapes."""

import numpy as np
import pytest

from vio_bench import layers, roofline, run
from vio_bench.trace import Trace

PYR_752 = [(480, 752), (240, 376), (120, 188), (60, 94)]


def test_rate_counts_a_stalled_frame():
    lat = [100.0] * 9 + [5000.0]             # one frame stalls for 5 s
    res = dict(frames=10, window_s=sum(lat) / 1e3, latency_ms=lat, setup_s=1.0)
    m = run.e2e_metrics(res)
    assert m["frames_per_s"] == pytest.approx(10 / 5.9)
    assert m["setup_s"] == 1.0


def test_p90_over_all_samples():
    lat = list(np.arange(1.0, 101.0))
    res = dict(frames=100, window_s=1.0, latency_ms=lat, setup_s=0.0)
    assert run.e2e_metrics(res)["frame_latency_p90_ms"] == pytest.approx(90.1)


def test_k1_counts_at_the_main_shapes():
    """3.84 MB a frame pair with all 256 slots counted. chip_smoke.py's
    3.78 MB counted the points its GFTT run kept alive (fewer than 256),
    so its level-0 reads were smaller; the images and the slots bound
    both counts from above."""
    n_bytes, flops = roofline.k1_counts(PYR_752, 256)
    images = 2 * sum(h * w * 4 for h, w in PYR_752)
    assert n_bytes == images + 256 * 26
    assert n_bytes / 1e6 == pytest.approx(3.84, abs=0.005)
    assert 3.78e6 < n_bytes
    t, bound = roofline.least_seconds(n_bytes, flops, 4)
    assert bound == "bytes" and t == pytest.approx(1.147e-6, rel=1e-3)


def test_k2_counts_at_the_main_shapes():
    """0.39 MB at K=12, L=384 in float64, as chip_smoke.py printed."""
    n_bytes, flops = roofline.k2_counts(12, 384, 8)
    assert n_bytes == 391304
    t, bound = roofline.least_seconds(n_bytes, flops, 8)
    assert bound == "bytes" and t * 1e6 == pytest.approx(0.117, abs=0.001)
    assert roofline.k2_counts(12, 384, 8, N=4)[0] == 4 * n_bytes


def test_roofline_share_from_known_counts():
    res = dict(k1_calls=[dict(levels=PYR_752, slots=256, win=21)] * 2,
               k2_calls=[dict(K=12, L=384, itemsize=8, N=1)] * 3)
    t1, b1 = layers.k1_least(res)
    t2, b2 = layers.k2_least(res)
    assert (b1, b2) == ("bytes", "bytes")
    assert layers.share_pct(t1, 2 * 100e-6) == pytest.approx(100 * t1 / 200e-6)
    assert layers.share_pct(t2, 0.0) is None and layers.share_pct(0.0, 1.0) is None


def trace_of(ops, start, end):
    return Trace(ops=sorted(ops, key=lambda o: o[1]), start_ns=start, end_ns=end)


def test_busy_time_is_the_union_of_operations():
    tr = trace_of([("a", 0, 10), ("b", 5, 20), ("Memcpy HtoD", 30, 40), ("c", 50, 60)], 0, 100)
    assert tr.busy_s() == pytest.approx(40e-9)
    assert tr.gaps() == [(20, 30), (40, 50), (60, 100)]
    assert [k[0] for k in tr.kernels()] == ["a", "b", "c"]
    assert [n for n, _ in tr.top_ops(2)] == ["b", "a"]
    assert [s for _, s in tr.top_ops(2)] == pytest.approx([15e-9, 10e-9])
    spans = [("outer", 0, 0, 100), ("inner", 0, 60, 90)]
    assert tr.idle_gaps(spans, 0, 2) == [["inner", 40e-9], ["outer", 10e-9]]


def test_per_layer_readers():
    spans = [("feature_tracker_time", 0, 0, 30_000_000), ("feature_tracker_time", 1, 0, 10_000_000),
             ("feature_tracker_time", 5, 0, 99_000_000),       # traced: left out
             ("backend_time", 0, 0, 1), ("subwindow_solve_time", 0, 0, 800_000_000),
             ("backend_time", 1, 0, 1), ("bundle_adjustor_solve_time", 1, 0, 1_000_000_000),
             ("bundle_adjustor_marginalization_time", 1, 0, 200_000_000)]
    tr = trace_of([("x", 0, 250), ("klt_track_kernel", 300, 400)], 0, 1000)
    res = dict(spans=spans, frames=2, trace_frames=(3, 10), trace=tr,
               k1_calls=[dict(levels=PYR_752, slots=256, win=21)], k2_calls=[],
               K1_KERNEL="klt_track_kernel", K2_KERNELS=("gram_main_kernel",))
    read = {n: run.metric_reader(n)(res) for n in (
        "frontend_ms", "window_solve_ms", "marginalization_ms", "visual_pnp_ms",
        "device_idle_pct", "kernels_per_frame", "k1_roofline_pct", "k2_roofline_pct")}
    assert read["frontend_ms"] == pytest.approx(20.0)
    assert read["window_solve_ms"] == pytest.approx(900.0)
    assert read["marginalization_ms"] == pytest.approx(200.0)
    assert read["visual_pnp_ms"] is None and read["k2_roofline_pct"] is None
    assert read["device_idle_pct"] == pytest.approx(65.0)
    assert read["kernels_per_frame"] == pytest.approx(2 / 8)
    assert read["k1_roofline_pct"] == pytest.approx(100 * 1.1468e-6 / 100e-9, rel=1e-3)
