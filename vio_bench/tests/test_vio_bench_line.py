"""The result line: its keys, the metrics each mode reports, `checks`
last; and a run's exits where it cannot give a result."""

import json
import os
import subprocess
import sys

import pytest

from vio_bench import run
from vio_bench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 123}


def fake_res(trace):
    res = dict(frames=20, window_s=18.0, setup_s=30.0, failed=0, correct=True,
               latency_ms=[900.0] * 20,
               checks={"solve_gap": dict(value=1e-9, limit=1e-3),
                       "ate_m": dict(value=0.01, limit=0.25)})
    if trace:
        res.update(spans=[("feature_tracker_time", 0, 0, 20_000_000),
                          ("backend_time", 0, 0, 1),
                          ("subwindow_solve_time", 0, 0, 800_000_000),
                          ("bundle_adjustor_marginalization_time", 0, 0, 1)],
                   trace=Trace(ops=[("klt_track_kernel", 10, 110), ("gram_main_kernel", 200, 220),
                                    ("gram_reduce_kernel", 220, 224)], start_ns=0, end_ns=1000),
                   k1_calls=[dict(levels=[(480, 752), (240, 376)], slots=256, win=21)],
                   k2_calls=[dict(K=12, L=384, itemsize=8, N=1)], trace_frames=(3, 10),
                   off_ns=0, K1_KERNEL="klt_track_kernel",
                   K2_KERNELS=("gram_main_kernel", "gram_reduce_kernel"))
    return res


@pytest.mark.parametrize("trace", [0, 1])
def test_line_schema(trace):
    bench = run.load_benchmark()
    for c in bench["workloads"]:
        check_line(bench, c, trace)


def check_line(bench, c, trace):
    cell = c["name"]
    line = run.result_line(bench, c, fake_res(trace), bool(trace), DEVICE)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["checks"]["solve_gap"] == [1e-9, 1e-3]
    json.dumps(line)
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    if not trace:
        assert set(line["metrics"]) == want
        assert line["metrics"]["frames_per_s"] == {"value": 20 / 18.0, "unit": "frames/s"}
    else:
        # what the fake record holds to read; nothing reads 0 for a share
        assert set(line["metrics"]) <= want and "frontend_ms" in line["metrics"]
        assert "k2_roofline_pct" in line["metrics"] and "k1_roofline_pct" in line["metrics"]
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["device_ops"]) <= 10


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "vio_bench.run", "--workload", "euroc.stream1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_workload():
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) != 0
