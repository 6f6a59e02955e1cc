"""The port's benchmark tools on the CPU at small sizes:

- `tools/bench_pipeline.py` at 320x240, 8 frames, 2 passes: its one JSON
  line holds frames/s of the fastest timed pass and of every pass,
  frames tracked, ATE, the per-frame latency (median <= p90, one sample
  per processed frame), the stage means and no card; a second run with
  another focal length renders into another directory (the cache is
  keyed on every parameter of the scene);
- one timed pass and no warm-up (`--passes 1 --warmup 0`, what
  `chip_smoke.py` runs after the main drive has warmed the process);
  `--passes` not above `--warmup` is refused;
- `tools/run_benchmark.py` over two tiny renders and one missing path:
  two sequence records, one `error` record, and the aggregate line last;
- `tools/run_dataset.py --viz`: one overlay PNG per processed frame.
"""

import json

import pytest
import torch

from xrslam_tpu_torch.tools import bench_pipeline, run_benchmark, run_dataset
from xrslam_tpu_torch.tools.make_dataset import render_dataset

BENCH_KEYS = {"metric", "frames_per_s", "unit", "device", "card", "frames",
              "pass_frames_per_s", "warmup_passes", "frames_tracked", "ate_rmse_m",
              "latency_ms", "timings_ms", "dataset", "schedule", "tracker_routes"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(tmp_path, capsys, *extra, passes: str = "2"):
    out = bench_pipeline.main(["--frames", "8", "--passes", passes, "--device", "cpu",
                               "--dir", str(tmp_path), *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    return out


def test_bench_pipeline_line_and_render_cache(tmp_path, capsys):
    out = _bench(tmp_path, capsys)
    assert set(out) == BENCH_KEYS
    assert out["device"] == "cpu" and out["card"] is None and out["frames"] == 8
    assert out["schedule"] == "sync"
    assert len(out["pass_frames_per_s"]) == 2
    assert out["frames_per_s"] == out["pass_frames_per_s"][1] > 0
    assert out["frames_tracked"] == 0  # 8 frames: still initializing
    lat = out["latency_ms"]
    assert lat["frames"] == 7 and 0 < lat["median"] <= lat["p90"]
    assert {"feature_tracker_time", "read_image_time"} <= set(out["timings_ms"])
    assert out["dataset"].endswith("f8_l500_320x240_focal260")

    other = _bench(tmp_path, capsys, "--focal", "300")
    assert other["dataset"].endswith("f8_l500_320x240_focal300")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "f8_l500_320x240_focal260", "f8_l500_320x240_focal300"]


def test_run_benchmark_records_and_aggregate(tmp_path, capsys):
    uris = []
    for name in ("a", "b"):
        paths = render_dataset(str(tmp_path / name), n_frames=6, n_landmarks=500,
                               width=320, height=240, focal=260.0)
        uris.append("euroc://" + paths["root"])
    uris.insert(1, "euroc://" + str(tmp_path / "missing" / "mav0"))
    results, summary = run_benchmark.main(uris + ["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == json.loads(json.dumps(results + [summary]))
    assert [r["sequence"] for r in results] == ["a", "missing", "b"]
    assert "error" in results[1]
    assert "error" not in results[0] and "error" not in results[2]
    assert results[0]["frames_tracked"] == results[2]["frames_tracked"] == 0
    assert summary == {"sequences": 3, "evaluated": 0, "ate_rmse_mean_m": None}


def test_run_dataset_viz_writes_overlays(tmp_path):
    paths = render_dataset(str(tmp_path / "seq"), n_frames=6, n_landmarks=500,
                           width=320, height=240, focal=260.0)
    viz = tmp_path / "viz"
    out = run_dataset.main(["euroc://" + paths["root"], "--slam-config", paths["slam_yaml"],
                            "--device-config", paths["device_yaml"], "--sync", "--gt",
                            "--viz", str(viz), "--device", "cpu"])
    pngs = sorted(viz.glob("frame_*.png"))
    assert len(pngs) == out["overlays"] == out["frames_processed"] == 6
    # nothing tracked in 6 frames, so no trajectory to plot
    assert out["frames_tracked"] == 0 and not (viz / "trajectory.png").exists()


def test_bench_pipeline_one_timed_pass(tmp_path, capsys):
    out = _bench(tmp_path, capsys, "--warmup", "0", passes="1")
    assert out["warmup_passes"] == 0 and len(out["pass_frames_per_s"]) == 1
    assert out["frames_per_s"] == out["pass_frames_per_s"][0] > 0
    assert out["latency_ms"]["frames"] == 7
    with pytest.raises(SystemExit):
        bench_pipeline.main(["--frames", "8", "--passes", "1", "--device", "cpu",
                             "--dir", str(tmp_path)])


def test_bench_pipeline_schedule(tmp_path, capsys):
    """--schedule pipelined runs the two-frame lag, --schedule chained the
    chained frontend on it; `bench` returns the reported pass with its
    final window after flush; the line counts the tracker's routes."""
    out = _bench(tmp_path, capsys, "--warmup", "0", "--schedule", "pipelined", passes="1")
    assert out["schedule"] == "pipelined" and out["frames_per_s"] > 0
    line, best = bench_pipeline.bench(["--frames", "8", "--passes", "1", "--warmup", "0",
                                       "--device", "cpu", "--dir", str(tmp_path)])
    assert line["schedule"] == "sync" and best["window"] == []  # not yet tracking
    assert len(best["ts"]) == line["frames_tracked"] == 0
    # 7 of the 8 frames processed: the last waits for IMU samples after it
    assert line["tracker_routes"] == {"chained_frames": 0, "standard_frames": 7,
                                      "reseeds": 0}
    # --schedule chained: the pipelined schedule with the chained frontend,
    # which carries every frame pair
    out = _bench(tmp_path, capsys, "--warmup", "0", "--schedule", "chained", passes="1")
    assert out["schedule"] == "chained" and out["frames_per_s"] > 0
    assert out["tracker_routes"] == {"chained_frames": 6, "standard_frames": 1,
                                     "reseeds": 1}
    with pytest.raises(SystemExit):
        bench_pipeline.main(["--schedule", "overlapped", "--device", "cpu"])
