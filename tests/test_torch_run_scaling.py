"""`tools/run_scaling.py` on the CPU over gloo at a small size: the data
and model modes on groups of 1 and 2 ranks print one JSON row per size
with a finite cost, the backend and the collectives per solve, then the
whole table as one JSON object; without a card the default device
raises rather than falling back to the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_scaling_cpu_rows():
    cmd = [sys.executable, "-m", "xrslam_tpu_torch.tools.run_scaling", "--device", "cpu",
           "--devices", "1", "2", "--modes", "data", "model", "--frames", "4",
           "--landmarks", "32", "--iters", "2", "--reps", "1"]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines() if s.startswith("{")]
    rows, table = lines[:-1], lines[-1]
    assert [(r["mode"], r["devices"]) for r in rows] == [
        ("data", 1), ("data", 2), ("model", 1), ("model", 2)]
    assert table == {"data": rows[:2], "model": rows[2:]}
    for r in rows:
        assert r["cost_finite"] and r["windows_per_s"] > 0
        assert r["backend"] == "gloo" and r["device"] == "cpu" and not r["ranks_share_cards"]
        # (H, b, cost) per assemble and the Schur terms per step
        assert r["collectives_per_solve"] == 2 * 2 + 1
    assert "[model] 2 ranks, gloo" in proc.stderr


def test_run_scaling_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from xrslam_tpu_torch.tools import run_scaling

    with pytest.raises(RuntimeError, match="CUDA device"):
        run_scaling.main(["--devices", "1"])
