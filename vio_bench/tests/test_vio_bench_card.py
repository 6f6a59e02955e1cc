"""A short run of every cell on the card, through the command that
BENCHMARK.json names: it exits 0 and its last line is correct."""

import json
import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.gpu
def test_cells_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        out = subprocess.run(bench["command"] + ["--workload", cell["name"], "--seed",
                                                 "3000000001", "--seconds", "10", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu", line
