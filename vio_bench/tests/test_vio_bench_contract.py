"""BENCHMARK.json against the benchmark's contract, and the files each
of its entries names."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = 24
    check = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert check <= 43200
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(spec["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and k in spec["config"]
            assert not k.endswith(("_dim", "_rank")) and not any(w in k for w in WIDTH_WORDS)
        assert spec["guarantees"]["ate_rmse_m"] > 0


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "vio_bench", "traffic", w["traffic"] + ".json"))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    seen = set()
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        seen.add(m["name"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e and m["name"] not in seen
        assert set(m.get("workloads", cells)) <= cells
        seen.add(m["name"])
        assert os.path.exists(os.path.join(ROOT, "vio_bench", "metrics", m["name"] + ".py"))
    for cell in cells:   # every cell: setup_s, another end-to-end metric, a per-layer one
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
        assert sum(cell in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
