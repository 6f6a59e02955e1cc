"""The comparison that decides `correct`, on the CPU at a size a test
run holds (320x240, a short window): sound runs pass; the control, the
reference one precision down put in the program's place, fails every
number that it can be put in for; and a run whose timed path is broken
underneath comes out not correct, once for each fault the cells can
have. The faults are armed when the window starts, so set-up
initializes as usual."""

import time

import numpy as np
import pytest
import torch

from vio_bench import check, run, stream, taps
from xrslam_tpu_torch.core import detail
from xrslam_tpu_torch.estimation import gram, solver
from xrslam_tpu_torch.frontend import image, klt

CAMERA = (320, 240, 260.0)


@pytest.fixture
def small_traffic(monkeypatch):
    orig = stream.load_traffic

    def load(name):
        t = dict(orig(name))
        t.update(trace_frames=[6, 8], settle_frames=4)
        return t

    monkeypatch.setattr(stream, "load_traffic", load)


def cpu_run(cell_name, seed, seconds=8.0):
    bench = run.load_benchmark()
    cell = {c["name"]: c for c in bench["workloads"]}[cell_name]
    return run.run_cell(bench, cell, seed, seconds, False, "cpu", time.perf_counter(),
                        n_frames=100, camera=CAMERA)


class Armed:
    """A fault that acts only once the window's taps are in place."""

    def __init__(self, monkeypatch):
        self.on = False
        orig = taps.Solves.__init__

        def init(tap, *a, **kw):
            self.on = True
            orig(tap, *a, **kw)

        monkeypatch.setattr(taps.Solves, "__init__", init)


@pytest.fixture(scope="module")
def sound():
    mp = pytest.MonkeyPatch()
    orig = stream.load_traffic
    mp.setattr(stream, "load_traffic",
               lambda n: dict(orig(n), trace_frames=[6, 8], settle_frames=4))
    try:
        yield cpu_run("euroc.stream1", 2**31 + 11)
    finally:
        mp.undo()


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert set(sound["checks"]) == {"solve_gap", "marg_gap", "track_lost_share",
                                    "track_gap_px", "pyramid_gap", "pose_gap_m", "ate_m"}


def test_control_fails(sound):
    ctl = check.readings(sound["captured"], control=True)
    assert set(ctl) == set(sound["checks"]) - {"ate_m"}
    for k, v in ctl.items():
        assert not v <= check.LIMITS[k], (k, v)


def fault_unchanged_step(monkeypatch, armed):
    orig = solver.solve_window_core

    def solve(state, data, opts, *a, **kw):
        out = orig(state, data, opts, *a, **kw)
        return (state, out[1]) if armed.on else out

    monkeypatch.setattr(solver, "solve_window_core", solve)


def fault_half_the_observations(monkeypatch, armed):
    orig = gram.reproj_factor_gram

    def half(state, data):
        if armed.on:
            L = data.obs_mask.shape[-1]
            keep = torch.arange(L, device=data.obs_mask.device) % 2 == 0
            data = data._replace(obs_mask=data.obs_mask & keep)
        return orig(state, data)

    monkeypatch.setattr(gram, "reproj_factor_gram", half)


def fault_tracks_moved(monkeypatch, armed):
    orig = klt.track_keypoints_plain

    def moved(*a, **kw):
        pts, ok = orig(*a, **kw)
        return (pts + 1.0 if armed.on else pts), ok

    monkeypatch.setattr(klt, "track_keypoints_plain", moved)


def fault_third_of_tracks_moved(monkeypatch, armed):
    orig = klt.track_keypoints_plain

    def moved(*a, **kw):
        pts, ok = orig(*a, **kw)
        if armed.on:
            third = (torch.arange(pts.shape[0]) % 3 == 0)[:, None]
            pts = torch.where(third, pts + 1.0, pts)
        return pts, ok

    monkeypatch.setattr(klt, "track_keypoints_plain", moved)


def fault_third_of_verdicts_flipped(monkeypatch, armed):
    orig = klt.track_keypoints_plain

    def flipped(*a, **kw):
        pts, ok = orig(*a, **kw)
        if armed.on:
            ok = torch.where(torch.arange(ok.shape[0]) % 3 == 0, ~ok, ok)
        return pts, ok

    monkeypatch.setattr(klt, "track_keypoints_plain", flipped)


def fault_upper_level_unblurred(monkeypatch, armed):
    orig = image.build_pyramid

    def build(img, levels=3):
        pyr = orig(img, levels)
        if armed.on and levels >= 2:
            pyr[2] = pyr[1][..., ::2, ::2].contiguous()
        return pyr

    monkeypatch.setattr(image, "build_pyramid", build)


def fault_pose_moved(monkeypatch, armed):
    orig = detail.VIOPipeline.predict_pose

    def moved(self, t):
        out = orig(self, t)
        if armed.on and out is not None:
            out = detail.OutputPose(t=out.t, q=out.q, p=out.p + 1e-6)
        return out

    monkeypatch.setattr(detail.VIOPipeline, "predict_pose", moved)


@pytest.mark.parametrize("fault, caught", [
    (fault_unchanged_step, "solve_gap"),
    (fault_half_the_observations, "solve_gap"),
    (fault_tracks_moved, "track_gap_px"),
    (fault_third_of_tracks_moved, "track_gap_px"),
    (fault_third_of_verdicts_flipped, "track_lost_share"),
    (fault_upper_level_unblurred, "pyramid_gap"),
    (fault_pose_moved, "pose_gap_m"),
])
def test_broken_timed_path_is_not_correct(monkeypatch, small_traffic, fault, caught):
    armed = Armed(monkeypatch)
    fault(monkeypatch, armed)
    res = cpu_run("euroc.stream1", 2**31 + 11)
    assert not res["correct"]
    c = res["checks"][caught]
    assert not c["value"] <= c["limit"], res["checks"]
