"""The solver time budget (`Config.solver_time_limit`, the reference's
Ceres `max_solver_time_in_seconds`, solver.cpp:186) of the port's
`core/sliding_window.py` held to the JAX package's, on the CPU in
float64; and the JAX package's schedule flags, which the port refuses.

- (a) `_budgeted_iterations` and `_budget_chained` over one grid of
  limit, estimate, iteration limit and localize share (the cases of
  `tests/test_solver.py`'s budget tests among them): equal in both
  packages and equal to the ladder value the grid states;
- (b) calibration: `_solve_timed` on `demo_window_problem(4, 32)` (the
  port's circle scene takes committed JAX draws, 24 landmarks the
  fewest, so not `tests/test_solver.py`'s (4, 16)) ten times under a stand-in clock that only the device wait advances (by a
  set time for each call): call 0 is untimed, calls 1-3 are timed, their
  median is kept, in both packages; the port waited on the device 3
  times (`stats["budget_syncs"]`);
- (c) the JAX checkpoint `tests/data/jax_circle_ckpt30.npz` finished by
  both packages under `solver_time_limit=0.1`, PARSAC off, with each
  tracker's estimates seeded before any solve so that the subframe
  chain clamps to 5 of its 10 iterations and the keyframe chain does
  not clamp: every solve's iteration counts equal, every frame of the
  final window within 1e-6 m (as `test_jax_checkpoint_finished_by_port`);
- (d) with a large "kf_chain" estimate the JAX package's keyframe chain
  keeps its 10 refine iterations (it budgets that share from the
  "refine" estimate, which only its depth path measures), while the
  port's clamps it to 1: both sides are asserted, so the test records
  the departure (ROADMAP.md, queue 3) without enshrining it;
- the mobile profile's window (5 keyframes) below the initializer's 8:
  the port's window slots hold the handed-over keyframes and the first
  keyframe step trims them to 5;
- `worker_overlap`, `pipelined_writeback` and `chained_frontend`: the
  port's `VIOPipeline` raises `ValueError` for each set True.
"""

import types

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core import sliding_window as jsw
from xrslam_tpu.core.detail import SyntheticTracker as JSyntheticTracker
from xrslam_tpu.core.map import PipelineMap as JPipelineMap
from xrslam_tpu.estimation import solver as jsolver
from xrslam_tpu.io.synthetic import demo_window_problem as jdemo_window_problem
from xrslam_tpu.utils import checkpoint as jck
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.core import sliding_window as sw
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.core.map import PipelineMap
from xrslam_tpu_torch.estimation.solver import SolveOptions
from xrslam_tpu_torch.io.synthetic import demo_window_problem
from xrslam_tpu_torch.utils import checkpoint as ck
from tests.test_torch_checkpoint import (CUT, JAX_CKPT, JAX_TAIL, N_FRAMES, drive,
                                         make_config, scene_inputs, tail_error,
                                         window_positions)

JSolveOptions = jsolver.SolveOptions
LIMIT = 0.1                 # configs/iphone_slam.yaml's time_limit
TAIL_TOL_M = 1e-6
# seeded estimates, seconds per iteration: the subframe chain fits
# int(0.1 / est) - 10 = 5 subwindow iterations, the keyframe chain 990
SUB_EST = LIMIT / 15.5
KF_FITS = 1e-4
KF_CLAMPS = 0.05            # max(1, int(0.1 / 0.05) - 10) -> 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trackers():
    """One sliding-window tracker of each package, on empty maps."""
    return (sw.SlidingWindowTracker(PipelineMap(), Config(), "cpu"),
            jsw.SlidingWindowTracker(JPipelineMap(), JConfig()))


# (limit, estimate, iteration limit, localize share,
#  _budgeted_iterations, _budget_chained's subwindow share)
GRID = [
    (0.05, None, 10, 2, 10, 10),     # no estimate yet
    (0.05, 0.020, 10, 2, 2, 1),      # tests/test_solver.py:208
    (0.05, 0.001, 10, 2, 10, 10),    # :211
    (1.0e6, 10.0, 10, 2, 10, 10),    # no limit (the default): :216
    (0.05, 0.01, 10, 2, 5, 3),       # :376, 3 of a 5-iteration fit
    (0.05, 1e-5, 10, 2, 10, 10),     # :382
    (0.1, 0.043, 10, 10, 2, 1),      # the card's subframe chain (PERF.md §5)
    (0.1, 0.051, 10, 10, 1, 1),      # ... and keyframe chain
    (0.1, 0.1 / 4.5, 10, 2, 3, 2),   # fit 4 -> 3; chained 4 - 2 = 2
    (0.1, 0.1 / 19.6, 10, 10, 10, 8),  # fit 19; chained 19 - 10 = 9 -> 8
    (0.1, 0.1 / 40.5, 40, 10, 40, 30),  # fit 40; chained 30
    (0.1, 0.1 / 40.5, 10, 10, 10, 10),
    (0.0, 0.05, 10, 2, 10, 10),      # limit 0: off
    (1.0e5, 2.0e4, 10, 2, 5, 10),    # at 1e5 only the chained form is off
]


@pytest.mark.parametrize("limit,est,iters,l_iters,want,want_chained", GRID)
def test_budget_functions_match_jax(trackers, limit, est, iters, l_iters, want,
                                    want_chained):
    port, jport = trackers
    port.config = Config(solver_iteration_limit=iters, solver_time_limit=limit)
    jport.config = JConfig(solver_iteration_limit=iters, solver_time_limit=limit)
    for t in (port, jport):
        t._iter_seconds.clear()
        if est is not None:
            t._iter_seconds.update(refine=est, chain=est)
    assert port._limit_active() == jport._limit_active()
    got = port._budgeted_iterations("refine")
    assert got == jport._budgeted_iterations("refine") == want
    chained = port._budget_chained("chain", SolveOptions(iterations=l_iters),
                                   SolveOptions(iterations=iters))
    jchained = jport._budget_chained("chain", JSolveOptions(iterations=l_iters),
                                     JSolveOptions(iterations=iters))
    assert chained.iterations == jchained.iterations == want_chained
    # the multi-sequence broker groups steps by their options: hashable, equal
    assert len({chained, port._budget_chained("chain", SolveOptions(iterations=l_iters),
                                              SolveOptions(iterations=iters))}) == 1
    assert port.BUDGET_LADDER == (1, 2, 3, 5, 8, 15, 30)


# the device wait of call k advances the stand-in clock by WAITS[k] s
WAITS = [5.0, 7.0, 2.0, 4.0, 9.0, 1.0, 3.0, 8.0, 6.0, 11.0]
CALIB_ITERS = 2


def test_calibration_matches_jax(monkeypatch):
    clock = {"port": 0.0, "jax": 0.0}
    port = sw.SlidingWindowTracker(
        PipelineMap(), Config(solver_time_limit=LIMIT), "cpu")
    jport = jsw.SlidingWindowTracker(JPipelineMap(), JConfig(solver_time_limit=LIMIT))
    monkeypatch.setattr(sw, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["port"]))
    monkeypatch.setattr(jsw, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["jax"]))
    wait, jblock = port._wait_device, jax.block_until_ready

    def port_wait(result):
        clock["port"] += WAITS[port._solve_calls["v"] - 1]
        wait(result)

    def jax_wait(result):
        clock["jax"] += WAITS[jport._solve_calls["v"] - 1]
        return jblock(result)

    monkeypatch.setattr(port, "_wait_device", port_wait)
    monkeypatch.setattr(jax, "block_until_ready", jax_wait)
    state, data = demo_window_problem(4, 32)
    jstate, jdata = jdemo_window_problem(4, 32, jnp.float64)
    for call in range(len(WAITS)):
        port._solve_timed("v", state, data, SolveOptions(iterations=CALIB_ITERS))
        jport._solve_timed("v", jstate, jdata, JSolveOptions(iterations=CALIB_ITERS))
        calibrated = call >= 3
        assert ("v" in port._iter_seconds) == ("v" in jport._iter_seconds) == calibrated
    samples = [w / CALIB_ITERS for w in WAITS[1:4]]   # call 0 untimed
    assert port._solve_samples["v"] == jport._solve_samples["v"] == sorted(samples)
    assert port._iter_seconds["v"] == jport._iter_seconds["v"] == np.median(samples)
    assert port._solve_calls["v"] == jport._solve_calls["v"] == len(WAITS)
    assert port.stats["budget_syncs"] == 3
    assert clock["port"] == clock["jax"] == sum(WAITS[1:4])


def solve_log(monkeypatch, chain, window, kf_chain):
    """Record the iteration counts of every solve through one package's
    solve functions (`chain`, `window`, `kf_chain`: (module, name))."""
    log = []

    def wrap(where, name, kind, counts):
        fn = getattr(where, name)

        def recorded(*args, **kwargs):
            log.append((kind,) + counts(args))
            return fn(*args, **kwargs)
        monkeypatch.setattr(where, name, recorded)

    wrap(*chain, "chained", lambda a: (a[2].iterations, a[5].iterations))
    wrap(*kf_chain, "keyframe", lambda a: (a[2].iterations, a[5].iterations))
    wrap(*window, "window", lambda a: (a[2].iterations,))
    return log


def budgeted_pipelines(monkeypatch, kf_est: float):
    """Both packages load the JAX checkpoint under the budget, PARSAC off,
    with each tracker's estimates seeded. Returns ((port pipeline, its
    solve log), (JAX pipeline, its solve log))."""
    ref = np.load(JAX_TAIL)
    id_map = dict(zip(ref["hints"].tolist(), ref["track_ids"].tolist()))
    cfg = make_config().replace(solver_time_limit=LIMIT)
    tracker = SyntheticTracker(device="cpu")
    tracker._id_map = dict(id_map)
    pipe = ck.load_pipeline(JAX_CKPT, cfg, tracker, device="cpu")
    jtracker = JSyntheticTracker()
    jtracker._id_map = dict(id_map)
    jpipe = jck.load_pipeline(JAX_CKPT, JConfig(**convert.config_to_dict(cfg)), jtracker)
    seeds = {"chained:subwindow": SUB_EST, "chained:subwindow_rot": SUB_EST,
             "kf_chain": kf_est}
    for p in (pipe, jpipe):
        assert p.swt is not None and not p.swt._solve_calls
        p.swt._iter_seconds.update(seeds)
    log = solve_log(monkeypatch, (sw, "solve_chained"), (sw, "solve_window"),
                    (sw, "solve_keyframe_chain"))
    jlog = solve_log(monkeypatch, (jsw, "solve_chained"), (jsw, "solve_window"),
                     (jsolver, "solve_keyframe_chain"))
    return (pipe, log), (jpipe, jlog)


def test_budgeted_drive_matches_jax(monkeypatch):
    (pipe, log), (jpipe, jlog) = budgeted_pipelines(monkeypatch, KF_FITS)
    inputs = scene_inputs(make_config())
    drive(pipe, inputs, CUT, N_FRAMES)
    drive(jpipe, inputs, CUT, N_FRAMES)
    assert log == jlog
    assert ("chained", 10, 5) in log and ("keyframe", 10, 10) in log, log
    assert pipe.swt.stats["budget_syncs"] == 0   # every variant was seeded
    err = tail_error(window_positions(jpipe), window_positions(pipe), -np.inf)
    assert err < TAIL_TOL_M


def test_kf_chain_budget_departs_from_jax(monkeypatch):
    (pipe, log), (jpipe, jlog) = budgeted_pipelines(monkeypatch, KF_CLAMPS)
    inputs = scene_inputs(make_config())
    k = CUT
    while not any(kind == "keyframe" for kind, *_ in log):
        assert k < N_FRAMES, log
        drive(pipe, inputs, k, k + 1)
        drive(jpipe, inputs, k, k + 1)
        k += 1
    assert log[:-1] == jlog[:-1]
    assert jlog[-1] == ("keyframe", 10, 10)   # the JAX package: unclamped
    assert log[-1] == ("keyframe", 10, 1)     # the port: fits the budget


def test_window_below_initializer_keyframes():
    cfg = make_config().replace(sliding_window_size=5)
    assert cfg.initializer_keyframe_num == 8
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    inputs = scene_inputs(make_config())
    k, sizes = 0, []
    while k < N_FRAMES:
        drive(pipe, inputs, k, k + 1)
        if pipe.swt is not None:
            sizes.append(len(pipe.swt.map.frames))
        k += 1
    assert pipe.swt.K_slots == 10
    assert sizes and sizes[0] >= 8 and sizes[-1] <= 5, sizes


@pytest.mark.parametrize("flag", VIOPipeline.UNPORTED_SCHEDULES)
def test_unported_schedule_flags_refused(flag):
    with pytest.raises(ValueError, match=f"{flag}.*ROADMAP.md"):
        VIOPipeline(Config(**{flag: True}), SyntheticTracker(device="cpu"),
                    device="cpu")
    VIOPipeline(Config(**{flag: False}), SyntheticTracker(device="cpu"), device="cpu")
