"""Snapshots and replays of the PARSAC chain (`judge_track_status`, then
`update_track_status` when the judge returns True), for holding one run
of the chain to another from the same window state and the same minimal
samples: the card to the CPU (`chip_smoke.py`), the port to the JAX
package (`tests/test_torch_parsac_drive.py`).

    with snapshotting() as snaps:          # before every judge call
        drive(pipe, scene)
    snap, fired = first_fired(snaps)
    swt = SlidingWindowTracker(PipelineMap(), cfg, device)
    swt.generator.set_state(snap["generator"])
    with recorded_draws() as drawn:
        ok = run_chain(swt, on_device(snap, device))
    ... run the other side with `replayed_draws(drawn)`, then compare
    with `differences`.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from ..core import sliding_window as sw
from ..ransac import core


def snapshot(swt) -> dict:
    """A deep copy of everything the chain reads or writes: both maps,
    the staged prediction (whose frame is the copied map's newest), the
    two bin-confidence vectors, the stats, m_th and the generator's
    state."""
    return copy.deepcopy({
        "map": swt.map, "tracker_map": swt._tracker_map, "pred": swt._pred_parsac,
        "bin_conf": swt.bin_conf, "bin_conf_2d2d": swt.bin_conf_2d2d,
        "stats": dict(swt.stats), "m_th": swt.m_th,
        "generator": swt.generator.get_state()})


@contextlib.contextmanager
def snapshotting():
    """Snapshots every SlidingWindowTracker before each judge call while
    the block runs; yields a list of (snapshot, judge's value)."""
    snaps = []
    judge = sw.SlidingWindowTracker.judge_track_status

    def snapshotted(self):
        snap = snapshot(self)
        ok = judge(self)
        snaps.append((snap, ok))
        return ok

    sw.SlidingWindowTracker.judge_track_status = snapshotted
    try:
        yield snaps
    finally:
        sw.SlidingWindowTracker.judge_track_status = judge


def first_fired(snaps):
    """(snapshot, True) before the first judge call that returned True,
    else (the last snapshot, False); None without a judge call."""
    for snap, ok in snaps:
        if ok:
            return snap, True
    return (snaps[-1][0], False) if snaps else None


def on_device(snap: dict, device) -> dict:
    """A deep copy of `snap` with its tensors on `device`."""
    snap = copy.deepcopy(snap)
    if snap["pred"] is not None:
        snap["pred"] = (snap["pred"][0],) + tuple(x.to(device) for x in snap["pred"][1:])
    snap["bin_conf"] = snap["bin_conf"].to(device)
    snap["bin_conf_2d2d"] = snap["bin_conf_2d2d"].to(device)
    return snap


def run_chain(swt, snap: dict) -> bool:
    """Loads `snap` into `swt` (it takes the snapshot's objects), runs
    the judge and, when it returns True, the update; returns the
    judge's value."""
    swt.map, swt._tracker_map, swt._pred_parsac = snap["map"], snap["tracker_map"], snap["pred"]
    swt.bin_conf, swt.bin_conf_2d2d = snap["bin_conf"], snap["bin_conf_2d2d"]
    swt.stats.update(tracks_unstatic=snap["stats"]["tracks_unstatic"])
    swt.m_th = snap["m_th"]
    ok = swt.judge_track_status()
    if ok:
        swt.update_track_status()
    return ok


def tags(pmap) -> dict:
    """{track id: (static, outlier)} of every track of a map."""
    return {tid: (tr.static, tr.outlier) for tid, tr in pmap.tracks.items()}


def asnumpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def differences(a_ok, a_swt, a_snap, b_ok, b_swt, b_snap, tol: float = 1e-12) -> list:
    """What differs between two runs of the chain (empty when they
    agree): the judge's value, m_th (relative `tol`), the newest frame's
    landed pose and both bin-confidence vectors (absolute `tol`), every
    track's tags in both maps, and tracks_unstatic."""
    bad = []
    if a_ok != b_ok:
        bad.append(f"judge returned {a_ok} and {b_ok}")
    if abs(a_swt.m_th - b_swt.m_th) > tol * max(abs(a_swt.m_th), abs(b_swt.m_th)):
        bad.append(f"m_th {a_swt.m_th} and {b_swt.m_th}")
    fa, fb = a_snap["map"].frames[-1], b_snap["map"].frames[-1]
    for what, x, y in (("q", fa.q, fb.q), ("p", fa.p, fb.p), ("v", fa.v, fb.v),
                       ("bin_conf", a_swt.bin_conf, b_swt.bin_conf),
                       ("bin_conf_2d2d", a_swt.bin_conf_2d2d, b_swt.bin_conf_2d2d)):
        err = float(np.max(np.abs(asnumpy(x) - asnumpy(y))))
        if not err <= tol:
            bad.append(f"{what} max |d| {err:.3e} > {tol:.0e}")
    for name in ("map", "tracker_map"):
        ta, tb = tags(a_snap[name]), tags(b_snap[name])
        if ta != tb:
            n = sum(ta.get(k) != tb.get(k) for k in set(ta) | set(tb))
            bad.append(f"{n} tracks' tags differ in the {name}")
    if a_swt.stats["tracks_unstatic"] != b_swt.stats["tracks_unstatic"]:
        bad.append(f"tracks_unstatic {a_swt.stats['tracks_unstatic']} and "
                   f"{b_swt.stats['tracks_unstatic']}")
    return bad


@contextlib.contextmanager
def recorded_draws():
    """Records every minimal sample the port draws in the block (index
    sets and the weights they were drawn by, on the host); yields the
    list."""
    drawn = []
    sample = core.sample_minimal

    def recording(generator, n_hyp, n_points, dof, valid=None, weights=None,
                  device=None):
        idx = sample(generator, n_hyp, n_points, dof, valid, weights, device)
        drawn.append((asnumpy(idx).copy(), None if weights is None else asnumpy(weights)))
        return idx

    core.sample_minimal = recording
    try:
        yield drawn
    finally:
        core.sample_minimal = sample


@contextlib.contextmanager
def replayed_draws(drawn, tol: float = 1e-12):
    """The port's minimal samples in the block are the recorded ones, in
    order, on the generator's device; each request must have the
    recorded shape, and its weights must be within `tol` of the
    recorded. Raises if a draw is left over."""
    queue = list(drawn)
    sample = core.sample_minimal

    def replaying(generator, n_hyp, n_points, dof, valid=None, weights=None,
                  device=None):
        idx, w = queue.pop(0)
        if idx.shape != (n_hyp, dof) or (weights is None) != (w is None):
            raise AssertionError(f"draw of {idx.shape} replayed for ({n_hyp}, {dof})")
        if w is not None:
            err = float(np.max(np.abs(asnumpy(weights) - w)))
            if not err <= tol:
                raise AssertionError(f"weights differ by {err:.3e} (> {tol:.0e})")
        return torch.as_tensor(idx, dtype=torch.int64, device=device or generator.device)

    core.sample_minimal = replaying
    try:
        yield queue
    finally:
        core.sample_minimal = sample
    if queue:
        raise AssertionError(f"{len(queue)} recorded draws left unused")
