"""The batched multi-sequence solve on the CPU, in float64:

- `solver.solve_chained_batch` against the JAX package's on N = 3
  distinct windows (K = 4, L = 32, a different injection slot per row):
  states within 1e-9; and against N single `solve_chained` calls within
  1e-12 (the batch runs the same arithmetic under `torch.func.vmap`;
  only the summation order of batched products differs);
- `gram.reproj_factor_gram_plain` (K2's plain version) on a batch of 3
  equal to the three single calls exactly, and the dispatching entry
  takes the batch on the CPU;
- `SlidingWindowTracker.prepare_fused_subframe` + `finish_fused_subframe`
  with no broker give exactly the poses of the step as it was before the
  split (its body is kept below as the reference), over a bearing-fed
  drive; with a one-sequence `tools.multiseq.ChainedSolveBroker` (the
  batched solve at N = 1) within 1e-9;
- the broker under a solver time budget: steps whose subwindow shares
  clamp to different counts are solved in one batched call per options
  pair, each row equal to its single solve within 1e-12;
- `tools.multiseq` (slow) at 320x240, N = 2 (seeds 3 and 32, which
  both track from frame 31 at this size; seed 5 does not start within
  44 frames here): both modes track the same frames, ATEs within 1e-6,
  and the first batched flush's windows solved alone agree with their
  batched rows within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.estimation import solver as jsolver
from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.io.synthetic import circle_scene
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.core import sliding_window as sw
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.estimation import gram, solver
from xrslam_tpu_torch.estimation.solver import SolveOptions
from xrslam_tpu_torch.io.synthetic import reproj_window
from xrslam_tpu_torch.tools import multiseq
from xrslam_tpu_torch.utils.tree import tree_map

from helpers import build_window, euler_consistent, perturb_state
from test_torch_checkpoint import drive, make_config, scene_inputs

K, L, N = 4, 32, 3
SLOTS = (3, 2, 3)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def windows():
    """N distinct (localize, subwindow) window pairs from the circle scene,
    as JAX pytrees: each row its own frames, perturbation and slot."""
    scene = euler_consistent(circle_scene(n_frames=32, n_landmarks=30))
    q_bc = jlie.expmap(jnp.array([-jnp.pi / 2, 0.0, 0.0], dtype=jnp.float64))
    p_bc = jnp.array([0.02, -0.01, 0.03], dtype=jnp.float64)
    rows = []
    for i, slot in enumerate(SLOTS):
        st_gt, data = build_window(scene, [i, i + 6, i + 12, i + 18], L=L,
                                   q_bc=q_bc, p_bc=p_bc)
        st0 = perturb_state(st_gt, jax.random.PRNGKey(20 + i), skip_frames=(0,))
        fix = np.ones(K, bool)
        fix[slot] = False
        d1 = data._replace(fix_pose=jnp.asarray(fix), fix_motion=jnp.asarray(fix),
                           fix_landmark=jnp.ones_like(data.fix_landmark))
        d2 = data._replace(fix_pose=data.fix_pose.at[0].set(True))
        rows.append((st0, d1, d2))
    return rows


O1, O2 = dict(iterations=4), dict(iterations=5)


def _port_batch(windows):
    st = tuple(convert.to_torch(r[0]) for r in windows)
    d1 = tuple(convert.to_torch(r[1]) for r in windows)
    d2 = tuple(convert.to_torch(r[2]) for r in windows)
    return st, d1, d2


def test_solve_chained_batch_matches_jax(windows):
    st = tuple(r[0] for r in windows)
    ref = jsolver.solve_chained_batch(
        st, tuple(r[1] for r in windows), jsolver.SolveOptions(**O1), st,
        tuple(r[2] for r in windows), jsolver.SolveOptions(**O2),
        jnp.asarray(SLOTS, jnp.int32))
    tst, td1, td2 = _port_batch(windows)
    out = solver.solve_chained_batch(tst, td1, SolveOptions(**O1), tst, td2,
                                     SolveOptions(**O2), SLOTS)
    assert len(out) == N
    for r, o in zip(ref, out):
        for name, a, b in zip(r._fields, r, o):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-9,
                                       err_msg=name)


def test_solve_chained_batch_matches_single_solves(windows):
    tst, td1, td2 = _port_batch(windows)
    out = solver.solve_chained_batch(tst, td1, SolveOptions(**O1), tst, td2,
                                     SolveOptions(**O2), torch.as_tensor(SLOTS))
    for i, slot in enumerate(SLOTS):
        _, ref, _ = solver.solve_chained(tst[i], td1[i], SolveOptions(**O1), tst[i],
                                         td2[i], SolveOptions(**O2), slot, slot)
        for name, a, b in zip(ref._fields, ref, out[i]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12,
                                       err_msg=f"row {i} {name}")


def test_reproj_factor_gram_plain_batch_equals_single_calls():
    pairs = [reproj_window(K, L, seed=s) for s in (1, 2, 3)]
    state = tree_map(lambda *x: torch.stack(x), *[p[0] for p in pairs])
    data = tree_map(lambda *x: torch.stack(x), *[p[1] for p in pairs])
    out = gram.reproj_factor_gram_plain(state, data)
    assert gram.reproj_factor_gram(state, data)[0].shape == (N, K, 6, K, 6)
    for i, (s, d) in enumerate(pairs):
        for a, b in zip(gram.reproj_factor_gram_plain(s, d), out):
            assert torch.equal(a, b[i])


class _Finisher:
    """Stands in for a tracker: keeps what the broker finishes it with."""

    def __init__(self):
        self.done = []

    def finish_fused_subframe(self, ctx, st2):
        self.done.append((ctx, st2))


def test_broker_groups_steps_by_budget(windows):
    """Under a solver time budget the sequences' subwindow shares can
    clamp to different counts: the broker solves each options pair as
    one batched call, and every step finishes with its own row (equal to
    its single solve) and the start time its budget is timed from."""
    tst, td1, td2 = _port_batch(windows)
    clamps = (5, 1, 5)
    broker = multiseq.ChainedSolveBroker(N)
    finishers = [_Finisher() for _ in clamps]
    for i, (f, s) in enumerate(zip(finishers, clamps)):
        broker.submit(f, dict(l_state=tst[i], l_data=td1[i], l_opts=SolveOptions(**O1),
                              s_state=tst[i], s_data=td2[i],
                              s_opts=SolveOptions(iterations=s), s2=SLOTS[i]))
    broker.flush()
    assert broker.batched_calls == len(set(clamps)) and broker.solo_equiv == N
    for i, (f, s) in enumerate(zip(finishers, clamps)):
        (ctx, st2), = f.done
        assert isinstance(ctx["t0"], float)
        _, ref, _ = solver.solve_chained(tst[i], td1[i], SolveOptions(**O1), tst[i], td2[i],
                                         SolveOptions(iterations=s), SLOTS[i], SLOTS[i])
        for name, a, b in zip(ref._fields, ref, st2):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12,
                                       err_msg=f"row {i} {name}")


def _unsplit_fused_subframe_step(self, target):
    """The subframe step before its split into prepare/finish, verbatim."""
    prep = self._prepare_subwindow()
    s_state, s_data, s_meta, s_opts, variant, kf, saved = prep
    frames = s_meta.frames
    s2 = len(frames) - 1
    assert frames[s2] is target
    K = self.K_sub
    pm = np.zeros((K,), dtype=bool)
    pm[s2] = bool(s_meta.preint_mask[s2])
    fix = np.ones((K,), dtype=bool)
    fix[s2] = False
    dev = self.device
    l_data = s_data._replace(
        preint_mask=torch.as_tensor(pm, device=dev),
        fix_pose=torch.as_tensor(fix, device=dev),
        fix_motion=torch.as_tensor(fix, device=dev),
        fix_landmark=torch.ones_like(s_data.fix_landmark),
        obs_mask=torch.as_tensor(s_meta.obs_mask, device=dev),
        landmark_mask=torch.as_tensor(s_meta.landmark_mask, device=dev))
    if variant == "subwindow_rot":
        l_data = l_data._replace(landmark_mask=s_data.landmark_mask)
    l_state = self._apply_pred(s_state, frames, s_data)
    l_opts = SolveOptions(iterations=self.config.solver_iteration_limit)
    _, st2, _ = sw.solve_chained(l_state, l_data, l_opts, s_state, s_data,
                                 s_opts, s2, s2)
    kf.fix_pose, kf.fix_motion = saved
    sw.write_back(self.map, st2, s_meta, write_landmarks=False)


N_DRIVE = 26  # the backend starts at frame 14; 9 subframe steps


def _bearing_drive(broker=None, **cfg_kw):
    cfg = make_config().replace(**cfg_kw)
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    inputs = scene_inputs(cfg)
    outs, subframes = [], [0]
    for k in range(N_DRIVE):
        if broker is not None and pipe.swt is not None:
            pipe.swt.solve_broker = broker
        drive(pipe, inputs, k, k + 1)
        if broker is not None:
            subframes[0] += len(broker.flush())
            if pipe.swt is not None:
                pipe._refresh_prop_state()
        if pipe.state == "tracking":
            t, _, p, _, _, _ = pipe.swt.get_latest_state()
            outs.append((float(t), np.asarray(p).copy()))
    return outs, subframes[0]


def test_split_subframe_step_unchanged(monkeypatch):
    # the step before its split wrote back at once: compare the two with
    # write-backs at once
    sync = dict(deferred_subframe_write=False)
    new, _ = _bearing_drive(**sync)
    monkeypatch.setattr(sw.SlidingWindowTracker, "_fused_subframe_step",
                        _unsplit_fused_subframe_step)
    ref, _ = _bearing_drive(**sync)
    assert len(new) == len(ref) > 5
    for (ta, pa), (tb, pb) in zip(ref, new):
        assert ta == tb and np.array_equal(pa, pb)
    monkeypatch.undo()
    # the broker's batched solve against the step, both with deferred
    # write-backs (the default)
    ref, _ = _bearing_drive()
    broker = multiseq.ChainedSolveBroker(1)
    batched, n_sub = _bearing_drive(broker)
    assert n_sub > 0 and broker.batched_calls == n_sub
    assert len(batched) == len(ref)
    for (ta, pa), (tb, pb) in zip(ref, batched):
        assert ta == tb
        np.testing.assert_allclose(pb, pa, rtol=0, atol=1e-9)


@pytest.mark.slow
def test_multiseq_modes_agree(tmp_path):
    res = multiseq.run(2, 44, 320, 240, 260.0, "cpu", str(tmp_path), check_first=True,
                       seeds=(3, 32))
    seq, bat = res["sequential"], res["batched"]
    assert seq["frames"] == bat["frames"] == 88
    for a, b in zip(seq["sequences"], bat["sequences"]):
        assert a["tracked"] == b["tracked"] > 0
        assert abs(a["ate_m"] - b["ate_m"]) <= 1e-6
    assert bat["batched_dispatches"] > 0
    assert bat["first_flush_check"]["windows"] == 2
    assert bat["first_flush_check"]["max_abs_err"] <= 1e-9
