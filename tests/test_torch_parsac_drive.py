"""The PARSAC chain and the camera-rate visual PnP of the port as a whole,
on the CPU (the PARSAC-off path's bit-identity is
`tests/test_torch_parsac_golden.py`):

- the dynamic-object scene (`io.synthetic.moving_object`,
  `bearings_of_points`, `bearings_of` and `tools.object_scene`) against
  the JAX package's, to 1e-12;
- PARSAC's IMU prediction (`_stage_prediction` + `_land_prediction`)
  against the JAX package's `_predict_frame` + `_land_pred_parsac`, to
  1e-12;
- a `parsac_flag: true` read from YAML reaches `judge_track_status`,
  which returns True on the dynamic-object drive, with at most two host
  reads per PARSAC frame and every refusal counted by its gate;
- `judge_track_status` + `update_track_status` of both packages from
  the same window state of that drive, JAX taking the port's minimal
  samples (`tools.parsac_chain`): the same value, m_th, tags on both
  maps and tracks_unstatic, also with a seeded share of the tags
  cleared beforehand so that the static tag's propagation has work;
  and `chip_smoke.chain_check` (card against CPU) rehearsed CPU
  against CPU;
- `SyntheticTracker(config)` of both packages flags FT_NO_TRANSLATION
  on the same frames of a pure-rotation pause, JAX taking the port's
  rotation-RANSAC samples;
- the camera-rate visual PnP publishes a pose on every tracked frame of
  `tests/test_visual_pnp.py`'s scene with the backend every 2nd frame;
- `visual_localization_enable` is accepted (the localizer is ported,
  `tests/test_torch_localizer.py`), and raises ImportError without
  Pillow rather than logging on every query;
- `slow`: the dynamic-object scene through the JAX `VIOPipeline` and
  through the port, each held to `test_dynamic_object_parsac_e2e`'s
  criteria, the two ATEs within 0.05 m;
- `slow`: `chip_smoke.py`'s static 752x480 scene with `parsac_flag`
  through both packages' `api.XRSLAM`, with the judge's outcomes
  counted by gate: the judge returns True on it in both or in neither.
"""

import contextlib
import copy
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.core import detail as jdetail
from xrslam_tpu.core import map as jmap
from xrslam_tpu.core import sliding_window as jsw
from xrslam_tpu.io import synthetic as jsyn
from xrslam_tpu_torch import api, convert
from xrslam_tpu_torch.config import load_config
from xrslam_tpu_torch.core import map as tmap
from xrslam_tpu_torch.core import sliding_window as tsw
from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline
from xrslam_tpu_torch.io import synthetic
from xrslam_tpu_torch.tools import object_scene as osc
from xrslam_tpu_torch.tools import parsac_chain as chain
from xrslam_tpu_torch.tools.make_dataset import ate, render_sequence, run_sequence


def jax_object_scene():
    """The scene exactly as `test_dynamic_object_parsac_e2e` builds it."""
    cfg = osc.base_config()
    q_bc = jnp.asarray(cfg.camera_to_body_rotation)
    p_bc = jnp.asarray(cfg.camera_to_body_translation)
    scene = jsyn.euler_consistent(jsyn.wave_scene(n_frames=60, n_landmarks=96))
    obj = jsyn.moving_object(scene, n_points=80, vel=(-0.12, 0.08, 0.03),
                             omega_obj=(0.0, 0.0, 0.2))
    pts = jnp.concatenate([jnp.broadcast_to(scene.landmarks,
                                            (scene.t.shape[0],) + scene.landmarks.shape),
                           obj], axis=1)
    bearings, mask = jsyn.bearings_of_points(scene.q, scene.p, pts, q_bc, p_bc)
    rng = np.random.default_rng(11)
    bearings = np.asarray(bearings).copy()
    nz = rng.normal(0.0, 0.5 / 450.0, bearings[..., :2].shape)
    bearings[..., 0] += nz[..., 0] * bearings[..., 2]
    bearings[..., 1] += nz[..., 1] * bearings[..., 2]
    bearings /= np.linalg.norm(bearings, axis=-1, keepdims=True)
    return scene, obj, bearings, np.asarray(mask)


def test_object_scene_matches_jax():
    scene, obj, bearings, mask = jax_object_scene()
    sc = osc.object_scene()
    tscene = sc["scene"]
    for name in ("t", "q", "p", "v", "landmarks", "imu_w", "imu_a"):
        np.testing.assert_allclose(getattr(tscene, name).numpy(),
                                   np.asarray(getattr(scene, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    tobj = synthetic.moving_object(tscene, n_points=80, vel=(-0.12, 0.08, 0.03),
                                   omega_obj=(0.0, 0.0, 0.2))
    np.testing.assert_allclose(tobj.numpy(), np.asarray(obj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sc["bearings"], bearings, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sc["mask"], mask)
    # bearings_of over a subset of frames and another field of view
    cfg = osc.base_config()
    q_bc, p_bc = cfg.camera_to_body_rotation, cfg.camera_to_body_translation
    b_j, m_j = jsyn.bearings_of(scene, jnp.asarray(q_bc), jnp.asarray(p_bc),
                                frame_idx=jnp.arange(3, 40, 5), fov_cos=0.5)
    b_t, m_t = synthetic.bearings_of(tscene, torch.as_tensor(q_bc), torch.as_tensor(p_bc),
                                     frame_idx=torch.arange(3, 40, 5), fov_cos=0.5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


Q_BI = np.array([0.999, 0.02, -0.03, 0.01]) / np.linalg.norm([0.999, 0.02, -0.03, 0.01])


def _frames(M, scene, cfg, k):
    """(frame k-1 with a solved-looking state, frame k with its IMU
    interval) as FrameRecs of map module M."""
    def mk(i):
        return M.FrameRec(
            id=1000 + i, t=float(scene.t[i]), q=np.asarray(scene.q[i]).copy(),
            p=np.asarray(scene.p[i]).copy(), v=np.asarray(scene.v[i]).copy(),
            bg=np.array([1e-3, -2e-3, 5e-4]), ba=np.array([0.01, 0.02, -0.01]),
            q_bc=cfg.camera_to_body_rotation, p_bc=cfg.camera_to_body_translation,
            q_bi=Q_BI,
            p_bi=np.array([0.01, -0.02, 0.005]), K=cfg.camera_intrinsic,
            sqrt_inv_cov2=np.eye(2), bearings=np.zeros((4, 3)),
            track_ids=np.full(4, -1))
    fi, fj = mk(k - 1), mk(k)
    fj.imu_t = np.asarray(scene.imu_t[k - 1]).copy()
    fj.imu_w = np.asarray(scene.imu_w[k - 1]).copy()
    fj.imu_a = np.asarray(scene.imu_a[k - 1]).copy()
    return fi, fj


def test_parsac_prediction_matches_jax():
    scene = jsyn.euler_consistent(jsyn.wave_scene(n_frames=24, n_landmarks=8))
    cfg = osc.base_config(parsac_flag=True)
    js = jsw.SlidingWindowTracker(jmap.PipelineMap(), JConfig(**convert.config_to_dict(cfg)))
    ts = tsw.SlidingWindowTracker(tmap.PipelineMap(), cfg, "cpu")
    for k in (5, 17):
        fi, fj = _frames(jmap, scene, cfg, k)
        js._predict_frame(fi, fj)
        js._land_pred_parsac()
        gi, gj = _frames(tmap, scene, cfg, k)
        ts._pred_parsac = ts._stage_prediction(gi, gj)
        assert ts._land_prediction() is None
        for a, b in ((gj.q, fj.q), (gj.p, fj.p), (gj.v, fj.v)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert ts.stats["parsac_host_reads"] == 2


def _write_yaml(tmp_path, cfg):
    """The (slam, device) YAML pair of `cfg`'s camera, initializer and
    PARSAC settings, with `parsac_flag: true`."""
    K = cfg.camera_intrinsic
    q = cfg.camera_to_body_rotation
    slam = tmp_path / "slam.yaml"
    dev = tmp_path / "device.yaml"
    slam.write_text(f"""%YAML:1.0
sliding_window:
  force_keyframe_landmarks: {cfg.sliding_window_force_keyframe_landmarks}
initializer:
  keyframe_gap: {cfg.initializer_keyframe_gap}
  min_matches: {cfg.initializer_min_matches}
  min_triangulation: {cfg.initializer_min_triangulation}
  min_landmarks: {cfg.initializer_min_landmarks}
parsac:
  parsac_flag: true
  dynamic_probability: {cfg.parsac_dynamic_probability}
  norm_scale: {cfg.parsac_norm_scale}
""")
    dev.write_text(f"""%YAML:1.0
cam0:
  intrinsics: [{K[0, 0]}, {K[1, 1]}, {K[0, 2]}, {K[1, 2]}]
  extrinsic:
    q_bc: [{", ".join(repr(float(q[i])) for i in (1, 2, 3, 0))}]
    p_bc: [{", ".join(repr(float(v)) for v in cfg.camera_to_body_translation)}]
""")
    return str(slam), str(dev)


@pytest.fixture(scope="module")
def yaml_drive(tmp_path_factory):
    """The dynamic-object drive with its config read from YAML
    (`parsac_flag: true`), up to the frame on which the judge first
    returns True, with the window state snapshotted before every judge
    call (`tools.parsac_chain`)."""
    sc = osc.object_scene()
    ref = osc.object_config(sc, parsac_flag=True)
    cfg = load_config(*_write_yaml(tmp_path_factory.mktemp("yaml"), ref)).replace(
        window_landmark_slots=sc["capacity"], init_landmark_slots=sc["capacity"])
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")

    def fired(k, p):
        return p.swt is not None and p.swt.stats["judge_true"] > 0

    with chain.snapshotting() as snaps:
        osc.drive(pipe, sc, on_frame=fired)
    return {"ref": ref, "cfg": cfg, "pipe": pipe, "snaps": snaps}


def test_yaml_parsac_flag_reaches_judge(yaml_drive):
    """`parsac_flag: true` from YAML reaches judge_track_status, and on
    the dynamic-object drive the judge returns True; every PARSAC frame
    reads the device at most twice (the judge's mask with the predicted
    pose; update's masks stacked)."""
    cfg, ref, pipe = yaml_drive["cfg"], yaml_drive["ref"], yaml_drive["pipe"]
    assert cfg.parsac_flag and cfg.parsac_norm_scale == 1.5
    for name in ("camera_intrinsic", "camera_to_body_rotation",
                 "camera_to_body_translation"):
        np.testing.assert_array_equal(getattr(cfg, name), getattr(ref, name))
    st = pipe.swt.stats
    assert st["judge_calls"] > 0 and st["judge_true"] == 1, st
    assert st["judge_calls"] == len(yaml_drive["snaps"])
    refused = sum(v for k, v in st.items() if k.startswith("judge_refused_"))
    assert refused == st["judge_calls"] - st["judge_true"], st
    assert st["tracks_unstatic"] > 0
    assert st["parsac_host_reads"] <= st["judge_calls"] + st["judge_true"], st
    assert "parsac_time" in pipe.times.means()


@contextlib.contextmanager
def jax_replay(drawn):
    """The JAX package's `sample_minimal` hands out the recorded draws in
    order, through a host callback inside its compiled programs (the
    caches are cleared on the way in and out, so no program keeps either
    version), after checking the shape of each request and that JAX
    weighted the points as the port did (to 1e-12)."""
    import jax
    from xrslam_tpu.ransac import core as jcore

    queue = list(drawn)

    def replaying(key, n_hyp, n_points, dof, valid=None, weights=None):
        def next_draw(*w):
            idx, w_port = queue.pop(0)
            assert idx.shape == (n_hyp, dof) and (not w) == (w_port is None)
            if w:
                np.testing.assert_allclose(np.asarray(w[0]), w_port, rtol=0, atol=1e-12)
            return idx.astype(np.int32)

        return jax.pure_callback(next_draw, jax.ShapeDtypeStruct((n_hyp, dof), jnp.int32),
                                 *(() if weights is None else (weights,)))

    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcore, "sample_minimal", replaying)
            yield queue
    finally:
        jax.clear_caches()
    assert not queue, f"{len(queue)} draws left unused"


def _as_jax(snap):
    """The snapshot's maps, records and prediction as the JAX package's
    classes and arrays (the two map modules have the same fields)."""
    snap = copy.deepcopy(snap)
    for m in (snap["map"], snap["tracker_map"]):
        m.__class__ = jmap.PipelineMap
        for tr in m.tracks.values():
            tr.__class__ = jmap.TrackRec
        stack = list(m.frames)
        while stack:
            f = stack.pop()
            f.__class__ = jmap.FrameRec
            stack.extend(f.subframes)
    if snap["pred"] is not None:
        snap["pred"] = (snap["pred"][0],) + tuple(
            jnp.asarray(x.numpy()) for x in snap["pred"][1:])
    for name in ("bin_conf", "bin_conf_2d2d"):
        snap[name] = jnp.asarray(snap[name].numpy())
    return snap


@pytest.mark.parametrize("which", ["fires", "fires_mixed_tags", "refuses"])
def test_judge_update_chain_matches_jax(yaml_drive, which):
    """judge_track_status and update_track_status of both packages from
    the same window state (the port's before the judge call on which
    the drive's judge first returned True, and before the call just
    ahead of it), the port drawing from its generator's state then and
    JAX taking the port's minimal samples: the same value, m_th, landed
    pose, bin confidences (1e-12), outlier and static tags of every
    track in both maps, and tracks_unstatic.

    On the first True every track is still static in both maps, so the
    static tag's propagation has nothing to carry; `fires_mixed_tags`
    first clears the tag of a seeded 30% of the tracks in each map,
    independently, so that every branch of the chain (inlier -> static
    and outlier -> non-static on both maps, update's propagation in
    both directions) changes some track."""
    snaps = yaml_drive["snaps"]
    snap, fired = snaps[-2] if which == "refuses" else snaps[-1]
    assert fired == (which != "refuses")
    if which == "fires_mixed_tags":
        snap = copy.deepcopy(snap)
        rng = np.random.default_rng(0)
        for name in ("map", "tracker_map"):
            for tid in sorted(snap[name].tracks):
                if rng.random() < 0.3:
                    snap[name].tracks[tid].static = False
    cfg = yaml_drive["cfg"]
    ts = tsw.SlidingWindowTracker(tmap.PipelineMap(), cfg, "cpu")
    ts.generator.set_state(snap["generator"])
    tsnap = copy.deepcopy(snap)
    with chain.recorded_draws() as drawn:
        t_ok = chain.run_chain(ts, tsnap)
    js = jsw.SlidingWindowTracker(jmap.PipelineMap(), JConfig(**convert.config_to_dict(cfg)))
    jsnap = _as_jax(snap)
    with jax_replay(drawn):
        j_ok = chain.run_chain(js, jsnap)
    # the drive's outcome, reproduced; on True the update's PARSACs ran
    assert t_ok == fired
    assert len(drawn) >= (2 if t_ok else 1), len(drawn)
    assert not chain.differences(t_ok, ts, tsnap, j_ok, js, jsnap)
    if t_ok:
        # the tags moved on both maps, some tracks un-static'd
        assert ts.stats["tracks_unstatic"] > snap["stats"]["tracks_unstatic"]
        assert chain.tags(tsnap["map"]) != chain.tags(snap["map"])
        assert chain.tags(tsnap["tracker_map"]) != chain.tags(snap["tracker_map"])


def test_chain_check_rehearsal(yaml_drive):
    """`chip_smoke.chain_check` with the CPU standing in for the card:
    the snapshot before the first judge True, replayed on both sides."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    res = chip_smoke.chain_check(torch.device("cpu"), yaml_drive["snaps"],
                                 yaml_drive["cfg"])
    assert res["from_first_true"] and res["judge"] and res["draws"] >= 2, res
    assert res["tracks_unstatic"] > 0 and not res["differences"], res


def _no_translation_flags(tracker, M, bearings, mask, frames):
    """Feeds `frames` of the scene's bearings (landmark index as the
    track hint) to a SyntheticTracker of map module M; returns each
    frame's FT_NO_TRANSLATION flag."""
    cfg = osc.base_config()
    pmap, C, out = M.PipelineMap(), bearings.shape[1], []
    for k in frames:
        kp = np.zeros((C, 3))
        kp[:, 2] = 1.0
        hint = np.full((C,), -1, dtype=np.int64)
        vis = np.nonzero(mask[k])[0]
        kp[:len(vis)] = bearings[k, vis]
        hint[:len(vis)] = vis
        f = M.FrameRec(
            id=M.new_frame_id(), t=0.05 * k, q=np.array([1.0, 0, 0, 0]), p=np.zeros(3),
            v=np.zeros(3), bg=np.zeros(3), ba=np.zeros(3),
            q_bc=cfg.camera_to_body_rotation, p_bc=cfg.camera_to_body_translation,
            q_bi=np.array([1.0, 0, 0, 0]), p_bi=np.zeros(3), K=cfg.camera_intrinsic,
            sqrt_inv_cov2=np.eye(2), bearings=kp, track_ids=np.full((C,), -1))
        f._hint = hint
        pmap.attach_frame(f)
        tracker.track_frame(pmap, f)
        out.append(bool(f.no_translation))
    return out


def test_synthetic_tracker_no_translation_matches_jax():
    """SyntheticTracker(config) of both packages over frames 36-59 of a
    wave trajectory with a pure-rotation pause at 2.4 s (the pause of
    `test_pure_rotation_subframes_e2e`), the port drawing its
    rotation-RANSAC samples and JAX taking them: the same
    FT_NO_TRANSLATION flag on every frame, set on some and clear on
    others."""
    cfg = osc.base_config()
    scene = synthetic.euler_consistent(synthetic.wave_scene(
        n_frames=60, n_landmarks=96, seed=0, pause=(2.4, 0.8)))
    b, m = synthetic.bearings_of(scene, torch.as_tensor(cfg.camera_to_body_rotation),
                                 torch.as_tensor(cfg.camera_to_body_translation))
    b, m = b.numpy(), m.numpy()
    frames = range(36, 60)
    with chain.recorded_draws() as drawn:
        flags = _no_translation_flags(SyntheticTracker(cfg, device="cpu"), tmap, b, m, frames)
    assert len(drawn) == len(frames) - 1
    with jax_replay(drawn):
        j_flags = _no_translation_flags(
            jdetail.SyntheticTracker(JConfig(**convert.config_to_dict(cfg))), jmap, b, m,
            frames)
    assert flags == j_flags
    assert any(flags) and not all(flags), flags


def test_visual_pnp_publishes_camera_rate_poses():
    """`tests/test_visual_pnp.py`'s scene (the first 64 landmarks of the
    committed 500 draw; the backend every 2nd frame): the PnP pose runs on
    every tracked frame and stays published, at the frame's time, on every
    frame the backend skips; on a backend frame the backend's anchor (its
    deferred write-back: one solve back, as in the JAX package) replaces
    it."""
    cfg = osc.base_config(visual_pnp_enable=True, sliding_window_tracker_frequent=2)
    scene = synthetic.euler_consistent(synthetic.wave_scene(n_frames=36))
    scene = scene._replace(landmarks=scene.landmarks[:64])
    b, m = synthetic.bearings_of(scene, torch.as_tensor(cfg.camera_to_body_rotation),
                                 torch.as_tensor(cfg.camera_to_body_translation))
    sc = {"scene": scene, "bearings": b.numpy(), "mask": m.numpy(), "capacity": 96}
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    at_frame = []

    tracked = [0]

    def on_frame(k, p):
        if p.state == "tracking":
            tracked[0] += 1
            if (p.frames_processed - 1) % 2:  # the backend skipped it
                at_frame.append(abs(p._prop["t"] - float(scene.t[k])) < 1e-9)

    est_t, est_p = osc.drive(pipe, sc, on_frame=on_frame)
    assert len(at_frame) >= 5 and all(at_frame)
    assert pipe.pnp_frames >= tracked[0] - 1
    assert osc.scene_ate(sc, est_t, est_p) < 0.01


def test_visual_localization_raises():
    """The localizer is ported, so `visual_localization_enable` raises
    only where the HTTP client cannot run: with Pillow (its JPEG
    encoder) blocked, a configured server endpoint raises ImportError
    at construction instead of logging a warning on every query."""
    import subprocess

    code = ("import sys; sys.modules['PIL'] = None\n"
            "from xrslam_tpu_torch.core.detail import SyntheticTracker, VIOPipeline\n"
            "from xrslam_tpu_torch.tools import object_scene as osc\n"
            "cfg = osc.base_config(visual_localization_enable=True,"
            " visual_localization_config_port=8000)\n"
            "try:\n"
            "    VIOPipeline(cfg, SyntheticTracker(device='cpu'), device='cpu')\n"
            "except ImportError as e:\n"
            "    print('raised', e.name)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "raised PIL"


def test_visual_localization_accepted():
    """`visual_localization_enable` no longer raises, and a configured
    server endpoint installs the HTTP client."""
    from xrslam_tpu_torch.localizer import HttpLocalizer

    cfg = osc.base_config(visual_localization_enable=True)
    assert api.XRSLAM(config=cfg, device="cpu").pipeline.localizer is None
    assert VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu").localizer is None
    cfg = cfg.replace(visual_localization_config_port=8000)
    pipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    assert isinstance(pipe.localizer, HttpLocalizer) and pipe.localizer.port == 8000


@pytest.mark.slow
def test_dynamic_object_pair_drive():
    """The dynamic-object scene through both packages, each held to
    test_dynamic_object_parsac_e2e's criteria; ATEs within 0.05 m."""
    scene, _, bearings, mask = jax_object_scene()
    sc = osc.object_scene()
    cfg = osc.object_config(sc, parsac_flag=True)
    jtracker = jdetail.SyntheticTracker()
    jpipe = jdetail.VIOPipeline(JConfig(**convert.config_to_dict(cfg)), jtracker)
    jsc = dict(sc, bearings=bearings, mask=mask)
    j_t, j_p = osc.drive(jpipe, jsc)
    a_j = osc.scene_ate(sc, j_t, j_p)
    bad_j = osc.criteria_failures(jpipe.swt.stats, osc.object_verdict(jpipe, sc), a_j)

    tpipe = VIOPipeline(cfg, SyntheticTracker(device="cpu"), device="cpu")
    t_t, t_p = osc.drive(tpipe, sc)
    a_t = osc.scene_ate(sc, t_t, t_p)
    bad_t = osc.criteria_failures(tpipe.swt.stats, osc.object_verdict(tpipe, sc), a_t)
    assert not bad_j, bad_j
    assert not bad_t, bad_t
    assert abs(a_j - a_t) <= 0.05, (a_j, a_t)



@contextlib.contextmanager
def judge_outcomes(sw_module):
    """Counts `sw_module.SlidingWindowTracker.judge_track_status`'s
    outcomes while the block runs: calls, True returns, refusals before
    the IMU-PARSAC PnP (< 20 triangulated tracks), after it but before
    the epipolar medians (too few matches, inliers or outliers), and at
    the ambiguity test; and the most PnP outliers of one call."""
    cls = sw_module.SlidingWindowTracker
    judge, find = cls.judge_track_status, sw_module.pnp_mod.find_pnp_matrix_parsac_imu
    out = {"calls": 0, "true": 0, "before_pnp": 0, "before_medians": 0,
           "ambiguous": 0, "max_outliers": 0}
    call = {}

    def counted_find(*args, **kwargs):
        res = find(*args, **kwargs)
        valid, mask = np.asarray(kwargs["valid"]), np.asarray(res[1])
        call["pnp"] = True
        out["max_outliers"] = max(out["max_outliers"], int(np.sum(valid & ~mask)))
        return res

    def counted_judge(self):
        call.clear()
        medians = []
        np_median = sw_module.np.median

        def median(a, *args, **kwargs):
            medians.append(len(a))
            return np_median(a, *args, **kwargs)

        sw_module.np.median = median
        try:
            ok = judge(self)
        finally:
            sw_module.np.median = np_median
        out["calls"] += 1
        if ok:
            out["true"] += 1
        elif not call:
            out["before_pnp"] += 1
        elif not medians:
            out["before_medians"] += 1
        else:
            out["ambiguous"] += 1
        return ok

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "judge_track_status", counted_judge)
        mp.setattr(sw_module.pnp_mod, "find_pnp_matrix_parsac_imu", counted_find)
        yield out


def static_scene_judges(n_frames=120):
    """`chip_smoke.py`'s PARSAC drive (the static bench scene at 752x480,
    focal 458, `parsac_flag`) through the JAX package (its TPU level
    tracker, as `tests/test_torch_slice.py` runs it) and through the
    port on the CPU. Returns {package: (judge outcomes, frames tracked,
    ATE)}; a package that raises records the error and the outcomes up
    to it."""
    import jax
    from xrslam_tpu import api as japi

    seq = render_sequence(n_frames=n_frames, width=752, height=480, focal=458.0)
    cfg = seq["config"].replace(parsac_flag=True)
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XR_LK_BACKEND", "mxu")
        jax.clear_caches()
        with judge_outcomes(jsw) as jout:
            try:
                ts, ps = run_sequence(japi, japi.XRSLAM(
                    config=JConfig(**convert.config_to_dict(cfg))), seq)
                res["jax"] = (jout, len(ts), ate(seq, ts, ps))
            except Exception as e:  # noqa: BLE001 - recorded and asserted on
                res["jax"] = (jout, None, repr(e))
        jax.clear_caches()
    with judge_outcomes(tsw) as tout:
        ts, ps = run_sequence(api, api.XRSLAM(config=cfg, device="cpu"), seq)
        res["port"] = (tout, len(ts), ate(seq, ts, ps))
    return res


@pytest.mark.slow
def test_static_scene_judge_pair():
    """On the static scene both packages' judges return True on the same
    side of zero: a judge that fires in one package and never in the
    other is a defect of the chain, not a draw."""
    res = static_scene_judges()
    print(res)
    assert res["jax"][1] is not None, res
    assert (res["jax"][0]["true"] > 0) == (res["port"][0]["true"] > 0), res
