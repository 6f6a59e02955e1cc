"""State and Config round trips through xrslam_tpu_torch.convert, and
the port's synthetic scene against the JAX package's: trajectory, IMU
and landmarks to 1e-12 in float64, rendered frames bit-equal, and the
committed landmark and object draws equal to fresh `jax.random` draws.

Run as a script from the repository root
(`PYTHONPATH=. python tests/test_torch_convert.py --write`) to rewrite
the committed draws in xrslam_tpu_torch/io/data from the JAX package;
the output is byte-identical to the committed files.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.config import Config as JConfig
from xrslam_tpu.estimation.window import MargPrior as JMargPrior
from xrslam_tpu.imu import preintegration as jpre
from xrslam_tpu.io import synthetic as jsyn
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.config import Config
from xrslam_tpu_torch.estimation.window import WindowData, WindowState
from xrslam_tpu_torch.io import synthetic
from xrslam_tpu_torch.tools.make_dataset import render_sequence

LANDMARK_FILE = os.path.join(synthetic.DATA_DIR, "wave_seed3_l500.npy")


def fresh_jax_landmarks(seed: int = 3, n_landmarks: int = 500) -> np.ndarray:
    """The JAX scene's landmark draw (independent of the frame count)."""
    return np.asarray(jsyn.wave_scene(n_frames=2, n_landmarks=n_landmarks,
                                      seed=seed).landmarks)


def fresh_jax_object_draw(seed: int, n_points: int) -> np.ndarray:
    """`moving_object`'s jax.random.uniform draw on [0, 1): the same
    bits as its [-extent, extent) draw, before the scaling."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n_points, 3),
                                         dtype=jnp.float64))


def committed_draws():
    """(file, fresh JAX draw) of every draw committed in io/data."""
    out = [(name, lambda k=k: fresh_jax_landmarks(*k))
           for k, name in synthetic.DEFAULT_LANDMARKS.items()]
    out += [(name, lambda k=k: fresh_jax_object_draw(*k))
            for k, name in synthetic.DEFAULT_OBJECT_DRAWS.items()]
    return [(os.path.join(synthetic.DATA_DIR, name), fn) for name, fn in out]


def _leaves_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            _leaves_equal(x, y)
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype or (x.dtype.kind == y.dtype.kind), name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_window_round_trip():
    st, data = jsyn.demo_window_problem(4, 32, jnp.float64)
    data = data._replace(marg=JMargPrior.gauge_fix(4, 32, st),
                         use_marg=jnp.asarray(True))
    tst, tdata = convert.to_torch(st), convert.to_torch(data)
    assert isinstance(tst, WindowState) and isinstance(tdata, WindowData)
    assert tdata.obs_mask.dtype == torch.bool
    assert tdata.ref_idx.dtype == torch.int32
    assert tdata.preint.cov.dtype == torch.float64
    _leaves_equal(st, convert.to_numpy(tst))
    _leaves_equal(data, convert.to_numpy(tdata))


def test_preint_and_noise_round_trip():
    noise = jpre.ImuNoise.isotropic(1e-4, 1e-2, 1e-8, 1e-6)
    rng = np.random.default_rng(0)
    d = jpre.integrate(jnp.arange(10) * 0.005, jnp.asarray(rng.normal(0, 0.3, (10, 3))),
                       jnp.asarray(rng.normal(0, 1.0, (10, 3)) + [0, 0, 9.8]),
                       0.05, jnp.zeros(3), jnp.zeros(3), noise)
    for x in (d, noise):
        t = convert.to_torch(x)
        _leaves_equal(x, convert.to_numpy(t))
    t32 = convert.to_torch(d, dtype=torch.float32)
    assert t32.cov.dtype == torch.float32


def test_config_round_trip():
    ref = JConfig(sliding_window_size=7, camera_intrinsic=np.diag([400.0, 410.0, 1.0]),
                  parsac_flag=True, random=11)
    cfg = convert.config_from(ref)
    assert isinstance(cfg, Config)
    back = convert.config_to_dict(cfg)
    for f in dataclasses.fields(JConfig):
        a, b = getattr(ref, f.name), back[f.name]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert convert.config_to_dict(convert.config_from(cfg)).keys() == back.keys()


def test_committed_landmarks_equal_fresh_jax_draw():
    np.testing.assert_array_equal(np.load(LANDMARK_FILE), fresh_jax_landmarks())


SCENE_DRAWS = [d for d in committed_draws() if d[0] != LANDMARK_FILE]


@pytest.mark.parametrize("path,fresh", SCENE_DRAWS,
                         ids=[os.path.basename(p) for p, _ in SCENE_DRAWS])
def test_committed_scene_draws_equal_fresh_jax_draws(path, fresh):
    """The draws the dynamic-object scene reads (beside the bench
    scene's landmarks, above)."""
    np.testing.assert_array_equal(np.load(path), fresh())


def test_wave_scene_matches_jax():
    n = 12
    ref = jsyn.euler_consistent(jsyn.wave_scene(n_frames=n, n_landmarks=500, seed=3))
    out = synthetic.euler_consistent(synthetic.wave_scene(n_frames=n))
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_wave_scene_with_pause_matches_jax():
    ref = jsyn.wave_scene(n_frames=8, n_landmarks=500, seed=3, pause=(0.2, 0.1))
    out = synthetic.wave_scene(n_frames=8, pause=(0.2, 0.1))
    for name in ("q", "p", "v", "imu_w", "imu_a"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_rendered_frames_bit_equal(tmp_path):
    """The JAX package's dataset renderer (PNG frames, IMU csv, ground
    truth) against the port's in-memory renderer."""
    pytest.importorskip("PIL")
    from PIL import Image

    from xrslam_tpu.tools.make_dataset import render_dataset

    n = 4
    paths = render_dataset(str(tmp_path), n_frames=n, n_landmarks=500)
    seq = render_sequence(n_frames=n)
    root = paths["root"]
    names = sorted(os.listdir(os.path.join(root, "cam0", "data")))
    assert len(names) == n
    for i, fn in enumerate(names):
        img = np.asarray(Image.open(os.path.join(root, "cam0", "data", fn)))
        np.testing.assert_array_equal(seq["images"][i], img)
        assert abs(float(fn[:-4]) * 1e-9 - seq["t_cam"][i]) == 0.0
    imu = np.loadtxt(os.path.join(root, "imu0", "data.csv"), delimiter=",")
    np.testing.assert_allclose(seq["imu_w"], imu[:, 1:4], rtol=0, atol=1e-12)
    np.testing.assert_allclose(seq["imu_a"], imu[:, 4:7], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(seq["imu_t"], imu[:, 0] * 1e-9)
    gt = np.loadtxt(os.path.join(root, "state_groundtruth_estimate0", "data.csv"),
                    delimiter=",")
    np.testing.assert_allclose(seq["gt_p"], gt[:, 1:4], rtol=0, atol=1e-12)
    from xrslam_tpu.config import load_config

    jcfg = load_config(paths["slam_yaml"], paths["device_yaml"])
    ported = convert.config_to_dict(seq["config"])
    for f in dataclasses.fields(JConfig):
        a, b = getattr(jcfg, f.name), ported[f.name]
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-15, err_msg=f.name)
        else:
            assert a == b, f.name


if __name__ == "__main__":
    if "--write" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        for path, fresh in committed_draws():
            np.save(path, fresh())
            print("wrote", path)
