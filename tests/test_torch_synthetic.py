"""The port's `circle_scene`, `window_problem` and `demo_window_problem`
(xrslam_tpu_torch/io/synthetic.py) against the JAX package's, with the
JAX landmark draws injected, to 1e-12 (absolute, and relative where
the preintegration square-root information runs to 1e3) in float64;
and the committed circle draws equal to fresh `jax.random` draws.

Run as a script from the repository root
(`PYTHONPATH=. python tests/test_torch_synthetic.py --write`) to write
the committed circle draws in xrslam_tpu_torch/io/data from the JAX
package.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrslam_tpu.geometry import lie as jlie
from xrslam_tpu.io import synthetic as jsyn
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.io import synthetic

TOL = 1e-12


def fresh_circle_landmarks(seed: int, n_landmarks: int) -> np.ndarray:
    """The JAX circle scene's float64 landmark draw (independent of the
    frame count)."""
    return np.asarray(jsyn.circle_scene(n_frames=2, n_landmarks=n_landmarks,
                                        seed=seed).landmarks)


def _close(a, b, what):
    """Leaf-wise comparison of two state containers (or arrays)."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for name, x, y in zip(a._fields, a, b):
            _close(x, y, f"{what}.{name}")
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_circle_scene_matches_jax():
    js = jsyn.circle_scene(n_frames=9, n_landmarks=20, seed=4)
    ts = synthetic.circle_scene(n_frames=9, n_landmarks=20,
                                landmarks=np.asarray(js.landmarks))
    for name in ts._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("K,L,stride", [(6, 64, 2), (4, 40, 3)])
def test_window_problem_matches_jax(K, L, stride):
    js = jsyn.euler_consistent(jsyn.circle_scene(n_frames=K * stride + 1,
                                                 n_landmarks=L - 8))
    q_bc = jlie.expmap(jnp.asarray([-np.pi / 2 + 0.05, 0.03, -0.02]))
    p_bc = jnp.asarray([0.02, -0.01, 0.03])
    frames = list(range(0, K * stride, stride))
    jst, jdata = jsyn.window_problem(js, frames, L=L, q_bc=q_bc, p_bc=p_bc)
    ts = synthetic.euler_consistent(synthetic.circle_scene(
        n_frames=K * stride + 1, n_landmarks=L - 8, landmarks=np.asarray(js.landmarks)))
    tst, tdata = synthetic.window_problem(ts, frames, L=L, q_bc=np.asarray(q_bc),
                                          p_bc=np.asarray(p_bc))
    assert int(tdata.landmark_mask.sum()) > L // 2
    _close(convert.to_numpy(tst), convert.to_numpy(convert.to_torch(jst)), "state")
    _close(convert.to_numpy(tdata), convert.to_numpy(convert.to_torch(jdata)), "data")


def test_demo_window_problem_matches_jax():
    jst, jdata = jsyn.demo_window_problem(12, 384, jnp.float64)
    tst, tdata = synthetic.demo_window_problem(12, 384)        # committed draw
    _close(convert.to_numpy(tst), convert.to_numpy(convert.to_torch(jst)), "state")
    _close(convert.to_numpy(tdata), convert.to_numpy(convert.to_torch(jdata)), "data")


def test_committed_circle_draws_equal_jax():
    for (seed, n), name in synthetic.DEFAULT_CIRCLE_LANDMARKS.items():
        np.testing.assert_array_equal(np.load(os.path.join(synthetic.DATA_DIR, name)),
                                      fresh_circle_landmarks(seed, n), err_msg=name)
    with pytest.raises(ValueError, match="no committed"):
        synthetic.circle_scene(n_landmarks=25)
    with pytest.raises(ValueError, match="no committed"):
        synthetic.demo_window_problem(4, 40)


def test_window_problem_device_and_dtype():
    st, data = synthetic.demo_window_problem(4, 32, dtype=torch.float32, device="cpu")
    assert st.p.dtype == torch.float32 and data.bearings.dtype == torch.float32
    assert data.ref_idx.dtype == torch.int32 and data.obs_mask.dtype == torch.bool
    assert data.marg.lin.inv_depth.shape == (32,)


if __name__ == "__main__" and "--write" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for (seed, n), name in synthetic.DEFAULT_CIRCLE_LANDMARKS.items():
        path = os.path.join(synthetic.DATA_DIR, name)
        np.save(path, fresh_circle_landmarks(seed, n))
        print("wrote", path)
