"""The port's C ABI: `xrslam_tpu_torch.capi_host` against the JAX
package's `capi_host`, and the shim `xrslam_tpu_torch/native/xr_capi.cpp`
(built by `native.build_capi` against `native/XRSLAM.h`) driven from C.

- Both host modules over one YAML pair (8-frame window), IMU and 3
  camera frames on the CPU: the body and camera pose, state, bias,
  intrinsics and landmarks after the third frame, and the features
  after the first (GFTT; after that the tracker's RANSAC gates take
  each package's own draws), within 1e-9. At 320x240: the
  JAX package's KLT takes a 22-pixel block at the top pyramid level, so
  at 64x48 it raises on the second frame.
- `tests/data/capi_roundtrip.c` compiled against the port's shim and run
  as a process with XRSLAM_TORCH_DEVICE=cpu and `jax` and `xrslam_tpu`
  unimportable in its embedded interpreter: every CAPI_* line that
  `tests/test_native.py::test_capi_c_roundtrip` checks.
- The shim loaded with ctypes into this interpreter (which it reuses)
  gives the host module's results.
- The default device is the card: without one, XRSLAMCreate fails with
  the port's message.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import xrslam_tpu.capi_host as jhost
import xrslam_tpu_torch.capi_host as thost
from xrslam_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")

SLAM_YAML = ("%YAML:1.0\n"
             "sliding_window:\n  size: 8\n  subframe_size: 3\n"
             "feature_tracker:\n  min_keypoint_distance: 8.0\n"
             "  max_keypoint_detection: 40\n"
             "solver:\n  iteration_limit: 5\n")
DEVICE_YAML = ("%YAML:1.0\n"
               "cam0:\n"
               "  resolution: [{w}, {h}]\n"
               "  intrinsics: [60.0, 60.0, {cx}, {cy}]\n")
TOL = 1e-9


def _yaml_pair(tmp_path, w: int, h: int):
    slam, dev = tmp_path / "slam.yaml", tmp_path / "device.yaml"
    slam.write_text(SLAM_YAML)
    dev.write_text(DEVICE_YAML.format(w=w, h=h, cx=w / 2, cy=h / 2))
    return str(slam), str(dev)


@pytest.fixture
def yaml_pair(tmp_path):
    """The 64x48 pair of tests/test_native.py::test_capi_c_roundtrip."""
    return _yaml_pair(tmp_path, 64, 48)


def _frame(seed: int, h: int = 48, stride: int = 72) -> bytes:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:stride]
    img = (x * 13 + y * 7 + (x * y) % 31 + rng.integers(0, 8, (h, stride))) & 0xFF
    return img.astype(np.uint8).tobytes()


def _drive(host):
    """IMU at 200 Hz from 0 to 0.16 s and 3 320x240 frames (0.05, 0.1,
    0.15)."""
    out = {}
    for f, t_img in enumerate((0.05, 0.10, 0.15)):
        for i in range(int(round((t_img - 0.05) / 0.005)),
                       int(round((t_img + 0.01) / 0.005)) + 1):
            t = i * 0.005
            host.push_imu(3, t, 0.01, -0.02 + 0.1 * t, 0.005)
            host.push_imu(2, t, 0.05 + 0.2 * t, -0.03, 9.81)
        host.push_camera(t_img, _frame(f, 240, 328), 328, 1)
        host.run_one_frame()
        if f == 0:
            out["features"] = np.frombuffer(host.get_features(), np.float64)
    out["body"] = host.get_pose(0)
    out["camera"] = host.get_pose(1)
    out["state"] = host.get_state()
    out["bias"] = host.get_bias()
    out["intrinsics"] = host.get_intrinsics()
    out["landmarks"] = np.frombuffer(host.get_landmarks(), np.float64)
    out["version"] = host.get_version()
    return out


def test_capi_host_matches_jax(tmp_path, monkeypatch):
    yaml_pair = _yaml_pair(tmp_path, 320, 240)
    monkeypatch.setenv(thost.DEVICE_ENV, "cpu")
    assert jhost.create(*yaml_pair) == 1
    try:
        ref = _drive(jhost)
    finally:
        jhost.destroy()
    assert thost.create(*yaml_pair) == 1
    assert thost._engine.device == torch.device("cpu")
    try:
        out = _drive(thost)
    finally:
        thost.destroy()
    assert out["state"] == ref["state"]
    assert out["version"] and ref["version"]
    for key in ("body", "camera", "bias", "intrinsics"):
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=TOL, err_msg=key)
    for key in ("features", "landmarks"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=TOL, err_msg=key)
    assert len(out["features"]) > 0


def test_capi_host_defaults_to_the_card(yaml_pair, monkeypatch):
    monkeypatch.delenv(thost.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        thost.create(*yaml_pair)


def _blocked_path(tmp_path) -> str:
    """A directory whose `jax` and `xrslam_tpu` packages raise on import."""
    block = tmp_path / "blocked"
    for pkg in ("jax", "xrslam_tpu"):
        (block / pkg).mkdir(parents=True)
        (block / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is blocked in the port')\n")
    return str(block)


def test_capi_c_roundtrip(tmp_path, yaml_pair):
    info = native.build_capi()
    cc = shutil.which("gcc") or shutil.which("cc")
    assert cc is not None, "no C compiler"
    exe = str(tmp_path / "capi_roundtrip")
    r = subprocess.run(
        [cc, os.path.join(REPO, "tests", "data", "capi_roundtrip.c"), "-I", NATIVE_DIR,
         info["library"], f"-Wl,-rpath,{os.path.dirname(info['library'])}", "-o", exe],
        capture_output=True, text=True)
    if r.returncode != 0 and not info["links_libpython"]:
        pytest.skip("this Python has no shared libpython, so a C program cannot "
                    f"link the shim: {r.stderr[-300:]}")
    assert r.returncode == 0, r.stderr
    env = dict(os.environ)
    env.pop("PYTHONHOME", None)
    env.update(PYTHONPATH=os.pathsep.join([_blocked_path(tmp_path), REPO]),
               XRSLAM_TORCH_DEVICE="cpu")
    r = subprocess.run([exe, *yaml_pair], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-800:])
    out = {}
    for line in r.stdout.splitlines():
        parts = line.split()
        if parts and parts[0].startswith("CAPI_"):
            out[parts[0]] = parts[1:]
    assert "CAPI_OK" in out
    assert out["CAPI_VERSION"], out
    assert out["CAPI_STATE0"] == ["0"]
    assert out["CAPI_STATE1"] == ["0"]
    assert float(out["CAPI_FX"][0]) == 60.0
    assert float(out["CAPI_FX"][2]) == 24.0
    assert int(out["CAPI_NFEATURES"][0]) > 0
    assert int(out["CAPI_NLANDMARKS"][0]) == 0
    assert float(out["CAPI_BIAS"][0]) == 0.0


class XRSLAMPose(ctypes.Structure):
    _fields_ = [("quaternion", ctypes.c_double * 4),
                ("translation", ctypes.c_double * 3),
                ("timestamp", ctypes.c_double)]


def test_capi_shim_in_process(yaml_pair, monkeypatch):
    """The shim reuses this interpreter; its results are the host
    module's."""
    monkeypatch.setenv(thost.DEVICE_ENV, "cpu")
    lib = ctypes.CDLL(native.build_capi()["library"])
    lib.XRSLAMCreate.argtypes = [ctypes.c_char_p] * 4 + [ctypes.c_void_p]
    lib.XRSLAMGetLastError.restype = ctypes.c_char_p
    lib.XRSLAMGetResult.argtypes = [ctypes.c_int, ctypes.c_void_p]
    assert lib.XRSLAMCreate(yaml_pair[0].encode(), yaml_pair[1].encode(), None, None,
                            None) == 1, lib.XRSLAMGetLastError()
    try:
        state = ctypes.c_int(-1)
        lib.XRSLAMGetResult(2, ctypes.byref(state))
        assert state.value == 0
        thost.push_camera(0.05, _frame(0), 72, 1)   # the shim's module
        lib.XRSLAMRunOneFrame()
        pose = XRSLAMPose()
        lib.XRSLAMGetResult(0, ctypes.byref(pose))
        assert tuple(pose.quaternion) + tuple(pose.translation) + (pose.timestamp,) \
            == thost.get_pose(0)
    finally:
        lib.XRSLAMDestroy()
    assert thost._engine is None
