"""The port's native host runtime (`xrslam_tpu_torch.native`, built with
g++ from native/xr_host.cpp into xrslam_tpu_torch/_build/) against
Pillow, its plain Python versions and the JAX package's bindings
(`xrslam_tpu.native`, the same C source): the PNG decode against Pillow
on 8-bit gray and RGB and 16-bit files; the remap, the CSV loaders and
`fuse_imu` equal to the JAX package's bindings bit for bit on the same
inputs, and the remap within 1e-5 of the numpy version;
`poisson_filter` equal to `frontend.tracker._poisson_accept`, with the
spacing property; a failed build raises with the compiler's output; the
tracker and the reader call the bindings."""

import numpy as np
import pytest
from PIL import Image

from xrslam_tpu import native as jnative
from xrslam_tpu_torch import native
from xrslam_tpu_torch.frontend.tracker import _poisson_accept
from xrslam_tpu_torch.io import dataset as tdataset


def test_png_load_matches_pil(tmp_path):
    rng = np.random.default_rng(0)
    for mode, arr in [
        ("L", rng.integers(0, 256, (37, 53)).astype(np.uint8)),
        ("RGB", rng.integers(0, 256, (24, 31, 3)).astype(np.uint8)),
    ]:
        p = str(tmp_path / f"t_{mode}.png")
        Image.fromarray(arr, mode=mode).save(p)
        out = native.png_load_gray(p)
        assert out.dtype == np.float32 and out.shape == arr.shape[:2]
        if mode == "L":
            assert np.array_equal(out, arr.astype(np.float32) / 255.0)
        else:
            ref = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                   + 0.114 * arr[..., 2]) / 255.0
            assert np.abs(out - ref).max() < 2e-3  # PIL rounds differently
        assert np.array_equal(out, jnative.png_load_gray(p))


def test_png_16bit(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 65536, (20, 22)).astype(np.uint16)
    p = str(tmp_path / "t16.png")
    Image.fromarray(arr).save(p)
    out = native.png_load_gray(p)
    assert np.array_equal(out, arr.astype(np.float32) / 65535.0)
    assert np.array_equal(out, tdataset.load_gray_pillow(p))


def test_png_decode_refusal_raises(tmp_path):
    p = str(tmp_path / "palette.png")
    Image.fromarray(np.zeros((8, 8), np.uint8), mode="L").convert("P").save(p)
    with pytest.raises(ValueError, match="native PNG decode"):
        native.png_load_gray(p)


def test_remap_matches_jax_and_python():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    remap = tdataset.UndistortMap(K, np.array([-0.2, 0.05, 1e-3, -1e-3]), 64, 48)
    before = native.CALLS["remap_bilinear"]
    out = remap(img)
    assert native.CALLS["remap_bilinear"] == before + 1
    assert np.array_equal(out, jnative.remap_bilinear(img, remap.src_u, remap.src_v))
    assert np.allclose(out, remap.remap_plain(img), atol=1e-5)


def test_csv_loaders(tmp_path):
    imu = tmp_path / "imu.csv"
    imu.write_text("#timestamp [ns],w,w,w,a,a,a\n"
                   "1000000000,0.1,0.2,0.3,1,2,3\n"
                   "1005000000,0.4,0.5,0.6,4,5,6\n")
    t, w, a = native.imu_csv_load(str(imu))
    assert np.allclose(t, [1.0, 1.005])
    assert np.allclose(w[1], [0.4, 0.5, 0.6])
    assert np.allclose(a[0], [1, 2, 3])
    for x, y in zip((t, w, a), jnative.imu_csv_load(str(imu))):
        assert np.array_equal(x, y)

    cam = tmp_path / "cam.csv"
    cam.write_text("#timestamp [ns],filename\n"
                   "2000000000,img_a.png\n2100000000,img_b.png\n")
    items = native.cam_csv_load(str(cam))
    assert items == [(2.0, "img_a.png"), (2.1, "img_b.png")]
    assert items == jnative.cam_csv_load(str(cam))


def test_fuse_imu_interpolates():
    tg = np.array([0.0, 0.01, 0.02, 0.03])
    wg = np.stack([np.array([i, 0.0, 0.0]) for i in range(4)])
    ta = np.array([-0.01, 0.005, 0.015, 0.02, 0.05])
    aa = np.tile(np.array([[0.0, 0.0, 9.8]]), (5, 1))
    t, w, a = native.fuse_imu(tg, wg, ta, aa)
    # accel at -0.01 (before gyro) and 0.05 (after) are dropped
    assert np.allclose(t, [0.005, 0.015, 0.02])
    assert np.allclose(w[:, 0], [0.5, 1.5, 2.0])
    assert np.allclose(a[:, 2], 9.8)
    for x, y in zip((t, w, a), jnative.fuse_imu(tg, wg, ta, aa)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", [3, 4])
def test_poisson_filter_matches_python(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 200, (300, 2))
    lengths = rng.integers(0, 10, 300)
    keep = rng.uniform(size=300) > 0.2
    order = np.argsort(-lengths, kind="stable")

    nat = native.poisson_filter(pts, order, keep, 11.0)
    assert np.array_equal(nat, _poisson_accept(pts, order, keep, 11.0))
    assert np.array_equal(nat, jnative.poisson_filter(pts, order, keep, 11.0))
    acc = pts[nat]
    d = np.linalg.norm(acc[:, None] - acc[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() >= 11.0


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a build that cannot run raises with the compiler's
    complaint, and so does the binding's first call."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.poisson_filter(np.zeros((1, 2)), np.zeros(1, np.int64),
                              np.ones(1, bool), 5.0)
    assert not native.available()
    # a compiler that runs and fails: its stderr is in the message
    broken = tmp_path / "xr_host.cpp"
    broken.write_text("int xr_broken = ;\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "HOST_SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*xr_broken"):
        native.load()


def test_tracker_and_reader_use_the_runtime(tmp_path):
    from xrslam_tpu_torch.tools.make_dataset import render_dataset

    paths = render_dataset(str(tmp_path / "seq"), n_frames=3, n_landmarks=500,
                           width=160, height=120, focal=130.0, seed=3)
    native.reset_counts()
    reader = tdataset.create_reader("euroc://" + paths["root"])
    n_img = 0
    while (kind := reader.next()) != tdataset.DataType.END:
        if kind == tdataset.DataType.CAMERA:
            reader.read_image()
            n_img += 1
        elif kind == tdataset.DataType.GYROSCOPE:
            reader.read_gyroscope()
        else:
            reader.read_accelerometer()
    assert n_img == 3 and native.CALLS["png_load_gray"] == 3
