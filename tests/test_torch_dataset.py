"""The port's dataset layer held to the JAX package and to Pillow:

- `io.dataset.load_gray` (a PNG through the port's build of the native
  decoder, `native/xr_host.cpp`) gives the JAX package's `load_gray`
  (the same C source) exactly, and `io.dataset.load_gray_pillow` gives
  the JAX package's Pillow path (its native decoder switched off; it
  converts colour to gray in float, Pillow in integers) and Pillow's
  grayscale scaled to [0,1] exactly: Pillow-written 8-bit gray, RGB, RGBA and 16-bit gray
  PNGs, and files whose rows carry each of the five filter types (all
  rows one type, a seeded per-row mix, and runs of several types),
  written by this test's own filter encoder since Pillow chooses its
  filters itself;
- `io.dataset.read_depth` gives the JAX reader's depth (uint16
  millimetres / 1000, float32) exactly;
- `tools.make_dataset.render_dataset` of both packages: the camera and
  depth CSVs and both YAMLs equal as text, the IMU and ground-truth
  CSVs equal in their timestamps and names and within 1e-12 in their
  values (the two scenes agree to a few ulp, tests/test_torch_convert.py),
  cam0 and depth0 pixels equal exactly;
- both readers over one directory give the same event sequence: kinds
  equal, timestamps within 1e-12, images and depth arrays equal;
- `UndistortMap`: the source maps equal, the remap within 1e-5;
- the port's `load_config` against the JAX package's on every pair of
  `configs/*.yaml` files and the rendered pair, every Config field
  equal.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from xrslam_tpu import config as jconfig
from xrslam_tpu.io import dataset as jdataset
from xrslam_tpu.tools.make_dataset import render_dataset as jax_render_dataset
from xrslam_tpu_torch import config as tconfig
from xrslam_tpu_torch.io import dataset as tdataset
from xrslam_tpu_torch.tools.make_dataset import render_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several side
    by side, and torch's OpenMP pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1)).astype(np.float64)
    img = np.kron(base, np.ones((8, 8)))[:h, :w] + rng.normal(0, 8, (h, w))
    return img.clip(0, 255).astype(np.uint8)


def _pillow_gray01(path) -> np.ndarray:
    """Pillow's grayscale of the file, scaled as `load_gray` scales it."""
    im = Image.open(path)
    arr = np.asarray(im if im.mode in ("L", "I;16") else im.convert("L"))
    return arr.astype(np.float32) / (255.0 if arr.dtype == np.uint8 else 65535.0)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered_png(px: np.ndarray, fts, bpp: int, depth: int, ctype: int) -> bytes:
    """A PNG of px (H, W*bpp bytes) with row r filtered by fts[r]."""
    H = px.shape[0]
    cur_rows = px.astype(np.int32)
    prior = np.zeros(px.shape[1], np.int32)
    out = []
    for r in range(H):
        cur = cur_rows[r]
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b = prior
        f = int(fts[r])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(np.concatenate([[f], (cur - pred) & 255]).astype(np.uint8))
        prior = cur
    W = px.shape[1] // bpp
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + _chunk(b"IEND", b""))


def _check_load_gray(monkeypatch, path):
    from xrslam_tpu import native

    out = tdataset.load_gray(str(path))
    ref = jdataset.load_gray(str(path))
    assert out.dtype == ref.dtype == np.float32 and np.array_equal(out, ref)
    monkeypatch.setattr(native, "png_load_gray", lambda p: None)
    out = tdataset.load_gray_pillow(str(path))
    ref = jdataset.load_gray(str(path))
    assert out.dtype == ref.dtype == np.float32 and np.array_equal(out, ref)
    assert np.array_equal(out, _pillow_gray01(path))


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("opts", [{}, {"compress_level": 1}, {"optimize": True}])
def test_load_gray_pillow_files_match_jax(monkeypatch, tmp_path, kind, opts):
    img = _image(96, 128)
    arr = {"L": img, "RGB": np.stack([img, img[::-1], 255 - img], -1),
           "RGBA": np.stack([img, img[::-1], 255 - img, img[:, ::-1]], -1),
           "I;16": img.astype(np.uint16) * 257 + 3}[kind]
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(path, format="PNG", **opts)
    _check_load_gray(monkeypatch, path)


@pytest.mark.parametrize("pattern", ["none", "sub", "up", "average", "paeth",
                                     "mixed", "runs"])
@pytest.mark.parametrize("layout", ["gray8", "rgb8", "gray16"])
def test_load_gray_each_filter_matches_jax(monkeypatch, tmp_path, pattern, layout):
    H = 80
    img = _image(H, 72, seed=1)
    if layout == "gray8":
        px, bpp, depth, ctype = img, 1, 8, 0
    elif layout == "rgb8":
        px = np.stack([img, img[::-1], 255 - img], -1).reshape(H, -1)
        bpp, depth, ctype = 3, 8, 2
    else:
        px = (img.astype(np.uint16) * 251).astype(">u2").view(np.uint8).reshape(H, -1)
        bpp, depth, ctype = 2, 16, 0
    rng = np.random.default_rng(2)
    fts = {"none": np.zeros(H), "sub": np.ones(H), "up": np.full(H, 2),
           "average": np.full(H, 3), "paeth": np.full(H, 4),
           "mixed": rng.integers(0, 5, H),
           "runs": np.repeat([4, 2, 3, 1], [40, 10, 20, 10])}[pattern]
    path = tmp_path / "img.png"
    path.write_bytes(_filtered_png(px, fts, bpp, depth, ctype))
    _check_load_gray(monkeypatch, path)


@pytest.mark.parametrize("scale", [1, 250])
@pytest.mark.parametrize("holes", [False, True])
def test_read_depth_matches_jax_reader(tmp_path, scale, holes):
    mm = _image(40, 52, seed=3).astype(np.uint16) * scale
    if holes:
        mm[::3, ::5] = 0
    path = tmp_path / "depth.png"
    Image.fromarray(mm).save(path)
    out = tdataset.read_depth(str(path))
    # the JAX reader's read_depth (xrslam_tpu/io/dataset.py)
    ref = np.asarray(Image.open(path), dtype=np.float32) / 1000.0
    assert out.dtype == np.float32 and np.array_equal(out, ref)
    assert np.array_equal(out == 0, mm == 0)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    base = tmp_path_factory.mktemp("render")
    kw = dict(n_frames=6, n_landmarks=500, width=320, height=240, focal=260.0,
              seed=3, with_depth=True)
    pj = jax_render_dataset(str(base / "jax"), **kw)
    pt = render_dataset(str(base / "port"), **kw)
    return pj, pt


def _rows(path):
    with open(path) as f:
        return [r.split(",") for r in f.read().splitlines()]


def test_render_dataset_matches_jax(rendered):
    pj, pt = rendered
    jroot, troot = os.path.dirname(pj["root"]), os.path.dirname(pt["root"])
    for rel in ("mav0/cam0/data.csv", "mav0/depth0/data.csv", "slam.yaml",
                "device.yaml"):
        with open(os.path.join(jroot, rel)) as a, open(os.path.join(troot, rel)) as b:
            assert a.read() == b.read(), rel
    for rel in ("mav0/imu0/data.csv", "mav0/state_groundtruth_estimate0/data.csv"):
        ra, rb = _rows(os.path.join(jroot, rel)), _rows(os.path.join(troot, rel))
        assert len(ra) == len(rb) and ra[0] == rb[0]
        assert [r[0] for r in ra] == [r[0] for r in rb]
        va = np.array([[float(x) for x in r[1:]] for r in ra[1:]])
        vb = np.array([[float(x) for x in r[1:]] for r in rb[1:]])
        np.testing.assert_allclose(vb, va, rtol=0, atol=1e-12)
    for stream in ("cam0", "depth0"):
        names = sorted(os.listdir(os.path.join(pj["root"], stream, "data")))
        assert names == sorted(os.listdir(os.path.join(pt["root"], stream, "data")))
        assert len(names) == 6
        for fn in names:
            a = np.asarray(Image.open(os.path.join(pj["root"], stream, "data", fn)))
            b = np.asarray(Image.open(os.path.join(pt["root"], stream, "data", fn)))
            assert a.dtype == b.dtype and np.array_equal(a, b), (stream, fn)
    dep = np.asarray(Image.open(os.path.join(pt["root"], "depth0", "data", names[0])))
    assert dep.dtype == np.uint16 and (dep > 0).mean() > 0.05


def _events(reader):
    out = []
    while (kind := reader.next()).name != "END":
        if kind.name == "CAMERA":
            out.append((kind.name,) + reader.read_image())
        elif kind.name == "DEPTH":
            out.append((kind.name,) + reader.read_depth())
        elif kind.name == "GYROSCOPE":
            out.append((kind.name,) + reader.read_gyroscope())
        else:
            out.append((kind.name,) + reader.read_accelerometer())
    return out


@pytest.mark.parametrize("async_", [False, True])
def test_readers_match_jax(rendered, async_):
    _, pt = rendered
    cfg_t = tconfig.load_config(pt["slam_yaml"], pt["device_yaml"])
    cfg_j = jconfig.load_config(pt["slam_yaml"], pt["device_yaml"])
    ej = _events(jdataset.create_reader("euroc://" + pt["root"], cfg_j, async_=async_))
    et = _events(tdataset.create_reader("euroc://" + pt["root"], cfg_t, async_=async_))
    assert [e[0] for e in ej] == [e[0] for e in et]
    assert sum(e[0] == "DEPTH" for e in et) == sum(e[0] == "CAMERA" for e in et) == 6
    # a depth image comes just before its camera frame
    kinds = [e[0] for e in et]
    assert all(kinds[i + 1] == "CAMERA" for i, k in enumerate(kinds) if k == "DEPTH")
    for a, b in zip(ej, et):
        assert abs(a[1] - b[1]) <= 1e-12
        assert a[2].dtype == b[2].dtype and np.array_equal(a[2], b[2]), a[0]
    gj, gt = jdataset.load_euroc_groundtruth(pt["root"]), tdataset.load_euroc_groundtruth(pt["root"])
    for a, b in zip(gj, gt):
        assert np.array_equal(a, b)


def test_undistort_map_matches_jax():
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
    dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    mj = jdataset.UndistortMap(K, dist, 96, 64)
    mt = tdataset.UndistortMap(K, dist, 96, 64)
    assert np.array_equal(mj.src_u, mt.src_u) and np.array_equal(mj.src_v, mt.src_v)
    img = np.random.default_rng(4).random((64, 96)).astype(np.float32)
    np.testing.assert_allclose(mt(img), mj(img), rtol=0, atol=1e-5)


def _fields_equal(a, b):
    import dataclasses

    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert np.array_equal(np.asarray(va), np.asarray(vb)), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("slam", ["euroc_slam.yaml", "iphone_slam.yaml"])
@pytest.mark.parametrize("sensor", ["euroc_sensor.yaml", "iphone12_sensor.yaml"])
def test_load_config_matches_jax(slam, sensor):
    s, d = (os.path.join(REPO, "configs", x) for x in (slam, sensor))
    _fields_equal(jconfig.load_config(s, d), tconfig.load_config(s, d))


def test_load_config_rendered_pair_matches_jax(rendered):
    _, pt = rendered
    cfg = tconfig.load_config(pt["slam_yaml"], pt["device_yaml"])
    _fields_equal(jconfig.load_config(pt["slam_yaml"], pt["device_yaml"]), cfg)
    from xrslam_tpu_torch.tools.make_dataset import sequence_config

    _fields_equal(sequence_config(320, 240, 260.0), cfg)
