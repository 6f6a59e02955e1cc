"""Dataset readers (port of `xrslam_tpu/io/dataset.py`, numpy only):
EuRoC / TUM-VI mav0 players with undistort-at-load, an optional
aligned depth stream and an async prefetch wrapper.

Timestamps are read in nanoseconds and returned in seconds, the camera
streams shifted by `Config.camera_time_offset`. Images come out as
float32 [0,1] (H,W) arrays, depth images as float32 metres (0 = no
measurement). PNG images decode through the native runtime
(`native.png_load_gray`), other image files and the depth PNGs through
Pillow, as in the JAX package. Undistortion is a precomputed bilinear
remap, applied by the native runtime (`native.remap_bilinear`); the
Pillow decode and the numpy remap stay here as their plain versions.

A reader given a `StageTimes` records `read_image_time`,
`read_depth_time` and `decode_time` (the decode of one file) into it.
"""

from __future__ import annotations

import contextlib
import csv
import enum
import os
import queue
import threading
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from .. import native
from ..config import Config
from ..utils.timing import StageTimes


class DataType(enum.Enum):
    GYROSCOPE = 0
    ACCELEROMETER = 1
    CAMERA = 2
    END = 3
    # aligned depth image, emitted just before the camera frame it
    # accompanies
    DEPTH = 4


# ---------------------------------------------------------------------------
# image loading + undistortion
# ---------------------------------------------------------------------------

def _stage(times: Optional[StageTimes], name: str):
    return times.stage(name) if times is not None else contextlib.nullcontext()


def load_gray_pillow(path: str) -> np.ndarray:
    """Pillow's decode as float32 grayscale in [0,1] (8-bit /255,
    16-bit /65535): other formats than PNG, and the plain version of
    `native.png_load_gray`."""
    with Image.open(path) as im:
        if im.mode not in ("L", "I;16", "I"):
            im = im.convert("L")
        arr = np.asarray(im)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def load_gray(path: str, times: Optional[StageTimes] = None) -> np.ndarray:
    """Load an image as float32 grayscale in [0,1] (8-bit /255, 16-bit
    /65535): PNGs through the native runtime, other formats through
    Pillow."""
    with _stage(times, "decode_time"):
        if path.lower().endswith(".png"):
            return native.png_load_gray(path)
        return load_gray_pillow(path)


def read_depth(path: str, times: Optional[StageTimes] = None) -> np.ndarray:
    """A uint16 millimetre depth PNG as float32 metres (0 = invalid)."""
    with _stage(times, "decode_time"), Image.open(path) as im:
        arr = np.asarray(im)
    return np.asarray(arr, dtype=np.float32) / 1000.0


class UndistortMap:
    """Precomputed radtan (k1,k2,p1,p2) undistortion remap: for each
    undistorted output pixel the distortion model is applied forward to
    find the source pixel in the raw image; sampling is bilinear with
    zero border."""

    def __init__(self, K: np.ndarray, dist: np.ndarray, width: int, height: int):
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        k1, k2, p1, p2 = [float(d) for d in dist[:4]]
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        x = (u - cx) / fx
        y = (v - cy) / fy
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        self.src_u = (fx * xd + cx).astype(np.float32)
        self.src_v = (fy * yd + cy).astype(np.float32)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return native.remap_bilinear(img, self.src_u, self.src_v)

    def remap_plain(self, img: np.ndarray) -> np.ndarray:
        """The numpy version of the native remap."""
        h, w = img.shape
        u0 = np.floor(self.src_u).astype(np.int32)
        v0 = np.floor(self.src_v).astype(np.int32)
        du = self.src_u - u0
        dv = self.src_v - v0

        def tap(vv, uu):
            inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            val = img[np.clip(vv, 0, h - 1), np.clip(uu, 0, w - 1)]
            return np.where(inside, val, 0.0)

        out = ((1 - du) * (1 - dv) * tap(v0, u0)
               + du * (1 - dv) * tap(v0, u0 + 1)
               + (1 - du) * dv * tap(v0 + 1, u0)
               + du * dv * tap(v0 + 1, u0 + 1))
        return out.astype(np.float32)


# ---------------------------------------------------------------------------
# CSV parsing (EuRoC mav0 layout; ns timestamps)
# ---------------------------------------------------------------------------

def _read_camera_csv(path: str):
    """[(t_seconds, filename)] from `timestamp [ns], filename` rows."""
    items = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith("#"):
                continue
            try:
                t = float(row[0]) * 1e-9
            except ValueError:
                continue
            items.append((t, row[1].strip()))
    items.sort(key=lambda it: it[0])
    return items


def _read_imu_csv(path: str):
    """[(t_seconds, w(3,), a(3,))] from
    `timestamp [ns], wx, wy, wz, ax, ay, az` rows."""
    items = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith("#"):
                continue
            try:
                vals = [float(x) for x in row[:7]]
            except ValueError:
                continue
            items.append((vals[0] * 1e-9,
                          np.array(vals[1:4]), np.array(vals[4:7])))
    items.sort(key=lambda it: it[0])
    return items


def load_euroc_groundtruth(seq_path: str):
    """(ts, ps (N,3), qs (N,4)[w,x,y,z]) from
    mav0/state_groundtruth_estimate0/data.csv."""
    path = os.path.join(seq_path, "state_groundtruth_estimate0", "data.csv")
    ts, ps, qs = [], [], []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith("#"):
                continue
            try:
                vals = [float(x) for x in row[:8]]
            except ValueError:
                continue
            ts.append(vals[0] * 1e-9)
            ps.append(vals[1:4])
            qs.append(vals[4:8])  # EuRoC gt order is already w,x,y,z
    return np.asarray(ts), np.asarray(ps), np.asarray(qs)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

class DatasetReader:
    """Pull-based reader: `next()` says which stream has the earliest
    sample; `read_*` pops it."""

    def next(self) -> DataType:
        raise NotImplementedError

    def read_image(self) -> Tuple[float, np.ndarray]:
        raise NotImplementedError

    def read_gyroscope(self) -> Tuple[float, np.ndarray]:
        raise NotImplementedError

    def read_accelerometer(self) -> Tuple[float, np.ndarray]:
        raise NotImplementedError

    def read_depth(self) -> Tuple[float, np.ndarray]:
        raise NotImplementedError

    @property
    def num_images(self) -> int:
        raise NotImplementedError


class _Mav0Reader(DatasetReader):
    """Shared EuRoC/TUM-VI mav0-layout reader: cam0/data.csv +
    imu0/data.csv (+ the optional depth0/data.csv), one time-ordered
    event stream. Each IMU row yields one GYROSCOPE and one
    ACCELEROMETER event at the same timestamp; at equal timestamps a
    depth image comes before its camera frame."""

    def __init__(self, path: str, config: Optional[Config] = None,
                 times: Optional[StageTimes] = None):
        self.path = path
        self.config = config or Config()
        self.times = times
        cam_dir = os.path.join(path, "cam0")
        imu_dir = os.path.join(path, "imu0")
        # path may point at mav0/ or at the sequence root
        if not os.path.isdir(cam_dir) and os.path.isdir(
                os.path.join(path, "mav0")):
            self.path = path = os.path.join(path, "mav0")
            cam_dir = os.path.join(path, "cam0")
            imu_dir = os.path.join(path, "imu0")

        t_off = self.config.camera_time_offset
        self._images = [(t + t_off, os.path.join(cam_dir, "data", fn))
                        for t, fn in _read_camera_csv(
                            os.path.join(cam_dir, "data.csv"))]
        imu = _read_imu_csv(os.path.join(imu_dir, "data.csv"))
        self._gyros = [(t, w) for t, w, _ in imu]
        self._accels = [(t, a) for t, _, a in imu]

        # optional aligned depth stream (mav0/depth0, same csv layout,
        # uint16 millimetre PNGs)
        depth_dir = os.path.join(path, "depth0")
        self._depths = []
        if os.path.isfile(os.path.join(depth_dir, "data.csv")):
            self._depths = [(t + t_off, os.path.join(depth_dir, "data", fn))
                            for t, fn in _read_camera_csv(
                                os.path.join(depth_dir, "data.csv"))]

        # stable sort: depth listed before camera
        events = ([(t, DataType.DEPTH) for t, _ in self._depths]
                  + [(t, DataType.CAMERA) for t, _ in self._images]
                  + [(t, DataType.GYROSCOPE) for t, _ in self._gyros]
                  + [(t, DataType.ACCELEROMETER) for t, _ in self._accels])
        events.sort(key=lambda e: e[0])
        self._events = events
        self._undistort = None
        if self.config.camera_distortion_flag:
            w, h = self.config.camera_resolution
            self._undistort = UndistortMap(
                np.asarray(self.config.camera_intrinsic),
                np.asarray(self.config.camera_distortion), int(w), int(h))
        self._num_images = len(self._images)

    @property
    def num_images(self) -> int:
        return self._num_images

    def next(self) -> DataType:
        return self._events[0][1] if self._events else DataType.END

    def read_image(self):
        with _stage(self.times, "read_image_time"):
            t, fn = self._images.pop(0)
            self._events.pop(0)
            img = load_gray(fn, self.times)
            if self._undistort is not None:
                img = self._undistort(img)
        return t, img

    def read_gyroscope(self):
        self._events.pop(0)
        return self._gyros.pop(0)

    def read_accelerometer(self):
        self._events.pop(0)
        return self._accels.pop(0)

    def read_depth(self):
        """(t, depth (H,W) float32 metres; 0 = invalid)."""
        with _stage(self.times, "read_depth_time"):
            t, fn = self._depths.pop(0)
            self._events.pop(0)
            return t, read_depth(fn, self.times)


class EurocDatasetReader(_Mav0Reader):
    pass


class TumDatasetReader(_Mav0Reader):
    pass


class AsyncDatasetReader(DatasetReader):
    """Background thread decoding images ahead of the consumer."""

    def __init__(self, reader: DatasetReader, depth: int = 8):
        self._inner = reader
        self._num_images = reader.num_images
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._head = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            kind = self._inner.next()
            if kind == DataType.END:
                self._q.put((DataType.END, None))
                return
            if kind == DataType.CAMERA:
                item = self._inner.read_image()
            elif kind == DataType.GYROSCOPE:
                item = self._inner.read_gyroscope()
            elif kind == DataType.DEPTH:
                item = self._inner.read_depth()
            else:
                item = self._inner.read_accelerometer()
            self._q.put((kind, item))

    def _peek(self):
        if self._head is None:
            self._head = self._q.get()
        return self._head

    @property
    def num_images(self) -> int:
        return self._num_images

    def next(self) -> DataType:
        return self._peek()[0]

    def _pop(self, expect: DataType):
        kind, item = self._peek()
        if kind != expect:
            raise RuntimeError(f"expected {expect}, the stream has {kind}")
        self._head = None
        return item

    def read_image(self):
        return self._pop(DataType.CAMERA)

    def read_gyroscope(self):
        return self._pop(DataType.GYROSCOPE)

    def read_accelerometer(self):
        return self._pop(DataType.ACCELEROMETER)

    def read_depth(self):
        return self._pop(DataType.DEPTH)


def create_reader(uri: str, config: Optional[Config] = None,
                  async_: bool = False,
                  times: Optional[StageTimes] = None) -> DatasetReader:
    """`euroc://path` or `tum://path`; a bare path is treated as EuRoC."""
    if uri.startswith("euroc://"):
        reader: DatasetReader = EurocDatasetReader(uri[len("euroc://"):], config, times)
    elif uri.startswith("tum://"):
        reader = TumDatasetReader(uri[len("tum://"):], config, times)
    else:
        reader = EurocDatasetReader(uri, config, times)
    return AsyncDatasetReader(reader) if async_ else reader
