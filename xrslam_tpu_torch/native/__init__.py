"""ctypes bindings to the native host runtime (port of
`xrslam_tpu/native/__init__.py` over the same C++ source,
`native/xr_host.cpp`), and the build of the port's C ABI shim
(`xr_capi.cpp` here, over `native/XRSLAM.h`; `build_capi`).

The host-side hot paths around the device: PNG decode, the
undistortion remap, CSV parsing, gyro/accel fusion and the Poisson
spacing filter. The library is compiled with g++ at first use into
`xrslam_tpu_torch/_build/` (git-ignored), keyed by a hash of the source
and the flags, and written under a temporary name that is renamed into
place, so concurrent processes may race to build it. Nothing is built
into `native/`, and the library committed there is never loaded.

There is no fallback: if the compiler is missing or the build fails,
the first call raises with the compiler's output. The Python versions
(`frontend.tracker._poisson_accept`, `io.dataset.UndistortMap.remap_plain`,
`io.dataset.load_gray_pillow`) stay beside their call sites as the plain
references that the tests hold the library to.

Every binding adds one to `CALLS[name]` when it calls the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..kernels.build import BUILD_DIR, PKG_DIR

REPO_DIR = os.path.dirname(PKG_DIR)
NATIVE_DIR = os.path.join(REPO_DIR, "native")
HOST_SOURCE = os.path.join(NATIVE_DIR, "xr_host.cpp")
CXX = "g++"
# the flags of native/Makefile's libxr_host.so
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-fvisibility=hidden", "-shared"]
HOST_LIBS = ["-lz"]
CAPI_SOURCE = os.path.join(PKG_DIR, "native", "xr_capi.cpp")

BINDINGS = ("png_load_gray", "remap_bilinear", "imu_csv_load", "cam_csv_load",
            "fuse_imu", "poisson_filter")
CALLS: Dict[str, int] = {name: 0 for name in BINDINGS}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}


def reset_counts() -> None:
    for name in BINDINGS:
        CALLS[name] = 0


def compile_shared(stem: str, sources: Sequence[str], flags: List[str],
                   libs: List[str] = ()) -> Dict[str, object]:
    """Compile `sources` with g++ (`CXX`) into `_build/lib<stem>_<hash>.so`
    unless that build exists. Returns {"library", "cached", "seconds",
    "cxx"}; raises RuntimeError with the compiler's output on failure."""
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    h.update(" ".join([CXX, *flags, *libs]).encode())
    out = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return {"library": out, "cached": True, "seconds": 0.0, "cxx": CXX}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    try:
        r = subprocess.run([CXX, *flags, *sources, "-o", tmp, *libs],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{stem}: cannot run the C++ compiler {CXX!r}: {e}") from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{stem}: {CXX} failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return {"library": out, "cached": False, "seconds": time.perf_counter() - t0,
            "cxx": CXX}


def load() -> ctypes.CDLL:
    """Build if needed, load once, declare the argtypes."""
    global _lib, _info
    with _lock:
        if _lib is not None:
            return _lib
        info = compile_shared("xr_host", [HOST_SOURCE], HOST_FLAGS, HOST_LIBS)
        lib = ctypes.CDLL(info["library"])
        c_i, c_d, c_f = ctypes.c_int, ctypes.c_double, ctypes.c_float
        c_u8, c_i64, P = ctypes.c_uint8, ctypes.c_int64, ctypes.POINTER
        lib.xr_png_probe.argtypes = [ctypes.c_char_p, P(c_i), P(c_i)]
        lib.xr_png_probe.restype = c_i
        lib.xr_png_load_gray.argtypes = [ctypes.c_char_p, P(c_f), c_i]
        lib.xr_png_load_gray.restype = c_i
        lib.xr_remap_bilinear.argtypes = [P(c_f), c_i, c_i, P(c_f), P(c_f), P(c_f)]
        lib.xr_remap_bilinear.restype = None
        lib.xr_imu_csv_load.argtypes = [ctypes.c_char_p, P(c_d), P(c_d), P(c_d), c_i]
        lib.xr_imu_csv_load.restype = c_i
        lib.xr_cam_csv_load.argtypes = [ctypes.c_char_p, P(c_d), ctypes.c_char_p,
                                        c_i, c_i]
        lib.xr_cam_csv_load.restype = c_i
        lib.xr_fuse_imu.argtypes = [P(c_d), P(c_d), c_i, P(c_d), P(c_d), c_i,
                                    P(c_d), P(c_d), P(c_d)]
        lib.xr_fuse_imu.restype = c_i
        lib.xr_poisson_filter.argtypes = [P(c_d), P(c_i64), P(c_u8), c_i, c_d,
                                          P(c_u8)]
        lib.xr_poisson_filter.restype = None
        _lib, _info = lib, info
        return lib


def available() -> bool:
    """Whether the library builds and loads here (the bindings raise
    when it does not)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def build_info() -> Dict[str, object]:
    return dict(_info)


def build_capi() -> Dict[str, object]:
    """Compile the port's C ABI shim (`xr_capi.cpp` with `native/XRSLAM.h`,
    Python's headers from `sysconfig`) into
    `_build/libxrslam_torch_capi_<hash>.so`. Loaded with ctypes into a
    running interpreter, the shim reuses it. Where Python is a shared
    library (`Py_ENABLE_SHARED`), the shim also links it, so that a C
    program linked against the shim embeds Python; otherwise
    `links_libpython` is False and such a link fails."""
    cfg = sysconfig.get_config_var
    shared = bool(cfg("Py_ENABLE_SHARED"))
    libs = []
    if shared:
        libdir = cfg("LIBDIR")
        libs = [f"-L{libdir}", f"-lpython{cfg('LDVERSION')}", f"-Wl,-rpath,{libdir}"]
    flags = ["-O3", "-std=c++17", "-fPIC", "-fvisibility=default", "-shared",
             "-I", NATIVE_DIR, "-I", sysconfig.get_paths()["include"]]
    info = compile_shared("xrslam_torch_capi", [CAPI_SOURCE], flags, libs)
    info["links_libpython"] = shared
    return info


def _call(name: str) -> ctypes.CDLL:
    lib = load()
    CALLS[name] += 1
    return lib


def _fp(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# ---------------------------------------------------------------------------


def png_load_gray(path: str) -> np.ndarray:
    """(H,W) float32 grayscale in [0,1] (8-bit /255, 16-bit /65535,
    RGB(A) by the ITU-R 601 weights). Raises on a file the decoder
    does not take (interlaced, palette, bit depths other than 8/16)."""
    lib = _call("png_load_gray")
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.xr_png_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc == 0:
        out = np.empty((h.value, w.value), dtype=np.float32)
        rc = lib.xr_png_load_gray(path.encode(), _fp(out, ctypes.c_float), out.size)
    if rc != 0:
        raise ValueError(f"native PNG decode of {path} failed (code {rc})")
    return out


def remap_bilinear(img: np.ndarray, src_u: np.ndarray,
                   src_v: np.ndarray) -> np.ndarray:
    """Bilinear remap with zero border: out[i] samples img at
    (src_u[i], src_v[i])."""
    lib = _call("remap_bilinear")
    img = np.ascontiguousarray(img, dtype=np.float32)
    su = np.ascontiguousarray(src_u, dtype=np.float32)
    sv = np.ascontiguousarray(src_v, dtype=np.float32)
    out = np.empty_like(su)
    lib.xr_remap_bilinear(_fp(img, ctypes.c_float), img.shape[0], img.shape[1],
                          _fp(su, ctypes.c_float), _fp(sv, ctypes.c_float),
                          _fp(out, ctypes.c_float))
    return out


def imu_csv_load(path: str, cap: int = 1 << 22):
    """(t (n,) seconds, w (n,3), a (n,3)) from an EuRoC imu0 CSV."""
    lib = _call("imu_csv_load")
    t = np.empty((cap,), dtype=np.float64)
    w = np.empty((cap, 3), dtype=np.float64)
    a = np.empty((cap, 3), dtype=np.float64)
    n = lib.xr_imu_csv_load(path.encode(), _fp(t, ctypes.c_double),
                            _fp(w, ctypes.c_double), _fp(a, ctypes.c_double), cap)
    if n < 0:
        raise ValueError(f"native IMU CSV load of {path} failed (code {n})")
    return t[:n].copy(), w[:n].copy(), a[:n].copy()


def cam_csv_load(path: str, cap: int = 1 << 20, name_cap: int = 256):
    """[(t seconds, filename)] from an EuRoC camera CSV."""
    lib = _call("cam_csv_load")
    t = np.empty((cap,), dtype=np.float64)
    names = ctypes.create_string_buffer(cap * name_cap)
    n = lib.xr_cam_csv_load(path.encode(), _fp(t, ctypes.c_double), names,
                            name_cap, cap)
    if n < 0:
        raise ValueError(f"native camera CSV load of {path} failed (code {n})")
    raw = names.raw
    return [(float(t[i]), raw[i * name_cap:(i + 1) * name_cap].split(b"\0", 1)[0]
             .decode()) for i in range(n)]


def fuse_imu(tg: np.ndarray, wg: np.ndarray, ta: np.ndarray, aa: np.ndarray):
    """Gyro samples at the accelerometer times inside the gyro span,
    linearly interpolated: (t, w, a)."""
    lib = _call("fuse_imu")
    tg, wg, ta, aa = (np.ascontiguousarray(x, dtype=np.float64)
                      for x in (tg, wg, ta, aa))
    n_max = len(ta)
    ot = np.empty((n_max,), dtype=np.float64)
    ow = np.empty((n_max, 3), dtype=np.float64)
    oa = np.empty((n_max, 3), dtype=np.float64)
    n = lib.xr_fuse_imu(_fp(tg, ctypes.c_double), _fp(wg, ctypes.c_double), len(tg),
                        _fp(ta, ctypes.c_double), _fp(aa, ctypes.c_double), n_max,
                        _fp(ot, ctypes.c_double), _fp(ow, ctypes.c_double),
                        _fp(oa, ctypes.c_double))
    return ot[:n].copy(), ow[:n].copy(), oa[:n].copy()


def poisson_filter(pts: np.ndarray, order: np.ndarray, keep_ok: np.ndarray,
                   min_dist: float) -> np.ndarray:
    """Greedy spacing filter over pts[order] (the grid filter of
    `frontend.tracker._poisson_accept`). Returns the (n,) bool accept
    mask aligned with pts."""
    lib = _call("poisson_filter")
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    keep = np.ascontiguousarray(keep_ok, dtype=np.uint8)
    accept = np.zeros((len(pts),), dtype=np.uint8)
    lib.xr_poisson_filter(_fp(pts, ctypes.c_double), _fp(order, ctypes.c_int64),
                          _fp(keep, ctypes.c_uint8), len(pts), float(min_dist),
                          _fp(accept, ctypes.c_uint8))
    return accept.astype(bool)
