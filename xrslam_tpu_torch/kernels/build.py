"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` (one process per source, started
together) and links them into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded with
`ctypes`. The build runs at first use, into
`xrslam_tpu_torch/_build/` (git-ignored), and is keyed by a hash of the
sources, so an edited kernel is rebuilt and a cached build is reused.

Each kernel has a `Kernel` record holding its C entry points and a
plain-int launch counter that its wrappers increment at every launch
(`count`); a kernel with several entries also keeps a count per entry,
and launches that serve a batch of problems are counted apart too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (every entry returns cudaError_t)
SIGNATURES = {
    "klt_level_launch": [_P] * 11 + [_I, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    "klt_track_launch": [_P] * 14 + [_I] * 14 + [_F] * 5 + [_P],
    "reproj_gram_launch": [_P] * 14 + [_I, _I, _I, _I, _P],
    "reproj_factor_gram_launch": [_P] * 19 + [_I, _I, _I, _I, _I, _P],
}


class Kernel:
    """One hand-written kernel: its source, the Pallas kernel it
    replaces, its C entry points and its launch counts."""

    def __init__(self, name: str, entries, source: str, replaces: str):
        self.name = name
        self.entries = tuple(entries)
        self.source = source
        self.replaces = replaces
        self.reset()

    def fn(self, entry: Optional[str] = None):
        return getattr(load_library(), entry or self.entries[0])

    def count(self, entry: Optional[str] = None, windows: int = 1) -> None:
        """One launch through `entry` (default: the first) serving
        `windows` problems; a launch that serves more than one is also
        counted in `batched` (launches, problems)."""
        self.launches += 1
        self.entry_launches[entry or self.entries[0]] += 1
        if windows > 1:
            self.batched["launches"] += 1
            self.batched["windows"] += windows

    def reset(self) -> None:
        self.launches = 0
        self.entry_launches = {e: 0 for e in self.entries}
        self.batched = {"launches": 0, "windows": 0}


KLT_LEVEL = Kernel("klt_level", ("klt_level_launch", "klt_track_launch"),
                   "xrslam_tpu_torch/csrc/klt_level.cu",
                   "xrslam_tpu/frontend/klt_pallas.py:150")
REPROJ_GRAM = Kernel("reproj_gram",
                     ("reproj_gram_launch", "reproj_factor_gram_launch"),
                     "xrslam_tpu_torch/csrc/reproj_gram.cu",
                     "xrslam_tpu/estimation/gram.py:182")
KERNELS = (KLT_LEVEL, REPROJ_GRAM)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


class _Library:
    """The loaded library plus how it was built."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.info: Dict[str, object] = {}


_LIB = _Library()


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> str:
    """Compile the kernels (if the cached build is stale) and return
    the library path. Sets `build_info()`, which keeps ptxas's
    register/shared-memory report."""
    srcs = _sources()
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libxrslam_kernels_{tag}.so")
    if os.path.exists(out):
        _LIB.info = {"library": out, "cached": True, "seconds": 0.0}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = out + f".tmp{os.getpid()}"
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s, o in zip(cus, objs)]
    logs = [p.communicate()[1] for p in procs]
    try:
        for s, p, log in zip(cus, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(s)} "
                                   f"({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    dt = time.perf_counter() - t0
    os.replace(tmp, out)
    _LIB.info = {"library": out, "cached": False, "seconds": dt,
                 "nvcc": nvcc, "ptxas": "".join(logs)}
    return out


def build_info() -> Dict[str, object]:
    return dict(_LIB.info)


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, declare every entry's argtypes."""
    if _LIB.lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.xr_error_string.argtypes = [ctypes.c_int]
        lib.xr_error_string.restype = ctypes.c_char_p
        _LIB.lib = lib
    return _LIB.lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = load_library().xr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
