"""Digests of every call of the port's math functions in a CPU run, for
finding the first step at which two hosts (or two builds) part. A
debugging aid beside `test_torch_parsac_golden.py`, run from the root
of the repo:

    # on each host, the PARSAC-off drive of tests/test_torch_parsac_golden.py
    # (its first N calls with --calls N):
    PYTHONPATH=. python tests/torch_call_trace.py --out A.npz [--calls N]
    # then, with both files on one machine:
    PYTHONPATH=. python tests/torch_call_trace.py --compare A.npz B.npz

Every return of a module-level function of CALL_MODULES, and of the
torch library calls of LIBRARY_CALLS, is recorded in return order with
a 64-bit digest of its arguments (taken before the call) and of its
result, and the innermost frame of the port that made the call, with
the number of records when each camera frame ended. A traced drive also
prints the largest |Δ| of its outputs from
`tests/data/torch_parsac_off_drive.npz`, as the golden test reads them.
Tensors inside torch.func transforms count by shape only. The
comparison prints the first record whose result differs and whether
its arguments agreed: with equal arguments, that function (innermost
first) computed another result on the other host; with unequal
arguments, the difference came in through code that is not wrapped.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import inspect
import os
import sys

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

import xrslam_tpu_torch

_PKG = os.path.dirname(os.path.abspath(xrslam_tpu_torch.__file__))

# the modules whose module-level functions `CallDigests` wraps
CALL_MODULES = ("geometry.lie", "geometry.essential", "geometry.homography",
                "geometry.wahba", "geometry.triangulate", "geometry.camera",
                "ransac.core", "ransac.stereo", "ransac.parsac", "ransac.pnp",
                "frontend.image", "frontend.klt", "imu.preintegration",
                "estimation.factors", "estimation.gram", "estimation.solver",
                "estimation.marginalization", "estimation.triangulate",
                "estimation.window", "core.nputil")
# the torch library calls `CallDigests` wraps too ((namespace, name)):
# those whose CPU kernels come from MKL or LAPACK (the `@` operator
# cannot be wrapped)
LIBRARY_CALLS = (("torch", "einsum"), ("torch", "matmul"), ("torch", "cholesky_solve"),
                 ("torch.linalg", "det"), ("torch.linalg", "solve"),
                 ("torch.linalg", "solve_ex"), ("torch.linalg", "inv_ex"),
                 ("torch.linalg", "eigh"), ("torch.linalg", "cholesky_ex"),
                 ("torch.linalg", "svd"), ("torch.linalg", "norm"))
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_parsac_off_drive.npz")


def _bytes(x: torch.Tensor) -> bytes:
    """The tensor's data, or b"" for one that has none to read (meta,
    zero tensors, tensors inside torch.func transforms)."""
    if x.is_meta or x._is_zerotensor() or not x.numel():
        return b""
    try:
        return np.ascontiguousarray(x.detach().resolve_neg().numpy()).tobytes()
    except RuntimeError:
        return b""


def _digest(tree) -> int:
    h = hashlib.blake2b(digest_size=8)
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            h.update(str((tuple(x.shape), x.dtype)).encode())
            h.update(_bytes(x))
        elif isinstance(x, np.ndarray):
            h.update(str((x.shape, x.dtype)).encode() + np.ascontiguousarray(x).tobytes())
        elif isinstance(x, (bool, int, float, str, type(None), torch.dtype, torch.device)):
            h.update(repr(x).encode())
        else:  # an object: its repr may hold its address
            h.update(type(x).__qualname__.encode())
    return int.from_bytes(h.digest(), "little", signed=True)


def _caller() -> str:
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.endswith("torch_call_trace.py"):
            return f"{os.path.relpath(path, os.path.dirname(_PKG))}:{f.f_lineno}"
        f = f.f_back
    return "?"


class Enough(Exception):
    """Raised by CallDigests at its limit."""


class CallDigests:
    """Records (function, argument digest, result digest, caller) of every
    return of the module-level functions of CALL_MODULES while active,
    up to `limit` records."""

    def __init__(self, limit=None):
        self.limit = limit
        self.names, self.ins, self.outs, self.where, self.frames = [], [], [], [], []
        self._undo = []

    def _wrap(self, label, fn):
        def wrapped(*args, **kwargs):
            d_in = _digest((args, kwargs))
            out = fn(*args, **kwargs)
            if self.limit is not None and len(self.names) >= self.limit:
                raise Enough
            self.names.append(label)
            self.ins.append(d_in)
            self.outs.append(_digest(out))
            self.where.append(_caller())
            return out
        return wrapped

    def __enter__(self):
        for m in CALL_MODULES:
            mod = importlib.import_module(f"xrslam_tpu_torch.{m}")
            for name, fn in list(vars(mod).items()):
                if inspect.isfunction(fn) and fn.__module__ == mod.__name__:
                    self._undo.append((mod, name, fn))
                    setattr(mod, name, self._wrap(f"{mod.__name__}.{name}", fn))
        for ns, name in LIBRARY_CALLS:
            mod = importlib.import_module(ns)
            fn = getattr(mod, name)
            self._undo.append((mod, name, fn))
            setattr(mod, name, self._wrap(f"{ns}.{name}", fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo.clear()

    def save(self, path: str) -> None:
        np.savez_compressed(path, names=np.array(self.names), ins=np.array(self.ins),
                            outs=np.array(self.outs), where=np.array(self.where),
                            frames=np.array(self.frames))


def golden_drive(trace: CallDigests) -> int:
    """The PARSAC-off 40-frame drive of tests/test_torch_parsac_golden.py
    on 2 intra-op threads, traced (the scene is rendered before the
    trace starts); prints its outputs' largest |Δ| from the golden file
    and returns the number of tracked frames, or -1 when the trace's
    limit ended the drive."""
    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.tools.make_dataset import render_sequence, run_sequence

    torch.set_num_threads(2)
    seq = render_sequence(n_frames=40)
    slam = api.XRSLAM(config=seq["config"].replace(parsac_flag=False), device="cpu")
    try:
        with trace:
            ts, ps = run_sequence(api, slam, seq, max_frames=40,
                                 on_frame=lambda i, s: trace.frames.append(len(trace.names)))
    except Enough:
        return -1
    f = slam.pipeline.swt.last_frame_chain()
    out = {"ts": ts, "ps": ps, "q": f.q, "p": f.p, "v": f.v, "bg": f.bg, "ba": f.ba}
    ref = np.load(GOLDEN)
    if len(ts) != len(ref["ts"]):
        print(f"call_trace: {len(ts)} tracked frames, the golden file {len(ref['ts'])}")
    else:
        print("call_trace: largest |Δ| from the golden file: " + ", ".join(
            f"{k} {float(np.abs(np.asarray(out[k]) - ref[k]).max()):.3e}" for k in ref.files))
    return len(ts)


def compare(a_path: str, b_path: str) -> str:
    """A line on the first record whose result differs between two
    traces (or on where the record sequences part)."""
    a, b = np.load(a_path), np.load(b_path)
    n = min(len(a["names"]), len(b["names"]))
    same_name = a["names"][:n] == b["names"][:n]
    diff = ~same_name | (a["outs"][:n] != b["outs"][:n])
    if not diff.any():
        return (f"call_trace: the first {n} records agree "
                f"({len(a['names'])} and {len(b['names'])} recorded)")
    i = int(np.argmax(diff))
    if not same_name[i]:
        return (f"call_trace: the record sequences part at #{i}: {a['names'][i]} at "
                f"{a['where'][i]} and {b['names'][i]} at {b['where'][i]}")
    args = "equal" if a["ins"][i] == b["ins"][i] else "unequal"
    frame = int(np.searchsorted(a["frames"], i, side="right"))
    return (f"call_trace: first differing result at record #{i} of {n} (camera frame "
            f"{frame}): {a['names'][i]} at {a['where'][i]}, arguments {args}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--out", help="trace the golden drive into this .npz")
    g.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--calls", type=int, help="stop after this many records")
    args = ap.parse_args(argv)
    if args.compare:
        print(compare(*args.compare))
        return 0
    trace = CallDigests(args.calls)
    tracked = golden_drive(trace)
    trace.save(args.out)
    print(f"call_trace: {len(trace.names)} records over {len(trace.frames)} camera frames"
          + ("" if tracked < 0 else f", {tracked} tracked") + f" -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
