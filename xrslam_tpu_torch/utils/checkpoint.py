"""Checkpoint/resume of the whole VIO pipeline (port of
`xrslam_tpu/utils/checkpoint.py`).

Serializes everything the online system owns: the tracker and window
maps (frames, tracks, landmarks, tags), the marginalization prior
(sqrt-inv-cov, info vector, linearization point), IMU buffers,
forward-propagation state, the PARSAC bin confidences and the global id
counters.

Format: the JAX package's, unchanged (`FORMAT_VERSION` 1): one .npz with
arrays stored flat under path-like keys plus a JSON manifest
(`__manifest__`) describing the tree; no pickle anywhere, so a
checkpoint is safe to load from untrusted storage, and a file written by
either package loads with the other's `load_tree`. Tensors are saved as
host numpy arrays and come back onto the restored pipeline's device
(`VIOPipeline.device`: the card unless `device="cpu"` is asked for).

What the port adds to the JAX tree, under keys the JAX package ignores:

- the random streams: the port draws from `torch.Generator`s, not a
  `jax.random` key. The window tracker's generator (and the
  initializer's, while the pipeline holds one) is stored as its
  `get_state()` bytes with the generator's device type beside it. A CUDA
  generator's state (seed and offset) and a CPU generator's (the
  mt19937 state) do not convert into each other, so restoring onto the
  other device type raises `ValueError`. A JAX file has no such state:
  the port ignores its `key` and seeds from `config.random`, as a fresh
  pipeline does;
- `bin_conf_2d2d`, the 2D-2D essential PARSAC's bin confidences, which
  the JAX tree leaves out (a JAX file loads with the initial ones, as
  the JAX package restores them);
- the frame counter that decimates the backend
  (`sliding_window_tracker_frequent`), the camera-rate PnP keymap, the
  window tracker's stats, each frame's keypoint depths, and the frames
  still waiting for their IMU samples together with their inputs.

A save first completes the pipeline's deferred work (`VIOPipeline.flush`:
the tracker's frame in flight, the queued backend stages of
`worker_overlap`, the pending write-backs), so that the frame states it
writes are solved; the JAX package lands only the write-backs
(`xrslam_tpu/utils/checkpoint.py:170`), and its overlapped schedules
lose the queued frame. Under `chained_frontend` the flush drops what
the tracker staged for the next frame (its slot update and the first
observations of its new detections, `KLTFeatureTracker.flush`): nothing
of them is saved, and the next frame of either pipeline takes the
standard route. The window tracker's other staged per-frame
values (the PARSAC prediction `_pred_parsac`, the IMU prediction
`_pred_frame`, the solved window `_last_window`) are each set and
consumed inside one frame's `track()` or overwritten by the next frame
before anything reads them.
A staged PARSAC prediction at save time means a save from inside a
frame, which raises.

Limitations, as in the JAX package: the image tracker is not
checkpointed (its pyramids are per-frame caches), so after a resume the
first camera frame re-detects keypoints and tracking continues on the
restored window; the `SyntheticTracker`'s hint -> track map is the
caller's to carry over. `pipeline_tree` draws the next value of each
global id counter, so every id after a save is one higher than in a run
without it: compare runs by time and pose, never by id. A visual
localizer is not saved.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict

import numpy as np
import torch

from ..config import Config
from ..core import map as map_mod
from ..core.detail import VIOPipeline
from ..core.map import FrameRec, PipelineMap, TrackRec
from ..core.sliding_window import SlidingWindowTracker
from ..estimation.window import MargPrior, WindowState

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# generic tree <-> npz
# ---------------------------------------------------------------------------

def _encode(obj: Any, arrays: Dict[str, np.ndarray], path: str):
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, np.bool_)):
        return {"t": "bool", "v": bool(obj)}
    if isinstance(obj, (int, np.integer)):
        return {"t": "int", "v": int(obj)}
    if isinstance(obj, (float, np.floating)):
        return {"t": "float", "v": float(obj)}
    if isinstance(obj, str):
        return {"t": "str", "v": obj}
    if isinstance(obj, (list, tuple)):
        return {"t": "list",
                "items": [_encode(v, arrays, f"{path}/{i}")
                          for i, v in enumerate(obj)]}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        return {"t": "dict",
                "keys": [_encode(k, arrays, f"{path}/k{i}")
                         for i, k in enumerate(keys)],
                "vals": [_encode(obj[k], arrays, f"{path}/v{i}")
                         for i, k in enumerate(keys)]}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    arrays[path] = np.asarray(obj)
    return {"t": "arr", "k": path}


def _decode(node, arrays) -> Any:
    t = node["t"]
    if t == "none":
        return None
    if t in ("bool", "int", "float", "str"):
        return node["v"]
    if t == "list":
        return [_decode(n, arrays) for n in node["items"]]
    if t == "dict":
        return {_decode(k, arrays): _decode(v, arrays)
                for k, v in zip(node["keys"], node["vals"])}
    return arrays[node["k"]]


def save_tree(path: str, tree: Any) -> None:
    """Write `tree` (nested dicts/lists of scalars, strings, None, numpy
    arrays and tensors) to `path` as .npz + JSON manifest."""
    arrays: Dict[str, np.ndarray] = {}
    manifest = _encode(tree, arrays, "r")
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"version": FORMAT_VERSION, "tree": manifest}).encode(),
        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_tree(path: str) -> Any:
    """The tree `save_tree` wrote, arrays as numpy."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
        if manifest["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {manifest['version']} != "
                             f"{FORMAT_VERSION}")
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    return _decode(manifest["tree"], arrays)


# ---------------------------------------------------------------------------
# pipeline <-> tree
# ---------------------------------------------------------------------------

_FRAME_ARRAYS = ["q", "p", "v", "bg", "ba", "q_bc", "p_bc", "q_bi", "p_bi",
                 "K", "sqrt_inv_cov2", "bearings", "track_ids",
                 "imu_t", "imu_w", "imu_a"]
_FRAME_FLAGS = ["keyframe", "no_translation", "fix_pose", "fix_motion"]
# inputs a frame carries until the tracker has processed it
_PENDING_INPUTS = ["_hint", "_image", "_depth_img"]


def _frame_tree(f: FrameRec) -> dict:
    d = {"id": f.id, "t": f.t}
    for k in _FRAME_ARRAYS:
        d[k] = getattr(f, k)
    for k in _FRAME_FLAGS:
        d[k] = getattr(f, k)
    d["subframes"] = [_frame_tree(s) for s in f.subframes]
    d["_pts"] = getattr(f, "_pts", None)
    d["kp_depth"] = f.kp_depth
    return d


def _frame_from(d: dict) -> FrameRec:
    f = FrameRec(id=int(d["id"]), t=float(d["t"]),
                 **{k: np.asarray(d[k]) for k in _FRAME_ARRAYS})
    for k in _FRAME_FLAGS:
        setattr(f, k, bool(d[k]))
    f.subframes = [_frame_from(s) for s in d["subframes"]]
    if d.get("_pts") is not None:
        f._pts = np.asarray(d["_pts"])
    if d.get("kp_depth") is not None:
        f.kp_depth = np.asarray(d["kp_depth"])
    return f


def _track_tree(tr: TrackRec) -> dict:
    return {"id": tr.id, "obs": dict(tr.obs), "p_w": tr.p_w,
            "valid": tr.valid, "triangulated": tr.triangulated,
            "static": tr.static, "outlier": tr.outlier,
            "trash": tr.trash, "life": tr.life}


def _track_from(d: dict) -> TrackRec:
    return TrackRec(
        id=int(d["id"]), obs={int(k): int(v) for k, v in d["obs"].items()},
        p_w=None if d["p_w"] is None else np.asarray(d["p_w"]),
        valid=bool(d["valid"]), triangulated=bool(d["triangulated"]),
        static=bool(d["static"]), outlier=bool(d["outlier"]),
        trash=bool(d["trash"]), life=int(d["life"]))


def _map_tree(m: PipelineMap) -> dict:
    return {"frames": [_frame_tree(f) for f in m.frames],
            "tracks": [_track_tree(t) for t in m.tracks.values()]}


def _map_from(d: dict) -> PipelineMap:
    m = PipelineMap()
    m.frames = [_frame_from(f) for f in d["frames"]]
    m.tracks = {}
    for td in d["tracks"]:
        tr = _track_from(td)
        m.tracks[tr.id] = tr
    return m


def _rng_tree(gen: torch.Generator) -> dict:
    return {"state": gen.get_state().numpy(), "device": gen.device.type}


def _set_rng(gen: torch.Generator, node: dict) -> None:
    """Restore a generator's state; the state of one device type's
    generator means nothing to another's."""
    if node["device"] != gen.device.type:
        raise ValueError(
            f"the checkpoint holds a {node['device']} generator state and the "
            f"pipeline's generator is on {gen.device.type}: a random stream "
            f"does not move between device types; restore on a "
            f"{node['device']} device")
    gen.set_state(torch.as_tensor(np.asarray(node["state"], dtype=np.uint8)))


def pipeline_tree(p: VIOPipeline) -> dict:
    """Everything needed to resume (see the module docstring)."""
    p.flush()
    swt = p.swt
    if swt is not None and swt._pred_parsac is not None:
        raise RuntimeError("a PARSAC prediction is staged: save between frames, "
                           "not from inside one")
    tree = {
        "tracker_map": _map_tree(p.tracker_map),
        "gyro_buf": [[t, w] for t, w in p.gyro_buf],
        "accel_buf": [[t, a] for t, a in p.accel_buf],
        "imu_pending": [[t, w, a] for t, w, a in p.imu_pending],
        "last_imu_t": float(p.last_imu_t) if np.isfinite(p.last_imu_t) else None,
        "prop": p._prop,
        "imu_since_opt": [[t, w, a] for t, w, a in p._imu_since_opt],
        "last_frame_t": p._last_frame_t,
        "last_taken": None if p._last_taken is None else list(p._last_taken),
        "swt": None,
        # the port's own keys
        "frame_count": p._frame_count,
        "frame_pending": [
            {"frame": _frame_tree(f),
             **{k: getattr(f, k, None) for k in _PENDING_INPUTS}}
            for f in p.frame_pending],
        "keymap": dict(p._keymap),
        "pnp_frames": p.pnp_frames,
        "initializer": None if p.initializer is None else {
            "generator": _rng_tree(p.initializer.generator),
            "depth_scale": p.initializer.depth_scale,
            "depth_ratios": p.initializer.depth_ratios},
    }
    if swt is not None:
        marg = None
        if swt.marg is not None:
            marg = {"sqrt_inv_cov": swt.marg.sqrt_inv_cov,
                    "infovec": swt.marg.infovec,
                    "lin": list(swt.marg.lin)}
        tree["swt"] = {
            "map": _map_tree(swt.map),
            "marg": marg,
            "bin_conf": swt.bin_conf,
            "m_th": swt.m_th,
            "bin_conf_2d2d": swt.bin_conf_2d2d,
            "generator": _rng_tree(swt.generator),
            "stats": dict(swt.stats),
        }
    # id counters: store the horizon so resumed ids never collide
    tree["next_frame_id"] = next(map_mod._frame_id_counter)
    tree["next_track_id"] = next(map_mod._track_id_counter)
    return tree


def restore_pipeline(tree: dict, config: Config, tracker, device="cuda",
                     times=None) -> VIOPipeline:
    """A pipeline on `device` (the card unless "cpu" is asked for) in the
    state `tree` describes; `tracker` is the caller's feature tracker and
    `times` an optional `StageTimes` for the pipeline's stages. Reads
    trees of either package."""
    p = VIOPipeline(config, tracker, device=device, times=times)
    dev = p.device

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    p.tracker_map = _map_from(tree["tracker_map"])
    p.gyro_buf = [(float(t), np.asarray(w)) for t, w in tree["gyro_buf"]]
    p.accel_buf = [(float(t), np.asarray(a)) for t, a in tree["accel_buf"]]
    p.imu_pending = [(float(t), np.asarray(w), np.asarray(a))
                     for t, w, a in tree["imu_pending"]]
    p.last_imu_t = (-np.inf if tree["last_imu_t"] is None
                    else float(tree["last_imu_t"]))
    prop = tree["prop"]
    if prop is not None:
        p._prop = {k: (float(v) if k == "t" else np.asarray(v))
                   for k, v in prop.items()}
    p._imu_since_opt = [(float(t), np.asarray(w), np.asarray(a))
                        for t, w, a in tree["imu_since_opt"]]
    p._last_frame_t = (None if tree.get("last_frame_t") is None
                       else float(tree["last_frame_t"]))
    lt = tree.get("last_taken")
    p._last_taken = None if lt is None else (
        float(lt[0]), np.asarray(lt[1]), np.asarray(lt[2]))
    p._frame_count = int(tree.get("frame_count", 0))
    for node in tree.get("frame_pending", []):
        f = _frame_from(node["frame"])
        for k in _PENDING_INPUTS:
            setattr(f, k, node.get(k))
        p.frame_pending.append(f)
    p._keymap = {int(k): np.asarray(v) for k, v in tree.get("keymap", {}).items()}
    p.pnp_frames = int(tree.get("pnp_frames", 0))

    init = tree.get("initializer")
    if init is not None:
        _set_rng(p.initializer.generator, init["generator"])
        p.initializer.depth_scale = init["depth_scale"]
        p.initializer.depth_ratios = int(init["depth_ratios"])

    if tree["swt"] is not None:
        s = tree["swt"]
        swt = SlidingWindowTracker(_map_from(s["map"]), config, dev, times=p.times)
        if s["marg"] is not None:
            m = s["marg"]
            swt.marg = MargPrior(sqrt_inv_cov=tensor(m["sqrt_inv_cov"]),
                                 infovec=tensor(m["infovec"]),
                                 lin=WindowState(*[tensor(x) for x in m["lin"]]))
        swt.bin_conf = tensor(s["bin_conf"])
        if s.get("bin_conf_2d2d") is not None:
            swt.bin_conf_2d2d = tensor(s["bin_conf_2d2d"])
        if s.get("generator") is not None:
            _set_rng(swt.generator, s["generator"])
        swt.m_th = float(s["m_th"])
        swt.stats.update(s.get("stats", {}))
        p.swt = swt
        if init is None:  # a JAX tree: the pipeline holds no initializer
            p.initializer = None

    # fast-forward the global id counters past the checkpoint horizon
    map_mod._frame_id_counter = itertools.count(int(tree["next_frame_id"]))
    map_mod._track_id_counter = itertools.count(int(tree["next_track_id"]))
    return p


def save_pipeline(path: str, p: VIOPipeline) -> None:
    save_tree(path, pipeline_tree(p))


def load_pipeline(path: str, config: Config, tracker, device="cuda",
                  times=None) -> VIOPipeline:
    return restore_pipeline(load_tree(path), config, tracker, device=device,
                            times=times)

