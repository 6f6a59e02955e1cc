"""The landmark-sharded Schur BA over `torch.distributed` (port of
`xrslam_tpu/parallel/sharded.py`).

Each rank of the mesh's `model` axis holds a contiguous block of L/W
landmark columns of a window and the whole frame state. It assembles
the reprojection block of its columns (kernel K2 on its shard on the
card: a shard is a window of L/W columns and the same K frames), the
frame-block H, b and cost and the Schur term Hfl·Hll⁻¹·Hflᵀ are summed
over the axis, every rank solves the small reduced camera system, and
the landmark back-substitution stays on the rank
(`estimation/solver.py`, `group=`). The `data` axis splits a batch of
independent windows.

`LANDMARK_DIMS` is the one table of which fields are landmark-indexed
and along which dimension (the JAX package's `state_pspec` and
`data_pspec`); every other field is replicated.

Entry points:
  shard_window(mesh, state, data)             this rank's columns of one window
  gather_window(mesh, state)                  inv_depth back to all L columns
  solve_window_sharded(mesh, state, data, opts)   one window, on its shard
  solve_batch_sharded(mesh, states, datas, opts)  a whole batch of windows
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..estimation import solver
from ..estimation.window import WindowData, WindowState
from .mesh import DATA_AXIS, MODEL_AXIS

# field path -> the landmark dimension of a single window's field
LANDMARK_DIMS = {
    ("inv_depth",): 0,
    ("bearings",): 1, ("obs_mask",): 1, ("ref_idx",): 0,
    ("landmark_mask",): 0, ("fix_landmark",): 0,
    ("marg", "lin", "inv_depth"): 0,
}


def _map_fields(tree, fn, path=()):
    """fn(path, leaf) over a NamedTuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_fields(v, fn, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    return fn(path, tree)


def _axis(mesh, name: str):
    """(rank along the axis, its size)."""
    return mesh[name].get_local_rank(), mesh[name].size()


def _block(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{parts} shards do not divide {n} {what}")
    return n // parts


def take_block(tree, lead: int, rows, cols: slice):
    """Rows `rows` of the leading batch axis (when lead = 1) and columns
    `cols` (a slice) of every landmark-indexed field of a state or data
    tree, made contiguous."""
    def take(path, x):
        if lead:
            x = x[rows]
        dim = LANDMARK_DIMS.get(path)
        # a prior built without landmark slots holds no landmark columns
        if dim is not None and x.shape[lead + dim] != 0:
            x = x.narrow(lead + dim, cols.start, cols.stop - cols.start)
        return x.contiguous()

    return _map_fields(tree, take)


def _columns(mesh, L: int) -> slice:
    r, W = _axis(mesh, MODEL_AXIS)
    n = _block(L, W, "landmark slots")
    return slice(r * n, (r + 1) * n)


def shard_window(mesh, state: WindowState, data: WindowData):
    """This rank's contiguous block of L/W landmark columns of one
    window, as the JAX package lays out P(MODEL_AXIS); frame fields
    whole. Raises unless W divides L."""
    cols = _columns(mesh, state.inv_depth.shape[-1])
    return take_block(state, 0, None, cols), take_block(data, 0, None, cols)


def gather_window(mesh, state: WindowState) -> WindowState:
    """`state` with its inverse depths (this rank's columns, after a
    leading batch axis if any) gathered over the model axis back to all
    L columns."""
    group = mesh.get_group(MODEL_AXIS)
    parts = [torch.empty_like(state.inv_depth) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, state.inv_depth.contiguous(), group=group)
    return state._replace(inv_depth=torch.cat(parts, dim=-1))


def solve_window_sharded(mesh, state: WindowState, data: WindowData,
                         opts: solver.SolveOptions = solver.SolveOptions()):
    """One window with its landmark columns sharded over the mesh's
    model axis: `state` and `data` are this rank's shard
    (`shard_window`). Returns (state with this rank's inverse depths,
    info); the frame state and info are the same on every rank."""
    return solver.solve_window_core(state, data, opts, group=mesh.get_group(MODEL_AXIS))


def solve_batch_sharded(mesh, states: WindowState, datas: WindowData,
                        opts: solver.SolveOptions = solver.SolveOptions()):
    """A batch of N independent windows (a leading axis on every field,
    the same on every rank): the batch is split over the data axis and
    each window's landmark columns over the model axis, and each rank
    solves its rows on its columns, K2 taking them in one call. Returns
    (states, info) of this rank's rows, inverse depths of its columns.
    Raises unless the data axis divides N and the model axis L."""
    d, D = _axis(mesh, DATA_AXIS)
    n = _block(states.q.shape[0], D, "windows")
    rows = slice(d * n, (d + 1) * n)
    cols = _columns(mesh, states.inv_depth.shape[-1])
    return solver.solve_window_batch(take_block(states, 1, rows, cols),
                                     take_block(datas, 1, rows, cols), opts,
                                     group=mesh.get_group(MODEL_AXIS))
