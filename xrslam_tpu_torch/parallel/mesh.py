"""Process groups and the (data, model) mesh of the sharded solve (port
of `xrslam_tpu/parallel/mesh.py`).

The `data` axis splits independent windows over ranks, the `model` axis
splits one window's landmark columns (`parallel/sharded.py`). A rank is
one process of a `torch.distributed` group; the caller starts the
processes and gives the group its address, size and rank
(`initialize_distributed`).

`run_ranks` starts such a group on this host: n spawned processes, one
per rank, each joining the group and running a function; it is how
`tools/run_scaling.py`, `chip_smoke.py` and the tests drive the sharded
solve.

The backend follows a stated rule, never a caught failure (`backend_for`):
NCCL when every rank has a card of its own, gloo when ranks share a card
or run on the CPU. NCCL refuses two ranks on one device; gloo reduces
CUDA tensors (through the host). Ranks that share one card prove the
math across a process boundary with the real kernels; they measure no
multi-card scaling.
"""

from __future__ import annotations

import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# collectives made by `all_reduce_sum` since `reset_counts()`: calls and
# the bytes of the buffers reduced
COLLECTIVES = {"calls": 0, "bytes": 0}
# how long the group's rendezvous and each collective may wait for a rank
RENDEZVOUS_TIMEOUT = timedelta(seconds=300)


def reset_counts() -> None:
    COLLECTIVES.update(calls=0, bytes=0)


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of rank `rank`: cuda:(rank % cards) unless the caller
    asks for the CPU; raises without a card."""
    from ..core.detail import compute_device

    device = compute_device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world_size: int, device="cuda") -> str:
    """"nccl" when each of the world's ranks has a card of its own on
    this host, "gloo" when ranks share a card or run on the CPU."""
    if torch.device(device).type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator: str, num_processes: int, process_id: int,
                           backend: Optional[str] = None, device="cuda") -> str:
    """Join the default process group at tcp://`coordinator` (host:port)
    as rank `process_id` of `num_processes`; the backend is
    `backend_for(num_processes, device)` unless given. A no-op when the
    group exists. A failed rendezvous raises (a "distributed" run that
    silently stayed single-process would sum nothing). Returns the
    group's backend."""
    if not dist.is_initialized():
        dev = rank_device(process_id, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend or backend_for(num_processes, dev.type),
                                init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=RENDEZVOUS_TIMEOUT)
    return dist.get_backend()


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda"):
    """(data, model) DeviceMesh over the group's `n_devices` ranks (all
    of them; a mesh spans the whole group). The default shape puts as
    much as possible on `data` with `model` = 2 when the count allows;
    a single large window wants a model-heavy shape, (1, n)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the whole group: {n} ranks asked, {world} in it")
    if shape is None:
        shape = (n // 2, 2) if (n % 2 == 0 and n >= 4) else (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list:
    """Each tensor summed over `group`'s ranks, in one collective: the
    tensors are packed into one flat buffer (one dtype and device),
    reduced with one all_reduce(SUM) and unpacked. Every rank gets the
    same bits."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += flat.numel() * flat.element_size()
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, device, args, out) -> None:
    """A spawned rank: one intra-op thread, join the group, run
    fn(rank, n, *args), report (rank, ok, result or traceback)."""
    try:
        torch.set_num_threads(1)
        initialize_distributed(f"localhost:{port}", n, rank, device=device)
        out.put((rank, True, fn(rank, n, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, args=(), device="cuda", timeout_s: float = 300.0) -> list:
    """fn(rank, n, *args) on each of n ranks of a new process group on
    this host, one spawned process a rank (one intra-op thread each),
    on `rank_device(rank, device)` over `backend_for(n, device)`. fn
    must be importable (module level) and return
    picklable results. Returns the n results in rank order. Raises if a
    rank fails, dies or has not reported within `timeout_s`; every
    process is joined or killed before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, device, args, out),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    done = False
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(results)} of {n} ranks did not report "
                                   f"within {timeout_s:.0f} s")
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{res}")
            results[rank] = res
        done = True
    finally:
        for p in procs:
            # after a failure the other ranks may wait in a collective
            p.join(timeout=max(1.0, min(30.0, deadline - time.monotonic())) if done else 1.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]
