"""Device meshes and the ranks that hold them — port of
``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default process
group, one process a rank, its dims named by ``axes``.  The reference
forces N virtual devices into one process; the port needs N processes:
:func:`run_ranks` starts them, joins them into one process group and
returns what a function returned in each.

:func:`make_mesh` refuses a world whose size is not the mesh's, as
``jax.make_mesh`` refuses too few devices: ``make_production_mesh`` (256
or 512 ranks) raises on any world this repository starts.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["NAMED_MESHES", "make_debug_mesh", "make_group_mesh", "make_mesh",
           "make_production_mesh", "run_ranks"]

#: the reference's named meshes: (shape, axes)
NAMED_MESHES = {"debug": ((2, 2), ("data", "model")),
                "single": ((16, 16), ("data", "model")),
                "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _session_device_type() -> str:
    """The live HALO session's device type; the card without one."""
    from ..core import c2mpi
    session = c2mpi._session
    if session is not None and not session.finalized:
        return session.device.type
    return "cuda"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    dims named ``axes``, ranks laid out row-major; ``device_type`` defaults
    to the live HALO session's.  Raises ``ValueError`` unless the world
    holds exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    need = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"a mesh of {shape} needs {need} ranks in a process "
                         f"group; none is initialised")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a mesh of {shape} needs {need} ranks; the world "
                         f"has {world}")
    return DeviceMesh(device_type or _session_device_type(),
                      torch.arange(world).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 ranks one pod, or 2×16×16 = 512 across two pods."""
    return make_mesh(*NAMED_MESHES["multi" if multi_pod else "single"])


def make_debug_mesh(shape=NAMED_MESHES["debug"][0], axes=NAMED_MESHES["debug"][1]):
    """Small mesh for tests (four ranks by default)."""
    return make_mesh(shape, axes)


def make_group_mesh(members: int, axis: str = "data"):
    """1-D mesh for a C²MPI device group (DESIGN.md §10): ``members``
    ranks along one named axis."""
    if members <= 0:
        raise ValueError(f"members must be positive, got {members}")
    return make_mesh((members,), (axis,))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, world: int, port: int, backend: str,
               timeout: float, device_type: str, results) -> None:
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))


def _failures(results, errors: dict, world: int) -> str:
    """Every rank's error that arrives within a second of the first (the
    first to arrive may be a peer's lost connection, not the cause)."""
    end = time.monotonic() + 1.0
    while time.monotonic() < end:
        try:
            rank, ok, out = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            errors[rank] = out
    return "\n".join(f"rank {r} of {world} failed:\n{errors[r]}"
                     for r in sorted(errors))


def run_ranks(fn: Callable, world: int, *, backend: str, timeout: float,
              args: Sequence[Any] = (), device_type: str = "cuda") -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes joined into one process
    group; returns each rank's result (picklable) in rank order.

    The ranks start by the ``spawn`` method (the caller may hold a CUDA
    context) and call ``init_process_group(backend, ...)`` with ``timeout``
    seconds as its bound; ``backend`` has no default (``gloo`` for the CPU
    and for several ranks on one card, ``nccl`` for one rank a card).  On
    ``device_type="cuda"`` rank r takes card r mod the card count.  ``fn``
    must be importable by name from a new process.  When a rank raises or
    dies, or ``timeout`` runs out before every rank has answered, every
    rank is killed and this raises; no rank outlives the call."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(fn, tuple(args), r, world, port, backend,
                               timeout, device_type, results))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    got: dict = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} did not "
                    f"answer within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.2))
            except queue.Empty:
                dead = [p.name for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a rank's last answer may still be in the pipe
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(f"{dead} exited without an answer "
                                           f"(exit codes {[p.exitcode for p in procs]})"
                                           ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(_failures(results, {rank: out}, world))
            got[rank] = out
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
    return [got[r] for r in range(world)]
