"""``repro_torch.halo`` — the port's public HALO API (one import).

Everything a host application needs for the ported slice, under the same
short names as ``repro.halo``::

    from repro_torch import halo

    halo.initialize()                      # the H100; device="cpu" for host
    cr = halo.claim("MMM")
    halo.send((a, b), cr)
    c = halo.recv(cr)                      # device-ready
    reqs = [halo.isend((a, b), halo.claim("EWADD"), mailbox=False)]
    outs = halo.waitall(reqs)
    with halo.graph(launch=False) as g:    # capture a DAG (DESIGN.md §8)
        t = halo.isend((a, b), halo.claim("EWMM"))
        u = halo.isend((t, b), halo.claim("EWADD"))
    cg = g.compile()                       # fuse + plan (§12)
    out, = cg.replay()
    comm = halo.comm_split(["hopper", "aten"])   # device group (§10)
    parts = halo.scatter(x, comm)                # collective verbs
    total = halo.allreduce(comm.map("VDP", [(p, p) for p in parts]), comm)
    state, history = halo.train("h2o-danube-1.8b", steps=20, reduced=True)
    state, history = halo.train("h2o-danube-1.8b", steps=20, reduced=True,
                                comm=2)          # data-parallel (§15)
    halo.configure(health_monitor=True)   # typed HALO_* knobs (§11)
    w = halo.spawn_worker("w0")           # a worker process (§13)
    w.agent("hopper").attach(halo.session())
    comm = halo.comm_split(["hopper", "hopper@w0"])
    halo.finalize()

Each name re-exports the object :mod:`repro_torch.core.c2mpi`,
:mod:`repro_torch.core.collective`, :mod:`repro_torch.core.config` or
:mod:`repro_torch.distributed.remote` defines; ``train`` is a thin wrapper
over the Trainer.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from .core.agents import HaloFuture
from .core.c2mpi import (MPIX_Allgather as allgather,
                         MPIX_Allreduce as allreduce, MPIX_Bcast as bcast,
                         MPIX_Claim as claim, MPIX_CommSplit as comm_split,
                         MPIX_CreateBuffer as create_buffer,
                         MPIX_Finalize as finalize, MPIX_Free as free,
                         MPIX_Gather as gather, MPIX_IAllgather as iallgather,
                         MPIX_IAllreduce as iallreduce, MPIX_IBcast as ibcast,
                         MPIX_IGather as igather, MPIX_Initialize as initialize,
                         MPIX_IRecv as irecv, MPIX_IReduce as ireduce,
                         MPIX_IScatter as iscatter, MPIX_ISend as isend,
                         MPIX_Recv as recv, MPIX_Reduce as reduce,
                         MPIX_Scatter as scatter, MPIX_Send as send,
                         MPIX_SendFwd as send_fwd, MPIX_Test as test,
                         MPIX_Wait as wait, MPIX_Waitall as waitall,
                         halo_dispatch as dispatch, halo_session as session)
from .core.collective import HaloComm
from .core.config import HaloConfig, configure
from .core.config import halo_config as config
from .core.fusion import CompiledGraph, compile_graph
from .core.graph import ExecutionGraph
from .core.graph import halo_graph as graph
from .distributed.remote import spawn_worker

__all__ = [
    "initialize", "finalize", "session", "dispatch", "claim", "send",
    "recv", "isend", "irecv", "wait", "waitall", "test", "send_fwd",
    "create_buffer", "free", "HaloFuture",
    # device groups + collective verbs (§10)
    "HaloComm", "comm_split", "bcast", "ibcast", "scatter", "iscatter",
    "gather", "igather", "allgather", "iallgather", "reduce", "ireduce",
    "allreduce", "iallreduce",
    # graph capture / compiled replay (§8, §12)
    "graph", "compile_graph", "ExecutionGraph", "CompiledGraph",
    # configuration (typed env knobs)
    "HaloConfig", "configure", "config",
    # multi-process workers (§13)
    "spawn_worker",
    # training (§15)
    "train",
]


def train(arch: str, *, steps: int = 20, seq_len: int = 128, batch: int = 8,
          comm: Any = None, reduced: bool = False, lr: float = 3e-3,
          microbatches: Optional[int] = None, seed: int = 0,
          log_every: int = 10) -> Tuple[Any, list]:
    """One-call LM training on synthetic data on the session's device:
    single-agent when ``comm`` is None, data-parallel over a device group
    otherwise (``comm`` may be a :class:`HaloComm` or a member count, whose
    group cycles the session's available substrates).  Returns
    ``(TrainState, [(step, loss), ...])`` — DESIGN.md §15."""
    import torch

    from .configs import get_config
    from .data.pipeline import SyntheticLM
    from .models import build_model
    from .train.trainer import TrainHyper, Trainer

    sess = session()
    if isinstance(comm, int):
        subs = sess.comm_split().platforms
        comm = sess.comm_split([subs[i % len(subs)] for i in range(comm)])
    n = comm.size if comm is not None else 1
    m = microbatches or n
    if m % n:
        raise ValueError(f"microbatches ({m}) must be a multiple of the "
                         f"member count ({n})")
    device = sess.device
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    hp = TrainHyper(base_lr=lr, warmup_steps=max(1, steps // 10),
                    total_steps=steps, microbatches=m)
    trainer = Trainer(model=build_model(cfg), hp=hp, comm=comm, arch=arch,
                      arch_reduced=reduced, log_every=log_every)
    pipe = SyntheticLM(cfg, seq_len=seq_len, global_batch=batch, seed=seed)
    state = trainer.init_state(torch.Generator(device=device).manual_seed(seed))
    return trainer.run(state, lambda step: pipe.device_batch(step, device), steps)
