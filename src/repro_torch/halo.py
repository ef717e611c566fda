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
    halo.finalize()

Each name re-exports the object :mod:`repro_torch.core.c2mpi` defines.
"""
from __future__ import annotations

from .core.agents import HaloFuture
from .core.c2mpi import (MPIX_Claim as claim,
                         MPIX_CreateBuffer as create_buffer,
                         MPIX_Finalize as finalize, MPIX_Free as free,
                         MPIX_Initialize as initialize, MPIX_IRecv as irecv,
                         MPIX_ISend as isend, MPIX_Recv as recv,
                         MPIX_Send as send, MPIX_SendFwd as send_fwd,
                         MPIX_Test as test, MPIX_Wait as wait,
                         MPIX_Waitall as waitall, halo_dispatch as dispatch,
                         halo_session as session)

__all__ = [
    "initialize", "finalize", "session", "dispatch", "claim", "send",
    "recv", "isend", "irecv", "wait", "waitall", "test", "send_fwd",
    "create_buffer", "free", "HaloFuture",
]
