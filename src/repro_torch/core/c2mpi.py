"""C2MPI v1.0 application-interface surface (paper §IV, Tables III–V) —
port of ``repro.core.c2mpi``.

Thin, MPI-flavored functions over a process-global :class:`RuntimeAgent`
session, so host applications read exactly like the paper's template:

    MPIX_Initialize()                 # device="cuda" unless told otherwise
    cr = MPIX_Claim("MMM")
    MPIX_Send((a, b), cr)
    out = MPIX_Recv(cr)
    MPIX_Finalize()

Non-blocking variants return :class:`HaloFuture` request handles
(DESIGN.md §4), mirroring MPI's ``MPI_Isend``/``MPI_Irecv``/``MPI_Wait``.
The graph and collective verbs of the reference are not ported yet.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .agents import ChildRank, HaloFuture, RuntimeAgent
from .compute_object import BufferHandle
from .manifest import Manifest, default_manifest
from .registry import GLOBAL_REGISTRY, KernelRegistry

__all__ = [
    "MPIX_Claim", "MPIX_CreateBuffer", "MPIX_Finalize", "MPIX_Free",
    "MPIX_Initialize", "MPIX_IRecv", "MPIX_ISend", "MPIX_Recv", "MPIX_Send",
    "MPIX_SendFwd", "MPIX_Test", "MPIX_Wait", "MPIX_Waitall",
    "halo_dispatch", "halo_session",
]

_session_lock = threading.RLock()
_session: Optional[RuntimeAgent] = None


# ---------------------------------------------------------------------------
# Session management
# ---------------------------------------------------------------------------
def MPIX_Initialize(manifest: Optional[Manifest] = None,
                    registry: Optional[KernelRegistry] = None,
                    device=None) -> RuntimeAgent:
    """Create the process-global HALO session, finalizing any live one.

    ``device`` is where the session runs: ``None`` means ``"cuda"``, which
    raises unless a card of CUDA capability 9.0 or higher is present (the
    port never demotes to the CPU); pass ``"cpu"`` to run every record's
    plain version on the host.  ``manifest`` is the unified config
    (Table I), ``registry`` the kernel repository (defaults to the global
    one with built-ins registered)."""
    global _session
    from .. import kernels  # ensure built-in kernel records are registered
    kernels.register_all()
    session = RuntimeAgent(registry=registry or GLOBAL_REGISTRY,
                           manifest=manifest or default_manifest(),
                           device="cuda" if device is None else device)
    with _session_lock:
        old, _session = _session, session
    if old is not None and not old.finalized:
        old.finalize()
    return session


def halo_session() -> RuntimeAgent:
    """The live session; auto-initializes with defaults on first touch."""
    with _session_lock:
        if _session is None or _session.finalized:
            return MPIX_Initialize()
        return _session


def MPIX_Finalize() -> None:
    """Tear down the process-global session: free all CRs and internal
    buffers, stop agent workers, persist the latency table."""
    global _session
    with _session_lock:
        if _session is not None:
            _session.finalize()
        _session = None


# ---------------------------------------------------------------------------
# Resource allocation / deallocation (Table IV)
# ---------------------------------------------------------------------------
def MPIX_Claim(func_alias, failsafe_func: Optional[Callable] = None,
               overrides: Optional[Dict[str, Any]] = None) -> ChildRank:
    """Allocate a child rank for ``func_alias`` (str) or a pipeline (list).

    ``failsafe_func`` is the claim-level fallback callable; ``overrides``
    merge over the manifest's per-alias config (MPI_Info style), e.g.
    ``{"allowed_platforms": ["hopper"]}`` pins the CR to the kernels."""
    return halo_session().claim(func_alias, failsafe=failsafe_func,
                                overrides=overrides)


def MPIX_CreateBuffer(child_rank: Optional[ChildRank], shape, dtype,
                      init=None, name: Optional[str] = None) -> BufferHandle:
    """Allocate a framework-managed internal buffer on the session device.

    ``init`` seeds the contents (zeros otherwise); a non-None ``child_rank``
    attaches the buffer as CR state (stateful invocations)."""
    return halo_session().create_buffer(child_rank, shape, dtype,
                                        init=init, name=name)


def MPIX_Free(child_rank: ChildRank) -> None:
    """Deallocate ``child_rank`` and its internal buffers; pending posted
    receives are cancelled."""
    halo_session().free(child_rank)


# ---------------------------------------------------------------------------
# Data movement (Table III / Figure 3)
# ---------------------------------------------------------------------------
def MPIX_Send(payload, child_rank: ChildRank, tag: int = 0, **kwargs) -> None:
    """Blocking invoke: marshal ``payload`` (compute object / tuple) to the
    CR; waits for the launch, result queued FIFO per ``tag``."""
    halo_session().send(payload, child_rank, tag=tag, **kwargs)


def MPIX_Recv(child_rank: ChildRank, tag: int = 0, block: bool = True):
    """Pop the oldest pending result for ``(child_rank, tag)``; ``block``
    controls only the final device sync (the receive itself always waits)."""
    return halo_session().recv(child_rank, tag=tag, block=block)


def MPIX_SendFwd(payload, child_rank: ChildRank, dest: ChildRank,
                 tag: int = 0, **kwargs) -> None:
    """Like :func:`MPIX_Send`, but the result lands in ``dest``'s mailbox
    instead of returning to the source PR (device-resident end to end)."""
    halo_session().send_fwd(payload, child_rank, dest, tag=tag, **kwargs)


# ---------------------------------------------------------------------------
# Non-blocking data movement (DESIGN.md §4)
# ---------------------------------------------------------------------------
def MPIX_ISend(payload, child_rank: ChildRank, tag: int = 0,
               mailbox: bool = True, **kwargs) -> HaloFuture:
    """Non-blocking send: submit and return the request handle immediately.

    The result is also queued FIFO on the CR's mailbox for ``tag``; pass
    ``mailbox=False`` when only the handle will be waited on."""
    return halo_session().isend(payload, child_rank, tag=tag,
                                mailbox=mailbox, **kwargs)


def MPIX_IRecv(child_rank: ChildRank, tag: int = 0) -> HaloFuture:
    """Non-blocking receive: request handle for the oldest pending result.

    May be posted *before* the matching send; the handle completes when a
    result for (cr, tag) lands."""
    return halo_session().irecv(child_rank, tag=tag)


def MPIX_Wait(request: HaloFuture, timeout: Optional[float] = None):
    """Block until the request completes; return its device-ready result
    (the CUDA event recorded after the launch is synchronised).

    Re-raises the execution error if the request failed, and
    :class:`repro_torch.core.agents.HaloCancelledError` if it was cancelled."""
    out = request.result(timeout)
    request.wait_device()
    return out


def MPIX_Waitall(requests: Sequence[HaloFuture],
                 timeout: Optional[float] = None) -> List[Any]:
    """Wait for every request; ``timeout`` is one shared deadline, not
    per-request."""
    deadline = None if timeout is None else time.monotonic() + timeout
    out = []
    for r in requests:
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        out.append(MPIX_Wait(r, left))
    return out


def MPIX_Test(request: HaloFuture) -> Tuple[bool, Optional[Any]]:
    """Non-blocking completion poll: ``(True, result)`` once the request is
    complete on the host and its device work has finished, ``(False, None)``
    while in flight.  Errors surface on completion."""
    if not request.done():
        return False, None
    if request.exception() is None and not request.device_done():
        return False, None
    return True, MPIX_Wait(request)


# ---------------------------------------------------------------------------
# Direct dispatch for hardware-agnostic code
# ---------------------------------------------------------------------------
def halo_dispatch(alias: str, *args, overrides: Optional[Dict] = None, **kwargs):
    """Select a kernel for ``alias`` and call it in the caller's thread.

    Host code names *what* to compute (the alias), never *how* or *where*."""
    return halo_session().dispatch(alias, *args, overrides=overrides, **kwargs)
