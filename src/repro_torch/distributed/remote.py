"""Multi-process C²MPI: remote virtualization agents over a socket
transport (DESIGN.md §13) — port of ``repro.distributed.remote``.

Everything else in the port is single-process multi-substrate; this module
extends the agent pool across OS processes while keeping the host program
unchanged.  Three pieces:

* :func:`spawn_worker` / :class:`WorkerRuntime` — launch a worker process
  (``python -m repro_torch.launch.worker``) that builds its **own** runtime
  session (registry + agents + scheduler from the inherited ``HALO_*`` env)
  on its device — the card unless the caller passes the CPU — and serves
  requests over a length-prefixed frame protocol on a loopback socket.  A
  worker on the card opens its own CUDA context, builds (or loads) the
  kernel library *before* its hello, and raises at start, never falling
  back to the CPU, where no card of capability 9.0 is present.
* :class:`WorkerClient` — the host-side transport: a writer lock plus one
  reader thread that resolves per-request :class:`~repro_torch.core.agents
  .HaloFuture`\\ s as result frames stream back (results arrive as
  done-callbacks, never by blocking the transport).
* :class:`RemoteAgent` — a :class:`~repro_torch.core.agents.
  VirtualizationAgent` proxy for one substrate of one worker.  On
  :meth:`RemoteAgent.attach` it republishes the host's records of that
  substrate under its remote platform id (``"hopper@w0"``) via
  :func:`~repro_torch.core.registry.clone_record`, so the *existing*
  selection, scheduling, collective-pinning and failover machinery treats
  the worker as just another member substrate: ``comm_split(["hopper",
  "hopper@w0"])`` mixes in-process and remote members with no new verbs.

Failure semantics (DESIGN.md §11/§13): a dead worker process surfaces both
promptly (transport EOF -> ``handle_dead_agent``) and via the heartbeat
path (a busy RemoteAgent whose transport died reports an infinitely stale
heartbeat, so a :class:`~repro_torch.core.agents.HealthMonitor` sweep
classifies it DEAD), and flows into the normal mark-dead -> comm-repair ->
replay ladder.  The agent's cloned records are deregistered inside
:meth:`RemoteAgent.mark_dead`, so replayed work re-places onto survivors.
:class:`RemoteWorkerError` is an :class:`~repro_torch.core.agents.
AgentDeadError`: a lost transport is a dead member, not a failing kernel.
On card tensors the card rule (a hopper record's error surfaces at once)
lets its request re-place, but onto hopper records only (the local row,
another worker's clone), and raises when none is left; an error *raised*
by a worker's kernel (:class:`RemoteExecutionError`) falls under the card
rule like a local one.

Where the port differs from the reference:

* **dtypes.** A tensor ships as its raw bytes under numpy's dtype name
  ("float32", "bfloat16", …); bfloat16 needs no ``ml_dtypes``: its bytes
  are a 2-byte view, rebuilt by ``torch.frombuffer(...).view(dtype)``.  For
  a tree of numpy arrays the frame is byte-identical to the reference's.
* **No torch tensor is immutable.**  The reference caches only
  ``jax.Array``\\ s and memoizes their digests by identity.  Here any
  tensor is eligible.  A CPU tensor is hashed on every send: it may share
  its memory with a numpy array (``torch.from_numpy``, ``Tensor.numpy()``,
  the port's own ``compute_object.from_numpy``), whose writes torch does
  not count.  A CUDA tensor's digest is memoized, valid only while its
  version counter (``_version``, shared by every view of its storage and
  bumped by every in-place op), data pointer, shape and stride are
  unchanged, so an in-place write re-hashes and ships the new bytes; the
  memo is what keeps a cached solve from hashing its operands every
  sweep.  Two writes to a CUDA tensor leave the memo stale: one through
  ``.data`` (which has a version counter of its own), and one by a kernel
  through a raw pointer into a tensor it was *given*.  The port makes
  neither: it writes nothing through ``.data``, and its kernels write
  only the outputs their wrappers allocate.  Inference tensors have no
  version counter and ship raw; numpy arrays always ship raw.
* **CUDA operands go through host memory.**  Before an operand's bytes are
  read the device is synchronized (its producing launch may sit on another
  agent's stream), and a decoded result lands on the host session's device.
  A worker decodes onto its own device; its pinned buffers stay there.
* **No ``devices``.**  The reference's ``devices`` (``--devices``,
  ``HALO_WORKER_DEVICES``) is XLA's host-device fan-out, which has no
  torch counterpart: a worker runs one session on one device.
* **Two knobs are constants.**  The wire cache is always on, and
  :data:`WIRE_CACHE_MIN` is the smallest tensor it pins; only its cap,
  ``HALO_WIRE_CACHE_MB``, stays a knob.

What is NOT shipped across the wire: callables (records are mirrored by
alias/platform/priority/version, never by function), ``BufferHandle``
tables (stateful-CR state ships **by value** per request), graph nodes
(payloads are materialized before send), and scheduler objects (workers
build their own from the inherited env; quarantine keys are the only
scheduler state that crosses, see :meth:`~repro_torch.core.scheduler.
CostModelScheduler.mark_failed_key`).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.agents import (AgentDeadError, HaloFuture, VirtualizationAgent,
                           _card_device)
from ..core.config import halo_config
from ..core.registry import KernelRecord, clone_record

log = logging.getLogger("repro_torch.halo.remote")

__all__ = [
    "RemoteAgent",
    "RemoteExecutionError",
    "RemoteWorker",
    "RemoteWorkerError",
    "WorkerClient",
    "WorkerRuntime",
    "connect_and_serve",
    "decode_payload",
    "encode_payload",
    "recv_frame",
    "send_frame",
    "spawn_worker",
]


class RemoteWorkerError(AgentDeadError):
    """Transport-layer failure: the worker process died or the socket
    closed with requests still pending."""


class RemoteExecutionError(RuntimeError):
    """A kernel execution failed inside the worker process.  Carries the
    worker-side exception type and message (the traceback object itself
    never crosses the wire)."""


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------
# A frame is ``[u64 total_len][u32 header_len][header JSON][buf 0][buf 1]…``
# (big-endian).  The header is the message tree with every array leaf
# replaced by an ``{"__a__": index, "s": shape, "d": dtype}`` marker; the
# raw bytes (C order) follow the header in marker order.  Tensors and numpy
# arrays round-trip dtype-exactly, bfloat16 included.
#
# Host -> worker frames may additionally use the content-addressed buffer
# cache: a large tensor (at least :data:`WIRE_CACHE_MIN` bytes) ships once
# as ``{"__a__": …, "put": digest}`` — the worker pins the decoded tensor,
# on its device, under the digest (of its bytes, dtype and shape) — and
# every later occurrence of the same tensor travels as a bufferless ``{"__aref__": digest, "s": shape, "d":
# dtype}`` marker.  Misses are impossible by construction: the host stops
# promising new digests once ``HALO_WIRE_CACHE_MB`` worth are pinned
# (further tensors ship raw), and the worker never evicts a pinned buffer,
# so no miss/retry round trip exists in the protocol.  A pinned tensor is
# shared by every request that names it: records never write their inputs.

_MAX_FRAME = 1 << 33            # 8 GiB sanity bound on a single frame
#: smallest tensor (bytes) the wire cache pins
WIRE_CACHE_MIN = 4096

#: numpy dtype name <-> torch dtype, for every type a tensor ships as
_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NUMPY_NAMES: Dict[torch.dtype, str] = {v: k for k, v in _TORCH_DTYPES.items()}


def _resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype a marker's numpy dtype name decodes to."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"dtype {name!r} does not cross the worker "
                        f"transport") from None


def _host_bytes(t: torch.Tensor) -> memoryview:
    """``t``'s elements in C order as one flat byte view in host memory.
    A CUDA tensor is copied to the host; its device must already be
    synchronized (:func:`_sync_devices`)."""
    t = t.detach().resolve_conj().resolve_neg()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _sync_devices(tree: Any) -> None:
    """Wait for every launch on each CUDA device that holds a tensor of
    ``tree``: an operand's producing launch may sit on any agent's stream,
    and its bytes are read on the host next."""
    seen = set()
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda" \
                and leaf.device not in seen:
            seen.add(leaf.device)
            torch.cuda.synchronize(leaf.device)


def _to_device(tree: Any, device: Optional[torch.device]) -> Any:
    """``tree`` with every tensor moved to ``device`` (None leaves it)."""
    if device is None or device.type == "cpu":
        return tree
    return pytree.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def _stamp(t: torch.Tensor) -> Optional[Tuple]:
    """What a memoized digest of ``t`` stays valid under, or None for a
    tensor without a version counter (an inference tensor)."""
    try:
        version = t._version
    except RuntimeError:
        return None
    return version, t.data_ptr(), tuple(t.shape), t.stride()


_digest_lock = threading.Lock()
#: id(tensor) -> (weakref, stamp, digest) — valid only while the weakref
#: still resolves to the *same* object (guards against id() reuse after
#: gc) and the stamp (version counter, data pointer, shape) is unchanged
_digest_memo: Dict[int, Tuple[Any, Tuple, str]] = {}


def _digest(t: torch.Tensor, data: memoryview) -> str:
    """Cache key of ``t``: the reference's content digest of its bytes,
    then its dtype and shape — equal bytes under another dtype or shape
    (zeros of one size, say) are another operand and pin on their own."""
    return "{}:{}:{}".format(
        hashlib.blake2b(data, digest_size=16).hexdigest(),
        _NUMPY_NAMES[t.dtype], "x".join(map(str, t.shape)))


def _digest_of(t: torch.Tensor, stamp: Tuple,
               data: Callable[[], memoryview]) -> str:
    """:func:`_digest` of a CUDA tensor, memoized by object identity and
    ``stamp`` so a matrix reused across thousands of dispatches is hashed
    once, and re-hashed after an in-place write."""
    key = id(t)
    with _digest_lock:
        ent = _digest_memo.get(key)
        if ent is not None and ent[0]() is t and ent[1] == stamp:
            return ent[2]
    digest = _digest(t, data())
    with _digest_lock:
        if len(_digest_memo) > 4096:        # prune dead weakrefs, bounded
            for k in [k for k, e in _digest_memo.items() if e[0]() is None]:
                del _digest_memo[k]
        _digest_memo[key] = (weakref.ref(t), stamp, digest)
    return digest


class _WireCache:
    """Host-side ledger of buffers pinned inside one worker.

    Only tensors of at least :data:`WIRE_CACHE_MIN` bytes are eligible
    (numpy arrays ship raw); the ledger stops promising new digests once
    ``cap_bytes`` (``HALO_WIRE_CACHE_MB``, read when the worker is
    spawned) are pinned worker-side, so the worker's pin store is bounded by the same
    cap and can never miss.  A tensor larger than the whole cap can never
    have been pinned, so it ships raw without being hashed (hashing runs
    at about a GB/s on the host: a 1.2 GB parameter vector would pay it on
    every new version).  A CPU tensor is hashed on every send, since a
    numpy array may share its memory and write it uncounted; a CUDA
    tensor's digest is memoized under its version counter, which a write
    through ``.data`` or through a raw pointer a kernel was given does not
    bump (the port makes neither).  ``offer`` runs under the client's write lock
    (one frame encodes at a time); ``commit``/``rollback`` settle a frame's
    new digests after the send succeeds or fails."""

    def __init__(self) -> None:
        self.cap_bytes = halo_config().wire_cache_mb * (1 << 20)
        self.known: set = set()
        self.pinned_bytes = 0
        self.bytes_sent = 0                 # every frame byte written
        self.bytes_saved = 0                # raw bytes elided by __aref__
        self._frame_new: List[Tuple[str, int]] = []

    def offer(self, obj: Any, nbytes: int,
              data: Callable[[], memoryview]) -> Optional[Tuple[str, str]]:
        """('ref'|'put', digest) when the cache applies, else None.
        ``data()`` gives the bytes to hash, on a memo miss only."""
        if nbytes < WIRE_CACHE_MIN or not isinstance(obj, torch.Tensor):
            return None                     # numpy arrays ship raw
        if nbytes > self.cap_bytes:
            return None                     # never pinnable: raw, unhashed
        stamp = _stamp(obj)
        if stamp is None:
            return None
        if obj.device.type == "cpu":        # numpy may alias it: no memo
            digest = _digest(obj, data())
        else:
            digest = _digest_of(obj, stamp, data)
        if digest in self.known:
            self.bytes_saved += nbytes
            return "ref", digest
        new_bytes = self.pinned_bytes + sum(n for _, n in self._frame_new)
        if new_bytes + nbytes > self.cap_bytes:
            return None                     # over cap: raw, never promised
        self._frame_new.append((digest, nbytes))
        return "put", digest

    def commit(self) -> None:
        for digest, nbytes in self._frame_new:
            if digest not in self.known:
                self.known.add(digest)
                self.pinned_bytes += nbytes
        self._frame_new = []

    def rollback(self) -> None:
        self._frame_new = []

    def stats(self) -> Dict[str, int]:
        return {"bytes_sent": self.bytes_sent,
                "bytes_saved": self.bytes_saved,
                "pinned_buffers": len(self.known),
                "pinned_bytes": self.pinned_bytes}


def _enc(obj: Any, bufs: List[Any], cache: Optional[_WireCache] = None) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, BaseException):
        return {"__e__": [type(obj).__name__, str(obj)]}
    if isinstance(obj, tuple):
        return {"__t__": [_enc(v, bufs, cache) for v in obj]}
    if isinstance(obj, list):
        return [_enc(v, bufs, cache) for v in obj]
    if isinstance(obj, dict):
        return {"__d__": [[_enc(k, bufs, cache), _enc(v, bufs, cache)]
                          for k, v in obj.items()]}
    if isinstance(obj, torch.Tensor):
        if obj.dtype not in _NUMPY_NAMES:
            raise TypeError(f"cannot serialize a {obj.dtype} tensor across "
                            f"the worker transport")
        shape, name = list(obj.shape), _NUMPY_NAMES[obj.dtype]
        nbytes = obj.numel() * obj.element_size()
        host: List[memoryview] = []

        def data() -> memoryview:           # read at most once, and lazily:
            if not host:                    # a cache ref needs no bytes
                host.append(_host_bytes(obj))
            return host[0]
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        # numpy arrays and scalars: tobytes() always emits C order, and
        # (unlike ascontiguousarray) np.asarray keeps 0-d scalars 0-d
        arr = np.asarray(obj)
        shape, name, nbytes = list(arr.shape), str(arr.dtype), arr.nbytes
        data = arr.tobytes
    else:
        raise TypeError(
            f"cannot serialize {type(obj).__name__!r} across the worker "
            f"transport (callables, handles and graph nodes never cross the "
            f"wire)")
    offer = cache.offer(obj, nbytes, data) if cache is not None else None
    if offer is not None and offer[0] == "ref":
        return {"__aref__": offer[1], "s": shape, "d": name}
    idx = len(bufs)
    bufs.append(data())
    mark = {"__a__": idx, "s": shape, "d": name}
    if offer is not None:                   # ("put", digest)
        mark["put"] = offer[1]
    return mark


def _tensor_of(buf: Any, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor over ``buf``'s bytes (shared when ``buf`` is a
    bytearray, copied otherwise)."""
    if len(buf) == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    if not isinstance(buf, bytearray):
        buf = bytearray(buf)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
        tuple(shape))


def _dec(obj: Any, bufs: Sequence[Any], store: Optional[Dict[str, torch.Tensor]],
         device: Optional[torch.device]) -> Any:
    if isinstance(obj, list):
        return [_dec(v, bufs, store, device) for v in obj]
    if isinstance(obj, dict):
        if "__a__" in obj:
            t = _tensor_of(bufs[obj["__a__"]], obj["s"],
                           _resolve_dtype(obj["d"]))
            if device is not None and device.type != "cpu":
                t = t.to(device)
            if store is not None and "put" in obj:
                store[obj["put"]] = t       # pinned: shared across requests
            return t
        if "__aref__" in obj:
            if store is None or obj["__aref__"] not in store:
                raise RemoteWorkerError(
                    f"frame references unpinned buffer {obj['__aref__']}")
            return store[obj["__aref__"]]
        if "__t__" in obj:
            return tuple(_dec(v, bufs, store, device) for v in obj["__t__"])
        if "__d__" in obj:
            return {_dec(k, bufs, store, device): _dec(v, bufs, store, device)
                    for k, v in obj["__d__"]}
        if "__e__" in obj:
            return RemoteExecutionError(f"{obj['__e__'][0]}: {obj['__e__'][1]}")
    return obj


def encode_payload(obj: Any,
                   cache: Optional[_WireCache] = None) -> Tuple[Any, List[Any]]:
    """Encode a message tree into (JSON-safe header tree, array buffers).

    Supported leaves: None/bool/int/float/str, exceptions (by type name +
    message), torch tensors and numpy arrays/scalars — shipped as raw bytes
    with shape and dtype preserved bit-exactly, bfloat16 included.  Tuples
    and dicts survive as tuples and dicts.  With a ``cache``, eligible
    tensors the peer already pins are elided into ``__aref__`` digest
    markers (see the wire-format notes above).  A CUDA tensor's bytes are
    read from the card: synchronize its device first."""
    bufs: List[Any] = []
    return _enc(obj, bufs, cache), bufs


def decode_payload(header: Any, bufs: Sequence[Any],
                   store: Optional[Dict[str, torch.Tensor]] = None,
                   device: Optional[torch.device] = None) -> Any:
    """Inverse of :func:`encode_payload`; arrays come back as torch tensors
    (numpy arrays too), on ``device`` (the CPU by default).  ``store`` is
    the receiver's digest -> pinned-tensor dict serving ``put``/``__aref__``
    markers (worker side only)."""
    return _dec(header, bufs, store, device)


def send_frame(sock: socket.socket, msg: Any,
               lock: Optional[threading.Lock] = None,
               cache: Optional[_WireCache] = None) -> None:
    """Serialize ``msg`` (a tree, tensors allowed) and write one frame.
    With a ``cache``, encode + send + digest-commit run as one locked
    critical section so concurrent requests cannot interleave promises.
    The buffers are written one by one, never joined into one copy."""
    if lock is None:
        lock = threading.Lock()
    with lock:
        header, bufs = encode_payload(msg, cache)
        hdr = json.dumps({"m": header, "b": [len(b) for b in bufs]}).encode()
        total = 4 + len(hdr) + sum(len(b) for b in bufs)  # after the u64
        try:
            sock.sendall(struct.pack(">QI", total, len(hdr)) + hdr)
            for b in bufs:
                sock.sendall(b)
        except BaseException:
            if cache is not None:
                cache.rollback()
            raise
        if cache is not None:
            cache.commit()
            cache.bytes_sent += 8 + total


def _read_exact(rfile, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = rfile.readinto(view[got:])
        if not k:
            raise EOFError("worker transport closed")
        got += k
    return buf


def recv_frame(rfile, store: Optional[Dict[str, torch.Tensor]] = None,
               device: Optional[torch.device] = None) -> Any:
    """Read and decode one frame from a ``makefile('rb')`` stream.
    Raises :class:`EOFError` on a closed transport.  ``store`` and
    ``device`` as in :func:`decode_payload`."""
    total, hdr_len = struct.unpack(">QI", _read_exact(rfile, 12))
    if not 4 <= total <= _MAX_FRAME or hdr_len > total:
        raise RemoteWorkerError(f"corrupt frame (len={total})")
    hdr = json.loads(_read_exact(rfile, hdr_len))
    bufs = [_read_exact(rfile, n) for n in hdr["b"]]
    return decode_payload(hdr["m"], bufs, store, device)


# ---------------------------------------------------------------------------
# Host-side transport
# ---------------------------------------------------------------------------
class WorkerClient:
    """Request/response multiplexer over one worker socket.

    Writes are serialized by a lock; one reader thread matches reply frames
    to pending request futures by uid and resolves them — streamed results
    land as :class:`HaloFuture` done-callbacks, so N in-flight requests to
    one worker never block each other on the host side.

    On EOF (worker death) the death callbacks run **first** — so the
    session can mark the agent dead and hand its in-flight items to the
    replay ladder — and only then are pending transport futures failed
    (waking blocked worker threads into an already-dead agent, whose
    ``_fail_item`` discards the transport error instead of racing the
    replayed result)."""

    def __init__(self, sock: socket.socket, name: str = "worker"):
        self.name = name
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self.cache = _WireCache()
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[HaloFuture, Any]] = {}
        self._uid = 0
        self._dead = False
        self._dead_reason = ""
        self._closing = False
        self._death_callbacks: List[Callable[[str], None]] = []
        self._reader = threading.Thread(
            target=self._read_loop, name=f"{name}-reader", daemon=True)
        self._reader.start()

    # -- request side --------------------------------------------------------
    def request(self, op: str, owner: Any = None, **fields: Any) -> HaloFuture:
        """Send one op frame; returns the future its reply will resolve."""
        fut = HaloFuture(alias=op)
        with self._lock:
            if self._dead:
                raise RemoteWorkerError(
                    f"worker {self.name} is gone ({self._dead_reason})")
            self._uid += 1
            uid = self._uid
            self._pending[uid] = (fut, owner)
        try:
            send_frame(self._sock, dict(fields, op=op, uid=uid), self._wlock,
                       cache=self.cache)
        except OSError as exc:
            with self._lock:
                self._pending.pop(uid, None)
            self._on_eof(f"send failed: {exc}")
            raise RemoteWorkerError(str(exc)) from exc
        except BaseException:
            with self._lock:
                self._pending.pop(uid, None)
            raise
        return fut

    def call(self, op: str, owner: Any = None,
             timeout: Optional[float] = None, **fields: Any) -> Dict[str, Any]:
        """Blocking request: returns the reply dict, raising the decoded
        worker-side exception for error replies."""
        reply = self.request(op, owner=owner, **fields).result(timeout=timeout)
        exc = reply.get("exc")
        if exc is not None:
            raise exc if isinstance(exc, BaseException) \
                else RemoteExecutionError(str(exc))
        return reply

    def pending_count(self) -> int:
        """Number of requests awaiting replies (test/diagnostic hook)."""
        with self._lock:
            return len(self._pending)

    def wire_stats(self) -> Dict[str, int]:
        """Transport counters: bytes written, raw bytes elided by the
        buffer cache, and what the worker currently pins."""
        return self.cache.stats()

    # -- reply side ----------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                msg = recv_frame(self._rfile)
                uid = msg.get("uid")
                with self._lock:
                    ent = self._pending.pop(uid, None)
                if ent is not None:
                    ent[0].set_result(msg)
                elif uid is not None:
                    log.debug("reply for unknown uid %s from %s (aborted "
                              "request?)", uid, self.name)
        except (EOFError, OSError, RemoteWorkerError, ValueError) as exc:
            self._on_eof(str(exc) or type(exc).__name__)

    def on_death(self, callback: Callable[[str], None]) -> None:
        """Register ``callback(reason)`` to run once when the transport
        dies unexpectedly (not on a graceful :meth:`close`)."""
        with self._lock:
            self._death_callbacks.append(callback)

    def _on_eof(self, reason: str) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._dead_reason = reason
            callbacks = list(self._death_callbacks) \
                if not self._closing else []
        # death callbacks BEFORE failing pending futures: see class docstring
        for cb in callbacks:
            try:
                cb(reason)
            except Exception:
                log.exception("worker death callback raised")
        self._fail_pending(None, reason)

    def _fail_pending(self, owner: Any, reason: str) -> None:
        with self._lock:
            if owner is None:
                failed = list(self._pending.values())
                self._pending.clear()
            else:
                failed = [ent for ent in self._pending.values()
                          if ent[1] is owner]
                self._pending = {u: ent for u, ent in self._pending.items()
                                 if ent[1] is not owner}
        for fut, _owner in failed:
            fut.set_exception(RemoteWorkerError(
                f"worker {self.name} died with request in flight ({reason})"))

    def abort_for(self, owner: Any, reason: str = "agent shut down") -> None:
        """Fail this owner's pending requests (late replies are dropped by
        the reader) — unblocks an agent's worker thread at shutdown."""
        self._fail_pending(owner, reason)

    @property
    def dead(self) -> bool:
        return self._dead

    def close(self) -> None:
        """Graceful close: no death callbacks, pending requests fail."""
        with self._lock:
            self._closing = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._on_eof("closed")


# ---------------------------------------------------------------------------
# Remote agent proxy
# ---------------------------------------------------------------------------
class RemoteAgent(VirtualizationAgent):
    """Proxy one substrate of a worker process behind the standard agent
    interface.  Inherits the per-agent FIFO worker queue (submissions to
    one remote member serialize in order, members overlap) and the
    heartbeat contract; ``_device_execute`` ships (alias, args, kwargs)
    across the wire instead of calling ``record.fn``.

    The platform id is ``"<substrate>@<worker>"`` (e.g. ``"hopper@w0"``):
    distinct from every local substrate, so device groups pin ranks to it,
    the scheduler keeps per-remote-member estimate tables (host-side EMAs
    include the wire cost — honest end-to-end latency), and quarantine is
    per-member."""

    on_caller_stream = False      # its records run in the worker process

    def __init__(self, worker: "RemoteWorker", substrate: str = "hopper"):
        self.platform = f"{substrate}@{worker.name}"
        super().__init__(name=f"remote-{substrate}-{worker.name}")
        self._worker_handle = worker
        self._substrate = substrate
        self._session = None
        self._clones: List[KernelRecord] = []
        self._applied_quarantine: set = set()
        self._timeout = halo_config().remote_timeout

    # -- session wiring ------------------------------------------------------
    def attach(self, session) -> "RemoteAgent":
        """Join a session: register as an agent and republish its records
        of this substrate under this platform id (fresh uids, never
        failsafe — the torch rows must stay the only failsafe so
        dead-member replays land on a local substrate).  Only the aliases
        the worker's own registry holds (its hello's ``aliases``) are
        republished: a record the host made for itself, such as a fused
        alias a compiled graph registered, has no counterpart there."""
        self._session = session
        served = self._worker_handle.hello.get("aliases")
        for alias in list(session.registry.aliases()):
            if served is not None and alias not in served:
                continue
            for rec in session.registry.records(alias):
                if rec.platform != self._substrate:
                    continue
                clone = clone_record(rec, platform=self.platform,
                                     is_failsafe=False)
                session.registry.register(clone)
                self._clones.append(clone)
        session.attach_agent(self)
        return self

    def _deregister_clones(self) -> None:
        if self._session is None:
            return
        for rec in self._clones:
            try:
                self._session.registry.deregister(rec.alias, rec.platform)
            except Exception:
                log.exception("deregistering clone %s/%s failed",
                              rec.alias, rec.platform)
        self._clones = []

    # -- agent contract ------------------------------------------------------
    def available(self) -> bool:
        return not self._dead and not self._worker_handle.dead

    def heartbeat(self) -> Tuple[int, bool, float]:
        beats, busy, last = super().heartbeat()
        if busy and self._worker_handle.dead:
            # a busy member whose process died can never beat again: report
            # an infinitely stale heartbeat so the next monitor sweep
            # classifies DEAD regardless of the configured timeout
            return beats, True, float("-inf")
        return beats, busy, last

    def _fail_item(self, fut: HaloFuture, exc: BaseException) -> None:
        if self._dead and isinstance(exc, RemoteWorkerError):
            # mark_dead already handed this item to the replay ladder; the
            # transport error waking this thread must not outrace it
            log.debug("dropping transport error on dead agent %s: %s",
                      self.name, exc)
            return
        super()._fail_item(fut, exc)

    def mark_dead(self, reason: str = "declared dead") -> List[tuple]:
        """Dead-member teardown, ordered so the replay ladder sees a
        consistent registry: collect queue items (super), deregister the
        record clones (re-placement falls through to local records / the
        torch fail-safe), then abort in-flight transport calls (their worker
        threads wake into ``_fail_item``'s discard path)."""
        items = super().mark_dead(reason)
        self._deregister_clones()
        self._worker_handle.client.abort_for(self, reason)
        return items

    def shutdown(self, cancel_pending: bool = True, wait: bool = True) -> None:
        self._worker_handle.client.abort_for(self, "agent shutdown")
        super().shutdown(cancel_pending=cancel_pending, wait=wait)

    # -- execution -----------------------------------------------------------
    def _device_execute(self, record: KernelRecord, args: Tuple, kwargs: Dict):
        _sync_devices((args, kwargs))
        reply = self._worker_handle.client.request(
            "exec", owner=self, alias=record.alias, platform=self._substrate,
            priority=record.priority, verid=record.attrs.sw_verid,
            args=list(args), kwargs=kwargs).result(timeout=self._timeout)
        # an error reply's quarantine is mirrored too, before it raises
        self._apply_quarantine(reply.get("quarantined") or ())
        exc = reply.get("exc")
        if exc is not None:
            raise exc if isinstance(exc, BaseException) \
                else RemoteExecutionError(str(exc))
        device = self._session.device if self._session is not None \
            else _card_device((args, kwargs))
        return _to_device(reply.get("result"), device)

    def _apply_quarantine(self, keys: Sequence[str]) -> None:
        """Propagate worker-side quarantine to the host scheduler: a worker
        key ``alias|<substrate>|prio:ver`` maps onto this member's clone key
        ``alias|<substrate>@<worker>|prio:ver`` — so host re-placement stops
        picking a record that only fails inside the worker (DESIGN.md §13)."""
        sess = self._session
        if sess is None or sess.scheduler is None:
            return
        for key in keys:
            if key in self._applied_quarantine:
                continue
            self._applied_quarantine.add(key)
            parts = key.split("|")
            if len(parts) == 3 and parts[1] == self._substrate:
                host_key = f"{parts[0]}|{self.platform}|{parts[2]}"
                log.warning("worker %s quarantined %s; quarantining %s "
                            "host-side", self._worker_handle.name, key,
                            host_key)
                sess.scheduler.mark_failed_key(host_key)


# ---------------------------------------------------------------------------
# Worker process handle
# ---------------------------------------------------------------------------
class RemoteWorker:
    """Host-side handle to one spawned worker process: owns the transport
    client and the process, and vends :class:`RemoteAgent` proxies (one per
    substrate — a single worker can back several remote members)."""

    def __init__(self, proc: Optional[subprocess.Popen],
                 client: WorkerClient, name: str,
                 platforms: Sequence[str], device: str = "cpu",
                 hello: Optional[Dict[str, Any]] = None):
        self.proc = proc
        self.client = client
        self.name = name
        self.platforms = tuple(platforms)
        self.device = device
        #: the worker's hello reply (its launch counts and loaded packages
        #: at start among it)
        self.hello = hello or {}
        self._agents: Dict[str, RemoteAgent] = {}
        client.on_death(self._on_death)

    @property
    def dead(self) -> bool:
        return self.client.dead

    def agent(self, substrate: str = "hopper") -> RemoteAgent:
        """The :class:`RemoteAgent` proxy for one of this worker's
        substrates (cached — one proxy per substrate)."""
        if substrate not in self.platforms:
            raise ValueError(f"worker {self.name} does not serve "
                             f"{substrate!r} (has {self.platforms})")
        if substrate not in self._agents:
            self._agents[substrate] = RemoteAgent(self, substrate)
        return self._agents[substrate]

    def _on_death(self, reason: str) -> None:
        # prompt path (the heartbeat path also works, but needs a monitor
        # sweep): EOF on the transport declares every attached proxy dead
        # and replays its queue through the session ladder
        for agent in list(self._agents.values()):
            sess = agent._session
            if sess is None or agent.dead:
                continue
            if sess.agents.get(agent.platform) is not agent:
                continue
            try:
                sess.handle_dead_agent(
                    agent, reason=f"worker process died ({reason})")
            except Exception:
                log.exception("handle_dead_agent failed for %s", agent.name)

    def heartbeat(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Worker-side liveness snapshot (``ping`` round trip), with the
        worker's own kernel launch counts under ``launches``."""
        return self.client.call("ping", timeout=timeout)

    def chaos(self, **plan: Any) -> None:
        """Install a serialized :class:`~repro_torch.testing.faults.
        FaultPlan` inside the worker (test harness; fields: platform, mode,
        nth, times, delay_s, aliases)."""
        self.client.call("chaos", plan=plan)

    def release(self) -> None:
        """Release worker-side fault injection (unblocks hang modes)."""
        self.client.call("release")

    def kill(self) -> None:
        """Hard-kill the worker process (fault-injection path: the
        transport EOF fires the dead-agent ladder)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful stop: ask the worker to finalize, close the transport
        (no death callbacks), reap the process."""
        try:
            self.client.call("shutdown", timeout=timeout)
        except (RemoteWorkerError, TimeoutError, OSError):
            pass
        self.client.close()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout)


def _src_root() -> str:
    return str(Path(__file__).resolve().parents[2])


def spawn_worker(name: str = "w0",
                 platforms: Sequence[str] = ("hopper", "aten", "torch"),
                 device: str = "cuda",
                 timeout: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None) -> RemoteWorker:
    """Launch ``python -m repro_torch.launch.worker`` and connect it back.

    The child runs on ``device`` (the card unless the caller passes
    ``"cpu"``; a child asked for the card raises without a capability-9.0
    one, and this call then raises :class:`RemoteWorkerError`) and serves
    the given substrates.  The reference's ``devices`` (XLA's host-device
    fan-out) has no torch counterpart and is not taken.  The parent's
    environment is inherited — so ``HALO_AUTOTUNE_CACHE`` gives workers the
    host's warm-start table and ``HALO_TUNING_DB`` its tuned launch plans —
    with transport details overridden by ``env``.
    Blocks until the worker's hello frame (default budget
    ``HALO_WORKER_TIMEOUT``, 120 s: a worker on the card builds or loads
    the kernel library before it answers)."""
    timeout = timeout if timeout is not None \
        else halo_config().worker_timeout
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(0.1)
    port = listener.getsockname()[1]
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in [_src_root(), child_env.get("PYTHONPATH", "")] if p)
    if env:
        child_env.update(env)
    cmd = [sys.executable, "-m", "repro_torch.launch.worker",
           "--connect", f"127.0.0.1:{port}", "--name", name,
           "--platforms", ",".join(platforms), "--device", str(device)]
    proc = subprocess.Popen(cmd, env=child_env)
    deadline = time.monotonic() + timeout
    try:
        while True:                          # accept, or see the child exit
            try:
                conn, _addr = listener.accept()
                break
            except socket.timeout:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise RemoteWorkerError(
                        f"worker {name} did not connect within {timeout}s "
                        f"(exit code {proc.poll()})") from None
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    finally:
        listener.close()
    conn.settimeout(None)
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    client = WorkerClient(conn, name=name)
    try:
        hello = client.request("hello").result(
            timeout=max(0.0, deadline - time.monotonic()))
        if hello.get("exc") is not None:
            raise RemoteWorkerError(f"worker {name} failed to start: "
                                    f"{hello['exc']}")
    except BaseException as exc:
        client.close()
        proc.kill()
        proc.wait()
        if isinstance(exc, RemoteWorkerError):
            raise
        raise RemoteWorkerError(f"worker {name} sent no hello: {exc!r} "
                                f"(exit code {proc.poll()})") from exc
    return RemoteWorker(proc, client, name,
                        platforms=hello.get("platforms", platforms),
                        device=hello.get("device", device), hello=hello)


# ---------------------------------------------------------------------------
# Worker-side runtime
# ---------------------------------------------------------------------------
class WorkerRuntime:
    """The serving loop inside a worker process: makes the process's HALO
    session on ``device`` (``MPIX_Initialize``: the built-in records and a
    fresh :class:`~repro_torch.core.agents.RuntimeAgent`, so scheduler and
    quarantine state is process-local by construction; the session is the
    process-global one, so a record's own dispatches — LM_GRAD's MMM,
    RMSNORM, FLASH_ATTN — run through it) and serves frames until EOF or a
    ``shutdown`` op.  On the card the session raises without a
    capability-9.0 card, and the kernel library is built (or loaded) here,
    before the first frame is read: a cold ``nvcc`` build takes about a
    minute and must not pass for a stall once the host is watching.

    ``exec`` requests resolve the named record (alias + platform +
    priority + version — the host's clone mirrors these), then run through
    ``session._execute_record`` **asynchronously** on the substrate
    agent's own worker queue: the reader thread never blocks on a kernel,
    in-flight requests to one substrate serialize in order (matching the
    host proxy's FIFO), and the full quarantine -> re-place -> fail-safe
    ladder applies worker-side before an error ever crosses the wire.
    Every reply carries the scheduler's current quarantined record keys so
    the host can mirror them (DESIGN.md §13); ``hello`` and ``ping`` carry
    the worker's kernel launch counts (``launches``), the requests each of
    its agents executed (``served``) and each installed fault plan's call
    and failure counts (``chaos``)."""

    def __init__(self, sock: socket.socket, name: str = "w0",
                 platforms: Sequence[str] = ("hopper", "aten", "torch"),
                 device: str = "cuda"):
        from ..core.c2mpi import MPIX_Initialize
        self.session = MPIX_Initialize(device=device)
        if self.session.device.type == "cuda" and "hopper" in self.session.agents:
            from ..kernels import _cuda
            _cuda.lib()
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wlock = threading.Lock()
        self.name = name
        self.platforms = tuple(p for p in platforms
                               if p in self.session.agents)
        self._crs: Dict[str, Any] = {}
        self._chaos: Dict[str, tuple] = {}   # platform -> (faulty, original)
        #: digest -> pinned tensor (on the session's device) serving
        #: ``__aref__`` markers; bounded by the host ledger's
        #: HALO_WIRE_CACHE_MB, never evicted
        self._pins: Dict[str, torch.Tensor] = {}
        self._stop = False

    # -- serving -------------------------------------------------------------
    def serve(self) -> None:
        """Block serving frames until the host disconnects or asks for
        shutdown; finalizes the session on the way out."""
        log.info("worker %s serving %s on %s", self.name, self.platforms,
                 self.session.device)
        try:
            while not self._stop:
                try:
                    msg = recv_frame(self._rfile, store=self._pins,
                                     device=self.session.device)
                except (EOFError, OSError):
                    break
                try:
                    self._handle(msg)
                except Exception as exc:  # noqa: BLE001 — reply, keep serving
                    log.exception("worker %s: %r failed", self.name,
                                  msg.get("op"))
                    self._reply(msg.get("uid"), exc=exc)
        finally:
            self._release_chaos()
            try:
                from ..core.c2mpi import MPIX_Finalize
                MPIX_Finalize()
            except Exception:
                log.exception("worker %s finalize failed", self.name)

    def _reply(self, uid: Optional[int], **fields: Any) -> None:
        if uid is None:
            return
        msg = dict(fields, uid=uid,
                   quarantined=self._quarantined_keys())
        try:
            _sync_devices(msg)
            send_frame(self._sock, msg, self._wlock)
        except (OSError, TypeError) as exc:
            if isinstance(exc, TypeError) and "result" in fields:
                # unserializable result: report instead of dying silently
                self._reply(uid, exc=exc)
            else:
                log.warning("worker %s could not reply to %s: %s",
                            self.name, uid, exc)

    def _quarantined_keys(self) -> List[str]:
        sched = self.session.scheduler
        return sched.failed_record_keys() if sched is not None else []

    # -- ops -----------------------------------------------------------------
    def _handle(self, msg: Dict[str, Any]) -> None:
        op, uid = msg.get("op"), msg.get("uid")
        if op == "exec":
            self._handle_exec(msg)
        elif op in ("hello", "ping"):
            from ..kernels import _cuda
            busy = any(a.heartbeat()[1] for a in self.session.agents.values())
            extra = {}
            if op == "hello":                # which packages the worker runs
                extra["imports"] = sorted({m.split(".")[0]
                                           for m in list(sys.modules)})
            served = {p: a.metrics["requests"]
                      for p, a in self.session.agents.items()}
            chaos = {p: {"calls": fa.calls, "failures": fa.failures}
                     for p, (fa, _orig) in self._chaos.items()}
            self._reply(uid, name=self.name, platforms=list(self.platforms),
                        device=str(self.session.device),
                        busy=busy, pins=len(self._pins),
                        aliases=self.session.registry.aliases(),
                        launches=_cuda.launch_counts(), served=served,
                        chaos=chaos, **extra)
        elif op == "chaos":
            self._install_chaos(msg.get("plan") or {})
            self._reply(uid, ok=True)
        elif op == "release":
            self._release_chaos()
            self._reply(uid, ok=True)
        elif op == "shutdown":
            self._stop = True
            self._reply(uid, ok=True)
        else:
            self._reply(uid, exc=ValueError(f"unknown op {op!r}"))

    def _find_record(self, alias: str, platform: str, priority: Any,
                     verid: Any) -> Optional[KernelRecord]:
        for rec in self.session.registry.records(alias):
            if rec.platform == platform \
                    and (priority is None or rec.priority == priority) \
                    and (verid is None or rec.attrs.sw_verid == verid):
                return rec
        return None

    def _cr_for(self, alias: str, platform: str):
        key = f"{alias}|{platform}"
        cr = self._crs.get(key)
        if cr is None:
            cr = self.session.claim(alias, overrides={
                "allowed_platforms": [platform],
                "platform_preference": [platform]})
            self._crs[key] = cr
        return cr

    def _handle_exec(self, msg: Dict[str, Any]) -> None:
        uid = msg.get("uid")
        alias, platform = msg["alias"], msg.get("platform", "hopper")
        args = tuple(msg.get("args") or ())
        kwargs = msg.get("kwargs") or {}
        agent = self.session.agents.get(platform)
        if agent is None:
            self._reply(uid, exc=ValueError(
                f"worker {self.name} has no {platform!r} agent"))
            return
        rec = self._find_record(alias, platform, msg.get("priority"),
                                msg.get("verid"))
        cr = self._cr_for(alias, platform)
        if rec is None:
            try:
                rec = self.session._select(alias, args, cr.overrides)
            except Exception as exc:  # noqa: BLE001 — report, keep serving
                self._reply(uid, exc=exc)
                return
        fut = HaloFuture(alias=alias)
        sess = self.session

        def _reply_done(f: HaloFuture, uid=uid) -> None:
            try:
                self._reply(uid, result=f.result())
            except BaseException as exc:  # noqa: BLE001 — ship error back
                self._reply(uid, exc=exc)

        fut.add_done_callback(_reply_done)
        try:
            agent.submit(lambda: sess._execute_record(rec, cr, args, kwargs),
                         future=fut)
        except Exception as exc:  # noqa: BLE001 — agent dead/shut down
            fut.set_exception(exc)

    # -- fault injection (test harness) --------------------------------------
    def _install_chaos(self, plan: Dict[str, Any]) -> None:
        from ..testing.faults import FaultPlan, FaultyAgent
        platform = plan.get("platform", "hopper")
        self._release_chaos(platform)
        fp = FaultPlan(
            platform=platform, mode=plan.get("mode", "raise"),
            nth=plan.get("nth", 1), times=plan.get("times"),
            delay_s=plan.get("delay_s", 0.0),
            aliases=tuple(plan["aliases"]) if plan.get("aliases") else None)
        original = self.session.agents.get(platform)
        faulty = FaultyAgent(fp, inner=original, device=self.session.device)
        self.session.attach_agent(faulty)
        self._chaos[platform] = (faulty, original)
        log.warning("worker %s: chaos installed on %s (%s)", self.name,
                    platform, fp.mode)

    def _release_chaos(self, platform: Optional[str] = None) -> None:
        targets = [platform] if platform else list(self._chaos)
        for p in targets:
            ent = self._chaos.pop(p, None)
            if ent is None:
                continue
            faulty, original = ent
            try:
                faulty.release()
            except Exception:
                log.exception("chaos release failed on %s", p)
            if original is not None:
                self.session.attach_agent(original)
        if self.session.scheduler is not None and targets:
            self.session.scheduler.clear_failures()


def connect_and_serve(address: str, name: str, platforms: Sequence[str],
                      device: str = "cuda") -> None:
    """Worker-process entry: dial the host and serve until disconnect
    (used by ``repro_torch.launch.worker``)."""
    host, port = address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    WorkerRuntime(sock, name=name, platforms=platforms,
                  device=device).serve()
