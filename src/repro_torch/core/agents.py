"""HALO 1.0 multi-agent system: runtime agent + virtualization agents (§V) —
port of ``repro.core.agents``.

Topology is the paper's star pattern: one :class:`RuntimeAgent` per
application acts as the crossbar between application parent ranks (PRs) and
a set of :class:`VirtualizationAgent` peers, each encapsulating one
execution substrate:

* ``torch``  — plain PyTorch reference implementations (the fail-safe),
* ``aten``   — PyTorch's library calls (cuBLAS and ATen kernels),
* ``hopper`` — the hand-written Hopper kernels (``csrc/*.cu``); on CPU
  tensors their wrappers run the plain version,
* ``sharded`` — records run under a device mesh
  (:class:`ShardedAgent`); available only with a mesh attached.

Agents are in-process modules with one FIFO worker thread each (DESIGN.md
§2).  PyTorch's current stream is per thread, so ``isend`` captures the
caller's current stream and the worker launches on it; a worker's future
completes once the kernel is *launched*, and a CUDA event recorded on that
stream right after the launch lets ``recv``/``wait`` promise a device-ready
result (DESIGN.md §4).

Two dispatch paths exist (DESIGN.md §3): :meth:`RuntimeAgent.dispatch`, a
direct select-and-call, and ``claim/send/recv/send_fwd``, the C2MPI DRPC
surface with child ranks, tagged FIFO mailboxes, stateful internal buffers
and fail-safe re-placement.  Inside a ``halo_graph()`` capture region
(DESIGN.md §8) ``dispatch`` and ``isend`` record graph nodes instead.
:meth:`RuntimeAgent.comm_split` makes device groups over the agents
(``core/collective.py``, DESIGN.md §10).

Liveness (DESIGN.md §11): every agent's worker beats on each claim and
completion; a :class:`HealthMonitor` marks a busy agent whose beats stall
DEGRADED, then DEAD, and the session then re-binds the dead agent's group
ranks and replays its unfinished requests on healthy agents
(:meth:`RuntimeAgent.handle_dead_agent`).  The monitor is off unless a
session asks for it (``health=``, :meth:`RuntimeAgent.enable_health_monitor`
or ``HALO_HEALTH_MONITOR``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from .compute_object import BufferHandle, as_compute_object
from .config import halo_config
from .manifest import Manifest, default_manifest
from .registry import (GLOBAL_REGISTRY, KernelRecord, KernelRegistry,
                       SelectionError)
from .scheduler import CostModelScheduler, abstract_signature

log = logging.getLogger("repro_torch.halo.agents")

# Execution-graph capture state (DESIGN.md §8).  The graph module installs
# the active ExecutionGraph here (thread-local: capture is a host-thread
# construct); isend/dispatch consult it so host code inside a
# ``halo_graph()`` region records DAG nodes instead of executing.
_graph_capture = threading.local()


def _active_graph(session: "RuntimeAgent"):
    g = getattr(_graph_capture, "graph", None)
    return g if g is not None and g.session is session else None

#: the least CUDA capability the hopper substrate runs on (H100 = 9.0)
HOPPER_CAPABILITY = (9, 0)


def require_hopper(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device of capability 9.0 or more.
    The port does not demote to another device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain versions on the host")
    cap = torch.cuda.get_device_capability(device)
    if cap < HOPPER_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has CUDA capability {cap}; "
            f"the hopper kernels need {HOPPER_CAPABILITY} or higher")


def _card_device(tree: Any) -> Optional[torch.device]:
    """The CUDA device of the first tensor in ``tree`` that lies on one."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def _on_hopper(record: Optional[KernelRecord]) -> bool:
    """Whether ``record`` runs a hand-written kernel: the local ``hopper``
    row or a worker's ``hopper@<worker>`` clone."""
    return record is not None \
        and record.platform.partition("@")[0] == "hopper"


def _hopper_error(record: Optional[KernelRecord],
                  exc: BaseException) -> bool:
    """Whether ``exc`` is a hopper record's own failure — in this process,
    or a worker's ``hopper@<worker>`` clone — which the card rule makes
    surface at once, unquarantined, when the request's tensors lie on the
    card.  A clone whose worker was lost (:class:`AgentDeadError`) is a
    dead member, not a failing kernel: on card tensors its request
    re-places onto hopper records only (``hopper_only`` of
    :meth:`RuntimeAgent._next_record` and of the graph's placement)."""
    return _on_hopper(record) and not (
        "@" in record.platform and isinstance(exc, AgentDeadError))


def _caller_stream(args: Tuple) -> Optional["torch.cuda.Stream"]:
    """The calling thread's current stream on the device of ``args``, or
    None for host operands.  A worker thread's own current stream is the
    default stream, so requests carry the caller's."""
    dev = _card_device(args)
    return None if dev is None else torch.cuda.current_stream(dev)


def _record_ready(out: Any) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on the current stream of the device that holds
    ``out``'s tensors, or None when none lies on a CUDA device."""
    dev = _card_device(out)
    if dev is None:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


# ---------------------------------------------------------------------------
# Futures
# ---------------------------------------------------------------------------
class HaloCancelledError(RuntimeError):
    """Raised when waiting on a request that was cancelled."""


class HaloFuture:
    """Completion handle for an asynchronous C2MPI request (MPIX_I*).

    Semantics follow ``concurrent.futures.Future`` but stay self-contained:
    ``result``/``exception`` may be called repeatedly.  ``result`` returns
    once the work is launched; :meth:`wait_device` then waits for the CUDA
    event recorded after the launch (a no-op for host results)."""

    _PENDING, _RUNNING, _DONE, _CANCELLED = range(4)

    def __init__(self, uid: int = 0, alias: str = "", tag: int = 0):
        self.uid = uid
        self.alias = alias
        self.tag = tag
        self._cond = threading.Condition()
        self._state = HaloFuture._PENDING
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["HaloFuture"], None]] = []
        self._ready: Optional["torch.cuda.Event"] = None

    # -- introspection -------------------------------------------------------
    def done(self) -> bool:
        with self._cond:
            return self._state in (HaloFuture._DONE, HaloFuture._CANCELLED)

    def running(self) -> bool:
        with self._cond:
            return self._state == HaloFuture._RUNNING

    def cancelled(self) -> bool:
        with self._cond:
            return self._state == HaloFuture._CANCELLED

    def device_done(self) -> bool:
        """True once the launched device work has finished (non-blocking)."""
        return self._ready is None or self._ready.query()

    def wait_device(self) -> None:
        """Block until the launched device work has finished."""
        if self._ready is not None:
            self._ready.synchronize()

    # -- completion (worker side) -------------------------------------------
    def _try_start(self) -> bool:
        """Worker claims the request; False if it was cancelled first."""
        with self._cond:
            if self._state != HaloFuture._PENDING:
                return False
            self._state = HaloFuture._RUNNING
            return True

    def _finish(self, state: int) -> List[Callable]:
        self._state = state
        self._cond.notify_all()
        cbs, self._callbacks = self._callbacks, []
        return cbs

    def _run_callbacks(self, cbs) -> None:
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                log.exception("HaloFuture done-callback raised")

    def set_result(self, value: Any) -> bool:
        """Complete with ``value``; first completion wins.  Returns False if
        the request already completed (or was cancelled)."""
        with self._cond:
            if self._state in (HaloFuture._DONE, HaloFuture._CANCELLED):
                return False
            self._result = value
            cbs = self._finish(HaloFuture._DONE)
        self._run_callbacks(cbs)
        return True

    def set_exception(self, exc: BaseException) -> bool:
        """Complete with ``exc``; first completion wins (see set_result)."""
        with self._cond:
            if self._state in (HaloFuture._DONE, HaloFuture._CANCELLED):
                return False
            self._exception = exc
            cbs = self._finish(HaloFuture._DONE)
        self._run_callbacks(cbs)
        return True

    def cancel(self) -> bool:
        """Cancel if still pending (queued, not yet claimed by a worker)."""
        with self._cond:
            if self._state != HaloFuture._PENDING:
                return self._state == HaloFuture._CANCELLED
            cbs = self._finish(HaloFuture._CANCELLED)
        self._run_callbacks(cbs)
        return True

    def _complete_from(self, other: "HaloFuture") -> None:
        """Mirror another future's outcome (and device event) into this one
        (irecv chaining).  A cancelled source surfaces as an error: this
        future may already be claimed (matched receive) and uncancellable."""
        if other.cancelled():
            self.set_exception(HaloCancelledError(
                f"matched send (uid={other.uid}, alias={other.alias!r}) "
                f"was cancelled"))
        elif other._exception is not None:
            self.set_exception(other._exception)
        else:
            self._ready = other._ready
            self.set_result(other._result)

    # -- waiting (host side) -------------------------------------------------
    def _wait(self, timeout: Optional[float]) -> None:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._state in (HaloFuture._DONE,
                                            HaloFuture._CANCELLED),
                    timeout=timeout):
                raise TimeoutError(
                    f"request (uid={self.uid}, alias={self.alias!r}) "
                    f"not complete within {timeout}s")

    def result(self, timeout: Optional[float] = None) -> Any:
        self._wait(timeout)
        if self._state == HaloFuture._CANCELLED:
            raise HaloCancelledError(
                f"request (uid={self.uid}, alias={self.alias!r}) was cancelled")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        self._wait(timeout)
        if self._state == HaloFuture._CANCELLED:
            raise HaloCancelledError(
                f"request (uid={self.uid}, alias={self.alias!r}) was cancelled")
        return self._exception

    def add_done_callback(self, fn: Callable[["HaloFuture"], None]) -> None:
        with self._cond:
            if self._state not in (HaloFuture._DONE, HaloFuture._CANCELLED):
                self._callbacks.append(fn)
                return
        fn(self)

    @classmethod
    def completed(cls, value: Any, **kw) -> "HaloFuture":
        fut = cls(**kw)
        fut.set_result(value)
        return fut


# ---------------------------------------------------------------------------
# Agent liveness (DESIGN.md §11)
# ---------------------------------------------------------------------------
class AgentState:
    """Liveness states the :class:`HealthMonitor` assigns to a target."""
    HEALTHY = "healthy"
    DEGRADED = "degraded"    # busy with no progress past the degraded window
    DEAD = "dead"            # no progress past the heartbeat timeout (sticky)


class AgentDeadError(RuntimeError):
    """An agent was declared dead: raised on new submissions to it, and used
    to fail or re-place work that cannot be recovered from its queue."""


#: share of the heartbeat timeout after which a stalled busy agent is DEGRADED
DEGRADED_FRACTION = 0.5


@dataclasses.dataclass
class HealthConfig:
    """Knobs for liveness detection and straggler speculation.

    ``heartbeat_timeout`` is the full detection budget: a busy agent whose
    worker makes no progress for that long is DEAD (DEGRADED past
    :data:`DEGRADED_FRACTION` of it).  ``straggler_multiple`` arms speculative
    re-execution of graph nodes that run past that multiple of their
    estimated latency (never earlier than ``straggler_min_s``; 0 disables).
    """

    heartbeat_timeout: float = 30.0
    poll_interval: Optional[float] = None    # None -> heartbeat_timeout / 4
    straggler_multiple: float = 4.0
    straggler_min_s: float = 0.25

    @classmethod
    def from_env(cls, **overrides: Any) -> "HealthConfig":
        """Build from :func:`repro_torch.core.config.halo_config`
        (``HALO_HEARTBEAT_TIMEOUT`` / ``HALO_HEALTH_POLL`` /
        ``HALO_STRAGGLER_MULTIPLE`` / ``HALO_STRAGGLER_MIN`` plus
        ``halo.configure(...)`` overrides), explicit keyword overrides
        winning."""
        hc = halo_config()
        cfg = {"heartbeat_timeout": hc.heartbeat_timeout,
               "poll_interval": hc.health_poll,
               "straggler_multiple": hc.straggler_multiple,
               "straggler_min_s": hc.straggler_min_s}
        cfg.update(overrides)
        return cls(**cfg)

    @property
    def effective_poll(self) -> float:
        if self.poll_interval:
            return self.poll_interval
        return max(self.heartbeat_timeout / 4.0, 1e-3)


class HealthMonitor:
    """Marks heartbeat targets DEGRADED/DEAD on missed beats (DESIGN.md §11).

    A *target* is anything exposing ``name`` and ``heartbeat() ->
    (progress_counter, busy, last_activity)`` — virtualization agents and
    the serving :class:`~repro_torch.serve.engine.StepScheduler` both
    qualify.  An idle target is always HEALTHY; a busy one whose progress
    counter has not advanced (equivalently: ``last_activity`` not
    refreshed) within the configured windows degrades, then dies.  DEAD is
    sticky: recovery is an explicit re-registration.

    Beats count host progress: an agent beats when its worker claims a
    request and when the request's thunk returns, and on the card a
    hopper or aten thunk returns once its kernels are *launched*.  Device
    completion is not counted, so a kernel still running on the card never
    stalls a beat, and a worker wedged on the host (a hung launch, a lost
    lock) does.

    The monitor doubles as the deadline service for straggler speculation:
    :meth:`watch` registers a one-shot callback fired when its deadline
    passes.  Sweeps happen on the background thread (:meth:`start`) or
    synchronously via :meth:`check`, which tests drive with a scripted
    clock."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig.from_env()
        self._lock = threading.Lock()
        self._targets: Dict[str, Any] = {}
        self._states: Dict[str, str] = {}
        self._listeners: List[Callable[[Any, str, str], None]] = []
        self._watches: Dict[int, Tuple[float, Callable[[], None]]] = {}
        self._watch_uid = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- registration --------------------------------------------------------
    def register(self, target: Any) -> None:
        """Track ``target``; re-registering a name resets it to HEALTHY."""
        with self._lock:
            self._targets[target.name] = target
            self._states[target.name] = AgentState.HEALTHY

    def unregister(self, target_or_name: Any) -> None:
        name = getattr(target_or_name, "name", target_or_name)
        with self._lock:
            self._targets.pop(name, None)
            self._states.pop(name, None)

    def on_transition(self, listener: Callable[[Any, str, str], None]) -> None:
        """``listener(target, old_state, new_state)`` on every change."""
        with self._lock:
            self._listeners.append(listener)

    def state(self, target_or_name: Any) -> str:
        name = getattr(target_or_name, "name", target_or_name)
        with self._lock:
            return self._states.get(name, AgentState.HEALTHY)

    # -- straggler watch service ---------------------------------------------
    def watch(self, deadline: float, callback: Callable[[], None]) -> int:
        """Fire ``callback`` once on the first sweep after ``deadline``
        (``time.monotonic`` clock); returns a token for :meth:`unwatch`."""
        with self._lock:
            self._watch_uid += 1
            self._watches[self._watch_uid] = (deadline, callback)
            return self._watch_uid

    def unwatch(self, token: Optional[int]) -> None:
        if token is None:
            return
        with self._lock:
            self._watches.pop(token, None)

    # -- sweeping ------------------------------------------------------------
    def _classify(self, busy: bool, stalled: float) -> str:
        cfg = self.config
        if not busy:
            return AgentState.HEALTHY
        if stalled >= cfg.heartbeat_timeout:
            return AgentState.DEAD
        if stalled >= cfg.heartbeat_timeout * DEGRADED_FRACTION:
            return AgentState.DEGRADED
        return AgentState.HEALTHY

    def _notify(self, listeners, target: Any, old: str, new: str) -> None:
        for listener in listeners:
            try:
                listener(target, old, new)
            except Exception:
                log.exception("health-transition listener raised")

    def check(self, now: Optional[float] = None) -> Dict[str, str]:
        """One synchronous liveness sweep + expired-watch firing; returns
        the post-sweep state map."""
        now = time.monotonic() if now is None else now
        transitions: List[Tuple[Any, str, str]] = []
        with self._lock:
            targets = list(self._targets.items())
        for name, target in targets:
            try:
                _beats, busy, last = target.heartbeat()
            except Exception:
                log.exception("heartbeat() raised for %s", name)
                continue
            new = self._classify(busy, now - last)
            with self._lock:
                old = self._states.get(name, AgentState.HEALTHY)
                if old == AgentState.DEAD or new == old:
                    continue
                self._states[name] = new
            transitions.append((target, old, new))
        with self._lock:
            due = [(tok, cb) for tok, (dl, cb) in self._watches.items()
                   if dl <= now]
            for tok, _cb in due:
                del self._watches[tok]
            listeners = list(self._listeners)
        for target, old, new in transitions:
            self._notify(listeners, target, old, new)
        for _tok, cb in due:
            try:
                cb()
            except Exception:
                log.exception("straggler watch callback raised")
        with self._lock:
            return dict(self._states)

    def mark_dead(self, target_or_name: Any) -> None:
        """Administratively force a target DEAD (listeners fire as usual)."""
        name = getattr(target_or_name, "name", target_or_name)
        with self._lock:
            target = self._targets.get(name)
            old = self._states.get(name, AgentState.HEALTHY)
            if target is None or old == AgentState.DEAD:
                return
            self._states[name] = AgentState.DEAD
            listeners = list(self._listeners)
        self._notify(listeners, target, old, AgentState.DEAD)

    # -- background sweeper --------------------------------------------------
    def start(self) -> "HealthMonitor":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="halo-health-monitor", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.effective_poll):
            self.check()

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def __enter__(self) -> "HealthMonitor":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Virtualization agents
# ---------------------------------------------------------------------------
class VirtualizationAgent:
    """Encapsulates one execution substrate behind the C2MPI accelerator
    interface.  The paper's three-stage pipeline (network manager → system
    services → device services) maps to ``_ingest`` → ``_services`` →
    ``_device_execute``."""

    platform: str = "torch"
    #: whether the agent runs its records in this process on the caller's
    #: stream, so that a CUDA graph captured around a dispatch records them
    on_caller_stream: bool = True

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{self.platform}-agent"
        self.metrics = collections.Counter()
        self._lock = threading.Lock()
        # asynchronous execute (§V-A): one FIFO worker per agent, lazily
        # started — requests to the same substrate serialize, requests to
        # different substrates overlap on the host.
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._shutdown = False
        # liveness (DESIGN.md §11): worker-loop progress counter + last-
        # activity timestamp, read by the HealthMonitor via heartbeat()
        self._beats = 0
        self._last_beat = time.monotonic()
        self._current: Optional[tuple] = None    # item the worker is running
        self._dead = False
        self._dead_reason = ""

    # -- asynchronous execution (worker queue) -------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._shutdown = False
            self._worker = threading.Thread(
                target=self._worker_loop, name=f"{self.name}-worker",
                daemon=True)
            self._worker.start()

    def _beat(self, item: Optional[tuple]) -> None:
        """Worker progress tick: claims (item) and completions (None)."""
        with self._lock:
            self._beats += 1
            self._last_beat = time.monotonic()
            self._current = item

    def _worker_loop(self) -> None:
        while True:
            # drop the last request before waiting for the next: its thunk
            # holds its graph and every result in it, which would otherwise
            # stay alive as long as this agent sits idle (``_current`` is
            # cleared by the completion beat for the same reason)
            item = fut = fn = after = replay = result = None
            item = self._queue.get()
            if item is None:
                return
            fut, fn, after, replay = item
            if not fut._try_start():      # cancelled while queued
                continue
            self._beat(item)
            t0 = time.perf_counter()
            try:
                result = fn()
            except BaseException as exc:  # noqa: BLE001 — propagate via future
                self._fail_item(fut, exc)
                self._beat(None)
                continue
            fut.set_result(result)        # waiters proceed before bookkeeping
            self._beat(None)
            if after is not None:
                try:
                    after(result, t0)
                except Exception:
                    log.exception("post-execution hook raised")

    def _fail_item(self, fut: HaloFuture, exc: BaseException) -> None:
        """Complete a work item's future with its execution error.  Split
        out of :meth:`_worker_loop` so transports can suppress it: a
        RemoteAgent whose process died fails the *transport* call on the
        blocked worker thread, but by then ``mark_dead`` already handed the
        item to the replay ladder — completing the future with the
        transport error would race (and could beat) the replayed result."""
        fut.set_exception(exc)

    def submit(self, fn: Callable[[], Any], future: Optional[HaloFuture] = None,
               after: Optional[Callable[[Any, float], None]] = None,
               replay: Optional[Callable[[], None]] = None) -> HaloFuture:
        """Enqueue a thunk on this agent's worker; returns its future.

        ``after(result, start_time)`` runs on the worker after the future is
        completed — used for latency feedback without delaying waiters.
        ``replay()`` is the recovery hook: if this agent is declared DEAD
        with the item still incomplete, the session calls it (instead of
        re-running ``fn``) so the owner can re-place the work."""
        fut = future or HaloFuture()
        with self._lock:
            if self._dead:
                raise AgentDeadError(
                    f"agent {self.name} is dead ({self._dead_reason})")
            if self._shutdown:
                raise RuntimeError(f"agent {self.name} is shut down")
            self._ensure_worker()
            # the beat clock restarts when a busy period begins; refreshing
            # it on every submit would let a steady caller mask a hung worker
            if self._current is None and self._queue.empty():
                self._last_beat = time.monotonic()
            self._queue.put((fut, fn, after, replay))
        return fut

    def heartbeat(self) -> Tuple[int, bool, float]:
        """Liveness snapshot: ``(progress_counter, busy, last_activity)``.
        ``busy`` means a request is running or queued — an idle agent is
        healthy no matter how stale its timestamp."""
        with self._lock:
            busy = self._current is not None or not self._queue.empty()
            return self._beats, busy, self._last_beat

    @property
    def dead(self) -> bool:
        return self._dead

    def mark_dead(self, reason: str = "declared dead") -> List[tuple]:
        """Declare this agent dead: refuse new submissions, report
        unavailable, and hand back every not-yet-completed work item — the
        claimed in-flight one first, then the queue in FIFO order — for the
        session to replay onto healthy agents.  The hung worker thread is
        left behind; if it ever finishes, its late result loses the
        first-completion race on the future.  Idempotent."""
        with self._lock:
            if self._dead:
                return []
            self._dead = True
            self._dead_reason = reason
            items: List[tuple] = []
            if self._current is not None and not self._current[0].done():
                items.append(self._current)
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item[0].done():
                    items.append(item)
            # wake an idle worker so the thread exits instead of lingering
            self._queue.put(None)
        return items

    def shutdown(self, cancel_pending: bool = True, wait: bool = True) -> None:
        """Stop the worker; optionally cancel still-queued requests."""
        with self._lock:
            self._shutdown = True
            worker = self._worker
        if cancel_pending:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[0].cancel()
        if worker is not None and worker.is_alive():
            self._queue.put(None)
            if wait:
                worker.join(timeout=5.0)
        self._worker = None

    # stage 1: network manager — validate & normalize the request
    def _ingest(self, record: KernelRecord, args: Tuple, kwargs: Dict):
        return args, kwargs

    # stage 2: system services — requests resolvable without hardware
    def _services(self, record: KernelRecord, args: Tuple):
        with self._lock:
            self.metrics["requests"] += 1
            for a in args:
                if isinstance(a, torch.Tensor):
                    self.metrics["bytes_in"] += a.numel() * a.element_size()

    # stage 3: device services — vendor logic / device manager
    def _device_execute(self, record: KernelRecord, args: Tuple, kwargs: Dict):
        return record.fn(*args, **kwargs)

    def available(self) -> bool:
        return not self._dead

    def execute(self, record: KernelRecord, *args, **kwargs):
        args, kwargs = self._ingest(record, args, kwargs)
        self._services(record, args)
        out = self._device_execute(record, args, kwargs)
        with self._lock:
            self.metrics["completed"] += 1
        return out


class TorchAgent(VirtualizationAgent):
    """Reference/fail-safe substrate: executes the plain PyTorch oracle."""
    platform = "torch"


class AtenAgent(VirtualizationAgent):
    """Library substrate: PyTorch's own ops (cuBLAS, ATen kernels)."""
    platform = "aten"


class HopperAgent(VirtualizationAgent):
    """Hand-written Hopper kernel substrate.

    Bound to the session's device.  On a CUDA device it requires capability
    9.0 or higher and raises at construction otherwise — it never demotes
    to another substrate.  On the CPU its records run their wrappers' plain
    versions, which is how the host tests drive this path."""
    platform = "hopper"

    def __init__(self, device="cuda", name: Optional[str] = None):
        super().__init__(name)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_hopper(self.device)


class ShardedAgent(AtenAgent):
    """Distributed substrate: runs each record under a device mesh
    (``distributed.sharding.mesh_context``), so the records' ``shard_map``
    regions split over it.  Available only with a mesh attached; no
    built-in record is registered on it."""
    platform = "sharded"
    on_caller_stream = False      # its records call collectives over the mesh

    def __init__(self, mesh=None, name: Optional[str] = None):
        super().__init__(name)
        self.mesh = mesh

    def available(self) -> bool:
        return self.mesh is not None and not self._dead

    def _device_execute(self, record: KernelRecord, args, kwargs):
        if self.mesh is None:
            raise RuntimeError("ShardedAgent has no mesh attached")
        from ..distributed.sharding import mesh_context
        with mesh_context(self.mesh):
            return super()._device_execute(record, args, kwargs)


# ---------------------------------------------------------------------------
# Child ranks
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChildRank:
    """Opaque virtual handle to a claimed system resource (§IV-C).

    The runtime agent may route each invocation to any compatible record;
    a CR can also represent a *pipeline* (series of dependent kernel
    invocations)."""

    uid: int
    alias: str
    pipeline: Tuple[str, ...] = ()
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    failsafe: Optional[Callable] = None
    # tag -> FIFO of pending result futures (the mailbox orders by
    # submission, not completion)
    mailboxes: Dict[int, collections.deque] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(collections.deque))
    # tag -> FIFO of receive futures posted before any matching send (irecv)
    recv_waiters: Dict[int, collections.deque] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(collections.deque))
    buffers: Dict[str, BufferHandle] = dataclasses.field(default_factory=dict)
    freed: bool = False
    # claim-time resolution cache: arg signature -> selected records
    resolution_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    @property
    def stateful(self) -> bool:
        return bool(self.buffers)


# ---------------------------------------------------------------------------
# Runtime agent
# ---------------------------------------------------------------------------
class RuntimeAgent:
    """The C2MPI crossbar: implements both the application interface (claim/
    send/recv/…) and the accelerator interface (agent registration, buffer
    table, manifests).  One runtime agent exists per application."""

    def __init__(self,
                 registry: Optional[KernelRegistry] = None,
                 manifest: Optional[Manifest] = None,
                 agents: Optional[Sequence[VirtualizationAgent]] = None,
                 scheduler: Optional[CostModelScheduler] = None,
                 device="cuda",
                 health: Optional[HealthMonitor] = None,
                 mesh=None):
        self.device = torch.device(device)
        self.registry = registry or GLOBAL_REGISTRY
        self.manifest = manifest or default_manifest()
        if agents is None:
            # the sharded substrate joins only with a mesh: without one no
            # reader of the session's agents (comm_split, the health
            # monitor, a worker's clones) sees it
            agents = [TorchAgent(), AtenAgent(), HopperAgent(self.device)]
            if mesh is not None:
                agents.append(ShardedAgent(mesh))
        self.agents: Dict[str, VirtualizationAgent] = {a.platform: a for a in agents}
        # cost-model + measured-latency request scheduler (DESIGN.md §4);
        # scheduler=False disables it (pure static platform-preference order)
        if scheduler is None:
            scheduler = CostModelScheduler.default()
        self.scheduler = scheduler or None
        self._cr_counter = 0
        self._crs: Dict[int, ChildRank] = {}
        self._comms: List[Any] = []                  # live HaloComm handles
        self._buffer_table: Dict[int, Any] = {}      # BufferHandle.uid -> tensor
        self._lock = threading.RLock()
        self.finalized = False
        # T1 instrumentation: host-side dispatch overhead accounting
        self._t1_seconds = 0.0
        self._t1_calls = 0
        # per-session compiled-graph cache (DESIGN.md §12): graph key ->
        # CompiledGraph, LRU-bounded by ``fusion.GRAPH_CACHE``
        self._compiled_graphs: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        # liveness (DESIGN.md §11): monitor off by default — sessions opt in
        # via the constructor, enable_health_monitor(), or HALO_HEALTH_MONITOR
        self.health: Optional[HealthMonitor] = None
        if health is not None:
            self.enable_health_monitor(monitor=health, start=False)
        elif halo_config().health_monitor:
            self.enable_health_monitor()

    # -- agent interoperability (plug-and-play, §V-A5) -------------------------
    def attach_agent(self, agent: VirtualizationAgent) -> None:
        with self._lock:
            self.agents[agent.platform] = agent
        if self.health is not None:
            self.health.register(agent)

    def detach_agent(self, platform: str) -> Optional[VirtualizationAgent]:
        with self._lock:
            agent = self.agents.pop(platform, None)
        if agent is not None and self.health is not None:
            self.health.unregister(agent)
        return agent

    # -- liveness + self-healing (DESIGN.md §11) -------------------------------
    def enable_health_monitor(self, config: Optional[HealthConfig] = None,
                              monitor: Optional[HealthMonitor] = None,
                              start: bool = True) -> HealthMonitor:
        """Wire a :class:`HealthMonitor` over this session's agents: every
        registered agent is tracked, and a DEAD transition triggers
        :meth:`handle_dead_agent` (queue replay + comm membership repair).
        ``start=True`` launches the background sweeper; tests usually pass
        ``start=False`` and drive ``monitor.check()`` themselves.

        On a card session the kernel library is built (or loaded) here,
        before any agent is watched: ``nvcc`` builds it at first launch
        otherwise, inside a hopper request, and a cold build outlasts the
        default heartbeat timeout — the hopper agent would be declared
        DEAD and its work replayed on the plain rows."""
        if self.device.type == "cuda" and "hopper" in self.agents:
            from ..kernels import _cuda
            _cuda.lib()
        mon = monitor or HealthMonitor(config)
        self.health = mon
        with self._lock:
            agents = list(self.agents.values())
        for agent in agents:
            mon.register(agent)
        mon.on_transition(self._on_health_transition)
        if start:
            mon.start()
        return mon

    def _on_health_transition(self, target: Any, old: str, new: str) -> None:
        if new != AgentState.DEAD or not isinstance(target, VirtualizationAgent):
            return
        if self.agents.get(target.platform) is target:
            self.handle_dead_agent(target)

    def _healthy_fallback(self, exclude: str) -> Optional[VirtualizationAgent]:
        """An available agent to replay a dead agent's work on — the torch
        fail-safe substrate when alive, else any other available one."""
        with self._lock:
            agents = dict(self.agents)
        torch_agent = agents.get("torch")
        if torch_agent is not None and torch_agent.platform != exclude \
                and torch_agent.available():
            return torch_agent
        for platform, agent in agents.items():
            if platform != exclude and agent.available():
                return agent
        return None

    def handle_dead_agent(self, agent: VirtualizationAgent,
                          reason: str = "heartbeat timeout") -> int:
        """Self-healing response to a DEAD agent (DESIGN.md §11): declare it
        dead (new submissions refused, ``available()`` False so placement
        routes around it), re-bind every device-group rank it held onto
        surviving members (``HaloComm.on_member_dead``), and replay its
        not-yet-completed queue items onto a healthy agent — via each
        item's ``replay`` hook when the owner registered one (graph nodes
        re-place), else by re-running the thunk on the fail-safe agent.
        Returns the number of items recovered."""
        items = agent.mark_dead(reason)
        log.warning("agent %s declared dead (%s); replaying %d queued "
                    "request(s)", agent.name, reason, len(items))
        with self._lock:
            comms = list(self._comms)
        for comm in comms:
            try:
                comm.on_member_dead(agent.platform)
            except Exception:
                log.exception("comm %s failed to drop dead member %s",
                              getattr(comm, "name", comm), agent.platform)
        fallback = self._healthy_fallback(exclude=agent.platform)
        for fut, fn, _after, replay in items:
            if replay is not None:
                try:
                    replay()
                except Exception:
                    log.exception("replay hook raised for %s", fut.alias)
                continue
            if fallback is None:
                fut.set_exception(AgentDeadError(
                    f"agent {agent.name} died and no healthy agent remains "
                    f"to replay request (uid={fut.uid}, alias={fut.alias!r})"))
                continue

            def _replayed(fn=fn, fut=fut):
                # the future may already be claimed by the dead worker, so
                # run the thunk directly and race it (first result wins —
                # for an in-flight hang the dead side never finishes anyway)
                try:
                    fut.set_result(fn())
                except BaseException as exc:  # noqa: BLE001 — via future
                    fut.set_exception(exc)
            fallback.submit(_replayed)
        return len(items)

    def attach_mesh(self, mesh) -> None:
        """Give the ``sharded`` substrate ``mesh`` (replacing any earlier
        one), attaching a :class:`ShardedAgent` if the session has none."""
        a = self.agents.get("sharded")
        if isinstance(a, ShardedAgent):
            a.mesh = mesh
        else:
            self.attach_agent(ShardedAgent(mesh))

    def _allowed_platforms(self) -> List[str]:
        return [p for p, a in self.agents.items() if a.available()]

    def capturable_platforms(self) -> Optional[Tuple[str, ...]]:
        """The platforms the session may dispatch to, or None where one of
        their agents runs its records off the caller's stream (a worker
        process, the sharded substrate): a CUDA graph cannot capture what
        such a session dispatches."""
        live = [a for a in self.agents.values() if a.available()]
        if not all(a.on_caller_stream for a in live):
            return None
        return tuple(a.platform for a in live)

    def _platform_preference(self) -> Optional[Sequence[str]]:
        """Hardware recommendation strategy (paper §IV-C, platform_list)."""
        pref = self.manifest.platform_preference()
        return None if pref is None else tuple(pref)

    # -- resource allocation (§IV-F) -------------------------------------------
    def claim(self, alias, failsafe: Optional[Callable] = None,
              overrides: Optional[Dict[str, Any]] = None) -> ChildRank:
        """MPIX_Claim: allocate a CR for ``alias`` (str) or a pipeline (list).

        Config-file overrides for the alias (Table I func_list entries) merge
        under explicit ``overrides`` (the MPI_Info-style runtime override)."""
        self._check_live()
        pipeline: Tuple[str, ...] = ()
        if isinstance(alias, (tuple, list)):
            pipeline = tuple(alias)
            alias = pipeline[0]
        merged: Dict[str, Any] = {}
        entry = self.manifest.func(alias)
        if entry is not None:
            merged.update(entry.overrides)
        if overrides:
            merged.update(overrides)
        with self._lock:
            self._cr_counter += 1
            cr = ChildRank(uid=self._cr_counter, alias=alias, pipeline=pipeline,
                           overrides=merged, failsafe=failsafe)
            self._crs[cr.uid] = cr
        return cr

    def create_buffer(self, cr: Optional[ChildRank], shape, dtype,
                      init=None, name: Optional[str] = None) -> BufferHandle:
        """MPIX_CreateBuffer: allocate an internal (framework-managed) buffer
        on the session's device.

        Passing ``cr=None`` (paper: CR handle 0) associates the buffer with
        the framework itself; otherwise it becomes CR state, turning the CR's
        invocations stateful."""
        self._check_live()
        handle = BufferHandle.allocate(shape, dtype,
                                       owner_rank=0 if cr is None else cr.uid)
        if init is None:
            t = torch.zeros(tuple(shape), dtype=dtype, device=self.device)
        else:
            t = torch.as_tensor(init, dtype=dtype, device=self.device).reshape(
                tuple(shape))
        with self._lock:
            self._buffer_table[handle.uid] = t
            if cr is not None:
                cr.buffers[name or f"buf{handle.uid}"] = handle
        return handle

    def read_buffer(self, handle: BufferHandle):
        return self._buffer_table[handle.uid]

    def free(self, cr: ChildRank) -> None:
        """MPIX_Free: deallocate the CR and its internal buffers.  Posted
        receives are cancelled; undelivered results are dropped."""
        with self._lock:
            for h in cr.buffers.values():
                self._buffer_table.pop(h.uid, None)
            cr.buffers.clear()
            waiters = [w for box in cr.recv_waiters.values() for w in box]
            cr.recv_waiters.clear()
            cr.mailboxes.clear()
            cr.freed = True
            self._crs.pop(cr.uid, None)
        for w in waiters:
            w.cancel()

    def finalize(self) -> None:
        """MPIX_Finalize: free all outstanding resources (child ranks, their
        buffers, device groups) and stop the monitor and the workers."""
        if self.health is not None:
            self.health.stop()
        with self._lock:
            crs = list(self._crs.values())
        for cr in crs:
            self.free(cr)
        with self._lock:
            comms, self._comms = self._comms, []
        for comm in comms:
            comm.free()
        for agent in list(self.agents.values()):
            agent.shutdown(cancel_pending=True, wait=True)
        with self._lock:
            self._buffer_table.clear()
            self._compiled_graphs.clear()
            self.finalized = True
        if self.scheduler is not None:
            self.scheduler.save()

    def _check_live(self):
        if self.finalized:
            raise RuntimeError("runtime agent already finalized")

    def comm_split(self, platforms: Optional[Sequence[str]] = None,
                   name: Optional[str] = None):
        """MPIX_CommSplit: create a device group (:class:`~repro_torch.core.
        collective.HaloComm`) over this session's virtualization agents
        (DESIGN.md §10).  ``platforms`` lists the member substrates in rank
        order; the default spans every available accelerator substrate.
        The handle is tracked so :meth:`finalize` frees it."""
        self._check_live()
        from .collective import comm_split
        comm = comm_split(self, platforms, name=name)
        with self._lock:
            self._comms.append(comm)
        return comm

    # -- selection + execution --------------------------------------------------
    def _select(self, alias: str, args: Tuple,
                overrides: Optional[Dict[str, Any]] = None,
                explore: bool = False) -> KernelRecord:
        overrides = overrides or {}
        allowed = overrides.get("allowed_platforms", self._allowed_platforms())
        pref = overrides.get("platform_preference", self._platform_preference())
        candidates = None
        if self.scheduler is not None:
            try:
                candidates = self.registry.candidates(
                    alias, *args, allowed_platforms=allowed,
                    platform_preference=pref)
            except SelectionError:
                candidates = None
            if candidates:
                # quarantine: a record whose execution raised stays
                # unselectable until clear_failures() (failsafe semantics)
                candidates = [c for c in candidates
                              if not self.scheduler.is_failed(c)]
            choice = self.scheduler.choose(alias, candidates, args,
                                           explore=explore) \
                if candidates else None
            if choice is not None:
                return choice
        # no cost estimate available for any candidate (or scheduler off):
        # static preference order + priority + version + round-robin ties
        record = self.registry.select(alias, *args, allowed_platforms=allowed,
                                      platform_preference=pref,
                                      _candidates=candidates)
        if record.platform not in allowed:
            # the registry's fail-safe does not override a claim's pin
            raise SelectionError(
                f"alias {alias!r}: no feasible record on {list(allowed)}")
        return record

    def _tuned_kwargs(self, record: KernelRecord, args: Tuple,
                      kwargs: Dict) -> Dict:
        """Merge the TuningDB's winning launch plan for (record, args) into
        the call kwargs (DESIGN.md §9).  Explicit caller kwargs always win;
        records without a tuning space, schedulers without a DB and an
        empty DB pass through untouched — the last without building a key
        or calling ``variants()``, since this runs on every dispatch."""
        sched = self.scheduler
        if sched is None or record.tuning_space is None or not sched.tuning:
            return kwargs
        cfg = sched.tuned_config(record, args)
        if not cfg:
            return kwargs
        cfg.update(kwargs)
        return cfg

    def dispatch(self, alias: str, *args, overrides: Optional[Dict] = None,
                 **kwargs):
        """Direct dispatch: select, then call the record in the caller's
        thread.  No mailboxes, no buffer table and no device sync — the
        result may still be in flight on the card.  A TuningDB entry for
        the selected record merges its launch plan into the call
        (:meth:`_tuned_kwargs`); T1 counts the merge with the selection.

        Inside a ``halo_graph()`` capture region the call records a DAG node
        and returns it; passing the node into later captured calls expresses
        the data dependency (DESIGN.md §8)."""
        g = _active_graph(self)
        if g is not None:
            return g.record_dispatch(alias, args, kwargs, overrides)
        t0 = time.perf_counter()
        try:
            record = self._select(alias, args, overrides)
            kwargs = self._tuned_kwargs(record, args, kwargs)
        except SelectionError:
            if overrides and overrides.get("failsafe") is not None:
                return overrides["failsafe"](*args, **kwargs)
            raise
        finally:
            self._account_t1(time.perf_counter() - t0)
        return record.fn(*args, **kwargs)

    def _execute_on(self, agent: VirtualizationAgent, record: KernelRecord,
                    cr: Optional[ChildRank], args: Tuple, kwargs: Dict):
        """One execution attempt on an explicit agent — no failover.

        Shared by the DRPC path and graph-node execution, so the TuningDB
        merge (:meth:`_tuned_kwargs`) happens here: whichever record was
        placed runs at its swept launch plan."""
        kwargs = self._tuned_kwargs(record, args, kwargs)
        if cr is not None and cr.stateful:
            # snapshot under the lock: a concurrent free() may be clearing
            # the CR's buffers while this request is in flight on a worker
            with self._lock:
                state = {n: self._buffer_table[h.uid]
                         for n, h in cr.buffers.items()
                         if h.uid in self._buffer_table}
            out, new_state = agent.execute(record, *args, state=state, **kwargs)
            with self._lock:
                for n, h in cr.buffers.items():
                    if n in new_state and h.uid in self._buffer_table:
                        self._buffer_table[h.uid] = new_state[n]
            return out
        return agent.execute(record, *args, **kwargs)

    def _record_failure(self, record: KernelRecord, exc: BaseException) -> None:
        """Quarantine a record whose execution raised so the scheduler stops
        selecting it, and drop stale resolutions that may still name it."""
        if self.scheduler is not None:
            self.scheduler.mark_failed(record)
        with self._lock:
            for cr in self._crs.values():
                cr.resolution_cache.clear()
        log.warning("record %s/%s failed (%s: %s); re-placing",
                    record.alias, record.platform, type(exc).__name__, exc)

    def _agent_for(self, record: KernelRecord) -> Optional[VirtualizationAgent]:
        agent = self.agents.get(record.platform)
        return agent if agent is not None and agent.available() else None

    def _execute_record(self, record: KernelRecord, cr: ChildRank,
                        args: Tuple, kwargs: Dict):
        """Execute with failsafe semantics (§IV-C): an agent that raises
        quarantines its record and the request re-places onto the next
        feasible record the claim allows, ending at the registry fail-safe
        (or the CR's claim-level callback); only when every path fails does
        the *original* error surface to the waiter.

        A hopper record given tensors on the card is the exception (a
        worker's ``hopper@<worker>`` clone included, :func:`_hopper_error`):
        its build or launch error surfaces at once, unquarantined, so a
        request on the card never gives way to a plain version unseen.  A
        clone whose worker was lost re-places onto the other hopper records
        (the local row, another worker's clone) and raises when none is
        left."""
        overrides = cr.overrides if cr is not None else {}
        agent = self._agent_for(record)
        if agent is None:
            record = self._next_record(record.alias, args, overrides, [record])
            if record is None:
                raise SelectionError(
                    f"no agent for the selected platform and no allowed "
                    f"fail-safe")
            agent = self._agent_for(record) or self.agents["torch"]
        tried: List[KernelRecord] = []
        first_exc: Optional[BaseException] = None
        card = _card_device(args) is not None
        hopper_only = False
        while True:
            try:
                return self._execute_on(agent, record, cr, args, kwargs)
            except Exception as exc:  # noqa: BLE001 — failsafe re-placement
                if card and _hopper_error(record, exc):
                    raise
                # a lost worker's hopper clone on the card: no plain row
                hopper_only = hopper_only or (card and _on_hopper(record))
                tried.append(record)
                first_exc = first_exc or exc
                self._record_failure(record, exc)
            nxt = self._next_record(record.alias, args, overrides, tried,
                                    hopper_only=hopper_only)
            if nxt is None:
                if cr is not None and cr.failsafe is not None \
                        and not hopper_only:
                    log.warning("CR %d (%s): fail-safe callback engaged after "
                                "execution failure", cr.uid, cr.alias)
                    return cr.failsafe(*args, **kwargs)
                raise first_exc
            record = nxt
            agent = self._agent_for(record) or self.agents["torch"]

    def _next_record(self, alias: str, args: Tuple, overrides: Dict,
                     tried: Sequence[KernelRecord],
                     hopper_only: bool = False) -> Optional[KernelRecord]:
        """Next feasible record for re-placement, excluding already-tried
        ones; falls back to the registry fail-safe record when the claim's
        ``allowed_platforms`` admit it.  ``hopper_only`` offers hopper
        records alone, and no fail-safe."""
        allowed = overrides.get("allowed_platforms", self._allowed_platforms())
        if hopper_only:
            allowed = [p for p in allowed if p.partition("@")[0] == "hopper"]
        pref = overrides.get("platform_preference", self._platform_preference())
        try:
            cands = self.registry.candidates(
                alias, *args, allowed_platforms=allowed,
                platform_preference=pref, exclude=tried)
        except SelectionError:
            cands = []
        for rec in cands:
            if self._agent_for(rec) is not None:
                return rec
        if hopper_only:
            return None
        fs = self.registry.failsafe(alias)
        if fs is not None and fs.platform in allowed \
                and all(fs is not r for r in tried):
            return fs
        return None

    #: sends per (CR, signature) before re-consulting the scheduler — lets
    #: measured-latency feedback re-rank records for long-lived CRs without
    #: paying selection on every request
    RESOLUTION_TTL = 32

    def _resolve(self, cr: ChildRank, args: Tuple) -> Tuple[List[KernelRecord], Any]:
        """Claim-style resolution caching: a CR re-resolves when the argument
        signature changes and, with the scheduler on, every RESOLUTION_TTL
        sends so feedback can re-rank."""
        sig = abstract_signature(args)
        entry = cr.resolution_cache.get(sig)
        if entry is not None and (self.scheduler is None or entry[1] > 0):
            entry[1] -= 1
            return entry[0], sig
        records = [self._select(a, args, cr.overrides, explore=True)
                   for a in (cr.pipeline or (cr.alias,))]
        cr.resolution_cache[sig] = [records, self.RESOLUTION_TTL]
        return records, sig

    def _execute_chain(self, cr: ChildRank, records: Sequence[KernelRecord],
                       args: Tuple, kwargs: Dict):
        """Worker-side body of one request: the CR's record (or pipeline)."""
        out = self._execute_record(records[0], cr, args, kwargs)
        # Pipeline CRs: series of dependent kernel invocations (§IV-C).  The
        # intermediate never returns to the host — the C2MPI SendFwd semantics.
        for rec in records[1:]:
            nxt = out if isinstance(out, tuple) else (out,)
            out = self._execute_record(rec, cr, nxt, {})
        return out

    def _deliver(self, target: ChildRank, tag: int, fut: HaloFuture) -> bool:
        """Under self._lock: hand ``fut`` to the oldest posted irecv waiter
        for (target, tag), or queue it on the mailbox.  True if mailboxed."""
        waiters = target.recv_waiters[tag]
        while waiters:
            waiter = waiters.popleft()
            # claiming the waiter (PENDING -> RUNNING) makes a later
            # cancel() refuse, so a matched receive cannot drop the result
            if waiter._try_start():
                fut.add_done_callback(waiter._complete_from)
                return False
        target.mailboxes[tag].append(fut)
        return True

    # -- data-movement interface (§IV-E; async surface DESIGN.md §4) -----------
    def isend(self, payload, cr: ChildRank, tag: int = 0,
              dest: Optional[ChildRank] = None, mailbox: bool = True,
              **kwargs) -> HaloFuture:
        """MPIX_ISend: non-blocking submit.  Selection + routing happen here
        (caller thread — T1); execution happens on the selected agent's
        worker.  The returned future completes when the worker has launched
        the kernel; ``MPIX_Wait``/``recv`` add the device sync through the
        CUDA event recorded after the launch.  The same future is queued
        FIFO on the (dest or cr) mailbox for this tag; pass
        ``mailbox=False`` when it will only be consumed through the handle.

        Inside a ``halo_graph()`` capture region the call records a DAG node
        (returned in place of a live request) instead of executing; graph
        results arrive through the node futures only, never the mailbox."""
        self._check_live()
        if cr.freed:
            raise RuntimeError(f"CR {cr.uid} was freed")
        g = _active_graph(self)
        if g is not None:
            if dest is not None:
                raise RuntimeError(
                    "MPIX_SendFwd/dest is not supported inside graph capture; "
                    "pass the returned node as a later payload instead")
            return g.record_isend(cr, payload, tag=tag, kwargs=kwargs)
        co = as_compute_object(payload)
        args = tuple(co.inputs[k] for k in sorted(co.inputs))
        kwargs = dict(kwargs)
        kwargs.update(co.meta)
        t0 = time.perf_counter()
        try:
            records, sig = self._resolve(cr, args)
        except SelectionError:
            self._account_t1(time.perf_counter() - t0)
            if cr.failsafe is None:
                raise
            log.warning("CR %d (%s): fail-safe callback engaged",
                        cr.uid, cr.alias)
            records, sig = None, None
        else:
            self._account_t1(time.perf_counter() - t0)
        fut = HaloFuture(uid=cr.uid, alias=cr.alias, tag=tag)
        after = None
        if records is None:
            agent = self.agents["torch"]
            failsafe = cr.failsafe
            run = lambda: failsafe(*args, **kwargs)
        else:
            agent = self.agents.get(records[0].platform) or self.agents["torch"]
            run = lambda: self._execute_chain(cr, records, args, kwargs)
            if self.scheduler is not None and not cr.pipeline:
                rec0, sched = records[0], self.scheduler

                def after(out, t0):
                    # worker-side latency feedback, after waiters were
                    # released; sampling keeps the device sync off hot keys
                    if not sched.wants_sample(rec0, sig):
                        return
                    fut.wait_device()
                    sched.observe(rec0, sig, time.perf_counter() - t0)

        stream = _caller_stream(args)

        def task():
            # launch on the caller's stream, so work it queued before this
            # request (its inputs) is ordered before the kernel
            with torch.cuda.stream(stream):
                out = run()
                fut._ready = _record_ready(out)
            return out

        # mailbox append and worker enqueue are atomic together: per-tag FIFO
        # order (what recv sees) always equals per-agent execution order
        with self._lock:
            # re-check under the lock: a concurrent free() must not let a
            # request execute against cleared buffers / a drained mailbox
            if cr.freed or (dest is not None and dest.freed):
                raise RuntimeError(f"CR {cr.uid} was freed")
            target = dest or cr
            mailboxed = self._deliver(target, tag, fut) if mailbox else False
            try:
                agent.submit(task, future=fut, after=after)
            except Exception:
                # undo the delivery: a future no worker will ever complete
                # must not strand a later recv/Wait
                if mailboxed:
                    try:
                        target.mailboxes[tag].remove(fut)
                    except ValueError:
                        pass
                fut.cancel()
                raise
        return fut

    def irecv(self, cr: ChildRank, tag: int = 0) -> HaloFuture:
        """MPIX_IRecv: future for the oldest pending result for (cr, tag).

        An empty mailbox is not an error: the returned future is *posted*
        and completes when a matching isend's result lands."""
        self._check_live()
        with self._lock:
            if cr.freed:
                raise RuntimeError(f"CR {cr.uid} was freed")
            box = cr.mailboxes[tag]
            if box:
                return box.popleft()
            waiter = HaloFuture(uid=cr.uid, alias=cr.alias, tag=tag)
            cr.recv_waiters[tag].append(waiter)
            return waiter

    def send(self, payload, cr: ChildRank, tag: int = 0, **kwargs) -> None:
        """MPIX_Send: blocking path — a thin wait-on-future wrapper over
        :meth:`isend`.  Waits for the launch so errors surface here; the
        result stays queued for ``recv``."""
        if _active_graph(self) is not None:
            raise RuntimeError("blocking MPIX_Send inside a halo_graph "
                               "capture would deadlock; use MPIX_ISend")
        self.isend(payload, cr, tag=tag, **kwargs).result()

    def recv(self, cr: ChildRank, tag: int = 0, block: bool = True):
        """MPIX_Recv: retrieve the oldest pending result for (cr, tag).

        Always waits for the request's worker execution; ``block=False``
        only skips the final device sync."""
        self._check_live()
        if _active_graph(self) is not None:
            raise RuntimeError("MPIX_Recv inside a halo_graph capture: graph "
                               "results arrive on node futures, not mailboxes")
        with self._lock:
            box = cr.mailboxes[tag]
            if not box:
                raise RuntimeError(
                    f"MPIX_Recv on empty mailbox (cr={cr.uid}, tag={tag})")
            fut = box.popleft()
        out = fut.result()
        if block:
            fut.wait_device()
        return out

    def send_fwd(self, payload, cr: ChildRank, dest: ChildRank,
                 tag: int = 0, **kwargs) -> None:
        """MPIX_SendFwd: like send, but the result is forwarded to ``dest``'s
        mailbox instead of returning to the source PR (device-resident end
        to end — only references move)."""
        self.isend(payload, cr, tag=tag, dest=dest, **kwargs).result()

    def invoke(self, cr: ChildRank, *args, tag: int = 0, **kwargs):
        """Synchronous convenience: send + recv in one call."""
        self.send(tuple(args), cr, tag=tag, **kwargs)
        return self.recv(cr, tag=tag)

    # -- overhead instrumentation (paper T1) -------------------------------------
    def _account_t1(self, dt: float) -> None:
        with self._lock:
            self._t1_seconds += dt
            self._t1_calls += 1

    @property
    def t1_seconds_per_call(self) -> float:
        return self._t1_seconds / max(1, self._t1_calls)

    def reset_t1(self) -> None:
        with self._lock:
            self._t1_seconds = 0.0
            self._t1_calls = 0
