"""C²MPI execution graphs: DAG capture + concurrent dispatch (DESIGN.md §8) —
port of ``repro.core.graph``.

* **Capture** — inside ``halo_graph()`` (or ``MPIX_GraphBegin``/``End``),
  ``MPIX_ISend`` and host-level ``halo_dispatch`` calls record
  :class:`GraphNode` s instead of executing.  Each node doubles as the
  request's :class:`~repro_torch.core.agents.HaloFuture`, so the graph *is*
  the paper's future tree.  Data-dependency edges are inferred from payload
  identity (a node appearing in a later payload) and from internal-buffer
  identity (two stateful nodes sharing a ``BufferHandle`` serialize in
  capture order).
* **Placement** — when a node becomes ready (parents done, their actual
  substrates known), the scheduler scores each feasible record by estimated
  latency + per-substrate backlog + a cross-substrate transfer penalty per
  parent on another agent; without estimates, static preference with
  parent-platform affinity.
* **Execution** — ready nodes are submitted to their placed agent's worker
  queue; after a success one ready child placed on the same agent continues
  inline.  Every node launches on the stream that was current on the thread
  that called :meth:`ExecutionGraph.launch`, so cross-agent edges keep
  stream order, and records a CUDA ready event on its future:
  :meth:`ExecutionGraph.wait` returns once the work is launched and
  ``node.wait_device()`` waits for the card.  A node whose record raises is
  re-placed onto the next feasible record (the failing record is
  quarantined); only when every path fails does the error surface, and
  descendants fail with :class:`GraphDependencyError`.  A hopper record that
  raises on card tensors fails its node at once, as in the DRPC path: a
  request on the card never gives way to a plain version unseen.
  ``cancel()`` cancels every not-yet-started node.
* **Self-healing** (DESIGN.md §11) — every attempt is submitted with a
  replay hook: when its agent is declared DEAD with the attempt queued or
  in flight, the node is re-placed through the same quarantine ladder
  (:meth:`ExecutionGraph._replay_dead`).  With a session
  :class:`~repro_torch.core.agents.HealthMonitor`, an attempt still running
  past ``straggler_multiple`` × its latency estimate (at least
  ``straggler_min_s``) gets one speculative backup on the next-ranked
  platform, or, for a fused node with no other fused record, its member
  chain placed off the straggling platform; the first completion wins and
  only the winner sets the node's result, platform and ready event.  An
  original attempt that fails while its backup runs leaves the node to
  the backup, and one that fails on a DEAD agent leaves it to the replay.  Every such move shows in
  ``node.attempts`` (``"<platform>+spec"``, ``"decomposed+spec"``) and in
  ``node.platform``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .agents import (AgentDeadError, HaloFuture, RuntimeAgent,
                     VirtualizationAgent, _card_device, _graph_capture,
                     _hopper_error, _on_hopper, _record_ready, log)
from .compute_object import ComputeObject, as_compute_object
from .registry import KernelRecord, SelectionError
from .scheduler import abstract_signature

__all__ = [
    "ExecutionGraph", "GraphDependencyError", "GraphError", "GraphNode",
    "begin_capture", "end_capture", "halo_graph",
]


class GraphError(RuntimeError):
    """Base error for execution-graph capture and launch failures."""


class GraphDependencyError(GraphError):
    """A node could not run because an upstream dependency failed."""


class GraphNode(HaloFuture):
    """One captured kernel dispatch: DAG node and request future in one.

    Passing a node inside a later captured payload both wires the
    dependency edge and splices the parent's (future) result into the
    child's arguments at execution time."""

    def __init__(self, uid: int, alias: str, payload: Any,
                 kwargs: Optional[Dict] = None, cr=None,
                 overrides: Optional[Dict] = None,
                 failsafe: Optional[Callable] = None, tag: int = 0):
        super().__init__(uid=uid, alias=alias, tag=tag)
        self.payload = payload
        self.kwargs = dict(kwargs or {})
        self.cr = cr
        self.overrides = dict(overrides or {})
        self.failsafe = failsafe
        self.parents: List["GraphNode"] = []
        self.children: List["GraphNode"] = []
        #: completed-elsewhere dependencies: futures (or nodes of an earlier,
        #: already-launched graph) in the payload; they gate readiness via
        #: done-callbacks instead of executor edges
        self._foreign_deps: List[HaloFuture] = []
        self.platform: Optional[str] = None      # substrate it actually ran on
        self.attempts: List[str] = []            # platforms tried, in order
        self.speculated = False                  # a straggler backup launched
        #: record pre-placed by a CompiledGraph plan (DESIGN.md §12); used
        #: as a fast path in _place while it stays healthy and untried
        self.pinned: Optional[KernelRecord] = None
        #: MemberSpec list when this node is a fused chain — the
        #: decompose-on-failure path replays these unfused (DESIGN.md §12)
        self.fused_members: Optional[List] = None
        #: decomposed chain members are shadow nodes, hidden from ``outputs``
        self._shadow = False
        self._tried: List[KernelRecord] = []     # records tried (failures)
        self._first_exc: Optional[BaseException] = None
        self._pending_parents = 0
        self._winner_claimed = False
        #: a speculative backup (or member chain) is still running; the
        #: original's error waits in ``_deferred`` until it has ended
        self._backup_live = False
        self._deferred: Optional[tuple] = None

    def _claim_win(self) -> bool:
        """Claim the right to complete this node and fire its children;
        False when a cancel or another completion already owns it."""
        with self._cond:
            if self._winner_claimed or self._state in (HaloFuture._DONE,
                                                       HaloFuture._CANCELLED):
                return False
            self._winner_claimed = True
            return True

    def __repr__(self):
        return (f"GraphNode(uid={self.uid}, alias={self.alias!r}, "
                f"parents={[p.uid for p in self.parents]}, "
                f"platform={self.platform!r})")


def _scan_nodes(obj: Any, found: List[HaloFuture]) -> None:
    """Collect future references anywhere in a payload structure."""
    if isinstance(obj, HaloFuture):
        found.append(obj)
    elif isinstance(obj, ComputeObject):
        for v in obj.inputs.values():
            _scan_nodes(v, found)
    elif isinstance(obj, dict):
        for v in obj.values():
            _scan_nodes(v, found)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _scan_nodes(v, found)


def _materialize(obj: Any) -> Any:
    """Substitute completed parents'/foreign futures' results into a
    captured payload."""
    if isinstance(obj, HaloFuture):
        return obj.result(timeout=0)             # dependencies completed by now
    if isinstance(obj, ComputeObject):
        return dataclasses.replace(
            obj, inputs={k: _materialize(v) for k, v in obj.inputs.items()})
    if isinstance(obj, dict):
        return {k: _materialize(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_materialize(v) for v in obj)
    return obj


def _payload_bytes(args: Sequence[Any]) -> int:
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


class ExecutionGraph:
    """A captured DAG of kernel dispatches plus its executor and handle.

    Lifecycle: capture (``record_*`` via the session's isend/dispatch
    hooks) → :meth:`launch` (submit every ready node) → :meth:`wait` /
    per-node futures.  Executor state transitions run under one lock;
    kernels run on the virtualization agents' workers."""

    #: placement-candidate cache entry cap (oldest entries evicted beyond it)
    _CAND_CACHE_MAX = 256

    def __init__(self, session: RuntimeAgent):
        self.session = session
        self.nodes: List[GraphNode] = []
        self._ids: set = set()                   # id() of this graph's nodes
        self._buffer_writers: Dict[int, GraphNode] = {}
        self._lock = threading.Lock()
        self._launched = False
        #: the launching thread's current stream on the session's card
        self._stream: Optional["torch.cuda.Stream"] = None
        #: platform -> estimated seconds of queued graph work (backlog term)
        self._backlog: Dict[str, float] = {}
        #: (alias, sig, allowed, pref, tried uids) -> feasible candidates;
        #: bounded at _CAND_CACHE_MAX, flushed whenever the scheduler's
        #: quarantine epoch moves
        self._cand_cache: Dict[Any, List[KernelRecord]] = {}
        sched = session.scheduler if session is not None else None
        self._cand_epoch = sched.epoch if sched is not None else 0
        #: placement counters (compiled-replay instrumentation, §12)
        self.stats: Dict[str, int] = {"placements_pinned": 0,
                                      "placements_scored": 0}

    # -- capture ---------------------------------------------------------
    def record_isend(self, cr, payload, tag: int = 0,
                     kwargs: Optional[Dict] = None) -> GraphNode:
        node = GraphNode(len(self.nodes) + 1, cr.alias, payload, kwargs,
                         cr=cr, overrides=cr.overrides, failsafe=cr.failsafe,
                         tag=tag)
        self._wire(node)
        # stateful hazard edges: nodes sharing an internal buffer keep
        # capture order (read/write of CR state does not commute)
        for handle in cr.buffers.values():
            prev = self._buffer_writers.get(handle.uid)
            if prev is not None and prev is not node \
                    and all(p is not prev for p in node.parents):
                node.parents.append(prev)
                prev.children.append(node)
            self._buffer_writers[handle.uid] = node
        return node

    def record_dispatch(self, alias: str, args: Tuple, kwargs: Dict,
                        overrides: Optional[Dict]) -> GraphNode:
        overrides = dict(overrides or {})
        node = GraphNode(len(self.nodes) + 1, alias, tuple(args), kwargs,
                         overrides=overrides,
                         failsafe=overrides.get("failsafe"))
        self._wire(node)
        return node

    def add_dependency(self, parent: GraphNode, child: GraphNode) -> None:
        """Explicit hazard edge: ``child`` starts only after ``parent``
        completes, with no data flowing between them.  The collective layer
        serializes successive collectives on one
        :class:`~repro_torch.core.collective.HaloComm` this way (MPI call
        order); host code whose captured calls share a resource the payload
        scan cannot see may use it too.  Duplicate and self edges are
        ignored."""
        if self._launched:
            raise GraphError("graph already launched; begin a new capture")
        if parent is child or any(p is parent for p in child.parents):
            return
        child.parents.append(parent)
        parent.children.append(child)

    def owns(self, node: GraphNode) -> bool:
        """True when ``node`` was recorded in this graph (identity).  The
        collective layer rejects hazard-edge sources from a dead capture
        whose ``id()`` was recycled: a parent outside this graph never
        decrements its child and would hang it."""
        return id(node) in self._ids

    def _wire(self, node: GraphNode) -> None:
        if self._launched:
            raise GraphError("graph already launched; begin a new capture")
        found: List[HaloFuture] = []
        _scan_nodes(node.payload, found)
        for parent in dict.fromkeys(found):      # dedupe, keep order
            if parent is node:
                continue
            if isinstance(parent, GraphNode) and id(parent) in self._ids:
                node.parents.append(parent)
                parent.children.append(node)
            else:
                # a future from outside this graph: gate on its completion
                # at launch instead of wiring an executor edge
                node._foreign_deps.append(parent)
        self.nodes.append(node)
        self._ids.add(id(node))

    # -- handle ----------------------------------------------------------
    @property
    def outputs(self) -> List[GraphNode]:
        """Terminal nodes (no consumers) — the graph's result frontier.
        Shadow nodes (decomposed fused-chain members, §12) are excluded."""
        return [n for n in self.nodes if not n.children and not n._shadow]

    def compile(self, fuse: bool = True):
        """Freeze this captured (unlaunched) graph into a replayable,
        session-cached :class:`~repro_torch.core.fusion.CompiledGraph`,
        running the §12 fusion pass on the way unless ``fuse=False``.
        Capture with ``halo_graph(launch=False)``."""
        from .fusion import compile_graph
        return compile_graph(self, fuse=fuse)

    def placements(self) -> Dict[int, Optional[str]]:
        return {n.uid: n.platform for n in self.nodes}

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        """Block until every output node is launched; returns their results
        in capture order.  Re-raises the first node error.  On the card the
        results are read after ``node.wait_device()`` on the outputs."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for n in self.outputs:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            out.append(n.result(left))
        return out

    def wait_device(self) -> None:
        """Block until every output node's device work has finished."""
        for n in self.outputs:
            n.wait_device()

    def cancel(self) -> int:
        """Cancel every node not yet claimed by a worker; returns count."""
        return sum(1 for n in self.nodes if n.cancel())

    # -- execution ---------------------------------------------------------
    def launch(self) -> "ExecutionGraph":
        with self._lock:
            if self._launched:
                return self
            self._launched = True
            dev = self.session.device
            self._stream = torch.cuda.current_stream(dev) \
                if dev.type == "cuda" else None
            for n in self.nodes:
                n._pending_parents = len(n.parents) + len(n._foreign_deps)
        for n in self.nodes:
            if not n.parents and not n._foreign_deps:
                self._submit(n)
        # foreign futures gate readiness through done-callbacks, registered
        # after the counts above so a racing completion never double-submits
        for n in self.nodes:
            for dep in n._foreign_deps:
                dep.add_done_callback(
                    lambda _fut, node=n: self._parent_done(node))
        return self

    def _parent_done(self, node: GraphNode) -> None:
        """One foreign dependency completed; submit the node when it was
        the last thing holding it back."""
        with self._lock:
            node._pending_parents -= 1
            ready = node._pending_parents == 0
        if ready:
            self._submit(node)

    def _submit(self, node: GraphNode) -> None:
        placed = self._prepare(node)
        if placed is not None:
            self._dispatch_attempt(node, *placed)

    def _prepare(self, node: GraphNode):
        """Materialize + place one ready node; returns the dispatch tuple
        ``(rec, agent, est, args, kwargs)`` or None after failing the node."""
        if node.done():                          # cancelled / failed upstream
            return None
        try:
            args, kwargs = self._node_args(node)
        except Exception as exc:  # noqa: BLE001 — upstream outcome propagates
            self._fail_node(node, GraphDependencyError(
                f"node {node.uid} ({node.alias}): dependency failed: {exc}"))
            return None
        try:
            rec, agent, est = self._place(node, args)
        except Exception as exc:  # noqa: BLE001 — SelectionError et al.
            if node.fused_members and self._decompose_fused(node, args, exc):
                return None                      # members run instead (§12)
            self._fail_node(node, exc)
            return None
        return rec, agent, est, args, kwargs

    def _node_args(self, node: GraphNode) -> Tuple[Tuple, Dict]:
        payload = _materialize(node.payload)
        if node.cr is not None:                  # isend-captured: C²MPI path
            co = as_compute_object(payload)
            args = tuple(co.inputs[k] for k in sorted(co.inputs))
            kwargs = dict(node.kwargs)
            kwargs.update(co.meta)
            return args, kwargs
        return tuple(payload), dict(node.kwargs)

    def _place(self, node: GraphNode, args: Tuple, hopper_only: bool = False
               ) -> Tuple[Optional[KernelRecord], VirtualizationAgent, float]:
        """Pick (record, agent, estimate) for one ready node.

        Returns ``record=None`` for the claim-level failsafe callback.
        Raises SelectionError when nothing can run the node.
        ``hopper_only`` offers the node's hopper records alone (the local
        row, a worker's clone), and no fail-safe."""
        sess = self.session
        overrides = node.overrides
        sched = sess.scheduler
        sig = abstract_signature(args)
        # compiled-replay fast path (§12): the plan's pinned record while it
        # is healthy, untried, feasible, and its agent is up
        pinned = node.pinned
        if pinned is not None and all(pinned is not r for r in node._tried) \
                and (_on_hopper(pinned) or not hopper_only) \
                and (sched is None or not sched.is_failed(pinned)) \
                and pinned.feasible(*args):
            agent = sess._agent_for(pinned)
            if agent is not None:
                est = (sched.estimate(pinned, sig, args) or 0.0) \
                    if sched is not None else 0.0
                self.stats["placements_pinned"] += 1
                return pinned, agent, est
        self.stats["placements_scored"] += 1
        allowed_ov = overrides.get("allowed_platforms")
        pref_ov = overrides.get("platform_preference")
        # tried records key by uid, never id(): a cache entry can outlive a
        # deregistered record whose id() is then reused
        key = (node.alias, sig, tuple(allowed_ov) if allowed_ov else None,
               tuple(pref_ov) if pref_ov else None,
               tuple(r.uid for r in node._tried))
        with self._lock:
            if sched is not None and sched.epoch != self._cand_epoch:
                # quarantine state moved mid-graph: cached lists may over-
                # or under-offer records
                self._cand_cache.clear()
                self._cand_epoch = sched.epoch
            cands = self._cand_cache.get(key)
        if cands is None:
            allowed = allowed_ov or sess._allowed_platforms()
            pref = pref_ov or sess._platform_preference()
            try:
                cands = sess.registry.candidates(
                    node.alias, *args, allowed_platforms=allowed,
                    platform_preference=pref, exclude=node._tried)
            except SelectionError:
                cands = []
            with self._lock:
                while len(self._cand_cache) >= self._CAND_CACHE_MAX:
                    self._cand_cache.pop(next(iter(self._cand_cache)))
                self._cand_cache[key] = cands
        if sched is not None and cands:
            # filter at use time: a record quarantined after this key was
            # cached must stop being offered at once
            cands = [c for c in cands if not sched.is_failed(c)]
        if hopper_only:
            cands = [c for c in cands if _on_hopper(c)]
        parent_platforms = [p.platform for p in node.parents]
        rec: Optional[KernelRecord] = None
        est = 0.0
        if sched is not None and len(cands) == 1:
            rec = cands[0]
            est = sched.estimate(rec, sig, args) or 0.0
        elif sched is not None and cands:
            with self._lock:
                backlog = dict(self._backlog)
            rec = sched.place(node.alias, cands, args,
                              parent_platforms=parent_platforms,
                              payload_bytes=_payload_bytes(args),
                              backlog=backlog)
            if rec is not None:
                est = sched.estimate(rec, sig, args) or 0.0
        if rec is None and cands:
            # no estimates: static preference with parent-platform affinity
            for p in parent_platforms:
                rec = next((c for c in cands if c.platform == p), None)
                if rec is not None:
                    break
            rec = rec or cands[0]
        if rec is None and not hopper_only:
            fs = sess.registry.failsafe(node.alias)
            if fs is not None and all(fs is not r for r in node._tried):
                rec = fs
        if rec is None:
            if node.failsafe is not None and not hopper_only:
                return None, sess.agents["torch"], 0.0
            raise SelectionError(
                f"graph node {node.uid}: no feasible record for "
                f"{node.alias!r} and no fail-safe")
        agent = sess._agent_for(rec) or sess.agents["torch"]
        return rec, agent, est

    def _dispatch_attempt(self, node: GraphNode, rec: Optional[KernelRecord],
                          agent: VirtualizationAgent, est: float,
                          args: Tuple, kwargs: Dict) -> None:
        with self._lock:
            self._backlog[agent.platform] = \
                self._backlog.get(agent.platform, 0.0) + est
        node.attempts.append(rec.platform if rec is not None else "failsafe")
        internal = HaloFuture(uid=node.uid, alias=node.alias, tag=node.tag)
        # one-element chain cell shared with the replay hook: inline child
        # continuations rebind it, so a DEAD declaration replays whichever
        # node of the chain the wedged worker was actually running
        item = [(node, rec, est, args, kwargs)]
        try:
            agent.submit(lambda: self._run(item, agent), future=internal,
                         replay=lambda: self._replay_dead(item, agent))
        except Exception as exc:  # noqa: BLE001 — agent shut down or dead
            self._backlog_sub(agent.platform, est)
            self._fail_node(node, exc)

    def _replay_dead(self, item: List[tuple],
                     agent: VirtualizationAgent) -> None:
        """Recovery hook (DESIGN.md §11): ``agent`` was declared DEAD with
        this attempt still queued or in flight.  ``item`` is the chain cell
        shared with :meth:`_run` — it names the node the wedged worker was
        on (the original submission or an inline child continuation).
        Re-place it through the quarantine ladder so it lands on a healthy
        agent; an in-flight attempt may still be hung on the dead worker,
        and the replay races it (first completion wins).  A dead agent is
        not a failing record: the card rule of :meth:`_run` does not apply,
        and the move shows in ``node.attempts``."""
        node, rec, est, args, kwargs = item[0]
        self._backlog_sub(agent.platform, est)
        if node.done():
            return
        self._retry_or_fail(node, rec, args, kwargs, AgentDeadError(
            f"agent {agent.name} died before node {node.uid} "
            f"({node.alias}) completed"))

    def _execute(self, node: GraphNode, rec: Optional[KernelRecord],
                 agent: VirtualizationAgent, args: Tuple, kwargs: Dict):
        """Launch one attempt of ``node`` on the launching thread's stream,
        after its foreign dependencies' events; returns the result and the
        ready event recorded after it.  The caller sets ``node._ready`` only
        if this attempt wins the node: a losing (speculated) attempt must
        not overwrite the winner's event."""
        with torch.cuda.stream(self._stream):
            for dep in node._foreign_deps:       # work queued elsewhere
                if dep._ready is not None and self._stream is not None:
                    self._stream.wait_event(dep._ready)
            if rec is None:
                out = node.failsafe(*args, **kwargs)
            else:
                out = self.session._execute_on(agent, rec, node.cr, args,
                                               kwargs)
            return out, _record_ready(out)

    def _run(self, item: List[tuple], agent: VirtualizationAgent) -> None:
        """Worker-side body of node attempts (runs on ``agent``'s worker).

        After a success, one ready child placed on the *same* agent
        continues inline — a dependent chain runs back-to-back on its
        substrate without a queue round trip per node; children placed on
        other agents are enqueued there (that is the overlap)."""
        sess = self.session
        while True:
            node, rec, est, args, kwargs = item[0]
            token = None
            try:
                # the first attempt claims the node (refusing a queued
                # cancel); re-placement and replay attempts arrive already
                # RUNNING; a node completed meanwhile has nothing left to do
                if not node._try_start() and not node.running():
                    self._backlog_sub(agent.platform, est)
                    return                       # cancelled or completed
                t0 = time.perf_counter()
                token = self._watch_straggler(node, rec, agent, est,
                                              args, kwargs)
                out, ready = self._execute(node, rec, agent, args, kwargs)
            except Exception as exc:  # noqa: BLE001 — re-place or surface
                self._unwatch(token)
                self._backlog_sub(agent.platform, est)
                # lost a speculation race, or the agent was declared DEAD
                # and its replay hook already owns the node
                if node.done() or agent.dead:
                    return
                with self._lock:
                    if node._backup_live:        # the backup settles it
                        node._deferred = (rec, args, kwargs, exc)
                        return
                self._attempt_failed(node, rec, args, kwargs, exc)
                return
            self._unwatch(token)
            self._backlog_sub(agent.platform, est)
            if not node._claim_win():            # cancelled or a backup won
                return
            node.platform = rec.platform if rec is not None else agent.platform
            node._ready = ready
            node.set_result(out)
            # sample before child placement, so the window matches the DRPC
            # path's (launch + device sync only)
            if rec is not None and sess.scheduler is not None:
                sig = abstract_signature(args)
                if sess.scheduler.wants_sample(rec, sig):
                    node.wait_device()
                    sess.scheduler.observe(rec, sig, time.perf_counter() - t0)
            ready_children: List[GraphNode] = []
            with self._lock:
                for child in node.children:
                    child._pending_parents -= 1
                    if child._pending_parents == 0:
                        ready_children.append(child)
            nxt = None
            for child in ready_children:
                placed = self._prepare(child)
                if placed is None:
                    continue
                c_rec, c_agent, c_est, c_args, c_kwargs = placed
                if nxt is None and c_agent is agent:
                    child.attempts.append(
                        c_rec.platform if c_rec is not None else "failsafe")
                    nxt = (child, c_rec, 0.0, c_args, c_kwargs)   # inline
                else:
                    self._dispatch_attempt(child, c_rec, c_agent, c_est,
                                           c_args, c_kwargs)
            if nxt is None:
                return
            # never queued: no backlog entry (est 0); rebind the shared chain
            # cell so a DEAD replay targets the child the worker runs next
            item[0] = nxt

    def _attempt_failed(self, node: GraphNode, rec: Optional[KernelRecord],
                        args: Tuple, kwargs: Dict, exc: BaseException) -> None:
        card = _card_device(args) is not None
        if card and _hopper_error(rec, exc):
            # as in RuntimeAgent._execute_record: a kernel's build or launch
            # error on the card surfaces unquarantined, and a lost worker's
            # hopper clone re-places onto hopper records only
            self._fail_node(node, exc)
            return
        self._retry_or_fail(node, rec, args, kwargs, exc,
                            hopper_only=card and _on_hopper(rec))

    def _backup_ended(self, node: GraphNode) -> None:
        """A speculative backup finished, won or lost.  An original attempt
        that failed while it ran handed its error over: settle it now,
        unless the node was completed meanwhile."""
        with self._lock:
            node._backup_live = False
            deferred, node._deferred = node._deferred, None
        if deferred is not None and not node.done():
            self._attempt_failed(node, *deferred)

    def _backlog_sub(self, platform: str, est: float) -> None:
        if est:
            with self._lock:
                self._backlog[platform] = \
                    max(0.0, self._backlog.get(platform, 0.0) - est)

    # -- straggler speculation (DESIGN.md §11) ----------------------------
    def _watch_straggler(self, node: GraphNode, rec: Optional[KernelRecord],
                         agent: VirtualizationAgent, est: float,
                         args: Tuple, kwargs: Dict) -> Optional[int]:
        """Arm a deadline on the session's HealthMonitor before executing:
        if the attempt is still running past ``straggler_multiple ×`` its
        latency estimate (floored at ``straggler_min_s``), a backup attempt
        launches on the next-ranked platform.  Returns the watch token
        (None when no monitor is wired or speculation is off)."""
        mon = self.session.health
        if mon is None or rec is None or node.speculated:
            return None
        cfg = mon.config
        if not cfg.straggler_multiple:
            return None
        budget = max(est * cfg.straggler_multiple, cfg.straggler_min_s)
        return mon.watch(
            time.monotonic() + budget,
            lambda: self._speculate(node, rec, agent, args, kwargs))

    def _unwatch(self, token: Optional[int]) -> None:
        mon = self.session.health
        if token is not None and mon is not None:
            mon.unwatch(token)

    def _backup_for(self, node: GraphNode, rec: KernelRecord, args: Tuple
                    ) -> Optional[Tuple[KernelRecord, VirtualizationAgent]]:
        """(record, agent) for a speculative backup attempt: the scheduler's
        best-ranked candidate on a different platform, falling back to the
        registry fail-safe for member-pinned nodes (their allowed set is a
        single — straggling — platform)."""
        sess = self.session
        sched = sess.scheduler
        if sched is None:
            return None
        allowed = node.overrides.get("allowed_platforms") \
            or sess._allowed_platforms()
        pref = node.overrides.get("platform_preference") \
            or sess._platform_preference()
        try:
            cands = sess.registry.candidates(
                node.alias, *args, allowed_platforms=allowed,
                platform_preference=pref, exclude=node._tried)
        except SelectionError:
            cands = []
        backup = sched.backup_candidate(node.alias, cands, args,
                                        exclude_platforms=(rec.platform,))
        if backup is None:
            fs = sess.registry.failsafe(node.alias)
            if fs is not None and fs.platform != rec.platform \
                    and all(fs is not r for r in node._tried):
                backup = fs
        if backup is None:
            return None
        b_agent = sess._agent_for(backup)
        if b_agent is None:
            return None
        return backup, b_agent

    def _speculate(self, node: GraphNode, rec: KernelRecord,
                   agent: VirtualizationAgent, args: Tuple,
                   kwargs: Dict) -> bool:
        """Launch one backup attempt for a straggling node.  The original
        keeps running — first completion wins (:meth:`GraphNode._claim_win`);
        the loser's result is discarded, and a backup still queued when the
        original finishes is cancelled outright."""
        if node.done() or node.speculated:
            return False
        backup = self._backup_for(node, rec, args)
        if backup is None:
            # no second fused record to race — decompose instead: the member
            # chain is the natural backup (§12), placed off the straggler's
            # platform, and the straggling fused attempt still races it
            return bool(node.fused_members) and self._decompose_fused(
                node, args, None, straggler=agent.platform)
        b_rec, b_agent = backup
        if b_agent is agent:             # would queue behind the straggler
            return False
        node.speculated = True
        node._backup_live = True
        node.attempts.append(f"{b_rec.platform}+spec")
        fut = HaloFuture(uid=node.uid, alias=node.alias, tag=node.tag)
        node.add_done_callback(lambda _f: fut.cancel())
        try:
            b_agent.submit(
                lambda: self._run_backup(node, b_rec, b_agent, args, kwargs),
                future=fut)
        except Exception:  # noqa: BLE001 — backup agent gone; keep original
            self._backup_ended(node)
            return False
        log.warning("graph node %d (%s): straggling on %s; speculating "
                    "on %s", node.uid, node.alias, agent.platform,
                    b_rec.platform)
        return True

    def _run_backup(self, node: GraphNode, rec: KernelRecord,
                    agent: VirtualizationAgent, args: Tuple,
                    kwargs: Dict) -> None:
        """Worker-side body of a speculative backup attempt, launched like
        any attempt (:meth:`_execute`: the graph's stream, after the
        foreign dependencies).  A backup that fails stays silent — the
        original attempt still owns the node and its quarantine ladder."""
        try:
            if node.done():
                return
            try:
                out, ready = self._execute(node, rec, agent, args, kwargs)
            except Exception:  # noqa: BLE001 — speculative: never surfaces
                log.warning("speculative attempt for node %d (%s) on %s "
                            "failed; original attempt still owns the node",
                            node.uid, node.alias, rec.platform, exc_info=True)
                return
            if node._claim_win():
                node.platform = rec.platform
                node._ready = ready
                node.set_result(out)
                self._fire_children(node)
        finally:
            self._backup_ended(node)

    def _fire_children(self, node: GraphNode) -> None:
        """Decrement children's readiness after an out-of-band completion
        (a speculative win or a decomposed chain's tail) and submit the
        ready ones — the counterpart of the inline child scheduling in
        :meth:`_run`."""
        ready: List[GraphNode] = []
        with self._lock:
            for child in node.children:
                child._pending_parents -= 1
                if child._pending_parents == 0:
                    ready.append(child)
        for child in ready:
            self._submit(child)

    def _retry_or_fail(self, node: GraphNode, rec: Optional[KernelRecord],
                       args: Tuple, kwargs: Dict, exc: BaseException,
                       hopper_only: bool = False) -> None:
        # the *original* error surfaces after every re-placement path fails
        node._first_exc = node._first_exc or exc
        if rec is not None:
            node._tried.append(rec)
            self.session._record_failure(rec, exc)
            log.warning("graph node %d (%s): attempt on %s failed; re-placing",
                        node.uid, node.alias, rec.platform)
            try:
                rec2, agent2, est2 = self._place(node, args, hopper_only)
            except Exception:  # noqa: BLE001 — nothing left to try
                pass
            else:
                self._dispatch_attempt(node, rec2, agent2, est2, args, kwargs)
                return
        if node.fused_members and not hopper_only \
                and self._decompose_fused(node, args, exc):
            return                               # members run instead (§12)
        self._fail_node(node, node._first_exc)

    def _decompose_fused(self, node: GraphNode, args: Tuple,
                         exc: Optional[BaseException],
                         straggler: Optional[str] = None) -> bool:
        """§12 failure fallback: replay a failed fused node as its member
        chain — bit-identical to never having fused, because the members
        *are* the captured kernels with the captured arguments.  Members are
        appended as shadow nodes; the tail's completion completes the fused
        node and fires its children.

        With ``straggler`` (the platform of a still-running fused attempt)
        the chain is a speculative backup: its members are placed off that
        platform, since behind the straggler they could never win (no chain
        when the node allows no other platform); a member failure stays
        silent, as a backup's does; and the members not yet started are
        cancelled once the node completes either way."""
        members = node.fused_members
        if not members or node.done():
            return False
        overrides = node.overrides
        if straggler is not None:
            sess = self.session
            allowed = [p for p in (overrides.get("allowed_platforms")
                                   or sess._allowed_platforms())
                       if p != straggler]
            if not allowed:
                return False
            pref = [p for p in (overrides.get("platform_preference")
                                or sess._platform_preference() or ())
                    if p != straggler]
            overrides = dict(overrides, allowed_platforms=allowed,
                             platform_preference=pref)
            node.speculated = True
            node._backup_live = True
        node.attempts.append("decomposed" if straggler is None
                             else "decomposed+spec")
        log.warning("graph node %d (%s): decomposing into %d member "
                    "node(s)%s", node.uid, node.alias, len(members),
                    "" if straggler is None
                    else f" (speculative, off {straggler})")
        sub: List[GraphNode] = []
        with self._lock:
            base = len(self.nodes)
            prev: Optional[GraphNode] = None
            for j, m in enumerate(members):
                # "chain" in an argmap means the previous member's output
                payload = tuple(prev if s == "chain" else args[s]
                                for s in m.argmap)
                child = GraphNode(base + j + 1, m.alias, payload,
                                  dict(m.kwargs), overrides=overrides)
                child._shadow = True
                if prev is not None:
                    child.parents.append(prev)
                    prev.children.append(child)
                    child._pending_parents = 1
                self.nodes.append(child)
                self._ids.add(id(child))
                sub.append(child)
                prev = child
        tail = sub[-1]

        def _finish(fut: HaloFuture) -> None:
            tail_exc = GraphError(
                f"decomposed chain for node {node.uid} ({node.alias}) was "
                f"cancelled") if fut.cancelled() else fut.exception(timeout=0)
            if tail_exc is None:
                if node._claim_win():
                    node.platform = tail.platform
                    node._ready = tail._ready
                    node.set_result(fut.result(timeout=0))
                    self._fire_children(node)
            elif straggler is None:
                self._fail_node(node, node._first_exc or exc or tail_exc)
            if straggler is not None:
                self._backup_ended(node)

        tail.add_done_callback(_finish)
        if straggler is not None:
            node.add_done_callback(lambda _f: [m.cancel() for m in sub])
        self._submit(sub[0])
        return True

    def _fail_node(self, node: GraphNode, exc: BaseException) -> None:
        if not node._claim_win():
            return                               # completed elsewhere
        node.set_exception(exc)
        self._fail_descendants(node, exc)

    def _fail_descendants(self, node: GraphNode, exc: BaseException) -> None:
        for child in node.children:
            if child.done():
                continue
            child.set_exception(GraphDependencyError(
                f"node {child.uid} ({child.alias}): upstream node "
                f"{node.uid} ({node.alias}) failed: {exc}"))
            self._fail_descendants(child, exc)


# ---------------------------------------------------------------------------
# Capture API (MPIX_GraphBegin / MPIX_GraphEnd / halo_graph)
# ---------------------------------------------------------------------------
def begin_capture(session: RuntimeAgent) -> ExecutionGraph:
    """Start capturing ``session``'s isend/dispatch calls on this thread
    into a fresh :class:`ExecutionGraph`; raises if one is already active."""
    if getattr(_graph_capture, "graph", None) is not None:
        raise GraphError("a graph capture is already active on this thread")
    g = ExecutionGraph(session)
    _graph_capture.graph = g
    return g


def end_capture(launch: bool = True) -> ExecutionGraph:
    """Stop the active capture; ``launch=True`` (default) dispatches the
    DAG immediately.  Returns the graph; raises if no capture is active."""
    g = getattr(_graph_capture, "graph", None)
    if g is None:
        raise GraphError("no active graph capture on this thread")
    _graph_capture.graph = None
    if launch:
        g.launch()
    return g


@contextlib.contextmanager
def halo_graph(session: Optional[RuntimeAgent] = None, launch: bool = True):
    """Capture every ``MPIX_ISend``/``halo_dispatch`` in the block into one
    execution graph, launched on exit (``launch=False`` defers to an
    explicit ``g.launch()`` or ``g.compile()``).  Yields the
    :class:`ExecutionGraph`:

        with halo_graph() as g:
            t = MPIX_ISend((a, b), cr_ewmm)
            m = MPIX_ISend((t, w), cr_mmm)     # depends on t by identity
        out = g.wait()                         # launched results
    """
    if session is None:
        from .c2mpi import halo_session
        session = halo_session()
    g = begin_capture(session)
    ok = False
    try:
        yield g
        ok = True
    finally:
        _graph_capture.graph = None
        if ok and launch:
            g.launch()
