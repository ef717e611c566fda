"""C²MPI collective verbs over device groups of virtualization agents
(DESIGN.md §10) — port of ``repro.core.collective``.

* :class:`HaloComm` — a *device group*: an ordered list of member ranks,
  each bound to one registered virtualization agent (substrate) of the
  session.  ``MPIX_CommSplit`` creates one.  Ranks are roles, agents are
  resources: one substrate may hold several ranks, and the group lives in
  one process (no ``torch.distributed``).
* **Collective verbs** — ``bcast`` / ``reduce`` / ``allreduce`` /
  ``scatter`` / ``gather`` / ``allgather`` plus non-blocking ``i*``
  variants returning :class:`~repro_torch.core.agents.HaloFuture` s, and
  ``map``/``imap`` for the member compute between collectives.

Every collective is built from ordinary registry dispatches — ``COPY``
stages (bcast fan-out, one per member queue), ``CONCAT`` combines
(gather), and element-wise kernels for the reduce step (``sum`` →
``EWADD``, ``prod`` → ``EWMM``, or any registered binary alias) — wired
into an :class:`~repro_torch.core.graph.ExecutionGraph`:

* **eager** (no active capture): the collective records its nodes into a
  private graph and launches it at once; blocking verbs wait (launch, then
  the device through the node's ready event), ``i*`` verbs hand back the
  node futures.
* **captured** (inside ``halo_graph()``): the same nodes join the ambient
  graph as multi-parent DAG nodes; successive collectives on one comm get
  explicit hazard edges (MPI call order) via
  :meth:`ExecutionGraph.add_dependency`.

Member stages are plain graph nodes, so reduce combines are placed by the
cost-model scheduler on the fastest member
(:meth:`CostModelScheduler.rank_platforms` seeds the static order), and a
member whose record fails mid-collective off the card is quarantined and
its work re-placed (registry fail-safe last) — the collective still
completes.  A hopper record that raises on card tensors fails its node, as
everywhere in the port.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .agents import HaloFuture, RuntimeAgent, _active_graph, log
from .graph import ExecutionGraph, GraphError, GraphNode
from .registry import PLATFORM_PREFERENCE

__all__ = ["HaloComm", "REDUCE_OPS", "comm_split"]

#: the fail-safe substrate: every alias has a row on it
FAILSAFE_PLATFORM = "torch"

#: reduce-op name -> registry alias of the binary combine kernel.  Any
#: registered binary alias may also be passed directly as ``op``.
REDUCE_OPS: Dict[str, str] = {"sum": "EWADD", "prod": "EWMM"}

NodeOrValue = Union[GraphNode, Any]


def comm_split(session: RuntimeAgent,
               platforms: Optional[Sequence[str]] = None,
               name: Optional[str] = None) -> "HaloComm":
    """Build a :class:`HaloComm` over ``session``'s registered agents.

    ``platforms`` lists the member substrates in rank order (a platform may
    appear more than once).  The default takes every *available*
    accelerator substrate in preference order, falling back to the
    ``torch`` fail-safe agent alone."""
    if platforms is None:
        pref = session._platform_preference() or PLATFORM_PREFERENCE
        platforms = [p for p in pref
                     if p != FAILSAFE_PLATFORM and p in session._allowed_platforms()]
        platforms = platforms or [FAILSAFE_PLATFORM]
    return HaloComm(session, platforms, name=name)


class HaloComm:
    """A C²MPI device group: ordered member ranks over virtualization agents.

    The comm is a lightweight handle — it owns no buffers and no workers;
    collectives execute on the member agents' existing queues.  One comm
    may be used from several host threads (each collective is wired
    independently), but MPI's call-order guarantee holds only within one
    thread / one capture region."""

    def __init__(self, session: RuntimeAgent, platforms: Sequence[str],
                 name: Optional[str] = None):
        if not platforms:
            raise ValueError("a device group needs at least one member")
        self._validate_platforms(session, platforms)
        self.session = session
        self._platforms: List[str] = list(platforms)
        self._epoch = 0
        self.name = name or f"comm({','.join(platforms)})"
        self.freed = False
        self._lock = threading.Lock()
        # per-captured-graph tail nodes for call-order hazard edges; keyed
        # by the graph object's id, pruned when another graph shows up
        # (captures are thread-local and short-lived)
        self._tails: Dict[int, List[GraphNode]] = {}

    @staticmethod
    def _validate_platforms(session: RuntimeAgent,
                            platforms: Sequence[str]) -> None:
        unknown = [p for p in platforms if p not in session.agents]
        if unknown:
            raise ValueError(
                f"no virtualization agent registered for platform(s) "
                f"{unknown}; have {sorted(session.agents)}")
        unavailable = [p for p in platforms
                       if not session.agents[p].available()]
        if unavailable:
            raise ValueError(
                f"member platform(s) {unavailable} are registered but not "
                f"available")

    # -- introspection -------------------------------------------------------
    @property
    def platforms(self) -> Tuple[str, ...]:
        """Per-rank member bindings, in rank order (snapshot)."""
        with self._lock:
            return tuple(self._platforms)

    @property
    def members(self) -> Tuple[str, ...]:
        """Distinct member substrates, first-rank order."""
        with self._lock:
            return tuple(dict.fromkeys(self._platforms))

    @property
    def epoch(self) -> int:
        """Membership-change counter: bumps on every remove/add/re-bind.
        Host loops that carry per-rank state compare it across iterations
        and :meth:`repartition` when it moved."""
        with self._lock:
            return self._epoch

    @property
    def size(self) -> int:
        """Number of member ranks."""
        return len(self.platforms)

    def __len__(self) -> int:
        return self.size

    def __repr__(self):
        return f"HaloComm({self.name!r}, platforms={list(self.platforms)})"

    def free(self) -> None:
        """Release the group handle.  Idempotent; in-flight collectives
        complete normally (members own the execution resources)."""
        self.freed = True

    # -- elastic membership (DESIGN.md §11) -----------------------------------
    def _survivors(self, losing: Sequence[str]) -> List[str]:
        """Distinct still-available member substrates after ``losing`` ones
        leave, in first-rank order; falls back to any live session agent
        (fail-safe first) when every member substrate is gone."""
        out = [p for p in dict.fromkeys(self._platforms)
               if p not in losing and self.session.agents[p].available()]
        if out:
            return out
        fs = self.session.agents.get(FAILSAFE_PLATFORM)
        if fs is not None and fs.available() and FAILSAFE_PLATFORM not in losing:
            return [FAILSAFE_PLATFORM]
        return [p for p, a in self.session.agents.items()
                if a.available() and p not in losing]

    def remove_member(self, platform: Optional[str] = None,
                      rank: Optional[int] = None,
                      shrink: bool = False) -> Tuple[str, ...]:
        """Take a substrate (every rank bound to ``platform``) or a single
        ``rank`` out of the group.  By default the freed ranks are
        **re-bound** round-robin onto the surviving member substrates: the
        logical group size and shard layout are unchanged, so an in-flight
        iterative solver keeps producing the same results.  With
        ``shrink=True`` the ranks are dropped instead (carry per-rank state
        across with :meth:`repartition`).  Returns the new binding."""
        if (platform is None) == (rank is None):
            raise ValueError("pass exactly one of platform= or rank=")
        with self._lock:
            if rank is not None:
                if not 0 <= rank < len(self._platforms):
                    raise ValueError(
                        f"rank {rank} out of range for "
                        f"{len(self._platforms)}-member group")
                affected = [rank]
                losing = [self._platforms[rank]]
            else:
                affected = [r for r, p in enumerate(self._platforms)
                            if p == platform]
                if not affected:
                    raise ValueError(
                        f"platform {platform!r} holds no rank in {self.name}")
                losing = [platform]
            if shrink:
                if len(affected) == len(self._platforms):
                    raise ValueError(
                        f"cannot shrink {self.name} to zero members")
                self._platforms = [p for r, p in enumerate(self._platforms)
                                   if r not in affected]
            else:
                survivors = self._survivors(losing)
                if not survivors:
                    raise RuntimeError(
                        f"{self.name}: no live agent left to absorb "
                        f"rank(s) {affected}")
                for i, r in enumerate(affected):
                    self._platforms[r] = survivors[i % len(survivors)]
            self._epoch += 1
            return tuple(self._platforms)

    def add_member(self, platform: str,
                   rank: Optional[int] = None) -> Tuple[str, ...]:
        """Bring a substrate into the group: with ``rank=None`` a new rank
        is appended (the group grows — :meth:`repartition` carried state
        over the new size); with an existing ``rank`` that role is re-bound
        onto ``platform`` (size unchanged)."""
        self._check_live()
        self._validate_platforms(self.session, [platform])
        with self._lock:
            if rank is None:
                self._platforms.append(platform)
            else:
                if not 0 <= rank < len(self._platforms):
                    raise ValueError(
                        f"rank {rank} out of range for "
                        f"{len(self._platforms)}-member group")
                self._platforms[rank] = platform
            self._epoch += 1
            return tuple(self._platforms)

    def on_member_dead(self, platform: str) -> bool:
        """Callback for a member agent declared dead: re-bind its ranks
        onto survivors (:meth:`remove_member`'s default policy) so in-flight
        and future collectives complete without it.  No-op for freed comms
        and non-members; returns whether a re-bind happened."""
        if self.freed:
            return False
        with self._lock:
            if platform not in self._platforms:
                return False
        self.remove_member(platform=platform)
        log.warning("comm %s: member %s died; ranks re-bound -> %s",
                    self.name, platform, list(self.platforms))
        return True

    def repartition(self, shards: Sequence[NodeOrValue],
                    axis: int = 0) -> List[Any]:
        """Re-split carried per-rank state over the *current* group size
        after an elastic resize (:func:`repro_torch.distributed.sharding.
        repartition_shards`): pass the old layout's shards (tensors or
        completed futures), get one shard per current rank back."""
        self._check_live()
        from ..distributed.sharding import repartition_shards
        arrs = [self._concrete(s, "repartition") for s in shards]
        return list(repartition_shards(arrs, self.size, axis=axis))

    # -- wiring ---------------------------------------------------------------
    def _check_live(self) -> None:
        if self.freed:
            raise RuntimeError(f"{self.name} was freed")
        self.session._check_live()

    def _check_rank(self, rank: int) -> None:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for {self.size}-"
                             f"member group")

    def _member_overrides(self, rank: int) -> Dict[str, Any]:
        p = self.platforms[rank]
        return {"allowed_platforms": [p], "platform_preference": [p]}

    def _group_overrides(self, alias: str, args: Sequence[Any]
                         ) -> Dict[str, Any]:
        """Overrides for a combine node: any member platform may run it;
        the preference order is the scheduler's fastest-first member
        ranking (static member order when nothing is measured yet)."""
        plats = list(dict.fromkeys(self.platforms))
        pref = plats
        sched = self.session.scheduler
        if sched is not None:
            try:
                cands = self.session.registry.candidates(
                    alias, *args, allowed_platforms=plats,
                    platform_preference=plats)
                ranked = sched.rank_platforms(alias, cands, args)
            except Exception:        # advisory ranking must never break
                ranked = []
            if ranked:
                pref = ranked + [p for p in plats if p not in ranked]
        return {"allowed_platforms": plats, "platform_preference": pref}

    def _graph(self) -> Tuple[ExecutionGraph, bool]:
        """The ambient captured graph (shared) or a fresh private one."""
        g = _active_graph(self.session)
        if g is not None:
            return g, True
        return ExecutionGraph(self.session), False

    def _seal(self, g: ExecutionGraph, captured: bool,
              roots: Sequence[GraphNode],
              tails: Sequence[GraphNode]) -> None:
        """Finish one collective's wiring: inside a capture, serialize it
        after the comm's previous collective on the same graph (hazard
        edges from the previous tails to this one's roots); eager, launch
        the private graph at once."""
        if captured:
            with self._lock:
                stale = [k for k in self._tails if k != id(g)]
                for k in stale:
                    del self._tails[k]
                prevs = self._tails.get(id(g), ())
                # id() values recycle: a fresh capture can land on the
                # address of a dead graph whose entry survived the sweep
                # above, and wiring its tails would give this graph parents
                # that completed elsewhere and never decrement — a hang.
                # Only tails recorded in *this* graph are hazard sources.
                if any(not g.owns(p) for p in prevs):
                    prevs = ()
                for prev in prevs:
                    for root in roots:
                        g.add_dependency(prev, root)
                self._tails[id(g)] = list(tails)
        else:
            g.launch()

    def _node(self, g: ExecutionGraph, alias: str, args: Sequence[Any],
              overrides: Dict[str, Any],
              kwargs: Optional[Dict] = None) -> GraphNode:
        return g.record_dispatch(alias, tuple(args), dict(kwargs or {}),
                                 overrides)

    @staticmethod
    def _concrete(x: NodeOrValue, verb: str) -> Any:
        """Collectives that slice their payload on the host (scatter) need a
        concrete tensor: a pending node's value does not exist yet.
        Completed futures unwrap (after their device work); live ones are
        an error."""
        if isinstance(x, HaloFuture):
            if not x.done():
                raise GraphError(
                    f"{verb} needs a concrete payload; inside a graph "
                    f"capture move the {verb} before the capture region "
                    f"(bcast/gather/reduce accept node payloads)")
            out = x.result()
            x.wait_device()
            return out
        return x

    def _per_rank(self, values: Sequence[NodeOrValue],
                  verb: str) -> List[NodeOrValue]:
        values = list(values)
        if len(values) != self.size:
            raise ValueError(
                f"{verb} expects one value per member rank "
                f"({self.size}), got {len(values)}")
        return values

    # -- non-blocking collectives ---------------------------------------------
    def ibcast(self, x: NodeOrValue, root: int = 0) -> List[GraphNode]:
        """Fan ``x`` (the root's value — a tensor or a captured node) out to
        every member: one ``COPY`` stage per member agent queue.  Returns
        the per-rank node futures."""
        self._check_live()
        self._check_rank(root)
        g, captured = self._graph()
        nodes = [self._node(g, "COPY", (x,), self._member_overrides(r))
                 for r in range(self.size)]
        self._seal(g, captured, roots=nodes, tails=nodes)
        return nodes

    def iscatter(self, x: NodeOrValue, root: int = 0,
                 axis: int = 0) -> List[GraphNode]:
        """Split ``x`` along ``axis`` into ``size`` equal shards and stage
        shard *r* onto member *r*'s agent
        (:func:`repro_torch.distributed.sharding.member_shard`)."""
        self._check_live()
        self._check_rank(root)
        from ..distributed.sharding import member_shard
        x = torch.as_tensor(self._concrete(x, "scatter"))
        shards = [member_shard(x, r, self.size, axis=axis)
                  for r in range(self.size)]
        g, captured = self._graph()
        nodes = [self._node(g, "COPY", (shards[r],),
                            self._member_overrides(r))
                 for r in range(self.size)]
        self._seal(g, captured, roots=nodes, tails=nodes)
        return nodes

    def igather(self, shards: Sequence[NodeOrValue],
                root: int = 0) -> GraphNode:
        """Concatenate the per-rank shards (axis 0; 0-d shards stack) at the
        root member — one multi-parent ``CONCAT`` node pinned to the root's
        agent.  Returns its future."""
        self._check_live()
        self._check_rank(root)
        shards = self._per_rank(shards, "gather")
        g, captured = self._graph()
        node = self._node(g, "CONCAT", shards, self._member_overrides(root))
        self._seal(g, captured, roots=[node], tails=[node])
        return node

    def iallgather(self, shards: Sequence[NodeOrValue],
                   root: int = 0) -> List[GraphNode]:
        """Gather at ``root`` then broadcast the concatenation back to every
        member; per-rank node futures for the full tensor."""
        self._check_live()
        self._check_rank(root)
        shards = self._per_rank(shards, "allgather")
        g, captured = self._graph()
        gathered = self._node(g, "CONCAT", shards,
                              self._member_overrides(root))
        outs = [self._node(g, "COPY", (gathered,),
                           self._member_overrides(r))
                for r in range(self.size)]
        self._seal(g, captured, roots=[gathered], tails=outs)
        return outs

    def _combine_alias(self, op: str) -> str:
        alias = REDUCE_OPS.get(op, op)
        try:
            self.session.registry._canonical(alias)
        except KeyError:
            raise ValueError(
                f"reduce op {op!r}: no registered combine kernel "
                f"{alias!r} (built-ins: {sorted(REDUCE_OPS)}; any "
                f"registered binary alias is accepted)") from None
        return alias

    def _reduce_tree(self, g: ExecutionGraph, shards: List[NodeOrValue],
                     alias: str, created: List[GraphNode]) -> NodeOrValue:
        """Wire a pairwise combine tree over the shards: (0,1), (2,3), …
        each level, an odd last one carried up.  Combine nodes go in
        ``created`` (for hazard-edge bookkeeping) and carry group-wide
        overrides so placement can pick the fastest member per node."""
        sample = tuple(s for s in shards if not isinstance(s, HaloFuture))[:2]
        overrides = self._group_overrides(alias, sample)
        level = shards
        while len(level) > 1:
            nxt: List[NodeOrValue] = []
            for i in range(0, len(level) - 1, 2):
                node = self._node(g, alias, (level[i], level[i + 1]),
                                  overrides)
                created.append(node)
                nxt.append(node)
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]

    def ireduce(self, shards: Sequence[NodeOrValue], op: str = "sum",
                root: int = 0) -> GraphNode:
        """Pairwise-tree reduction of the per-rank shards through the
        registry's combine kernel for ``op``.  Each combine node may run on
        *any* member platform — per-node placement picks the fastest, with
        the scheduler's member ranking as the static fallback (DESIGN.md
        §10).  Returns the root node future of the tree."""
        self._check_live()
        shards = self._per_rank(shards, "reduce")
        self._check_rank(root)
        alias = self._combine_alias(op)
        g, captured = self._graph()
        created: List[GraphNode] = []
        out = self._reduce_tree(g, shards, alias, created)
        if not isinstance(out, GraphNode):       # size-1 group: stage once
            out = self._node(g, "COPY", (out,), self._member_overrides(root))
            created.append(out)
        self._seal(g, captured, roots=created, tails=[out])
        return out

    def iallreduce(self, shards: Sequence[NodeOrValue],
                   op: str = "sum") -> List[GraphNode]:
        """Reduce then fan the result back out: per-rank node futures that
        all resolve to the identical reduced value."""
        self._check_live()
        shards = self._per_rank(shards, "allreduce")
        alias = self._combine_alias(op)
        g, captured = self._graph()
        created: List[GraphNode] = []
        reduced = self._reduce_tree(g, shards, alias, created)
        outs = [self._node(g, "COPY", (reduced,),
                           self._member_overrides(r))
                for r in range(self.size)]
        created.extend(outs)
        self._seal(g, captured, roots=created, tails=outs)
        return outs

    def imap(self, alias: str, per_rank_args: Sequence[Sequence[NodeOrValue]],
             kwargs: Optional[Dict] = None) -> List[GraphNode]:
        """Data-parallel member compute: dispatch ``alias`` once per rank,
        pinned to that member's agent, with that rank's argument tuple
        (tensors and/or node futures) — the SPMD body between collectives,
        e.g. each member's Jacobi sweep over its row shard."""
        self._check_live()
        per_rank_args = self._per_rank(per_rank_args, "member dispatch")
        g, captured = self._graph()
        nodes = [self._node(g, alias, tuple(args),
                            self._member_overrides(r), kwargs)
                 for r, args in enumerate(per_rank_args)]
        self._seal(g, captured, roots=nodes, tails=nodes)
        return nodes

    # -- blocking collectives --------------------------------------------------
    @staticmethod
    def _ready(node: GraphNode) -> Any:
        """The node's result once launched and its device work finished."""
        out = node.result()
        node.wait_device()
        return out

    def _wait_many(self, nodes: Sequence[GraphNode]) -> List[Any]:
        return [self._ready(n) for n in nodes]

    def _no_capture(self, verb: str) -> None:
        if _active_graph(self.session) is not None:
            raise GraphError(
                f"blocking {verb} inside a halo_graph capture would "
                f"deadlock; use the non-blocking i{verb} variant")

    def bcast(self, x: Any, root: int = 0) -> List[Any]:
        """Blocking :meth:`ibcast`: the per-rank copies, device-ready."""
        self._no_capture("bcast")
        return self._wait_many(self.ibcast(x, root))

    def scatter(self, x: Any, root: int = 0, axis: int = 0) -> List[Any]:
        """Blocking :meth:`iscatter`: the per-rank shards, device-ready."""
        self._no_capture("scatter")
        return self._wait_many(self.iscatter(x, root, axis))

    def gather(self, shards: Sequence[Any], root: int = 0) -> Any:
        """Blocking :meth:`igather`: the concatenated tensor."""
        self._no_capture("gather")
        return self._ready(self.igather(shards, root))

    def allgather(self, shards: Sequence[Any], root: int = 0) -> List[Any]:
        """Blocking :meth:`iallgather`: per-rank full tensors."""
        self._no_capture("allgather")
        return self._wait_many(self.iallgather(shards, root))

    def reduce(self, shards: Sequence[Any], op: str = "sum",
               root: int = 0) -> Any:
        """Blocking :meth:`ireduce`: the reduced value."""
        self._no_capture("reduce")
        return self._ready(self.ireduce(shards, op, root))

    def allreduce(self, shards: Sequence[Any], op: str = "sum") -> List[Any]:
        """Blocking :meth:`iallreduce`: per-rank reduced values."""
        self._no_capture("allreduce")
        return self._wait_many(self.iallreduce(shards, op))

    def map(self, alias: str, per_rank_args: Sequence[Sequence[Any]],
            kwargs: Optional[Dict] = None) -> List[Any]:
        """Blocking :meth:`imap`: per-rank member-compute results."""
        self._no_capture("map")
        return self._wait_many(self.imap(alias, per_rank_args, kwargs))
