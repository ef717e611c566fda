"""Graph-level kernel fusion + replayable compiled graphs (DESIGN.md §12) —
port of ``repro.core.fusion``.

* **Fusion** — :func:`find_chains` walks a captured, unlaunched DAG for
  same-agent linear chains of fusible nodes (:func:`register_fusible`
  declares the per-alias rules) and collapses each into one synthetic
  ``FUSED:*`` :class:`~repro_torch.core.registry.KernelRecord` with two
  rows: ``aten`` (priority 10), a call loop over the members' aten records,
  and ``hopper`` (20): for a pure element-wise chain the hand-written chain
  kernel ``csrc/fused.cu`` in one launch, for a mixed chain a call loop over
  the members' hopper records.  Both are bit-identical to serial member
  execution: the call loops run the members' own launches, and the chain
  kernel rounds as each EW launch does, so the reference's
  ``HALO_FUSION_CONTRACT`` choice between the two has no counterpart here.
  A call loop passes each member the launch plan serial dispatch would
  give it — its captured kwargs merged with the TuningDB's entry for the
  member's record at the member's shapes, resolved when the chain is
  compiled — so the loop stays bit-identical to serial dispatch under a
  DB (the reference's loop calls its members at their default plans).
  Fused records estimate as the sum of their members' estimates until
  measured.
* **Buffer planning** — chain intermediates never become node payloads;
  single-consumer inputs produced inside the same graph are planned for
  donation and counted (``stats["planned_donations"]``); writing into a
  donated buffer is not implemented.
* **Replay** — :func:`compile_graph` freezes the optimized DAG into a
  :class:`CompiledGraph` keyed by (topology hash, shapes, dtypes, devices,
  placement epoch), cached per session (:data:`GRAPH_CACHE` entries).
  ``replay()`` re-instantiates nodes from templates — no re-capture, no
  payload re-scanning, and placement pinned to the plan.

Shapes are propagated without running anything: each node's fail-safe
oracle runs on ``meta`` tensors; an oracle that fails there leaves its node
unfused.  Failure semantics: a fused node whose records all fail,
quarantine or are refused *decomposes* back into its member nodes and
replays the chain unfused, bit-identical to never having fused — except a
hopper record that raises on card tensors, whose error fails the node, as
everywhere in the port.  There is no fail-safe row: decomposition is the
fail-safe.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import logging
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .agents import HaloFuture, RuntimeAgent
from .compute_object import ComputeObject, as_compute_object
from .registry import KernelAttributes, KernelRecord, SelectionError
from .scheduler import abstract_signature

log = logging.getLogger("repro_torch.halo.fusion")

__all__ = [
    "CHAIN",
    "CompiledGraph",
    "FusionRule",
    "MemberSpec",
    "NodeTemplate",
    "compile_graph",
    "find_chains",
    "fusion_rule",
    "register_fusible",
]

#: argmap sentinel: "the previous chain member's output".
CHAIN = "chain"

#: payload length cap for fusible nodes (defensive bound, far above reality).
_MAX_PAYLOAD = 64

#: member-feasibility cache entries per fused hopper loop record
_FEASIBLE_CACHE_MAX = 64

#: LRU capacity of the per-session compiled-graph cache
GRAPH_CACHE = 16


# ---------------------------------------------------------------------------
# Fusibility predicates (per-alias rules)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FusionRule:
    """Per-alias fusibility declaration.

    ``ewise_op`` names the element-wise op (``mul/div/add/sub``) a member
    contributes to the chain kernel; ``unary`` marks 1-arg pass-through
    members (COPY).  Members with neither fuse as a call loop.
    ``terminal`` members may only *end* a chain."""

    alias: str
    ewise_op: Optional[str] = None
    unary: bool = False
    terminal: bool = False


#: alias -> FusionRule; populated by :func:`register_fusible`.
FUSION_RULES: Dict[str, FusionRule] = {}


def register_fusible(alias: str, *, ewise_op: Optional[str] = None,
                     unary: bool = False, terminal: bool = False
                     ) -> FusionRule:
    """Declare ``alias`` fusible into same-agent linear chains.  Kernels
    without a rule never fuse; re-registering replaces the rule."""
    rule = FusionRule(alias, ewise_op=ewise_op, unary=unary,
                      terminal=terminal)
    FUSION_RULES[alias] = rule
    return rule


def fusion_rule(alias: str) -> Optional[FusionRule]:
    """The :class:`FusionRule` registered for ``alias``, or None."""
    return FUSION_RULES.get(alias)


@dataclasses.dataclass
class MemberSpec:
    """One chain member inside a fused node: enough to re-dispatch it.

    ``argmap`` maps the member's positional args onto the fused node's
    payload — an integer indexes the fused payload; :data:`CHAIN` is the
    previous member's output."""

    alias: str
    argmap: Tuple[Any, ...]
    kwargs: Dict[str, Any]


# ---------------------------------------------------------------------------
# Abstract shape propagation over a captured DAG
# ---------------------------------------------------------------------------
class _Unknown(Exception):
    """A payload leaf's abstract value is unavailable (unfusible node)."""


def _to_meta(t: torch.Tensor) -> torch.Tensor:
    """A shape-only stand-in for ``t``."""
    if t.device.type == "meta":
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _on_device(a: Any, device: torch.device) -> Any:
    """A meta stand-in as an uninitialised tensor on ``device``, for the
    kernels' feasibility checks, which judge the device an operand lies on;
    nothing reads it, and it lives only as long as the check."""
    if isinstance(a, torch.Tensor) and a.device.type == "meta":
        return torch.empty(a.shape, dtype=a.dtype, device=device)
    return a


def _abstractify(obj: Any, table: Dict[int, Any],
                 leaf: Callable[[torch.Tensor], Any] = _to_meta) -> Any:
    """``obj`` with futures replaced by their abstract outputs in ``table``
    and tensors passed through ``leaf``."""
    if isinstance(obj, HaloFuture):
        val = table.get(id(obj))
        if val is None:
            raise _Unknown
        return val
    if isinstance(obj, ComputeObject):
        return dataclasses.replace(
            obj, inputs={k: _abstractify(v, table, leaf)
                         for k, v in obj.inputs.items()})
    if isinstance(obj, dict):
        return {k: _abstractify(v, table, leaf) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_abstractify(v, table, leaf) for v in obj)
    if isinstance(obj, torch.Tensor):
        return leaf(obj)
    return obj


def _abstract_args(node, table: Dict[int, Any],
                   leaf: Callable[[torch.Tensor], Any] = _to_meta
                   ) -> Tuple[Tuple, Dict]:
    """Mirror of ``ExecutionGraph._node_args`` over abstract values."""
    payload = _abstractify(node.payload, table, leaf)
    if node.cr is not None:
        co = as_compute_object(payload)
        args = tuple(co.inputs[k] for k in sorted(co.inputs))
        kwargs = dict(node.kwargs)
        kwargs.update(co.meta)
        return args, kwargs
    return tuple(payload), dict(node.kwargs)


def _abstract_outputs(g) -> Dict[int, Any]:
    """id(node) -> abstract output (a meta tensor) for every node whose
    output the fail-safe oracle derives on meta tensors; None when it
    cannot (multi-output, unknown inputs, an oracle that fails on meta) —
    such nodes never fuse."""
    table: Dict[int, Any] = {}
    registry = g.session.registry
    for node in g.nodes:
        out = None
        fs = registry.failsafe(node.alias)
        if fs is not None:
            try:
                args, kwargs = _abstract_args(node, table)
                res = fs.fn(*args, **kwargs)
                if isinstance(res, torch.Tensor) and res.device.type == "meta":
                    out = res
            except Exception:  # noqa: BLE001 — advisory; node stays unfused
                out = None
        table[id(node)] = out
    return table


# ---------------------------------------------------------------------------
# Chain detection
# ---------------------------------------------------------------------------
def _fusible_node(node, table: Dict[int, Any]) -> bool:
    if FUSION_RULES.get(node.alias) is None:
        return False
    if node._foreign_deps:
        return False
    if node.cr is not None and (node.cr.buffers or node.cr.pipeline):
        return False                     # stateful / pipeline CRs never fuse
    p = node.payload
    if not isinstance(p, (tuple, list)) or not p or len(p) > _MAX_PAYLOAD:
        return False
    for leaf in p:
        if isinstance(leaf, (dict, ComputeObject, tuple, list)):
            return False                 # nested payloads keep node as-is
    return isinstance(table.get(id(node)), torch.Tensor)


def find_chains(g, table: Dict[int, Any]) -> List[List[Any]]:
    """Maximal same-agent linear chains of fusible nodes, in capture order.

    A chain extends parent→child only when the link is exclusive (parent's
    sole consumer, child's sole producer), the child actually consumes the
    parent's output, both share overrides, and the parent's rule is not
    ``terminal``.  Chains of length < 2 are not chains."""
    chains: List[List[Any]] = []
    in_chain: set = set()
    for node in g.nodes:
        if id(node) in in_chain or not _fusible_node(node, table):
            continue
        chain = [node]
        cur = node
        while True:
            if FUSION_RULES[cur.alias].terminal:
                break
            if len(cur.children) != 1:
                break
            child = cur.children[0]
            if id(child) in in_chain or not _fusible_node(child, table):
                break
            if len(child.parents) != 1 or child.parents[0] is not cur:
                break
            if not any(leaf is cur for leaf in child.payload):
                break                    # pure hazard edge: order, not data
            if child.overrides != node.overrides:
                break
            chain.append(child)
            cur = child
        if len(chain) >= 2:
            chains.append(chain)
            in_chain.update(id(n) for n in chain)
    return chains


# ---------------------------------------------------------------------------
# Synthetic fused records
# ---------------------------------------------------------------------------
def _member_record(registry, alias: str, platform: str) -> KernelRecord:
    """Best member record for composition: the highest-priority record on
    ``platform``, else the fail-safe oracle."""
    best = None
    for rec in registry.records(alias):
        if rec.platform == platform and \
                (best is None or rec.priority > best.priority):
            best = rec
    best = best or registry.failsafe(alias)
    if best is None:
        raise SelectionError(f"no implementation for chain member {alias!r}")
    return best


def _member_args(m: MemberSpec, args: Sequence[Any], acc: Any) -> Tuple:
    return tuple(acc if s == CHAIN else args[s] for s in m.argmap)


def _sum_of_parts_cost(session: RuntimeAgent,
                       members: Sequence[MemberSpec]) -> Callable:
    """Analytic cost model for a fused record until it has measurements:
    the sum of the members' best estimates, chained through the fail-safe
    oracles on meta tensors."""
    registry = session.registry
    member_recs = {m.alias: registry.records(m.alias) for m in members}
    cache: Dict[Any, float] = {}

    def cost(*args) -> float:
        sched = session.scheduler
        if sched is None:
            raise RuntimeError("sum-of-parts estimate needs a scheduler")
        key = abstract_signature(args)
        if key in cache:
            return cache[key]
        total, known = 0.0, False
        acc = None
        for m in members:
            m_abs = tuple(_to_meta(a) if isinstance(a, torch.Tensor) else a
                          for a in _member_args(m, args, acc))
            sig = abstract_signature(m_abs)
            ests = [e for e in (sched.estimate(r, sig, m_abs)
                                for r in member_recs[m.alias]
                                if not sched.is_failed(r)) if e is not None]
            if ests:
                total += min(ests)
                known = True
            acc = registry.failsafe(m.alias).fn(*m_abs, **m.kwargs)
        if not known:
            raise ValueError("no member estimates yet")
        cache[key] = total
        return total

    return cost


def _chain_supports(n_inputs: int, steps: Tuple) -> Callable:
    """Feasibility of the chain kernel: what :func:`chain_problem` accepts
    (the caps, one shape and type, no 0-d operand, contiguous)."""
    from ..kernels.fused import chain_problem

    def supports(*args, **kw) -> bool:
        return len(args) == n_inputs and chain_problem(args, steps) is None

    return supports


def _arg_key(a: Any) -> Any:
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype, a.device, a.is_contiguous())
    return ("v", repr(a))


def _loop_supports(registry, members: Sequence[MemberSpec],
                   recs: Sequence[KernelRecord]) -> Callable:
    """Feasibility of a call loop: every member's record takes its
    arguments.  A member result not yet computed is the member oracle's
    output on meta tensors, checked as an empty tensor on the operands'
    device; answers are cached per argument signature."""
    cache: Dict[Any, bool] = {}
    lock = threading.Lock()

    def feasible(args) -> bool:
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        acc = None
        for m, rec in zip(members, recs):
            m_args = _member_args(m, args, acc)
            if not rec.feasible(*(_on_device(a, device) for a in m_args),
                                **m.kwargs):
                return False
            acc = registry.failsafe(m.alias).fn(
                *(_to_meta(a) if isinstance(a, torch.Tensor) else a
                  for a in m_args), **m.kwargs)
        return True

    def supports(*args, **kw) -> bool:
        key = tuple(_arg_key(a) for a in args)
        with lock:
            hit = cache.get(key)
        if hit is None:
            try:
                hit = feasible(args)
            except Exception:  # noqa: BLE001 — an oracle failed on meta
                hit = False
            with lock:
                if len(cache) >= _FEASIBLE_CACHE_MAX:
                    cache.clear()
                cache[key] = hit
        return hit

    return supports


def _member_configs(session: RuntimeAgent, chain: List[Any],
                    members: Sequence[MemberSpec], table: Dict[int, Any]
                    ) -> Dict[str, Tuple[Dict[str, Any], ...]]:
    """Platform → each member's call kwargs in that platform's call loop:
    its captured kwargs merged with the launch plan serial dispatch would
    give the member's record at the member's shapes
    (:meth:`RuntimeAgent._tuned_kwargs`), resolved now, when the chain is
    compiled."""
    out: Dict[str, Tuple[Dict[str, Any], ...]] = {}
    for platform in ("aten", "hopper"):
        cfgs = []
        for node, m in zip(chain, members):
            rec = _member_record(session.registry, m.alias, platform)
            try:
                args = _abstract_args(node, table)[0]
            except _Unknown:
                cfgs.append(dict(m.kwargs))
                continue
            cfgs.append(dict(session._tuned_kwargs(rec, args, dict(m.kwargs))))
        out[platform] = tuple(cfgs)
    return out


def _fused_alias(members: Sequence[MemberSpec], donate: Sequence[int],
                 configs: Optional[Dict[str, Tuple[Dict[str, Any], ...]]] = None
                 ) -> str:
    """``FUSED:A+B+…@hash``; member configs that differ from the captured
    kwargs (a TuningDB's plans) key a record of their own."""
    desc = "+".join(m.alias for m in members)
    spec = repr([(m.alias, m.argmap, sorted(m.kwargs.items()))
                 for m in members]) + repr(sorted(donate))
    captured = [m.kwargs for m in members]
    tuned = sorted((p, [sorted(c.items()) for c in cfgs])
                   for p, cfgs in (configs or {}).items()
                   if list(cfgs) != captured)
    if tuned:
        spec += repr(tuned)
    return f"FUSED:{desc}@{hashlib.sha1(spec.encode()).hexdigest()[:8]}"


def _ensure_fused_records(session: RuntimeAgent, alias: str,
                          members: Sequence[MemberSpec], n_inputs: int,
                          ew_steps: Optional[Tuple],
                          donate: Sequence[int],
                          configs: Optional[Dict[str, Tuple]] = None
                          ) -> List[KernelRecord]:
    """Register (idempotently) the synthetic records for one fused alias.

    ``aten`` (10): a call loop over the members' aten records (the
    reference's single-jit composition has no counterpart here).
    ``hopper`` (20): a pure element-wise chain is the chain kernel
    (``csrc/fused.cu``, one launch); a mixed chain is a call loop over the
    members' hopper records, when every member has one.  A call loop calls
    each member with ``configs[platform]`` (:func:`_member_configs`), else
    its captured kwargs.  No fail-safe row: an exhausted fused node
    decomposes back to its members, which *is* the fail-safe."""
    registry = session.registry
    existing = registry.records(alias)
    if existing:
        return existing
    from ..kernels.fused import ACC, ewise_chain, make_composed

    cost = _sum_of_parts_cost(session, members)
    argmaps = [tuple(ACC if s == CHAIN else s for s in m.argmap)
               for m in members]
    configs = configs or {}
    kwargs_list = [dict(m.kwargs) for m in members]
    aten_recs = [_member_record(registry, m.alias, "aten") for m in members]
    out = [registry.register(KernelRecord(
        alias=alias, fn=make_composed([r.fn for r in aten_recs], argmaps,
                                      configs.get("aten", kwargs_list)),
        platform="aten", attrs=KernelAttributes(sw_fid=f"fid:{alias.lower()}"),
        priority=10, cost_model=cost,
        doc=f"composition loop over {len(members)} chained aten kernels"))]
    hw = dict(vid="nvidia", pid="h100")
    if ew_steps is not None:
        out.append(registry.register(KernelRecord(
            alias=alias, fn=functools.partial(ewise_chain, steps=ew_steps),
            platform="hopper",
            attrs=KernelAttributes(sw_fid=f"fid:{alias.lower()}:hopper", **hw),
            priority=20, supports=_chain_supports(n_inputs, ew_steps),
            cost_model=cost,
            doc=f"hand-written chain kernel over {len(members)} ewise ops "
                f"(csrc/fused.cu)")))
        return out
    hop_recs = [_member_record(registry, m.alias, "hopper") for m in members]
    if all(r.platform == "hopper" for r in hop_recs):
        out.append(registry.register(KernelRecord(
            alias=alias, fn=make_composed([r.fn for r in hop_recs], argmaps,
                                          configs.get("hopper", kwargs_list)),
            platform="hopper",
            attrs=KernelAttributes(sw_fid=f"fid:{alias.lower()}:hopper", **hw),
            priority=20, supports=_loop_supports(registry, members, hop_recs),
            cost_model=cost,
            doc=f"composition loop over {len(members)} chained hopper "
                f"kernels")))
    return out


# ---------------------------------------------------------------------------
# Compiled graphs: templates + replay
# ---------------------------------------------------------------------------
class _SlotRef:
    """Payload placeholder: the i-th compiled-graph input tensor."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


class _NodeRef:
    """Payload placeholder: the i-th template's output node."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


@dataclasses.dataclass
class NodeTemplate:
    """Frozen recipe for one replayed node: payload with slot/node refs in
    place of tensors/parents, explicit parent edges (no payload re-scan),
    the planned placement, and — for fused nodes — the member specs the
    decompose-on-failure path needs."""

    alias: str
    payload: Any
    kwargs: Dict[str, Any]
    overrides: Dict[str, Any]
    cr: Any
    tag: int
    failsafe: Optional[Callable]
    parents: Tuple[int, ...]
    members: Optional[List[MemberSpec]] = None
    pinned: Optional[KernelRecord] = None
    abstract_args: Optional[Tuple] = None


def _collect_inputs(g) -> Tuple[List[Any], Dict[int, int]]:
    """Distinct tensor leaves across all payloads, in first-appearance
    (capture) order — the compiled graph's input slots."""
    slots: List[Any] = []
    index: Dict[int, int] = {}

    def visit(obj: Any) -> None:
        if isinstance(obj, HaloFuture):
            return
        if isinstance(obj, ComputeObject):
            for k in sorted(obj.inputs):
                visit(obj.inputs[k])
        elif isinstance(obj, dict):
            for k in sorted(obj):
                visit(obj[k])
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                visit(v)
        elif isinstance(obj, torch.Tensor):
            if id(obj) not in index:
                index[id(obj)] = len(slots)
                slots.append(obj)

    for n in g.nodes:
        visit(n.payload)
    return slots, index


def _templatize(obj: Any, node_idx: Dict[int, int],
                slot_idx: Dict[int, int]) -> Any:
    if isinstance(obj, HaloFuture):
        return _NodeRef(node_idx[id(obj)])
    if isinstance(obj, ComputeObject):
        return dataclasses.replace(
            obj, inputs={k: _templatize(v, node_idx, slot_idx)
                         for k, v in obj.inputs.items()})
    if isinstance(obj, dict):
        return {k: _templatize(v, node_idx, slot_idx) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_templatize(v, node_idx, slot_idx) for v in obj)
    if isinstance(obj, torch.Tensor):
        return _SlotRef(slot_idx[id(obj)])
    return obj


def _resolve(obj: Any, nodes: List[Any], arrays: List[Any]) -> Any:
    if isinstance(obj, _NodeRef):
        return nodes[obj.i]
    if isinstance(obj, _SlotRef):
        return arrays[obj.i]
    if isinstance(obj, ComputeObject):
        return dataclasses.replace(
            obj, inputs={k: _resolve(v, nodes, arrays)
                         for k, v in obj.inputs.items()})
    if isinstance(obj, dict):
        return {k: _resolve(v, nodes, arrays) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_resolve(v, nodes, arrays) for v in obj)
    return obj


def _payload_sig(obj: Any, slot_idx: Dict[int, int]) -> str:
    if isinstance(obj, HaloFuture):
        return f"n{obj.uid}"
    if isinstance(obj, ComputeObject):
        inner = ",".join(f"{k}:{_payload_sig(v, slot_idx)}"
                         for k, v in sorted(obj.inputs.items()))
        return f"co({inner})"
    if isinstance(obj, dict):
        inner = ",".join(f"{k}:{_payload_sig(v, slot_idx)}"
                         for k, v in sorted(obj.items()))
        return f"d({inner})"
    if isinstance(obj, (tuple, list)):
        return "t(" + ",".join(_payload_sig(v, slot_idx) for v in obj) + ")"
    if isinstance(obj, torch.Tensor):
        return (f"a{slot_idx[id(obj)]}:{tuple(obj.shape)}:{obj.dtype}:"
                f"{obj.device}:{int(obj.is_contiguous())}")
    return f"s{obj!r}"


# Stable ids for failsafe callables in compiled-graph cache keys: ``id()``
# of a callable can be recycled after collection, and a new lambda at a dead
# one's address would hit the dead graph's plan.  A WeakKeyDictionary entry
# dies with its callable, so a uid is never reused for another live object.
_callable_uids: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_callable_uid_counter = itertools.count(1)
_callable_uid_lock = threading.Lock()


def _callable_uid(fn: Callable) -> int:
    """Process-unique id for ``fn``, stable for its lifetime."""
    with _callable_uid_lock:
        try:
            uid = _callable_uids.get(fn)
            if uid is None:
                uid = next(_callable_uid_counter)
                _callable_uids[fn] = uid
            return uid
        except TypeError:
            # not weakref-able (a builtin): immortal, so id() cannot recur
            return id(fn)


def _graph_key(g, fuse: bool, slot_idx: Dict[int, int]) -> str:
    """Cache key: topology + shapes/dtypes/devices + kwargs/overrides + the
    fusion switch + placement epoch + TuningDB generation.  A quarantine
    change (scheduler epoch) invalidates every compiled plan, so stale
    pinned placements are never replayed; so does a change of the DB, whose
    plans the call loops hold."""
    sched = g.session.scheduler
    tuning = sched.tuning if sched is not None else None
    h = hashlib.sha1()
    h.update(f"fuse={int(fuse)};epoch={sched.epoch if sched else 0};"
             f"tuning={tuning.generation if tuning is not None else 0}".encode())
    for node in g.nodes:
        # stateless CRs key by presence only (re-claiming the same alias
        # between steps still hits); stateful CRs key by uid
        cr = node.cr
        cr_sig = cr.uid if cr is not None and cr.buffers \
            else int(cr is not None)
        h.update((
            f"|{node.alias}|{node.tag}"
            f"|{sorted((k, repr(v)) for k, v in node.overrides.items())}"
            f"|{sorted((k, repr(v)) for k, v in node.kwargs.items())}"
            f"|{cr_sig}|{_callable_uid(node.failsafe) if node.failsafe else 0}"
            f"|{[p.uid for p in node.parents]}"
            f"|{_payload_sig(node.payload, slot_idx)}").encode())
    return h.hexdigest()


def _abstract_bytes(args: Sequence[Any]) -> int:
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


class CompiledGraph:
    """An optimized, frozen execution graph that replays without
    re-capture, re-placement, or re-wiring (DESIGN.md §12).

    Obtained via ``ExecutionGraph.compile()`` (or :func:`compile_graph`).
    ``replay(updates={slot: tensor})`` runs one steady-state iteration:
    nodes are re-instantiated from templates with explicit edges, and
    placement uses the pinned plan (re-scored only when a pinned record has
    been quarantined since planning)."""

    def __init__(self, session: RuntimeAgent, key: str,
                 templates: List[NodeTemplate], inputs: List[Any],
                 stats: Dict[str, Any]):
        self.session = session
        self.key = key
        self.templates = templates
        self.stats = stats
        self._inputs = list(inputs)
        self._lock = threading.Lock()

    # -- inputs -----------------------------------------------------------
    def slot_of(self, arr: Any) -> Optional[int]:
        """Input-slot index of a capture-time tensor (by identity), for
        building ``replay(updates=...)`` dicts; None if not an input."""
        for i, a in enumerate(self._inputs):
            if a is arr:
                return i
        return None

    def _rebind_inputs(self, slots: List[Any]) -> None:
        from .graph import GraphError
        if len(slots) != len(self._inputs):
            raise GraphError(
                f"compiled-graph cache collision: {len(slots)} input "
                f"slot(s) vs {len(self._inputs)} expected")
        with self._lock:
            self._inputs = list(slots)

    def _updated_inputs(self, updates: Optional[Dict[int, Any]]) -> List[Any]:
        from .graph import GraphError
        with self._lock:
            arrays = list(self._inputs)
        if not updates:
            return arrays
        for i, v in updates.items():
            if not 0 <= int(i) < len(arrays):
                raise GraphError(f"no input slot {i}")
            old = arrays[int(i)]
            if not isinstance(v, torch.Tensor) \
                    or _arg_key(v) != _arg_key(old):
                got = _arg_key(v) if isinstance(v, torch.Tensor) else type(v)
                raise GraphError(
                    f"input slot {i} expects {_arg_key(old)} (shape, dtype, "
                    f"device, contiguous); got {got} — recompile instead")
            arrays[int(i)] = v
        return arrays

    # -- replay -----------------------------------------------------------
    def replay_async(self, updates: Optional[Dict[int, Any]] = None):
        """Instantiate + launch one iteration; returns the live
        :class:`~repro_torch.core.graph.ExecutionGraph` (non-blocking)."""
        from .graph import ExecutionGraph, GraphNode
        arrays = self._updated_inputs(updates)
        g = ExecutionGraph(self.session)
        nodes: List[GraphNode] = []
        for idx, t in enumerate(self.templates):
            node = GraphNode(idx + 1, t.alias,
                             _resolve(t.payload, nodes, arrays),
                             t.kwargs, cr=t.cr, overrides=t.overrides,
                             failsafe=t.failsafe, tag=t.tag)
            node.pinned = t.pinned
            node.fused_members = t.members
            for p in t.parents:
                node.parents.append(nodes[p])
                nodes[p].children.append(node)
            g.nodes.append(node)
            g._ids.add(id(node))
            nodes.append(node)
        with self._lock:
            self.stats["replays"] += 1
        g.launch()
        return g

    def replay(self, updates: Optional[Dict[int, Any]] = None,
               timeout: Optional[float] = None) -> List[Any]:
        """One steady-state iteration: launch from templates and wait for
        the launches; returns the output nodes' results in capture order
        (on the card, synchronise before reading them).  The intermediate
        results are freed on return, even while a worker of a dead agent
        is still wedged in one of the nodes."""
        g = self.replay_async(updates)
        out = g.wait(timeout)
        with self._lock:
            self.stats["placements_pinned_last"] = \
                g.stats["placements_pinned"]
            self.stats["placements_scored_last"] = \
                g.stats["placements_scored"]
        # parents and children link each other: the cycles would keep every
        # node's result (a training step's gradient vectors) alive until
        # the next cyclic collection.  Every node is done once the outputs
        # are, and the graph goes no further than here
        for node in g.nodes:
            node.parents, node.children = [], []
        # a worker still wedged inside one node (its agent declared dead and
        # the node replayed elsewhere) holds this graph: without its node
        # list the wedge pins that node alone, not every result of the step
        g.nodes = []
        return out


# ---------------------------------------------------------------------------
# The optimization pass
# ---------------------------------------------------------------------------
def _chain_members(chain: List[Any]) -> Tuple[List[MemberSpec], List[Any]]:
    """(member specs, fused payload) for one chain: dedupe non-chain args
    by identity into one payload tuple; argmaps index it (or CHAIN)."""
    payload: List[Any] = []
    index: Dict[int, int] = {}
    members: List[MemberSpec] = []
    for i, node in enumerate(chain):
        argmap: List[Any] = []
        for leaf in node.payload:
            if i > 0 and leaf is chain[i - 1]:
                argmap.append(CHAIN)
                continue
            idx = index.get(id(leaf))
            if idx is None:
                idx = len(payload)
                index[id(leaf)] = idx
                payload.append(leaf)
            argmap.append(idx)
        members.append(MemberSpec(node.alias, tuple(argmap),
                                  dict(node.kwargs)))
    return members, payload


def _ewise_steps(chain: List[Any], members: List[MemberSpec],
                 payload: List[Any], table: Dict[int, Any]
                 ) -> Optional[Tuple]:
    """Static step tuple for the chain kernel, or None when the chain is
    not purely element-wise over operands of one shape and type, or is
    over the kernel's caps (such a chain keeps the hopper call loop)."""
    from ..kernels.fused import ACC, MAX_INPUTS, MAX_STEPS

    if len(payload) > MAX_INPUTS or len(members) > MAX_STEPS:
        return None

    out = table[id(chain[-1])]
    shape, dtype = tuple(out.shape), out.dtype
    if len(shape) < 1:
        return None
    for entry in payload:
        a = table.get(id(entry)) if isinstance(entry, HaloFuture) else entry
        if tuple(getattr(a, "shape", ())) != shape \
                or getattr(a, "dtype", None) != dtype:
            return None
    steps: List[Tuple[str, Any, Any]] = []
    for m in members:
        rule = FUSION_RULES[m.alias]
        if m.kwargs:
            return None
        specs = tuple(ACC if s == CHAIN else s for s in m.argmap)
        if rule.unary and len(specs) == 1:
            steps.append(("copy", specs[0], None))
        elif rule.ewise_op is not None and len(specs) == 2:
            steps.append((rule.ewise_op, specs[0], specs[1]))
        else:
            return None
    return tuple(steps)


def _plan_placement(session: RuntimeAgent,
                    templates: List[NodeTemplate]) -> Tuple[int, int]:
    """Pin one record per template, mirroring the ready-time placement
    scoring (estimate + backlog + transfer penalty) over the templates'
    arguments: capture-time tensors, and for node results their meta
    stand-ins as empty tensors on the session's device.  Returns (pinned,
    unplanned) counts."""
    sched = session.scheduler
    backlog: Dict[str, float] = {}
    platform_of: Dict[int, str] = {}
    pinned = 0
    for idx, t in enumerate(templates):
        if t.abstract_args is None:
            continue
        args = tuple(_on_device(a, session.device) for a in t.abstract_args)
        allowed = t.overrides.get("allowed_platforms") \
            or session._allowed_platforms()
        pref = t.overrides.get("platform_preference") \
            or session._platform_preference()
        try:
            cands = session.registry.candidates(
                t.alias, *args, allowed_platforms=allowed,
                platform_preference=pref)
        except SelectionError:
            cands = []
        if sched is not None:
            cands = [c for c in cands if not sched.is_failed(c)]
        if not cands:
            continue
        parent_platforms = [platform_of[p] for p in t.parents
                            if p in platform_of]
        sig = abstract_signature(args)
        rec: Optional[KernelRecord] = None
        est = 0.0
        if sched is not None and len(cands) == 1:
            rec = cands[0]
            est = sched.estimate(rec, sig, args) or 0.0
        elif sched is not None:
            rec = sched.place(t.alias, cands, args,
                              parent_platforms=parent_platforms,
                              payload_bytes=_abstract_bytes(args),
                              backlog=dict(backlog))
            if rec is not None:
                est = sched.estimate(rec, sig, args) or 0.0
        if rec is None:
            for p in parent_platforms:
                rec = next((c for c in cands if c.platform == p), None)
                if rec is not None:
                    break
            rec = rec or cands[0]
        t.pinned = rec
        platform_of[idx] = rec.platform
        backlog[rec.platform] = backlog.get(rec.platform, 0.0) + est
        pinned += 1
    return pinned, len(templates) - pinned


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def compile_graph(g, fuse: bool = True) -> CompiledGraph:
    """Run the capture-time optimization pass over an unlaunched captured
    graph and freeze it into a session-cached :class:`CompiledGraph`.

    ``fuse=False`` skips the fusion pass and keeps replay caching.  Raises
    :class:`~repro_torch.core.graph.GraphError` for launched graphs and
    graphs gated on foreign futures (their readiness is external state a
    frozen replay cannot reproduce)."""
    from .graph import GraphError
    session = g.session
    if g._launched:
        raise GraphError("graph already launched; capture with "
                         "halo_graph(launch=False) to compile it")
    for node in g.nodes:
        if node._foreign_deps:
            raise GraphError(
                f"node {node.uid} ({node.alias}) depends on a future from "
                f"outside this graph; compiled replay requires a closed DAG")
    slots, slot_idx = _collect_inputs(g)
    key = _graph_key(g, fuse, slot_idx)
    cache = session._compiled_graphs
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        hit._rebind_inputs(slots)
        with hit._lock:
            hit.stats["cache_hits"] += 1
        return hit

    table = _abstract_outputs(g)
    chains = find_chains(g, table) if fuse else []
    chain_pos: Dict[int, int] = {}       # id(node) -> chain index
    chain_ids: set = set()
    for ci, chain in enumerate(chains):
        for n in chain:
            chain_pos[id(n)] = ci
            chain_ids.add(id(n))

    templates: List[NodeTemplate] = []
    node_idx: Dict[int, int] = {}        # id(node) -> template index
    planned_donations = 0
    fused_aliases: List[str] = []
    for node in g.nodes:
        ci = chain_pos.get(id(node))
        if ci is not None:
            chain = chains[ci]
            if node is not chain[0]:
                continue                 # chain members fold into the head
            members, payload = _chain_members(chain)
            ew_steps = _ewise_steps(chain, members, payload, table)
            donate = [i for i, e in enumerate(payload)
                      if isinstance(e, HaloFuture)
                      and all(id(c) in chain_ids for c in e.children)]
            planned_donations += len(donate)
            configs = _member_configs(session, chain, members, table)
            alias = _fused_alias(members, donate, configs)
            _ensure_fused_records(session, alias, members, len(payload),
                                  ew_steps, donate, configs)
            fused_aliases.append(alias)
            t = NodeTemplate(
                alias=alias,
                payload=tuple(_templatize(e, node_idx, slot_idx)
                              for e in payload),
                kwargs={}, overrides=dict(node.overrides), cr=None,
                tag=node.tag, failsafe=None,
                parents=tuple(dict.fromkeys(
                    node_idx[id(p)] for p in node.parents)),
                members=members)
            try:
                t.abstract_args = tuple(_abstractify(e, table, _keep)
                                        for e in payload)
            except _Unknown:
                t.abstract_args = None
            idx = len(templates)
            templates.append(t)
            for n in chain:
                node_idx[id(n)] = idx    # consumers of the tail hit the head
            continue
        t = NodeTemplate(
            alias=node.alias,
            payload=_templatize(node.payload, node_idx, slot_idx),
            kwargs=dict(node.kwargs), overrides=dict(node.overrides),
            cr=node.cr, tag=node.tag, failsafe=node.failsafe,
            parents=tuple(dict.fromkeys(
                node_idx[id(p)] for p in node.parents)))
        try:
            t.abstract_args = _abstract_args(node, table, _keep)[0]
        except _Unknown:
            t.abstract_args = None
        idx = len(templates)
        templates.append(t)
        node_idx[id(node)] = idx

    pinned, unplanned = _plan_placement(session, templates)
    stats = {
        "captured_nodes": len(g.nodes),
        "nodes": len(templates),
        "fused_nodes": len(chains),
        "intermediates_eliminated": sum(len(c) - 1 for c in chains),
        "planned_donations": planned_donations,
        "fused_aliases": fused_aliases,
        "pinned_placements": pinned,
        "unplanned_placements": unplanned,
        "replays": 0,
        "cache_hits": 0,
        "placements_pinned_last": 0,
        "placements_scored_last": 0,
    }
    cg = CompiledGraph(session, key, templates, slots, stats)
    log.info("compiled graph %s: %d node(s) -> %d (fused %d chain(s), "
             "%d intermediate(s) eliminated)", key[:8], len(g.nodes),
             len(templates), len(chains), stats["intermediates_eliminated"])
    cache[key] = cg
    while len(cache) > GRAPH_CACHE:
        cache.popitem(last=False)
    return cg
