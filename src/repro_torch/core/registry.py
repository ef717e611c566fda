"""Kernel registry + attribute-based selection (C2MPI §IV-C, Table II) —
port of ``repro.core.registry``.

Every implementation of an alias is a :class:`KernelRecord` carrying the
paper's kernel attributes (VID/PID/SS_VID/SS_PID/SW_VID/SW_PID/SW_FID/
SW_VERID).  Selection semantics (used by the runtime agent per request):

1. filter records by alias (or ``sw_fid`` override),
2. filter by the ``supports(*args)`` predicate (shape/dtype/device
   feasibility),
3. filter by platform compatibility with the executing agent set,
4. order by (strategy-declared platform preference, record priority,
   semantic version), round-robin among exact ties,
5. if nothing survives: fall back to the alias's **fail-safe** record (the
   plain PyTorch oracle) to preserve functional portability (§IV-C).
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.halo.registry")

__all__ = [
    "GLOBAL_REGISTRY",
    "KernelAttributes",
    "KernelRecord",
    "KernelRegistry",
    "PLATFORM_PREFERENCE",
    "SelectionError",
    "clone_record",
]

# Process-wide monotonic record ids: caches that may outlive a record key on
# ``KernelRecord.uid``, never on ``id()`` (reused after collection).
_record_uids = itertools.count(1)

# Platform ids, ordered by default performance preference on the H100.
PLATFORM_PREFERENCE: Tuple[str, ...] = ("sharded", "hopper", "aten", "torch")


@dataclasses.dataclass(frozen=True)
class KernelAttributes:
    """Table II attributes.  ``"*"`` means wildcard / any."""

    vid: str = "*"          # HW vendor id          e.g. "nvidia"
    pid: str = "*"          # HW product id         e.g. "h100"
    ss_vid: str = "*"       # HW sub-system vendor id
    ss_pid: str = "*"       # HW sub-system product id
    sw_vid: str = "repro"   # SW vendor id
    sw_pid: str = "halo"    # SW product id
    sw_fid: str = ""        # SW function id — the stable lookup key
    sw_verid: str = "1.0.0" # SW version id

    def matches(self, other: "KernelAttributes") -> bool:
        for f in ("vid", "pid", "ss_vid", "ss_pid", "sw_vid", "sw_pid"):
            a, b = getattr(self, f), getattr(other, f)
            if a != "*" and b != "*" and a != b:
                return False
        return True

    def version_tuple(self) -> Tuple[int, ...]:
        try:
            return tuple(int(x) for x in self.sw_verid.split("."))
        except ValueError:
            return (0,)


@dataclasses.dataclass
class KernelRecord:
    """One hardware-specific implementation of a functional abstraction."""

    alias: str                       # func_alias, e.g. "MMM"
    fn: Callable                     # the implementation
    platform: str                    # "torch" | "aten" | "hopper" | "sharded"
    attrs: KernelAttributes = dataclasses.field(default_factory=KernelAttributes)
    priority: int = 0                # higher wins within a platform
    supports: Optional[Callable[..., bool]] = None   # predicate over args
    cost_model: Optional[Callable[..., float]] = None  # est. seconds for args
    is_failsafe: bool = False        # reference oracle for the alias
    doc: str = ""
    # Tunable-configuration axis (DESIGN.md §9): maps the call's args to a
    # list of launch-plan dicts the autotuner may sweep, a function of the
    # args' shapes and types alone.  A record that declares a space
    # promises that ``fn`` takes every dict's keys as keyword arguments.
    tuning_space: Optional[Callable[..., List[Dict[str, Any]]]] = None
    uid: int = dataclasses.field(default_factory=_record_uids.__next__)

    def feasible(self, *args, **kwargs) -> bool:
        """True when ``supports`` accepts these args (or is unset)."""
        if self.supports is None:
            return True
        try:
            return bool(self.supports(*args, **kwargs))
        except Exception:  # an over-strict predicate must never break dispatch
            log.debug("supports() raised for %s/%s; treating as infeasible",
                      self.alias, self.platform, exc_info=True)
            return False

    def variants(self, *args, **kwargs) -> List[Dict[str, Any]]:
        """Feasible tuning-space configs for these args ([] when untunable).

        A raising space is treated as empty — tuning is advisory and must
        never break dispatch."""
        if self.tuning_space is None:
            return []
        try:
            return list(self.tuning_space(*args, **kwargs))
        except Exception:  # noqa: BLE001 — same contract as supports()
            log.debug("tuning_space raised for %s/%s; treating as empty",
                      self.alias, self.platform, exc_info=True)
            return []


def clone_record(record: KernelRecord, **changes) -> KernelRecord:
    """A copy of ``record`` with ``changes`` applied and a **fresh uid**.

    ``dataclasses.replace`` alone would copy the source's uid, making the
    clone indistinguishable from the original to every uid-keyed cache.
    Used by the remote transport (DESIGN.md §13) to republish a worker's
    records under its remote platform id."""
    if "uid" not in changes:
        changes["uid"] = next(_record_uids)
    return dataclasses.replace(record, **changes)


class SelectionError(KeyError):
    """No kernel record (and no fail-safe) satisfies a selection request."""


class KernelRegistry:
    """Open-ended, thread-safe multi-source kernel repository."""

    def __init__(self):
        self._records: Dict[str, List[KernelRecord]] = {}
        self._fid_index: Dict[str, str] = {}   # sw_fid -> alias
        self._rr: Dict[str, itertools.count] = {}
        self._lock = threading.RLock()
        #: moves with every registration and deregistration, so a frozen
        #: selection (a captured decode step) can tell the records changed
        self.generation = 0

    # -- registration -------------------------------------------------------
    def register(self, record: KernelRecord) -> KernelRecord:
        """Publish one record; returns it (so callers can keep the handle)."""
        with self._lock:
            self._records.setdefault(record.alias, []).append(record)
            if record.attrs.sw_fid:
                self._fid_index[record.attrs.sw_fid] = record.alias
            self._rr.setdefault(record.alias, itertools.count())
            self.generation += 1
        log.debug("registered %s [%s] prio=%d failsafe=%s",
                  record.alias, record.platform, record.priority, record.is_failsafe)
        return record

    def register_fn(self, alias: str, platform: str, *, priority: int = 0,
                    attrs: Optional[KernelAttributes] = None,
                    supports=None, cost_model=None, is_failsafe: bool = False,
                    tuning_space=None, doc: str = ""):
        """Decorator form: ``@registry.register_fn("MMM", "hopper")``."""
        def deco(fn):
            self.register(KernelRecord(
                alias=alias, fn=fn, platform=platform,
                attrs=attrs or KernelAttributes(sw_fid=alias),
                priority=priority, supports=supports, cost_model=cost_model,
                is_failsafe=is_failsafe, tuning_space=tuning_space,
                doc=doc or (fn.__doc__ or "")))
            return fn
        return deco

    def deregister(self, alias: str, platform: Optional[str] = None) -> int:
        """Plug-and-play: agents may disconnect without affecting host code."""
        with self._lock:
            recs = self._records.get(alias, [])
            keep = [r for r in recs if platform is not None and r.platform != platform]
            removed = len(recs) - len(keep)
            self.generation += 1
            if keep:
                self._records[alias] = keep
            else:
                self._records.pop(alias, None)
            return removed

    # -- lookup --------------------------------------------------------------
    def aliases(self) -> List[str]:
        """All registered func aliases, sorted."""
        return sorted(self._records)

    def records(self, alias: str) -> List[KernelRecord]:
        """All records for ``alias`` in registration order ([] if unknown)."""
        return list(self._records.get(alias, ()))

    def resolve_fid(self, sw_fid: str) -> Optional[str]:
        """Map a Table-II ``sw_fid`` to its alias, or None."""
        return self._fid_index.get(sw_fid)

    def failsafe(self, alias: str) -> Optional[KernelRecord]:
        """The alias's fail-safe (reference-oracle) record, or None."""
        for r in self._records.get(alias, ()):
            if r.is_failsafe:
                return r
        return None

    # -- the selection process (§IV-C) ----------------------------------------
    def _canonical(self, alias: str) -> str:
        if alias in self._records:
            return alias
        mapped = self.resolve_fid(alias)
        if mapped is None:
            raise SelectionError(f"unknown kernel alias/sw_fid: {alias!r}")
        return mapped

    @staticmethod
    def _rank(pref: Tuple[str, ...]):
        def rank(r: KernelRecord):
            try:
                p = pref.index(r.platform)
            except ValueError:
                p = len(pref)
            # lower tuple = better
            return (p, -r.priority, tuple(-v for v in r.attrs.version_tuple()))
        return rank

    def candidates(self, alias: str, *args,
                   allowed_platforms: Sequence[str] = PLATFORM_PREFERENCE,
                   platform_preference: Optional[Sequence[str]] = None,
                   required_attrs: Optional[KernelAttributes] = None,
                   exclude: Sequence[KernelRecord] = (),
                   **kwargs) -> List[KernelRecord]:
        """All feasible records for an alias, best-static-rank first.

        ``exclude`` drops specific records by identity — used for
        re-placement after an execution failure.  Raises for unknown
        aliases; returns ``[]`` when nothing feasible survives the filters."""
        alias = self._canonical(alias)
        pref = tuple(platform_preference or PLATFORM_PREFERENCE)
        allowed = set(allowed_platforms)
        skip = {id(r) for r in exclude}
        out = [
            r for r in self._records[alias]
            if id(r) not in skip
            and r.platform in allowed
            and (required_attrs is None or r.attrs.matches(required_attrs))
            and r.feasible(*args, **kwargs)
        ]
        out.sort(key=self._rank(pref))
        return out

    def select(self, alias: str, *args,
               allowed_platforms: Sequence[str] = PLATFORM_PREFERENCE,
               platform_preference: Optional[Sequence[str]] = None,
               required_attrs: Optional[KernelAttributes] = None,
               _candidates: Optional[List[KernelRecord]] = None,
               **kwargs) -> KernelRecord:
        """Pick one record.  ``_candidates`` short-circuits the filter/sort
        when the caller already holds this call's candidates() result."""
        alias = self._canonical(alias)
        cands = _candidates if _candidates is not None else self.candidates(
            alias, *args, allowed_platforms=allowed_platforms,
            platform_preference=platform_preference,
            required_attrs=required_attrs, **kwargs)
        if not cands:
            fs = self.failsafe(alias)
            if fs is not None:
                log.warning("alias %r: no feasible candidate; fail-safe mode", alias)
                return fs
            raise SelectionError(
                f"alias {alias!r}: no feasible candidate and no fail-safe registered")
        # cands is sorted by rank, so the exact ties are its leading run
        rank = self._rank(tuple(platform_preference or PLATFORM_PREFERENCE))
        best = rank(cands[0])
        ties = list(itertools.takewhile(lambda r: rank(r) == best, cands))
        if len(ties) == 1:
            return ties[0]
        # round-robin recommendation strategy among exact ties (§V-C)
        with self._lock:
            i = next(self._rr[alias]) % len(ties)
        return ties[i]


# A process-global default registry; sessions may also build private ones.
GLOBAL_REGISTRY = KernelRegistry()
