"""Cost-model request scheduler (DESIGN.md §4) — port of
``repro.core.scheduler``.

The registry's static selection (platform preference → priority → version →
round-robin) answers "which record *should* be fastest on this target"; the
scheduler answers "which record *is* fastest for these argument shapes",
from the **measured latency**: an EMA of seconds per ``(alias, platform,
argument-signature)`` key, fed back by the runtime agent's worker after
each DRPC execution (device-synchronised through a CUDA event on the card).
The first observation per key is discarded as warmup (it includes the
kernel build).  The table persists as a small JSON file when
``HALO_AUTOTUNE_CACHE`` (or an explicit path) is set.

An estimate is, best first (DESIGN.md §9): a feasible
:class:`~repro_torch.core.tuning.TuningDB` sweep result for the record's
``platform|alias|shape-bucket|dtype`` (rung 1, which also supplies the
launch plan the runtime agent merges into the call, :meth:`tuned_config`),
the measured EMA, else the record's analytic ``cost_model`` (fused graph
records sum their members' estimates).  Records with no estimate are left
to the static selection order.  A record whose execution raised is
quarantined (:meth:`mark_failed`) until :meth:`clear_failures`;
:attr:`epoch` moves with every change of the quarantined set.
:meth:`place` scores graph nodes (DESIGN.md §8), :meth:`rank_platforms`
orders a device group's members for its combines (§10) and
:meth:`backup_candidate` picks a straggler's backup (§11).
"""
from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .config import halo_config
from .registry import KernelRecord

log = logging.getLogger("repro_torch.halo.scheduler")

__all__ = ["CostModelScheduler", "SigType", "abstract_signature"]

SigType = Tuple[Tuple[Any, str], ...]


def abstract_signature(args: Sequence[Any]) -> SigType:
    """Shape/dtype signature of positional args — the resolution-cache and
    latency-table key."""
    return tuple((tuple(getattr(a, "shape", ()) or ()),
                  str(getattr(a, "dtype", type(a).__name__)))
                 for a in args)


def _sig_str(sig: SigType) -> str:
    return ",".join(f"{dt}[{'x'.join(map(str, shape))}]" for shape, dt in sig)


def _record_key(record: KernelRecord) -> str:
    """Stable per-record key (priority + version keep replicas apart)."""
    return (f"{record.alias}|{record.platform}|"
            f"{record.priority}:{record.attrs.sw_verid}")


def _key(record: KernelRecord, sig: SigType) -> str:
    return f"{_record_key(record)}|{_sig_str(sig)}"


class CostModelScheduler:
    """Latency-aware record selection with a persistent measurement table."""

    #: EMA smoothing factor for steady-state latency updates.
    alpha: float = 0.25
    #: autosave the cache every N observations (when a path is configured).
    save_every: int = 64
    #: keep timing every request until a key has this many kept samples ...
    min_samples: int = 8
    #: ... then only time every Nth request (bounds instrumentation cost).
    sample_every: int = 8
    #: route every Nth DRPC selection to the best-ranked *unmeasured*
    #: candidate so greedy choice cannot lock out an untried record.
    explore_every: Optional[int] = 16
    #: cross-substrate transfer model for graph placement (DESIGN.md §8): a
    #: fixed staging latency plus payload bytes over an effective host-side
    #: link bandwidth, so chained nodes stay on one substrate unless the
    #: estimated kernel-time win exceeds the hop
    transfer_latency_s: float = 2e-5
    transfer_bandwidth: float = 8e9          # bytes / second

    def __init__(self, cache_path: Optional[os.PathLike] = None,
                 explore_every: Optional[int] = None,
                 explore_offset: int = 0,
                 tuning_db=None):
        """``explore_every``/``explore_offset`` inject the exploration
        policy: every Nth :meth:`choose` per key explores, starting the
        per-key counter at ``offset`` (0/None disables exploration).
        ``tuning_db`` wires a :class:`~repro_torch.core.tuning.TuningDB`
        (rung 1): None builds an empty in-memory DB, ``False`` disables
        tuned-config consultation entirely."""
        from .tuning import TuningDB       # deferred: tuning imports us
        self._lock = threading.Lock()
        # key -> [n_observations, ema_seconds]; n counts *kept* samples
        self._measured: Dict[str, List[float]] = {}
        self._warmed: Dict[str, bool] = {}
        self._attempts: Dict[str, int] = {}    # wants_sample() call counts
        self._chooses: Dict[str, int] = {}     # choose() call counts per key
        self._failed: Dict[str, int] = {}      # record key -> failure count
        self._epoch = 0                        # bumps on quarantine changes
        self._since_save = 0
        if explore_every is not None:
            self.explore_every = explore_every or None
        self.explore_offset = explore_offset
        # an empty TuningDB is falsy (len 0): test identity, not truth
        if tuning_db is None:
            tuning_db = TuningDB()
        self.tuning = tuning_db if tuning_db is not False else None
        self.cache_path = Path(cache_path) if cache_path else None
        if self.cache_path is not None and self.cache_path.exists():
            self.load(self.cache_path)

    @classmethod
    def default(cls) -> "CostModelScheduler":
        """Process-default scheduler: EMA table persistent iff
        ``autotune_cache`` is set (``HALO_AUTOTUNE_CACHE`` or
        ``halo.configure``); tuning DB from ``HALO_TUNING_DB`` (or the
        cache path's ``.tuning.json`` sibling, else memory)."""
        from .tuning import TuningDB       # deferred: tuning imports us
        return cls(cache_path=halo_config().autotune_cache,
                   tuning_db=TuningDB.default())

    # -- measurement feedback ------------------------------------------------
    def observe(self, record: KernelRecord, sig: SigType,
                seconds: float) -> None:
        """Record one executed-request latency for (record, sig); the first
        sample per key in this process is discarded as warmup."""
        key = _key(record, sig)
        with self._lock:
            if not self._warmed.get(key):
                self._warmed[key] = True
                return
            ent = self._measured.get(key)
            if ent is None:
                self._measured[key] = [1, seconds]
            else:
                ent[0] += 1
                ent[1] += self.alpha * (seconds - ent[1])
            self._since_save += 1
            due = (self.cache_path is not None
                   and self._since_save >= self.save_every)
            if due:
                self._since_save = 0
        if due:
            self.save()

    def measured(self, record: KernelRecord, sig: SigType) -> Optional[float]:
        with self._lock:
            ent = self._measured.get(_key(record, sig))
            return ent[1] if ent else None

    def wants_sample(self, record: KernelRecord, sig: SigType) -> bool:
        """Should the executor pay for timing this request?  Every request
        until ``min_samples`` are kept, then one in ``sample_every``."""
        key = _key(record, sig)
        with self._lock:
            n = self._attempts.get(key, 0)
            self._attempts[key] = n + 1
            ent = self._measured.get(key)
            if ent is None or ent[0] < self.min_samples:
                return True
            return n % self.sample_every == 0

    # -- failure quarantine ---------------------------------------------------
    @property
    def epoch(self) -> int:
        """Monotonic quarantine-state version: bumps whenever
        :meth:`mark_failed` / :meth:`clear_failures` changes the failed set,
        so holders of derived state (graph candidate caches, compiled graphs
        with pinned placements) can detect staleness cheaply."""
        with self._lock:
            return self._epoch

    def mark_failed(self, record: KernelRecord) -> None:
        """Quarantine a record whose execution raised: selection skips it
        until :meth:`clear_failures`.

        **Locality**: quarantine state (and :attr:`epoch`) is process-local,
        never persisted and never shared implicitly.  A worker process's
        scheduler quarantines on its own; a record that fails only inside a
        worker stays selectable on the host unless the event is passed back
        through :meth:`mark_failed_key` (the remote transport does this on
        every reply, DESIGN.md §13)."""
        self.mark_failed_key(_record_key(record))

    def mark_failed_key(self, key: str) -> None:
        """Quarantine by raw record key (``alias|platform|prio:ver``): the
        cross-process form of :meth:`mark_failed`, with which the host
        applies a worker's quarantine events after translating the platform
        segment to the remote member's id."""
        with self._lock:
            self._failed[key] = self._failed.get(key, 0) + 1
            self._epoch += 1

    def failed_record_keys(self) -> List[str]:
        """The currently-quarantined record keys (``alias|platform|prio:ver``),
        for shipping across the wire (see :meth:`mark_failed_key`)."""
        with self._lock:
            return sorted(self._failed)

    def is_failed(self, record: KernelRecord) -> bool:
        with self._lock:
            return _record_key(record) in self._failed

    def clear_failures(self) -> None:
        with self._lock:
            if self._failed:
                self._epoch += 1
            self._failed.clear()

    # -- selection -----------------------------------------------------------
    def estimate(self, record: KernelRecord, sig: SigType,
                 args: Sequence[Any]) -> Optional[float]:
        """Best available latency estimate for one record, or None: a
        feasible TuningDB sweep result, then the measured EMA, then the
        record's analytic cost model."""
        if self.tuning is not None:
            try:
                est = self.tuning.tuned_seconds(record, sig, args)
            except Exception:              # advisory data must never break
                log.debug("tuning lookup raised for %s/%s", record.alias,
                          record.platform, exc_info=True)
                est = None
            if est is not None:
                return est
        est = self.measured(record, sig)
        if est is not None:
            return est
        if record.cost_model is not None:
            try:
                return float(record.cost_model(*args))
            except Exception:
                log.debug("cost_model raised for %s/%s", record.alias,
                          record.platform, exc_info=True)
        return None

    def tuned_config(self, record: KernelRecord, args: Sequence[Any],
                     sig: Optional[SigType] = None
                     ) -> Optional[Dict[str, Any]]:
        """The TuningDB's winning launch plan for (record, args-bucket): a
        fresh dict of config kwargs, or None when no DB is wired, no entry
        exists, the default config won the sweep, or the stored config is
        no longer a feasible variant for these args (a stale entry falls
        through)."""
        if self.tuning is None:
            return None
        try:
            return self.tuning.tuned_config_for(
                record, sig if sig is not None else abstract_signature(args),
                args)
        except Exception:                  # advisory data must never break
            log.debug("tuned_config raised for %s/%s", record.alias,
                      record.platform, exc_info=True)
            return None

    def choose(self, alias: str, candidates: Sequence[KernelRecord],
               args: Sequence[Any], explore: bool = False
               ) -> Optional[KernelRecord]:
        """Pick the cheapest estimated candidate; None defers to the static
        selection order (no candidate has any estimate).  Ties keep the
        candidates' given (preference) order.

        With ``explore=True`` (DRPC path only), every ``explore_every``-th
        call instead returns the best-ranked candidate that has no estimate
        yet, so it can acquire measurements."""
        if not candidates:
            return None
        sig = abstract_signature(args)
        estimates = [self.estimate(rec, sig, args) for rec in candidates]
        if explore and self.explore_every \
                and any(e is None for e in estimates) \
                and any(e is not None for e in estimates):
            key = f"{alias}|{_sig_str(sig)}"
            with self._lock:
                n = self._chooses.get(key, self.explore_offset)
                self._chooses[key] = n + 1
            if n % self.explore_every == self.explore_every - 1:
                return next(rec for rec, e in zip(candidates, estimates)
                            if e is None)
        best: Optional[Tuple[float, int]] = None
        for i, est in enumerate(estimates):
            if est is not None and (best is None or est < best[0]):
                best = (est, i)
        return candidates[best[1]] if best is not None else None

    # -- graph placement (DESIGN.md §8) ---------------------------------------
    def transfer_penalty(self, nbytes: int) -> float:
        """Estimated seconds to stage one node's inputs onto a different
        substrate than the one that produced them."""
        return self.transfer_latency_s + max(0, nbytes) / self.transfer_bandwidth

    def place(self, alias: str, candidates: Sequence[KernelRecord],
              args: Sequence[Any], parent_platforms: Sequence[str] = (),
              payload_bytes: int = 0,
              backlog: Optional[Dict[str, float]] = None
              ) -> Optional[KernelRecord]:
        """Per-node graph placement: cheapest estimated completion time.

        Score = latency estimate + the substrate's queued graph seconds
        (``backlog``: spreads independent branches across agents) + one
        :meth:`transfer_penalty` per parent that ran on another substrate
        (keeps dependent chains together unless splitting pays).  A
        candidate with no estimate scores as the worst estimated one.
        Returns None when no candidate has an estimate — callers fall back
        to static preference with parent-platform affinity."""
        if not candidates:
            return None
        sig = abstract_signature(args)
        estimates = [self.estimate(rec, sig, args) for rec in candidates]
        known = [e for e in estimates if e is not None]
        if not known:
            return None
        proxy = max(known)
        best: Optional[Tuple[float, int]] = None
        for i, rec in enumerate(candidates):
            score = estimates[i] if estimates[i] is not None else proxy
            if backlog:
                score += backlog.get(rec.platform, 0.0)
            score += sum(self.transfer_penalty(payload_bytes)
                         for p in parent_platforms
                         if p is not None and p != rec.platform)
            if best is None or score < best[0]:
                best = (score, i)
        return candidates[best[1]]

    def rank_platforms(self, alias: str, candidates: Sequence[KernelRecord],
                       args: Sequence[Any]) -> List[str]:
        """Group-aware platform ranking for collective combines (DESIGN.md
        §10): the candidates' platforms fastest-first by estimated latency,
        so a device group can seed a reduce node's ``platform_preference``
        with the member most likely to finish first.  Platforms without any
        estimate keep their given order behind every estimated one;
        quarantined records are skipped."""
        sig = abstract_signature(args)
        best: Dict[str, float] = {}        # platform -> cheapest estimate
        order: List[str] = []              # platforms in candidate order
        for rec in candidates:
            if self.is_failed(rec):
                continue
            if rec.platform not in order:
                order.append(rec.platform)
            est = self.estimate(rec, sig, args)
            if est is None:
                continue
            if est < best.get(rec.platform, float("inf")):
                best[rec.platform] = est
        scored = sorted((p for p in order if p in best), key=best.__getitem__)
        return scored + [p for p in order if p not in best]

    def backup_candidate(self, alias: str,
                         candidates: Sequence[KernelRecord],
                         args: Sequence[Any],
                         exclude_platforms: Sequence[str] = ()
                         ) -> Optional[KernelRecord]:
        """The record a straggling graph node should speculatively re-execute
        on (DESIGN.md §11): the best-ranked candidate — :meth:`rank_platforms`
        order, fastest estimated platform first — on a platform other than
        the one(s) already running the node.  Quarantined records are
        skipped; None when no other platform can run it."""
        pool = [c for c in candidates
                if c.platform not in exclude_platforms and not self.is_failed(c)]
        if not pool:
            return None
        for platform in self.rank_platforms(alias, pool, args):
            for rec in pool:
                if rec.platform == platform:
                    return rec
        return pool[0]

    # -- persistence ---------------------------------------------------------
    def load(self, path: os.PathLike) -> None:
        """Ingest a persisted table (loaded keys are not marked warmed)."""
        try:
            table = json.loads(Path(path).read_text())
            entries = [(str(k), int(n), float(ema))
                       for k, (n, ema) in table.items()]
        except (OSError, ValueError, TypeError):
            log.warning("autotune cache %s unreadable; starting cold", path)
            return
        with self._lock:
            for key, n, ema in entries:
                self._measured[key] = [n, ema]

    def save(self, path: Optional[os.PathLike] = None) -> None:
        """Atomically persist the measurement table, merged with what is on
        disk (more kept samples win); a no-op when memory-only."""
        path = Path(path) if path else self.cache_path
        if path is None:
            return
        with self._lock:
            table = {k: list(v) for k, v in self._measured.items()}
        try:
            disk = json.loads(path.read_text())
            for key, ent in disk.items():
                n, ema = int(ent[0]), float(ent[1])
                if key not in table or table[key][0] < n:
                    table[key] = [n, ema]
        except (OSError, ValueError, TypeError, IndexError):
            pass                               # absent/corrupt: ours wins
        tmp = path.with_suffix(path.suffix + ".tmp")
        try:
            tmp.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(table, indent=1, sort_keys=True))
            tmp.replace(path)
        except OSError:
            log.warning("could not persist autotune cache to %s", path,
                        exc_info=True)
