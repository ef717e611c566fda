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

Records with no estimate are left to the static selection order.  A record
whose execution raised is quarantined (:meth:`mark_failed`) until
:meth:`clear_failures`.  The reference's other estimate sources — its
TuningDB sweep results and the records' analytic cost models — are not
ported yet.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .envutil import env_path
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

    def __init__(self, cache_path: Optional[os.PathLike] = None,
                 explore_every: Optional[int] = None,
                 explore_offset: int = 0):
        """``explore_every``/``explore_offset`` inject the exploration
        policy: every Nth :meth:`choose` per key explores, starting the
        per-key counter at ``offset`` (0/None disables exploration)."""
        self._lock = threading.Lock()
        # key -> [n_observations, ema_seconds]; n counts *kept* samples
        self._measured: Dict[str, List[float]] = {}
        self._warmed: Dict[str, bool] = {}
        self._attempts: Dict[str, int] = {}    # wants_sample() call counts
        self._chooses: Dict[str, int] = {}     # choose() call counts per key
        self._failed: Dict[str, int] = {}      # record key -> failure count
        self._since_save = 0
        if explore_every is not None:
            self.explore_every = explore_every or None
        self.explore_offset = explore_offset
        self.cache_path = Path(cache_path) if cache_path else None
        if self.cache_path is not None and self.cache_path.exists():
            self.load(self.cache_path)

    @classmethod
    def default(cls) -> "CostModelScheduler":
        """Process-default scheduler: persistent iff ``HALO_AUTOTUNE_CACHE``
        is set."""
        return cls(cache_path=env_path("HALO_AUTOTUNE_CACHE"))

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
    def mark_failed(self, record: KernelRecord) -> None:
        """Quarantine a record whose execution raised: selection skips it
        until :meth:`clear_failures`.  Process-local, never persisted."""
        key = _record_key(record)
        with self._lock:
            self._failed[key] = self._failed.get(key, 0) + 1

    def failed_record_keys(self) -> List[str]:
        """The currently-quarantined record keys (``alias|platform|prio:ver``)."""
        with self._lock:
            return sorted(self._failed)

    def is_failed(self, record: KernelRecord) -> bool:
        with self._lock:
            return _record_key(record) in self._failed

    def clear_failures(self) -> None:
        with self._lock:
            self._failed.clear()

    # -- selection -----------------------------------------------------------
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
        estimates = [self.measured(rec, sig) for rec in candidates]
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
