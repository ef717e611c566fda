"""Shape-bucketed kernel autotuning: TuningDB + sweep driver (DESIGN.md §9)
— port of ``repro.core.tuning``.

The cost-model scheduler (DESIGN.md §4) chooses *between* kernel records;
this module tunes *within* one:

* each tunable :class:`~repro_torch.core.registry.KernelRecord` exposes a
  ``tuning_space`` callable mapping the call's args to a list of feasible
  launch-plan dicts (``record.variants(*args)``): on the card these are the
  Hopper kernels' run-time plans (MMM's route, split count and tile width,
  EW*'s items a thread, RMSNORM's warps a row, SORT's rows a block),
* :func:`autotune` sweeps those variants (best-of-N wall clock, warm-up
  discarded, interleaved rounds, the card synchronised after each call) and
  persists the winner into a :class:`TuningDB` — a small JSON database
  keyed by ``platform|alias|shape-bucket|dtype`` with atomic writes and
  merge-on-save, in the reference's file format,
* the scheduler consults the DB *first* (tuned config → measured EMA →
  cost model → static priority → fail-safe), and the runtime agent merges
  the winning config into the kernel call — host programs never change.

Keys use the reference's dtype names (``float32``, ``bfloat16``), not
``str(torch.float32)``, so one DB file serves both packages.  Shapes are
bucketed to powers of two so one sweep covers its neighborhood; entries
are *frozen* after a sweep so repeat invocations never churn a committed
winner unless ``force=True``.

Lookups sit on the dispatch path, so two things keep them cheap: an empty
DB answers without building a key, and a feasible-entry lookup is memoized
per (record, argument signature) until the DB next changes — a space is a
function of its args' shapes and types, so the answer cannot move between
two calls of one signature.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .registry import KernelRecord
from .scheduler import SigType, abstract_signature
from .tree import tree_leaves

log = logging.getLogger("repro_torch.halo.tuning")

__all__ = [
    "TuneEntry",
    "TuneResult",
    "TuningDB",
    "autotune",
    "config_feasible",
    "dtype_tag",
    "shape_bucket",
    "tuning_key",
]

#: feasible-entry memo size per DB before it is cleared
_MEMO_MAX = 4096
_MISS = object()


def _bucket_dim(d: int) -> int:
    """Power-of-two bucket for one dimension (1 for d ≤ 1)."""
    return 1 if d <= 1 else 1 << (int(d) - 1).bit_length()


def shape_bucket(sig: SigType) -> str:
    """Shape-bucket string for an abstract argument signature.

    Each positional arg contributes its dims rounded up to powers of two
    (``"512x512"``); args are comma-joined and scalars render as ``"-"``."""
    parts = []
    for shape, _ in sig:
        parts.append("x".join(str(_bucket_dim(d)) for d in shape) or "-")
    return ",".join(parts)


def _dtype_name(dt: str) -> str:
    """``"torch.bfloat16"`` → ``"bfloat16"``: the reference's name."""
    return dt[len("torch."):] if dt.startswith("torch.") else dt


def dtype_tag(sig: SigType) -> str:
    """Deduplicated dtype tag for a signature (``"float32"`` or
    ``"float32+bfloat16"`` for mixed-dtype calls), in the reference's
    names."""
    seen: List[str] = []
    for _, dt in sig:
        name = _dtype_name(dt)
        if name not in seen:
            seen.append(name)
    return "+".join(seen) or "-"


def tuning_key(platform: str, alias: str, bucket: str, dtype: str) -> str:
    """The TuningDB primary key: ``platform|alias|shape-bucket|dtype``."""
    return f"{platform}|{alias}|{bucket}|{dtype}"


def config_feasible(record: KernelRecord, config: Dict[str, Any],
                    args: Sequence[Any]) -> bool:
    """True when ``config`` is one of the record's current variants (the
    default ``{}`` always is).  A stale DB entry — tuned for a bucket the
    kernel's space no longer offers for these args — is not feasible, and
    selection falls through to the next rung."""
    if not config:
        return True
    return any(v == config for v in record.variants(*args))


@dataclasses.dataclass
class TuneEntry:
    """One committed TuningDB row: the winning config for a key.

    Attributes:
        config: winning launch-plan kwargs (``{}`` when the default won).
        seconds: best-of-N wall-clock of the winner at sweep time.
        default_seconds: best-of-N wall-clock of the default config.
        repeats: N used for the best-of-N measurement.
        frozen: committed winners are not re-swept unless forced.
        source: provenance tag (``"sweep"`` or ``"seed"``).
    """

    config: Dict[str, Any]
    seconds: float
    default_seconds: float
    repeats: int = 1
    frozen: bool = True
    source: str = "sweep"

    @property
    def speedup(self) -> float:
        """Tuned-over-default gain (1.0 when the default config won)."""
        return self.default_seconds / self.seconds if self.seconds > 0 else 1.0

    def to_json(self) -> Dict[str, Any]:
        """Plain-dict form for the JSON file."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "TuneEntry":
        """Parse one row; raises on malformed input (caller skips the row)."""
        return cls(config=dict(obj["config"]),
                   seconds=float(obj["seconds"]),
                   default_seconds=float(obj["default_seconds"]),
                   repeats=int(obj.get("repeats", 1)),
                   frozen=bool(obj.get("frozen", True)),
                   source=str(obj.get("source", "sweep")))


def _better(a: TuneEntry, b: TuneEntry) -> TuneEntry:
    """Merge rule for two entries under one key: frozen beats unfrozen,
    then the lower (faster) tuned time wins."""
    if a.frozen != b.frozen:
        return a if a.frozen else b
    return a if a.seconds <= b.seconds else b


class TuningDB:
    """Persistent shape-bucketed tuning database (DESIGN.md §9).

    A thread-safe mapping ``platform|alias|shape-bucket|dtype →``
    :class:`TuneEntry`, persisted as versioned JSON (``{"version": 1,
    "entries": …}``) with atomic writes (tmp + rename) and merge-on-save.
    A corrupt or foreign file logs a warning and starts cold — tuning data
    is advisory, never load-bearing.  :attr:`generation` moves with every
    change of the entries, so holders of derived state (compiled graphs
    with resolved member configs) can tell a stale one."""

    VERSION = 1

    def __init__(self, path: Optional[os.PathLike] = None):
        """Create a DB, loading ``path`` if it exists (memory-only when
        ``path`` is None)."""
        self._lock = threading.Lock()
        self._entries: Dict[str, TuneEntry] = {}
        self._memo: Dict[Tuple[int, SigType], Optional[TuneEntry]] = {}
        self.generation = 0
        self.path = Path(path) if path else None
        if self.path is not None and self.path.exists():
            self.load(self.path)

    @classmethod
    def default(cls) -> "TuningDB":
        """Process-default DB: ``HALO_TUNING_DB`` if set, else a
        ``.tuning.json`` sibling of ``HALO_AUTOTUNE_CACHE``, else memory."""
        from .config import halo_config
        hc = halo_config()
        path = hc.tuning_db
        if not path:
            cache = hc.autotune_cache
            if cache:
                path = str(Path(cache).with_suffix(".tuning.json"))
        return cls(path or None)

    def _changed(self) -> None:
        """Caller holds the lock: forget memoized lookups."""
        self._memo.clear()
        self.generation += 1

    # -- lookup ----------------------------------------------------------------
    def key_for(self, record: KernelRecord, sig: SigType) -> str:
        """The record's DB key for one abstract argument signature."""
        return tuning_key(record.platform, record.alias,
                          shape_bucket(sig), dtype_tag(sig))

    def get(self, key: str) -> Optional[TuneEntry]:
        """Entry for a raw key string, or None."""
        with self._lock:
            return self._entries.get(key)

    def lookup(self, record: KernelRecord, sig: SigType) -> Optional[TuneEntry]:
        """Entry for (record, signature), or None — no feasibility check."""
        return self.get(self.key_for(record, sig))

    def _feasible(self, record: KernelRecord, sig: SigType,
                  args: Sequence[Any]) -> Optional[TuneEntry]:
        if not self._entries:              # empty: no key, no variants()
            return None
        memo = (record.uid, sig)
        with self._lock:
            hit = self._memo.get(memo, _MISS)
            gen = self.generation
        if hit is not _MISS:
            return hit
        ent = self.lookup(record, sig)
        if ent is not None and ent.config \
                and not config_feasible(record, ent.config, args):
            log.debug("tuned config %s for %s/%s no longer feasible; "
                      "falling through", ent.config, record.alias,
                      record.platform)
            ent = None
        with self._lock:
            if self.generation == gen:
                if len(self._memo) >= _MEMO_MAX:
                    self._memo.clear()
                self._memo[memo] = ent
        return ent

    def tuned_seconds(self, record: KernelRecord, sig: SigType,
                      args: Sequence[Any]) -> Optional[float]:
        """Sweep-measured seconds for (record, sig) if a feasible entry
        exists — rung 1 of the selection-precedence ladder."""
        ent = self._feasible(record, sig, args)
        return ent.seconds if ent is not None else None

    def tuned_config_for(self, record: KernelRecord, sig: SigType,
                         args: Sequence[Any]) -> Optional[Dict[str, Any]]:
        """Copy of the winning non-default config for (record, sig), or
        None when absent, default-won, or no longer feasible."""
        ent = self._feasible(record, sig, args)
        if ent is None or not ent.config:
            return None
        return dict(ent.config)

    # -- mutation --------------------------------------------------------------
    def put(self, key: str, entry: TuneEntry) -> TuneEntry:
        """Insert/replace the entry for ``key`` (in memory; call
        :meth:`save` to persist)."""
        with self._lock:
            self._entries[key] = entry
            self._changed()
        return entry

    def entries(self) -> Dict[str, TuneEntry]:
        """Snapshot copy of all entries (key → :class:`TuneEntry`)."""
        with self._lock:
            return dict(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- persistence -----------------------------------------------------------
    def load(self, path: os.PathLike) -> int:
        """Ingest a persisted DB file; returns the number of rows loaded.

        Unreadable files or malformed rows are skipped with a warning —
        recovery is always "start cold", never an exception."""
        loaded = 0
        try:
            table = json.loads(Path(path).read_text())
            rows = table["entries"]
            if not isinstance(rows, dict):
                raise TypeError("entries must be a mapping")
        except (OSError, ValueError, TypeError, KeyError):
            log.warning("tuning DB %s unreadable; starting cold", path)
            return 0
        for key, obj in rows.items():
            try:
                ent = TuneEntry.from_json(obj)
            except (TypeError, ValueError, KeyError):
                log.warning("tuning DB %s: skipping malformed row %r",
                            path, key)
                continue
            with self._lock:
                cur = self._entries.get(key)
                self._entries[key] = ent if cur is None else _better(cur, ent)
                self._changed()
            loaded += 1
        return loaded

    def save(self, path: Optional[os.PathLike] = None) -> Optional[Path]:
        """Atomically persist the DB (no-op memory-only); returns the path.

        Merges with whatever is on disk first — the DB is shared across
        sweeps and processes, and a plain overwrite would clobber winners
        another tuner committed since our load.  Conflicts resolve
        frozen-first, then faster-wins."""
        path = Path(path) if path else self.path
        if path is None:
            return None
        with self._lock:
            table = dict(self._entries)
        try:
            disk = json.loads(path.read_text())["entries"]
            for key, obj in disk.items():
                try:
                    ent = TuneEntry.from_json(obj)
                except (TypeError, ValueError, KeyError):
                    continue
                cur = table.get(key)
                table[key] = ent if cur is None else _better(cur, ent)
        except (OSError, ValueError, TypeError, KeyError, AttributeError):
            pass                               # absent/corrupt: ours wins
        payload = {"version": self.VERSION,
                   "entries": {k: table[k].to_json() for k in sorted(table)}}
        tmp = path.with_suffix(path.suffix + ".tmp")
        try:
            tmp.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
            tmp.replace(path)
        except OSError:
            log.warning("could not persist tuning DB to %s", path,
                        exc_info=True)
            return None
        return path


@dataclasses.dataclass
class TuneResult:
    """Outcome of one :func:`autotune` call.

    Attributes:
        record: the swept kernel record.
        key: the TuningDB key the sweep resolved to.
        entry: the committed (or pre-existing frozen) :class:`TuneEntry`.
        swept: False when a frozen entry short-circuited the sweep.
        timings: deterministic ``(config, best_seconds)`` list, default
            config first (empty when ``swept`` is False).
    """

    record: KernelRecord
    key: str
    entry: TuneEntry
    swept: bool
    timings: List[Tuple[Dict[str, Any], float]]


def _wait(out: Any) -> None:
    """Block until ``out``'s first tensor is computed on its device."""
    t = next((x for x in tree_leaves(out) if isinstance(x, torch.Tensor)), None)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def autotune(record: KernelRecord, args: Sequence[Any],
             kwargs: Optional[Dict[str, Any]] = None, *,
             db: Optional[TuningDB] = None, repeats: int = 3,
             warmup: int = 1, force: bool = False, min_gain: float = 1.02,
             timer: Callable[[], float] = time.perf_counter) -> TuneResult:
    """Sweep one record's tuning space for one shape bucket.

    Args:
        record: kernel record to sweep (its ``variants(*args)`` define the
            space; the default config is always swept first).
        args: concrete positional args — the sweep executes on them, and
            their abstract signature picks the shape bucket.
        kwargs: extra keyword args forwarded to every variant call.
        db: TuningDB to read/commit the winner into (frozen); None sweeps
            without persistence.
        repeats: interleaved measurement rounds; each variant keeps its
            best-of-``repeats`` sample.
        warmup: leading samples discarded per variant (kernel build, first
            launch).
        force: re-sweep even when a frozen entry exists.
        min_gain: a non-default winner must beat the default config by at
            least this factor, otherwise the default is committed — noise
            must never displace a known-good configuration.
        timer: injectable clock (tests).

    Each sample times one call and a ``torch.cuda.synchronize`` of its
    output's device.  Measurement is *interleaved*: after per-variant
    warm-up, each round times every variant once (default first), so slow
    drift on a shared host hits all variants alike.  A variant that raises
    is dropped — :attr:`TuneResult.timings` then lacks it; raises
    ``RuntimeError`` only when *no* variant executes.
    """
    args = tuple(args)
    kwargs = dict(kwargs or {})
    sig = abstract_signature(args)
    key = tuning_key(record.platform, record.alias,
                     shape_bucket(sig), dtype_tag(sig))
    if db is not None and not force:
        ent = db.get(key)
        if ent is not None and ent.frozen:
            return TuneResult(record=record, key=key, entry=ent,
                              swept=False, timings=[])

    def _time_once(cfg: Dict[str, Any]) -> float:
        t0 = timer()
        _wait(record.fn(*args, **cfg, **kwargs))
        return timer() - t0

    cfgs: List[Dict[str, Any]] = [dict()]
    cfgs += [v for v in record.variants(*args) if v]
    best: Dict[int, float] = {}
    for i, cfg in enumerate(cfgs):         # per-variant warm-up
        try:
            for _ in range(max(1, warmup)):
                _time_once(cfg)
            best[i] = float("inf")
        except Exception:  # noqa: BLE001 — a bad variant must not abort
            log.debug("variant %s failed for %s/%s; skipping", cfg,
                      record.alias, record.platform, exc_info=True)
    for _ in range(max(1, repeats)):       # interleaved best-of-N rounds
        for i in list(best):
            try:
                best[i] = min(best[i], _time_once(cfgs[i]))
            except Exception:  # noqa: BLE001 — drop from the rotation
                log.debug("variant %s failed mid-sweep for %s/%s", cfgs[i],
                          record.alias, record.platform, exc_info=True)
                del best[i]
    timings = [(cfgs[i], s) for i, s in sorted(best.items())
               if s != float("inf")]
    if not timings:
        raise RuntimeError(
            f"autotune: no variant of {record.alias}/{record.platform} "
            f"executed for bucket {shape_bucket(sig)}")
    best_cfg, best_s = min(timings, key=lambda t: t[1])
    default_s = timings[0][1] if not timings[0][0] else best_s
    if best_cfg and not timings[0][0] and default_s < best_s * min_gain:
        best_cfg, best_s = {}, default_s   # within noise: keep the default
    entry = TuneEntry(config=dict(best_cfg), seconds=best_s,
                      default_seconds=default_s, repeats=repeats,
                      frozen=True, source="sweep")
    if db is not None:
        db.put(key, entry)
    return TuneResult(record=record, key=key, entry=entry, swept=True,
                      timings=timings)
