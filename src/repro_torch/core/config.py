"""Typed runtime configuration: the port's ``HALO_*`` knobs in one place —
port of ``repro.core.config``.

:class:`HaloConfig` is one frozen dataclass whose fields document every
knob the port reads and its default.  :func:`halo_config` builds the
effective config at each read — **override > environment > default** —
and :func:`configure` layers process-local typed overrides on top::

    from repro_torch import halo
    halo.configure(health_monitor=True, heartbeat_timeout=5.0)

Overrides are never written back into ``os.environ``.

Only the fields with a reader in the port are kept: the liveness and
straggler knobs (read by ``core/agents.py``'s :class:`HealthConfig` and
:class:`RuntimeAgent`), ``autotune_cache`` (read by
:meth:`CostModelScheduler.default`), ``tuning_db`` (read by
:meth:`TuningDB.default`, ``core/tuning.py``), and the wire-cache cap and
worker knobs (read by ``distributed/remote.py`` and ``launch/worker.py``).
The reference's fusion and compiled-graph cache knobs wait for A9's
remainder: each comes with the module that reads it.  Its ``wire_cache`` switch and ``wire_cache_min`` are
constants of ``distributed/remote.py`` (the cache always on, its floor
``WIRE_CACHE_MIN``) until a second value is needed, and its
``worker_devices`` — XLA's host-device fan-out — has no torch counterpart.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional

from .envutil import env_flag, env_float, env_int, env_path

__all__ = ["HaloConfig", "configure", "halo_config", "reset_config"]


@dataclasses.dataclass(frozen=True)
class HaloConfig:
    """The port's ``HALO_*`` knob surface as typed fields with defaults.

    Each field maps onto the env var of the same upper-snake name with the
    ``HALO_`` prefix (``health_monitor`` ↔ ``HALO_HEALTH_MONITOR``), except
    ``straggler_min_s`` ↔ ``HALO_STRAGGLER_MIN``, as in the reference."""

    # -- liveness / health monitoring (DESIGN.md §11) ----------------------
    #: start the background HealthMonitor sweeper with every session
    health_monitor: bool = False
    #: seconds without a heartbeat before an agent is declared DEAD
    heartbeat_timeout: float = 30.0
    #: sweeper poll interval (None → derived from ``heartbeat_timeout``)
    health_poll: Optional[float] = None
    #: in-flight call is a straggler at ``multiple`` × the median latency
    straggler_multiple: float = 4.0
    #: never flag a straggler under this many seconds in flight
    straggler_min_s: float = 0.25

    # -- autotuning (DESIGN.md §9) -----------------------------------------
    #: path of the persisted scheduler latency table (None → memory only)
    autotune_cache: Optional[str] = None
    #: path of the persisted TuningDB (None → autotune-cache sibling)
    tuning_db: Optional[str] = None

    # -- multi-process workers (DESIGN.md §13) -----------------------------
    #: per-worker pinned-tensor budget in MiB
    wire_cache_mb: int = 256
    #: client-side timeout (s) for one remote execution (None → no limit)
    remote_timeout: Optional[float] = None
    #: seconds to wait for a spawned worker's hello (its kernel build included)
    worker_timeout: float = 120.0
    #: worker-process log level name
    worker_log: str = "WARNING"


_FIELDS = {f.name: f for f in dataclasses.fields(HaloConfig)}

_READERS = {
    "health_monitor": lambda d: env_flag("HALO_HEALTH_MONITOR", d),
    "heartbeat_timeout": lambda d: env_float("HALO_HEARTBEAT_TIMEOUT", d),
    "health_poll": lambda d: env_float("HALO_HEALTH_POLL", d),
    "straggler_multiple": lambda d: env_float("HALO_STRAGGLER_MULTIPLE", d),
    "straggler_min_s": lambda d: env_float("HALO_STRAGGLER_MIN", d),
    "autotune_cache": lambda d: env_path("HALO_AUTOTUNE_CACHE", d),
    "tuning_db": lambda d: env_path("HALO_TUNING_DB", d),
    "wire_cache_mb": lambda d: env_int("HALO_WIRE_CACHE_MB", d),
    "remote_timeout": lambda d: env_float("HALO_REMOTE_TIMEOUT", d),
    "worker_timeout": lambda d: env_float("HALO_WORKER_TIMEOUT", d),
    "worker_log": lambda d: env_path("HALO_WORKER_LOG", d),
}

assert set(_READERS) == set(_FIELDS)

_lock = threading.Lock()
_overrides: Dict[str, Any] = {}


def halo_config() -> HaloConfig:
    """The effective config *right now*: override > env > default.  Rebuilt
    on every call, so a changed environment is seen at once."""
    with _lock:
        ov = dict(_overrides)
    return HaloConfig(**{
        name: ov[name] if name in ov else _READERS[name](field.default)
        for name, field in _FIELDS.items()})


def configure(**overrides: Any) -> HaloConfig:
    """Set process-local typed overrides for ``HALO_*`` knobs.

    Keyword names are :class:`HaloConfig` field names; unknown names raise
    ``TypeError``.  Passing ``None`` for a field clears its override (back
    to env/default).  Returns the new effective config.  Overrides never
    touch ``os.environ``."""
    unknown = [k for k in overrides if k not in _FIELDS]
    if unknown:
        raise TypeError(
            f"unknown HaloConfig field(s) {unknown}; "
            f"have {sorted(_FIELDS)}")
    with _lock:
        for k, v in overrides.items():
            if v is None:
                _overrides.pop(k, None)
            else:
                _overrides[k] = v
    return halo_config()


def reset_config() -> None:
    """Drop every :func:`configure` override (tests / fresh sessions)."""
    with _lock:
        _overrides.clear()
