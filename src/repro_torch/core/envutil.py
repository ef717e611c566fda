"""``HALO_*`` environment-variable parsing (port of ``repro.core.envutil``).

Only the readers the port's knobs use are kept (``core/config.py``).
Semantics shared by all of them, as in the reference: an unset or empty
variable yields the default; a present but unparsable value logs a warning
and yields the default, so a typo'd knob never raises inside an init path.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger("repro_torch.halo.env")

__all__ = ["env_flag", "env_float", "env_int", "env_path"]


def env_int(name: str, default: int) -> int:
    """``int(os.environ[name])`` with warn-and-fallback on malformed values."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("ignoring non-integer %s=%r (using default %r)",
                    name, raw, default)
        return default


def env_float(name: str, default: Optional[float]) -> Optional[float]:
    """``float(os.environ[name])`` with warn-and-fallback on malformed
    values.  ``default`` may be None for knobs whose unset state is
    meaningful (``HALO_HEALTH_POLL`` -> derive from the timeout)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring non-numeric %s=%r (using default %r)",
                    name, raw, default)
        return default


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset/empty -> ``default``; ``"0"`` -> False; any other
    value -> True (``HALO_HEALTH_MONITOR=yes`` means on)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw != "0"


def env_path(name: str, default: Optional[str] = None) -> Optional[str]:
    """Path-valued knob: unset/empty -> ``default`` (usually None, meaning
    "memory only").  No validation beyond emptiness — the consumer decides
    whether a missing file is cold-start or an error."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw
