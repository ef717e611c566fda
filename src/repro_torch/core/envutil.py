"""``HALO_*`` environment-variable parsing (port of ``repro.core.envutil``).

Only the reader the port's knobs use is kept.  An unset or empty variable
yields the default, matching the reference's semantics.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["env_path"]


def env_path(name: str, default: Optional[str] = None) -> Optional[str]:
    """Path-valued knob: unset/empty -> ``default`` (usually None, meaning
    "memory only").  No validation beyond emptiness — the consumer decides
    whether a missing file is cold-start or an error."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw
