"""Failure detection and straggler mitigation bookkeeping — port of
``repro.train.fault_tolerance``.

The host-side machinery a launcher consumes:

* :class:`HeartbeatJournal` — each controller appends (step, wall-time)
  records to a journal file; a supervisor (or the launcher's watchdog)
  declares a worker dead when its journal goes stale past ``stall_after_s``
  and triggers checkpoint-restart (checkpoints store every leaf whole).
* :class:`StragglerPolicy` — per-step wall-time tracker flagging outliers
  (> ``factor`` × rolling median); its recommendation is to drain the
  slow host at the next checkpoint boundary.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import List, Optional


@dataclasses.dataclass
class HeartbeatJournal:
    path: str
    worker: str = "worker-0"

    def __post_init__(self):
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int, t: Optional[float] = None) -> None:
        rec = {"worker": self.worker, "step": step,
               "t": time.time() if t is None else t}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def last_beat(self) -> Optional[dict]:
        p = Path(self.path)
        if not p.exists():
            return None
        lines = p.read_text().strip().splitlines()
        return json.loads(lines[-1]) if lines else None

    def stalled(self, stall_after_s: float, now: Optional[float] = None) -> bool:
        last = self.last_beat()
        if last is None:
            return True
        now = time.time() if now is None else now
        return (now - last["t"]) > stall_after_s

    def resume_step(self) -> int:
        last = self.last_beat()
        return 0 if last is None else int(last["step"])


@dataclasses.dataclass
class StragglerPolicy:
    """Flags slow steps/hosts; window-based rolling median."""
    factor: float = 3.0
    window: int = 50
    _times: List[float] = dataclasses.field(default_factory=list)

    def observe(self, step_seconds: float) -> bool:
        """Record a step time; returns True when it is a straggler event."""
        history = self._times[-self.window:]
        self._times.append(step_seconds)
        if len(history) < 5:
            return False
        med = statistics.median(history)
        return step_seconds > self.factor * med

    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0

    def recommendation(self) -> str:
        """What the launcher should do (consumed by launch scripts)."""
        if not self._times:
            return "ok"
        if self._times[-1] > self.factor * max(self.median(), 1e-9):
            return "drain-slow-host-at-next-checkpoint"
        return "ok"
