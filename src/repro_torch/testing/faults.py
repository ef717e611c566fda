"""Fault-injection harness for the self-healing runtime (DESIGN.md §11) —
port of ``repro.testing.faults``.

Every fault-path test injects failures through this module, so the failure
modes the runtime claims to survive are named, reusable, and exercised
identically everywhere:

* :class:`FaultPlan` — a declarative description of one substrate's
  misbehavior: *raise* on the Nth device call (optionally for a bounded
  number of calls — flaky-then-recover), *hang* (straggle for ``delay_s``
  then finish, feeding the straggler-speculation path), or *die* (wedge the
  worker until released, feeding the heartbeat/DEAD path).  Faults can be
  restricted to specific kernel aliases.
* :class:`FaultyAgent` — a virtualization agent executing the plan.  Its
  non-faulting calls execute through a real agent of its platform — the
  one it replaces in a session, or one built on the given device — so a
  hopper fault agent launches the same kernels bit for bit and only the
  *injected* behavior differs.
* :func:`chaos` — a context manager that swaps fault agents into a live
  :class:`~repro_torch.core.agents.RuntimeAgent` session and restores the
  originals on exit: wedged calls are released, replaced agents
  re-attached, and scheduler quarantine cleared, so one test's chaos never
  leaks into the next.
* :func:`engine_chaos` — the serving-path counterpart: a serving engine
  calls its model directly, not through an agent, so :class:`FaultyAgent`
  never sees a decode call.  ``engine_chaos`` wraps a serving engine's
  host entry point ``decode_step`` with the same :class:`FaultPlan`
  semantics instead.
* :func:`failing` / :func:`faulty_record` — the record-level counterparts:
  a kernel function, and a registry record around it, that always raise,
  for paths where the *record* is bad (quarantine, re-placement, fail-safe
  ladders, a worker's quarantine passed to the host) rather than the agent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Union)

from ..core.agents import (AtenAgent, HopperAgent, RuntimeAgent, TorchAgent,
                           VirtualizationAgent)
from ..core.registry import KernelRecord

__all__ = ["EngineFault", "FaultError", "FaultPlan", "FaultyAgent", "chaos",
           "engine_chaos", "failing", "faulty_record"]

_MODES = ("raise", "hang", "die")


class FaultError(RuntimeError):
    """Default error type raised by injected faults — distinct from real
    runtime errors so tests can assert the injected failure (and nothing
    else) propagated."""


@dataclasses.dataclass
class FaultPlan:
    """One substrate's scripted misbehavior.

    ``mode`` selects the failure family:

    * ``"raise"`` — device calls ``nth`` .. ``nth + times - 1`` (1-based;
      ``times=None`` means every call from ``nth`` on) raise
      :class:`FaultError`.
      ``times`` bounds the fault window, giving flaky-then-recover.
    * ``"hang"`` — faulting calls straggle: block for ``delay_s`` seconds
      (or until :meth:`FaultyAgent.release`), then run the real kernel and
      succeed.  Exercises straggler speculation.
    * ``"die"`` — faulting calls wedge the worker until
      :meth:`FaultyAgent.release`, then fail.  The agent stops heartbeating
      mid-request: exercises DEAD detection, membership re-bind and queue
      replay.

    ``aliases`` restricts faults to those kernel aliases (others execute
    normally and do not advance the call count)."""
    platform: str = "aten"
    mode: str = "raise"
    nth: int = 1
    times: Optional[int] = None
    delay_s: float = 0.0
    aliases: Optional[Sequence[str]] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.nth < 1:
            raise ValueError(f"nth is 1-based and must be >= 1, got {self.nth}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times}")

    def applies(self, call_index: int) -> bool:
        """Whether the ``call_index``-th targeted device call faults."""
        if call_index < self.nth:
            return False
        return self.times is None or call_index < self.nth + self.times


def _substrate(platform: str, device) -> VirtualizationAgent:
    """A healthy agent of ``platform`` (the hopper one bound to ``device``)
    for a fault agent to execute its non-faulting calls through."""
    if platform == "hopper":
        return HopperAgent(device)
    return {"torch": TorchAgent, "aten": AtenAgent}.get(
        platform, VirtualizationAgent)()


class _Gate:
    """The fault plan's call counter and release event, shared by
    :class:`FaultyAgent` and :class:`EngineFault`: ``calls`` counts targeted
    calls, ``failures`` the ones that faulted (both readable from the test
    thread while a worker runs); ``release()`` unblocks hang/die waits."""

    def _init_gate(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.calls = 0
        self.failures = 0
        self._fault_lock = threading.Lock()
        self._release = threading.Event()

    def release(self) -> None:
        """Unblock every in-flight and future hang/die wait."""
        self._release.set()

    def _faulted(self, call: Callable[[], Any]) -> Any:
        """Count one targeted call and run it under the plan."""
        plan = self.plan
        with self._fault_lock:
            self.calls += 1
            n = self.calls
            hit = plan.applies(n)
            if hit:
                self.failures += 1
        if not hit:
            return call()
        if plan.mode == "raise":
            raise FaultError("injected fault: device lost")
        if plan.mode == "hang":
            # straggle, then finish correctly on the real path
            self._release.wait(plan.delay_s if plan.delay_s > 0 else None)
            return call()
        # "die": wedge mid-request until released, then fail — the stalled
        # heartbeat is the point
        self._release.wait()
        raise FaultError("injected fault: device lost")


class FaultyAgent(_Gate, VirtualizationAgent):
    """A virtualization agent that executes a :class:`FaultPlan`.

    Its non-faulting calls (and a hang's late call) execute through
    ``inner``: the agent it stands in for, or a fresh healthy agent of its
    platform bound to ``device``.  Counters and ``release()`` as in
    :class:`_Gate`; :func:`chaos` releases on exit so no test leaves a
    wedged worker behind."""

    def __init__(self, plan: FaultPlan, *,
                 inner: Optional[VirtualizationAgent] = None, device="cpu"):
        # instance attr must shadow the class attr before super().__init__
        # reads it for the default agent name
        self.platform = plan.platform
        VirtualizationAgent.__init__(self, name=f"faulty-{plan.platform}")
        self._init_gate(plan)
        self._inner = inner if inner is not None \
            else _substrate(plan.platform, device)

    def _device_execute(self, record: KernelRecord, args, kwargs):
        call = lambda: self._inner._device_execute(record, args, kwargs)
        if self.plan.aliases is not None and record.alias not in self.plan.aliases:
            return call()
        return self._faulted(call)


@contextlib.contextmanager
def chaos(session: RuntimeAgent, *plans: FaultPlan
          ) -> Iterator[Union[FaultyAgent, List[FaultyAgent]]]:
    """Swap :class:`FaultyAgent` s into ``session`` for the block's duration.

    Each plan replaces the session agent on its platform and executes through it.  Yields the
    single agent, or the list when several plans are given.  On exit —
    success or test failure — wedged calls are released, the original
    agents are re-attached (or the platform detached if it had none), the
    fault agents' workers shut down, and the scheduler's quarantine set is
    cleared so record failures provoked here do not bias placement in later
    tests."""
    if not plans:
        raise ValueError("chaos() needs at least one FaultPlan")
    seen = [p.platform for p in plans]
    if len(set(seen)) != len(seen):
        raise ValueError(f"one plan per platform, got {seen}")
    originals: Dict[str, Optional[VirtualizationAgent]] = {
        p.platform: session.agents.get(p.platform) for p in plans}
    agents = [FaultyAgent(p, inner=originals[p.platform],
                          device=session.device) for p in plans]
    for fa in agents:
        session.attach_agent(fa)
    try:
        yield agents[0] if len(agents) == 1 else agents
    finally:
        for fa in agents:
            fa.release()
        for fa in agents:
            orig = originals.get(fa.platform)
            if session.agents.get(fa.platform) is fa:
                if orig is not None:
                    session.attach_agent(orig)
                else:
                    session.detach_agent(fa.platform)
            fa.shutdown(cancel_pending=True, wait=False)
        sched = getattr(session, "scheduler", None)
        if sched is not None:
            sched.clear_failures()


class EngineFault(_Gate):
    """Executes a :class:`FaultPlan` against an engine's ``decode_step``.

    A serving engine calls its model directly, so agent-level fault
    injection (:class:`FaultyAgent`) cannot reach it.  This adapter patches
    the *host* entry point instead and applies the plan's raise/hang/die
    semantics at the call boundary, which is where a lost device surfaces
    to the scheduler.  Counters and ``release()`` as in :class:`_Gate`.

    ``plan.aliases`` is ignored (the patched method *is* the target);
    ``plan.platform`` is informational only."""

    method = "decode_step"

    def __init__(self, target: Any, plan: FaultPlan):
        self.target = target
        self._init_gate(plan)
        self._orig: Optional[Callable[..., Any]] = None

    def _wrapped(self, *args, **kwargs):
        return self._faulted(lambda: self._orig(*args, **kwargs))

    def install(self) -> "EngineFault":
        if self._orig is not None:
            raise RuntimeError("EngineFault already installed")
        # remember whether the method lived on the instance or on the class:
        # uninstall must restore the same arrangement, not pin a bound method
        self._was_instance_attr = self.method in vars(self.target)
        self._orig = getattr(self.target, self.method)
        setattr(self.target, self.method, self._wrapped)
        return self

    def uninstall(self) -> None:
        if self._orig is None:
            return
        if self._was_instance_attr:
            setattr(self.target, self.method, self._orig)
        else:
            delattr(self.target, self.method)
        self._orig = None


@contextlib.contextmanager
def engine_chaos(engine: Any, **plan_fields) -> Iterator[EngineFault]:
    """Patch ``engine.decode_step`` with the :class:`FaultPlan` of
    ``plan_fields`` for the block's duration.  On exit — success or test failure — wedged calls are
    released and the original method restored::

        with engine_chaos(paged, mode="raise", nth=3) as fault:
            ... drive the scheduler ...
        assert fault.failures == 1
    """
    fault = EngineFault(engine, FaultPlan(**plan_fields)).install()
    try:
        yield fault
    finally:
        fault.release()
        fault.uninstall()



def failing(message: str = "injected fault",
            exc_type: type = FaultError,
            calls: Optional[list] = None) -> Callable[..., Any]:
    """A kernel function that always raises ``exc_type(message)``.

    Pass ``calls`` (any list) to record each invocation's positional args —
    tests assert on attempt counts without a bespoke closure every time."""
    def _boom(*args, **kwargs):
        if calls is not None:
            calls.append(args)
        raise exc_type(message)
    return _boom


def faulty_record(alias: str, platform: str = "aten", priority: int = 50,
                  message: Optional[str] = None,
                  exc_type: type = FaultError,
                  is_failsafe: bool = False) -> KernelRecord:
    """A registry record whose kernel always raises — the record-level
    counterpart of :class:`FaultyAgent`, for paths where the *record* is bad
    (quarantine, re-placement, fail-safe ladders) rather than the agent."""
    message = message or f"injected fault: {alias} on {platform} died"
    return KernelRecord(alias=alias, fn=failing(message, exc_type),
                        platform=platform, priority=priority,
                        is_failsafe=is_failsafe)
