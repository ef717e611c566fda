"""Agent liveness in the port (DESIGN.md §11), held against the JAX package:
heartbeat detection, DEAD-agent queue replay, the health knobs, and the
serving scheduler's lane failure — the cases of tests/test_health.py, each
run through the reference and the port, with the same scripted
``heartbeat``/``now`` sequences driven through both monitors and their
state maps compared.  The port's own cases: an idle agent holds no
finished request, and a card session builds its kernel library before a
monitor watches the hopper agent (the build hook stubbed: this host has
no ``nvcc``).

Every monitor sweep takes an injected clock (``check(now=...)``), so the
transitions are deterministic; no test sleeps longer than a few hundred
milliseconds, and every wait is bounded.  MMM results are compared with
the plain version bit for bit and with the JAX dispatch within the
float32 parity tolerance (2e-4)."""
import dataclasses
import gc
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HealthConfig as JHealthConfig
from repro.core import HealthMonitor as JHealthMonitor
from repro.core import KernelRegistry as JRegistry
from repro.core import RuntimeAgent as JAgent
from repro.core import default_manifest as j_manifest
from repro.kernels import register_all as j_register_all
from repro.serve.engine import Request as JRequest
from repro.serve.engine import StepScheduler as JStepScheduler
from repro.serve.engine import _Lane as JLane
from repro.testing.faults import FaultPlan as JFaultPlan
from repro.testing.faults import chaos as j_chaos
from repro_torch.core import config as t_config
from repro_torch.core.agents import (DEGRADED_FRACTION, AgentDeadError,
                                     AgentState, AtenAgent, HaloFuture,
                                     HealthConfig, HealthMonitor, HopperAgent,
                                     RuntimeAgent, TorchAgent)
from repro_torch.core.manifest import default_manifest
from repro_torch.core.registry import KernelRegistry
from repro_torch.kernels import _cuda, register_all
from repro_torch.kernels.matmul.ref import mmm_ref
from repro_torch.serve.engine import Request, StepScheduler, _Lane
from repro_torch.testing.faults import FaultPlan, chaos

TOL = 2e-4
TIMEOUT = 30


@pytest.fixture(autouse=True)
def _fresh_port_config():
    """The port's typed overrides are process state: none leaks across
    tests (the ambient HALO_* variables are stripped by conftest.py)."""
    t_config.reset_config()
    yield
    t_config.reset_config()


def _port_session(**kw):
    registry = KernelRegistry()
    register_all(registry)
    return RuntimeAgent(registry=registry, manifest=default_manifest(),
                        device="cpu", **kw)


def _ref_session():
    registry = JRegistry()
    j_register_all(registry)
    return JAgent(registry=registry, manifest=j_manifest())


@pytest.fixture()
def session():
    s = _port_session()
    yield s
    s.finalize()


@pytest.fixture()
def jsession():
    s = _ref_session()
    yield s
    s.finalize()


def _wait_until(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} not reached in time"
        time.sleep(0.005)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pin(*platforms):
    return {"allowed_platforms": list(platforms),
            "platform_preference": list(platforms)}


class _Scripted:
    """A heartbeat target whose ``(beats, busy, last)`` a test sets."""

    def __init__(self, name, beats=0, busy=False, last=0.0):
        self.name = name
        self.beat = (beats, busy, last)

    def heartbeat(self):
        return self.beat


# -- config knobs -------------------------------------------------------------
def _fields(cfg):
    """The port's HealthConfig as the reference's fields: its DEGRADED
    share is a module constant, not a field."""
    return dict(dataclasses.asdict(cfg), degraded_fraction=DEGRADED_FRACTION)


def test_health_config_from_env(monkeypatch):
    monkeypatch.setenv("HALO_HEARTBEAT_TIMEOUT", "2.5")
    monkeypatch.setenv("HALO_HEALTH_POLL", "0.5")
    monkeypatch.setenv("HALO_STRAGGLER_MULTIPLE", "3")
    monkeypatch.setenv("HALO_STRAGGLER_MIN", "0.125")
    cfg, jcfg = HealthConfig.from_env(), JHealthConfig.from_env()
    assert _fields(cfg) == dataclasses.asdict(jcfg)
    assert cfg.heartbeat_timeout == 2.5
    assert cfg.poll_interval == 0.5 and cfg.effective_poll == 0.5
    assert cfg.straggler_multiple == 3.0 and cfg.straggler_min_s == 0.125
    # explicit keyword overrides beat the environment
    assert HealthConfig.from_env(heartbeat_timeout=9.0).heartbeat_timeout \
        == JHealthConfig.from_env(heartbeat_timeout=9.0).heartbeat_timeout == 9.0
    # junk values fall back to defaults instead of crashing startup
    monkeypatch.setenv("HALO_HEARTBEAT_TIMEOUT", "banana")
    assert HealthConfig.from_env().heartbeat_timeout \
        == JHealthConfig.from_env().heartbeat_timeout == 30.0
    # halo.configure overrides reach the health knobs, over the environment
    t_config.configure(heartbeat_timeout=4.0)
    assert HealthConfig.from_env().heartbeat_timeout == 4.0


def test_effective_poll_defaults_to_quarter_timeout():
    for cls in (HealthConfig, JHealthConfig):
        assert cls(heartbeat_timeout=8.0).effective_poll == 2.0
        assert cls(heartbeat_timeout=8.0, poll_interval=0.1).effective_poll == 0.1
        assert cls(heartbeat_timeout=0.0).effective_poll == 1e-3
    assert _fields(HealthConfig()) == dataclasses.asdict(JHealthConfig())


def test_env_auto_enables_monitor(monkeypatch):
    monkeypatch.setenv("HALO_HEALTH_MONITOR", "1")
    s, js = _port_session(), _ref_session()
    try:
        assert s.health is not None and js.health is not None
        assert s.health._thread is not None and s.health._thread.is_alive()
        assert sorted(s.health.check().values()) == [AgentState.HEALTHY] * 3
    finally:
        s.finalize()
        js.finalize()
    assert s.health._thread is None          # finalize stopped the sweeper
    monkeypatch.setenv("HALO_HEALTH_MONITOR", "0")
    s = _port_session()
    try:
        assert s.health is None
    finally:
        s.finalize()


# -- heartbeat classification -------------------------------------------------
@pytest.mark.parametrize("script", [
    # (busy, seconds since the last beat) per sweep, timeout 1.0
    [(True, 0.1), (True, 0.5), (True, 0.9), (True, 1.0), (False, 5.0)],
    [(True, 0.6), (False, 0.6), (True, 0.2), (True, 2.0)],
    [(False, 1e6), (True, 0.49), (True, 0.51), (False, 0.0)],
], ids=["degrade-die-sticky", "recover-then-die", "idle-never-ages"])
def test_scripted_heartbeats_match_reference(script):
    """The same scripted (beats, busy, last) sequence and sweep clock through
    both monitors: equal state maps after every sweep, equal transition
    logs."""
    logs = {"port": [], "ref": []}
    mons = {"port": HealthMonitor(HealthConfig(heartbeat_timeout=1.0)),
            "ref": JHealthMonitor(JHealthConfig(heartbeat_timeout=1.0))}
    targets = {}
    for side, mon in mons.items():
        targets[side] = [_Scripted("a"), _Scripted("b")]
        for t in targets[side]:
            mon.register(t)
        mon.on_transition(lambda t, o, n, _l=logs[side]: _l.append((t.name, o, n)))
    now = 100.0
    for step, (busy, stalled) in enumerate(script):
        maps = {}
        for side, mon in mons.items():
            a, b = targets[side]
            a.beat = (step, busy, now - stalled)
            b.beat = (step, not busy, now)             # the other one fresh
            maps[side] = mon.check(now=now)
        assert maps["port"] == maps["ref"]
        now += 1.0
    assert logs["port"] == logs["ref"]


def test_idle_agents_stay_healthy(session, jsession):
    mon = session.enable_health_monitor(
        config=HealthConfig(heartbeat_timeout=0.2), start=False)
    jmon = jsession.enable_health_monitor(
        config=JHealthConfig(heartbeat_timeout=0.2), start=False)
    # far-future sweep: idle targets never degrade, however stale their clock
    states = mon.check(now=time.monotonic() + 1e6)
    jstates = jmon.check(now=time.monotonic() + 1e6)
    assert set(states.values()) == set(jstates.values()) == {AgentState.HEALTHY}
    assert len(states) == len(session.agents)


def test_completed_work_advances_heartbeat(session):
    agent = session.agents["torch"]
    beats0, _, _ = agent.heartbeat()
    cr = session.claim("MMM", overrides=_pin("torch"))
    session.send((torch.eye(4), torch.eye(4)), cr)
    session.recv(cr)
    # a claim beat and a completion beat (which may land just after recv)
    _wait_until(lambda: agent.heartbeat()[0] >= beats0 + 2, what="two beats")
    _wait_until(lambda: not agent.heartbeat()[1], what="agent idle")


def test_idle_agent_holds_no_finished_request(session):
    """An agent's worker drops its finished request before it waits for
    the next one (the comm-mode training memory fix): once idle, neither
    ``_current`` nor the worker's frame keeps the result alive."""
    agent = session.agents["torch"]

    class Box:
        pass

    box = Box()
    ref = weakref.ref(box)
    # the thunk, the after hook and the replay hook each hold the result
    fut = agent.submit(lambda b=box: b, after=lambda out, t0, b=box: None,
                       replay=lambda b=box: None)
    assert fut.result(TIMEOUT) is box
    _wait_until(lambda: not agent.heartbeat()[1], what="agent idle")
    assert agent._current is None
    del fut, box
    # the worker clears its frame's locals before it blocks on the queue
    _wait_until(lambda: gc.collect() >= 0 and ref() is None,
                what="finished request freed")


def _hung_ref_states(jsession, a):
    """The reference's DEGRADED/DEAD arc for the same wedge and clock."""
    jsession.enable_health_monitor(
        config=JHealthConfig(heartbeat_timeout=0.2, degraded_fraction=0.5),
        start=False)
    with j_chaos(jsession, JFaultPlan(platform="xla", mode="die")) as faulty:
        cr = jsession.claim("MMM", overrides=_pin("xla", "jnp"))
        fut = jsession.isend((jnp.asarray(a), jnp.asarray(a)), cr, mailbox=False)
        _wait_until(lambda: faulty.failures >= 1, what="reference worker wedged")
        _, busy, last = faulty.heartbeat()
        assert busy
        states = [jsession.health.check(now=last + dt)[faulty.name]
                  for dt in (0.05, 0.11, 0.21)]
        out = np.asarray(fut.result(timeout=TIMEOUT))
    return states, out


def test_hung_worker_degrades_then_dies_and_replays(session, jsession):
    """The full arc, clock-driven: a wedged aten worker is DEGRADED at half
    the timeout, DEAD at the timeout (the reference's xla worker on the
    same clock gives the same states), and its in-flight request is
    replayed onto the fail-safe torch row with the plain result."""
    a = _np((16, 16), 0)
    jstates, jout = _hung_ref_states(jsession, a)
    mon = session.enable_health_monitor(
        config=HealthConfig(heartbeat_timeout=0.2), start=False)
    ta = torch.from_numpy(a)
    with chaos(session, FaultPlan(platform="aten", mode="die")) as faulty:
        cr = session.claim("MMM", overrides=_pin("aten", "torch"))
        fut = session.isend((ta, ta), cr, mailbox=False)
        _wait_until(lambda: faulty.failures >= 1, what="worker wedged")
        _, busy, last = faulty.heartbeat()
        assert busy
        states = [mon.check(now=last + dt)[faulty.name]
                  for dt in (0.05, 0.11, 0.21)]
        assert states == jstates == [AgentState.HEALTHY, AgentState.DEGRADED,
                                     AgentState.DEAD]
        # DEAD is sticky and the transition already healed the session:
        assert faulty.dead and not faulty.available()
        with pytest.raises(AgentDeadError):
            faulty.submit(lambda: None)
        out = fut.result(timeout=TIMEOUT)
    assert torch.equal(out, mmm_ref(ta, ta))
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)


def test_dead_agent_replays_whole_queue(session):
    """In-flight AND still-queued requests of a dead agent all complete on
    the fail-safe substrate."""
    mats = [torch.from_numpy(_np((12, 12), i)) for i in range(3)]
    with chaos(session, FaultPlan(platform="aten", mode="die")) as faulty:
        cr = session.claim("MMM", overrides=_pin("aten", "torch"))
        futs = [session.isend((m, m), cr, mailbox=False) for m in mats]
        _wait_until(lambda: faulty.failures >= 1, what="worker wedged")
        assert session.handle_dead_agent(faulty, reason="test kill") == 3
        for m, f in zip(mats, futs):
            assert torch.equal(f.result(timeout=TIMEOUT), mmm_ref(m, m))
        assert faulty.dead
        # idempotent: a second declaration finds nothing left to recover
        assert session.handle_dead_agent(faulty) == 0


def test_reregistration_resets_dead_state(session, jsession):
    for sess, cfg, platform in ((session, HealthConfig, "torch"),
                                (jsession, JHealthConfig, "jnp")):
        mon = sess.enable_health_monitor(config=cfg(heartbeat_timeout=0.2),
                                         start=False)
        agent = sess.agents[platform]
        mon.mark_dead(agent)
        assert mon.state(agent) == AgentState.DEAD
        mon.register(agent)           # explicit recovery path
        assert mon.state(agent) == AgentState.HEALTHY


def test_watch_fires_once_and_unwatch_cancels():
    fired = {"port": [], "ref": []}
    for side, mon in (("port", HealthMonitor(HealthConfig(heartbeat_timeout=1.0))),
                      ("ref", JHealthMonitor(JHealthConfig(heartbeat_timeout=1.0)))):
        now = 100.0
        tok1 = mon.watch(now + 0.05, lambda _f=fired[side]: _f.append(1))
        tok2 = mon.watch(now + 0.05, lambda _f=fired[side]: _f.append(2))
        mon.unwatch(tok2)
        mon.unwatch(None)             # no token: nothing to cancel
        mon.check(now=now)            # before the deadline: nothing fires
        assert fired[side] == []
        mon.check(now=now + 0.1)
        mon.check(now=now + 0.2)      # one-shot: no refire
        assert tok1 != tok2
    assert fired["port"] == fired["ref"] == [1]


# -- serving lane failure -----------------------------------------------------
class _StubEngine:
    """Engine stand-in: the scheduler reads slots/max_len/device until a
    step runs work, which these tests never do (the point is the hang)."""
    slots = 2
    max_len = 64
    device = torch.device("cpu")


def _wedge_lane(sched, lane_cls, request_cls, future):
    req = request_cls(99, [1, 2], 8, future=future)
    with sched._cond:
        sched._lanes[0] = lane_cls(req, pos=2, last_tok=1, tokens=[1])


def test_slot_scheduler_heartbeat_and_dead_failure():
    """A serving scheduler nobody steps goes DEAD on the same clock as the
    reference's, and every queued request and occupied lane fails with
    AgentDeadError instead of blocking its client forever."""
    from repro.core import HaloFuture as JHaloFuture
    results = {}
    for side, (Sched, Mon, Cfg, Fut, Lane, Req) in {
            "port": (StepScheduler, HealthMonitor, HealthConfig, HaloFuture,
                     _Lane, Request),
            "ref": (JStepScheduler, JHealthMonitor, JHealthConfig, JHaloFuture,
                    JLane, JRequest)}.items():
        sched = Sched(_StubEngine())
        mon = Mon(Cfg(heartbeat_timeout=0.2))
        sched.attach_health(mon)
        queued = sched.submit([1, 2, 3], max_new=4)
        lane_fut = Fut(uid=99, alias="generate")
        _wedge_lane(sched, Lane, Req, lane_fut)
        _, busy, last = sched.heartbeat()
        assert busy
        states = [mon.check(now=last + dt)[sched.name] for dt in (0.05, 0.11, 0.3)]
        errors = []
        for f in (queued, lane_fut):
            with pytest.raises(RuntimeError) as info:
                f.result(timeout=5)
            errors.append(type(info.value).__name__)
        assert sched.pending() == 0 and sched.active() == 0
        results[side] = (states, errors)
    assert results["port"] == results["ref"]
    assert results["port"][0][-1] == AgentState.DEAD
    assert results["port"][1] == ["AgentDeadError"] * 2


def test_slot_scheduler_step_advances_beat():
    for Sched in (StepScheduler, JStepScheduler):
        sched = Sched(_StubEngine())
        beats0, busy, _ = sched.heartbeat()
        assert not busy
        assert sched.step() is False        # idle step: no work, still beats
        beats1, _, _ = sched.heartbeat()
        assert beats1 > beats0


# -- a cold kernel build is not a stall ---------------------------------------
class _StubBuild:
    """Stands in for ``_cuda.lib``: the first call is a cold build that
    takes ``seconds``, later calls return at once; the log records each
    call beside the monitor registrations."""

    def __init__(self, log, seconds):
        self.log, self.seconds, self.built = log, seconds, False

    def __call__(self):
        self.log.append("build")
        if not self.built:
            time.sleep(self.seconds)
            self.built = True


def _card_session(monkeypatch, log, seconds=0.0, **kw):
    """A session whose device is the card but whose hopper agent runs on
    the host (no card here): only the monitor's build rule reads it."""
    monkeypatch.setattr(_cuda, "lib", _StubBuild(log, seconds))
    registry = KernelRegistry()
    register_all(registry)
    return RuntimeAgent(registry=registry, manifest=default_manifest(),
                        agents=[TorchAgent(), AtenAgent(), HopperAgent("cpu")],
                        device="cuda", **kw)


def test_card_session_builds_the_kernel_library_before_watching(monkeypatch):
    """Both ways a monitor reaches a card session — ``health=`` and
    ``enable_health_monitor`` — build the kernel library before the first
    agent is registered; a host session builds nothing."""
    log = []

    class Recording(HealthMonitor):
        def register(self, target):
            log.append(f"register {target.name}")
            super().register(target)

    s = _card_session(monkeypatch, log, health=Recording(HealthConfig()))
    try:
        assert log[0] == "build" and "register hopper-agent" in log[1:]
        del log[:]
        s.enable_health_monitor(monitor=Recording(HealthConfig()), start=False)
        assert log[0] == "build" and len(log) == 4
    finally:
        s.finalize()
    del log[:]
    s = _port_session(health=Recording(HealthConfig()))
    try:
        assert "build" not in log and len(log) == 3
    finally:
        s.finalize()


def test_monitor_on_a_cold_build_does_not_kill_the_hopper_agent(monkeypatch):
    """HALO_HEALTH_MONITOR with a 0.1 s timeout and a 0.3 s cold build: the
    card session builds while it starts, so the hopper agent's first
    launch (the thunk calls the build hook, as a kernel's first launch
    does) returns at once and the agent stays HEALTHY through sweeps past
    the timeout.  The control, a monitor whose session never built first,
    sees the same first launch stall and declares the agent DEAD."""
    monkeypatch.setenv("HALO_HEALTH_MONITOR", "1")
    monkeypatch.setenv("HALO_HEARTBEAT_TIMEOUT", "0.1")
    monkeypatch.setenv("HALO_HEALTH_POLL", "0.01")
    log = []
    s = _card_session(monkeypatch, log, seconds=0.3)
    try:
        hopper = s.agents["hopper"]
        assert log == ["build"] and s.health is not None
        hopper.submit(_cuda.lib).result(TIMEOUT)
        time.sleep(0.2)
        assert s.health.state(hopper) == AgentState.HEALTHY and not hopper.dead
    finally:
        s.finalize()
    monkeypatch.setenv("HALO_HEALTH_MONITOR", "0")
    log = []
    s = _card_session(monkeypatch, log, seconds=0.3)
    try:
        hopper = s.agents["hopper"]
        mon = HealthMonitor(HealthConfig(heartbeat_timeout=0.1, poll_interval=0.01))
        mon.register(hopper)
        mon.on_transition(s._on_health_transition)
        mon.start()
        try:
            hopper.submit(_cuda.lib)
            _wait_until(lambda: hopper.dead, what="cold build declared dead")
        finally:
            mon.stop()
    finally:
        s.finalize()


def test_finalize_stops_the_monitor_and_the_replay_fallback_prefers_torch(session):
    mon = session.enable_health_monitor(
        config=HealthConfig(heartbeat_timeout=5.0, poll_interval=0.01))
    assert mon._thread.is_alive()
    assert session._healthy_fallback(exclude="aten") is session.agents["torch"]
    assert session._healthy_fallback(exclude="torch") is session.agents["aten"]
    thread = mon._thread
    session.finalize()
    thread.join(timeout=5)
    assert not thread.is_alive()
