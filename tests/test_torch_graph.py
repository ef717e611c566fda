"""Execution graphs in the port (DESIGN.md §8) on the CPU: the semantics
tests/test_graph.py pins for the JAX package — capture, the diamond DAG
against serial dispatch and against the JAX graph, overlap across agents,
placement with the transfer penalty, re-placement after a raising record,
the original error after exhaustion, dependency failures, cancellation,
blocking calls refused in capture, shared-buffer ordering, no mailboxing.

Nothing here waits on a sleep or a short deadline: workers are drained by
queueing a marker behind the work, and stalls are released by events."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelRegistry as JaxRegistry
from repro.core import RuntimeAgent as JaxAgent
from repro.core import default_manifest as jax_manifest
from repro.core import halo_graph as jax_graph
from repro.kernels import register_all as jax_register_all
from repro_torch.core.agents import HaloCancelledError, RuntimeAgent
from repro_torch.core.c2mpi import (MPIX_Claim, MPIX_Finalize,
                                    MPIX_GraphBegin, MPIX_GraphEnd,
                                    MPIX_Initialize, MPIX_ISend, MPIX_Wait)
from repro_torch.core.graph import (ExecutionGraph, GraphDependencyError,
                                    GraphError, GraphNode, begin_capture,
                                    halo_graph)
from repro_torch.core.manifest import default_manifest
from repro_torch.core.registry import KernelRecord, KernelRegistry
from repro_torch.core.scheduler import CostModelScheduler
from repro_torch.kernels import register_all

TIMEOUT = 60
PIN = {"allowed_platforms": ["hopper"]}


@pytest.fixture()
def agent():
    registry = KernelRegistry()
    register_all(registry)
    a = RuntimeAgent(registry=registry, manifest=default_manifest(),
                     device="cpu")
    yield a
    a.finalize()


def _session(*records):
    reg = KernelRegistry()
    for r in records:
        reg.register(r)
    return RuntimeAgent(registry=reg, manifest=default_manifest(),
                        scheduler=CostModelScheduler(), device="cpu")


def _drain(agent, platform):
    """Return once everything queued on ``platform``'s worker has run."""
    agent.agents[platform].submit(lambda: None).result(TIMEOUT)


def _raising(message, exc_type=RuntimeError):
    def fn(*args, **kwargs):
        raise exc_type(message)
    return fn


def test_diamond_dag_matches_serial_dispatch_and_jax(agent):
    """a → (b, c) → d: graph results equal the same requests dispatched one
    at a time bit for bit, and the JAX graph's output within 2e-4."""
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((24, 24), dtype=np.float32)
    b_np = rng.standard_normal((24, 24), dtype=np.float32) + 3.0
    g_np = np.ones(24, np.float32)
    a, b, gamma = (torch.from_numpy(x) for x in (a_np, b_np, g_np))

    def program(sess, graph, a, b, gamma, overrides):
        cr = {al: sess.claim(al, overrides=overrides)
              for al in ("EWMM", "MMM", "RMSNORM")}
        with graph(session=sess) as g:
            top = sess.isend((a, b), cr["EWMM"])
            left = sess.isend((top, b), cr["MMM"])
            right = sess.isend((top, gamma), cr["RMSNORM"])
            out = sess.isend((left, right), cr["EWMM"])
        return g, (top, left, right, out)

    cr = {al: agent.claim(al, overrides=PIN) for al in ("EWMM", "MMM", "RMSNORM")}
    agent.send((a, b), cr["EWMM"])
    top = agent.recv(cr["EWMM"])
    agent.send((top, b), cr["MMM"])
    left = agent.recv(cr["MMM"])
    agent.send((top, gamma), cr["RMSNORM"])
    right = agent.recv(cr["RMSNORM"])
    agent.send((left, right), cr["EWMM"])
    ref = agent.recv(cr["EWMM"])

    g, (n_top, n_left, n_right, n_out) = program(agent, halo_graph, a, b,
                                                 gamma, PIN)
    assert [p.uid for p in n_out.parents] == [n_left.uid, n_right.uid]
    assert n_top.children == [n_left, n_right]
    (out,) = g.wait(timeout=TIMEOUT)
    assert torch.equal(out, ref)
    assert all(p == "hopper" for p in g.placements().values())

    jreg = JaxRegistry()
    jax_register_all(jreg)
    jsess = JaxAgent(registry=jreg, manifest=jax_manifest())
    try:
        jg, _ = program(jsess, jax_graph, jnp.asarray(a_np), jnp.asarray(b_np),
                        jnp.asarray(g_np), None)
        (jout,) = jg.wait(timeout=TIMEOUT)
    finally:
        jsess.finalize()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4,
                               atol=2e-4)


def test_independent_branches_run_on_distinct_agents(agent):
    """Two independent branches: while one stalls the torch worker, the
    other completes on the aten agent — distinct worker queues, overlap."""
    gate = threading.Event()

    def stall(x):
        assert gate.wait(TIMEOUT)
        return x

    agent.registry.register(KernelRecord(alias="STALL", fn=stall,
                                         platform="torch", is_failsafe=True))
    cr_stall = agent.claim("STALL")
    cr_fast = agent.claim("MMM", overrides={"allowed_platforms": ["aten"],
                                            "platform_preference": ["aten"]})
    with halo_graph(session=agent) as g:
        n_slow = agent.isend((torch.ones(4),), cr_stall)
        n_fast = agent.isend((torch.eye(8), torch.eye(8)), cr_fast)
    assert torch.equal(n_fast.result(timeout=TIMEOUT), torch.eye(8))
    assert not n_slow.done()          # torch branch still stalled → overlap
    gate.set()
    g.wait(timeout=TIMEOUT)
    assert n_slow.platform == "torch" and n_fast.platform == "aten"


def test_transfer_penalty_keeps_chains_on_one_agent():
    """With near-equal per-kernel estimates, the transfer penalty keeps a
    dependent chain on its parent's substrate; an independent node takes
    the cheaper record."""
    agent = _session(
        KernelRecord(alias="K", fn=lambda a: a + 1.0, platform="aten",
                     priority=10, cost_model=lambda a: 1.00e-4),
        KernelRecord(alias="K", fn=lambda a: a + 1.0, platform="torch",
                     cost_model=lambda a: 0.99e-4, is_failsafe=True))
    try:
        cr_root = agent.claim("K", overrides={"allowed_platforms": ["aten"],
                                              "platform_preference": ["aten"]})
        cr_child = agent.claim("K")
        with halo_graph(session=agent) as g:
            root = agent.isend((torch.zeros((256, 256)),), cr_root)
            child = agent.isend((root,), cr_child)
        g.wait(timeout=TIMEOUT)
        assert root.platform == "aten" and child.platform == "aten"
        with halo_graph(session=agent) as g2:
            free = agent.isend((torch.zeros((256, 256)),), agent.claim("K"))
        g2.wait(timeout=TIMEOUT)
        assert free.platform == "torch"
    finally:
        agent.finalize()


def test_node_failure_replaces_onto_next_record():
    """A node whose record raises re-places onto the next feasible record;
    the failing record is quarantined; downstream nodes still complete."""
    bad = KernelRecord(alias="K", fn=_raising("substrate lost"),
                       platform="aten", priority=10)
    agent = _session(bad, KernelRecord(alias="K", fn=lambda a: a + 1.0,
                                       platform="torch", is_failsafe=True))
    try:
        cr1, cr2 = agent.claim("K"), agent.claim("K")
        with halo_graph(session=agent):
            n1 = agent.isend((torch.zeros(4),), cr1)
            n2 = agent.isend((n1,), cr2)
        assert torch.equal(n2.result(timeout=TIMEOUT), torch.full((4,), 2.0))
        assert n1.attempts == ["aten", "torch"]   # tried, failed, re-placed
        assert n1.platform == "torch"
        assert agent.scheduler.is_failed(bad)     # quarantined
        assert n2.attempts == ["torch"]           # never offered the bad one
    finally:
        agent.finalize()


def test_replacement_exhaustion_surfaces_original_error():
    """When every re-placement also fails, the first attempt's error is what
    surfaces."""
    agent = _session(
        KernelRecord(alias="K", fn=_raising("device lost"), platform="aten",
                     priority=10),
        KernelRecord(alias="K", fn=_raising("oracle also broken", TypeError),
                     platform="torch", is_failsafe=True))
    try:
        with halo_graph(session=agent):
            node = agent.isend((torch.zeros(2),), agent.claim("K"))
        with pytest.raises(RuntimeError, match="device lost"):
            node.result(timeout=TIMEOUT)
        assert node.attempts == ["aten", "torch"]
    finally:
        agent.finalize()


def test_per_node_platform_preference_respected():
    """Two nodes with the same alias and signature but different preference
    overrides do not share a placement."""
    agent = _session(
        KernelRecord(alias="K", fn=lambda a: a + 1.0, platform="aten",
                     priority=10),
        KernelRecord(alias="K", fn=lambda a: a + 2.0, platform="torch",
                     is_failsafe=True))
    try:
        cr_x = agent.claim("K", overrides={"platform_preference": ["aten",
                                                                   "torch"]})
        cr_j = agent.claim("K", overrides={"platform_preference": ["torch",
                                                                   "aten"]})
        with halo_graph(session=agent) as g:
            nx = agent.isend((torch.zeros(3),), cr_x)
            nj = agent.isend((torch.zeros(3),), cr_j)
        g.wait(timeout=TIMEOUT)
        assert nx.platform == "aten" and nj.platform == "torch"
    finally:
        agent.finalize()


def test_node_failure_without_fallback_cascades_to_descendants():
    agent = _session(KernelRecord(alias="BOOM",
                                  fn=_raising("kernel exploded", ValueError),
                                  platform="torch", is_failsafe=True))
    try:
        cr1, cr2 = agent.claim("BOOM"), agent.claim("BOOM")
        with halo_graph(session=agent) as g:
            n1 = agent.isend((torch.zeros(2),), cr1)
            n2 = agent.isend((n1,), cr2)
        with pytest.raises(ValueError, match="kernel exploded"):
            n1.result(timeout=TIMEOUT)
        with pytest.raises(GraphDependencyError):
            n2.result(timeout=TIMEOUT)
        with pytest.raises((ValueError, GraphDependencyError)):
            g.wait(timeout=TIMEOUT)
    finally:
        agent.finalize()


def test_claim_level_failsafe_engages_in_graph(agent):
    cr = agent.claim("NO_SUCH_KERNEL", failsafe=lambda *a: torch.zeros((2, 2)))
    with halo_graph(session=agent):
        node = agent.isend((torch.ones((2, 2)),), cr)
    assert torch.equal(node.result(timeout=TIMEOUT), torch.zeros((2, 2)))
    assert node.attempts == ["failsafe"]


def test_cancellation_propagates_to_not_yet_started_nodes(agent):
    """Cancelling the graph while the root runs cancels every queued node;
    the running node is unaffected, and its completion never resurrects the
    cancelled children."""
    started, gate = threading.Event(), threading.Event()

    def slow(x):
        started.set()
        assert gate.wait(TIMEOUT)
        return x

    agent.registry.register(KernelRecord(alias="SLOW", fn=slow,
                                         platform="torch", is_failsafe=True))
    cr_slow, cr_next = agent.claim("SLOW"), agent.claim("SLOW")
    with halo_graph(session=agent) as g:
        root = agent.isend((torch.ones(3),), cr_slow)
        child = agent.isend((root,), cr_next)
        grandchild = agent.isend((child,), cr_next)
    assert started.wait(TIMEOUT)
    assert root.running()
    assert g.cancel() == 2                          # child + grandchild
    gate.set()
    assert torch.equal(root.result(timeout=TIMEOUT), torch.ones(3))
    _drain(agent, "torch")                          # the root's worker is done
    assert child.cancelled() and grandchild.cancelled()
    assert not child.running()
    with pytest.raises(HaloCancelledError):
        child.result(timeout=TIMEOUT)


def test_cancel_before_launch_runs_nothing(agent):
    ran = []
    agent.registry.register(KernelRecord(
        alias="TRACK", fn=lambda x: ran.append(1) or x, platform="torch",
        is_failsafe=True))
    cr = agent.claim("TRACK")
    with halo_graph(session=agent, launch=False) as g:
        n1 = agent.isend((torch.ones(2),), cr)
        n2 = agent.isend((n1,), cr)
    assert g.cancel() == 2
    g.launch()
    with pytest.raises(HaloCancelledError):
        n1.result(timeout=TIMEOUT)
    for platform in agent.agents:
        _drain(agent, platform)
    assert ran == [] and n2.cancelled()


def test_dispatch_capture_and_unified_control_flow(agent):
    """halo_dispatch inside a capture region records nodes; outside it,
    dispatch executes at once again."""
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 16), dtype=np.float32))
    with halo_graph(session=agent) as g:
        t = agent.dispatch("MMM", a, a, overrides=PIN)
        assert isinstance(t, GraphNode)
        agent.dispatch("EWMM", t, t, overrides=PIN)
    (out,) = g.wait(timeout=TIMEOUT)
    ref = agent.dispatch("MMM", a, a, overrides=PIN)
    assert not isinstance(ref, GraphNode)
    assert torch.equal(out, ref * ref)


def test_blocking_calls_rejected_during_capture(agent):
    cr = agent.claim("MMM")
    with halo_graph(session=agent, launch=False) as g:
        with pytest.raises(RuntimeError, match="MPIX_ISend"):
            agent.send((torch.eye(2), torch.eye(2)), cr)
        with pytest.raises(RuntimeError, match="node futures"):
            agent.recv(cr)
        with pytest.raises(RuntimeError, match="SendFwd"):
            agent.send_fwd((torch.eye(2), torch.eye(2)), cr, agent.claim("MMM"))
        with pytest.raises(GraphError, match="already active"):
            begin_capture(agent)
    assert g.nodes == []


def test_stateful_buffer_identity_orders_nodes(agent):
    """Two nodes sharing a CR's internal buffer serialize in capture order
    even with no payload dependency (write-write hazard)."""
    def accum(x, state):
        new = state["acc"] + x
        return new, {"acc": new}

    agent.registry.register(KernelRecord(alias="ACCUM", fn=accum,
                                         platform="torch", is_failsafe=True))
    cr = agent.claim("ACCUM")
    agent.create_buffer(cr, (2,), torch.float32, name="acc")
    with halo_graph(session=agent) as g:
        n1 = agent.isend((torch.ones(2),), cr)
        n2 = agent.isend((10.0 * torch.ones(2),), cr)
    assert n2.parents == [n1]                      # buffer-identity edge
    g.wait(timeout=TIMEOUT)
    assert torch.equal(n2.result(), torch.full((2,), 11.0))


def test_graph_results_not_mailboxed(agent):
    cr = agent.claim("MMM")
    with halo_graph(session=agent) as g:
        agent.isend((torch.eye(2), torch.eye(2)), cr)
    g.wait(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="empty mailbox"):
        agent.recv(cr)


def test_foreign_future_gates_a_node(agent):
    """A request sent outside the graph gates the node that reads it."""
    gate = threading.Event()

    def stall(x):
        assert gate.wait(TIMEOUT)
        return x + 1.0

    agent.registry.register(KernelRecord(alias="STALL", fn=stall,
                                         platform="torch", is_failsafe=True))
    fut = agent.isend((torch.zeros(3),), agent.claim("STALL"), mailbox=False)
    cr = agent.claim("EWADD", overrides=PIN)
    with halo_graph(session=agent) as g:
        node = agent.isend((fut, torch.ones(3)), cr)
    assert node._foreign_deps == [fut] and not node.parents
    assert not node.done()
    gate.set()
    (out,) = g.wait(timeout=TIMEOUT)
    assert torch.equal(out, torch.full((3,), 2.0))


def test_candidate_cache_is_bounded(agent, monkeypatch):
    """The per-graph placement-candidate cache evicts its oldest entries
    past its cap."""
    monkeypatch.setattr(ExecutionGraph, "_CAND_CACHE_MAX", 3)
    cr = agent.claim("EWMM")
    with halo_graph(session=agent) as g:
        for m in (2, 3, 4, 5, 6):                  # 5 distinct signatures
            agent.isend((torch.ones((m, m)), torch.ones((m, m))), cr)
    g.wait(timeout=TIMEOUT)
    assert len(g._cand_cache) <= 3


def test_candidate_cache_flushed_on_quarantine_change(agent):
    """mark_failed / clear_failures mid-graph move the scheduler epoch; the
    next placement flushes every cached candidate list and re-syncs."""
    a = torch.ones((8, 8))
    cr = agent.claim("EWMM")
    with halo_graph(session=agent, launch=False) as g:
        node = agent.isend((a, a), cr)
    rec, _, _ = g._place(node, (a, a))
    assert g._cand_cache and g._cand_epoch == agent.scheduler.epoch
    agent.scheduler.mark_failed(rec)               # quarantine mid-graph
    rec2, _, _ = g._place(node, (a, a))
    assert rec2 is not rec                         # no longer offered
    assert g._cand_epoch == agent.scheduler.epoch  # cache re-synced
    agent.scheduler.clear_failures()
    rec3, _, _ = g._place(node, (a, a))
    assert rec3 is rec                             # offered again post-clear


def test_mpix_graph_begin_end_and_wait():
    """The C²MPI verbs: MPIX_GraphBegin/End capture on the process session,
    MPIX_Wait on a node gives its result."""
    MPIX_Initialize(device="cpu")
    try:
        a = torch.full((4, 4), 2.0)
        g = MPIX_GraphBegin()
        t = MPIX_ISend((a, a), MPIX_Claim("EWMM", overrides=PIN))
        u = MPIX_ISend((t, a), MPIX_Claim("EWADD", overrides=PIN))
        assert isinstance(u, GraphNode) and not g._launched
        assert MPIX_GraphEnd() is g and g._launched
        assert torch.equal(MPIX_Wait(u, timeout=TIMEOUT), torch.full((4, 4), 6.0))
        with pytest.raises(GraphError, match="no active graph"):
            MPIX_GraphEnd()
    finally:
        MPIX_Finalize()


def test_graph_launches_on_the_launching_threads_stream(agent):
    """On the CPU there is no stream: nodes record no ready event, and
    wait_device returns at once."""
    cr = agent.claim("EWADD", overrides=PIN)
    with halo_graph(session=agent) as g:
        node = agent.isend((torch.ones(2), torch.ones(2)), cr)
    g.wait(timeout=TIMEOUT)
    g.wait_device()
    assert g._stream is None and node._ready is None and node.device_done()


def test_graphs_from_many_threads_keep_their_results():
    """Eight host threads capture and launch graphs at once on one session
    whose three agents' workers are shared, with a short switch interval:
    every node runs exactly once and every result is the serial one."""
    import sys

    registry = KernelRegistry()
    register_all(registry)
    calls = []
    lock = threading.Lock()

    def add_one(x):
        with lock:
            calls.append(1)
        return x + 1.0

    for platform, prio in (("torch", 0), ("aten", 10), ("hopper", 20)):
        registry.register(KernelRecord(alias="INC", fn=add_one,
                                       platform=platform, priority=prio,
                                       is_failsafe=platform == "torch"))
    agent = RuntimeAgent(registry=registry, device="cpu")
    platforms = ("torch", "aten", "hopper")
    errors = []

    def worker(k):
        try:
            crs = [agent.claim("INC", overrides={"allowed_platforms": [p]})
                   for p in platforms]
            for rep in range(5):
                with halo_graph(session=agent) as g:
                    x = torch.full((4,), float(k))
                    for step in range(9):        # a chain hopping agents
                        x = agent.isend((x,), crs[(k + step) % 3])
                (out,) = g.wait(timeout=TIMEOUT)
                assert torch.equal(out, torch.full((4,), k + 9.0))
                assert [n.platform for n in g.nodes] == \
                    [platforms[(k + s) % 3] for s in range(9)]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        agent.finalize()
    assert errors == []
    assert len(calls) == 8 * 5 * 9
