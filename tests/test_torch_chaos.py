"""Chaos suite in the port (DESIGN.md §11): whole-system fault injection
through ``repro_torch.testing.faults``, the cases of tests/test_chaos.py,
each held against the JAX package.

The claims under test: a device group survives a member agent dying
*mid-solve* with bit-identical results, eager and captured (survivors take
the dead member's ranks, so the shard layout and the numerics do not
change), and a straggling attempt is speculatively re-executed on the
next-ranked substrate with exact result parity.  The port's group is
``GROUP = ("hopper", "torch")``: on the CPU the hopper rows run their
plain versions, the very functions of the torch rows, so the pair gives
the same bits (as the reference's ``("xla", "jnp")`` does); its hopper
member dies.  Each solve is also held to the JAX package's fault-free
solve on the same numpy inputs within the float32 parity tolerance
``TOL`` (2e-4): the port's MVM sums each row with ``torch.sum``, the
reference's with a library dot.  The paged-serving cases hold the port's
tokens to the JAX engine's on the same weights (``params_from_numpy``).

Every wait is bounded; no test sleeps longer than a few hundred
milliseconds at a time."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import KernelRegistry as JRegistry
from repro.core import RuntimeAgent as JAgent
from repro.core import default_manifest as j_manifest
from repro.core import halo_graph as j_halo_graph
from repro.kernels import register_all as j_register_all
from repro.models import build_model as j_build_model
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import StepScheduler as JStepScheduler
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.core.agents import (AgentDeadError, AgentState, HealthConfig,
                                     HealthMonitor, RuntimeAgent)
from repro_torch.core.graph import halo_graph
from repro_torch.core.manifest import default_manifest
from repro_torch.core.registry import KernelRegistry
from repro_torch.kernels import register_all
from repro_torch.models import build_model
from repro_torch.serve.engine import PagedEngine, StepScheduler
from repro_torch.testing.faults import FaultError, FaultPlan, chaos, engine_chaos

N = 32
ITERS = 4
TOL = 2e-4
TIMEOUT = 60
GROUP = ("hopper", "torch")      # same bits on the CPU; hopper dies
REF_GROUP = ("xla", "jnp")


def _session():
    registry = KernelRegistry()
    register_all(registry)
    return RuntimeAgent(registry=registry, manifest=default_manifest(),
                        device="cpu")


def _ref_session():
    registry = JRegistry()
    j_register_all(registry)
    return JAgent(registry=registry, manifest=j_manifest())


def _problem(n=N):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return a, b, np.diagonal(a).copy()


def _wait_until(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} not reached in time"
        time.sleep(0.005)


def _eager_jacobi(comm, a, b, d, zeros, iters=ITERS):
    """Blocking-verb Jacobi (the paper's collective Jacobi, shrunk); the
    same code drives either package's HaloComm."""
    A, B, D = comm.scatter(a), comm.scatter(b), comm.scatter(d)
    X = comm.scatter(zeros)
    res = 0.0
    for _ in range(iters):
        xs = comm.allgather(X)
        P = comm.map("MVM", list(zip(A, xs)))
        T = comm.map("EWSUB", list(zip(B, P)))
        U = comm.map("EWMM", list(zip(D, X)))
        V = comm.map("EWADD", list(zip(T, U)))
        Xn = comm.map("EWMD", list(zip(V, D)))
        E = comm.map("EWSUB", list(zip(Xn, X)))
        S = comm.map("VDP", list(zip(E, E)))
        res = float(comm.allreduce(S, op="sum")[0])
        X = Xn
    return comm.gather(X), res


def _captured_jacobi(comm, a, b, d, zeros, iters=ITERS, graph=halo_graph):
    """The same loop with each iteration captured as one execution graph."""
    A, B, D = comm.scatter(a), comm.scatter(b), comm.scatter(d)
    X = comm.scatter(zeros)
    res = 0.0
    for _ in range(iters):
        with graph(session=comm.session):
            xs = comm.iallgather(X)
            P = comm.imap("MVM", list(zip(A, xs)))
            T = comm.imap("EWSUB", list(zip(B, P)))
            U = comm.imap("EWMM", list(zip(D, X)))
            V = comm.imap("EWADD", list(zip(T, U)))
            Xn = comm.imap("EWMD", list(zip(V, D)))
            E = comm.imap("EWSUB", list(zip(Xn, X)))
            S = comm.imap("VDP", list(zip(E, E)))
            R = comm.iallreduce(S, op="sum")
        X = [n.result(timeout=TIMEOUT) for n in Xn]
        res = float(R[0].result(timeout=TIMEOUT))
    return comm.gather(X), res


def _ref_solve(captured):
    a, b, d = _problem()
    s = _ref_session()
    try:
        comm = s.comm_split(list(REF_GROUP))
        args = [jnp.asarray(v) for v in (a, b, d)] + [jnp.zeros(N, jnp.float32)]
        if captured:
            x, res = _captured_jacobi(comm, *args, graph=j_halo_graph)
        else:
            x, res = _eager_jacobi(comm, *args)
        return np.asarray(x), res
    finally:
        s.finalize()


def _chaos_jacobi(run, nth):
    """Fault-free port run vs one where the hopper member dies mid-solve on
    its ``nth`` device call, under a started monitor."""
    a, b, d = (torch.from_numpy(v) for v in _problem())
    zeros = torch.zeros(N)
    ref_sess = _session()
    try:
        x_ref, res_ref = run(ref_sess.comm_split(list(GROUP)), a, b, d, zeros)
    finally:
        ref_sess.finalize()
    sess = _session()
    try:
        sess.enable_health_monitor(
            config=HealthConfig(heartbeat_timeout=0.25, poll_interval=0.02,
                                straggler_multiple=0.0), start=True)
        comm = sess.comm_split(list(GROUP))
        with chaos(sess, FaultPlan(platform="hopper", mode="die", nth=nth)) as fa:
            x, res = run(comm, a, b, d, zeros)
        return x, res, x_ref, res_ref, comm, fa
    finally:
        sess.finalize()


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_jacobi_survives_member_death(captured):
    run, nth = (_captured_jacobi, 15) if captured else (_eager_jacobi, 12)
    x, res, x_ref, res_ref, comm, fa = _chaos_jacobi(run, nth)
    assert fa.failures >= 1                    # the wedge actually happened
    assert "hopper" not in comm.platforms      # ranks re-bound onto survivors
    assert comm.platforms == ("torch", "torch")
    assert comm.size == len(GROUP)             # logical size unchanged
    assert comm.epoch >= 1
    assert torch.equal(x, x_ref)               # bit-identical solve
    assert res == pytest.approx(res_ref, rel=1e-5)
    jx, jres = _ref_solve(captured)
    np.testing.assert_allclose(x.numpy(), jx, rtol=TOL, atol=TOL)
    assert res == pytest.approx(jres, rel=TOL, abs=TOL * 1e-3)


def test_straggler_speculation_result_parity():
    """A hung (not failed) aten attempt is speculatively re-executed on the
    next-ranked substrate, hopper; the backup's result is bit-identical to
    a plain dispatch on hopper, the straggler's late result is discarded
    (first completion wins), and the node keeps the winner's ready event.
    Held to the JAX MMM within TOL."""
    a_np = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)
    a = torch.from_numpy(a_np)
    pin = {"allowed_platforms": ["hopper"], "platform_preference": ["hopper"]}
    ref_sess = _session()
    try:
        cr = ref_sess.claim("MMM", overrides=pin)
        ref_sess.send((a, a), cr)
        ref = ref_sess.recv(cr)
    finally:
        ref_sess.finalize()
    sess = _session()
    try:
        sess.enable_health_monitor(
            config=HealthConfig(heartbeat_timeout=60.0, straggler_multiple=1.0,
                                straggler_min_s=0.05), start=False)
        with chaos(sess, FaultPlan(platform="aten", mode="hang",
                                   delay_s=60.0)) as fa:
            cr = sess.claim("MMM", overrides={
                "allowed_platforms": ["aten", "hopper"],
                "platform_preference": ["aten", "hopper"]})
            with halo_graph(session=sess):
                node = sess.isend((a, a), cr)
            _wait_until(lambda: fa.failures >= 1, what="straggler wedged")
            time.sleep(0.06)                   # past the speculation floor
            sess.health.check()
            out = node.result(timeout=TIMEOUT)
            ready = node._ready
            fa.release()                       # the late aten result lands
            _wait_until(lambda: not fa.heartbeat()[1], what="straggler done")
        assert node.attempts == ["aten", "hopper+spec"]
        assert node.platform == "hopper"       # the backup won the race
        assert node.result(timeout=0) is out and node._ready is ready
        assert torch.equal(out, ref)
    finally:
        sess.finalize()
    jout = np.asarray(jnp.asarray(a_np) @ jnp.asarray(a_np))
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)


def test_a_wedged_worker_pins_only_its_node_after_a_replay():
    """A compiled replay whose aten node wedges (die) completes through the
    monitor's replay on torch; once ``replay`` returns, the wedged worker
    still holds its own node, but no longer the graph's other nodes and
    their results (a data-parallel step's gradient vectors: without it the
    card ran out of memory in the step after a member's death)."""
    import gc
    import weakref

    from repro_torch.core import graph as graph_mod
    sess = _session()
    pin = {p: {"allowed_platforms": [p], "platform_preference": [p]}
           for p in ("aten", "torch")}
    a, b = torch.ones(1000), torch.full((1000,), 2.0)
    seen = []
    orig = graph_mod.ExecutionGraph.wait

    def spy(self, timeout=None):
        out_ = orig(self, timeout)
        seen.extend(weakref.ref(n) for n in self.nodes)
        return out_

    try:
        sess.enable_health_monitor(config=HealthConfig(
            heartbeat_timeout=0.2, poll_interval=0.01, straggler_multiple=0.0))
        with chaos(sess, FaultPlan(platform="aten", mode="die")) as fa:
            with halo_graph(session=sess, launch=False) as g:
                t = sess.dispatch("EWADD", a, b, overrides=pin["aten"])
                u = sess.dispatch("EWMM", t, b, overrides=pin["torch"])
                sess.dispatch("MVM", torch.ones(10, 1000), u, overrides=pin["torch"])
            cg = g.compile(fuse=False)
            del g, t, u
            gc.disable()
            try:
                graph_mod.ExecutionGraph.wait = spy
                (out,) = cg.replay(timeout=TIMEOUT)
                graph_mod.ExecutionGraph.wait = orig
                assert fa.dead and fa.failures == 1
                _wait_until(lambda: seen[1]() is None and seen[2]() is None,
                            what="the replay's other nodes freed")
                assert seen[0]() is not None and seen[0]().attempts == ["aten", "torch"]
            finally:
                graph_mod.ExecutionGraph.wait = orig
                gc.enable()
        assert torch.equal(out, torch.full((10,), 6000.0))
    finally:
        sess.finalize()


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card_rule"])
def test_a_released_wedge_leaves_the_node_to_its_replay(monkeypatch, card):
    """A hopper attempt wedged on a dying agent is replayed on torch; its
    call, released before that replay finishes, raises — and the node
    stays the replay's: no second re-placement off the card, and no
    failure under the card rule on card tensors (``card_rule`` makes the
    CPU tensors count as card tensors).  The torch replay then completes
    the node."""
    from repro_torch.core import graph as graph_mod
    if card:
        monkeypatch.setattr(graph_mod, "_card_device",
                            lambda args: torch.device("cuda"))
    sess = _session()
    a, b = torch.ones(64), torch.full((64,), 2.0)
    try:
        mon = sess.enable_health_monitor(config=HealthConfig(
            heartbeat_timeout=0.2, straggler_multiple=0.0), start=False)
        with chaos(sess, FaultPlan(platform="hopper", mode="die"),
                   FaultPlan(platform="torch", mode="hang",
                             delay_s=60.0)) as (fh, ft):
            with halo_graph(session=sess):
                node = sess.dispatch("EWADD", a, b, overrides={
                    "allowed_platforms": ["hopper", "torch"],
                    "platform_preference": ["hopper", "torch"]})
            _wait_until(lambda: fh.failures >= 1, what="hopper wedged")
            mon.check(now=fh.heartbeat()[2] + 1.0)     # DEAD: replay on torch
            _wait_until(lambda: ft.failures >= 1, what="torch replay hung")
            fh.release()                    # the wedged hopper call raises now
            _wait_until(lambda: not fh.heartbeat()[1], what="hopper call ended")
            assert fh.dead and not node.done()
            assert node.attempts == ["hopper", "torch"]
            ft.release()
            out = node.result(timeout=TIMEOUT)
        assert node.platform == "torch" and node.attempts == ["hopper", "torch"]
        assert torch.equal(out, a + b)
    finally:
        sess.finalize()


@pytest.mark.parametrize("backup", ["wins", "fails"])
def test_an_original_failing_under_a_live_backup_leaves_it_the_node(backup):
    """An aten attempt that straggles, gets a backup on torch, then raises
    while the backup still runs hands the node to the backup: no second
    attempt meanwhile.  A backup that wins completes the node; one that
    then fails settles the original's error through the usual re-placement
    (here onto torch again, which fails too: the original error surfaces)."""
    sess = _session()
    a, b = torch.ones(64), torch.full((64,), 2.0)
    try:
        mon = sess.enable_health_monitor(config=HealthConfig(
            heartbeat_timeout=60.0, straggler_multiple=1.0,
            straggler_min_s=0.05), start=False)
        with chaos(sess, FaultPlan(platform="aten", mode="die"),
                   FaultPlan(platform="torch", delay_s=60.0,
                             mode="hang" if backup == "wins" else "die")
                   ) as (fa, ft):
            with halo_graph(session=sess):
                node = sess.dispatch("EWADD", a, b, overrides={
                    "allowed_platforms": ["aten", "torch"],
                    "platform_preference": ["aten", "torch"]})
            _wait_until(lambda: fa.failures >= 1, what="aten straggling")
            time.sleep(0.06)                    # past the speculation floor
            mon.check()
            _wait_until(lambda: ft.failures >= 1, what="torch backup wedged")
            fa.release()                        # the original raises now
            _wait_until(lambda: not fa.heartbeat()[1], what="aten call ended")
            assert not node.done() and node._deferred is not None
            assert node.attempts == ["aten", "torch+spec"]
            ft.release()
            if backup == "wins":
                out = node.result(timeout=TIMEOUT)
            else:
                with pytest.raises(FaultError):
                    node.result(timeout=TIMEOUT)
        assert node._deferred is None
        if backup == "wins":
            assert node.platform == "torch"
            assert node.attempts == ["aten", "torch+spec"]
            assert torch.equal(out, a + b)
        else:
            assert node.attempts == ["aten", "torch+spec", "torch"]
    finally:
        sess.finalize()


def test_backup_candidate_ranks_as_the_reference_does():
    """The straggler's backup record: the fastest estimated platform other
    than the straggling one, quarantine skipped, None when no other
    platform is left; the same picks, role for role, as the reference's."""
    from repro.core import CostModelScheduler as JScheduler
    from repro.core import KernelRecord as JRecord
    from repro.core.scheduler import abstract_signature as j_signature
    from repro_torch.core.registry import KernelRecord
    from repro_torch.core.scheduler import CostModelScheduler, abstract_signature
    seconds = [3e-3, 1e-3, 2e-3]
    sides = {"port": (CostModelScheduler, KernelRecord, abstract_signature,
                      ("aten", "torch", "hopper"), (torch.ones(4),)),
             "ref": (JScheduler, JRecord, j_signature, ("xla", "jnp", "pallas"),
                     (jnp.ones(4),))}
    picks = {}
    for side, (Sched, Rec, signature, plats, args) in sides.items():
        sched = Sched(explore_every=0)
        recs = [Rec(alias="X", fn=lambda x: x, platform=p) for p in plats]
        for rec, t in zip(recs, seconds):
            for _ in range(2):                       # the first is warmup
                sched.observe(rec, signature(args), t)

        def pick(pool, exclude):
            rec = sched.backup_candidate("X", pool, args, exclude_platforms=exclude)
            return None if rec is None else plats.index(rec.platform)

        got = [pick(recs, (p,)) for p in plats]
        sched.mark_failed(recs[1])
        got += [pick(recs, (plats[0],)), pick(recs[:1], (plats[0],))]
        picks[side] = got
    assert picks["port"] == picks["ref"] == [1, 2, 1, 2, None]


def test_chaos_context_restores_session():
    """chaos() leaves no residue: original agents back in place, quarantine
    cleared, and the session fully usable afterwards."""
    sess = _session()
    try:
        original = sess.agents["aten"]
        with chaos(sess, FaultPlan(platform="aten", mode="raise")) as fa:
            assert sess.agents["aten"] is fa and fa._inner is original
            cr = sess.claim("MMM", overrides={
                "allowed_platforms": ["aten", "torch"],
                "platform_preference": ["aten", "torch"]})
            sess.send((torch.eye(4), torch.eye(4)), cr)
            assert torch.equal(sess.recv(cr), torch.eye(4))
            assert fa.failures == 1
            assert sess.scheduler.failed_record_keys()
        assert sess.agents["aten"] is original
        assert not sess.scheduler.failed_record_keys()
        cr2 = sess.claim("MMM", overrides={
            "allowed_platforms": ["aten"], "platform_preference": ["aten"]})
        sess.send((torch.eye(4), torch.eye(4)), cr2)   # healthy aten again
        assert torch.equal(sess.recv(cr2), torch.eye(4))
    finally:
        sess.finalize()


def test_flaky_member_recovers_without_membership_change():
    """A raise-then-recover member (bounded fault window) is quarantined at
    the record level but never declared DEAD: the comm keeps its binding,
    and the sum equals the reference group's bit for bit."""
    a_np, b_np = np.arange(4.0, dtype=np.float32), np.ones(4, np.float32)
    sess = _session()
    try:
        comm = sess.comm_split(list(GROUP))
        with chaos(sess, FaultPlan(platform="hopper", mode="raise", nth=1,
                                   times=1)) as fa:
            outs = comm.allreduce([torch.from_numpy(a_np), torch.from_numpy(b_np)],
                                  op="sum")
            assert fa.failures == 1
        assert comm.platforms == GROUP          # membership untouched
        assert comm.epoch == 0
    finally:
        sess.finalize()
    js = _ref_session()
    try:
        jouts = js.comm_split(list(REF_GROUP)).allreduce(
            [jnp.asarray(a_np), jnp.asarray(b_np)], op="sum")
    finally:
        js.finalize()
    for o, jo in zip(outs, jouts):
        assert np.array_equal(o.numpy(), np.asarray(jo))


# -- paged serving chaos ------------------------------------------------------
# A serving engine calls its model directly, so FaultyAgent never sees a
# decode call; engine_chaos patches the engine's host entry point instead.
# The claims (DESIGN.md §14): a decode fault fails exactly the in-flight
# lanes, every failed lane's blocks return to the arena, queued requests
# still serve afterwards, and a wedged stepping thread goes DEAD — futures
# fail with AgentDeadError and the arena drains while the call is stuck.

CASES = [([3, 1, 4, 1, 5], 6), ([2, 7, 1, 8, 2, 8], 6), ([9, 9, 8, 7], 5)]
PAGED = dict(block_size=8, chunk_tokens=0)      # whole-prompt admission


@pytest.fixture(scope="module")
def serve_model():
    """The reduced danube on the JAX weights, both packages, and the JAX
    PagedEngine's fault-free greedy tokens for CASES."""
    jc, tc = j_get_config("h2o-danube-1.8b").reduced(), get_config("h2o-danube-1.8b").reduced()
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    session = halo.initialize(device="cpu")
    try:
        tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
        jsched = JStepScheduler(JPagedEngine(jm, jp, slots=2, max_len=48, **PAGED))
        futs = [jsched.submit(p, max_new=n) for p, n in CASES]
        jsched.drain()
        expect = [f.result(timeout=TIMEOUT) for f in futs]
        yield tm, tp, expect
    finally:
        halo.finalize()


def _paged_sched(model, params):
    engine = PagedEngine(model, params, 2, 48, **PAGED)
    return engine, StepScheduler(engine)


def _assert_arena_drained(pool):
    """Every refcount back at zero, reservations returned, nothing leaked."""
    pool.check()
    assert pool.live_blocks() == 0
    assert pool.reserved == 0
    assert pool.available() == pool.capacity


def test_paged_decode_fault_releases_blocks_and_keeps_serving(serve_model):
    """Kill decode mid-step: the two in-flight lanes fail with the injected
    FaultError and release their blocks; the still-queued third request is
    served afterwards with the JAX engine's fault-free tokens."""
    model, params, expect = serve_model
    engine, sched = _paged_sched(model, params)
    futs = [sched.submit(p, max_new=n) for p, n in CASES]
    with engine_chaos(engine, mode="raise", nth=2, times=1) as fault:
        with pytest.raises(FaultError):
            while sched.busy():            # 2nd batched decode call faults
                sched.step()
        assert fault.failures == 1
        for f in futs[:2]:                 # the lanes that were in flight
            with pytest.raises(FaultError):
                f.result(timeout=5)
        sched.drain()                      # queued request still serves
    assert futs[2].result(timeout=TIMEOUT) == expect[2]
    assert sched.completed == 1
    _assert_arena_drained(engine.pool)


def test_paged_decode_straggle_recovers_with_parity(serve_model):
    """Hang (not kill) one decode step: the straggling call finishes on the
    real path after the delay, so every request completes with the JAX
    engine's tokens and the arena drains to empty."""
    model, params, expect = serve_model
    engine, sched = _paged_sched(model, params)
    with engine_chaos(engine, mode="hang", nth=2, times=1,
                      delay_s=0.2) as fault:
        futs = [sched.submit(p, max_new=n) for p, n in CASES]
        sched.drain()
        assert fault.failures == 1
    assert [f.result(timeout=TIMEOUT) for f in futs] == expect
    assert sched.completed == len(CASES)
    _assert_arena_drained(engine.pool)


def test_paged_wedged_decode_goes_dead_and_frees_blocks(serve_model):
    """A stepping thread wedged inside a device call stalls the heartbeat;
    the monitor declares the scheduler DEAD, every in-flight and queued
    future fails with AgentDeadError, and the failed lanes' blocks are back
    in the arena *while the call is still stuck*."""
    model, params, _ = serve_model
    engine, sched = _paged_sched(model, params)
    mon = HealthMonitor(HealthConfig(heartbeat_timeout=0.25,
                                     poll_interval=0.02))
    sched.attach_health(mon)
    with engine_chaos(engine, mode="die", nth=1) as fault:
        sched.start()
        futs = [sched.submit(p, max_new=n) for p, n in CASES]
        _wait_until(lambda: fault.calls >= 1, what="decode wedged")
        _, busy, last = sched.heartbeat()
        assert busy
        assert mon.check(now=last + 0.05)[sched.name] == AgentState.HEALTHY
        assert mon.check(now=last + 0.3)[sched.name] == AgentState.DEAD
        for f in futs:
            with pytest.raises(AgentDeadError):
                f.result(timeout=5)
        _assert_arena_drained(engine.pool)  # freed while decode still wedged
        fault.release()                     # wedged call now fails; loop
    sched.stop(drain=False)                 # survives (step errors are caught)
    assert sched.pending() == 0 and sched.active() == 0
