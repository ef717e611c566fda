"""Graph fusion + compiled replay in the port (DESIGN.md §12) on the CPU: the
semantics tests/test_fusion.py pins for the JAX package, and parity with it.

Fused must be *bit-identical* to serial member dispatch within the port, on
both rows (call loops, and the chain kernel's plain version for pure
element-wise chains) and in float32 and bfloat16; decomposition after a
failing fused record too.  Against the JAX package, on the same numpy
inputs: the compile stats of the same captured program are equal, and the
fused results agree within the reference's conformance tolerances
(tests/test_kernels_property.py: float32 2e-4, bfloat16 4e-2).  A
straggling fused attempt speculates by decomposing, bit-identical too."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelRegistry as JaxRegistry
from repro.core import RuntimeAgent as JaxAgent
from repro.core import default_manifest as jax_manifest
from repro.core import halo_graph as jax_graph
from repro.kernels import register_all as jax_register_all
from repro.kernels.fused import ewise_chain as jax_ewise_chain
from repro_torch import halo
from repro_torch.core import fusion
from repro_torch.core.agents import HealthConfig, RuntimeAgent
from repro_torch.core.graph import GraphError, halo_graph
from repro_torch.core.manifest import default_manifest
from repro_torch.core.registry import (KernelRecord, KernelRegistry,
                                       SelectionError)
from repro_torch.core.scheduler import CostModelScheduler, abstract_signature
from repro_torch.kernels import register_all
from repro_torch.kernels.fused import (ACC, chain_problem, ewise_chain,
                                       ewise_chain_ref, make_composed)
from repro_torch.testing.faults import FaultPlan, chaos

TOL = {torch.float32: 2e-4, torch.bfloat16: 4e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])

# chain specs: (alias, argspec) where an int indexes the shared inputs list
# and "prev" splices the previous member's output
MIXED4 = [("EWMM", (0, 1)), ("EWADD", ("prev", 2)),
          ("EWSUB", ("prev", 1)), ("RMSNORM", ("prev", 4))]
EW3 = [("EWMM", (0, 1)), ("EWADD", ("prev", 2)), ("EWSUB", ("prev", 1))]
EW4 = [("EWMM", (0, 1)), ("EWADD", ("prev", 2)), ("EWSUB", ("prev", 3)),
       ("EWMD", ("prev", 1))]


@pytest.fixture()
def sess():
    registry = KernelRegistry()
    register_all(registry)
    s = RuntimeAgent(registry=registry, manifest=default_manifest(),
                     device="cpu")
    yield s
    s.finalize()


@pytest.fixture()
def jsess():
    registry = JaxRegistry()
    jax_register_all(registry)
    s = JaxAgent(registry=registry, manifest=jax_manifest())
    yield s
    s.finalize()


def _np_inputs(seed=0, m=16, n=128):
    """a, b, c, d and gamma as float32 numpy arrays; b = 1 + |normal|, so
    a division by b (or b²) is well conditioned in every type."""
    rng = np.random.default_rng(seed)
    a, c, d = (rng.standard_normal((m, n), dtype=np.float32) for _ in range(3))
    b = np.abs(rng.standard_normal((m, n), dtype=np.float32)) + 1.0
    return [a, b, c, d, np.ones(n, np.float32)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in arrays]


def _jax(arrays, dtype=torch.float32):
    return [jnp.asarray(x).astype(JNP[dtype]) for x in arrays]


def _ov(pin):
    """Overrides for one platform (a string) or an ordered list of them."""
    if pin is None:
        return None
    pins = [pin] if isinstance(pin, str) else list(pin)
    return {"allowed_platforms": pins, "platform_preference": pins}


def _serial(sess, chain, inputs, pin=None):
    """Unfused reference: one blocking dispatch per member."""
    acc = None
    for alias, spec in chain:
        cr = sess.claim(alias, overrides=_ov(pin))
        payload = tuple(acc if s == "prev" else inputs[s] for s in spec)
        acc = sess.isend(payload, cr, mailbox=False).result(60)
    return acc


def _capture(sess, chain, inputs, pin=None, graph=halo_graph):
    crs = [sess.claim(alias, overrides=_ov(pin)) for alias, _ in chain]
    with graph(session=sess, launch=False) as g:
        acc = None
        for (alias, spec), cr in zip(chain, crs):
            payload = tuple(acc if s == "prev" else inputs[s] for s in spec)
            acc = sess.isend(payload, cr)
    return g


def _fused(sess, chain, inputs, pin=None, fuse=True, graph=halo_graph):
    cg = _capture(sess, chain, inputs, pin, graph).compile(fuse=fuse)
    gr = cg.replay_async()
    out = gr.wait(timeout=60)
    return cg, gr, out[-1]


def _bitwise(x, y):
    assert x.dtype == y.dtype and x.shape == y.shape
    assert torch.equal(x, y), f"max |diff| = {(x.float() - y.float()).abs().max()}"


def _close_to_jax(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# Chain detection + synthetic records
# ---------------------------------------------------------------------------
def test_chain_detection_and_stats(sess):
    """A 3-deep chain plus an independent node compile to 2 templates; the
    fused alias has aten and hopper call-loop rows and no fail-safe."""
    a, b, c = _torch(_np_inputs())[:3]
    w = torch.eye(16)
    crs = [sess.claim(al) for al, _ in EW3]
    cr_mmm = sess.claim("MMM")
    with halo_graph(session=sess, launch=False) as g:
        acc = None
        for (al, spec), cr in zip(EW3, crs):
            acc = sess.isend(tuple(acc if s == "prev" else [a, b, c][s]
                                   for s in spec), cr)
        sess.isend((w, w), cr_mmm)               # independent of the chain
    cg = g.compile()
    st = cg.stats
    assert st["captured_nodes"] == 4 and st["nodes"] == 2
    assert st["fused_nodes"] == 1
    assert st["intermediates_eliminated"] == 2
    assert st["pinned_placements"] + st["unplanned_placements"] == 2
    (alias,) = st["fused_aliases"]
    assert alias.startswith("FUSED:EWMM+EWADD+EWSUB@")
    recs = sess.registry.records(alias)
    assert {r.platform: r.priority for r in recs} == {"aten": 10, "hopper": 20}
    assert sess.registry.failsafe(alias) is None
    assert all(r.cost_model is not None for r in recs)    # sum of parts


def test_terminal_rule_ends_chain(sess):
    """MMM may terminate a chain but nothing fuses after it; results stay
    bit-identical to serial dispatch."""
    a, b, c = _torch(_np_inputs(m=32, n=32))[:3]
    chain = [("EWMM", (0, 1)), ("MMM", ("prev", 1)), ("EWADD", ("prev", 2))]
    ref = _serial(sess, chain, [a, b, c], pin="hopper")
    cg, gr, out = _fused(sess, chain, [a, b, c], pin="hopper")
    assert cg.stats["fused_nodes"] == 1
    assert cg.stats["intermediates_eliminated"] == 1
    assert cg.stats["fused_aliases"][0].startswith("FUSED:EWMM+MMM@")
    assert cg.stats["nodes"] == 2                # EWADD rides outside
    _bitwise(ref, out)


def test_consumers_of_fused_tail_rewire_to_fused_node(sess):
    """Nodes consuming the chain tail read the fused node's output; both
    diamond outputs match the serial reference bit for bit."""
    a, b, c = _torch(_np_inputs())[:3]
    crs = {al: sess.claim(al, overrides=_ov("hopper"))
           for al in ("EWMM", "EWADD", "EWSUB")}

    def run(send):
        t = send((a, b), "EWMM")
        u = send((t, c), "EWADD")
        return send((u, b), "EWMM"), send((u, c), "EWSUB")

    ref_l, ref_r = run(lambda p, al: sess.isend(p, crs[al],
                                                mailbox=False).result(60))
    with halo_graph(session=sess, launch=False) as g:
        run(lambda p, al: sess.isend(p, crs[al]))
    cg = g.compile()
    assert cg.stats["fused_nodes"] == 1 and cg.stats["nodes"] == 3
    out_l, out_r = cg.replay(timeout=60)
    _bitwise(ref_l, out_l)
    _bitwise(ref_r, out_r)


# ---------------------------------------------------------------------------
# Differential conformance: fused is bit-identical to serial in the port
# ---------------------------------------------------------------------------
@DTYPES
@pytest.mark.parametrize("pin", [None, "hopper", "aten"])
@pytest.mark.parametrize("chain", [MIXED4, EW4], ids=["mixed4", "ew4"])
def test_fused_chain_bitwise_vs_serial(sess, dtype, pin, chain):
    """Both rows, both types, each substrate: the fused node is one node,
    never decomposes, and equals one-kernel-at-a-time dispatch bit for bit."""
    inputs = _torch(_np_inputs(), dtype)
    ref = _serial(sess, chain, inputs, pin=pin or "hopper")
    cg, gr, out = _fused(sess, chain, inputs, pin=pin)
    assert cg.stats["fused_nodes"] == 1 and cg.stats["nodes"] == 1
    node = gr.nodes[0]
    assert "decomposed" not in node.attempts
    assert node.platform == (pin or "hopper")
    _bitwise(ref, out)


@DTYPES
@pytest.mark.parametrize("chain", [MIXED4, EW4], ids=["mixed4", "ew4"])
def test_fused_chain_matches_jax(sess, jsess, dtype, chain):
    """The port's fused output agrees with the JAX package's fused output
    on the same numpy inputs; the compile stats are equal."""
    arrays = _np_inputs(seed=3)
    cg, _, out = _fused(sess, chain, _torch(arrays, dtype))
    jcg, _, jout = _fused(jsess, chain, _jax(arrays, dtype), graph=jax_graph)
    _close_to_jax(out, jout, dtype)
    for key in ("captured_nodes", "nodes", "fused_nodes",
                "intermediates_eliminated", "planned_donations"):
        assert cg.stats[key] == jcg.stats[key], key
    assert [a.split("@")[0] for a in cg.stats["fused_aliases"]] == \
        [a.split("@")[0] for a in jcg.stats["fused_aliases"]]


def _program_js(sess, inputs, graph):
    n = 24
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n), dtype=np.float32) + n * np.eye(
        n, dtype=np.float32)
    b = rng.standard_normal(n, dtype=np.float32)
    x = rng.standard_normal(n, dtype=np.float32)
    conv = inputs
    a, b, x = conv([a, b, x])
    cr = sess.claim("JS")
    with graph(session=sess, launch=False) as g:
        for _ in range(3):
            x = sess.isend((a, x, b), cr)
    return g


def _program_diamond(sess, inputs, graph):
    a, b, c = inputs(_np_inputs(seed=7)[:3])
    crs = {al: sess.claim(al) for al in ("EWMM", "EWADD", "EWSUB", "COPY")}
    with graph(session=sess, launch=False) as g:
        t = sess.isend((a, b), crs["EWMM"])
        t = sess.isend((t,), crs["COPY"])
        u = sess.isend((t, c), crs["EWADD"])
        sess.isend((u, b), crs["EWMM"])
        v = sess.isend((u, c), crs["EWSUB"])
        sess.isend((c, v), crs["EWSUB"])
    return g


def _program_chain(chain, m=16, n=128):
    def build(sess, inputs, graph):
        return _capture(sess, chain, inputs(_np_inputs(seed=9, m=m, n=n)),
                        graph=graph)
    return build


PROGRAMS = {"ew3": _program_chain(EW3), "mixed4": _program_chain(MIXED4),
            "terminal": _program_chain([("EWMM", (0, 1)), ("MMM", ("prev", 1)),
                                        ("EWADD", ("prev", 2))], m=32, n=32),
            "js3": _program_js, "diamond": _program_diamond}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_compile_stats_equal_jax(sess, jsess, program):
    """The same captured program compiles to the same nodes, chains and
    fused aliases (member lists and argument maps) in both packages."""
    build = PROGRAMS[program]
    cg = build(sess, _torch, halo_graph).compile()
    jcg = build(jsess, _jax, jax_graph).compile()
    for key in ("captured_nodes", "nodes", "fused_nodes",
                "intermediates_eliminated", "planned_donations",
                "fused_aliases"):
        assert cg.stats[key] == jcg.stats[key], key
    out = cg.replay(timeout=60)
    jout = jcg.replay(timeout=60)
    assert len(out) == len(jout)
    for o, j in zip(out, jout):
        _close_to_jax(o, j, torch.float32)


def test_js_chain_bitwise(sess):
    """Jacobi sweeps chain through x: three sweeps fuse into one call loop
    and match three serial sweeps bit for bit."""
    rng = np.random.default_rng(11)
    n = 64
    a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)
                         + n * np.eye(n, dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    x0 = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))

    def run(isend):
        x = x0
        for _ in range(3):
            x = isend(x)
        return x

    cr = sess.claim("JS", overrides=_ov("hopper"))
    ref = run(lambda x: sess.isend((a, x, b), cr, mailbox=False).result(60))
    with halo_graph(session=sess, launch=False) as g:
        run(lambda x: sess.isend((a, x, b), cr))
    cg = g.compile()
    assert cg.stats["fused_nodes"] == 1
    assert cg.stats["fused_aliases"][0].startswith("FUSED:JS+JS+JS@")
    (out,) = cg.replay(timeout=60)
    _bitwise(ref, out)


@pytest.mark.parametrize("chain", [MIXED4, EW3], ids=["mixed4", "ew3"])
def test_chain_pinned_to_torch_decomposes_bitwise(sess, chain):
    """A chain pinned to a substrate with no fused record decomposes back
    into member nodes at replay — and still matches serial bit for bit."""
    inputs = _torch(_np_inputs())
    ref = _serial(sess, chain, inputs, pin="torch")
    cg, gr, out = _fused(sess, chain, inputs, pin="torch")
    assert cg.stats["fused_nodes"] == 1
    node = gr.nodes[0]
    assert "decomposed" in node.attempts
    assert node.platform == "torch"              # tail member's substrate
    assert gr.outputs == [node]                  # shadow members hidden
    _bitwise(ref, out)


# ---------------------------------------------------------------------------
# Failure semantics
# ---------------------------------------------------------------------------
@DTYPES
def test_fail_then_decompose_bitwise(sess, dtype):
    """A fused record whose execution raises quarantines and decomposes;
    the member-chain result is bit-identical to never having fused."""
    inputs = _torch(_np_inputs(), dtype)
    ref = _serial(sess, MIXED4, inputs, pin="aten")
    cg = _capture(sess, MIXED4, inputs, pin="aten").compile()
    (alias,) = cg.stats["fused_aliases"]
    calls = []

    def broken(*args):
        calls.append(len(args))
        raise RuntimeError("fused record lost")

    # the fused alias's aten row replaced by a raising record; a second
    # session on the same registry plans against it
    sess.registry.deregister(alias, "aten")
    bad = sess.registry.register(KernelRecord(alias=alias, fn=broken,
                                              platform="aten", priority=10))
    other = RuntimeAgent(registry=sess.registry, device="cpu")
    try:
        cg2 = _capture(other, MIXED4, inputs, pin="aten").compile()
        assert cg2.templates[0].pinned is bad
        gr = cg2.replay_async()
        out = gr.wait(timeout=60)[-1]
        node = gr.nodes[0]
        assert calls and node.attempts[:2] == ["aten", "decomposed"]
        assert other.scheduler.is_failed(bad)
        assert node.platform == "aten"
        _bitwise(ref, out)
    finally:
        other.finalize()


def test_decomposed_member_failure_fails_the_fused_node(sess):
    """A decomposed chain whose member fails everywhere fails the fused node
    with the reason it decomposed (as the reference does); the member's own
    error stays on its shadow node."""
    inputs = _torch(_np_inputs())
    cg = _capture(sess, EW3, inputs, pin="torch").compile()

    def broken(a, b):
        raise ValueError("member exploded")

    sess.registry.deregister("EWSUB", "torch")
    sess.registry.register(KernelRecord(alias="EWSUB", fn=broken,
                                        platform="torch", is_failsafe=True))
    gr = cg.replay_async()
    with pytest.raises(SelectionError, match="no feasible record"):
        gr.wait(timeout=60)
    shadow = [n for n in gr.nodes if n._shadow]
    assert [n.alias for n in shadow] == ["EWMM", "EWADD", "EWSUB"]
    with pytest.raises(ValueError, match="member exploded"):
        shadow[-1].result(timeout=60)


def _wait_until(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} not reached in time"
        time.sleep(0.005)


def _straggle_fused(sess, chain, inputs, allowed):
    """Compile ``chain`` over ``allowed`` (hopper first: the fused node runs
    on hopper) and hang its fused hopper attempt past the speculation
    floor; returns (compiled replay, the hopper fault agent)."""
    sess.enable_health_monitor(
        config=HealthConfig(heartbeat_timeout=60.0, straggler_multiple=1.0,
                            straggler_min_s=0.05), start=False)
    cg = _capture(sess, chain, inputs, pin=allowed).compile()
    (alias,) = cg.stats["fused_aliases"]
    return cg, FaultPlan(platform="hopper", mode="hang", delay_s=60.0,
                         aliases=[alias])


@pytest.mark.parametrize("winner", ["chain", "fused"])
@pytest.mark.parametrize("chain", [MIXED4, EW4], ids=["mixed4", "ew4"])
def test_straggler_fused_node_decomposes(sess, chain, winner):
    """A straggling fused attempt with no second fused record (the node
    allows hopper and torch, and no fused row is on torch) speculates by
    decomposing: the member chain is placed off the straggler, on torch,
    and races it; first win counts, bit-identical to serial dispatch on the
    platform that won.  When the fused attempt wins, the members not yet
    started are cancelled."""
    inputs = _torch(_np_inputs())
    won_on = "torch" if winner == "chain" else "hopper"
    ref = _serial(sess, chain, inputs, pin=won_on)
    cg, plan = _straggle_fused(sess, chain, inputs, ["hopper", "torch"])
    plans = [plan]
    if winner == "fused":                        # the first member hangs too
        plans.append(FaultPlan(platform="torch", mode="hang", delay_s=60.0))
    with chaos(sess, *plans) as fas:
        fa = fas[0] if winner == "fused" else fas
        gr = cg.replay_async()
        _wait_until(lambda: fa.failures >= 1, what="fused attempt wedged")
        time.sleep(0.06)                         # past the speculation floor
        sess.health.check()
        node = gr.nodes[0]
        assert node.attempts == ["hopper", "decomposed+spec"]
        assert node.speculated
        shadows = [n for n in gr.nodes if n._shadow]
        if winner == "chain":
            out = gr.wait(timeout=60)[-1]        # while the fused call hangs
            assert fa.heartbeat()[1]
            assert node._ready is shadows[-1]._ready
            fa.release()
            _wait_until(lambda: not fa.heartbeat()[1], what="late fused call")
            assert all(n.platform == "torch" for n in shadows)
        else:
            _wait_until(lambda: fas[1].failures >= 1, what="member wedged")
            fa.release()                         # the fused attempt wins
            out = gr.wait(timeout=60)[-1]
            assert [n.cancelled() for n in shadows] == \
                [False] + [True] * (len(chain) - 1)
            fas[1].release()
            _wait_until(lambda: shadows[0].done(), what="first member done")
    assert node.platform == won_on
    assert node.result(timeout=0) is out
    assert [n.alias for n in shadows] == [a for a, _ in chain]
    _bitwise(ref, out)


def test_straggler_pinned_fused_node_does_not_decompose(sess):
    """Pinned to the straggling platform, the member chain could only queue
    behind the straggler: no decomposition; the fused attempt finishes."""
    inputs = _torch(_np_inputs())
    ref = _serial(sess, EW4, inputs, pin="hopper")
    cg, plan = _straggle_fused(sess, EW4, inputs, "hopper")
    with chaos(sess, plan) as fa:
        gr = cg.replay_async()
        _wait_until(lambda: fa.failures >= 1, what="fused attempt wedged")
        time.sleep(0.06)
        sess.health.check()
        node = gr.nodes[0]
        assert node.attempts == ["hopper"] and not node.speculated
        fa.release()
        out = gr.wait(timeout=60)[-1]
    assert node.platform == "hopper" and len(gr.nodes) == 1
    _bitwise(ref, out)


# ---------------------------------------------------------------------------
# CompiledGraph cache + replay
# ---------------------------------------------------------------------------
def test_replay_cache_hit_and_epoch_invalidation(sess):
    """Re-compiling an identical capture returns the cached CompiledGraph;
    a quarantine change (scheduler epoch bump) forces a fresh plan."""
    inputs = _torch(_np_inputs())
    cg1 = _capture(sess, EW3, inputs).compile()
    cg2 = _capture(sess, EW3, inputs).compile()
    assert cg2 is cg1
    assert cg1.stats["cache_hits"] == 1
    rec = sess.registry.records("MMM")[0]
    sess.scheduler.mark_failed(rec)              # epoch moves → stale plans
    cg3 = _capture(sess, EW3, inputs).compile()
    assert cg3 is not cg1
    sess.scheduler.clear_failures()


def test_fuse_switch_compiles_apart(sess):
    """The fusion switch is part of the plan: the same capture compiled
    with and without fusion gives two graphs."""
    inputs = _torch(_np_inputs())
    fused = _capture(sess, EW3, inputs).compile()
    unfused = _capture(sess, EW3, inputs).compile(fuse=False)
    assert unfused is not fused
    assert fused.stats["fused_aliases"] and not unfused.stats["fused_aliases"]
    assert _capture(sess, EW3, inputs).compile(fuse=False) is unfused


def test_compiled_graph_cache_is_bounded(monkeypatch, sess):
    monkeypatch.setattr(fusion, "GRAPH_CACHE", 2)
    for m in (8, 16, 24):
        _capture(sess, EW3, _torch(_np_inputs(m=m))).compile()
    assert len(sess._compiled_graphs) == 2


def test_finalize_clears_the_compiled_graphs():
    registry = KernelRegistry()
    register_all(registry)
    s = RuntimeAgent(registry=registry, device="cpu")
    _capture(s, EW3, _torch(_np_inputs())).compile()
    assert len(s._compiled_graphs) == 1
    s.finalize()
    assert len(s._compiled_graphs) == 0


def test_replay_updates_and_validation(sess):
    """replay(updates=) swaps input slots by index; a shape, type or device
    mismatch and unknown slots are rejected."""
    inputs = _torch(_np_inputs())
    cg, _, out = _fused(sess, EW3, inputs, pin="hopper")
    slot = cg.slot_of(inputs[0])
    assert slot is not None
    a2 = inputs[0] * 2.0
    ref2 = _serial(sess, EW3, [a2] + inputs[1:], pin="hopper")
    (out2,) = cg.replay(updates={slot: a2}, timeout=60)
    _bitwise(ref2, out2)
    for bad in (torch.zeros((2, 2)), inputs[0].to(torch.bfloat16),
                torch.zeros((128, 16)).t()):
        with pytest.raises(GraphError):
            cg.replay(updates={slot: bad})
    with pytest.raises(GraphError):
        cg.replay(updates={99: a2})


def test_steady_state_replay_is_fully_pinned(sess):
    """After compile, replays place every node through the pinned fast
    path — no re-capture, no re-scoring, no re-wiring in steady state."""
    inputs = _torch(_np_inputs())
    cg = _capture(sess, MIXED4, inputs).compile()
    for _ in range(3):
        cg.replay(timeout=60)
    assert cg.stats["replays"] == 3
    assert cg.stats["placements_scored_last"] == 0
    assert cg.stats["placements_pinned_last"] == cg.stats["nodes"]


def test_fuse_false_disables_fusion(sess):
    """fuse=False keeps replay caching but skips the fusion pass; the
    unfused compiled graph still matches serial bit for bit."""
    inputs = _torch(_np_inputs())
    ref = _serial(sess, MIXED4, inputs, pin="hopper")
    cg, gr, out = _fused(sess, MIXED4, inputs, pin="hopper", fuse=False)
    assert cg.stats["fused_nodes"] == 0
    assert cg.stats["nodes"] == cg.stats["captured_nodes"] == 4
    _bitwise(ref, out)


def test_ew_chain_registers_the_chain_kernel(sess):
    """A pure element-wise chain has the chain kernel as its hopper row
    (its plain version on CPU tensors); a mixed chain, and an element-wise
    chain over the kernel's caps, keep the hopper call loop."""
    inputs = _torch(_np_inputs())
    cg, gr, out = _fused(sess, EW3, inputs)
    (alias,) = cg.stats["fused_aliases"]
    hop = next(r for r in sess.registry.records(alias)
               if r.platform == "hopper")
    assert hop.fn.func is ewise_chain
    assert hop.fn.keywords["steps"] == (("mul", 0, 1), ("add", ACC, 2),
                                        ("sub", ACC, 1))
    assert gr.nodes[0].platform == "hopper"
    _bitwise(_serial(sess, EW3, inputs, pin="hopper"), out)
    mixed, _, _ = _fused(sess, MIXED4, inputs)
    hop = next(r for r in sess.registry.records(mixed.stats["fused_aliases"][0])
               if r.platform == "hopper")
    assert "loop" in hop.doc
    long_chain = [("EWMM", (0, 1))] + [("EWADD", ("prev", 2))] * 32
    long, _, out = _fused(sess, long_chain, inputs)
    hop = next(r for r in sess.registry.records(long.stats["fused_aliases"][0])
               if r.platform == "hopper")
    assert "loop" in hop.doc
    _bitwise(_serial(sess, long_chain, inputs, pin="hopper"), out)


EW_GRAPH_CHAINS = {
    "copy": [("COPY", (2,)), ("EWMM", ("prev", 0)), ("COPY", ("prev",)),
             ("EWADD", ("prev", 3))],
    "acc second": [("EWMM", (1, 1)), ("EWMD", (0, "prev")),
                   ("EWSUB", (2, "prev")), ("EWADD", (3, "prev"))],
    "input twice": [("EWMM", (0, 0)), ("EWMD", ("prev", 1)),
                    ("EWADD", ("prev", 0))],
}


@DTYPES
@pytest.mark.parametrize("name", sorted(EW_GRAPH_CHAINS))
def test_ew_chain_kernel_row_bitwise_vs_serial(sess, dtype, name):
    """Captured chains with COPY steps, the chain result as the second
    operand, and an input used twice run on the chain kernel's row and
    equal serial hopper dispatch bit for bit."""
    chain = EW_GRAPH_CHAINS[name]
    inputs = _torch(_np_inputs(seed=11), dtype)
    cg, gr, out = _fused(sess, chain, inputs)
    assert cg.stats["fused_nodes"] == 1 and cg.stats["nodes"] == 1
    hop = next(r for r in sess.registry.records(cg.stats["fused_aliases"][0])
               if r.platform == "hopper")
    assert hop.fn.func is ewise_chain
    assert gr.nodes[0].platform == "hopper"
    _bitwise(_serial(sess, chain, inputs, pin="hopper"), out)


def test_chain_kernel_row_refuses_what_the_kernel_does_not_take(sess):
    """The chain kernel's hopper row is infeasible for mixed shapes, mixed
    types, 0-d operands, and chains over the kernel's caps."""
    inputs = _torch(_np_inputs())
    cg = _capture(sess, EW3, inputs).compile()
    hop = next(r for r in sess.registry.records(cg.stats["fused_aliases"][0])
               if r.platform == "hopper")
    a, b, c = inputs[:3]
    assert hop.feasible(a, b, c)
    assert not hop.feasible(a, b, c[:8])
    assert not hop.feasible(a, b, c.to(torch.bfloat16))
    assert not hop.feasible(a[0, 0], b[0, 0], c[0, 0])
    assert not hop.feasible(a, b, c.t().contiguous().t())
    steps = tuple(("add", ACC, 0) for _ in range(32))
    assert chain_problem([a], (("copy", 0, None),) + steps) is not None
    assert chain_problem([a] * 17, (("copy", 0, None),)) is not None
    assert chain_problem([a] * 16, (("copy", 15, None),) + steps[:31]) is None


def test_compile_rejects_launched_and_foreign_graphs(sess):
    a, b = _torch(_np_inputs())[:2]
    cr = sess.claim("EWMM")
    with halo_graph(session=sess) as g:          # launched on exit
        sess.isend((a, b), cr)
    g.wait(timeout=60)
    with pytest.raises(GraphError, match="already launched"):
        g.compile()
    fut = sess.isend((a, b), cr, mailbox=False)
    fut.result(60)
    with halo_graph(session=sess, launch=False) as g2:
        sess.isend((fut, b), cr)                 # gated on a foreign future
    with pytest.raises(GraphError, match="outside this graph"):
        g2.compile()


def test_facade_graph_compile_replay():
    """halo.graph(launch=False) → compile() → replay() on a CPU session."""
    session = halo.initialize(device="cpu")
    try:
        a, b, c = _torch(_np_inputs())[:3]
        pin = {"allowed_platforms": ["hopper"]}
        with halo.graph(launch=False) as g:
            t = halo.isend((a, b), halo.claim("EWMM", overrides=pin))
            halo.isend((t, c), halo.claim("EWADD", overrides=pin))
        assert isinstance(g, halo.ExecutionGraph)
        cg = halo.compile_graph(g)
        assert isinstance(cg, halo.CompiledGraph)
        (out,) = cg.replay(timeout=60)
        _bitwise(a * b + c, out)
        assert session._compiled_graphs
    finally:
        halo.finalize()


# ---------------------------------------------------------------------------
# Cost + scheduler plumbing
# ---------------------------------------------------------------------------
def test_sum_of_parts_cost_model(sess):
    """A fused record estimates as the sum of its members' best estimates
    until measured — and refuses to guess before any member is known."""
    inputs = _torch(_np_inputs())
    cg = _capture(sess, EW3, inputs).compile()
    (alias,) = cg.stats["fused_aliases"]
    rec = next(r for r in sess.registry.records(alias) if r.platform == "aten")
    args = tuple(inputs[:3])
    with pytest.raises(ValueError):
        rec.cost_model(*args)                    # no member estimates yet
    sched = sess.scheduler
    sig = abstract_signature(args[:2])
    per_member = {"EWMM": 3e-4, "EWADD": 2e-4, "EWSUB": 1e-4}
    for al, seconds in per_member.items():
        mrec = next(r for r in sess.registry.records(al)
                    if r.platform == "aten")
        sched.observe(mrec, sig, seconds)        # warmup sample (discarded)
        sched.observe(mrec, sig, seconds)
    assert rec.cost_model(*args) == pytest.approx(sum(per_member.values()),
                                                  rel=1e-6)
    assert sched.estimate(rec, abstract_signature(args), args) == \
        pytest.approx(sum(per_member.values()), rel=1e-6)


def test_scheduler_epoch_tracks_quarantine_changes():
    sched = CostModelScheduler()
    rec = KernelRecord(alias="K", fn=lambda a: a, platform="aten")
    e0 = sched.epoch
    sched.mark_failed(rec)
    assert sched.epoch == e0 + 1
    sched.clear_failures()
    assert sched.epoch == e0 + 2
    sched.clear_failures()                       # nothing quarantined: no-op
    assert sched.epoch == e0 + 2


# ---------------------------------------------------------------------------
# The chain's plain version against the JAX package's chain kernel
# ---------------------------------------------------------------------------
CHAINS = {
    "ew4": (("mul", 0, 1), ("add", ACC, 2), ("sub", ACC, 3), ("div", ACC, 1)),
    "copy": (("copy", 2, None), ("mul", ACC, 0), ("copy", ACC, None),
             ("add", ACC, 3)),
    "acc second": (("mul", 1, 1), ("div", 0, ACC), ("sub", 2, ACC),
                   ("add", 3, ACC)),
    "input twice": (("mul", 0, 0), ("div", ACC, 1), ("add", ACC, 0)),
}


@DTYPES
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_ewise_chain_ref_matches_jax_chain_kernel(name, dtype):
    """ewise_chain_ref against the JAX package's ewise_chain (Pallas,
    interpret mode) on the same numpy inputs at a ragged shape."""
    steps = CHAINS[name]
    arrays = _np_inputs(seed=13, m=19, n=133)[:4]
    out = ewise_chain_ref(*_torch(arrays, dtype), steps=steps)
    ref = jax_ewise_chain(*_jax(arrays, dtype), steps=steps, interpret=True)
    assert out.dtype == dtype and tuple(out.shape) == (19, 133)
    _close_to_jax(out, ref, dtype)


@DTYPES
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_ewise_chain_on_cpu_equals_serial_ew_ops(name, dtype):
    """The public chain function on CPU tensors equals the EW ops applied
    one by one, bit for bit, and never aliases an input."""
    from repro_torch.kernels.ewise import ewadd, ewmd, ewmm, ewsub
    ops = {"mul": ewmm, "div": ewmd, "add": ewadd, "sub": ewsub}
    xs = _torch(_np_inputs(seed=17)[:4], dtype)
    acc = None
    for op, a, b in CHAINS[name]:
        x = acc if a == ACC else xs[a]
        acc = x if op == "copy" else ops[op](x, acc if b == ACC else xs[b])
    out = ewise_chain(*xs, steps=CHAINS[name])
    _bitwise(acc, out)
    assert all(out is not x for x in xs)


def test_ewise_chain_refuses_bad_steps():
    xs = _torch(_np_inputs()[:2])
    for steps in ((("add", ACC, 0),), (("pow", 0, 1),), (("add", 0, 2),), ()):
        with pytest.raises(ValueError, match="fused chain"):
            ewise_chain(*xs, steps=steps)
    only_copy = ewise_chain(xs[0], steps=(("copy", 0, None),))
    _bitwise(xs[0], only_copy)
    assert only_copy is not xs[0]


def test_make_composed_resolves_argmaps():
    calls = []

    def f(x, y, *, scale=1.0):
        calls.append((x, y, scale))
        return (x + y) * scale

    composed = make_composed([f, f], [(0, 1), (ACC, 0)], [{}, {"scale": 2.0}])
    assert composed(1.0, 2.0) == 8.0
    assert calls == [(1.0, 2.0, 1.0), (3.0, 1.0, 2.0)]


# ---------------------------------------------------------------------------
# Cache keys never use id() of something that can be collected
# ---------------------------------------------------------------------------
def test_callable_uid_stable_distinct_and_never_reused():
    """Failsafe callables key compiled graphs by a uid that is stable for
    the callable's life and never handed to another callable."""
    import gc

    from repro_torch.core.fusion import _callable_uid, _callable_uids

    def f():
        return 1

    def g():
        return 2

    assert _callable_uid(f) == _callable_uid(f) != _callable_uid(g)
    uid = _callable_uid(f)
    before = len(_callable_uids)
    del f
    gc.collect()
    assert len(_callable_uids) == before - 1     # the entry died with f

    def h():
        return 3

    assert _callable_uid(h) != uid
    assert _callable_uid(len) == _callable_uid(len)   # builtins: id() is safe


def test_claim_failsafe_is_part_of_the_graph_key(sess):
    """Two captures that differ only in their claim-level fail-safe compile
    apart; the same fail-safe hits the cache."""
    a, b = _torch(_np_inputs())[:2]

    def fs1(x, y):
        return x

    def fs2(x, y):
        return y

    def compile_with(fs):
        cr = sess.claim("EWMM", failsafe=fs)
        with halo_graph(session=sess, launch=False) as g:
            sess.isend((a, b), cr)
        return g.compile()

    first = compile_with(fs1)
    assert compile_with(fs1) is first
    assert compile_with(fs2) is not first


@pytest.mark.parametrize("alias,args", [
    ("COPY", (np.arange(6, dtype=np.float32).reshape(2, 3),)),
    ("CONCAT", (np.ones((2, 3), np.float32), np.zeros((1, 3), np.float32))),
    ("CONCAT", (np.float32(1.5), np.float32(2.5), np.float32(-1.0))),
])
def test_staging_rows_match_jax(sess, alias, args):
    """COPY and CONCAT have torch, aten and hopper rows, each giving the JAX
    package's staging oracle's value."""
    from repro.kernels import staging as jax_staging
    ref = {"COPY": jax_staging.copy_ref,
           "CONCAT": jax_staging.concat_ref}[alias](*map(jnp.asarray, args))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    recs = sess.registry.records(alias)
    assert {r.platform: r.priority for r in recs} == {"torch": 0, "aten": 10,
                                                      "hopper": 20}
    for rec in recs:
        out = rec.fn(*targs)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_plan_pins_hopper_for_nodes_fed_by_nodes(sess):
    """The plan judges a node whose inputs are other nodes' results, and a
    call loop judges its members' intermediate results, on stand-ins on the
    session's device: none is planned off the hopper records."""
    cg = _program_diamond(sess, _torch, halo_graph).compile()
    assert cg.stats["unplanned_placements"] == 0
    assert [t.pinned.platform for t in cg.templates] == ["hopper"] * 3
    mixed = _capture(sess, MIXED4, _torch(_np_inputs())).compile()
    assert mixed.templates[0].pinned.platform == "hopper"
