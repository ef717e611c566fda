"""C²MPI device groups and the collective verbs in the port (DESIGN.md §10)
on the CPU, held against the JAX package: the cases of
tests/test_collective.py, each run through a reference
``HaloComm(["xla", "jnp"])`` and a port ``HaloComm(["hopper", "torch"])``
(the hopper rows' plain versions on CPU tensors) on the same numpy inputs;
the collective Jacobi of ``examples/collective_jacobi.py`` against the
port's ``repro_torch.collective_jacobi``; membership changes, the graph's
hazard edges and the recycled-id guard, a member record that raises
mid-collective, ``rank_platforms``, the partition helpers and the MPIX
verbs.

Tolerances: every verb is bit-exact against the reference (a copy, a
slice, a concatenation, or a pairwise tree of float32 adds or multiplies
in the same order on both sides).  The collective Jacobi is held to the
reference within 1e-5 normwise: the reference's xla MVM is a library dot
product, the port's plain version sums each row's products with
``torch.sum``, so their rows differ by float32 rounding.  Nothing here
waits on a sleep."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import halo as jhalo
from repro.core import CostModelScheduler as JScheduler
from repro.core import KernelRecord as JRecord
from repro.core import KernelRegistry as JRegistry
from repro.core import RuntimeAgent as JAgent
from repro.core import default_manifest as j_manifest
from repro.distributed import sharding as j_sharding
from repro.kernels import register_all as j_register_all
from repro.testing.faults import faulty_record
from repro_torch import collective_jacobi as t_cj
from repro_torch import halo
from repro_torch.core import c2mpi
from repro_torch.core.agents import RuntimeAgent
from repro_torch.core.collective import HaloComm
from repro_torch.core.graph import (ExecutionGraph, GraphError, GraphNode,
                                    halo_graph)
from repro_torch.core.manifest import default_manifest
from repro_torch.core.registry import KernelRecord, KernelRegistry
from repro_torch.core.scheduler import CostModelScheduler, abstract_signature
from repro_torch.distributed import sharding
from repro_torch.kernels import register_all

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60
REF_GROUP = ("xla", "jnp")
PORT_GROUP = ("hopper", "torch")
#: the reference's substrate -> the port's, rank by rank
PLATFORM_OF = dict(zip(REF_GROUP, PORT_GROUP))


def _example():
    spec = importlib.util.spec_from_file_location(
        "collective_jacobi_example", ROOT / "examples" / "collective_jacobi.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def agent():
    registry = KernelRegistry()
    register_all(registry)
    a = RuntimeAgent(registry=registry, manifest=default_manifest(),
                     device="cpu")
    yield a
    a.finalize()


@pytest.fixture()
def jagent():
    registry = JRegistry()
    j_register_all(registry)
    a = JAgent(registry=registry, manifest=j_manifest())
    yield a
    a.finalize()


@pytest.fixture()
def comm(agent):
    return agent.comm_split(list(PORT_GROUP))


@pytest.fixture()
def jcomm(jagent):
    return jagent.comm_split(list(REF_GROUP))


def _np(shape=(4, 6), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _same(got, want):
    """Bit-exact: the port's tensor against the reference's array."""
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- verb semantics against the reference -------------------------------------
def test_bcast_copies_to_every_member(comm, jcomm):
    x = _np()
    copies, jcopies = comm.bcast(_t(x)), jcomm.bcast(jnp.asarray(x))
    assert len(copies) == comm.size == len(jcopies)
    for c, jc in zip(copies, jcopies):
        _same(c, jc)
        _same(c, x)


def test_scatter_gather_roundtrip(comm, jcomm):
    x = _np((8, 3))
    shards, jshards = comm.scatter(_t(x)), jcomm.scatter(jnp.asarray(x))
    assert [tuple(s.shape) for s in shards] == [(4, 3), (4, 3)]
    for s, js in zip(shards, jshards):
        _same(s, js)
    _same(comm.gather(shards), jcomm.gather(jshards))
    _same(comm.gather(shards), x)


def test_scatter_along_axis_1(comm, jcomm):
    x = _np((3, 8), seed=4)
    shards = comm.scatter(_t(x), axis=1)
    for s, js in zip(shards, jcomm.scatter(jnp.asarray(x), axis=1)):
        _same(s, js)


def test_scatter_rejects_indivisible_axis(comm, jcomm):
    for c, x in ((comm, _t(_np((5, 2)))), (jcomm, jnp.asarray(_np((5, 2))))):
        with pytest.raises(ValueError, match="does not divide evenly"):
            c.scatter(x)


@pytest.mark.parametrize("length,parts", [(8, 2), (6, 3), (12, 4), (5, 1)])
def test_partition_slices_match_reference(length, parts):
    assert sharding.partition_slices(length, parts) == \
        j_sharding.partition_slices(length, parts)


@pytest.mark.parametrize("length,parts", [(7, 2), (4, 0)])
def test_partition_slices_refuse_what_the_reference_refuses(length, parts):
    for mod in (sharding, j_sharding):
        with pytest.raises(ValueError):
            mod.partition_slices(length, parts)


def test_member_shard_and_repartition_match_reference():
    x = _np((12, 5), seed=9)
    for r in range(3):
        _same(sharding.member_shard(_t(x), r, 3),
              j_sharding.member_shard(jnp.asarray(x), r, 3))
        _same(sharding.member_shard(_t(x.T.copy()), r, 3, axis=1),
              j_sharding.member_shard(jnp.asarray(x.T.copy()), r, 3, axis=1))
    parts = [_t(x[:6]), _t(x[6:])]
    jparts = [jnp.asarray(x[:6]), jnp.asarray(x[6:])]
    got = sharding.repartition_shards(parts, 3)
    want = j_sharding.repartition_shards(jparts, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
        assert g.is_contiguous()
    # a fresh copy: writing into a shard leaves its source as it was
    single = sharding.repartition_shards([_t(x)], 1)[0]
    single += 1.0
    _same(sharding.member_shard(_t(x), 0, 1), x)


@pytest.mark.parametrize("op", ["sum", "prod"])
@pytest.mark.parametrize("size", [2, 3])
def test_reduce_and_allreduce_bit_exact_with_reference(agent, jagent, op, size):
    """The same pairwise tree ((0+1)+2 at three shards) of float32 adds or
    multiplies on both sides: bit-exact, and equal to the tree in numpy."""
    comm = agent.comm_split(list((PORT_GROUP * 2)[:size]))
    jcomm = jagent.comm_split(list((REF_GROUP * 2)[:size]))
    xs = [_np((4, 6), seed=10 + r) for r in range(size)]
    want = xs[0]
    for x in xs[1:]:
        want = want + x if op == "sum" else want * x
    red = comm.reduce([_t(x) for x in xs], op=op)
    _same(red, jcomm.reduce([jnp.asarray(x) for x in xs], op=op))
    _same(red, want)
    outs = comm.allreduce([_t(x) for x in xs], op=op)
    jouts = jcomm.allreduce([jnp.asarray(x) for x in xs], op=op)
    assert len(outs) == size == len(jouts)
    for o, jo in zip(outs, jouts):
        _same(o, jo)


def test_reduce_scalars_vdp_residual_pattern(comm, jcomm):
    parts = [torch.tensor(1.25), torch.tensor(2.5)]
    jparts = [jnp.float32(1.25), jnp.float32(2.5)]
    assert float(comm.reduce(parts, op="sum")) == 3.75 == \
        float(jcomm.reduce(jparts, op="sum"))
    # gather of 0-d shards stacks one element per rank
    _same(comm.gather(parts), jcomm.gather(jparts))
    _same(comm.gather(parts), np.asarray([1.25, 2.5], np.float32))


def test_allgather(comm, jcomm):
    x = _np((8,), seed=2)
    shards, jshards = comm.scatter(_t(x)), jcomm.scatter(jnp.asarray(x))
    fulls = comm.allgather(shards)
    assert len(fulls) == comm.size
    for full, jfull in zip(fulls, jcomm.allgather(jshards)):
        _same(full, jfull)
        _same(full, x)


def test_reduce_unknown_op_raises(comm):
    with pytest.raises(ValueError, match="no registered combine kernel"):
        comm.reduce([_t(_np()), _t(_np())], op="median")


def test_custom_binary_alias_as_reduce_op(agent, jagent):
    agent.registry.register(KernelRecord(
        alias="EWMAX", fn=torch.maximum, platform="torch", is_failsafe=True))
    jagent.registry.register(JRecord(
        alias="EWMAX", fn=jnp.maximum, platform="jnp", is_failsafe=True))
    comm = agent.comm_split(list(PORT_GROUP))
    jcomm = jagent.comm_split(list(REF_GROUP))
    a, b = _np(seed=1), _np(seed=2)
    got = comm.reduce([_t(a), _t(b)], op="EWMAX")
    _same(got, jcomm.reduce([jnp.asarray(a), jnp.asarray(b)], op="max"))
    _same(got, np.maximum(a, b))


def test_per_rank_length_validation(comm):
    with pytest.raises(ValueError, match="one value per member rank"):
        comm.reduce([_t(_np())], op="sum")
    with pytest.raises(ValueError, match="rank 3 out of range"):
        comm.bcast(_t(_np()), root=3)


def test_comm_split_validation(agent):
    with pytest.raises(ValueError, match="no virtualization agent"):
        agent.comm_split(["gpu-of-theseus"])
    with pytest.raises(ValueError, match="at least one member"):
        agent.comm_split([])
    # the default group spans the available accelerator substrates
    comm = agent.comm_split()
    assert comm.platforms == ("hopper", "aten") and "torch" not in comm.platforms
    assert isinstance(comm, HaloComm) and len(comm) == 2


def test_freed_comm_and_finalize_frees_comms(agent):
    comm = agent.comm_split(["hopper"])
    comm.free()
    with pytest.raises(RuntimeError, match="was freed"):
        comm.bcast(_t(_np()))
    comm2 = agent.comm_split(["hopper"])
    comm3 = agent.comm_split(["hopper", "aten"])
    assert agent._comms[-2:] == [comm2, comm3]
    agent.finalize()
    assert comm2.freed and comm3.freed and agent._comms == []
    with pytest.raises(RuntimeError, match="finalized"):
        agent.comm_split(["hopper"])


# -- member placement ---------------------------------------------------------
def test_member_stages_pin_to_member_agents(comm):
    """Each bcast COPY stage runs on its member's agent (fan-out on the
    member worker queues, not wherever preference points)."""
    submitted = []
    for platform, va in comm.session.agents.items():
        orig = va.submit

        def spy(fn, future=None, _p=platform, _o=orig, **kw):
            submitted.append(_p)
            return _o(fn, future=future, **kw)

        va.submit = spy
    nodes = comm.ibcast(_t(_np()))
    [n.result(timeout=TIMEOUT) for n in nodes]
    assert [n.platform for n in nodes] == list(PORT_GROUP)
    assert set(PORT_GROUP) <= set(submitted)


def test_map_member_compute(comm, jcomm):
    a0, a1 = _np(seed=1), _np(seed=2)
    outs = comm.map("EWMM", [(_t(a0), _t(a0)), (_t(a1), _t(a1))])
    jouts = jcomm.map("EWMM", [(jnp.asarray(a0), jnp.asarray(a0)),
                               (jnp.asarray(a1), jnp.asarray(a1))])
    for o, jo in zip(outs, jouts):
        _same(o, jo)
    _same(outs[1], a1 * a1)


def test_eager_future_chaining_across_collectives(comm):
    """i-verb futures from one launched collective feed the next
    collective's payloads: cross-graph dependencies gate via callbacks."""
    x = _np((6, 4), seed=3)
    shards = comm.scatter(_t(x))
    doubled = comm.imap("EWADD", list(zip(shards, shards)))
    out = comm.reduce(doubled, op="sum")
    _same(out, (x[:3] + x[:3]) + (x[3:] + x[3:]))


# -- graph capture ------------------------------------------------------------
def test_captured_bcast_reduce_diamond_matches_eager(comm):
    """bcast → member compute → reduce as ONE captured graph: multi-parent
    reduce node, bit-identical to the eager run, every node placed."""
    x = _t(_np((4, 6)))
    copies = comm.bcast(x)
    sq = comm.map("EWMM", [(c, c) for c in copies])
    ref = comm.reduce(sq, op="sum")

    with halo_graph(session=comm.session) as g:
        ncopies = comm.ibcast(x)
        nsq = comm.imap("EWMM", [(c, c) for c in ncopies])
        nred = comm.ireduce(nsq, op="sum")
    assert [p.alias for p in nred.parents] == ["EWMM", "EWMM"]
    assert len(g.nodes) == 5
    assert torch.equal(nred.result(timeout=TIMEOUT), ref)
    assert all(p is not None for p in g.placements().values())


def test_capture_order_hazard_edges_between_collectives(comm):
    """Two collectives on one comm in one capture serialize in call order
    even with no data dependency (MPI call-order semantics)."""
    with halo_graph(session=comm.session, launch=False) as g:
        first = comm.ibcast(_t(_np(seed=1)))
        second = comm.ibcast(_t(_np(seed=2)))
    for node in second:
        assert any(p in first for p in node.parents)
    g.launch()
    g.wait(timeout=TIMEOUT)


def test_recycled_graph_id_does_not_wire_stale_hazard_edges(comm):
    """A fresh capture can reuse the ``id()`` of a dead graph whose tails
    entry survived the stale sweep; wiring those completed foreign nodes
    as hazard parents would hang the new graph's roots.  The seal rejects
    tails it does not own."""
    with halo_graph(session=comm.session) as g1:
        stale = comm.ibcast(_t(_np(seed=1)))
    [n.result(timeout=TIMEOUT) for n in stale]
    with halo_graph(session=comm.session) as g2:
        comm._tails = {id(g2): list(stale)}       # id(g2) == id(g1), simulated
        out = comm.ibcast(_t(_np(seed=2)))
    for node in out:
        assert all(g2.owns(p) for p in node.parents)
    _same(out[0].result(timeout=TIMEOUT), _np(seed=2))
    assert not g2.owns(stale[0]) and g1.owns(stale[0])


def test_add_dependency_ignores_duplicates_and_self_and_refuses_after_launch(agent):
    g = ExecutionGraph(agent)
    a = g.record_dispatch("COPY", (_t(_np()),), {}, None)
    b = g.record_dispatch("COPY", (_t(_np(seed=1)),), {}, None)
    g.add_dependency(a, b)
    g.add_dependency(a, b)                      # duplicate: ignored
    g.add_dependency(b, b)                      # self: ignored
    assert b.parents == [a] and a.children == [b] and not a.parents
    g.launch()
    g.wait(timeout=TIMEOUT)
    with pytest.raises(GraphError, match="already launched"):
        g.add_dependency(b, a)
    assert g.owns(a) and not g.owns(GraphNode(99, "COPY", ()))


@pytest.mark.parametrize("verb,args", [
    ("bcast", lambda x: (x,)),
    ("scatter", lambda x: (x,)),
    ("gather", lambda x: ([x, x],)),
    ("allgather", lambda x: ([x, x],)),
    ("reduce", lambda x: ([x, x],)),
    ("allreduce", lambda x: ([x, x],)),
    ("map", lambda x: ("EWMM", [(x, x), (x, x)])),
])
def test_blocking_collective_inside_capture_raises(comm, verb, args):
    with halo_graph(session=comm.session, launch=False):
        with pytest.raises(GraphError, match="would deadlock"):
            getattr(comm, verb)(*args(_t(_np())))


def test_scatter_of_completed_node_unwraps(comm):
    """A finished collective's node is a concrete value: scatter chained
    off it unwraps instead of demanding a pre-capture payload."""
    x = _np((8,), seed=5)
    copies = comm.ibcast(_t(x))
    [c.result(timeout=TIMEOUT) for c in copies]
    shards = comm.scatter(copies[0])
    _same(shards[1], x[4:])


def test_scatter_of_live_node_inside_capture_raises(comm):
    with halo_graph(session=comm.session, launch=False):
        nodes = comm.ibcast(_t(_np((4, 4))))
        with pytest.raises(GraphError, match="concrete payload"):
            comm.iscatter(nodes[0])


def test_captured_multi_iteration_allreduce_jacobi_parity(comm, jcomm):
    """Two captured allgather→MVM→update→allreduce iterations match the
    eager run bit for bit; the port's iterate is held to the reference's
    within 1e-6 normwise (MVM's row sums in another order)."""
    x = _np((8,), seed=6)
    A = [_np((4, 8), seed=11), _np((4, 8), seed=12)]

    def one_pass(shards0, conv, gathered, mapped, reduced):
        cur, res = list(shards0), None
        mats = [conv(a) for a in A]
        for _ in range(2):
            full = gathered(cur)
            p = mapped("MVM", list(zip(mats, full)))
            cur = mapped("EWADD", list(zip(p, cur)))
            s = mapped("VDP", list(zip(cur, cur)))
            res = reduced(s)
        return cur, res

    shards0 = comm.scatter(_t(x))
    cur, res = one_pass(shards0, _t, comm.allgather, comm.map,
                        lambda s: comm.allreduce(s, op="sum"))
    ref_x = comm.gather(cur)
    ref_res = float(res[0])
    with halo_graph(session=comm.session) as g:
        cur, res = one_pass(shards0, _t, comm.iallgather, comm.imap,
                            lambda s: comm.iallreduce(s, op="sum"))
        out = comm.igather(cur)
    assert torch.equal(out.result(timeout=TIMEOUT), ref_x)
    assert float(res[0].result(timeout=TIMEOUT)) == ref_res
    assert all(p is not None for p in g.placements().values())

    jcur, jres = one_pass(jcomm.scatter(jnp.asarray(x)), jnp.asarray,
                          jcomm.allgather, jcomm.map,
                          lambda s: jcomm.allreduce(s, op="sum"))
    jx = np.asarray(jcomm.gather(jcur))
    assert np.linalg.norm(ref_x.numpy() - jx) <= 1e-6 * np.linalg.norm(jx)
    assert ref_res == pytest.approx(float(jres[0]), rel=1e-6)


# -- the collective Jacobi against the reference -------------------------------
@pytest.mark.parametrize("iters", [1, 8])
def test_collective_jacobi_matches_reference_and_serial(iters):
    """n = 64, 4 ranks.  Port: serial on hopper, eager and graph over
    ``["hopper"] * 4``; eager == graph bit for bit (iterate and residual),
    and the collective iterate == serial bit for bit (the plain MVM sums
    each row alone; the updates are element-wise).  Against the reference's
    functions over ``["xla", "jnp"] * 2`` on the same numpy inputs: the
    iterate within 1e-5 normwise; the residual within 1e-5 of the first
    sweep's (after 8 sweeps it is at float32's noise, ~1e-18 against ~1e-2
    after one: its bits say nothing there)."""
    n = 64
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    d = np.diagonal(a).copy()
    ex = _example()

    jhalo.initialize()
    try:
        ja, jb, jd = (jnp.asarray(v) for v in (a, b, d))
        jcomm = jhalo.comm_split(list(REF_GROUP * 2))
        jx, jres = ex.collective_jacobi(jcomm, ja, jb, jd, iters)
        _, jres1 = ex.serial_jacobi(ja, jb, jd, 1)
        jx = np.asarray(jx)
    finally:
        jhalo.finalize()

    session = halo.initialize(device="cpu")
    try:
        ta, tb, td = _t(a), _t(b), _t(d)
        comm = halo.comm_split(["hopper"] * 4)
        assert comm.session is session
        xs, res_s = t_cj.serial_jacobi(ta, tb, td, iters, "hopper")
        xe, res_e = t_cj.collective_jacobi(comm, ta, tb, td, iters)
        g, xg, res_g = t_cj.collective_jacobi_graph(comm, ta, tb, td, iters)
    finally:
        halo.finalize()
    assert torch.equal(xe, xg) and res_e == res_g
    assert torch.equal(xe, xs)
    assert res_e == pytest.approx(res_s, rel=1e-5)      # VDP partials bracketed apart
    assert all(p is not None for p in g.placements().values())
    assert np.linalg.norm(xe.numpy() - jx) <= 1e-5 * np.linalg.norm(jx)
    assert abs(res_e - jres) <= 1e-5 * jres1
    assert t_cj.solve_error(ta, tb, xe) < (1.0 if iters == 1 else 1e-5)


def test_problem_is_diagonally_dominant_and_seeded():
    a, b, d = t_cj.problem(32, "cpu", seed=3)
    a2, b2, _ = t_cj.problem(32, "cpu", seed=3)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert torch.equal(d, torch.diagonal(a))
    off = a.abs().sum(dim=1) - d.abs()
    assert bool((d.abs() > off).all())


# -- elastic membership --------------------------------------------------------
def _bindings(jcomm):
    return tuple(PLATFORM_OF.get(p, p) for p in jcomm.platforms)


def test_remove_and_add_member_rebind_as_the_reference_does(agent, jagent):
    comm = agent.comm_split(["hopper", "torch", "hopper", "torch"])
    jcomm = jagent.comm_split(["xla", "jnp", "xla", "jnp"])
    assert comm.epoch == jcomm.epoch == 0
    assert comm.remove_member(platform="hopper") == ("torch",) * 4
    jcomm.remove_member(platform="xla")
    assert comm.platforms == _bindings(jcomm)
    assert comm.add_member("hopper", rank=2) == ("torch", "torch", "hopper", "torch")
    jcomm.add_member("xla", rank=2)
    assert comm.platforms == _bindings(jcomm)
    assert comm.remove_member(rank=1, shrink=True) == ("torch", "hopper", "torch")
    jcomm.remove_member(rank=1, shrink=True)
    assert comm.platforms == _bindings(jcomm) and comm.size == 3
    assert comm.add_member("hopper") == ("torch", "hopper", "torch", "hopper")
    jcomm.add_member("xla")
    assert comm.platforms == _bindings(jcomm)
    assert comm.epoch == jcomm.epoch == 4
    assert comm.members == ("torch", "hopper")
    with pytest.raises(ValueError, match="exactly one"):
        comm.remove_member()
    with pytest.raises(ValueError, match="holds no rank"):
        comm.remove_member(platform="aten")
    with pytest.raises(ValueError, match="out of range"):
        comm.add_member("hopper", rank=9)
    with pytest.raises(ValueError, match="zero members"):
        agent.comm_split(["hopper"]).remove_member(rank=0, shrink=True)


def test_on_member_dead_rebinds_onto_survivors(agent, jagent):
    comm = agent.comm_split(["hopper", "aten", "hopper"])
    jcomm = jagent.comm_split(["xla", "pallas", "xla"])
    assert comm.on_member_dead("hopper") and jcomm.on_member_dead("xla")
    assert comm.platforms == ("aten",) * 3 and jcomm.platforms == ("pallas",) * 3
    assert comm.epoch == 1
    assert not comm.on_member_dead("torch")          # not a member
    comm.free()
    assert not comm.on_member_dead("aten")           # freed: no-op
    # the last member gone: its ranks fall back to the fail-safe agent
    lone = agent.comm_split(["aten"])
    assert lone.on_member_dead("aten") and lone.platforms == ("torch",)


def test_repartition_carries_state_across_a_resize(agent):
    comm = agent.comm_split(["hopper", "torch", "hopper", "torch"])
    x = _np((12, 2), seed=8)
    shards = comm.scatter(_t(x))
    comm.remove_member(rank=3, shrink=True)
    new = comm.repartition(shards)
    assert [tuple(s.shape) for s in new] == [(4, 2)] * 3
    _same(comm.gather(new), x)
    # completed futures are accepted as shards
    nodes = agent.comm_split(["hopper", "torch"]).iscatter(_t(x))
    [n.result(timeout=TIMEOUT) for n in nodes]
    _same(torch.cat(comm.repartition(nodes)), x)


# -- failure paths --------------------------------------------------------------
def _boom(message):
    def fn(*args, **kwargs):
        raise RuntimeError(message)
    return fn


def _faulty_port_registry():
    """EWADD with a raising hopper record (no aten row) beside the torch
    fail-safe, and a per-member PART alias raising on hopper; built inline
    (the fault-injection helpers are not ported)."""
    reg = KernelRegistry()
    register_all(reg)
    reg.deregister("EWADD", "hopper")
    reg.deregister("EWADD", "aten")
    reg.register(KernelRecord(alias="EWADD", fn=_boom("hopper combine died"),
                              platform="hopper", priority=50))
    reg.register(KernelRecord(alias="PART", fn=_boom("hopper member died"),
                              platform="hopper", priority=50))
    reg.register(KernelRecord(alias="PART", fn=lambda a: a * 3.0,
                              platform="torch", is_failsafe=True))
    return reg


def _faulty_ref_registry():
    reg = JRegistry()
    j_register_all(reg)
    reg.deregister("EWADD", "xla")
    reg.deregister("EWADD", "pallas")
    reg.register(faulty_record("EWADD", platform="xla", message="xla combine died"))
    reg.register(faulty_record("PART", platform="xla", message="xla member died"))
    reg.register(JRecord(alias="PART", fn=lambda a: a * 3.0, platform="jnp",
                         is_failsafe=True))
    return reg


def test_member_quarantine_mid_allreduce_bit_identical():
    """A member whose combine record raises mid-allreduce is quarantined
    and the combine re-places onto the fail-safe; the collective completes
    bit-identical to the serial sum and to the reference's run."""
    a, b = _np(seed=3), _np(seed=4)
    jag = JAgent(registry=_faulty_ref_registry(), manifest=j_manifest())
    try:
        jouts = jag.comm_split(list(REF_GROUP)).allreduce(
            [jnp.asarray(a), jnp.asarray(b)], op="sum")
        jout = np.asarray(jouts[0])
    finally:
        jag.finalize()
    reg = _faulty_port_registry()
    agent = RuntimeAgent(registry=reg, manifest=default_manifest(), device="cpu")
    try:
        comm = agent.comm_split(list(PORT_GROUP))
        outs = comm.allreduce([_t(a), _t(b)], op="sum")
        for o in outs:
            _same(o, a + b)
            _same(o, jout)
        bad = next(r for r in reg.records("EWADD") if r.platform == "hopper")
        assert agent.scheduler.is_failed(bad)
        outs2 = comm.allreduce([_t(a), _t(b)], op="sum")   # skips it now
        _same(outs2[0], a + b)
    finally:
        agent.finalize()


def test_member_compute_failure_replaces_shard():
    """A raising member-compute record re-places that member's shard onto
    the fail-safe; the downstream reduce still sees every shard."""
    a, b = _np(seed=5), _np(seed=6)
    agent = RuntimeAgent(registry=_faulty_port_registry(),
                         manifest=default_manifest(), device="cpu")
    try:
        comm = agent.comm_split(list(PORT_GROUP))
        parts = comm.imap("PART", [(_t(a),), (_t(b),)])
        out = comm.reduce(parts, op="sum")
        _same(out, np.float32(3.0) * a + np.float32(3.0) * b)
        assert parts[0].attempts[0] == "hopper"          # tried the member…
        assert parts[0].platform == "torch"              # …landed on failsafe
    finally:
        agent.finalize()


def test_captured_collective_with_failing_member_completes():
    a, b = _np(seed=7), _np(seed=8)
    agent = RuntimeAgent(registry=_faulty_port_registry(),
                         manifest=default_manifest(), device="cpu")
    try:
        comm = agent.comm_split(list(PORT_GROUP))
        with halo_graph(session=agent):
            parts = comm.imap("PART", [(_t(a),), (_t(b),)])
            red = comm.ireduce(parts, op="sum")
        _same(red.result(timeout=TIMEOUT),
              np.float32(3.0) * a + np.float32(3.0) * b)
    finally:
        agent.finalize()


# -- group-aware scheduler ranking ----------------------------------------------
def test_rank_platforms_orders_members_as_the_reference_does():
    """Measured members fastest first, unmeasured ones behind in their
    given order, quarantined ones dropped — the port and the reference
    rank the same measured latencies the same way."""
    from repro.core.scheduler import abstract_signature as j_sig
    port_of = {"jnp": "torch", "xla": "aten", "pallas": "hopper"}
    sched = CostModelScheduler(explore_every=0)
    jsched = JScheduler(explore_every=0, tuning_db=False)
    recs = {p: KernelRecord(alias="K", fn=lambda a: a, platform=p)
            for p in ("torch", "aten", "hopper")}
    jrecs = {p: JRecord(alias="K", fn=lambda a: a, platform=p)
             for p in ("jnp", "xla", "pallas")}
    args, jargs = (torch.ones(4, 4),), (jnp.ones((4, 4)),)
    for (p, secs), jp in zip((("torch", 1e-5), ("aten", 1e-2)), ("jnp", "xla")):
        for _ in range(2):                    # the first is a warm-up discard
            sched.observe(recs[p], abstract_signature(args), secs)
            jsched.observe(jrecs[jp], j_sig(jargs), secs)
    got = sched.rank_platforms("K", [recs["aten"], recs["torch"]], args)
    want = jsched.rank_platforms("K", [jrecs["xla"], jrecs["jnp"]], jargs)
    assert got == ["torch", "aten"] == [port_of[p] for p in want]
    assert sched.rank_platforms(
        "K", [recs["hopper"], recs["aten"], recs["torch"]], args) == \
        ["torch", "aten", "hopper"]
    sched.mark_failed(recs["torch"])
    assert sched.rank_platforms("K", [recs["aten"], recs["torch"]], args) == ["aten"]


def test_combine_preference_follows_the_ranking(agent):
    """_group_overrides seeds a combine's preference with the measured
    fastest member; with nothing measured it keeps the member order."""
    comm = agent.comm_split(["hopper", "aten"])
    x = _t(_np())
    assert comm._group_overrides("EWADD", (x, x))["platform_preference"] == \
        ["hopper", "aten"]
    sig = abstract_signature((x, x))
    for rec in agent.registry.records("EWADD"):
        for _ in range(2):
            agent.scheduler.observe(rec, sig, 1e-6 if rec.platform == "aten" else 1e-3)
    ov = comm._group_overrides("EWADD", (x, x))
    assert ov == {"allowed_platforms": ["hopper", "aten"],
                  "platform_preference": ["aten", "hopper"]}


# -- the MPIX verbs and the facade ----------------------------------------------
VERBS = ["MPIX_CommSplit", "MPIX_CommFree", "MPIX_Bcast", "MPIX_IBcast",
         "MPIX_Scatter", "MPIX_IScatter", "MPIX_Gather", "MPIX_IGather",
         "MPIX_Allgather", "MPIX_IAllgather", "MPIX_Reduce", "MPIX_IReduce",
         "MPIX_Allreduce", "MPIX_IAllreduce"]
FACADE = {"comm_split": "MPIX_CommSplit", "bcast": "MPIX_Bcast",
          "ibcast": "MPIX_IBcast", "scatter": "MPIX_Scatter",
          "iscatter": "MPIX_IScatter", "gather": "MPIX_Gather",
          "igather": "MPIX_IGather", "allgather": "MPIX_Allgather",
          "iallgather": "MPIX_IAllgather", "reduce": "MPIX_Reduce",
          "ireduce": "MPIX_IReduce", "allreduce": "MPIX_Allreduce",
          "iallreduce": "MPIX_IAllreduce"}


def test_the_fourteen_verbs_and_the_facade_names_exist():
    from repro.core import c2mpi as j_c2mpi
    for verb in VERBS:
        assert verb in c2mpi.__all__ and callable(getattr(c2mpi, verb))
        assert callable(getattr(j_c2mpi, verb))
    for name, verb in FACADE.items():
        assert name in halo.__all__ and getattr(halo, name) is getattr(c2mpi, verb)
    assert halo.HaloComm is HaloComm and "HaloComm" in halo.__all__


def test_verbs_through_the_facade_on_a_cpu_session():
    session = halo.initialize(device="cpu")
    try:
        comm = halo.comm_split(list(PORT_GROUP))
        assert comm in session._comms
        x = torch.arange(8, dtype=torch.float32)
        parts = halo.scatter(x, comm)
        assert [p.shape[0] for p in parts] == [4, 4]
        total = halo.allreduce([p.sum() for p in parts], comm)
        assert [float(t) for t in total] == [28.0, 28.0]
        assert float(halo.wait(halo.ireduce([p.sum() for p in parts], comm))) == 28.0
        assert torch.equal(halo.gather(parts, comm), x)
        assert torch.equal(halo.wait(halo.igather(parts, comm)), x)
        for full in halo.waitall(halo.iallgather(parts, comm)):
            assert torch.equal(full, x)
        for copy in halo.bcast(x, comm) + halo.waitall(halo.ibcast(x, comm)):
            assert torch.equal(copy, x)
        assert [float(t) for t in halo.waitall(halo.iallreduce(
            [p.sum() for p in parts], comm))] == [28.0, 28.0]
        assert torch.equal(torch.cat(halo.waitall(halo.iscatter(x, comm))), x)
        assert torch.equal(c2mpi.MPIX_Reduce(parts, comm, op="prod"),
                           parts[0] * parts[1])
        assert [float(v) for v in c2mpi.MPIX_Allgather(
            [p.sum() for p in parts], comm)[1]] == [6.0, 22.0]
        c2mpi.MPIX_CommFree(comm)
        assert comm.freed
    finally:
        halo.finalize()

