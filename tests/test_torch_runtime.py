"""The port's runtime on the CPU: the C2MPI semantics that the reference's
tests pin (tests/test_c2mpi.py, tests/test_async_c2mpi.py,
tests/test_scheduler.py) for the ported parts — registry ranking, mailboxes,
posted receives, futures, buffers, fail-safe re-placement with quarantine,
and numpy state transfer."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import halo
from repro_torch.core.agents import (HaloCancelledError, HaloFuture,
                                     HopperAgent, RuntimeAgent)
from repro_torch.core.c2mpi import MPIX_Test
from repro_torch.core.compute_object import (ComputeObject, as_compute_object,
                                             from_numpy, to_numpy)
from repro_torch.core.manifest import Manifest, default_manifest
from repro_torch.core.portability import KernelReport, time_fn
from repro_torch.core.registry import (KernelAttributes, KernelRecord,
                                       KernelRegistry, SelectionError)
from repro_torch.core.scheduler import CostModelScheduler
from repro_torch.kernels import register_all

SLICE = ("MMM", "EWMM", "EWMD", "EWADD", "EWSUB", "MVM", "VDP", "JS",
         "1DCONV", "SMMM", "FFT", "SORT", "HIST", "RMSNORM", "FLASH_ATTN")


@pytest.fixture()
def registry():
    reg = KernelRegistry()
    register_all(reg)
    return reg


@pytest.fixture()
def agent(registry):
    a = RuntimeAgent(registry=registry, manifest=default_manifest(),
                     device="cpu")
    yield a
    a.finalize()


def _args(alias, n=16):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(n, n, generator=g)
    b = torch.randn(n, n, generator=g) + 3.0
    x = torch.randn(n, generator=g)
    values = torch.randn(2, 3, n // 2, 4, generator=g)
    indices = torch.tensor([[0, 2, -1], [3, -1, -1]], dtype=torch.int32)
    q = torch.randn(1, 4, 5, 32, generator=g)
    kv = torch.randn(1, 2, 7, 32, generator=g)
    return {"MMM": (a, b), "MVM": (a, x), "VDP": (x, x),
            "JS": (a + n * torch.eye(n), x, x + 1.0), "1DCONV": (x, x[:5]),
            "SMMM": (values, indices, b), "FFT": (a,), "SORT": (a,),
            "HIST": (torch.sigmoid(a),), "RMSNORM": (a, x),
            "FLASH_ATTN": (q, kv, kv + 1.0)}.get(alias, (a, b))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alias", SLICE)
def test_registry_ranks_hopper_over_aten_over_torch(registry, alias):
    args = _args(alias)
    cands = registry.candidates(alias, *args,
                                platform_preference=("hopper", "aten", "torch"))
    assert [c.platform for c in cands] == ["hopper", "aten", "torch"]
    assert [c.priority for c in cands] == [20, 10, 0]
    assert registry.select(alias, *args).platform == "hopper"
    hop = cands[0]
    assert (hop.attrs.vid, hop.attrs.pid) == ("nvidia", "h100")
    assert registry.failsafe(alias).platform == "torch"
    assert registry.resolve_fid(f"fid:{alias.lower()}") == alias


@pytest.mark.parametrize("alias", ["EWMM", "EWMD", "EWADD", "EWSUB"])
def test_ewise_zero_d_operands_go_to_lower_rows(registry, alias):
    """csrc/ewise.cu takes 0-d operands (one element), so the hopper row
    does, unlike the reference's Pallas rows; without it they go to the
    lower rows in order."""
    s, t = torch.tensor(2.0), torch.tensor(3.0)
    hop = registry.select(alias, s, t)
    assert hop.platform == "hopper"
    assert torch.equal(hop.fn(s, t), registry.failsafe(alias).fn(s, t))
    assert registry.select(alias, s, t, allowed_platforms=["aten", "torch"]
                           ).platform == "aten"
    assert registry.select(alias, s, t, allowed_platforms=["torch"]
                           ).platform == "torch"


def test_hopper_rows_infeasible_for_what_the_kernel_does_not_take(registry):
    i = torch.ones(4, 4, dtype=torch.int32)
    assert registry.select("MMM", i, i).platform == "aten"
    f = torch.ones(4, 4)
    assert registry.select("MMM", f, f.double()).platform == "aten"
    assert registry.select("VDP", f, f).platform == "aten"     # not 1-D
    assert registry.select("EWADD", f, torch.ones(4)).platform == "aten"


@pytest.mark.parametrize("alias", ["FFT", "SORT", "HIST"])
def test_integer_operands_leave_the_hopper_row(registry, alias):
    i = torch.ones(4, 4, dtype=torch.int32)
    assert registry.select(alias, i).platform == "aten"
    assert registry.select(alias, i, allowed_platforms=["hopper", "torch"]
                           ).platform == "torch"


def test_unknown_alias_raises(registry):
    with pytest.raises(SelectionError):
        registry.select("NO_SUCH_KERNEL", torch.ones(2))


def test_round_robin_among_ties_and_deregister():
    reg = KernelRegistry()
    for name in ("a", "b"):
        reg.register(KernelRecord(alias="T", fn=lambda x, n=name: n,
                                  platform="aten",
                                  attrs=KernelAttributes(sw_fid="fid:t")))
    picks = {reg.select("T", 1).fn(1) for _ in range(4)}
    assert picks == {"a", "b"}
    assert reg.deregister("T", "aten") == 2
    assert reg.aliases() == []


# ---------------------------------------------------------------------------
# claim / send / recv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alias", SLICE)
def test_claim_send_recv_runs_the_hopper_record(agent, alias):
    args = _args(alias)
    cr = agent.claim(alias)
    agent.send(args, cr)
    out = agent.recv(cr)
    ref = agent.registry.failsafe(alias).fn(*args)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)
    assert agent.agents["hopper"].metrics["requests"] == 1


def test_tag_fifo_out_of_order(agent):
    eye = torch.eye(4)
    cr = agent.claim("MMM")
    agent.send((eye * 1, eye), cr, tag=7)
    agent.send((eye * 2, eye), cr, tag=7)
    agent.send((eye * 3, eye), cr, tag=9)
    assert torch.equal(agent.recv(cr, tag=9), 3 * eye)
    assert torch.equal(agent.recv(cr, tag=7), 1 * eye)     # FIFO
    assert torch.equal(agent.recv(cr, tag=7), 2 * eye)


def test_fifo_per_tag_under_concurrent_isend(agent):
    eye = torch.eye(4)
    cr = agent.claim("MMM")
    n_threads, n_each = 4, 12
    barrier = threading.Barrier(n_threads)

    def worker(tag):
        barrier.wait()
        for i in range(n_each):
            agent.isend((eye * (i + 1), eye), cr, tag=tag)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for tag in range(n_threads):
        got = [int(agent.recv(cr, tag=tag)[0, 0]) - 1 for _ in range(n_each)]
        assert got == list(range(n_each)), tag


def test_recv_empty_mailbox_raises(agent):
    with pytest.raises(RuntimeError, match="empty mailbox"):
        agent.recv(agent.claim("MMM"))


def test_irecv_posted_before_isend(agent):
    cr = agent.claim("MMM")
    eye = torch.eye(4)
    waiter = agent.irecv(cr, tag=3)
    assert not waiter.done()
    agent.isend((2.0 * eye, eye), cr, tag=3)
    assert torch.equal(halo.wait(waiter, timeout=30), 2.0 * eye)
    # a second send on the tag goes to the mailbox, not the used-up waiter
    agent.send((3.0 * eye, eye), cr, tag=3)
    assert torch.equal(agent.recv(cr, tag=3), 3.0 * eye)


def test_wait_waitall_and_test(agent):
    x = torch.ones(128)
    reqs = [agent.isend((x * i, x), agent.claim("VDP"), mailbox=False)
            for i in range(1, 4)]
    outs = halo.waitall(reqs, timeout=30)
    assert [float(o) for o in outs] == [128.0, 256.0, 384.0]
    fut = agent.isend((x, x), agent.claim("VDP"), mailbox=False)
    deadline = time.monotonic() + 30
    done, result = MPIX_Test(fut)
    while not done and time.monotonic() < deadline:
        time.sleep(0.001)
        done, result = MPIX_Test(fut)
    assert done and float(result) == 128.0
    assert fut.device_done()                       # host result: no event


def test_test_reports_in_flight_until_the_worker_finishes(agent):
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    agent.registry.register(KernelRecord(alias="SLOW", fn=slow,
                                         platform="torch", is_failsafe=True))
    fut = agent.isend((torch.ones(2),), agent.claim("SLOW"), mailbox=False)
    assert MPIX_Test(fut) == (False, None)
    gate.set()
    assert torch.equal(halo.wait(fut, timeout=30), torch.ones(2))


def test_cancellation_and_free_cancel_posted_receives(agent):
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    agent.registry.register(KernelRecord(alias="SLOW", fn=slow,
                                         platform="torch", is_failsafe=True))
    cr = agent.claim("SLOW")
    blocker = agent.isend((torch.ones(2),), cr)     # occupies the worker
    queued = agent.isend((torch.ones(2),), cr)
    assert queued.cancel() and queued.cancelled()
    gate.set()
    blocker.result(timeout=30)
    with pytest.raises(HaloCancelledError):
        queued.result(timeout=5)
    other = agent.claim("MMM")
    waiter = agent.irecv(other)
    agent.free(other)
    assert waiter.cancelled()
    with pytest.raises(RuntimeError, match="freed"):
        agent.isend((torch.eye(2), torch.eye(2)), other)


def test_execution_error_propagates_to_wait_and_blocking_send(agent):
    def boom(x):
        raise ValueError("kernel exploded")

    agent.registry.register(KernelRecord(alias="BOOM", fn=boom,
                                         platform="torch", is_failsafe=True))
    fut = agent.isend((torch.ones(2),), agent.claim("BOOM"))
    with pytest.raises(ValueError, match="kernel exploded"):
        fut.result(timeout=30)
    with pytest.raises(ValueError, match="kernel exploded"):
        agent.send((torch.ones(2),), agent.claim("BOOM"))


def test_send_fwd_routes_to_dest(agent):
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    src, dst = agent.claim("MMM"), agent.claim("EWMM")
    agent.send_fwd((a, a), src, dst, tag=3)
    torch.testing.assert_close(agent.recv(dst, tag=3), a @ a)
    with pytest.raises(RuntimeError, match="empty mailbox"):
        agent.recv(src, tag=3)


def test_create_buffer_stateful_cr_and_free(agent):
    def accumulate(x, *, state):
        total = state["acc"] + x
        return total, {"acc": total}

    agent.registry.register(KernelRecord(alias="ACC", fn=accumulate,
                                         platform="torch", is_failsafe=True))
    cr = agent.claim("ACC")
    h = agent.create_buffer(cr, (3,), torch.float32, name="acc")
    assert cr.stateful and h.owner_rank == cr.uid
    assert agent.read_buffer(h).device.type == "cpu"
    for _ in range(3):
        agent.send((torch.ones(3),), cr)
    assert torch.equal(agent.recv(cr), torch.ones(3))
    assert torch.equal(agent.read_buffer(h), 3 * torch.ones(3))
    g = agent.create_buffer(None, (2,), torch.float32, init=[1.0, 2.0])
    assert torch.equal(agent.read_buffer(g), torch.tensor([1.0, 2.0]))
    agent.free(cr)
    assert cr.freed and not cr.buffers
    with pytest.raises(KeyError):
        agent.read_buffer(h)


def test_pipeline_cr_chains_records_without_host_round_trips(agent):
    agent.registry.register(KernelRecord(alias="DOUBLE", fn=lambda x: 2 * x,
                                         platform="torch", is_failsafe=True))
    cr = agent.claim(["EWADD", "DOUBLE"])
    assert cr.pipeline == ("EWADD", "DOUBLE")
    agent.send((torch.ones(3), torch.ones(3)), cr)
    assert torch.equal(agent.recv(cr), 4 * torch.ones(3))


def test_claim_level_failsafe_callback(agent):
    cr = agent.claim("NO_SUCH_KERNEL", failsafe=lambda *a: torch.zeros(2))
    agent.send((torch.ones(2),), cr)
    assert torch.equal(agent.recv(cr), torch.zeros(2))


def test_failing_record_is_quarantined_and_request_replaced(agent):
    """A record that raises is quarantined and the request re-places onto
    the next row, ending at the oracle: host code still gets the answer."""
    calls = {"hopper": 0}

    def broken(a, b):
        calls["hopper"] += 1
        raise RuntimeError("kernel launch failed")

    rec = agent.registry.register(KernelRecord(
        alias="MMM", fn=broken, platform="hopper", priority=99))
    a = torch.randn(6, 6, generator=torch.Generator().manual_seed(2))
    cr = agent.claim("MMM", overrides={"allowed_platforms": ["hopper", "torch"]})
    agent.send((a, a), cr)
    torch.testing.assert_close(agent.recv(cr), a @ a)
    assert calls["hopper"] == 1
    assert agent.scheduler.is_failed(rec)
    assert agent.scheduler.failed_record_keys() == ["MMM|hopper|99:1.0.0"]
    # the quarantined record is not selected again
    agent.send((a, a), cr)
    agent.recv(cr)
    assert calls["hopper"] == 1
    agent.scheduler.clear_failures()
    assert agent.scheduler.failed_record_keys() == []


def test_pinned_claim_never_leaves_its_platforms(agent):
    """A claim pinned to ``hopper`` gets the kernel's error, not the oracle's
    answer: neither re-placement nor selection falls back to the fail-safe
    row outside the pin."""
    def broken(x):
        raise RuntimeError("kernel launch failed")

    reg = KernelRegistry()
    reg.register(KernelRecord(alias="X", fn=broken, platform="hopper"))
    reg.register(KernelRecord(alias="X", fn=lambda x: x, platform="torch",
                              is_failsafe=True))
    rt = RuntimeAgent(registry=reg, device="cpu")
    try:
        cr = rt.claim("X", overrides={"allowed_platforms": ["hopper"]})
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            rt.send((torch.ones(2),), cr)
        # the record is quarantined now; selection refuses the fail-safe
        # rather than route the pinned claim to it
        with pytest.raises(SelectionError, match="no feasible record"):
            rt.send((torch.ones(2),), cr)
        assert rt.agents["torch"].metrics["requests"] == 0
        # the unpinned claim still re-places onto the oracle
        rt.send((torch.ones(2),), rt.claim("X"))
        assert rt.agents["torch"].metrics["requests"] == 1
    finally:
        rt.finalize()
    # an infeasible hopper row (VDP takes 1-D vectors) is refused the same way
    with pytest.raises(SelectionError):
        agent.send((torch.eye(4), torch.eye(4)), agent.claim(
            "VDP", overrides={"allowed_platforms": ["hopper"]}))
    assert agent.agents["torch"].metrics["requests"] == 0


def test_every_path_failing_surfaces_the_first_error(agent):
    def broken(*a):
        raise RuntimeError("first")

    reg = KernelRegistry()
    reg.register(KernelRecord(alias="X", fn=broken, platform="hopper"))
    reg.register(KernelRecord(alias="X", fn=lambda *a: 1 / 0, platform="torch",
                              is_failsafe=True))
    rt = RuntimeAgent(registry=reg, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="first"):
            rt.send((torch.ones(1),), rt.claim("X"))
    finally:
        rt.finalize()


def test_dispatch_and_t1_accounting(agent):
    a = torch.eye(3)
    agent.reset_t1()
    assert torch.equal(agent.dispatch("MMM", a, 2 * a), 2 * a)
    agent.send((a, a), agent.claim("EWADD"))
    assert agent._t1_calls == 2 and agent.t1_seconds_per_call > 0


def test_finalize_stops_workers_and_refuses_new_work(registry):
    rt = RuntimeAgent(registry=registry, device="cpu")
    rt.send((torch.eye(2), torch.eye(2)), rt.claim("MMM"))
    rt.finalize()
    assert rt.finalized
    assert all(a._worker is None for a in rt.agents.values())
    with pytest.raises(RuntimeError, match="finalized"):
        rt.claim("MMM")


def test_hopper_agent_on_cpu_runs_plain_versions():
    assert HopperAgent("cpu").available()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HopperAgent("cuda")


def test_facade_session_on_cpu():
    session = halo.initialize(device="cpu")
    try:
        assert halo.session() is session and session.device.type == "cpu"
        cr = halo.claim("EWSUB")
        halo.send((torch.ones(2, 2), torch.ones(2, 2)), cr)
        assert torch.equal(halo.recv(cr), torch.zeros(2, 2))
        assert torch.equal(halo.dispatch("EWMM", torch.ones(2), torch.ones(2)),
                           torch.ones(2))
    finally:
        halo.finalize()


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------
def _rec(platform, prio=0):
    return KernelRecord(alias="A", fn=lambda *a: None, platform=platform,
                        priority=prio)


def test_scheduler_ema_warmup_and_choice():
    s = CostModelScheduler(explore_every=0)
    hop, aten = _rec("hopper", 20), _rec("aten", 10)
    sig = (((4,), "torch.float32"),)
    args = (torch.ones(4),)
    assert s.choose("A", [hop, aten], args) is None     # no estimates yet
    s.observe(aten, sig, 9.0)                           # warmup: discarded
    assert s.measured(aten, sig) is None
    s.observe(aten, sig, 1.0)
    s.observe(hop, sig, 5.0)
    s.observe(hop, sig, 2.0)
    assert s.choose("A", [hop, aten], args) is aten
    s.observe(hop, sig, 0.0)
    assert s.measured(hop, sig) == pytest.approx(1.5)


def test_scheduler_explores_unmeasured_candidates():
    s = CostModelScheduler(explore_every=4)
    hop, aten = _rec("hopper", 20), _rec("aten", 10)
    sig = (((4,), "torch.float32"),)
    s.observe(aten, sig, 1.0)
    s.observe(aten, sig, 1.0)
    picks = [s.choose("A", [hop, aten], (torch.ones(4),), explore=True)
             for _ in range(8)]
    assert [p.platform for p in picks].count("hopper") == 2


def test_scheduler_persists_latency_table(tmp_path, monkeypatch):
    path = tmp_path / "lat.json"
    s = CostModelScheduler(cache_path=path)
    rec = _rec("aten")
    sig = (((2,), "torch.float32"),)
    s.observe(rec, sig, 1.0)
    s.observe(rec, sig, 3.0)
    s.save()
    assert CostModelScheduler(cache_path=path).measured(rec, sig) == 3.0
    monkeypatch.setenv("HALO_AUTOTUNE_CACHE", str(path))
    assert CostModelScheduler.default().measured(rec, sig) == 3.0
    monkeypatch.setenv("HALO_AUTOTUNE_CACHE", "")
    assert CostModelScheduler.default().cache_path is None


# ---------------------------------------------------------------------------
# compute objects, manifest, numpy state, portability
# ---------------------------------------------------------------------------
def test_compute_object_pytree_and_single_input():
    co = as_compute_object({"b": torch.ones(2), "a": torch.zeros(3)})
    leaves, spec = torch.utils._pytree.tree_flatten(co)
    assert [tuple(t.shape) for t in leaves] == [(3,), (2,)]
    back = torch.utils._pytree.tree_unflatten(leaves, spec)
    assert isinstance(back, ComputeObject) and set(back.inputs) == {"a", "b"}
    assert co.working_set_bytes() == 20
    assert list(as_compute_object(torch.ones(1)).inputs) == ["arg000"]


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32,
                                   np.int64, jnp.bfloat16])
def test_from_numpy_to_numpy_round_trip(dtype):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 5)) * 100).astype(dtype)
    tree = {"x": arr, "pair": (arr[0], 7), "s": np.float32(2.5)}
    t = from_numpy(tree)
    assert isinstance(t["x"], torch.Tensor) and t["pair"][1] == 7
    if dtype is jnp.bfloat16:
        assert t["x"].dtype == torch.bfloat16
        # the bits are carried, not re-rounded
        assert np.array_equal(t["x"].view(torch.int16).numpy(),
                              arr.view(np.int16))
    back = to_numpy(t)
    assert back["x"].dtype == arr.dtype
    assert np.array_equal(back["x"].view(np.uint8), arr.view(np.uint8))
    assert np.array_equal(back["pair"][0], arr[0])
    assert back["s"] == np.float32(2.5)


def test_manifest_round_trip(tmp_path):
    m = default_manifest()
    assert m.platform_preference() == ("hopper", "aten", "torch")
    assert m.total_slots() == 1
    assert [f.func_alias for f in m.func_list] == list(SLICE)
    m.func("MMM").overrides["allowed_platforms"] = ["hopper"]
    m.to_json(tmp_path / "m.json")
    back = Manifest.from_json(tmp_path / "m.json")
    assert back.to_dict() == m.to_dict()
    assert back.func("MMM").overrides == {"allowed_platforms": ["hopper"]}


def test_claim_merges_manifest_overrides():
    m = default_manifest()
    m.func("MMM").overrides["allowed_platforms"] = ["torch"]
    reg = KernelRegistry()
    register_all(reg)
    rt = RuntimeAgent(registry=reg, manifest=m, device="cpu")
    try:
        cr = rt.claim("MMM", overrides={"tag_note": 1})
        assert cr.overrides == {"allowed_platforms": ["torch"], "tag_note": 1}
        rt.send((torch.eye(2), torch.eye(2)), cr)
        rt.recv(cr)
        assert rt.agents["torch"].metrics["requests"] == 1
    finally:
        rt.finalize()


def test_future_callbacks_and_completed():
    seen = []
    fut = HaloFuture(uid=1, alias="X")
    fut.add_done_callback(lambda f: seen.append(f.result()))
    assert fut.set_result(3) and not fut.set_result(4)
    assert seen == [3]
    assert HaloFuture.completed(5).result() == 5


def test_time_fn_on_cpu_and_kernel_report():
    t = time_fn(lambda: sum(range(100)), device="cpu", warmup=1, iters=5)
    assert t.device == "cpu" and t.runs == 5 and t.median_s > 0
    r = KernelReport("MMM", "cpu", t1_s=1e-6, t3_baseline_s=2e-3,
                     t3_halo_s=4e-3, t3_agnostic_s=8e-3)
    assert r.halo_score == 0.5 and r.agnostic_score == 0.25
    assert r.halo_gain == 2.0
    assert r.overhead == pytest.approx(1e-6 / (4e-3 + 1e-6))
    assert r.csv().startswith("MMM,cpu,")
