"""The captured decode step's CPU half (``repro_torch.serve.step_graph``):

* the host-sync audit: a ``TorchDispatchMode`` that raises on every op
  that reads device data back to the host or makes a tensor from Python
  data wraps the eager decode bodies of ``SlotEngine`` and ``PagedEngine``
  for each family the card serves (danube, gemma3's ring layers, zamba2
  and mamba2, moonshot's MoE, deepseek's MLA) and ``ServeEngine``'s
  lockstep body (paligemma's prefix); a mutant with an ``.item()`` in the
  step is caught.  On the card such an op would be refused inside a
  capture, or baked into the graph as a constant;
* the recapture key: a rebound parameter tree, a TuningDB generation, a
  quarantine, a registration and the session each move it; an in-place
  parameter write keeps it; the CPU, a mesh, a worker member and the
  sharded substrate give none (their agents run off the caller's stream);
* the CPU path: the engines' greedy tokens equal the JAX package's engines'
  on the same weights, and every step is reported eager.

The card half (capture, replay, recapture) is in ``tests/test_torch_cuda.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import SlotEngine as JSlotEngine
from repro.serve.engine import StepScheduler as JStepScheduler
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.core.agents import ShardedAgent, TorchAgent
from repro_torch.core.registry import KernelRecord
from repro_torch.core.tuning import TuneEntry
from repro_torch.distributed.remote import RemoteAgent
from repro_torch.distributed.sharding import mesh_context
from repro_torch.kernels import _cuda
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import (PagedEngine, ServeEngine, SlotEngine,
                                      StepScheduler)
from repro_torch.serve.step_graph import StepGraph, capture_key

#: ops that read device data back to the host (a sync, refused under
#: capture) or make a tensor from Python data (a constant in a graph)
HOST_OPS = frozenset({"_local_scalar_dense", "item", "nonzero", "nonzero_static",
                      "is_nonzero", "masked_select", "unique", "_unique", "_unique2",
                      "unique_dim", "unique_consecutive", "lift_fresh",
                      "lift_fresh_copy"})


#: indexing ops whose boolean index is a nonzero inside the kernel
MASK_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})


class HostSyncAudit(TorchDispatchMode):
    """Raise on every op of :data:`HOST_OPS` dispatched inside the mode,
    and on indexing by a boolean mask; ``ops`` counts what did dispatch,
    so a case can show it ran."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_OPS:
            raise AssertionError(f"host sync or Python data in the decode step: "
                                 f"aten.{name}")
        if name in MASK_INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())):
            raise AssertionError(f"host sync in the decode step: aten.{name} by a "
                                 f"boolean mask")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _audited(body, audits):
    def run(*args):
        audit = HostSyncAudit()
        with audit:
            out = body(*args)
        audits.append(audit.ops)
        return out
    return run


@pytest.fixture
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


def _model(arch, seed=0):
    model = build_model(get_config(arch).reduced())
    return model, model.init(torch.Generator().manual_seed(seed))


def _serve(engine, prompts, budgets, seed=0):
    sched = StepScheduler(engine, seed=seed)
    futs = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    sched.drain()
    return [f.result(timeout=60) for f in futs]


# ---------------------------------------------------------------------------
# (a) the host-sync audit of the eager decode bodies
# ---------------------------------------------------------------------------
#: (arch, prompt lengths): gemma3's reduced local layers hold rings of 32
#: slots, which 30 prompt tokens and 6 decode steps wrap
FAMILIES = [("h2o-danube-1.8b", (9, 5)), ("gemma3-4b", (30, 12)),
            ("zamba2-1.2b", (9, 5)), ("mamba2-370m", (9, 5)),
            ("moonshot-v1-16b-a3b", (9, 5)), ("deepseek-v2-236b", (9, 5))]


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("arch,lens", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_decode_body_reads_nothing_back_to_the_host(cpu_session, arch, lens, paged):
    """Two requests on three slots, one lane idle and the shorter request
    retiring first: every decode step's body runs under the audit."""
    model, params = _model(arch)
    engine = (PagedEngine(model, params, 3, 48, block_size=8) if paged
              else SlotEngine(model, params, 3, 48))
    audits = []
    engine._decode_body = _audited(engine._decode_body, audits)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist() for n in lens]
    out = _serve(engine, prompts, [6, 3])
    assert [len(t) for t in out] == [6, 3]
    assert len(audits) == 5 and all(audits)
    assert engine.step_stats() == {"captures": 0, "replays": 0, "eager_steps": 5}


def test_lockstep_body_reads_nothing_back_to_the_host(cpu_session, monkeypatch):
    """paligemma's prefix-LM lockstep loop (patches in ``batch_extra``)."""
    model, params = _model("paligemma-3b")
    cfg = model.cfg
    audits = []
    monkeypatch.setattr(engine_mod._Lockstep, "body",
                        _audited(engine_mod._Lockstep.body, audits))
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6))
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.prefix_len, cfg.d_model)).astype(np.float32))
    engine = ServeEngine(model, max_len=cfg.prefix_len + 6 + 5)
    toks = engine.generate(params, prompts, 5, batch_extra={"patches": patches})
    assert tuple(toks.shape) == (2, 5)
    assert len(audits) == 4 and all(audits)
    assert engine.step_stats() == {"captures": 0, "replays": 0, "eager_steps": 4}


def test_audit_catches_an_item_in_the_step(cpu_session, monkeypatch):
    """The mutant: the logits' mask reads a value back with ``.item()``."""
    orig = transformer._masked_logits

    def reads_back(params, x, cfg):
        float(x.abs().amax().item())
        return orig(params, x, cfg)
    model, params = _model("h2o-danube-1.8b")
    engine = SlotEngine(model, params, 2, 32)
    engine._decode_body = _audited(engine._decode_body, [])
    monkeypatch.setattr(transformer, "_masked_logits", reads_back)
    sched = StepScheduler(engine)
    fut = sched.submit([1, 2, 3], max_new=3)
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        sched.drain()
    assert isinstance(fut.exception(timeout=5), AssertionError)


def test_audit_catches_python_data_and_masks():
    with HostSyncAudit():
        x = torch.arange(4.0)
        with pytest.raises(AssertionError, match="nonzero"):
            x.nonzero()
        with pytest.raises(AssertionError, match="masked_select"):
            torch.masked_select(x, x > 1)
        with pytest.raises(AssertionError, match="boolean mask"):
            x[x > 1]
        with pytest.raises(AssertionError, match="boolean mask"):
            x.index_put_((x > 1,), x[0])
        with pytest.raises(AssertionError, match="lift_fresh"):
            torch.tensor([1, 2])
        with pytest.raises(AssertionError, match="_local_scalar_dense|is_nonzero"):
            bool(x[1])


# ---------------------------------------------------------------------------
# (b) the recapture key
# ---------------------------------------------------------------------------
CARD = torch.device("cuda", 0)      # a device type only: nothing runs on it


def _key_setup():
    model, params = _model("h2o-danube-1.8b")
    return params, model.init_cache(2, 16)


def test_key_moves_with_a_rebound_parameter_tree(cpu_session):
    params, caches = _key_setup()
    key = capture_key(CARD, params, caches)
    assert key is not None and capture_key(CARD, params, caches) == key
    rebound = pytree.tree_map(torch.clone, params)
    assert capture_key(CARD, rebound, caches) != key
    one_leaf = dict(params, final_norm=params["final_norm"].clone())
    assert capture_key(CARD, one_leaf, caches) != key
    assert capture_key(CARD, params, pytree.tree_map(torch.clone, caches)) != key


def test_key_keeps_an_in_place_parameter_write(cpu_session):
    params, caches = _key_setup()
    key = capture_key(CARD, params, caches)
    with torch.no_grad():
        params["final_norm"].mul_(2.0)
        params["stages"][0][0]["attn"]["wq"].add_(1.0)
    assert capture_key(CARD, params, caches) == key


def test_key_moves_with_the_tuning_db_generation(cpu_session):
    params, caches = _key_setup()
    key = capture_key(CARD, params, caches)
    db = cpu_session.scheduler.tuning
    db.put("MMM|hopper|0:0|bucket", TuneEntry(config={"route": "wgmma"}, seconds=1e-6,
                                              default_seconds=1e-5, source="seed"))
    moved = capture_key(CARD, params, caches)
    assert moved != key and capture_key(CARD, params, caches) == moved


def test_key_moves_with_the_quarantine(cpu_session):
    params, caches = _key_setup()
    key = capture_key(CARD, params, caches)
    cpu_session.scheduler.mark_failed_key("RMSNORM|hopper|0:0")
    quarantined = capture_key(CARD, params, caches)
    assert quarantined != key
    cpu_session.scheduler.clear_failures()
    assert capture_key(CARD, params, caches) == key


def test_key_moves_with_the_records_and_the_session(cpu_session):
    params, caches = _key_setup()
    key = capture_key(CARD, params, caches)
    reg = cpu_session.registry
    gen = reg.generation
    reg.register(KernelRecord(alias="STEP_GRAPH_PROBE", fn=lambda x: x, platform="torch"))
    try:
        assert reg.generation == gen + 1 and capture_key(CARD, params, caches) != key
    finally:
        assert reg.deregister("STEP_GRAPH_PROBE") == 1
    halo.initialize(device="cpu")
    assert capture_key(CARD, params, caches) != key


def test_no_key_on_the_cpu_under_a_mesh_or_with_a_worker(cpu_session):
    params, caches = _key_setup()
    assert capture_key(torch.device("cpu"), params, caches) is None
    with mesh_context(types.SimpleNamespace(mesh_dim_names=("expert",))):
        assert capture_key(CARD, params, caches) is None
    assert capture_key(CARD, params, caches) is not None

    class Remote(TorchAgent):                     # a worker member's proxy
        platform = "hopper@w0"
        on_caller_stream = RemoteAgent.on_caller_stream
    assert not RemoteAgent.on_caller_stream
    for agent in (Remote(), ShardedAgent(types.SimpleNamespace(mesh_dim_names=("expert",)))):
        cpu_session.attach_agent(agent)
        try:
            assert capture_key(CARD, params, caches) is None
        finally:
            cpu_session.detach_agent(agent.platform)
        assert capture_key(CARD, params, caches) is not None
    # an in-process agent of any name is captured, its platform in the key
    key = capture_key(CARD, params, caches)
    cpu_session.attach_agent(type("Fancy", (TorchAgent,), {"platform": "fancy@0"})())
    try:
        moved = capture_key(CARD, params, caches)
        assert moved is not None and moved != key and "fancy@0" in moved[2]
    finally:
        cpu_session.detach_agent("fancy@0")


def test_step_graph_without_a_key_runs_the_body_eagerly():
    calls = []

    def body(x, y):
        calls.append((x.device, y.device))
        return x + y
    graph = StepGraph(torch.device("cpu"))
    for i in range(3):
        out = graph(None, body, torch.full((2,), float(i)), torch.ones(2))
        assert torch.equal(out, torch.full((2,), i + 1.0))
    assert graph.stats() == {"captures": 0, "replays": 0, "eager_steps": 3}
    assert calls == [(torch.device("cpu"),) * 2] * 3


def test_recorded_launches_are_credited():
    """What a capture's wrappers count is noted on its thread and credited
    once a replay; nested recordings add into the outer one."""
    a, b = _cuda.counter("step_graph_probe_a"), _cuda.counter("step_graph_probe_b")
    a.reset(), b.reset()
    with _cuda.recording_launches() as outer:
        a.add()
        with _cuda.recording_launches() as inner:
            a.add(), b.add(2)
    assert inner == {a: 1, b: 2} and outer == {a: 2, b: 2}
    assert (a.count, b.count) == (2, 2)
    _cuda.credit_launches(inner)
    assert (a.count, b.count) == (3, 4)
    b.add()
    assert (a.count, b.count) == (3, 5)


# ---------------------------------------------------------------------------
# (c) the CPU path: the engines' tokens, every step eager
# ---------------------------------------------------------------------------
@pytest.fixture
def danube(cpu_session):
    jm = j_build_model(j_get_config("h2o-danube-1.8b").reduced())
    tm = build_model(get_config("h2o-danube-1.8b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


def _jax_serve(engine, prompts, budgets):
    sched = JStepScheduler(engine, seed=0)
    futs = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    sched.drain()
    return [f.result(timeout=60) for f in futs]


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_cpu_engines_serve_the_reference_tokens_eagerly(danube, paged):
    """Four requests on three slots (one waits, lanes join and leave): the
    JAX engine's greedy tokens, and every decode step eager."""
    jm, jp, tm, tp = danube
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).tolist() for n in (9, 14, 5, 11)]
    budgets = [6, 3, 5, 4]
    if paged:
        engine = PagedEngine(tm, tp, 3, 32, block_size=8)
        want = _jax_serve(JPagedEngine(jm, jp, 3, 32, block_size=8), prompts, budgets)
    else:
        engine = SlotEngine(tm, tp, 3, 32)
        want = _jax_serve(JSlotEngine(jm, jp, 3, 32), prompts, budgets)
    assert _serve(engine, prompts, budgets) == want
    stats = engine.step_stats()
    assert stats["captures"] == stats["replays"] == 0 and stats["eager_steps"] >= 5


def test_cpu_lockstep_serves_the_reference_tokens_eagerly(danube):
    """The lockstep loop at two widths, twice each: the JAX package's
    tokens, one state a width, every step eager."""
    jm, jp, tm, tp = danube
    jeng, teng = JServeEngine(jm, max_len=32), ServeEngine(tm, max_len=32)
    rng = np.random.default_rng(3)
    for b in (2, 3, 2):
        prompts = rng.integers(0, tm.cfg.vocab_size, (b, 7)).astype(np.int32)
        want = np.asarray(jeng._generate_lockstep(jp, jnp.asarray(prompts), 5)).tolist()
        assert teng._generate_lockstep(tp, prompts, 5).tolist() == want
    assert sorted(teng._lockstep) == [2, 3]
    assert teng.step_stats() == {"captures": 0, "replays": 0, "eager_steps": 12}


def test_decode_body_is_the_engine_step(cpu_session):
    """``_decode_body`` on device tensors gives ``decode_step``'s logits:
    the eager body the card's captured step is held against."""
    model, params = _model("h2o-danube-1.8b")
    eng = SlotEngine(model, params, 2, 24)
    for slot, prompt in enumerate(([3, 4, 5, 6], [7, 8])):
        eng.prefill_into_slot(slot, prompt, None)
    twin = SlotEngine(model, params, 2, 24)
    twin.caches = pytree.tree_map(torch.clone, eng.caches)
    tok, pos, act = np.array([1, 2]), np.array([4, 2]), np.array([True, False])
    seen = []
    orig = eng._decode_logits

    def keep(*args):
        seen.append(orig(*args))
        return seen[-1]
    eng._decode_logits = keep
    eng.decode_step(tok, pos, act, None)
    body = twin._decode_body(torch.from_numpy(tok), torch.from_numpy(pos),
                             torch.from_numpy(act))
    assert torch.equal(seen[0], body)
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(eng.caches),
                                                 pytree.tree_leaves(twin.caches)))
