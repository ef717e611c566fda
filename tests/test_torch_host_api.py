"""Port parity for the small host APIs (ROADMAP A1–A3) and their reader,
the portability demo: ``RuntimeAgent.invoke``, ``KernelRegistry.
register_fn``, ``ComputeObject.with_input``/``with_buffer``,
``performance_penalty``, ``fusion_rule``, ``data.pipeline.make_batch`` and
``repro_torch.core``'s re-exports, each against its ``repro`` counterpart;
``repro_torch.portability_demo.run`` on a CPU session against the picks
the JAX demo (``examples/portability_demo.py``) prints.

Inputs are made in numpy from a seed and fed to both packages; the port
runs on the CPU.  MMM results are held at the float32 conformance
tolerance of tests/test_kernels_property.py (2e-4)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as j_core
import repro_torch.core as t_core
from repro.configs import get_config as j_get_config
from repro.configs.base import InputShape as JInputShape
from repro.core import fusion as j_fusion
from repro.core import portability as j_port
from repro.data import pipeline as j_pipeline
from repro.kernels import register_all as j_register_all
from repro_torch import portability_demo
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import InputShape as TInputShape
from repro_torch.core import fusion as t_fusion
from repro_torch.core import portability as t_port
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.data import pipeline as t_pipeline
from repro_torch.kernels import register_all as t_register_all

F32_TOL = dict(rtol=2e-4, atol=2e-4)
#: the JAX demo's substrates and the port's, in policy order
J_TO_T = {"jnp": "torch", "xla": "aten", "pallas": "hopper"}
J_POLICIES = (["jnp"], ["jnp", "xla"], ["jnp", "xla", "pallas"])


def _operands(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


@pytest.fixture
def t_agent():
    registry = t_core.KernelRegistry()
    t_register_all(registry)
    agent = t_core.RuntimeAgent(registry=registry, device="cpu")
    yield agent
    agent.finalize()


@pytest.fixture
def j_agent():
    registry = j_core.KernelRegistry()
    j_register_all(registry)
    agent = j_core.RuntimeAgent(registry=registry)
    yield agent
    agent.finalize()


# ---------------------------------------------------------------------------
# RuntimeAgent.invoke
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", [0, 3])
def test_invoke_matches_jax_and_empties_the_mailbox(t_agent, j_agent, tag):
    """send + recv in one call, under a tag: the MMM product equals the JAX
    agent's invoke on the same numpy operands, and nothing stays queued."""
    a, b = _operands()
    t_cr = t_agent.claim("MMM", overrides={"allowed_platforms": ["aten"]})
    j_cr = j_agent.claim("MMM", overrides={"allowed_platforms": ["xla"]})
    got = t_agent.invoke(t_cr, *from_numpy((a, b)), tag=tag)
    want = j_agent.invoke(j_cr, jnp.asarray(a), jnp.asarray(b), tag=tag)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **F32_TOL)
    assert not t_cr.mailboxes[tag] and not j_cr.mailboxes[tag]
    with pytest.raises(RuntimeError, match="empty mailbox"):
        t_agent.recv(t_cr, tag=tag)


# ---------------------------------------------------------------------------
# KernelRegistry.register_fn
# ---------------------------------------------------------------------------
def _record_fields(rec):
    return (rec.alias, rec.platform, rec.priority, rec.is_failsafe, rec.doc,
            rec.supports, rec.cost_model, dataclasses.asdict(rec.attrs))


@pytest.mark.parametrize("kw", [{}, {"priority": 7, "doc": "mine",
                                     "attrs": "acme", "is_failsafe": True}])
def test_register_fn_registers_as_the_reference(kw):
    """The decorator returns the function unchanged and registers one
    record whose fields are the reference's for the same arguments (the
    attributes default to ``sw_fid=alias``, the doc to the docstring)."""
    recs = []
    for core in (t_core, j_core):
        registry = core.KernelRegistry()
        args = dict(kw)
        if args.get("attrs"):
            args["attrs"] = core.KernelAttributes(vid="acme", sw_fid="fid:x")

        def kernel(x):
            """Doubles x."""
            return x * 2
        assert registry.register_fn("MYOP", "fancy", **args)(kernel) is kernel
        (rec,) = registry.records("MYOP")
        assert rec.fn is kernel
        recs.append(_record_fields(rec))
    assert recs[0] == recs[1]


def test_register_fn_record_wins_selection(t_agent):
    """A substrate attached at run time whose record is registered by the
    decorator at priority 99 and preferred first serves the claim."""
    class Fancy(t_core.VirtualizationAgent):
        platform = "fancy"
    agent = Fancy()
    t_agent.attach_agent(agent)
    calls = []

    @t_agent.registry.register_fn("MMM", "fancy", priority=99)
    def mmm_fancy(x, y):
        calls.append(1)
        return x @ y

    a, b = from_numpy(_operands())
    cr = t_agent.claim("MMM", overrides={
        "allowed_platforms": ["aten", "hopper", "fancy"],
        "platform_preference": ["fancy", "hopper", "aten"]})
    out = t_agent.invoke(cr, a, b)
    assert calls == [1] and agent.metrics["requests"] == 1
    assert torch.equal(out, a @ b)


# ---------------------------------------------------------------------------
# ComputeObject.with_input / with_buffer
# ---------------------------------------------------------------------------
def test_with_input_and_with_buffer_leave_the_original():
    """Each returns a new compute-object with the one entry set (added or
    replaced), tag and meta kept; the original's dicts are untouched — as
    the reference's."""
    out = []
    for core, mk in ((t_core, torch.ones), (j_core, jnp.ones)):
        h1 = core.BufferHandle.allocate((4,), "float32")
        h2 = core.BufferHandle.allocate((2,), "float32")
        co = core.ComputeObject(inputs={"x": mk(2)}, buffers={"s": h1},
                                meta={"k": 1}, tag=5)
        co2 = co.with_input("y", mk(3)).with_input("x", mk(4))
        co3 = co2.with_buffer("t", h2).with_buffer("s", h2)
        assert sorted(co.inputs) == ["x"] and co.inputs["x"].shape == (2,)
        assert co.buffers == {"s": h1} and co.with_input("z", 0).stateful
        assert sorted(co2.inputs) == ["x", "y"] and co2.inputs["x"].shape == (4,)
        assert co2.buffers == {"s": h1} and co2.buffers is not co3.buffers
        assert co3.buffers == {"s": h2, "t": h2} and co3.inputs is co2.inputs
        assert (co3.tag, co3.meta) == (5, {"k": 1})
        out.append((sorted(co3.inputs), sorted(co3.buffers), co3.stateful))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# performance_penalty, fusion_rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t3,base", [(2.0, 1.0), (1.0, 1.0), (0.5, 2.0),
                                     (3e-4, 7e-5), (1.0, 3.0)])
def test_performance_penalty_matches_reference(t3, base):
    assert t_port.performance_penalty(t3, base) == j_port.performance_penalty(t3, base)


def test_fusion_rule_matches_reference():
    """After both packages' register_all, every alias's rule (or None) has
    the reference's fields, and an unknown alias has none."""
    t_register_all(t_core.KernelRegistry())
    j_register_all(j_core.KernelRegistry())
    aliases = sorted(set(t_fusion.FUSION_RULES) | set(j_fusion.FUSION_RULES)
                     | {"NOT_A_KERNEL", "SORT"})
    for alias in aliases:
        t_rule, j_rule = t_fusion.fusion_rule(alias), j_fusion.fusion_rule(alias)
        if j_rule is None:
            assert t_rule is None, alias
        else:
            assert dataclasses.asdict(t_rule) == dataclasses.asdict(j_rule), alias
    assert t_fusion.fusion_rule("MMM").terminal


# ---------------------------------------------------------------------------
# make_batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "paligemma-3b", "musicgen-large"])
def test_make_batch_equals_reference(arch):
    """The same arrays as the reference's for the same step and seed
    (token, patch-embed and frame-embed frontends), as tensors on the
    device the caller passes."""
    t_cfg, j_cfg = t_get_config(arch).reduced(), j_get_config(arch).reduced()
    got = t_pipeline.make_batch(t_cfg, TInputShape("x", 24, 2, "train"), 3, 1,
                                device="cpu")
    want = j_pipeline.make_batch(j_cfg, JInputShape("x", 24, 2, "train"), 3, 1)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# core re-exports
# ---------------------------------------------------------------------------
def test_core_reexports_the_reference_names_the_port_has():
    """``repro_torch.core.__all__`` is the names of ``repro.core.__all__``
    that the port's core modules define — no more, no fewer — and each is
    the submodule's own object."""
    import importlib
    modules = [importlib.import_module(f"repro_torch.core.{m}") for m in (
        "compute_object", "registry", "manifest", "scheduler", "tuning",
        "agents", "c2mpi", "collective", "graph", "fusion", "portability")]
    has = {n for n in j_core.__all__ if any(hasattr(m, n) for m in modules)}
    assert set(t_core.__all__) == has
    assert len(t_core.__all__) == len(set(t_core.__all__))
    for name in t_core.__all__:
        owner = next(m for m in modules if hasattr(m, name))
        assert getattr(t_core, name) is getattr(owner, name), name
    assert {"performance_penalty", "fusion_rule", "TuningDB",
            "autotune"} <= set(t_core.__all__)


# ---------------------------------------------------------------------------
# the portability demo
# ---------------------------------------------------------------------------
def test_portability_demo_on_the_cpu_picks_as_the_jax_demo():
    """``run`` on the CPU: each policy picks the substrate the JAX demo
    prints for its policy (jnp → torch, xla → aten, pallas → hopper), every
    result within the float32 tolerance of the JAX MMM, the fancy agent
    serves the prio-99 claim and the fail-safe callback engages."""
    res = portability_demo.run("cpu", n=64, iters=1)
    a, b = to_numpy(res["a"]), to_numpy(res["b"])
    j_registry = j_core.KernelRegistry()
    j_register_all(j_registry)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    j_picks = [J_TO_T[j_registry.select("MMM", ja, jb, allowed_platforms=p).platform]
               for p in J_POLICIES]
    assert [p["picked"] for p in res["policies"]] == j_picks == ["torch", "aten", "hopper"]
    assert [p["served"] for p in res["policies"]] == \
        [{p["picked"]: p["calls"]} for p in res["policies"]]
    assert [p["allowed"] for p in res["policies"]] == \
        [[J_TO_T[s] for s in p] for p in J_POLICIES]
    want = np.asarray(jnp.dot(ja, jb, preferred_element_type=jnp.float32))
    for p in res["policies"]:
        np.testing.assert_allclose(to_numpy(p["out"]), want, **F32_TOL)
        assert p["t3_s"] > 0 and np.isfinite(p["penalty_pct"])
    aten = next(p for p in res["policies"] if p["picked"] == "aten")
    assert aten["phi"] == 1.0 and aten["penalty_pct"] == 0.0
    assert res["fancy"]["served"] == 1
    np.testing.assert_allclose(to_numpy(res["fancy"]["out"]), want, **F32_TOL)
    assert res["failsafe"]["engaged"]
    assert not to_numpy(res["failsafe"]["out"]).any()
