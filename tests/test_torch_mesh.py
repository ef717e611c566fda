"""The serving half of expert parallelism under a device mesh, on the CPU:
``repro_torch.launch.mesh``, the mesh half of ``distributed.sharding``,
``distributed.mesh_ops`` (``shard_map`` and its verbs), the MoE's two
``shard_map`` bodies with the int8 all_to_all, ``moe_layer`` under a mesh
and the ``sharded`` substrate — against the JAX package under the same
meshes.

One JAX subprocess forces four host devices
(``--xla_force_host_platform_device_count=4``, as tests/test_sharded.py
forces eight) and writes the reference's results to an ``.npz`` under
``tmp_path``; meanwhile one module-scoped run of four ``gloo`` ranks
(``run_ranks``) runs every port case.  Both read the same inputs, built
here from a seed with numpy.  Every wait is bounded: ``run_ranks`` kills
its ranks when one fails or its bound runs out, and the JAX subprocess is
killed past its own.

The cases: ``logical_spec`` for every ``ParamSpec`` of reduced moonshot
and danube under (2, 2) and (1, 4), with and without ``sp_rules``; the
tiled all_to_all alone against ``jax.lax.all_to_all`` at (0, 1) and (1,
0); ``moe_layer`` in both modes (a2a: 2×16 tokens; replicated: 6×1, so
that rows drop at capacity 1.25 on (1, 4)) under both meshes, float32 and
bfloat16, bf16 and int8 dispatch, 0 and 2 shared experts, against the
JAX ``moe_layer`` (f32 2e-4, bf16 4e-2), every rank's y ``torch.equal``,
two calls the same bits, int8 within 0.05 of the exact path; on (1, 4) in
decode each rank's expert outputs ``torch.equal`` to
``moe_expert_parallel``'s member on the same 16 of 64 experts; reduced
moonshot's prefill and 2 decode steps and its served tokens under (2, 2)
against no mesh; reduced danube's loss under a mesh and under
``sp_rules`` ``torch.equal`` to no mesh; ``ShardedAgent``,
``attach_mesh`` and ``MPIX_Initialize(mesh=)``; ``make_mesh``'s
refusals; the bodies' call counters in every rank."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import moe as t_moe

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ("moonshot-v1-16b-a3b", "h2o-danube-1.8b")
#: the parity contract (tests/test_kernels_property.py's conformance)
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
#: int8 dispatch against the exact path (tests/test_sharded.py:161)
INT8_REL = 0.05
D, E, TOP_K, D_FF = 32, 8, 2, 16
#: tokens (B, S): a2a splits 32 tokens over the 4 ranks (8 a rank, so the
#: skewed router overflows capacity 4); replicated is 6 decode rows
TOKENS = {"a2a": (2, 16), "rep": (6, 1)}
#: (dtype, capacity factor, shared experts, dispatch precision)
VARIANTS = {"a2a": [("float32", 8.0, 0, "bf16"), ("float32", 1.25, 2, "bf16"),
                    ("bfloat16", 1.25, 2, "bf16"), ("bfloat16", 8.0, 0, "int8"),
                    ("float32", 1.25, 2, "int8")],
            "rep": [("float32", 8.0, 0, "bf16"), ("float32", 1.25, 2, "bf16"),
                    ("bfloat16", 1.25, 2, "bf16")]}
CASES = [dict(id=f"{mesh}-{mode}-{dt}-c{cap}-s{sh}-{prec}", mesh=mesh, mode=mode,
              dtype=dt, cap=cap, shared=sh, prec=prec)
         for mesh in MESHES for mode in VARIANTS
         for dt, cap, sh, prec in VARIANTS[mode]]
#: the expert-slice cases: 64 experts top 6 on (1, 4), decode
SLICE = {"experts": 64, "top_k": 6, "tokens": (4, 1)}
#: (split_axis, concat_axis) → the global input's shape
A2A_SHAPES = {(0, 1): (16, 6, 3), (1, 0): (16, 8, 3)}
#: seconds: the four ranks' whole run, and the JAX subprocess
RANK_TIMEOUT = 120.0
JAX_TIMEOUT = 150.0


def _moe_cfg(case, experts=E, top_k=TOP_K):
    return dict(n_experts=experts, top_k=top_k, d_ff_expert=D_FF,
                n_shared=case["shared"], capacity_factor=case["cap"],
                a2a_precision=case["prec"])


def _bf16_values(a):
    """float32 values that bfloat16 holds exactly (numpy has no bfloat16)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _inputs():
    """Every case's weights and tokens, float32 arrays (bfloat16 cases
    rounded to bfloat16 values); the router favours expert 0 so that rows
    drop at capacity 1.25."""
    out = {}
    rng = np.random.default_rng(0)
    for case in CASES + _slice_cases():
        e = case.get("experts", E)
        specs = t_moe.moe_param_specs(D, MoEConfig(**_moe_cfg(case, e, case.get("top_k", TOP_K))),
                                      torch.float32)
        for name, s in specs.items():
            w = rng.standard_normal(s.shape).astype(np.float32) * s.shape[-2] ** -0.5
            if name == "router":
                w[:, 0] += 0.1
            elif case["dtype"] == "bfloat16":
                w = _bf16_values(w)
            out[f"{case['id']}/{name}"] = w
        x = rng.standard_normal((*case.get("x", TOKENS[case.get("mode", "rep")]), D)) + 1.0
        x = x.astype(np.float32)
        out[f"{case['id']}/x"] = _bf16_values(x) if case["dtype"] == "bfloat16" else x
    for (s, c), shape in A2A_SHAPES.items():
        out[f"a2a_in/{s}{c}"] = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    return out


def _slice_cases():
    return [dict(id=f"slice-{dt}", dtype=dt, cap=1.25, shared=2, prec="bf16",
                 experts=SLICE["experts"], top_k=SLICE["top_k"], x=SLICE["tokens"])
            for dt in ("float32", "bfloat16")]


def _no_drops(cfg):
    """``cfg`` with every MoE layer at capacity factor 8.0 ≥ n_experts /
    top_k (8 / 2): every expert's capacity holds every token a call sees,
    so no row drops in one process or on a rank's share of the tokens and
    the two agree to rounding (the capacity is sized per call from the
    tokens a call sees; tests/test_sharded.py's equalities take 8.0)."""
    return dataclasses.replace(cfg, stages=tuple(
        dataclasses.replace(st, pattern=tuple(
            dataclasses.replace(b, moe=dataclasses.replace(b.moe, capacity_factor=8.0))
            if b.moe is not None else b for b in st.pattern))
        for st in cfg.stages))


def _walk(tree, path=""):
    """(path, ParamSpec) leaves of a spec tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _entries(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


# ---------------------------------------------------------------------------
# the JAX package under a four-device host mesh
# ---------------------------------------------------------------------------
JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import MoEConfig
    from repro.distributed.sharding import logical_spec, mesh_context, sp_rules
    from repro.launch.mesh import make_mesh
    from repro.models.moe import _shard_map, moe_layer
    from repro.models.transformer import param_specs

    inp_path, cases_path, out_path, spec_path = sys.argv[1:5]
    inp = np.load(inp_path)
    job = json.load(open(cases_path))

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}")
        else:
            yield path, tree

    meshes = {k: make_mesh(tuple(v), ("data", "model")) for k, v in job["meshes"].items()}
    specs = {}
    for arch in job["archs"]:
        tree = param_specs(get_config(arch).reduced())
        for mk, mesh in meshes.items():
            for rk, rules in (("default", None), ("sp", sp_rules())):
                with mesh_context(mesh, rules):
                    specs[f"{arch}/{mk}/{rk}"] = {
                        p: [e if e is None or isinstance(e, str) else list(e)
                            for e in logical_spec(s.shape, s.logical)]
                        for p, s in walk(tree)}
    json.dump(specs, open(spec_path, "w"))
    out = {}
    for mk, mesh in meshes.items():
        for key in job["a2a"]:
            s, c = int(key[0]), int(key[1])
            f = _shard_map(lambda x, s=s, c=c: jax.lax.all_to_all(
                x, "model", split_axis=s, concat_axis=c, tiled=True),
                mesh, in_specs=(P("model"),), out_specs=P("model"))
            out[f"a2a/{mk}/{key}"] = np.asarray(jax.jit(f)(jnp.asarray(inp[f"a2a_in/{key}"])))
    for case in job["cases"]:
        cid, dt = case["id"], jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
        m = MoEConfig(**case["cfg"])
        p = {n: jnp.asarray(inp[f"{cid}/{n}"]) for n in job["names"][cid]}
        p = {n: (a if n == "router" else a.astype(dt)) for n, a in p.items()}
        x = jnp.asarray(inp[f"{cid}/x"]).astype(dt)
        with mesh_context(meshes[case["mesh"]]):
            y, aux = jax.jit(lambda p, x, m=m: moe_layer(p, x, m, "swiglu"))(p, x)
        out[f"moe/{cid}/y"] = np.asarray(y.astype(jnp.float32))
        out[f"moe/{cid}/aux"] = np.asarray(aux, np.float32)
    np.savez(out_path, **out)
""")


# ---------------------------------------------------------------------------
# the port: four gloo ranks
# ---------------------------------------------------------------------------
def _port_rank(inp_path: str):
    """Every port case in one rank; returns numpy results and flags."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.agents import RuntimeAgent, ShardedAgent
    from repro_torch.core.c2mpi import MPIX_Finalize, MPIX_Initialize
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.distributed import mesh_ops
    from repro_torch.distributed.sharding import (P, current_context, logical_spec,
                                                  mesh_context, sp_rules)
    from repro_torch.models import build_model
    from repro_torch.models.transformer import param_specs
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import pad_caches

    torch.set_num_threads(1)
    inp = np.load(inp_path)
    rank = dist.get_rank()
    out = {"rank": rank}
    MPIX_Initialize(device="cpu")
    meshes = {k: t_mesh.make_mesh(v, AXES, device_type="cpu") for k, v in MESHES.items()}

    # logical specs
    specs = {}
    for arch in ARCHS:
        tree = param_specs(get_config(arch).reduced())
        for mk, mesh in meshes.items():
            for rk, rules in (("default", None), ("sp", sp_rules())):
                with mesh_context(mesh, rules):
                    specs[f"{arch}/{mk}/{rk}"] = {
                        p: _entries(logical_spec(s.shape, s.logical)) for p, s in _walk(tree)}
    out["specs"] = specs

    # the tiled all_to_all alone
    for mk, mesh in meshes.items():
        for (s, c) in A2A_SHAPES:
            f = mesh_ops.shard_map(
                lambda x, s=s, c=c, mesh=mesh: (mesh_ops.all_to_all(x, mesh, "model", s, c),),
                mesh, (P("model"),), (P("model"),))
            out[f"a2a/{mk}/{s}{c}"] = f(torch.from_numpy(inp[f"a2a_in/{s}{c}"]))[0].numpy()

    def weights(case):
        dt = getattr(torch, case["dtype"])
        names = [k.split("/", 1)[1] for k in inp.files if k.startswith(case["id"] + "/")]
        p = {n: torch.from_numpy(inp[f"{case['id']}/{n}"]) for n in names if n != "x"}
        p = {n: (w if n == "router" else w.to(dt)) for n, w in p.items()}
        return p, torch.from_numpy(inp[f"{case['id']}/x"]).to(dt)

    # moe_layer under each mesh, twice, and the int8 cases' exact twins
    calls0 = dict(t_moe.BODY_CALLS)
    for case in CASES:
        p, x = weights(case)
        m = MoEConfig(**_moe_cfg(case))
        with mesh_context(meshes[case["mesh"]]):
            y, aux = t_moe.moe_layer(p, x, m, "swiglu")
            y2, aux2 = t_moe.moe_layer(p, x, m, "swiglu")
            if case["prec"] == "int8":
                exact = MoEConfig(**{**_moe_cfg(case), "a2a_precision": "bf16"})
                out[f"moe/{case['id']}/exact"] = \
                    t_moe.moe_layer(p, x, exact, "swiglu")[0].float().numpy()
        out[f"moe/{case['id']}/y"] = y.float().numpy()
        out[f"moe/{case['id']}/aux"] = aux.numpy()
        out[f"moe/{case['id']}/repeat"] = bool(torch.equal(y, y2) and torch.equal(aux, aux2))
        out[f"moe/{case['id']}/dtype"] = str(y.dtype)
    out["calls_moe"] = {k: v - calls0.get(k, 0) for k, v in t_moe.BODY_CALLS.items()}

    # (1, 4) decode: each rank's expert outputs against moe_expert_parallel's member
    session = MPIX_Initialize(device="cpu")
    for case in _slice_cases():
        p, x = weights(case)
        m = MoEConfig(**_moe_cfg(case, SLICE["experts"], SLICE["top_k"]))
        taps = []
        ffn = t_moe._expert_ffn

        def tap(*a, **k):
            taps.append(ffn(*a, **k))
            return taps[-1]
        t_moe._expert_ffn = tap
        try:
            with mesh_context(meshes["1x4"]):
                t_moe.moe_layer(p, x, m, "swiglu")
        finally:
            t_moe._expert_ffn = ffn
        comm = session.comm_split(["aten"] * 4)
        parts = []
        gather = comm.gather

        def spy(items, *a, **k):
            parts.extend(items)
            return gather(items, *a, **k)
        comm.gather = spy
        t_moe.moe_expert_parallel(p, x, m, "swiglu", comm)
        del comm.gather
        comm.free()
        out[f"slice/{case['dtype']}"] = (len(taps) == 1 and len(parts) == 4
                                         and tuple(taps[0].shape) == tuple(parts[rank].shape)
                                         and bool(torch.equal(taps[0], parts[rank])))

    # reduced moonshot: prefill + 2 decode steps, and served tokens, under (2, 2)
    cfg = _no_drops(get_config("moonshot-v1-16b-a3b").reduced())
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)))

    def steps(mesh, toks=None):
        got, toks = [], list(toks or [])
        with mesh_context(mesh):
            logits, caches = model.prefill(params, {"tokens": prompt})
            caches = pad_caches(cfg, caches, 32)
            got.append(logits.float())
            for i in range(2):
                if len(toks) <= i:
                    toks.append(logits.argmax(-1, keepdim=True))
                logits, caches = model.decode_step(params, caches, toks[i], 16 + i)
                got.append(logits.float())
        return got, toks

    calls0 = dict(t_moe.BODY_CALLS)
    plain, toks = steps(None)
    meshed, _ = steps(meshes["2x2"], toks)
    out["model_steps"] = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(meshed, plain)]
    out["calls_model"] = {k: v - calls0.get(k, 0) for k, v in t_moe.BODY_CALLS.items()}
    engine = ServeEngine(model, max_len=32)
    served_plain = engine.generate(params, prompt, 3)
    calls0 = dict(t_moe.BODY_CALLS)
    with mesh_context(meshes["2x2"]):
        served = ServeEngine(model, max_len=32).generate(params, prompt, 3)
    out["calls_serve"] = {k: v - calls0.get(k, 0) for k, v in t_moe.BODY_CALLS.items()}
    out["served"] = served.numpy()
    out["served_plain"] = served_plain.numpy()

    # reduced danube's loss: no mesh, a mesh, a mesh with sp_rules
    dcfg = get_config("h2o-danube-1.8b").reduced()
    dmodel = build_model(dcfg)
    dparams = dmodel.init(torch.Generator().manual_seed(1))
    g = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(g.integers(0, dcfg.vocab_size, (4, 32))),
             "labels": torch.from_numpy(g.integers(0, dcfg.vocab_size, (4, 32)))}
    base = dmodel.loss_fn(dparams, batch)[0]
    with mesh_context(meshes["2x2"]):
        sharded = dmodel.loss_fn(dparams, batch)[0]
    with mesh_context(meshes["2x2"], sp_rules()):
        sp = dmodel.loss_fn(dparams, batch)[0]
    out["danube"] = (bool(torch.equal(base, sharded)), bool(torch.equal(base, sp)),
                     float(base))

    # the sharded substrate
    reg = KernelRegistry()
    reg.register_fn("MESH_PROBE", "sharded")(
        lambda x: x + current_context().axis_size(("model",)))
    pin = {"allowed_platforms": ["sharded"], "platform_preference": ["sharded"]}

    def probe(sess):
        cr = sess.claim("MESH_PROBE", overrides=pin)
        sess.send((torch.zeros(1),), cr)
        return float(sess.recv(cr)[0])

    agents = {}
    plain_sess = RuntimeAgent(registry=reg, device="cpu")
    agents["no_mesh_absent"] = "sharded" not in plain_sess.agents
    agents["unattached_unavailable"] = not ShardedAgent().available()
    plain_sess.attach_mesh(meshes["2x2"])
    agents["attached"] = plain_sess.agents["sharded"].available()
    agents["probe_2x2"] = probe(plain_sess)
    plain_sess.attach_mesh(meshes["1x4"])
    agents["probe_1x4"] = probe(plain_sess)
    agents["default_group_skips"] = "sharded" not in plain_sess.comm_split().platforms
    plain_sess.finalize()
    sess = MPIX_Initialize(registry=reg, device="cpu", mesh=meshes["2x2"])
    agents["initialize_mesh"] = sess.agents["sharded"].mesh is meshes["2x2"]
    agents["probe_init"] = probe(sess)
    MPIX_Finalize()
    out["agents"] = agents

    # make_mesh's refusals
    refused = {}
    for name, fn in (("too_small", lambda: t_mesh.make_mesh((2, 4), AXES, "cpu")),
                     ("production", lambda: t_mesh.make_production_mesh()),
                     ("multi_pod", lambda: t_mesh.make_production_mesh(multi_pod=True)),
                     ("group_zero", lambda: t_mesh.make_group_mesh(0))):
        try:
            fn()
            refused[name] = False
        except ValueError:
            refused[name] = True
    refused["group_4"] = t_mesh.make_group_mesh(4).shape == (4,)
    out["refused"] = refused
    out["calls"] = dict(t_moe.BODY_CALLS)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX results, the JAX specs, the four ranks' results)."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    job = {"meshes": {k: list(v) for k, v in MESHES.items()}, "archs": list(ARCHS),
           "a2a": [f"{s}{c}" for s, c in A2A_SHAPES],
           "cases": [dict(c, cfg=_moe_cfg(c)) for c in CASES],
           "names": {c["id"]: [k.split("/", 1)[1] for k in inputs
                               if k.startswith(c["id"] + "/") and not k.endswith("/x")]
                     for c in CASES}}
    (tmp / "job.json").write_text(json.dumps(job))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "job.json"),
         str(tmp / "ref.npz"), str(tmp / "specs.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = t_mesh.run_ranks(_port_rank, 4, backend="gloo", timeout=RANK_TIMEOUT,
                                 args=(str(tmp / "inputs.npz"),), device_type="cpu")
        stdout, stderr = ref.communicate(timeout=JAX_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait(timeout=10)
    assert ref.returncode == 0, stderr[-3000:]
    return (dict(np.load(tmp / "ref.npz")), json.loads((tmp / "specs.json").read_text()),
            ranks)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_logical_specs_match_jax(runs, arch, mesh):
    """Every ParamSpec's logical_spec, with the default rules and with
    sp_rules, equal to the reference's under the same mesh (rank 0)."""
    _, specs, ranks = runs
    for rules in ("default", "sp"):
        key = f"{arch}/{mesh}/{rules}"
        assert ranks[0]["specs"][key] == specs[key], key
        assert all(r["specs"][key] == specs[key] for r in ranks)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("split_concat", ["01", "10"])
def test_tiled_all_to_all_matches_jax(runs, mesh, split_concat):
    """mesh_ops.all_to_all in a shard_map over the model axis: JAX's tiled
    split/concat layout, element for element, on every rank."""
    ref, _, ranks = runs
    want = ref[f"a2a/{mesh}/{split_concat}"]
    for r in ranks:
        got = r[f"a2a/{mesh}/{split_concat}"]
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_moe_layer_under_a_mesh_matches_jax(runs, case):
    """y and aux against the JAX moe_layer under the same mesh; every rank's
    y the same bits; two calls the same bits; y in x's type."""
    ref, _, ranks = runs
    cid, tol = case["id"], TOL[case["dtype"]]
    y0 = ranks[0][f"moe/{cid}/y"]
    np.testing.assert_allclose(y0, ref[f"moe/{cid}/y"], rtol=tol, atol=tol)
    np.testing.assert_allclose(ranks[0][f"moe/{cid}/aux"], ref[f"moe/{cid}/aux"],
                               rtol=tol, atol=tol)
    for r in ranks:
        assert np.array_equal(r[f"moe/{cid}/y"], y0)
        assert np.array_equal(r[f"moe/{cid}/aux"], ranks[0][f"moe/{cid}/aux"])
        assert r[f"moe/{cid}/repeat"]
        assert r[f"moe/{cid}/dtype"] == f"torch.{case['dtype']}"
    if case["prec"] == "int8":
        exact = ranks[0][f"moe/{cid}/exact"]
        rel = np.abs(y0 - exact).max() / np.abs(exact).max()
        assert 0 < rel < INT8_REL, rel


def test_capacity_drops_rows_in_the_skewed_cases():
    """The 1.25 cases drop rows where the module docstring says they do:
    a2a on every rank's 8 tokens, replicated on (1, 4) (6 tokens,
    capacity 4)."""
    inputs = _inputs()
    for case in CASES:
        if case["cap"] != 1.25 or (case["mode"] == "rep" and case["mesh"] == "2x2"):
            continue
        m = MoEConfig(**_moe_cfg(case))
        x2 = torch.from_numpy(inputs[f"{case['id']}/x"]).reshape(-1, D).to(
            getattr(torch, case["dtype"]))
        blocks = x2.chunk(4) if case["mode"] == "a2a" else [x2]
        for xb in blocks:
            _, eidx, _ = t_moe._route(xb, torch.from_numpy(inputs[f"{case['id']}/router"]), m)
            c = t_moe._capacity(xb.shape[0], m)
            _, keep = t_moe._dispatch_indices(eidx, xb.shape[0], c, E)
            assert not bool(keep.all()), case["id"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ranks_hold_moe_expert_parallels_members(runs, dtype):
    """On (1, 4) in decode (64 experts, top 6, C = 4) each rank's expert
    outputs are torch.equal to moe_expert_parallel's member over the same
    16 experts (float32 through the per-expert products: ROADMAP C3)."""
    _, _, ranks = runs
    assert all(r[f"slice/{dtype}"] for r in ranks)


def test_moonshot_prefill_and_decode_under_a_mesh(runs):
    """Reduced moonshot (capacity factor 8.0: ``_no_drops``) under (2, 2):
    the prefill's and 2 decode steps' logits within float32's tolerance of
    no mesh, fed the same tokens;
    the prefill took the a2a body and the decode steps the replicated one
    in every rank."""
    _, _, ranks = runs
    for r in ranks:
        assert len(r["model_steps"]) == 3 and max(r["model_steps"]) <= TOL["float32"]
        # 2 MoE layers: the prefill (32 tokens) in a2a, each decode (2) replicated
        assert r["calls_model"] == {"a2a": 2, "replicated": 4}


def test_moonshot_served_under_a_mesh(runs):
    """ServeEngine.generate under (2, 2) in every rank: the same tokens on
    every rank and as without a mesh; the bodies ran (a row's prefill in
    a2a, the 2-lane decode steps replicated)."""
    _, _, ranks = runs
    for r in ranks:
        assert np.array_equal(r["served"], ranks[0]["served"])
        assert np.array_equal(r["served"], r["served_plain"])
        assert r["served"].shape == (2, 3)
        assert r["calls_serve"].get("a2a", 0) >= 4 and r["calls_serve"].get("replicated", 0) >= 2


def test_danube_loss_is_unchanged_by_a_mesh(runs):
    """The global view: danube's loss under (2, 2), with and without
    sp_rules, torch.equal to no mesh (tests/test_sharded.py's two loss
    checks)."""
    _, _, ranks = runs
    for r in ranks:
        assert r["danube"][:2] == (True, True) and np.isfinite(r["danube"][2])


def test_sharded_agent_and_attach_mesh(runs):
    """No sharded agent without a mesh; unattached it is unavailable; a
    record on it runs under the mesh context (the probe reads the model
    axis's size); a second attach replaces the mesh; MPIX_Initialize(mesh=)
    attaches it; a default device group never takes it."""
    _, _, ranks = runs
    for r in ranks:
        a = r["agents"]
        assert a == {"no_mesh_absent": True, "unattached_unavailable": True,
                     "attached": True, "probe_2x2": 2.0, "probe_1x4": 4.0,
                     "default_group_skips": True, "initialize_mesh": True,
                     "probe_init": 2.0}


def test_make_mesh_refusals(runs):
    """A mesh the world cannot hold raises ValueError, the production
    meshes (256 and 512 ranks) included; a 4-member group mesh is made."""
    _, _, ranks = runs
    for r in ranks:
        assert all(r["refused"].values()), r["refused"]
    with pytest.raises(ValueError, match="none is initialised"):
        t_mesh.make_mesh((2, 2), AXES, device_type="cpu")


def test_run_ranks_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="gloo or nccl"):
        t_mesh.run_ranks(_port_rank, 4, backend="mpi", timeout=1.0)


def test_body_counters_rose_in_every_rank(runs):
    """Every rank ran both bodies: a lost mesh context (the one-device
    path) would leave them at 0."""
    _, _, ranks = runs
    a2a = sum(1 for c in CASES if c["mode"] == "a2a")
    rep = sum(1 for c in CASES if c["mode"] == "rep")
    int8 = sum(1 for c in CASES if c["prec"] == "int8")
    for r in ranks:
        assert r["calls_moe"] == {"a2a": 2 * a2a + int8, "replicated": 2 * rep}
        assert r["calls"]["a2a"] > 0 and r["calls"]["replicated"] > 0
