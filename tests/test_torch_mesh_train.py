"""The training half of expert parallelism under a device mesh, on the CPU:
the backward through ``distributed.mesh_ops``' verbs and ``shard_map``,
through the MoE's two ``shard_map`` bodies (the int8 dispatch
straight-through), ``Model.loss_fn``'s recompute under the forward's mesh
from any thread, ``make_train_step`` and the Trainer under a mesh with
their checkpoints, and ``launch/train.py --mesh debug`` — against the JAX
package under the same meshes.

As in tests/test_torch_mesh.py, one JAX subprocess forces four host
devices and writes the reference's results to an ``.npz`` under
``tmp_path``, while one module-scoped run of four ``gloo`` ranks
(``run_ranks``) runs every port case and, beside them, the port's launcher
starts its own four ranks.  Both packages read the same inputs, built
here from a seed with numpy (the reduced moonshot's weights are the
port's ``init`` at seed 0, carried across; both launchers start from a
checkpoint of step 0 holding them).  The reference runs in three JAX
subprocesses at once (the cases, the sharded step, the launcher).  Every
wait is bounded.

The cases: each verb's VJP and ``shard_map``'s with inputs P(),
P("data") and P(("data", "model")) against ``jax.vjp`` (the transpose
the reference's ``shard_map`` takes with ``check_vma=False``);
``moe_layer``'s gradients for every parameter and x on (2, 2) and (1, 4),
a2a and replicated, float32 and bfloat16, against ``jax.grad``; the
reference's int8 dispatch cutting its gradient, and the port's within
0.05 of its exact dispatch; tests/test_sharded.py's sharded train step
leaf for leaf; a backward run off the forward's thread; danube's step
under (2, 2) ``torch.equal`` to no mesh; a Trainer with checkpoints on
(2, 2) restored on (1, 4) and on no mesh and resumed; the launcher's
``--mesh debug`` history against the reference launcher's.  Tolerances:
the parity contract, float32 2e-4, bfloat16 4e-2."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import train as t_launch
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import TrainState

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: the parity contract (tests/test_kernels_property.py's conformance)
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
#: int8 dispatch against the exact path (tests/test_sharded.py:161)
INT8_REL = 0.05
MOONSHOT = "moonshot-v1-16b-a3b"
#: the MoE gradient cases: tests/test_sharded.py's layer (8 experts top 2,
#: d 32, d_ff 16, capacity factor 8.0); a2a 2 × 8 tokens (4 a rank),
#: replicated 2 × 1
D, E, TOP_K, D_FF, CAP = 32, 8, 2, 16, 8.0
TOKENS = {"a2a": (2, 8), "rep": (2, 1)}
GRAD_CASES = [dict(id=f"{mesh}-{mode}-{dt}", mesh=mesh, mode=mode, dtype=dt, prec="bf16")
              for mesh in MESHES for mode in TOKENS for dt in ("float32", "bfloat16")]
#: the int8 dispatch on (2, 2), x (2, 8, 32), beside its exact twin
INT8_CASE = dict(id="2x2-a2a-float32-int8", mesh="2x2", mode="a2a", dtype="float32",
                 prec="int8")
MOE_CASES = GRAD_CASES + [INT8_CASE]
#: the verbs on (2, 2) over an (8, 8) float32 input split along dim 0 by
#: its spec; each body squares its block first, then: nothing
#: ("shard_map"), all_to_all over "model" (split 0, concat 1), psum over
#: "model", pmean over both axes, or a tiled all_gather over "model" along
#: dim 0.  The output's spec splits dim 0 over the axes along which the
#: body's output differs
SPECS = {"P()": [], "P(data)": ["data"], "P(data,model)": ["data", "model"]}
VERBS = ("shard_map", "all_to_all", "psum", "pmean", "all_gather")
VERB_CASES = [dict(id=f"{verb}-{spec}", verb=verb, spec=spec) for verb in VERBS
              for spec in SPECS]
#: the sharded train step (tests/test_sharded.py:118): reduced moonshot,
#: (2, 2), TrainHyper() defaults
STEP_BATCH = (4, 16)
#: the launcher on both sides: --mesh debug
LAUNCH = ["--arch", MOONSHOT, "--reduced", "--steps", "3", "--seq-len", "16",
          "--batch", "4", "--lr", "3e-3"]
#: seconds: the four ranks' whole run, the JAX subprocess, the launcher
RANK_TIMEOUT = 150.0
JAX_TIMEOUT = 150.0
LAUNCH_TIMEOUT = 150.0


def _out_axes(case):
    """dim 0's axes in the output's spec."""
    axes = SPECS[case["spec"]]
    if case["verb"] == "all_to_all":
        return [a for a in AXES if a in axes or a == "model"]
    if case["verb"] in ("psum", "all_gather"):
        return [a for a in axes if a != "model"]
    if case["verb"] == "pmean":
        return []
    return axes


def _cotangent(shape):
    """A cotangent both packages make from the output's shape alone."""
    n = int(np.prod(shape))
    return (np.sin(np.arange(n) * 0.37 + 0.1)).reshape(shape).astype(np.float32)


def _moe_cfg(case):
    return dict(n_experts=E, top_k=TOP_K, d_ff_expert=D_FF, capacity_factor=CAP,
                a2a_precision=case["prec"])


def _bf16_values(a):
    """float32 values that bfloat16 holds exactly (numpy has no bfloat16)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _inputs():
    """Every case's inputs as float32 arrays (bfloat16 cases rounded to
    bfloat16 values), the reduced moonshot's weights (the port's init at
    seed 0) in jax.tree order, and the sharded step's batch."""
    out = {}
    rng = np.random.default_rng(38)
    out["verb_x"] = rng.standard_normal((8, 8)).astype(np.float32)
    for case in MOE_CASES:
        p = {"router": rng.standard_normal((D, E)),
             "we_g": rng.standard_normal((E, D, D_FF)) * 0.2,
             "we_u": rng.standard_normal((E, D, D_FF)) * 0.2,
             "we_d": rng.standard_normal((E, D_FF, D)) * 0.2,
             "x": rng.standard_normal((*TOKENS[case["mode"]], D))}
        for name, w in p.items():
            w = w.astype(np.float32)
            if case["dtype"] == "bfloat16" and name != "router":
                w = _bf16_values(w)
            out[f"{case['id']}/{name}"] = w
    model = build_model(get_config(MOONSHOT).reduced())
    for i, leaf in enumerate(tree_leaves(model.init(torch.Generator().manual_seed(0)))):
        out[f"params/{i:05d}"] = leaf.float().numpy()
    vocab = model.cfg.vocab_size
    out["step/tokens"] = rng.integers(0, vocab, STEP_BATCH).astype(np.int32)
    out["step/labels"] = rng.integers(0, vocab, STEP_BATCH).astype(np.int32)
    return out


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
    from repro.distributed.sharding import mesh_context
    from repro.launch import train as launch_train
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.models.moe import _shard_map, moe_layer
    from repro.optim.adamw import adamw_init
    from repro.train.trainer import TrainHyper, TrainState, make_train_step

    inp_path, job_path, out_path, part = sys.argv[1:5]
    inp = np.load(inp_path)
    job = json.load(open(job_path))
    meshes = {k: make_mesh(tuple(v), ("data", "model")) for k, v in job["meshes"].items()}
    out = {}

    def spec(axes):
        return P(tuple(axes) if len(axes) > 1 else axes[0]) if axes else P()

    def cotangent(shape):
        n = int(np.prod(shape))
        return np.sin(np.arange(n) * 0.37 + 0.1).reshape(shape).astype(np.float32)

    for case in job["verbs"] if part == "cases" else ():
        def body(xb, verb=case["verb"]):
            y = xb * xb
            if verb == "all_to_all":
                y = jax.lax.all_to_all(y, "model", 0, 1, tiled=True)
            elif verb == "psum":
                y = jax.lax.psum(y, "model")
            elif verb == "pmean":
                y = jax.lax.pmean(y, ("data", "model"))
            elif verb == "all_gather":
                y = jax.lax.all_gather(y, "model", axis=0, tiled=True)
            return y
        f = jax.jit(_shard_map(body, meshes["2x2"], in_specs=(spec(case["in"]),),
                               out_specs=spec(case["out"])))
        y, vjp = jax.vjp(f, jnp.asarray(inp["verb_x"]))
        (gx,) = vjp(jnp.asarray(cotangent(y.shape)))
        out[f"verb/{case['id']}/y"] = np.asarray(y)
        out[f"verb/{case['id']}/gx"] = np.asarray(gx)

    for case in job["moe"] if part == "cases" else ():
        cid = case["id"]
        dt = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
        m = MoEConfig(**case["cfg"])
        p = {n: jnp.asarray(inp[f"{cid}/{n}"]) for n in ("router", "we_g", "we_u", "we_d")}
        p = {n: (a if n == "router" else a.astype(dt)) for n, a in p.items()}
        x = jnp.asarray(inp[f"{cid}/x"]).astype(dt)

        def loss(p, x, m=m):
            y, aux = moe_layer(p, x, m, "swiglu")
            return jnp.sum(y.astype(jnp.float32) ** 2) + 10.0 * aux
        with mesh_context(meshes[case["mesh"]]):
            val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(p, x)
        out[f"moe/{cid}/loss"] = np.asarray(val, np.float32)
        out[f"moe/{cid}/x"] = np.asarray(gx.astype(jnp.float32))
        for n, g in gp.items():
            out[f"moe/{cid}/{n}"] = np.asarray(g.astype(jnp.float32))
        if case["prec"] == "int8":
            exact = MoEConfig(**{**case["cfg"], "a2a_precision": "bf16"})
            with mesh_context(meshes[case["mesh"]]):
                _, (_, gx) = jax.jit(jax.value_and_grad(
                    lambda p, x: loss(p, x, exact), argnums=(0, 1)))(p, x)
            out[f"moe/{cid}/exact_x"] = np.asarray(gx)

    if part == "step":                      # tests/test_sharded.py:118's step
        model = build_model(get_config(job["arch"]).reduced())
        like = jax.tree.leaves(model.init(jax.random.PRNGKey(0)))
        params = jax.tree.unflatten(
            jax.tree.structure(model.init(jax.random.PRNGKey(0))),
            [jnp.asarray(inp[f"params/{i:05d}"], l.dtype) for i, l in enumerate(like)])
        state = TrainState(params=params, opt=adamw_init(params))
        batch = {"tokens": jnp.asarray(inp["step/tokens"]),
                 "labels": jnp.asarray(inp["step/labels"])}
        with mesh_context(meshes["2x2"]):
            state, metrics = jax.jit(make_train_step(model, TrainHyper()))(state, batch)
        for k, v in metrics.items():
            out[f"step/metric/{k}"] = np.asarray(v, np.float32)
        leaves = jax.tree.leaves((state.params, state.opt.mu, state.opt.nu))
        for i, leaf in enumerate(leaves):
            out[f"step/state/{i:05d}"] = np.asarray(leaf, np.float32)
    if part == "launch":
        hist = launch_train.main(job["launch"] + ["--mesh", "debug",
                                                  "--ckpt-dir", job["jax_ckpt"]])
        out["launch/history"] = np.asarray(hist, np.float64)
    np.savez(out_path, **out)
""")


# ---------------------------------------------------------------------------
# the port: four gloo ranks
# ---------------------------------------------------------------------------
def _moonshot(inp):
    """Reduced moonshot with the weights of ``inp``."""
    model = build_model(get_config(MOONSHOT).reduced())
    leaves, spec = tree_flatten(model.init(torch.Generator().manual_seed(0)))
    ref = [inp[f"params/{i:05d}"] for i in range(len(leaves))]
    assert [tuple(r.shape) for r in ref] == [tuple(t.shape) for t in leaves]
    return model, tree_unflatten(spec, [torch.from_numpy(r).to(t.dtype)
                                        for r, t in zip(ref, leaves)])


def _grads(fn, tensors):
    """(value, grads) of the scalar ``fn(*leaves)``."""
    leaves = [t.detach().clone().requires_grad_() for t in tensors]
    val = fn(*leaves)
    return val.detach(), torch.autograd.grad(val, leaves)


def _verb_cases(mesh, x_np):
    from repro_torch.distributed import mesh_ops
    from repro_torch.distributed.sharding import P

    def spec(axes):
        return P(tuple(axes) if len(axes) > 1 else axes[0]) if axes else P()
    out = {}
    for case in VERB_CASES:
        def body(xb, verb=case["verb"]):
            y = xb * xb
            if verb == "all_to_all":
                y = mesh_ops.all_to_all(y, mesh, "model", 0, 1)
            elif verb == "psum":
                y = mesh_ops.psum(y, mesh, ("model",))
            elif verb == "pmean":
                y = mesh_ops.pmean(y, mesh, AXES)
            elif verb == "all_gather":
                y = mesh_ops.all_gather(y, mesh, ("model",), 0)
            return (y,)
        f = mesh_ops.shard_map(body, mesh, (spec(SPECS[case["spec"]]),),
                               (spec(_out_axes(case)),))
        x = torch.from_numpy(x_np).requires_grad_()
        y = f(x)[0]
        y.backward(torch.from_numpy(_cotangent(tuple(y.shape))))
        out[f"verb/{case['id']}/y"] = y.detach().numpy()
        out[f"verb/{case['id']}/gx"] = x.grad.numpy()
    return out


def _moe_loss(m, mesh):
    from repro_torch.distributed.sharding import mesh_context

    def loss(router, we_g, we_u, we_d, x):
        p = {"router": router, "we_g": we_g, "we_u": we_u, "we_d": we_d}
        with mesh_context(mesh):
            y, aux = t_moe.moe_layer(p, x, m, "swiglu")
        return (y.float() ** 2).sum() + 10.0 * aux
    return loss


def _moe_cases(inp, meshes):
    out = {}
    names = ("router", "we_g", "we_u", "we_d", "x")
    for case in MOE_CASES:
        dt = getattr(torch, case["dtype"])
        ts = [torch.from_numpy(inp[f"{case['id']}/{n}"]) for n in names]
        ts = [t if n == "router" else t.to(dt) for n, t in zip(names, ts)]
        m = MoEConfig(**_moe_cfg(case))
        calls0 = dict(t_moe.BODY_CALLS)
        val, gs = _grads(_moe_loss(m, meshes[case["mesh"]]), ts)
        val2, gs2 = _grads(_moe_loss(m, meshes[case["mesh"]]), ts)
        out[f"moe/{case['id']}/calls"] = {k: v - calls0.get(k, 0)
                                          for k, v in t_moe.BODY_CALLS.items()
                                          if v - calls0.get(k, 0)}
        out[f"moe/{case['id']}/loss"] = val.numpy()
        out[f"moe/{case['id']}/repeat"] = bool(torch.equal(val, val2) and all(
            torch.equal(a, b) for a, b in zip(gs, gs2)))
        for n, g in zip(names, gs):
            out[f"moe/{case['id']}/{n}"] = g.float().numpy()
            out[f"moe/{case['id']}/{n}/dtype"] = str(g.dtype)
        if case["prec"] == "int8":
            exact = MoEConfig(**{**_moe_cfg(case), "a2a_precision": "bf16"})
            _, ge = _grads(_moe_loss(exact, meshes[case["mesh"]]), ts)
            for n, g in zip(names, ge):
                out[f"moe/{case['id']}/exact/{n}"] = g.float().numpy()
    return out


def _step_case(inp, mesh):
    """tests/test_sharded.py:118's step in the port: metrics and the new
    params, mu and nu in jax.tree order."""
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.train.trainer import TrainHyper, make_train_step
    model, params = _moonshot(inp)
    state = TrainState(params=params, opt=adamw_init(params))
    batch = {"tokens": torch.from_numpy(inp["step/tokens"]).long(),
             "labels": torch.from_numpy(inp["step/labels"]).long()}
    with mesh_context(mesh):
        new, metrics = make_train_step(model, TrainHyper())(state, batch)
    out = {f"step/metric/{k}": float(v) for k, v in metrics.items()}
    leaves = tree_leaves(new.params) + tree_leaves(new.opt.mu) + tree_leaves(new.opt.nu)
    out["step/state"] = [t.float().numpy() for t in leaves]
    out["step/digest"] = [t.numpy().tobytes() for t in leaves]
    return out


def _thread_case(inp, mesh):
    """loss_fn under (2, 2) in this thread; its backward once here and once
    from a thread with no mesh context."""
    from repro_torch.distributed.sharding import mesh_context
    model, params = _moonshot(inp)
    batch = {"tokens": torch.from_numpy(inp["step/tokens"]).long(),
             "labels": torch.from_numpy(inp["step/labels"]).long()}
    flat, spec = tree_flatten(params)

    def forward():
        leaves = [t.detach().clone().requires_grad_() for t in flat]
        with mesh_context(mesh):
            loss, _ = model.loss_fn(tree_unflatten(spec, leaves), batch)
        return loss, leaves

    loss, leaves = forward()
    here = torch.autograd.grad(loss, leaves)
    loss, leaves = forward()
    calls0 = dict(t_moe.BODY_CALLS)
    got = {}
    worker = threading.Thread(
        target=lambda: got.update(g=torch.autograd.grad(loss, leaves)), daemon=True)
    worker.start()
    worker.join(timeout=60)
    calls = {k: v - calls0.get(k, 0) for k, v in t_moe.BODY_CALLS.items()
             if v - calls0.get(k, 0)}
    return {"thread/alive": worker.is_alive(), "thread/calls": calls,
            "thread/equal": "g" in got and all(torch.equal(a, b)
                                               for a, b in zip(here, got["g"]))}


def _danube_case(mesh):
    """Reduced danube's train step under (2, 2) against no mesh."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.train.trainer import TrainHyper, make_train_step
    model = build_model(get_config("h2o-danube-1.8b").reduced())
    params = model.init(torch.Generator().manual_seed(1))
    batch = SyntheticLM(model.cfg, seq_len=16, global_batch=4).device_batch(0, "cpu")
    step = make_train_step(model, TrainHyper(base_lr=1e-2, warmup_steps=1, total_steps=4))
    state = TrainState(params=params, opt=adamw_init(params))
    plain, pm = step(state, batch)
    with mesh_context(mesh):
        meshed, mm = step(state, batch)
    return {"danube/equal": all(torch.equal(a, b) for a, b in
                                zip(tree_leaves((plain, pm)), tree_leaves((meshed, mm))))}


def _trainer_case(inp, meshes, ckpt_dir: str, hb_path: str):
    """A Trainer with checkpoints and a heartbeat on (2, 2); the checkpoint
    restored on (1, 4) and on no mesh; a resume against an unbroken run."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.train.fault_tolerance import HeartbeatJournal
    from repro_torch.train.trainer import Trainer, TrainHyper
    model, params = _moonshot(inp)
    pipe = SyntheticLM(model.cfg, seq_len=16, global_batch=4)
    hp = TrainHyper(base_lr=1e-2, warmup_steps=2, total_steps=5)

    flat, spec = tree_flatten(params)

    def fresh():
        p = tree_unflatten(spec, [t.clone() for t in flat])
        return TrainState(params=p, opt=adamw_init(p))

    ckpt = CheckpointManager(ckpt_dir)
    writes = []
    write = ckpt._write
    ckpt._write = lambda step, leaves: (writes.append(step), write(step, leaves))
    hb = HeartbeatJournal(hb_path)
    with mesh_context(meshes["2x2"]):
        whole, hist = Trainer(model=model, hp=hp, log_every=1).run(
            fresh(), pipe.device_batch, steps=5)
        tr = Trainer(model=model, hp=hp, ckpt=ckpt, heartbeat=hb, log_every=1,
                     ckpt_every=2)
        saved, first = tr.run(fresh(), pipe.device_batch, steps=3)
    saved = [t.clone() for t in tree_leaves(saved)]
    out = {"trainer/writes": writes, "trainer/first": first, "trainer/whole": hist,
           "trainer/tmp": sorted(p.name for p in Path(ckpt_dir).iterdir()
                                 if p.name.startswith(".tmp"))}
    with mesh_context(meshes["1x4"]):
        tr = Trainer(model=model, hp=hp, ckpt=CheckpointManager(ckpt_dir), log_every=1)
        state, step = tr.restore_or_init(torch.Generator().manual_seed(99))
        out["trainer/restored_1x4"] = (step, all(torch.equal(a, b) for a, b in
                                                 zip(tree_leaves(state), saved)))
    dist.barrier()
    plain, step = CheckpointManager(ckpt_dir).restore_latest(like=fresh())
    out["trainer/restored_none"] = (step, all(torch.equal(a, b) for a, b in
                                              zip(tree_leaves(plain), saved)))
    dist.barrier()
    with mesh_context(meshes["2x2"]):
        resumed, second = tr.run(state, pipe.device_batch, steps=2,
                                 start_step=int(state.opt.step))
    out["trainer/second"] = second
    out["trainer/resume_equal"] = all(torch.equal(a, b) for a, b in
                                      zip(tree_leaves(resumed), tree_leaves(whole)))
    return out


def _port_rank(inp_path: str, ckpt_dir: str, hb_path: str):
    import torch.distributed as dist

    from repro_torch.core.c2mpi import MPIX_Initialize

    torch.set_num_threads(1)
    inp = dict(np.load(inp_path))
    MPIX_Initialize(device="cpu")
    meshes = {k: t_mesh.make_mesh(v, AXES, device_type="cpu") for k, v in MESHES.items()}
    out = {"rank": dist.get_rank()}
    out.update(_verb_cases(meshes["2x2"], inp["verb_x"]))
    out.update(_moe_cases(inp, meshes))
    out.update(_step_case(inp, meshes["2x2"]))
    out.update(_thread_case(inp, meshes["2x2"]))
    out.update(_danube_case(meshes["2x2"]))
    out.update(_trainer_case(inp, meshes, ckpt_dir, hb_path))
    return out


def _launch(argv, result):
    """The port's launcher in a thread: its history, or its error."""
    try:
        result["history"] = t_launch.main(argv)
    except Exception as exc:  # noqa: BLE001 — reported by the test
        result["error"] = exc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX results, the four ranks' results, the port launcher's
    result, the directory of the run's files)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    # both launchers start from a checkpoint of step 0 (opt.step 0) holding
    # the same weights, so each trains steps 0, 1, 2 from them
    model, params = _moonshot(inputs)
    CheckpointManager(str(tmp / "launch_ckpt")).save(
        0, TrainState(params=params, opt=adamw_init(params)), wait=True)
    shutil.copytree(tmp / "launch_ckpt", tmp / "jax_ckpt")
    job = {"meshes": {k: list(v) for k, v in MESHES.items()}, "arch": MOONSHOT,
           "verbs": [dict(c, **{"in": SPECS[c["spec"]], "out": _out_axes(c)})
                     for c in VERB_CASES],
           "moe": [dict(c, cfg=_moe_cfg(c)) for c in MOE_CASES], "launch": LAUNCH,
           "jax_ckpt": str(tmp / "jax_ckpt")}
    (tmp / "job.json").write_text(json.dumps(job))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = {part: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "job.json"),
         str(tmp / f"ref_{part}.npz"), part],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("cases", "step", "launch")}
    launched = {}
    launcher = threading.Thread(target=_launch, daemon=True, args=(
        LAUNCH + ["--device", "cpu", "--mesh", "debug", "--ckpt-dir",
                  str(tmp / "launch_ckpt")], launched))
    try:
        launcher.start()
        (tmp / "ckpt").mkdir()
        ranks = t_mesh.run_ranks(_port_rank, 4, backend="gloo", timeout=RANK_TIMEOUT,
                                 args=(str(tmp / "inputs.npz"), str(tmp / "ckpt"),
                                       str(tmp / "hb.jsonl")),
                                 device_type="cpu")
        errors = {part: ref.communicate(timeout=JAX_TIMEOUT)[1] for part, ref in refs.items()}
        launcher.join(timeout=LAUNCH_TIMEOUT)
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.wait(timeout=10)
    for part, ref in refs.items():
        assert ref.returncode == 0, (part, errors[part][-3000:])
    assert not launcher.is_alive()
    out = {}
    for part in refs:
        out.update(np.load(tmp / f"ref_{part}.npz"))
    return out, ranks, launched, tmp


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
def _close(got, want, dtype="float32"):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _rel(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", VERB_CASES, ids=[c["id"] for c in VERB_CASES])
def test_verb_vjp_matches_jax(runs, case):
    """shard_map around one verb on (2, 2): the output and the input's
    gradient for a fixed cotangent against jax.vjp of the reference's
    shard_map (check_vma=False), on every rank."""
    ref, ranks, _, _ = runs
    for r in ranks:
        _close(r[f"verb/{case['id']}/y"], ref[f"verb/{case['id']}/y"])
        _close(r[f"verb/{case['id']}/gx"], ref[f"verb/{case['id']}/gx"])
        assert np.array_equal(r[f"verb/{case['id']}/gx"], ranks[0][f"verb/{case['id']}/gx"])


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c["id"] for c in GRAD_CASES])
def test_moe_layer_gradients_match_jax(runs, case):
    """sum(y²) + 10·aux through moe_layer under the mesh: its value and the
    gradient of the router, the three expert stacks and x against
    jax.grad of the reference's moe_layer under the same mesh (relative to
    each gradient's largest entry), every rank the same bits, two
    backward passes the same bits, each gradient in its input's type, the
    case's body in every rank."""
    ref, ranks, _, _ = runs
    cid = case["id"]
    tol = TOL[case["dtype"]]
    r0 = ranks[0]
    assert abs(float(r0[f"moe/{cid}/loss"]) - float(ref[f"moe/{cid}/loss"])) <= \
        tol * abs(float(ref[f"moe/{cid}/loss"]))
    for n in ("router", "we_g", "we_u", "we_d", "x"):
        assert _rel(r0[f"moe/{cid}/{n}"], ref[f"moe/{cid}/{n}"]) <= tol, n
        want = "torch.float32" if n == "router" else f"torch.{case['dtype']}"
        assert r0[f"moe/{cid}/{n}/dtype"] == want
        for r in ranks:
            assert np.array_equal(r[f"moe/{cid}/{n}"], r0[f"moe/{cid}/{n}"])
    mode = "a2a" if case["mode"] == "a2a" else "replicated"
    for r in ranks:
        assert r[f"moe/{cid}/repeat"]
        assert r[f"moe/{cid}/calls"] == {mode: 2}


def test_reference_int8_dispatch_gradient_is_not_straight_through(runs):
    """The reference's int8 dispatch (src/repro/models/moe.py:134-148)
    promises a straight-through gradient, but its int8 cast cuts it and
    only the scales carry one: on (2, 2), x (2, 8, 32), its x gradient
    stands more than the exact dispatch's largest entry away from it."""
    ref, _, _, _ = runs
    cid = INT8_CASE["id"]
    assert _rel(ref[f"moe/{cid}/x"], ref[f"moe/{cid}/exact_x"]) > 1.0


def test_port_int8_dispatch_is_straight_through(runs):
    """The port keeps the documented behaviour: every gradient through the
    int8 dispatch within 0.05 (relative, tests/test_sharded.py's forward
    bound) of the exact dispatch's, and not equal to it."""
    _, ranks, _, _ = runs
    cid = INT8_CASE["id"]
    for r in ranks:
        rels = [_rel(r[f"moe/{cid}/{n}"], r[f"moe/{cid}/exact/{n}"])
                for n in ("router", "we_g", "we_u", "we_d", "x")]
        assert 0 < max(rels) < INT8_REL, rels


def test_train_step_sharded_matches_jax(runs):
    """tests/test_sharded.py:118 (reduced moonshot, (2, 2), batch (4, 16),
    TrainHyper()): the loss, xent, aux and grad norm and every updated
    parameter and moment against the reference's jitted step under its
    mesh_context, and every rank's state the same bits."""
    ref, ranks, _, _ = runs
    r0 = ranks[0]
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        _close(r0[f"step/metric/{k}"], ref[f"step/metric/{k}"])
    assert r0["step/metric/aux"] > 0
    assert len(r0["step/state"]) == len([k for k in ref if k.startswith("step/state/")])
    for i, got in enumerate(r0["step/state"]):
        _close(got, ref[f"step/state/{i:05d}"])
    for r in ranks:
        assert r["step/digest"] == r0["step/digest"]


def test_backward_off_the_forward_thread_keeps_the_mesh(runs):
    """A backward called from a thread with no mesh context: the
    recompute ran both MoE layers' a2a bodies again (the mesh path), and
    the gradients are bit-identical to a backward from the forward's
    thread."""
    _, ranks, _, _ = runs
    for r in ranks:
        assert not r["thread/alive"]
        assert r["thread/calls"] == {"a2a": 2}
        assert r["thread/equal"]


def test_danube_step_is_unchanged_by_a_mesh(runs):
    """Reduced danube (no MoE) trains the same bits under (2, 2) as with no
    mesh: its state and metrics torch.equal."""
    _, ranks, _, _ = runs
    assert all(r["danube/equal"] for r in ranks)


def test_trainer_checkpoints_under_a_mesh(runs):
    """A Trainer on (2, 2), checkpoints every 2 steps and at the end: rank 0
    alone writes (steps 2 and 2), no .tmp-* stays, every rank restores it
    bit for bit on (1, 4) and on no mesh, and the resume goes on at step
    3, its history and state equal to an unbroken 5-step run's; every
    rank's histories the same."""
    _, ranks, _, _ = runs
    for r in ranks:
        assert r["trainer/writes"] == ([2, 2] if r["rank"] == 0 else [])
        assert r["trainer/tmp"] == []
        assert r["trainer/restored_1x4"] == (2, True)
        assert r["trainer/restored_none"] == (2, True)
        assert [s for s, _ in r["trainer/second"]] == [3, 4]
        assert r["trainer/first"] + r["trainer/second"] == r["trainer/whole"]
        assert r["trainer/resume_equal"]
        assert r["trainer/whole"] == ranks[0]["trainer/whole"]


def test_trainer_beats_once_under_a_mesh(runs):
    """The heartbeat journal holds rank 0's 3 beats, not one a rank."""
    _, _, _, tmp = runs
    beats = [json.loads(line) for line in (tmp / "hb.jsonl").read_text().splitlines()]
    assert [b["step"] for b in beats] == [0, 1, 2]


def test_launch_train_mesh_debug_matches_the_reference_launcher(runs):
    """python -m repro_torch.launch.train --mesh debug --device cpu (four
    gloo ranks; the launcher raises if a rank's history differs) from the
    reference's weights: its history within float32's tolerance of the
    reference launcher's --mesh debug run; its checkpoint of step 2
    restores with no mesh."""
    ref, _, launched, tmp = runs
    assert "error" not in launched, launched.get("error")
    hist = launched["history"]
    want = ref["launch/history"]
    assert [s for s, _ in hist] == [int(s) for s, _ in want] == [0, 2]
    _close([l for _, l in hist], want[:, 1])
    ckpt = CheckpointManager(str(tmp / "launch_ckpt"))
    assert ckpt.list_steps() == [0, 2]
    model, params = _moonshot(dict(np.load(tmp / "inputs.npz")))
    state, step = ckpt.restore_latest(like=TrainState(params=params, opt=adamw_init(params)))
    assert step == 2 and int(state.opt.step) == 3
    assert all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(state))
