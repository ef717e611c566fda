"""Data-parallel training over C²MPI device groups (DESIGN.md §15) in the
port: ``Trainer(comm=, arch=)``, ``launch/train.py --comm`` and
``halo.train(comm=)``, and the embedding's fixed-order backward that
makes its gradients repeat bit for bit on the card.

As ``tests/test_train_parallel.py`` holds the JAX package, at its size
(reduced danube, seq 32, global batch 8, 4 microbatches, 3 steps): at
equal global batch the loss history, parameters and moments are
bit-identical for 1, 2 and 4 members, the substrates mixed; a second run
replays through the compiled-graph cache; a member's death at step 2 —
re-bound by hand, declared through ``session.handle_dead_agent`` (the
reference's drill), or found by a started health monitor when the aten
member wedges in its first LM_GRAD call of step 2 — moves the epoch and
changes no bit.  The comm-mode history is held to the
JAX package's comm-mode history from the same weights and batches at the
parity tolerance (float32 2e-4).  Sessions run on the CPU, where the
hopper rows run their plain versions."""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.c2mpi import MPIX_Finalize as j_finalize
from repro.core.c2mpi import MPIX_Initialize as j_initialize
from repro.core.c2mpi import halo_session as j_session
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build_model
from repro.models.layers import embed_tokens as j_embed_tokens
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainHyper as JTrainHyper
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.core.agents import HealthConfig
from repro_torch.core.compute_object import to_numpy
from repro_torch.core.registry import KernelRegistry
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.kernels import register_all
from repro_torch.kernels.embed_grad.ref import CHUNK, embed_grad_aten, embed_grad_ref
from repro_torch.launch import train as t_launch
from repro_torch.models import build_model
from repro_torch.models.layers import EmbedFunction, embed_tokens
from repro_torch.testing.faults import FaultPlan, chaos
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StragglerPolicy
from repro_torch.train.step_kernels import flatten_params
from repro_torch.train.trainer import Trainer, TrainHyper, TrainState

ARCH = "h2o-danube-1.8b"
#: the parity contract's tolerances (ROADMAP): float32 2e-4, bfloat16 4e-2
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
SINGLE = ["torch"]
#: 2 and 4 members, the last mixed, each held to the single member's bits
GROUPS = {"two": ["hopper", "aten"], "four_mixed": ["hopper", "aten", "hopper", "torch"]}


def _hp(microbatches=4):
    return TrainHyper(microbatches=microbatches, warmup_steps=2, total_steps=20)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
    return build_model(cfg), SyntheticLM(cfg, seq_len=32, global_batch=8).device_batch


@pytest.fixture
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


def _train(session, model, data, platforms, steps=3, comm=None):
    comm = comm or session.comm_split(platforms)
    tr = Trainer(model=model, hp=_hp(), comm=comm, arch=ARCH, arch_reduced=True,
                 log_every=1)
    state, hist = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, steps)
    comm.free()
    return state, hist


def _vectors(state):
    return [flatten_params(t) for t in (state.params, state.opt.mu, state.opt.nu)]


@pytest.fixture(scope="module")
def single_run(setup):
    """The one-member run every group is held to: (history, params, mu, nu,
    step)."""
    model, data = setup
    session = halo.initialize(device="cpu")
    try:
        state, hist = _train(session, model, data, SINGLE)
    finally:
        halo.finalize()
    return hist, _vectors(state), int(state.opt.step)


@pytest.mark.parametrize("group", list(GROUPS))
def test_member_count_parity(cpu_session, setup, single_run, group):
    """2 and 4 members (mixed substrates) against 1: bit-identical loss
    histories and bit-identical final parameters and both moments."""
    model, data = setup
    hist, vecs, step = single_run
    state, h = _train(cpu_session, model, data, GROUPS[group])
    assert [s for s, _ in h] == [0, 1, 2] and h == hist
    for got, want in zip(_vectors(state), vecs):
        assert torch.equal(got, want)
    assert int(state.opt.step) == step == 3
    assert state.opt.step.dtype == torch.int32


def test_members_reach_the_hopper_rows(setup, single_run):
    """On a session whose records count their calls: the mixed group's
    torch and aten members run LM_GRAD's own dispatches (MMM, RMSNORM,
    FLASH_ATTN, EMBED_GRAD) on the hopper rows, as its hopper members do
    (the shape pass of the compile runs them on meta tensors, not
    counted), and the run keeps the single member's bits."""
    model, data = setup
    counts = collections.Counter()
    full, reg = KernelRegistry(), KernelRegistry()
    register_all(full)
    for alias in full.aliases():
        for rec in full.records(alias):
            @functools.wraps(rec.fn)
            def counted(*args, _fn=rec.fn, _key=(alias, rec.platform), **kw):
                if not any(isinstance(a, torch.Tensor) and a.device.type == "meta"
                           for a in args):
                    counts[_key] += 1
                return _fn(*args, **kw)
            reg.register(dataclasses.replace(rec, fn=counted))
    session = halo.initialize(device="cpu", registry=reg)
    try:
        state, hist = _train(session, model, data, GROUPS["four_mixed"])
    finally:
        halo.finalize()
    assert hist == single_run[0]
    nested = {k: v for k, v in counts.items()
              if k[0] in ("MMM", "RMSNORM", "FLASH_ATTN", "EMBED_GRAD")}
    assert {p for _, p in nested} == {"hopper"}, counts
    steps, micro = 3, 4
    assert counts[("EMBED_GRAD", "hopper")] == steps * micro
    assert sum(v for (a, _), v in counts.items() if a == "LM_GRAD") == steps * micro
    assert counts[("LM_GRAD", "torch")] == counts[("LM_GRAD", "aten")] == steps


def test_compiled_graph_cache_across_runs(cpu_session, setup):
    """A second run of the same topology compiles to the cached graph (a
    cache hit, no new graph), replays it with its inputs rebound, and
    gives the same history."""
    model, data = setup
    _, h_a = _train(cpu_session, model, data, ["hopper", "aten"], steps=2)
    (cg,) = cpu_session._compiled_graphs.values()
    replays, hits = cg.stats["replays"], cg.stats["cache_hits"]
    assert replays == 2 and hits == 0
    _, h_b = _train(cpu_session, model, data, ["hopper", "aten"], steps=2)
    assert list(cpu_session._compiled_graphs.values()) == [cg]
    assert cg.stats["replays"] == replays + 2 and cg.stats["cache_hits"] == hits + 1
    assert h_a == h_b


def test_remote_member_parity(cpu_session, setup, single_run):
    """One member rank lives in a spawned worker process (``hopper@tw-train``,
    on the CPU): the wire carries the LM_GRAD vectors and the EWADD
    partials bit-exactly, so the mixed local/remote group reproduces the
    single member's history, parameters and moments bit for bit."""
    from repro_torch.distributed.remote import spawn_worker
    model, data = setup
    hist, vecs, step = single_run
    w = spawn_worker("tw-train", device="cpu")
    try:
        agent = w.agent("hopper").attach(cpu_session)
        served0 = w.heartbeat(timeout=60)["served"]["hopper"]
        state, h = _train(cpu_session, model, data, ["hopper", agent.platform])
        served = w.heartbeat(timeout=60)["served"]["hopper"] - served0
    finally:
        w.shutdown()
        w.kill()
    assert h == hist
    for got, want in zip(_vectors(state), vecs):
        assert torch.equal(got, want)
    assert int(state.opt.step) == step
    # 2 of each step's 4 LM_GRAD microbatches, and its local EWADD, ran there
    assert served >= 3 * 3
    assert w.client.wire_stats()["bytes_sent"] > 0


def test_arch_depth_cut_names_resolve_in_every_process():
    """``"<id>@<L>"`` is the config cut to L layers, as a host registers a
    cut with ``register_arch``; a worker resolves the same name alike."""
    from repro_torch.train.step_kernels import param_size, resolve_arch
    cfg = get_config(ARCH)
    cut = resolve_arch(f"{ARCH}@2")
    assert cut == dataclasses.replace(cfg, stages=(dataclasses.replace(
        cfg.stages[0], repeats=2),))
    assert resolve_arch(f"{ARCH}@2", reduced=True) == cut.reduced()
    assert param_size(f"{ARCH}@1") < param_size(f"{ARCH}@2") < param_size(ARCH)
    for bad in (f"{ARCH}@0", f"{ARCH}@x", "zamba2-1.2b@2"):
        with pytest.raises(KeyError):
            resolve_arch(bad)


def test_comm_mode_requires_arch_and_divisibility(cpu_session, setup):
    model, data = setup
    comm = cpu_session.comm_split(["hopper", "aten"])
    tr = Trainer(model=model, hp=_hp(), comm=comm)
    state = tr.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="arch"):
        tr.run(state, data, steps=1)
    tr3 = Trainer(model=model, hp=_hp(microbatches=3), comm=comm, arch=ARCH,
                  arch_reduced=True)
    with pytest.raises(ValueError, match="divide"):
        tr3.run(tr3.init_state(torch.Generator().manual_seed(0)), data, steps=1)
    comm.free()


def test_member_death_mid_run_repairs_and_stays_bit_identical(cpu_session, setup):
    """A member dies between steps 1 and 2: the comm re-binds its rank onto
    the survivor, the epoch moves, the trainer recaptures, and the 4-step
    history equals the single member's bit for bit."""
    model, data = setup
    _, h_ref = _train(cpu_session, model, data, SINGLE, steps=4)
    comm = cpu_session.comm_split(["hopper", "aten"])
    epoch0 = comm.epoch
    killed = []

    def chaotic_data(step):
        if step == 2 and not killed:
            assert comm.on_member_dead("aten")
            killed.append(step)
        return data(step)

    captures = []
    orig = Trainer._capture_comm_step

    def counted(self, *a):
        captures.append(comm.epoch)
        return orig(self, *a)

    Trainer._capture_comm_step = counted
    try:
        _, h_mix = _train(cpu_session, model, chaotic_data, None, steps=4, comm=comm)
    finally:
        Trainer._capture_comm_step = orig
    assert killed and comm.epoch > epoch0
    assert comm.platforms == ("hopper", "hopper")
    assert captures == [epoch0, comm.epoch]
    assert h_mix == h_ref


def _death_run(session, model, data, kill):
    """4 steps over ``["hopper", "aten"]`` with ``kill(step)`` called at
    each batch draw; returns the history, the comm and the epochs each
    capture saw."""
    comm = session.comm_split(["hopper", "aten"])
    captures = []
    orig = Trainer._capture_comm_step

    def counted(self, *a):
        captures.append(comm.epoch)
        return orig(self, *a)

    def chaotic_data(step):
        kill(step)
        return data(step)

    Trainer._capture_comm_step = counted
    try:
        _, hist = _train(session, model, chaotic_data, None, steps=4, comm=comm)
    finally:
        Trainer._capture_comm_step = orig
    return hist, comm, captures


def test_member_death_through_handle_dead_agent_stays_bit_identical(
        cpu_session, setup):
    """The reference's drill: the session declares its aten agent dead
    before step 2 (``handle_dead_agent``, the monitor's own response): the
    comm re-binds aten's rank onto hopper, the agent refuses work, the
    trainer recaptures, and the 4-step history equals one member's."""
    model, data = setup
    _, h_ref = _train(cpu_session, model, data, SINGLE, steps=4)
    aten = cpu_session.agents["aten"]
    killed = []

    def kill(step):
        if step == 2 and not killed:
            killed.append(cpu_session.handle_dead_agent(aten, reason="chaos drill"))

    hist, comm, captures = _death_run(cpu_session, model, data, kill)
    assert killed == [0]                   # nothing queued between steps
    assert aten.dead and "aten" not in cpu_session._allowed_platforms()
    assert comm.platforms == ("hopper", "hopper") and comm.epoch == 1
    assert captures == [0, 1]
    assert hist == h_ref


def test_member_death_found_by_the_monitor_stays_bit_identical(cpu_session, setup):
    """A started monitor over the session (2 s timeout) and an aten member
    that wedges in its first LM_GRAD call of step 2: the monitor declares
    it DEAD, the session re-binds its rank and replays the wedged call and
    the queued one on the fail-safe torch row (LM_GRAD is one callable on
    every row), step 2 completes on the old graph, step 3 recaptures, and
    the history equals one member's bit for bit."""
    model, data = setup
    _, h_ref = _train(cpu_session, model, data, SINGLE, steps=4)
    cpu_session.enable_health_monitor(
        config=HealthConfig(heartbeat_timeout=2.0, poll_interval=0.02,
                            straggler_multiple=0.0))
    with chaos(cpu_session, FaultPlan(platform="aten", mode="die", nth=10 ** 6,
                                      aliases=["LM_GRAD"])) as fa:
        def kill(step):
            if step == 2:                  # arm at step 2's first LM_GRAD
                fa.plan = dataclasses.replace(fa.plan, nth=fa.calls + 1)

        hist, comm, captures = _death_run(cpu_session, model, data, kill)
        assert fa.calls == 5 and fa.failures == 1 and fa.dead
    assert comm.platforms == ("hopper", "hopper") and comm.epoch == 1
    assert captures == [0, 1]
    assert hist == h_ref


def test_comm_checkpoint_restores_into_the_single_device_trainer_and_back(
        cpu_session, setup, tmp_path):
    """A comm-mode checkpoint holds the single-device TrainState's leaves:
    the single-device trainer resumes from it, and a comm-mode trainer
    resumes from the single-device one's, each step's loss within the
    parity tolerance of the other mode's."""
    model, data = setup
    comm = cpu_session.comm_split(["hopper", "aten"])
    ck = CheckpointManager(str(tmp_path / "comm"))
    tr = Trainer(model=model, hp=_hp(), comm=comm, arch=ARCH, arch_reduced=True,
                 ckpt=ck, log_every=1)
    whole, h_comm = tr.run(tr.init_state(torch.Generator().manual_seed(0)), data, 4)
    first = Trainer(model=model, hp=_hp(), comm=comm, arch=ARCH, arch_reduced=True,
                    ckpt=CheckpointManager(str(tmp_path / "half")), log_every=1)
    first.run(first.init_state(torch.Generator().manual_seed(0)), data, 2)

    single = Trainer(model=model, hp=_hp(), ckpt=CheckpointManager(str(tmp_path / "half")),
                     log_every=1)
    state, step = single.restore_or_init(torch.Generator().manual_seed(9))
    assert step == 1 and int(state.opt.step) == 2
    params = model.init(torch.Generator().manual_seed(0))
    for got, want in zip(tree_leaves(state), tree_leaves(TrainState(params,
                                                                    adamw_init(params)))):
        assert got.dtype == want.dtype and got.shape == want.shape
    _, h_single = single.run(state, data, steps=2, start_step=2)
    np.testing.assert_allclose([l for _, l in h_single], [l for _, l in h_comm[2:]],
                               rtol=TOL["float32"], atol=TOL["float32"])

    back = Trainer(model=model, hp=_hp(), comm=comm, arch=ARCH, arch_reduced=True,
                   ckpt=CheckpointManager(str(tmp_path / "half")), log_every=1)
    state, step = back.restore_or_init(torch.Generator().manual_seed(9))
    assert step == 3
    resumed, h_back = back.run(state, data, steps=1, start_step=4)
    assert int(resumed.opt.step) == 5 and np.isfinite(h_back[0][1])
    assert [s for s, _ in h_comm] == [0, 1, 2, 3]
    assert int(whole.opt.step) == 4
    comm.free()


def test_launcher_wires_straggler_and_comm(monkeypatch):
    """launch/train.py passes its StragglerPolicy, a 2-member comm, the arch
    and microbatches raised to a multiple of 2 into the Trainer."""
    seen = {}
    real = t_launch.Trainer

    def spy(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(t_launch, "Trainer", spy)
    hist = t_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                          "2", "--seq-len", "32", "--comm", "2"])
    assert isinstance(seen["straggler"], StragglerPolicy)
    assert seen["comm"] is not None and seen["comm"].size == 2
    assert seen["comm"].platforms == ("hopper", "aten")
    assert seen["arch"] == ARCH and seen["arch_reduced"] is True
    assert seen["hp"].microbatches == 2
    assert [s for s, _ in hist] == [0, 1] and all(np.isfinite(l) for _, l in hist)


def test_launcher_resumes_comm_mode_after_the_checkpointed_step(tmp_path):
    """The launcher's resume rule in comm mode: a run that checkpointed
    step s goes on at s + 1 (its optimizer's step count) and checkpoints
    its own last step."""
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq-len", "16",
            "--batch", "4", "--comm", "2", "--ckpt-dir", str(tmp_path)]
    t_launch.main(args + ["--steps", "2"])
    ck = CheckpointManager(str(tmp_path))
    assert ck.list_steps() == [1]
    resumed = t_launch.main(args + ["--steps", "4"])
    assert [s for s, _ in resumed] == [3] and np.isfinite(resumed[0][1])
    assert ck.list_steps() == [1, 3]
    model = build_model(get_config(ARCH).reduced())
    params = model.init(torch.Generator().manual_seed(0))
    state = ck.restore(3, like=TrainState(params, adamw_init(params)))
    assert int(state.opt.step) == 4


def test_halo_train_comm(cpu_session):
    state, hist = halo.train(ARCH, steps=2, reduced=True, seq_len=16, batch=4,
                             comm=2, log_every=1)
    assert [s for s, _ in hist] == [0, 1] and int(state.opt.step) == 2
    with pytest.raises(ValueError, match="multiple of the member count"):
        halo.train(ARCH, steps=1, reduced=True, seq_len=16, batch=4, comm=2,
                   microbatches=3)


# ---------------------------------------------------------------------------
# Parity with the JAX package's comm mode
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_comm_run():
    """The reference's comm-mode run over ["xla", "xla"], compiled once: its
    initial weights as numpy and its history."""
    cfg = j_get_config(ARCH).reduced()
    model = j_build_model(cfg)
    pipe = JSyntheticLM(cfg, seq_len=32, global_batch=8)
    j_initialize()
    try:
        comm = j_session().comm_split(["xla", "xla"])
        tr = JTrainer(model=model, hp=JTrainHyper(microbatches=4, warmup_steps=2,
                                                  total_steps=20),
                      comm=comm, arch=ARCH, arch_reduced=True, log_every=1)
        state = tr.init_state(jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, state.params)
        _, hist = tr.run(state, lambda s: {k: jnp.asarray(v)
                                           for k, v in pipe.batch(s).items()}, 3)
        comm.free()
    finally:
        j_finalize()
    return params, hist


def test_comm_history_matches_the_jax_comm_trainer(cpu_session, setup, jax_comm_run):
    model, data = setup
    jparams, jhist = jax_comm_run
    params = model.params_from_numpy(jparams)
    tr = Trainer(model=model, hp=_hp(), comm=cpu_session.comm_split(["hopper", "aten"]),
                 arch=ARCH, arch_reduced=True, log_every=1)
    _, hist = tr.run(TrainState(params=params, opt=adamw_init(params)), data, 3)
    assert [s for s, _ in hist] == [s for s, _ in jhist] == [0, 1, 2]
    np.testing.assert_allclose([l for _, l in hist], [l for _, l in jhist],
                               rtol=TOL["float32"], atol=TOL["float32"])
    assert hist[-1][1] < hist[0][1]


# ---------------------------------------------------------------------------
# The embedding's Function and its fixed-order backward
# ---------------------------------------------------------------------------
def _embed_case(dtype, seed=3):
    """A (50, 24) table and (3, 40) tokens with one token repeated past a
    chunk and a position masked out of the output gradient."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((50, 24)).astype(np.float32)
    tokens = rng.integers(0, 50, size=(3, 40)).astype(np.int32)
    tokens[:, ::3] = 7                       # 42 rows of token 7: two chunks
    g = rng.standard_normal((3, 40, 24)).astype(np.float32)
    g[1, 5] = 0.0                            # a masked position's zero row
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return table.astype(jdt), tokens, g.astype(jdt)


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)) if a.dtype != np.int32 \
        else torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_function_matches_the_jax_vjp(cpu_session, dtype):
    table, tokens, g = _embed_case(dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jout, vjp = jax.vjp(lambda e: j_embed_tokens(e, jnp.asarray(tokens)), jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(g))
    emb = _torch(table).to(tdt).requires_grad_()
    out = embed_tokens(emb, _torch(tokens))
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("EmbedFunction")
    out.backward(_torch(g).to(tdt))
    assert out.dtype == emb.grad.dtype == tdt
    np.testing.assert_array_equal(to_numpy(out.detach().float()), np.asarray(jout, np.float32))
    np.testing.assert_allclose(to_numpy(emb.grad.float()), np.asarray(jgrad, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert not torch.any(emb.grad[sorted(set(range(50)) - set(tokens.ravel().tolist()))])


def test_embed_lookup_without_grad_is_the_plain_gather(cpu_session):
    table, tokens, _ = _embed_case("float32")
    emb, tok = _torch(table), _torch(tokens)
    with torch.no_grad():
        assert embed_tokens(emb.requires_grad_(), tok).grad_fn is None
    assert embed_tokens(emb.detach(), tok).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_backward_repeats_bit_for_bit(cpu_session, dtype):
    table, tokens, g = _embed_case("float32", seed=5)
    grads = []
    for _ in range(2):
        emb = _torch(table).to(dtype).requires_grad_()
        EmbedFunction.apply(emb, _torch(tokens)).backward(_torch(g).to(dtype))
        grads.append(emb.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5, 500])
def test_embed_grad_plain_version_against_index_put_in_float64(n):
    """The fixed-order float32 sum against ``index_put_(accumulate=True)``
    in float64: within float32's sum error (runs up to 500 rows long, one
    token everywhere at n = 500 but for a few)."""
    rng = np.random.default_rng(n)
    tokens = torch.from_numpy(rng.integers(0, 9, size=n)).to(torch.int64)
    if n == 500:
        tokens[rng.integers(0, n, size=5)] = 4
        tokens[tokens != 4] = 2
    g = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    got = embed_grad_ref(g, tokens, 12)
    want = torch.zeros((12, 16), dtype=torch.float64).index_put_(
        (tokens,), g.double(), accumulate=True)
    assert got.dtype == torch.float32 and got.shape == (12, 16)
    bound = 4 * n * np.finfo(np.float32).eps * float(g.abs().max())
    assert float((got.double() - want).abs().max()) <= bound
    assert torch.equal(got[12 - 1], torch.zeros(16))      # token 11 never occurs
    torch.testing.assert_close(embed_grad_aten(g, tokens, 12), got, rtol=1e-5, atol=1e-5)


def test_embed_grad_sums_in_its_stated_order():
    """One token over 70 sorted entries starting at entry 3: pieces 3..31,
    32..63, 64..72 of the fixed chunks, each summed from 0 in position
    order, then added from 0 in order; other tokens' rows in between."""
    tokens = torch.tensor([0, 0, 1] + [5] * 70 + [9] * 4)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((tokens.numel(), 3))
                         .astype(np.float32)) * torch.logspace(0, 6, tokens.numel())[:, None]
    rows = g[3:73]
    pieces = [rows[:29], rows[29:61], rows[61:]]
    total = torch.zeros(3)
    for piece in pieces:
        acc = torch.zeros(3)
        for r in piece:
            acc = acc + r
        total = total + acc
    got = embed_grad_ref(g, tokens, 10)
    assert torch.equal(got[5], total)
    assert torch.equal(got[1], g[2])


def test_a_replay_frees_its_intermediates(cpu_session):
    """A compiled replay's nodes (and so their results, a comm step's
    gradient vectors) are freed once it returns and the agents' workers go
    idle, with no cyclic collection: parents and children are unlinked,
    and an idle worker keeps no reference to its last request."""
    import gc
    import time
    import weakref

    from repro_torch.core import graph as graph_mod
    a, b = torch.ones(1000), torch.full((1000,), 2.0)
    with halo.graph(launch=False) as g:
        t = halo.dispatch("EWADD", a, b)
        u = halo.dispatch("EWMM", t, b)
        halo.dispatch("MVM", torch.ones(10, 1000), u)
    cg = g.compile(fuse=False)
    del g, t, u
    seen = []
    orig = graph_mod.ExecutionGraph.wait

    def spy(self, timeout=None):
        out = orig(self, timeout)
        seen.extend(weakref.ref(n) for n in self.nodes)
        return out

    gc.disable()
    try:
        graph_mod.ExecutionGraph.wait = spy
        (out,) = cg.replay()
        graph_mod.ExecutionGraph.wait = orig
        deadline = time.monotonic() + 5.0
        while any(r() is not None for r in seen) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(seen) == 3 and all(r() is None for r in seen)
    finally:
        graph_mod.ExecutionGraph.wait = orig
        gc.enable()
    assert torch.equal(out, torch.full((10,), 6000.0))
