"""Port parity for training (ROADMAP A8): the gradients of the MMM, RMSNORM
and FLASH_ATTN ``autograd.Function``s against ``jax.vjp`` of the JAX
package's ops (Pallas in interpret mode), ``mea_attention`` and its VJP,
``softmax_xent``, ``Model.loss_fn`` and every gradient leaf of four reduced
configurations against ``jax.value_and_grad`` of the reference's, AdamW,
the schedules and compression, a reduced danube's loss history against the
JAX Trainer (plain, and with microbatches and compression), a resumed run
against an unbroken one, the LM_GRAD and ADAMW_STEP vectors against the
reference's, and the launcher and facade (their data-parallel mode once
each; test_torch_train_parallel.py holds it).

Inputs are made once in numpy from a seed and fed to both packages; the
port runs on the CPU (its wrappers' plain versions) through a session
made with ``device="cpu"``.  Tolerances (ROADMAP's parity contract):
float32 rtol/atol 2e-4, bfloat16 4e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import xla as j_fa_xla
from repro.kernels.matmul import ops as j_mm_ops
from repro.kernels.rmsnorm import ops as j_rms_ops
from repro.models import build_model as j_build_model
from repro.models.layers import softmax_xent as j_softmax_xent
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro.optim import schedule as j_sched
from repro.train import step_kernels as j_steps
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainHyper as JTrainHyper
from repro.train.trainer import TrainState as JTrainState
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.core.c2mpi import halo_dispatch
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.xla import mea_attention
from repro_torch.kernels.matmul import ops as t_mm_ops
from repro_torch.kernels.rmsnorm import ops as t_rms_ops
from repro_torch.launch import train as t_launch
from repro_torch.models import build_model
from repro_torch.models.layers import softmax_xent
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp
from repro_torch.optim import schedule as t_sched
from repro_torch.train import step_kernels as t_steps
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (Trainer, TrainHyper, TrainState,
                                       loss_and_grads)

TOL = {"float32": 2e-4, "bfloat16": 4e-2}
DTYPES = ["float32", "bfloat16"]
DANUBE = "h2o-danube-1.8b"
#: dense attention, MoE (the router's aux), Mamba-2 with zamba2's shared
#: block, and a patch-embed prefix whose logits loss_fn slices
GRAD_ARCHS = [DANUBE, "moonshot-v1-16b-a3b", "zamba2-1.2b", "paligemma-3b"]


def _np(dtype, a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                            else np.float32)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = to_numpy(x)
    return np.asarray(x, np.float32).astype(np.float64)


def _close(got, want, dtype="float32"):
    tol = TOL[dtype]
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _leaf(t):
    """A torch leaf that requires grad."""
    return t.detach().clone().requires_grad_()


@pytest.fixture
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


# ---------------------------------------------------------------------------
# (a) the three Functions against jax.vjp of the reference's ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_mmm_gradients_match_jax(dtype):
    rng = np.random.default_rng(1)
    a, b = _np(dtype, rng.standard_normal((33, 40))), _np(dtype, rng.standard_normal((40, 24)))
    g = _np(dtype, rng.standard_normal((33, 24)))
    out, vjp = jax.vjp(lambda x, y: j_mm_ops.mmm(x, y, interpret=True),
                       jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    ta, tb = _leaf(from_numpy(a)), _leaf(from_numpy(b))
    tout = t_mm_ops.mmm(ta, tb)
    assert tout.grad_fn is not None
    tout.backward(from_numpy(g))
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    for got, want in ((tout, out), (ta.grad, da), (tb.grad, db)):
        _close(got, want, dtype)


def test_mmm_backward_skips_an_operand_that_needs_no_grad():
    rng = np.random.default_rng(2)
    a = from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    b = _leaf(from_numpy(rng.standard_normal((7, 5)).astype(np.float32)))
    t_mm_ops.mmm(a, b).sum().backward()
    assert a.grad is None
    _close(b.grad, a.numpy().T @ np.ones((9, 5), np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_gradients_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = _np(dtype, rng.standard_normal((3, 5, 80)) * 2.0)
    gamma = _np(dtype, 1.0 + 0.1 * rng.standard_normal(80))
    g = _np(dtype, rng.standard_normal((3, 5, 80)))
    out, vjp = jax.vjp(lambda x_, g_: j_rms_ops.rmsnorm(x_, g_, eps=1e-5, interpret=True),
                       jnp.asarray(x), jnp.asarray(gamma))
    dx, dgamma = vjp(jnp.asarray(g))
    tx, tg = _leaf(from_numpy(x)), _leaf(from_numpy(gamma))
    tout = t_rms_ops.rmsnorm(tx, tg, eps=1e-5)
    assert tout.grad_fn is not None
    tout.backward(from_numpy(g))
    for got, want in ((tout, out), (tx.grad, dx), (tg.grad, dgamma)):
        _close(got, want, dtype)


#: (heads, KV heads, Sq, Skv, causal, window, prefix_len): causal, window,
#: a bidirectional prefix with a window, GQA with Sq < Skv, no mask
FA_CASES = [(4, 4, 24, 24, True, None, 0), (4, 2, 24, 24, True, 8, 0),
            (4, 1, 24, 24, True, 8, 6), (4, 2, 9, 24, True, None, 0),
            (2, 2, 16, 16, False, None, 0)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "h{}kv{}q{}k{}c{}w{}p{}".format(*c))
def test_flash_attention_gradients_match_jax(dtype, case):
    h, hkv, sq, skv, causal, window, prefix = case
    rng = np.random.default_rng(sum(case[:4]))
    q = _np(dtype, rng.standard_normal((2, h, sq, 32)))
    k = _np(dtype, rng.standard_normal((2, hkv, skv, 32)))
    v = _np(dtype, rng.standard_normal((2, hkv, skv, 32)))
    g = _np(dtype, rng.standard_normal((2, h, sq, 32)))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out, vjp = jax.vjp(lambda *t: j_fa_ops.flash_attention(*t, interpret=True, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_leaf(from_numpy(x)) for x in (q, k, v))
    tout = t_fa_ops.flash_attention(tq, tk, tv, **kw)
    assert tout.grad_fn is not None
    tout.backward(from_numpy(g))
    _close(tout, out, dtype)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, dtype)


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "h{}kv{}q{}k{}c{}w{}p{}".format(*c))
def test_mea_attention_and_its_vjp_match_jax(case):
    """Blocks of 8 queries and 8 keys, so tiles are skipped and the online
    softmax rescales across key blocks."""
    h, hkv, sq, skv, causal, window, prefix = case
    rng = np.random.default_rng(7 + sum(case[:4]))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, h, sq, 32), (2, hkv, skv, 32), (2, hkv, skv, 32)))
    g = rng.standard_normal((2, h, sq, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix, bq=8, bk=8)
    out, vjp = jax.vjp(lambda *t: j_fa_xla.mea_attention(*t, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_leaf(torch.from_numpy(x)) for x in (q, k, v))
    tout = mea_attention(tq, tk, tv, **kw)
    tout.backward(torch.from_numpy(g))
    _close(tout, out)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_value_and_gradient_match_jax(masked):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    (jloss, jnll), jg = jax.value_and_grad(
        lambda x: j_softmax_xent(x, jnp.asarray(labels), jm), has_aux=True)(
        jnp.asarray(logits))
    tl = _leaf(torch.from_numpy(logits))
    loss, nll = softmax_xent(tl, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    loss.backward()
    _close(loss, jloss)
    _close(nll, jnll)
    _close(tl.grad, jg)


def test_softmax_xent_empty_mask_divides_by_one():
    logits = torch.zeros((1, 3, 4), requires_grad=True)
    loss, _ = softmax_xent(logits, torch.zeros((1, 3), dtype=torch.long),
                           torch.zeros((1, 3)))
    assert float(loss) == 0.0


# ---------------------------------------------------------------------------
# (b) loss_fn and every gradient leaf of whole reduced models
# ---------------------------------------------------------------------------
def _models(arch):
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_fn_and_every_gradient_leaf_match_jax(cpu_session, arch):
    jm, jp, tm, tp = _models(arch)
    batch = JSyntheticLM(jm.cfg, seq_len=24, global_batch=2).batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = loss_and_grads(tm, tp, from_numpy(batch))
    _close(loss, jloss)
    for key in ("xent", "aux"):
        _close(met[key], jmet[key])
    if arch.startswith("moonshot"):
        assert float(met["aux"]) > 0.0          # the router's aux reaches the loss
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for got, want, p in zip(tl, jl, tree_leaves(tp)):
        assert got.dtype == p.dtype and got.shape == p.shape
        _close(got, want)


def test_train_mode_keeps_no_cache_and_recomputes_each_repeat(cpu_session, monkeypatch):
    """Train mode runs each repeat under torch.utils.checkpoint: the
    backward calls every repeat's body a second time, and no stage keeps a
    cache."""
    from repro_torch.models import transformer
    jm, jp, tm, tp = _models(DANUBE)
    calls = []
    orig = transformer._train_body

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(transformer, "_train_body", counted)
    x = torch.randn((2, 16, tm.cfg.d_model), requires_grad=True)
    pos = torch.arange(16).expand(2, 16)
    out, aux, caches = transformer._forward(tp, x, pos, tm.cfg, mode="train")
    repeats = sum(st.repeats for st in tm.cfg.stages)
    assert len(calls) == repeats and all(c is None for c in caches)
    out.sum().backward()
    assert len(calls) == 2 * repeats and x.grad is not None


# ---------------------------------------------------------------------------
# (c) optimizer, schedules, compression
# ---------------------------------------------------------------------------
def _tree(rng, bf16_leaf=True):
    """A tree with keys out of sorted order and a bfloat16 leaf."""
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"z": rng.standard_normal(4).astype(np.float32),
                  "a": rng.standard_normal((2, 3000)).astype(np.float32)}}
    if bf16_leaf:
        tree["e"] = rng.standard_normal((6,)).astype(jnp.bfloat16)
    return tree


def test_adamw_and_global_norm_match_jax():
    rng = np.random.default_rng(11)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), from_numpy(params)
    jst, tst = j_adamw.adamw_init(jp), t_adamw.adamw_init(tp)
    for i in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.5).astype(p.dtype),
                             params)
        _close(t_adamw.global_norm(from_numpy(grads)),
               j_adamw.global_norm(jax.tree.map(jnp.asarray, grads)))
        jp, jst, jm = j_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jst,
                                          lr=1e-2 * (i + 1), weight_decay=0.1,
                                          clip_norm=1.0)
        tp, tst, tm = t_adamw.adamw_update(tp, from_numpy(grads), tst,
                                          lr=1e-2 * (i + 1), weight_decay=0.1,
                                          clip_norm=1.0)
        _close(tm["grad_norm"], jm["grad_norm"])
    assert int(tst.step) == int(jst.step) == 3
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(got, want, "bfloat16" if got.dtype == torch.bfloat16 else "float32")
        assert str(got.dtype).endswith(str(want.dtype))
    for part in ("mu", "nu"):
        for got, want in zip(tree_leaves(getattr(tst, part)),
                             jax.tree.leaves(getattr(jst, part))):
            _close(got, want)


def test_adamw_clips_a_bfloat16_leaf_in_float32_as_jax_does():
    """A clipped bfloat16 gradient reaches the moments unrounded: JAX's
    ``g * scale`` promotes bfloat16 × a float32 array to float32, so the
    port casts each leaf before the clip scale.  One 64×64 bfloat16 leaf,
    gradients N(0, 3²) (global norm ~190, so clip_norm 1.0 scales them), 5
    steps, the same numpy arrays to both packages.  Moments within 1e-5 of
    their largest value (the global norm's sum order; rounding the clipped
    gradient to bfloat16 is ~2e-3), parameters at most one bfloat16 ulp
    apart."""
    rng = np.random.default_rng(23)
    params = {"w": rng.standard_normal((64, 64)).astype(jnp.bfloat16)}
    jp, tp = jax.tree.map(jnp.asarray, params), from_numpy(params)
    jst, tst = j_adamw.adamw_init(jp), t_adamw.adamw_init(tp)
    for _ in range(5):
        grads = {"w": (rng.standard_normal((64, 64)) * 3.0).astype(jnp.bfloat16)}
        jp, jst, _ = j_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jst,
                                          lr=3e-3, clip_norm=1.0)
        tp, tst, _ = t_adamw.adamw_update(tp, from_numpy(grads), tst,
                                          lr=3e-3, clip_norm=1.0)
        for part in ("mu", "nu"):
            got = _f64(getattr(tst, part)["w"])
            want = _f64(getattr(jst, part)["w"])
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), part
        got = _f64(tp["w"])
        want = _f64(jp["w"])
        # one bfloat16 ulp at |want|: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


def test_global_norm():
    t = {"a": torch.ones(4) * 3.0, "b": torch.ones(9) * 4.0}
    assert float(t_adamw.global_norm(t)) == pytest.approx((4 * 9 + 9 * 16) ** 0.5)


def test_schedules_match_jax():
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 130):
        kw = dict(base_lr=1e-3, warmup_steps=10, total_steps=100)
        _close(t_sched.linear_warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw),
               j_sched.linear_warmup_cosine(jnp.asarray(step, jnp.int32), **kw))
        _close(t_sched.cosine_schedule(torch.tensor(step), base_lr=1e-3, total_steps=100),
               j_sched.cosine_schedule(jnp.asarray(step), base_lr=1e-3, total_steps=100))
    assert float(t_sched.linear_warmup_cosine(0, **kw)) == 0.0


def test_compression_matches_jax_and_feeds_back_the_error():
    rng = np.random.default_rng(13)
    grads = _tree(rng, bf16_leaf=False)
    jq, js, je = j_comp.compress_gradients(jax.tree.map(jnp.asarray, grads))
    tq, ts, te = t_comp.compress_gradients(from_numpy(grads))
    for got, want in zip(tree_leaves(tq), jax.tree.leaves(jq)):
        assert got.dtype == torch.int8
        diff = np.abs(to_numpy(got).astype(np.int32) - np.asarray(want, np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3     # a .5 tie at most
    for got, want in zip(tree_leaves(ts), jax.tree.leaves(js)):
        _close(got, want)
    deq = t_comp.decompress_gradients(tq, ts, from_numpy(grads))
    for d, e, g in zip(tree_leaves(deq), tree_leaves(te), tree_leaves(from_numpy(grads))):
        torch.testing.assert_close(d + e, g, rtol=0, atol=1e-6)
    # the second step adds the residual before it quantizes
    tq2, ts2, te2 = t_comp.compress_gradients(from_numpy(grads), te)
    deq2 = t_comp.decompress_gradients(tq2, ts2, from_numpy(grads))
    for d, e2, g, e in zip(tree_leaves(deq2), tree_leaves(te2),
                           tree_leaves(from_numpy(grads)), tree_leaves(te)):
        torch.testing.assert_close(d + e2, g + e, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) the Trainer against the JAX Trainer; resume
# ---------------------------------------------------------------------------
HISTORY_CASES = {"plain": {}, "microbatches2_compressed": dict(microbatches=2,
                                                               compress_grads=True)}


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_loss_history_matches_the_jax_trainer(cpu_session, case):
    """5 steps of reduced danube from the same weights and batches."""
    extra = HISTORY_CASES[case]
    jm, jp, tm, tp = _models(DANUBE)
    hp = dict(base_lr=1e-2, warmup_steps=2, total_steps=5, **extra)
    jpipe = JSyntheticLM(jm.cfg, seq_len=32, global_batch=8)
    jtr = JTrainer(model=jm, hp=JTrainHyper(**hp), log_every=1)
    jstate = JTrainState(params=jp, opt=j_adamw.adamw_init(jp),
                         err_fb=jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
                         if extra else None)
    _, jhist = jtr.run(jstate, lambda s: {k: jnp.asarray(v) for k, v in
                                          jpipe.batch(s).items()}, steps=5)
    pipe = SyntheticLM(tm.cfg, seq_len=32, global_batch=8)
    tr = Trainer(model=tm, hp=TrainHyper(**hp), log_every=1)
    state = TrainState(params=tp, opt=t_adamw.adamw_init(tp))   # err_fb: zeros
    _, hist = tr.run(state, pipe.device_batch, steps=5)
    assert [s for s, _ in hist] == [s for s, _ in jhist] == list(range(5))
    np.testing.assert_allclose([l for _, l in hist], [l for _, l in jhist],
                               rtol=TOL["float32"], atol=TOL["float32"])
    assert hist[-1][1] < hist[0][1]


def test_resumed_run_equals_an_unbroken_one(cpu_session, tmp_path):
    tm = build_model(get_config(DANUBE).reduced())
    pipe = SyntheticLM(tm.cfg, seq_len=16, global_batch=4)
    hp = TrainHyper(base_lr=1e-2, warmup_steps=2, total_steps=6)
    whole, hist = Trainer(model=tm, hp=hp, log_every=1).run(
        Trainer(model=tm, hp=hp).init_state(torch.Generator().manual_seed(3)),
        pipe.device_batch, steps=6)
    first = Trainer(model=tm, hp=hp, ckpt=CheckpointManager(str(tmp_path)), log_every=1)
    first.run(first.init_state(torch.Generator().manual_seed(3)), pipe.device_batch, steps=3)
    second = Trainer(model=tm, hp=hp, ckpt=CheckpointManager(str(tmp_path)), log_every=1)
    state, step = second.restore_or_init(torch.Generator().manual_seed(99))
    assert step == 2 and int(state.opt.step) == 3
    resumed, hist2 = second.run(state, pipe.device_batch, steps=3, start_step=3)
    assert hist2 == hist[3:]
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)


def test_run_donates_its_input_state(cpu_session):
    """As the reference's step donates its state (donate_argnums): after the
    first step the state passed in holds no memory, the returned one does."""
    tm = build_model(get_config(DANUBE).reduced())
    tr = Trainer(model=tm, hp=TrainHyper(), log_every=1)
    state = tr.init_state(torch.Generator().manual_seed(0))
    first = tree_leaves(state)
    pipe = SyntheticLM(tm.cfg, seq_len=8, global_batch=2)
    new, hist = tr.run(state, pipe.device_batch, steps=2)
    assert len(hist) == 2
    assert all(t.untyped_storage().nbytes() == 0 for t in first)
    assert all(t.untyped_storage().nbytes() > 0 for t in tree_leaves(new))


@pytest.mark.parametrize("arch", [DANUBE, "paligemma-3b", "musicgen-large"])
def test_synthetic_stream_is_the_references(arch):
    """The same numpy batches for the same seed and step, with each
    frontend's inputs."""
    want = JSyntheticLM(j_get_config(arch).reduced(), seq_len=24, global_batch=3,
                        seed=5).batch(2)
    got = SyntheticLM(get_config(arch).reduced(), seq_len=24, global_batch=3,
                      seed=5).device_batch(2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_trainer_refuses_a_device_group(cpu_session):
    """A device group without ``arch`` is refused at ``run``, as the
    reference refuses it (the comm mode's own tests are in
    test_torch_train_parallel.py)."""
    tm = build_model(get_config(DANUBE).reduced())
    tr = Trainer(model=tm, hp=TrainHyper(), comm=cpu_session.comm_split(["hopper"]))
    pipe = SyntheticLM(tm.cfg, seq_len=8, global_batch=2)
    with pytest.raises(ValueError, match="arch"):
        tr.run(tr.init_state(torch.Generator().manual_seed(0)), pipe.device_batch, steps=1)


# ---------------------------------------------------------------------------
# (e) LM_GRAD and ADAMW_STEP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_size_and_leaf_order_match_jax(arch):
    jspecs = j_build_model(j_get_config(arch).reduced()).param_specs()
    tspecs = build_model(get_config(arch).reduced()).param_specs()
    jl, tl = jax.tree.leaves(jspecs), tree_leaves(tspecs)
    assert [tuple(s.shape) for s in tl] == [tuple(s.shape) for s in jl]
    assert [str(s.dtype).split(".")[-1] for s in tl] == \
        [jnp.dtype(s.dtype).name for s in jl]
    assert t_steps.param_size(arch, True) == j_steps.param_size(arch, True)


def test_lm_grad_and_adamw_step_vectors_match_jax(cpu_session):
    jm, jp, tm, tp = _models(DANUBE)
    pvec = np.asarray(j_steps.flatten_params(jp))
    np.testing.assert_array_equal(to_numpy(t_steps.flatten_params(tp)), pvec)
    batch = JSyntheticLM(jm.cfg, seq_len=16, global_batch=2).batch(1)
    args = (batch["tokens"], batch["labels"], batch["mask"])
    want = np.asarray(j_steps.lm_grad_vec(jnp.asarray(pvec), *map(jnp.asarray, args),
                                          arch=DANUBE, reduced=True))
    got = halo_dispatch("LM_GRAD", from_numpy(pvec), *map(from_numpy, args),
                        arch=DANUBE, reduced=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[0] == 1 + t_steps.param_size(DANUBE, True)
    _close(got, want)
    rng = np.random.default_rng(17)
    p = want.shape[0] - 1
    gsum = want * 2.0                   # two microbatches summed
    mu = (rng.standard_normal(p) * 1e-3).astype(np.float32)
    nu = (rng.random(p) * 1e-4).astype(np.float32)
    hyper = dict(arch=DANUBE, reduced=True, n_micro=2, base_lr=1e-2, warmup_steps=2,
                 total_steps=10)
    jout = np.asarray(j_steps.adamw_step_vec(gsum, pvec, mu, nu, 3, **hyper))
    tout = halo_dispatch("ADAMW_STEP", *map(from_numpy, (gsum, pvec, mu, nu)),
                         torch.tensor(3, dtype=torch.int32), **hyper)
    assert tout.shape == jout.shape == (3 * p + 4,)
    _close(tout, jout)
    params, m, v, metrics = t_steps.unpack_adamw_out(tout, DANUBE, True)
    assert int(metrics["step"]) == 4
    _close(metrics["loss"], want[0])
    assert tree_leaves(t_steps.unflatten_params(params, DANUBE, True))[0].shape == \
        jax.tree.leaves(jp)[0].shape


def test_registered_arch_resolves_and_refuses_frontends(cpu_session):
    cfg = dataclasses.replace(get_config(DANUBE).reduced(), name="danube-tiny")
    t_steps.register_arch("danube-tiny", cfg)
    assert t_steps.param_size("danube-tiny") == t_steps.param_size(DANUBE, True)
    pali = build_model(get_config("paligemma-3b").reduced())
    p = t_steps.flatten_params(pali.init(torch.Generator().manual_seed(0)))
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="token-frontend"):
        t_steps.lm_grad_vec(p, tok, tok, tok.float(), arch="paligemma-3b", reduced=True)


# ---------------------------------------------------------------------------
# (f) the launcher and the facade
# ---------------------------------------------------------------------------
def test_launch_train_on_the_cpu(tmp_path, capsys):
    hist = t_launch.main(["--arch", DANUBE, "--reduced", "--device", "cpu",
                          "--steps", "3", "--seq-len", "16", "--batch", "2",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--heartbeat", str(tmp_path / "hb.jsonl")])
    assert [s for s, _ in hist] == [0, 2] and all(np.isfinite(l) for _, l in hist)
    assert f"final loss: {hist[-1][1]}" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "ck")).list_steps() == [2]
    assert (tmp_path / "hb.jsonl").read_text().count("\n") == 3


@pytest.mark.parametrize("flags", [["--comm", "2"], ["--mesh", "debug"]])
def test_launch_train_refuses_comm_and_mesh(flags, capsys):
    """``--comm 2`` trains data-parallel over a two-member group; ``--mesh
    debug`` trains under a (2, 2) mesh of four gloo ranks on the CPU (the
    launcher raises if a rank's history differs from rank 0's), and says
    so.  Both run 2 steps (tests/test_torch_mesh_train.py holds the mesh
    against the reference)."""
    argv = ["--arch", DANUBE, "--reduced", "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--batch", "2", *flags]
    hist = t_launch.main(argv)
    assert [s for s, _ in hist] == [0, 1] and all(np.isfinite(l) for _, l in hist)
    if flags[0] == "--mesh":
        assert "mesh debug (2, 2): 4 ranks over gloo" in capsys.readouterr().out


def test_launch_train_default_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_launch.main(["--arch", DANUBE, "--reduced", "--steps", "1"])


def test_halo_train_single_agent(cpu_session):
    state, hist = halo.train(DANUBE, steps=2, reduced=True, seq_len=16, batch=2,
                             log_every=1)
    assert [s for s, _ in hist] == [0, 1] and int(state.opt.step) == 2
    state, hist2 = halo.train(DANUBE, steps=2, reduced=True, seq_len=16, batch=2,
                              log_every=1, comm=2)
    assert [s for s, _ in hist2] == [0, 1] and int(state.opt.step) == 2
