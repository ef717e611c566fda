"""Port parity for the model path: configs field for field, RMSNORM and
FLASH_ATTN against the JAX package's Pallas ops (interpret mode), whole
reduced models (prefill, then decode through the ring cache; the stub
frontends with their patch or frame embeddings) on the JAX package's own
weights, the slot engine's greedy tokens against the JAX
StepScheduler's, the serving helpers, and a fault of the reference pinned.

Inputs are made once in numpy from a seed and fed to both packages; the
port runs on the CPU (its wrappers' plain versions), through a session
made with ``device="cpu"``.  Tolerances are normwise relative errors:
float32 1e-5 for one kernel (the two sum the same float32 terms in another
order), 1e-4 for a whole model's logits (rounding differences compound
over the layers, as in the reference's own model tests), bfloat16 1e-2
(an 8-bit mantissa rounds the output)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.kernels.rmsnorm import ops as j_rms_ops
from repro.models import build_model as j_build_model
from repro.serve import kvcache as j_kvcache
from repro.serve.engine import SlotEngine as JSlotEngine
from repro.serve.engine import StepScheduler as JStepScheduler
from repro_torch import halo
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.rmsnorm import ops as t_rms_ops
from repro_torch.kernels.rmsnorm import ref as t_rms_ref
from repro_torch.kernels.rmsnorm.rmsnorm import ROW_WARPS, RmsnormPlan, rmsnorm_plan
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.serve import kvcache as t_kvcache
from repro_torch.serve.engine import (AdmissionError, AdmissionPolicy,
                                      QoSClass, SlotEngine, StepScheduler,
                                      sample_tokens)

KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MODEL_TOL = 1e-4
DTYPES = ["float32", "bfloat16"]
#: the architectures the port builds: dense attention, the state-space ones
#: (Mamba-2 blocks on the SSD rows, zamba2's shared attention block), the
#: MoE ones (MOE_FFN; deepseek-v2's MLA) and the stub frontends
PORTED = ["mistral-large-123b", "h2o-danube-1.8b", "gemma-7b", "gemma3-4b",
          "mamba2-370m", "zamba2-1.2b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
          "musicgen-large", "paligemma-3b"]
#: the stub frontends: precomputed frame or patch embeddings, served by the
#: lockstep path and the model-level entry points, refused by the engines
STUB_FRONTENDS = ["musicgen-large", "paligemma-3b"]


def _np(dtype, a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                            else np.float32)


def _normwise(got, want) -> float:
    got = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(to_numpy(want) if isinstance(want, torch.Tensor) else want,
                      np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


@pytest.fixture(scope="module")
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


# ---------------------------------------------------------------------------
# (a) configs
# ---------------------------------------------------------------------------
def test_arch_ids_match():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_the_reference_field_for_field(arch):
    t, j = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for tc, jc in ((t, j), (t.reduced(), j.reduced())):
        assert (tc.n_layers, tc.padded_vocab) == (jc.n_layers, jc.padded_vocab)
        assert str(tc.activation_dtype()).split(".")[-1] \
            == jnp.dtype(jc.activation_dtype()).name


# ---------------------------------------------------------------------------
# (b) RMSNORM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [80, 1000])
def test_rmsnorm_matches_jax(dtype, d):
    rng = np.random.default_rng(d)
    x = _np(dtype, rng.standard_normal((3, 5, d)) * 2.0)
    g = _np(dtype, 1.0 + 0.1 * rng.standard_normal(d))
    want = j_rms_ops.rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=1e-5,
                             interpret=True)
    tx, tg = from_numpy(x), from_numpy(g)
    got = t_rms_ops.rmsnorm(tx, tg, eps=1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _normwise(got, want) <= KERNEL_TOL[dtype]
    # the library row computes the same function
    assert _normwise(t_rms_ref.rmsnorm_aten(tx, tg, 1e-5), want) <= KERNEL_TOL[dtype]


#: the H100's SMs, which the RMSNORM launch plan fills
H100_SMS = 132


@pytest.mark.parametrize("rows,d,size", [(1, 2560, 2), (4, 2560, 2), (512, 2560, 2),
                                         (4096, 2560, 2), (4200, 2560, 2), (3, 80, 2),
                                         (7, 1000, 2), (7, 1000, 4), (3, 8192, 4),
                                         (5, 1025, 2), (2, 32768, 2)])
def test_rmsnorm_plan_covers_every_row_once(rows, d, size):
    """Block b serves rows b·(8/W) .. b·(8/W) + 8/W − 1: the blocks cover
    every row once and the last block holds at least one; a lane's V
    vectors cover the row with fewer than one vector a lane to spare.
    Rows off whole 16-byte vectors, or longer than 8 warps of 16 vectors,
    take one block per row."""
    plan = rmsnorm_plan(rows, d, size, H100_SMS)
    per = plan.rows_per_block
    assert (plan.blocks - 1) * per < rows <= plan.blocks * per
    nvec, rem = divmod(d * size, 16)
    if rem or nvec > 32 * 8 * 16:
        assert plan == (0, 0, rows)
        return
    w, v = plan.warps_per_row, plan.vecs_per_lane
    assert w in ROW_WARPS and 1 <= v <= 16
    assert 32 * w * (v - 1) < nvec <= 32 * w * v


def _width_plan(rows, d, size, w):
    """The rows kernel's plan at ``w`` warps a row, whatever rmsnorm_plan
    would pick."""
    lanes = 32 * w
    return RmsnormPlan(w, -(-d * size // (16 * lanes)), -(-rows // (8 // w)))


@pytest.mark.parametrize("size", [2, 4])
def test_rmsnorm_plan_reaches_every_width_at_the_card_tests_shapes(size):
    """tests/test_torch_cuda.py::test_rmsnorm_kernel_at_every_width runs the
    path's row counts at d 80, 512, 1000 and 2560: in each element size
    the plan picks each of 1, 2, 4 and 8 warps a row at one of them."""
    widths = {rmsnorm_plan(rows, d, size, H100_SMS).warps_per_row
              for rows in (4, 512, 4200) for d in (80, 512, 1000, 2560)}
    assert widths == set(ROW_WARPS)


def test_rmsnorm_plan_fills_the_card_at_the_path_row_counts():
    """danube's rows of 2560 bfloat16: a 512-token prefill's 512 rows and a
    4200-token prefill's rows spread over every SM; decode's 4 rows take
    8 warps a row, the most a block gives one row."""
    for rows in (512, 4200):
        assert rmsnorm_plan(rows, 2560, 2, H100_SMS).blocks >= H100_SMS
    assert rmsnorm_plan(4, 2560, 2, H100_SMS) == (8, 2, 4)
    assert rmsnorm_plan(4096, 2560, 2, H100_SMS).vecs_per_lane <= 8
    # the plan reads the SM count: a card of twice the SMs gets more warps a row
    assert rmsnorm_plan(512, 2560, 2, 2 * H100_SMS).warps_per_row \
        >= rmsnorm_plan(512, 2560, 2, H100_SMS).warps_per_row


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(15, 80), (15, 1000), (4, 2560), (9, 2560)])
def test_rmsnorm_plan_ref_matches_jax(dtype, rows, d):
    """The kernel's plain model under the plan, and under every warps-per-row
    that holds the row, against the JAX RMSNORM (interpret mode)."""
    rng = np.random.default_rng(rows * d)
    x = _np(dtype, rng.standard_normal((rows, d)) * 2.0)
    g = _np(dtype, 1.0 + 0.1 * rng.standard_normal(d))
    want = j_rms_ops.rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=1e-5, interpret=True)
    tx, tg = from_numpy(x), from_numpy(g)
    size = tx.element_size()
    plans = {rmsnorm_plan(rows, d, size, H100_SMS)} | {
        _width_plan(rows, d, size, w) for w in ROW_WARPS
        if -(-d * size // (16 * 32 * w)) <= 16}
    for plan in plans:
        got = t_rms_ref.rmsnorm_plan_ref(tx, tg, 1e-5, plan)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        assert _normwise(got, want) <= KERNEL_TOL[dtype], plan


def test_rmsnorm_plan_ref_leaves_what_a_plan_skips():
    """A plan one block short leaves its last rows unwritten (NaN in the
    model), and one with a vector too few a lane the row's last columns:
    the card's checks against rmsnorm_ref catch either."""
    x = torch.randn(7, 1000).bfloat16()
    g = torch.ones(1000).bfloat16()
    plan = rmsnorm_plan(7, 1000, 2, H100_SMS)
    assert not torch.isnan(t_rms_ref.rmsnorm_plan_ref(x, g, 1e-5, plan)).any()
    short = t_rms_ref.rmsnorm_plan_ref(x, g, 1e-5, plan._replace(blocks=plan.blocks - 1))
    assert torch.isnan(short[-1]).all() and not torch.isnan(short[0]).any()
    wide = _width_plan(7, 1000, 2, 1)
    narrow = t_rms_ref.rmsnorm_plan_ref(x, g, 1e-5,
                                        wide._replace(vecs_per_lane=wide.vecs_per_lane - 1))
    assert torch.isnan(narrow[:, -8:]).all() and not torch.isnan(narrow[:, :8]).any()


# ---------------------------------------------------------------------------
# (c) FLASH_ATTN
# ---------------------------------------------------------------------------
FA_CASES = {
    "causal": dict(sq=70, skv=70, causal=True, window=None, prefix_len=0),
    "window": dict(sq=70, skv=70, causal=True, window=16, prefix_len=0),
    "prefix+window": dict(sq=70, skv=70, causal=True, window=16, prefix_len=8),
    "sq<skv": dict(sq=17, skv=70, causal=True, window=None, prefix_len=0),
    "bidirectional": dict(sq=33, skv=33, causal=False, window=None, prefix_len=0),
}


def fa_inputs(dtype, sq, skv, h=8, hkv=2, d=80, seed=0):
    rng = np.random.default_rng(seed)
    return (_np(dtype, rng.standard_normal((1, h, sq, d))),
            _np(dtype, rng.standard_normal((1, hkv, skv, d))),
            _np(dtype, rng.standard_normal((1, hkv, skv, d))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_matches_jax(dtype, d, case):
    """danube's head dim and gemma's 256; at 256 in bfloat16 also the plain
    model of the wgmma route (attention_mma_ref, 64-key tiles, p rounded to
    bfloat16)."""
    c = FA_CASES[case]
    q, k, v = fa_inputs(dtype, c["sq"], c["skv"], d=d)
    kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
    want = j_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True, **kw)
    tq, tk, tv = from_numpy((q, k, v))
    got = t_fa_ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _normwise(got, want) <= KERNEL_TOL[dtype]
    # the library row: SDPA with the end-aligned mask where it differs
    assert _normwise(t_fa_ref.attention_aten(tq, tk, tv, **kw), want) \
        <= KERNEL_TOL[dtype]
    if d == 256 and dtype == "bfloat16":
        assert _normwise(t_fa_ref.attention_mma_ref(tq, tk, tv, tile=64, **kw), want) \
            <= KERNEL_TOL[dtype]


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    q, k, v = from_numpy(fa_inputs("float32", 8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        t_fa_ops.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="head dim"):
        t_fa_ops.flash_attention(*from_numpy(fa_inputs("float32", 8, 8, d=264)))
    with pytest.raises(ValueError, match="share one of"):
        t_fa_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="do not split"):
        t_fa_ops.flash_attention(q[:, :7].contiguous(), k, v)


# ---------------------------------------------------------------------------
# (f) a fault of the reference, pinned
# ---------------------------------------------------------------------------
def test_reference_flash_attention_fully_masked_row_is_not_zero():
    """q (1,2,16,32), k/v (1,1,10,32), causal: query rows 0–5 sit at
    positions −6..−1 and see no key.  The Pallas kernel's comment says such
    rows return 0; they do not.  The masked score is a finite −1e30, so
    p = exp(0) = 1 for every key: the Pallas op returns Σv over the keys
    zero-padded to 128 divided by 128, attention_ref the mean of v.  The
    port follows attention_ref (its kernel pads nothing)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 2, 16, 32)).astype(np.float32)
    k = rng.standard_normal((1, 1, 10, 32)).astype(np.float32)
    v = rng.standard_normal((1, 1, 10, 32)).astype(np.float32)
    pallas = np.asarray(j_fa_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    ref = np.asarray(j_fa_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=True))
    port = to_numpy(t_fa_ops.flash_attention(*from_numpy((q, k, v)), causal=True))
    blind = slice(0, 6)
    np.testing.assert_allclose(pallas[0, :, blind], np.broadcast_to(
        v[0, 0].sum(0) / 128, (2, 6, 32)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref[0, :, blind], np.broadcast_to(
        v[0, 0].mean(0), (2, 6, 32)), rtol=1e-5, atol=1e-6)
    assert np.abs(pallas[0, :, blind]).min() > 0 and np.abs(ref[0, :, blind]).min() > 0
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)
    # rows that see at least one key agree everywhere
    np.testing.assert_allclose(pallas[0, :, 6:], ref[0, :, 6:], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) whole models on the JAX package's weights
# ---------------------------------------------------------------------------
def _gqa(cfg, n_kv):
    """``cfg`` with every attention block's n_kv_heads set to ``n_kv``
    (dense attention configurations only)."""
    stages = tuple(dataclasses.replace(st, pattern=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, n_kv_heads=n_kv))
        for b in st.pattern)) for st in cfg.stages)
    return dataclasses.replace(cfg, stages=stages)


def _models(arch, n_kv=None):
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    if n_kv is not None:
        jc, tc = _gqa(jc, n_kv), _gqa(tc, n_kv)
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


MODEL_CASES = [(a, None) for a in PORTED] + [("h2o-danube-1.8b", 2)]


@pytest.mark.parametrize("arch,n_kv", MODEL_CASES,
                         ids=[f"{a}-kv{n or 'cfg'}" for a, n in MODEL_CASES])
def test_model_prefill_and_ring_decode_match_jax(cpu_session, arch, n_kv):
    """Prefill a 36-token prompt (past the reduced 32-token window, so the
    window masks and pad_caches rolls the cache into a ring; off the
    reduced SSD chunk of 16), then 8 decode steps that wrap the ring (or
    advance the Mamba states); logits at every step ≤ 1e-4 normwise.  The
    stub frontends take their precomputed inputs: paligemma-3b 8 patch
    embeddings before the tokens (a bidirectional prefix; decode from
    position 36 + 8), musicgen-large 36 frame embeddings and one frame
    embedding a decode step."""
    jm, jp, tm, tp = _models(arch, n_kv)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (1, 36)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (8, 1, 1)).astype(np.int32)
    batch = {"tokens": prompt}
    if cfg.frontend == "patch_embed":
        batch["patches"] = rng.standard_normal((1, cfg.prefix_len, cfg.d_model)
                                               ).astype(np.float32)
    if cfg.frontend == "frame_embed":
        batch = {"frames": rng.standard_normal((1, 36, cfg.d_model)).astype(np.float32)}
        steps = rng.standard_normal((8, 1, 1, cfg.d_model)).astype(np.float32)
    prefix = cfg.prefix_len if cfg.frontend == "patch_embed" else 0
    max_len = 48 + prefix

    def port(a):
        t = torch.from_numpy(a)
        return t.long() if a.dtype == np.int32 else t

    jl, jcache = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = tm.prefill(tp, {k: port(v) for k, v in batch.items()})
    assert tl.shape == (1, cfg.padded_vocab)
    assert _normwise(tl, jl) <= MODEL_TOL
    jcache = j_kvcache.pad_caches(jm.cfg, jcache, max_len)
    tcache = t_kvcache.pad_caches(cfg, tcache, max_len)
    for jc, tcc in zip(jax.tree.leaves(jcache), torch.utils._pytree.tree_leaves(tcache)):
        assert _normwise(tcc, jc) <= MODEL_TOL
    decode = jax.jit(jm.decode_step)
    for i, tok in enumerate(steps):
        pos = 36 + prefix + i
        jl, jcache = decode(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = tm.decode_step(tp, tcache, port(tok), pos)
        assert _normwise(tl, jl) <= MODEL_TOL, (arch, i)


def _head_dim_256(cfg):
    """Reduced gemma3-4b as the wgmma FLASH_ATTN route sees it: head dim
    256 kept, 2 heads on 1 KV head, one 5:1 pattern (5 local layers, window
    32, and 1 global), the reduced widths otherwise."""
    stage = cfg.stages[0]
    pattern = tuple(dataclasses.replace(b, attn=dataclasses.replace(
        b.attn, n_heads=2, n_kv_heads=1, head_dim=256)) for b in stage.pattern)
    return dataclasses.replace(cfg, stages=(dataclasses.replace(
        stage, pattern=pattern, repeats=1),))


def test_head_dim_256_model_prefill_and_ring_decode_match_jax(cpu_session):
    """gemma3-4b at head dim 256 (_head_dim_256), on the JAX weights: a
    36-token prompt passes the local window, so the local layers' caches
    roll into rings beside the global layer's; 8 decode steps wrap them.
    Logits at every step and the padded caches ≤ 1e-4 normwise."""
    jc = _head_dim_256(j_get_config("gemma3-4b").reduced())
    tc = _head_dim_256(get_config("gemma3-4b").reduced())
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.n_layers == 6 and [b.attn.window for b in tc.stages[0].pattern] \
        == [32] * 5 + [None]
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, tc.vocab_size, (1, 36)).astype(np.int32)
    steps = rng.integers(0, tc.vocab_size, (8, 1, 1)).astype(np.int32)
    max_len = 48
    jl, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()})
    assert _normwise(tl, jl) <= MODEL_TOL
    jcache = j_kvcache.pad_caches(jm.cfg, jcache, max_len)
    tcache = t_kvcache.pad_caches(tc, tcache, max_len)
    leaves = torch.utils._pytree.tree_leaves(tcache)
    assert sorted({t.shape[-2] for t in leaves}) == [32, max_len]
    for jc_, tc_ in zip(jax.tree.leaves(jcache), leaves):
        assert _normwise(tc_, jc_) <= MODEL_TOL
    decode = jax.jit(jm.decode_step)
    for i, tok in enumerate(steps):
        jl, jcache = decode(jp, jcache, jnp.asarray(tok), jnp.int32(36 + i))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok).long(), 36 + i)
        assert _normwise(tl, jl) <= MODEL_TOL, i


def test_decode_step_leaves_inactive_lanes_untouched(cpu_session):
    _, _, tm, tp = _models("h2o-danube-1.8b")
    caches = tm.init_cache(2, 48)
    for leaf in torch.utils._pytree.tree_leaves(caches):
        leaf.normal_(generator=torch.Generator().manual_seed(5))
    before = [t.clone() for t in torch.utils._pytree.tree_leaves(caches)]
    tm.decode_step(tp, caches, torch.tensor([[3], [4]]), torch.tensor([40, 7]),
                   torch.tensor([True, False]))
    for old, new in zip(before, torch.utils._pytree.tree_leaves(caches)):
        assert torch.equal(old[:, 1], new[:, 1])          # lane 1 wrote nothing
        assert not torch.equal(old[:, 0], new[:, 0])      # lane 0 wrote its slot


def test_params_from_numpy_checks_every_leaf(cpu_session):
    jm, jp, tm, _ = _models("h2o-danube-1.8b")
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match=r"params\.final_norm"):
        tm.params_from_numpy(tree)
    tree = jax.tree.map(np.asarray, jp)
    tree["stages"][0][0]["attn"]["wq"] = tree["stages"][0][0]["attn"]["wq"].astype(np.float64)
    with pytest.raises(ValueError, match=r"stages\[0\]\[0\]\.attn\.wq"):
        tm.params_from_numpy(tree)
    del tree["unembed"]
    with pytest.raises(ValueError, match="keys"):
        tm.params_from_numpy(tree)


def test_refused_and_ported_cover_every_arch():
    """build_model builds every configuration the JAX package builds."""
    assert sorted(PORTED) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", STUB_FRONTENDS)
def test_build_model_refuses_what_is_not_ported(cpu_session, arch):
    """The stub frontends build, at full size and reduced; what refuses
    them is the token-fed engines (SlotEngine, PagedEngine), as in the
    reference: they serve through ServeEngine's lockstep path and the
    model-level entry points.  (The name dates from when build_model
    refused them; what is refused now is these engines.)"""
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.models.transformer import param_specs

    assert param_specs(get_config(arch))["embed"].shape[1] == get_config(arch).d_model
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0))
    for engine in (SlotEngine, PagedEngine):
        with pytest.raises(ValueError, match="serves token frontends"):
            engine(model, params, 1, 32)


def test_mla_attention_raises_naming_the_roadmap(cpu_session):
    """deepseek-v2 with dense FFNs in place of its MoE ones (MLA alone), on
    the JAX weights: MLA's multi-token step through the latent cache — a
    prefill of 12 tokens, padded, then a 9-token chunk at position 12
    (written first, masked per query) — against the JAX package's
    prefill_chunk: the chunk's last logits ≤ 1e-4 normwise, the latent
    and rope caches too; and against a whole prefill of all 21 tokens.
    (The name dates from when this step raised; it is now a parity test.)"""
    def dense_ffn(cfg):
        return dataclasses.replace(cfg, stages=tuple(dataclasses.replace(
            st, pattern=tuple(dataclasses.replace(b, moe=None, d_ff=64)
                              for b in st.pattern)) for st in cfg.stages))

    jm = j_build_model(dense_ffn(j_get_config("deepseek-v2-236b").reduced()))
    tm = build_model(dense_ffn(get_config("deepseek-v2-236b").reduced()))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (1, 21)).astype(np.int32)
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :12])})
    _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12]).long()})
    jcache = j_kvcache.pad_caches(jm.cfg, jcache, 24)
    tcache = t_kvcache.pad_caches(tm.cfg, tcache, 24)
    jl, jcache = jax.jit(jm.prefill_chunk)(jp, jcache, jnp.asarray(toks[:, 12:]), 12)
    tl, tcache = tm.prefill_chunk(tp, tcache, torch.from_numpy(toks[:, 12:]).long(), 12)
    assert _normwise(tl, jl) <= MODEL_TOL
    for jc, tcc in zip(jax.tree.leaves(jcache), torch.utils._pytree.tree_leaves(tcache)):
        assert _normwise(tcc, jc) <= MODEL_TOL
    whole, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert _normwise(tl, whole) <= MODEL_TOL


def test_bf16_weights_cross_with_their_bits(cpu_session):
    jc = dataclasses.replace(j_get_config("h2o-danube-1.8b").reduced(), dtype="bfloat16")
    tc = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(), dtype="bfloat16")
    jp = j_build_model(jc).init(jax.random.PRNGKey(3))
    tp = build_model(tc).params_from_numpy(jax.tree.map(np.asarray, jp))
    w, jw = tp["stages"][0][0]["ffn"]["wd"], jp["stages"][0][0]["ffn"]["wd"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.int16).numpy(),
                          np.asarray(jw).view(np.int16))


# ---------------------------------------------------------------------------
# (e) the slot engine against the JAX StepScheduler
# ---------------------------------------------------------------------------
SERVE_CASES = [([3, 1, 4, 1, 5], 4), (list(range(40, 76)), 6),
               ([9, 9, 8, 7, 6, 5, 4, 3, 2], 8)]


def test_step_scheduler_greedy_tokens_match_jax(cpu_session):
    jm, jp, tm, tp = _models("h2o-danube-1.8b")
    jsched = JStepScheduler(JSlotEngine(jm, jp, slots=2, max_len=48))
    tsched = StepScheduler(SlotEngine(tm, tp, slots=2, max_len=48))
    jf = [jsched.submit(p, max_new=n) for p, n in SERVE_CASES]
    tf = [tsched.submit(p, max_new=n) for p, n in SERVE_CASES]
    jsched.drain()
    tsched.drain()
    for (p, n), a, b in zip(SERVE_CASES, jf, tf):
        assert b.result(timeout=60) == a.result(timeout=60)
        assert len(b.result()) == n
    assert tsched.completed == 3 and tsched.active() == 0
    rep = tsched.report()
    assert rep.tokens == sum(n for _, n in SERVE_CASES) and rep.steps > 0
    # retired lanes are zeroed
    assert all(not bool(t.any()) for t in
               torch.utils._pytree.tree_leaves(tsched.engine.caches))


def test_to_ring_matches_jax():
    rng = np.random.default_rng(2)
    for s0 in (5, 32, 37, 70):
        k = rng.standard_normal((2, 1, 3, s0, 4)).astype(np.float32)
        want = np.asarray(j_kvcache._to_ring(jnp.asarray(k), 32))
        assert np.array_equal(to_numpy(t_kvcache._to_ring(torch.from_numpy(k), 32)), want)


def test_sample_tokens_greedy_and_seeded_draw():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 0.0, 0.0, 0.0]])
    assert sample_tokens(logits, None, 0.0).tolist() == [1, 0]
    draws = [sample_tokens(logits, torch.Generator().manual_seed(s), 1.0).tolist()
             for s in (0, 0, 1)]
    assert draws[0] == draws[1]
    assert all(0 <= t < 4 for d in draws for t in d)


def test_admission_policy_caps_the_queue(cpu_session):
    _, _, tm, tp = _models("h2o-danube-1.8b")
    pol = AdmissionPolicy(classes={"batch": QoSClass(max_depth=1)})
    sched = StepScheduler(SlotEngine(tm, tp, slots=1, max_len=16), policy=pol)
    sched.submit([1, 2], max_new=2, qos="batch")
    with pytest.raises(AdmissionError):
        sched.submit([3, 4], max_new=2, qos="batch")
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit(list(range(15)), max_new=2)
    sched.drain()
    assert sched.rejected == 1 and sched.completed == 1


def test_serve_launcher_on_the_cpu(capsys):
    results = t_serve.main(["--arch", "h2o-danube-1.8b", "--reduced",
                            "--device", "cpu", "--slots", "2", "--requests", "5",
                            "--max-new", "4"])
    assert [len(r) for r in results] == t_serve.mixed_budgets(5, 4)
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "T1_us" in out


def test_serve_launcher_refuses_the_unported_paths(capsys):
    """--legacy and --paged are two paths, not a combination: the parser
    refuses them together.  (The name dates from when each flag alone was
    refused; both now serve, see test_torch_serve_front.py.)"""
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "h2o-danube-1.8b", "--paged", "--legacy",
                      "--device", "cpu"])
    assert "mutually exclusive" in capsys.readouterr().err
