"""Port parity for MLA (multi-head latent attention, DeepSeek-V2) and for
FLASH_ATTN at head dims between the kernels' instantiated ones: the MLA
parameter and cache specs against the JAX package's; ``mla_forward``'s
prefill (decompressed keys and values through FLASH_ATTN at 128 + 64 =
192, or 32 + 16 = 48 reduced) and its absorbed decode through the latent
cache against the JAX package's on the same numpy weights, an inactive
lane's latent cache left bit for bit; FLASH_ATTN at 48 and 192 against
the JAX flash attention (interpret mode) and the hopper path's zero
padding to 64 and 256 at the real dim's scale; the reduced deepseek-v2
dispatching its prefill attention to the hopper row; its slot engine's
greedy tokens against the JAX StepScheduler's.

Inputs are made in numpy from a seed and fed to both packages; the port
runs on the CPU through a session made with ``device="cpu"``.  Tolerances
are the reference's conformance tolerances (tests/test_kernels_property.py:
float32 rtol = atol = 2e-4, bfloat16 4e-2)."""
import collections
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as j_get_config
from repro.configs.base import AttnConfig as JAttnConfig
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro.serve import kvcache as j_kvcache
from repro.serve.engine import SlotEngine as JSlotEngine
from repro.serve.engine import StepScheduler as JStepScheduler
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.configs.base import AttnConfig
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.core.registry import KernelRegistry
from repro_torch.kernels import register_all
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models import transformer as t_transformer
from repro_torch.serve import kvcache as t_kvcache
from repro_torch.serve.engine import SlotEngine, StepScheduler

#: the wrapper module (the package's namespace names its public function
#: ``flash_attention`` too)
t_fa_kernel = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
CONFORMANCE_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
                   "bfloat16": dict(rtol=4e-2, atol=4e-2)}
DTYPES = ["float32", "bfloat16"]
#: the reduced MLA's widths (configs.base.ArchConfig.reduced): 4 heads,
#: nope 32 + rope 16 = 48, v 32, latent 32, q_lora 32
MLA_KW = dict(n_heads=4, n_kv_heads=4, head_dim=32, kv_lora=32, q_lora=32,
              rope_head_dim=16, v_head_dim=32, rope_theta=10_000.0)
D_MODEL = 64


def _np(dtype, a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                            else np.float32)


def _close(got, want, dtype):
    got = to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **CONFORMANCE_TOL[dtype])


@pytest.fixture(scope="module")
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


# ---------------------------------------------------------------------------
# (a) FLASH_ATTN between the instantiated head dims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [48, 192])
@pytest.mark.parametrize("hkv", [1, 4])
def test_flash_attention_off_the_instantiated_dims_matches_jax(dtype, d, hkv):
    """The public FLASH_ATTN takes any head dim up to 256: at 48 and 192,
    causal over 40 tokens, against the JAX Pallas op in interpret mode
    (which pads the head dim to a multiple of 128)."""
    rng = np.random.default_rng(d + hkv)
    q = _np(dtype, rng.standard_normal((1, 4, 40, d)))
    k = _np(dtype, rng.standard_normal((1, hkv, 40, d)))
    v = _np(dtype, rng.standard_normal((1, hkv, 40, d)))
    want = j_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, interpret=True)
    got = t_fa_ops.flash_attention(*from_numpy((q, k, v)), causal=True)
    assert got.dtype == from_numpy(q).dtype and tuple(got.shape) == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,padded", [(48, 64), (192, 256), (100, 128), (17, 32)])
def test_hopper_path_pads_to_an_instantiated_dim_at_the_real_scale(
        monkeypatch, dtype, d, padded):
    """``_launch`` zero-pads q, k and v to the next instantiated head dim,
    hands the kernel the real dim's D^-1/2, and slices the output back:
    with the kernel replaced by attention_ref at the scale it is handed,
    the result equals attention_ref at the real dim.  A kernel handed the
    padded dim's scale would differ (the last assertion)."""
    seen = []

    def plain_kernel(route, q, k, v, causal, window, prefix_len, scale):
        seen.append((route, q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return t_fa_ref.attention_ref(q, k, v, causal=causal, window=window,
                                      prefix_len=prefix_len, scale=scale)

    monkeypatch.setattr(t_fa_kernel, "_launch_at", plain_kernel)
    g = torch.Generator().manual_seed(d)
    q = torch.randn(1, 4, 24, d, generator=g).to(dtype)
    k = torch.randn(1, 2, 24, d, generator=g).to(dtype)
    v = torch.randn(1, 2, 24, d, generator=g).to(dtype)
    route = t_fa_kernel.fa_route(dtype, d)
    got = t_fa_kernel._launch(route, q, k, v, True, None, 0)
    assert seen == [(route, padded, padded, padded, d ** -0.5)]
    assert route == ("tf32x3" if dtype == torch.float32
                     else "mma" if padded <= 128 else "wgmma")
    want = t_fa_ref.attention_ref(q, k, v, causal=True)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0)
    wrong = t_fa_ref.attention_ref(q, k, v, causal=True, scale=padded ** -0.5)
    assert float((wrong.float() - want.float()).abs().max()) > 1e-2


def test_flash_attention_problem_refuses_only_past_256():
    for d in (1, 48, 192, 256):
        q = torch.zeros(1, 2, 4, d)
        assert t_fa_kernel.flash_attention_problem(q, q, q) is None
        assert t_fa_ops.flash_attention_supported(q, q, q)
    q = torch.zeros(1, 2, 4, 257)
    assert "head dim" in t_fa_kernel.flash_attention_problem(q, q, q)
    assert t_fa_kernel.padded_head_dim(192) == 256
    assert t_fa_kernel.padded_head_dim(48) == 64


# ---------------------------------------------------------------------------
# (b) mla_forward on the same numpy weights
# ---------------------------------------------------------------------------
def test_attn_param_specs_match_jax():
    t = t_attn.attn_param_specs(D_MODEL, AttnConfig(**MLA_KW), torch.bfloat16)
    j = j_attn.attn_param_specs(D_MODEL, JAttnConfig(**MLA_KW), jnp.bfloat16)
    assert sorted(t) == sorted(j)
    for name in t:
        assert (t[name].shape, t[name].logical, t[name].init_kind) == \
            (j[name].shape, j[name].logical, j[name].init_kind), name


def mla_weights(dtype, seed=0):
    rng = np.random.default_rng(seed)
    specs = t_attn.attn_param_specs(D_MODEL, AttnConfig(**MLA_KW), torch.float32)
    return {n: _np(dtype, 1.0 + 0.1 * rng.standard_normal(s.shape)
                   if s.init_kind == "ones"
                   else rng.standard_normal(s.shape) * s.shape[0] ** -0.5)
            for n, s in specs.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_forward_prefill_then_decode_matches_jax(cpu_session, dtype):
    """Two lanes prefill 10 tokens (FLASH_ATTN at 48 on the hopper row;
    the latent cache (B,S,32) and rope key (B,S,16)), then 3 absorbed
    decode steps with lane 1 inactive: lane 0's output and cache against
    JAX's (which writes every lane), lane 1's cache bit for bit as it was."""
    w = mla_weights(dtype)
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    tw = from_numpy(w)
    ja, ta = JAttnConfig(**MLA_KW), AttnConfig(**MLA_KW)
    rng = np.random.default_rng(1)
    s0, max_len = 10, 16
    x = _np(dtype, rng.standard_normal((2, s0, D_MODEL)))
    pos = np.broadcast_to(np.arange(s0), (2, s0))
    jy, jc = j_attn.mla_forward(jw, jnp.asarray(x), ja, positions=jnp.asarray(pos),
                                norm_eps=1e-6)
    ty, tc = t_attn.mla_forward(tw, from_numpy(x), ta,
                                positions=torch.from_numpy(pos.copy()), norm_eps=1e-6)
    _close(ty, jy, dtype)
    assert [tuple(t.shape) for t in tc] == [(2, s0, 32), (2, s0, 16)]
    for t, j in zip(tc, jc):
        _close(t, j, dtype)
    pad = ((0, 0), (0, max_len - s0), (0, 0))
    jc = tuple(jnp.pad(j, pad) for j in jc)
    tc = tuple(torch.nn.functional.pad(t, (0, 0, 0, max_len - s0)) for t in tc)
    lane1 = [t[1].clone() for t in tc]
    for step in range(3):
        xt = _np(dtype, rng.standard_normal((2, 1, D_MODEL)))
        p = np.full((2,), s0 + step, np.int32)
        jy, jc = j_attn.mla_forward(jw, jnp.asarray(xt), ja,
                                    positions=jnp.asarray(p[:, None]), norm_eps=1e-6,
                                    cache=jc, cache_pos=jnp.asarray(p))
        ty, out = t_attn.mla_forward(tw, from_numpy(xt), ta,
                                     positions=torch.from_numpy(p[:, None]).long(),
                                     norm_eps=1e-6, cache=tc,
                                     cache_pos=torch.from_numpy(p).long(),
                                     active=torch.tensor([True, False]))
        assert all(o is t for o, t in zip(out, tc))        # updated in place
        _close(ty[0], jy[0], dtype)
        for t, j in zip(tc, jc):
            _close(t[0], j[0], dtype)
        for t, old in zip(tc, lane1):
            assert torch.equal(t[1], old)


def test_mla_decode_holds_the_rope_scores(cpu_session):
    """The absorbed decode's scores are latent + rope: with the rope key
    cache zeroed the output moves (a decode without the rope scores would
    not see it)."""
    w = from_numpy(mla_weights("float32"))
    a = AttnConfig(**MLA_KW)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 8, D_MODEL, generator=g)
    _, (cl, cr) = t_attn.mla_forward(w, x, a, positions=torch.arange(8)[None])
    xt = torch.randn(1, 1, D_MODEL, generator=g)
    kw = dict(positions=torch.tensor([[7]]), cache_pos=torch.tensor([7]))
    y, _ = t_attn.mla_forward(w, xt, a, cache=(cl.clone(), cr.clone()), **kw)
    y0, _ = t_attn.mla_forward(w, xt, a, cache=(cl.clone(), torch.zeros_like(cr)), **kw)
    assert float((y - y0).norm() / y.norm()) > 1e-2


# ---------------------------------------------------------------------------
# (c) the model and its caches
# ---------------------------------------------------------------------------
def _models(arch="deepseek-v2-236b"):
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def test_mla_cache_specs_and_pad_caches_match_jax(cpu_session):
    """(R,B,S,kv_lora) and (R,B,S,rope) leaves; pad_caches grows axis 2,
    not GQA's axis 3, with zeros; insert_slot and evict_slot write lane 1
    of a pooled cache whole."""
    jm, jp, tm, tp = _models()
    cfg = tm.cfg
    t_specs = pytree.tree_leaves(t_transformer.cache_specs(cfg, 2, 24),
                                 is_leaf=lambda s: hasattr(s, "shape"))
    j_specs = jax.tree.leaves(j_transformer.cache_specs(jm.cfg, 2, 24),
                              is_leaf=lambda s: hasattr(s, "shape"))
    assert [s.shape for s in t_specs] == [s.shape for s in j_specs]
    assert {s.shape[-1] for s in t_specs} == {32, 16}
    prompt = np.arange(1, 13, dtype=np.int32)[None]
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)})
    _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()})
    jcache = j_kvcache.pad_caches(jm.cfg, jcache, 24)
    tcache = t_kvcache.pad_caches(cfg, tcache, 24)
    for t, j in zip(pytree.tree_leaves(tcache), jax.tree.leaves(jcache)):
        assert tuple(t.shape) == j.shape and t.shape[2] == 24
        assert not t[:, :, 12:].any()
        _close(t, j, "float32")
    pool = tm.init_cache(2, 24)
    for leaf in pytree.tree_leaves(pool):
        leaf.fill_(3.0)
    t_kvcache.insert_slot(pool, tcache, 1)
    for f, o in zip(pytree.tree_leaves(pool), pytree.tree_leaves(tcache)):
        assert torch.equal(f[:, 1], o[:, 0]) and bool((f[:, 0] == 3.0).all())
    t_kvcache.evict_slot(pool, 1)
    assert all(not f[:, 1].any() and bool((f[:, 0] == 3.0).all())
               for f in pytree.tree_leaves(pool))


def test_reduced_mla_prefill_dispatches_flash_attn_to_hopper(cpu_session):
    """On a session whose records count their calls: the reduced
    deepseek-v2's prefill sends FLASH_ATTN at head dim 48 to the hopper row
    once a layer and never to aten (SDPA), and MOE_FFN once a MoE layer to
    its aten row; a decode step sends FLASH_ATTN nowhere.  The module's
    CPU session is restored after."""
    counts = collections.Counter()
    full, reg = KernelRegistry(), KernelRegistry()
    register_all(full)
    for alias in full.aliases():
        for rec in full.records(alias):
            @functools.wraps(rec.fn)
            def counted(*args, _fn=rec.fn, _key=f"{alias}/{rec.platform}", **kw):
                counts[_key] += 1
                return _fn(*args, **kw)
            reg.register(dataclasses.replace(rec, fn=counted))
    cfg = get_config("deepseek-v2-236b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    layers = cfg.n_layers
    moe_layers = sum(st.repeats for st in cfg.stages for b in st.pattern if b.moe)
    halo.initialize(device="cpu", registry=reg)
    try:
        _, caches = model.prefill(params, {"tokens": torch.arange(1, 21)[None]})
        fa = {k: v for k, v in counts.items() if k.startswith("FLASH_ATTN")}
        assert fa == {"FLASH_ATTN/hopper": layers}
        assert counts["MOE_FFN/aten"] == moe_layers and not counts["MOE_FFN/torch"]
        counts.clear()
        model.decode_step(params, t_kvcache.pad_caches(cfg, caches, 24),
                          torch.tensor([[5]]), 20)
        assert not any(k.startswith("FLASH_ATTN") for k in counts)
        assert counts["MOE_FFN/aten"] == moe_layers
    finally:
        halo.initialize(device="cpu")


SERVE_CASES = [([3, 1, 4, 1, 5], 4), (list(range(40, 51)), 5),
               ([9, 9, 2, 6, 6], 3)]


def test_step_scheduler_greedy_tokens_match_jax(cpu_session):
    """deepseek-v2 reduced (MLA and MoE): three requests on two slots, lanes
    joining and retiring mid-flight, the same greedy tokens as the JAX
    StepScheduler; the retired lanes' latent caches zeroed."""
    jm, jp, tm, tp = _models()
    jsched = JStepScheduler(JSlotEngine(jm, jp, slots=2, max_len=24))
    tsched = StepScheduler(SlotEngine(tm, tp, slots=2, max_len=24))
    jf = [jsched.submit(p, max_new=n) for p, n in SERVE_CASES]
    tf = [tsched.submit(p, max_new=n) for p, n in SERVE_CASES]
    jsched.drain()
    tsched.drain()
    for (p, n), a, b in zip(SERVE_CASES, jf, tf):
        assert b.result(timeout=60) == a.result(timeout=60)
        assert len(b.result()) == n
    assert tsched.completed == len(SERVE_CASES) and tsched.active() == 0
    assert all(not bool(t.any()) for t in pytree.tree_leaves(tsched.engine.caches))
