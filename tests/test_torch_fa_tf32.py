"""FLASH_ATTN's float32 tensor-core route on the CPU: its plain model.

``csrc/flash_attention_tf32x3.cu`` runs float32 attention by 3×TF32: every
operand is split into TF32 hi + lo, each product is lo·hi + hi·lo + hi·hi,
each 32-deep stage of q·kᵀ and each 32 keys of p·v sum into a fresh
tensor-core accumulator that is added in float32.  ``attention_tf32x3_ref``
models those steps: against the JAX package's flash attention (Pallas,
interpret mode) on the same numpy inputs, and against float64; a model with
only the hi·hi products falls outside float32's tolerance; one tensor-core
accumulator over all keys of a long row errs more than one per 32 keys (the
accumulator modelled as float32 truncated toward zero, as the tensor cores
do not round it to nearest); the route and the wrapper's refusals.

Tolerances: normwise, float32's 1e-5 (chip_smoke.py ``TOL``) against the
JAX op and against float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, fa_route, flash_attention_tf32x3_hopper, tf32x3_key_tile)
from repro_torch.kernels.flash_attention.ref import (
    TF32X3_TERMS, attention_f64, attention_ref, attention_tf32x3_ref)
from repro_torch.kernels.matmul.ref import tf32_split

FA_TOL = 1e-5

#: the masks and edges of tests/test_torch_sort_attention.py's FA_CASES
FA_CASES = {
    "causal": dict(sq=70, skv=70, causal=True, window=None, prefix_len=0),
    "window": dict(sq=70, skv=70, causal=True, window=16, prefix_len=0),
    "prefix+window": dict(sq=70, skv=70, causal=True, window=16, prefix_len=8),
    "sq<skv": dict(sq=17, skv=150, causal=True, window=None, prefix_len=0),
    "bidirectional": dict(sq=33, skv=33, causal=False, window=None, prefix_len=0),
    "no key seen": dict(sq=40, skv=20, causal=True, window=None, prefix_len=0),
    # the last 64-key tile holds key 128 alone
    "one past a tile": dict(sq=129, skv=129, causal=True, window=None, prefix_len=0),
}


def _inputs(c, d, seed):
    """4 query heads over 2 KV heads, float32 numpy; v has mean 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 4, c["sq"], d)).astype(np.float32)
    k = rng.standard_normal((1, 2, c["skv"], d)).astype(np.float32)
    v = (rng.standard_normal((1, 2, c["skv"], d)) + 1.0).astype(np.float32)
    return q, k, v


def _kw(c):
    return dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("d", [32, 80, 256])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_attention_tf32x3_ref_matches_jax(d, case):
    """"no key seen": query rows 0–19 see no key; the reference's Pallas op
    gives them Σv over keys zero-padded to its block, so that case is held
    to the JAX package's attention_ref, which gives the mean of v, as the
    port does."""
    c = FA_CASES[case]
    q, k, v = _inputs(c, d, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if case == "no key seen":
        want = j_fa_ref.attention_ref(jq, jk, jv, **_kw(c))
    else:
        want = j_fa_ops.flash_attention(jq, jk, jv, interpret=True, **_kw(c))
    tq, tk, tv = from_numpy((q, k, v))
    got = attention_tf32x3_ref(tq, tk, tv, **_kw(c))
    assert got.dtype == torch.float32 and got.shape == tq.shape
    assert _normwise(to_numpy(got), want) <= FA_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", ["prefix+window", "sq<skv", "no key seen"])
def test_attention_tf32x3_ref_matches_float64(d, case):
    c = FA_CASES[case]
    tq, tk, tv = from_numpy(_inputs(c, d, 1))
    exact = attention_f64(tq, tk, tv, **_kw(c))
    assert exact.dtype == torch.float64
    assert _normwise(attention_tf32x3_ref(tq, tk, tv, **_kw(c)), exact) <= FA_TOL
    assert _normwise(attention_ref(tq, tk, tv, **_kw(c)), exact) <= FA_TOL


def test_model_with_only_hi_hi_products_falls_outside_the_float32_tol():
    """TF32 alone keeps ~11 bits: dropping both cross terms errs ~1e-4; the
    lo·hi term of q·kᵀ alone, ~5e-5 (what a kernel that drops it reads)."""
    c = FA_CASES["prefix+window"]
    tq, tk, tv = from_numpy(_inputs(c, 80, 2))
    exact = attention_f64(tq, tk, tv, **_kw(c))
    hi_hi = TF32X3_TERMS[2:]
    assert hi_hi == (("hi", "hi"),)
    only_hi = attention_tf32x3_ref(tq, tk, tv, qk_terms=hi_hi, pv_terms=hi_hi, **_kw(c))
    no_lo_hi = attention_tf32x3_ref(tq, tk, tv, qk_terms=TF32X3_TERMS[1:], **_kw(c))
    full = attention_tf32x3_ref(tq, tk, tv, **_kw(c))
    assert _normwise(full, exact) <= FA_TOL / 10
    assert _normwise(only_hi, exact) > FA_TOL
    assert _normwise(no_lo_hi, exact) > FA_TOL


def test_model_key_tile_follows_the_kernel():
    """The model's online softmax takes the kernel's key tile by default
    (64 keys up to d = 96, 32 above); the tile moves the result by
    float32 rounding only."""
    assert [tf32x3_key_tile(d) for d in HEAD_DIMS] == [64, 64, 64, 64, 32, 32]
    c = FA_CASES["one past a tile"]
    tq, tk, tv = from_numpy(_inputs(c, 256, 3))
    by_default = attention_tf32x3_ref(tq, tk, tv, **_kw(c))
    assert torch.equal(by_default, attention_tf32x3_ref(tq, tk, tv, tile=32, **_kw(c)))
    assert _normwise(by_default, attention_tf32x3_ref(tq, tk, tv, tile=64, **_kw(c))) < 1e-6


def _to_zero(x64):
    """float64 ``x64`` to float32, truncated toward zero."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _pv_on_tensor_cores(p, v, chunk):
    """p (rows, keys) · v (keys, d) as the kernel's products take it: both
    split into TF32 hi + lo, per 8-key step lo·hi, hi·lo and hi·hi, each
    product exact and added to a float32 accumulator truncated toward zero;
    the accumulator starts fresh every ``chunk`` keys and is added to the
    float32 sum to nearest."""
    (p_hi, p_lo), (v_hi, v_lo) = tf32_split(p), tf32_split(v)
    out = torch.zeros((p.shape[0], v.shape[1]))
    acc = torch.zeros_like(out)
    for k0 in range(0, p.shape[1], 8):
        s = slice(k0, k0 + 8)
        for a, b in ((p_lo, v_hi), (p_hi, v_lo), (p_hi, v_hi)):
            acc = _to_zero(acc.double() + a[:, s].double() @ b[s].double())
        if (k0 + 8) % chunk == 0 or k0 + 8 >= p.shape[1]:
            out, acc = out + acc, torch.zeros_like(acc)
    return out


def test_one_pv_accumulator_over_a_long_row_errs_more_than_one_per_32_keys():
    """A row of 4096 keys with weights in (0, 1] and v of mean 1: the
    per-32-key accumulators err at float32's level; one accumulator over
    all keys truncates 1536 times into a sum ~2000 and errs several times
    more, past what the card's model tolerance allows."""
    g = torch.Generator().manual_seed(4)
    p = torch.exp(-torch.rand((16, 4096), generator=g))
    v = torch.randn((4096, 8), generator=g) + 1.0
    exact = p.double() @ v.double()
    per_32 = _normwise(_pv_on_tensor_cores(p, v, 32), exact)
    single = _normwise(_pv_on_tensor_cores(p, v, 4096), exact)
    assert per_32 < 1e-6
    assert single > 4 * per_32 and single > 1e-6


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fa_route_sends_float32_to_tf32x3(d):
    assert fa_route(torch.float32, d) == "tf32x3"
    assert fa_route(torch.bfloat16, d) == ("mma" if d <= 128 else "wgmma")


def test_tf32x3_wrapper_refuses_host_tensors_and_counts_nothing():
    q = torch.randn(1, 2, 4, 32)
    before = _cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_tf32x3_hopper(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_tf32x3_hopper(*(torch.randn(1, 2, 4, 264),) * 3)
    assert _cuda.launch_counts() == before
    assert before.get("flash_attention_tf32x3", 0) == 0
