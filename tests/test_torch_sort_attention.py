"""The second routes of SORT and FLASH_ATTN on the CPU: the radix SORT's and
the tensor-core FLASH_ATTN's plain models (``sort_radix_ref``,
``attention_mma_ref``) against the JAX package's ops (Pallas in interpret
mode) on the same numpy inputs, the radix key order and pass plan, and both
routes' choice by shape and type.

Tolerances: SORT bit for bit (every correct sort of the same keys gives the
same bits; equal keys are equal bits).  FLASH_ATTN normwise, bfloat16 at
tests/test_torch_model.py's KERNEL_TOL (1e-2); float16 at 2e-3, as
tests/test_torch_cuda.py holds its kernels: p and o round to an 11-bit
mantissa (2^-11 relative each) where bfloat16 has 8."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.kernels.sorthist import ops as j_sh_ops
from repro.kernels.sorthist import ref as j_sh_ref
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, MMA_HEAD_DIMS, WGMMA_HEAD_DIM, fa_route, flash_attention_mma_hopper,
    flash_attention_wgmma_hopper, wgmma_workspace_bytes)
from repro_torch.kernels.flash_attention.ref import attention_mma_ref
from repro_torch.kernels.sorthist import sorthist as t_sh
from repro_torch.kernels.sorthist.ref import (keys_to_values, radix_passes,
                                              sort_keys, sort_radix_ref, sort_ref)

FA_TOL = {"bfloat16": 1e-2, "float16": 2e-3}
_NP = {"float32": np.float32, "bfloat16": jnp.bfloat16, "float16": np.float16}


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _nan_equal(a, b):
    """Equal, counting NaN as NaN (and −0.0 as +0.0)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def _jax_sort(x):
    return np.asarray(j_sh_ops.sort(jnp.asarray(x), interpret=True))


# ---------------------------------------------------------------------------
# SORT, radix route
# ---------------------------------------------------------------------------
def _sort_inputs(case, dtype, rng):
    if case == "ragged":
        x = rng.standard_normal(1001)
    elif case == "many rows":
        x = rng.standard_normal((2, 3, 129))
    elif case == "duplicates":
        x = rng.integers(0, 16, (3, 500))
    elif case == "negative only":
        x = -rng.uniform(1.0, 3.0, (2, 300))
    elif case == "constant":
        x = np.full((2, 257), 0.75)
    else:  # one digit varies: values one mantissa step apart at 1.0
        step = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
        x = 1.0 + step * rng.integers(0, 120, (2, 300))
    return x.astype(np.float32).astype(_NP[dtype])


SORT_CASES = ["ragged", "many rows", "duplicates", "negative only", "constant",
              "one digit varies"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_radix_ref_matches_jax_bit_for_bit(dtype, case):
    x = _sort_inputs(case, dtype, np.random.default_rng(len(case)))
    want = _jax_sort(x)
    got = sort_radix_ref(from_numpy(x))
    assert got.dtype == from_numpy(x).dtype and tuple(got.shape) == x.shape
    assert _same_bits(to_numpy(got), want)
    assert _same_bits(to_numpy(sort_ref(from_numpy(x))), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sort_radix_ref_puts_nan_last_whatever_its_sign(dtype):
    """NaN of either sign lands last, ±inf at the ends of the numbers, as
    np.sort and the JAX package's jnp.sort order (its Pallas network turns
    a row with NaN to NaN: tests/test_torch_fft_sorthist.py)."""
    x = np.random.default_rng(3).standard_normal((2, 1000)).astype(np.float32)
    x[:, [3, 7, 11, 20, 30, 40]] = [np.nan, np.inf, -np.inf, -0.0, 0.0, -np.nan]
    x[1, 50] = np.nan
    x = x.astype(_NP[dtype])
    got = to_numpy(sort_radix_ref(from_numpy(x)))
    want = np.sort(x.astype(np.float32), axis=-1)
    assert _nan_equal(got, want)
    if dtype != "float16":
        assert _nan_equal(got, np.asarray(j_sh_ref.sort_ref(jnp.asarray(x))))
    for row, nans in ((0, 2), (1, 3)):
        assert np.isnan(got[row, 1000 - nans:]).all()
        assert not np.isnan(got[row, :1000 - nans]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sort_radix_ref_orders_minus_zero_before_plus_zero(dtype):
    """The key of −0 is below +0's, so −0 sorts first, bit for bit."""
    x = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0], np.float32).astype(_NP[dtype])
    keys = sort_keys(from_numpy(x))
    assert int(keys[1]) < int(keys[0])
    got = to_numpy(sort_radix_ref(from_numpy(x))).astype(np.float32)
    np.testing.assert_array_equal(got, [-1.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    assert list(np.signbit(got)) == [True, True, True, False, False, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sort_keys_round_trip_and_order(dtype):
    """Every value of the type (NaN as the one positive NaN) comes back from
    its key exactly, and key order is value order."""
    x = np.random.default_rng(4).standard_normal(4000).astype(np.float32) * 1e3
    x[:6] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40]
    tx = from_numpy(x.astype(_NP[dtype]))
    keys = sort_keys(tx)
    assert bool((keys >= 0).all()) and bool((keys < 2 ** 32).all())
    assert torch.equal(keys_to_values(keys, tx.dtype), tx)
    order = torch.argsort(keys, stable=True)
    vals = tx[order].float()
    assert bool((vals[1:] >= vals[:-1]).all())


def test_radix_passes_on_bf16_and_constant_rows():
    rng = np.random.default_rng(5)
    row = from_numpy(rng.standard_normal(3000).astype(np.float32))
    assert radix_passes(sort_keys(row)) == (0, 1, 2, 3)
    # a bfloat16 key's low 16 bits are cleared: at most the two high digits
    assert radix_passes(sort_keys(row.bfloat16())) == (2, 3)
    assert radix_passes(sort_keys(row.half())) == (1, 2, 3)
    assert radix_passes(sort_keys(torch.full((9000,), -2.5))) == ()
    assert radix_passes(sort_keys(torch.full((9000,), float("nan")).bfloat16())) == ()
    ints = torch.arange(16, dtype=torch.float32).repeat(100)
    assert radix_passes(sort_keys(ints.bfloat16())) == (2, 3)
    step = 1.0 + 2.0 ** -23 * torch.arange(200, dtype=torch.float64)
    assert radix_passes(sort_keys(step.float())) == (0,)


def test_sort_route_at_the_tile_boundary():
    assert t_sh.SORT_TILE == 8192
    for n, route in ((1, "tile"), (4097, "tile"), (8192, "tile"), (8193, "radix"),
                     (1 << 24, "radix")):
        assert t_sh.sort_route(n) == route, n
    keys_len, tables_len = t_sh.radix_scratch(3, 8193)
    assert keys_len == 2 * 3 * 8193
    assert tables_len == 3 * (4 * 256 + 1) + 4 * 3 * 256 * 3


# ---------------------------------------------------------------------------
# FLASH_ATTN, tensor-core route
# ---------------------------------------------------------------------------
FA_CASES = {
    "causal": dict(sq=70, skv=70, causal=True, window=None, prefix_len=0),
    "window": dict(sq=70, skv=70, causal=True, window=16, prefix_len=0),
    "prefix+window": dict(sq=70, skv=70, causal=True, window=16, prefix_len=8),
    "sq<skv": dict(sq=17, skv=150, causal=True, window=None, prefix_len=0),
    "bidirectional": dict(sq=33, skv=33, causal=False, window=None, prefix_len=0),
    "no key seen": dict(sq=40, skv=20, causal=True, window=None, prefix_len=0),
    # the last key tile holds key 128 alone
    "one past a tile": dict(sq=129, skv=129, causal=True, window=None, prefix_len=0),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [32, 80, 128, 256])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_attention_mma_ref_matches_jax(dtype, d, case):
    """The plain model of both 16-bit routes (mma up to d = 128, wgmma at
    d = 256).  4 query heads over 2 KV heads; v has mean 1.  "no key seen": query
    rows 0–19 see no key; the reference's Pallas op gives them Σv over keys
    zero-padded to its block (tests/test_torch_model.py pins it), so that
    case is held to the JAX package's attention_ref, which gives the mean
    of v, as the port does."""
    c = FA_CASES[case]
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 4, c["sq"], d)).astype(np.float32).astype(_NP[dtype])
    k = rng.standard_normal((1, 2, c["skv"], d)).astype(np.float32).astype(_NP[dtype])
    v = (rng.standard_normal((1, 2, c["skv"], d)) + 1.0).astype(np.float32) \
        .astype(_NP[dtype])
    kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if case == "no key seen":
        want = j_fa_ref.attention_ref(jq, jk, jv, **kw)
    else:
        want = j_fa_ops.flash_attention(jq, jk, jv, interpret=True, **kw)
    tq, tk, tv = from_numpy((q, k, v))
    got = attention_mma_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(to_numpy(got).astype(np.float64) - want) / np.linalg.norm(want)
    assert err <= FA_TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fa_route_by_type_and_head_dim(dtype, d):
    # float32 on the 3×TF32 tensor-core route at every head dim; 16-bit
    # types on mma.sync up to d = 128 and on wgmma at d = 256
    want = ("tf32x3" if dtype == torch.float32
            else "mma" if d <= 128 else "wgmma")
    assert fa_route(dtype, d) == want
    assert (d in MMA_HEAD_DIMS) == (d % 16 == 0 and d <= 128)
    assert (d == WGMMA_HEAD_DIM) == (d not in MMA_HEAD_DIMS)


@pytest.mark.parametrize("off", [(), ("q",), ("k",), ("v",), ("q", "k", "v")])
def test_wgmma_workspace_counts_each_operand_off_the_grid(off):
    """The wgmma route copies each operand TMA cannot load (a base off the
    16-byte grid) whole into its workspace, and no other."""
    def operand(h, s, skew):
        t = torch.zeros(2 * h * s * 256 + 1, dtype=torch.bfloat16)
        return (t[1:] if skew else t[:-1]).view(2, h, s, 256)
    q, k, v = operand(8, 5, "q" in off), operand(2, 7, "k" in off), operand(2, 7, "v" in off)
    assert all((t.data_ptr() % 16 != 0) == (n in off) for n, t in zip("qkv", (q, k, v)))
    want = sum(t.numel() * 2 for n, t in zip("qkv", (q, k, v)) if n in off)
    assert wgmma_workspace_bytes(q, k, v) == want
    assert want % 16 == 0


# ---------------------------------------------------------------------------
# the new wrappers on the host
# ---------------------------------------------------------------------------
def test_new_route_wrappers_refuse_host_tensors():
    x = torch.randn(3, 9000)
    q = torch.randn(1, 2, 4, 32).bfloat16()
    before = _cuda.launch_counts()
    for fn, args in ((t_sh.sort_radix_hopper, (x,)),
                     (t_sh.sort_tile_hopper, (x[:, :100].contiguous(),)),
                     (t_sh.sort_hopper, (x,)),
                     (flash_attention_mma_hopper, (q, q, q)),
                     (flash_attention_wgmma_hopper, (q.new_zeros(1, 2, 4, 256),) * 3)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    assert _cuda.launch_counts() == before
    assert {"sort_radix", "flash_attention_mma", "flash_attention_wgmma"} <= set(before)
