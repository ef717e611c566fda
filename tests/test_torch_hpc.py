"""Port parity for JS, 1DCONV and SMMM: repro_torch's ops (CPU → plain
version), oracles and library rows against the JAX package's Pallas ops
(interpret mode) on the same numpy inputs, in float32 and bfloat16; the
blocked-ELL format helpers against the reference's, bit for bit; and the
wrappers' refusals.

The inputs avoid three weaknesses of the reference's own: JS runs with a
random x ≠ 0 (with x = 0 the A·x term vanishes and a kernel that skips it
still passes); SMMM's pad slots hold 7.0 instead of zeros (a kernel that
clamps index −1 to block 0 and adds it would then still pass) and one block
row has no block at all; ragged sizes everywhere.

Tolerances are the reference's conformance ones
(tests/test_kernels_property.py: float32 2e-4, bfloat16 4e-2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv1d import ops as j_conv_ops
from repro.kernels.conv1d import ref as j_conv_ref
from repro.kernels.jacobi import ops as j_js_ops
from repro.kernels.spmm import ops as j_sp_ops
from repro.kernels.spmm import ref as j_sp_ref
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels.conv1d import ops as t_conv_ops
from repro_torch.kernels.conv1d import ref as t_conv_ref
from repro_torch.kernels.jacobi import ops as t_js_ops
from repro_torch.kernels.jacobi import ref as t_js_ref
from repro_torch.kernels.spmm import ops as t_sp_ops
from repro_torch.kernels.spmm import ref as t_sp_ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
DTYPES = ["float32", "bfloat16"]
BM, BK = 64, 128
PAD_FILL = 7.0


def _dt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else np.float32


def _f32(t):
    return np.asarray(to_numpy(t) if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL[dtype])


def js_inputs(n, dtype, seed=0):
    """A + n·I (diagonally dominant), x ≠ 0, b: numpy in ``dtype``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    assert np.all(x != 0)
    return [v.astype(_dt(dtype)) for v in (a, x, b)]


def block_sparse_np(m, k, density, seed, empty_row=None):
    """A numpy block-sparse (m, k) float32 matrix in BM×BK blocks; block
    row ``empty_row`` has no block at all."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m // BM, k // BK)) < density
    mask[:, 0] = True
    if empty_row is not None:
        mask[empty_row] = False
    full = np.repeat(np.repeat(mask, BM, axis=0), BK, axis=1)
    return rng.standard_normal((m, k)).astype(np.float32) * full


def smmm_inputs(m, k, n, dtype, seed=0):
    """Blocked-ELL parts of a block-sparse (m, k) A with its last block row
    empty and pad slots filled with 7.0, and a dense (k, n) B: numpy."""
    a = block_sparse_np(m, k, 0.4, seed, empty_row=m // BM - 1)
    values, indices = (np.array(v) for v in j_sp_ref.dense_to_bell(a, BM, BK))
    assert (indices == -1).all(axis=1).any()          # an all-pad block row
    values[indices < 0] = PAD_FILL
    b = np.random.default_rng(seed + 1).standard_normal((k, n)).astype(np.float32)
    return values.astype(_dt(dtype)), indices, b.astype(_dt(dtype))


# ---------------------------------------------------------------------------
# JS
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 37, 150])
def test_jacobi_step_matches_jax(dtype, n):
    a, x, b = js_inputs(n, dtype)
    want = j_js_ops.jacobi_step(jnp.asarray(a), jnp.asarray(x), jnp.asarray(b),
                                interpret=True)
    ta, tx, tb = from_numpy((a, x, b))
    for fn in (t_js_ops.jacobi_step, t_js_ref.jacobi_step_ref,
               t_js_ref.jacobi_step_aten):
        got = fn(ta, tx, tb)
        assert got.dtype == tx.dtype and str(want.dtype) == str(got.dtype).split(".")[-1]
        _close(got, want, dtype, f"{fn.__name__} n={n}")
    # x ≠ 0: the sweep is not b / diag(A)
    assert not np.allclose(_f32(want), _f32(b) / np.diag(_f32(a)), rtol=1e-2)


@pytest.mark.parametrize("n", [48, 130])
def test_jacobi_solve_matches_jax_and_converges(n):
    a, _, b = js_inputs(n, "float32", seed=1)
    want = j_js_ops.jacobi_solve(jnp.asarray(a), jnp.asarray(b), iters=12,
                                 interpret=True)
    ta, tb = from_numpy((a, b))
    got = t_js_ops.jacobi_solve(ta, tb, iters=12)
    _close(got, want, "float32", "jacobi_solve")
    _close(t_js_ref.jacobi_solve_ref(ta, tb, iters=12), want, "float32",
           "jacobi_solve_ref")
    x = to_numpy(got).astype(np.float64)
    resid = np.linalg.norm(a.astype(np.float64) @ x - b) / np.linalg.norm(b)
    assert resid <= 1e-4, resid


def test_jacobi_solve_starts_from_x0():
    a, x0, b = from_numpy(tuple(js_inputs(20, "float32", seed=2)))
    one = t_js_ops.jacobi_step(a, x0, b)
    assert torch.equal(t_js_ops.jacobi_solve(a, b, iters=1, x0=x0), one)
    assert torch.equal(t_js_ops.jacobi_solve(a, b, iters=0, x0=x0), x0)


# ---------------------------------------------------------------------------
# 1DCONV
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,bn", [(1000, 1, None), (3001, 17, None),
                                    (1500, 200, 128)])
def test_conv1d_matches_jax(dtype, n, k, bn):
    """K = 1, the quickstart's 17 taps, and 200 taps over the reference's
    128-wide output tiles (K longer than one tile)."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal(n).astype(np.float32).astype(_dt(dtype))
    w = rng.standard_normal(k).astype(np.float32).astype(_dt(dtype))
    want = j_conv_ops.conv1d(jnp.asarray(x), jnp.asarray(w), bn=bn,
                             interpret=True)
    tx, tw = from_numpy((x, w))
    for fn in (t_conv_ops.conv1d, t_conv_ref.conv1d_ref, t_conv_ref.conv1d_aten):
        got = fn(tx, tw)
        assert got.dtype == tx.dtype and got.shape == (n - k + 1,)
        _close(got, want, dtype, f"{fn.__name__} n={n} k={k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_long_taps_match_jax_ref(dtype):
    """2100 taps: more than the port's 2048-output tile and its 1024-tap
    staging chunk.  Held to the reference's jnp.convolve oracle: its Pallas
    kernel unrolls every tap while tracing, too slow to interpret here."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4500).astype(np.float32).astype(_dt(dtype))
    w = rng.standard_normal(2100).astype(np.float32).astype(_dt(dtype))
    want = j_conv_ref.conv1d_ref(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(w, jnp.float32))
    tx, tw = from_numpy((x, w))
    for fn in (t_conv_ops.conv1d, t_conv_ref.conv1d_aten):
        _close(fn(tx, tw), want, dtype, fn.__name__)


def test_conv1d_ref_sums_taps_in_order():
    """The oracle's float32 arithmetic, which the card kernel reproduces to
    the bit: a rounded product and a rounded add per tap, t = 0 .. K−1."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(300).astype(np.float32)
    w = rng.standard_normal(40).astype(np.float32)
    acc = np.zeros(261, np.float32)
    for t in range(40):
        acc = acc + np.float32(w[t]) * x[t:t + 261]
    got = t_conv_ref.conv1d_ref(*from_numpy((x, w)))
    assert np.array_equal(to_numpy(got), acc)


# ---------------------------------------------------------------------------
# SMMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(256, 256, 200), (192, 128, 70)])
def test_smmm_matches_jax(dtype, m, k, n):
    values, indices, b = smmm_inputs(m, k, n, dtype)
    want = j_sp_ops.smmm(jnp.asarray(values), jnp.asarray(indices),
                         jnp.asarray(b), interpret=True)
    tv, ti, tb = from_numpy((values, indices, b))
    for fn in (t_sp_ops.smmm, t_sp_ref.smmm_bell_ref, t_sp_ref.smmm_aten):
        got = fn(tv, ti, tb)
        assert got.dtype == tb.dtype and got.shape == (m, n)
        _close(got, want, dtype, f"{fn.__name__} {m}x{k}@{k}x{n}")
        # the empty block row gives exact zeros, whatever its pad slots hold
        assert not bool(got[-BM:].any())
    dense = t_sp_ref.bell_to_dense(tv, ti, k)
    _close(t_sp_ref.smmm_ref(dense, tb), want, dtype, "smmm_ref(bell_to_dense)")


def test_smmm_pad_slots_never_reach_the_sum():
    """A pad slot that were read as block 0 would add 7·B[0:bk] to its row."""
    values, indices, b = from_numpy(smmm_inputs(256, 256, 64, "float32"))
    zeroed = values.clone()
    zeroed[indices < 0] = 0.0
    for fn in (t_sp_ops.smmm, t_sp_ref.smmm_bell_ref, t_sp_ref.smmm_aten):
        assert torch.equal(fn(values, indices, b), fn(zeroed, indices, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bell_format_matches_the_reference_bit_for_bit(dtype):
    a = block_sparse_np(256, 384, 0.3, seed=4, empty_row=1).astype(_dt(dtype))
    a[3, 5] = -0.0                                   # a signed zero survives
    jv, ji = (np.asarray(v) for v in j_sp_ref.dense_to_bell(a, BM, BK))
    tv, ti = t_sp_ref.dense_to_bell(from_numpy(a), BM, BK)
    assert ti.dtype == torch.int32 and np.array_equal(to_numpy(ti), ji)
    nv = to_numpy(tv)
    assert nv.dtype == jv.dtype and nv.shape == jv.shape
    assert np.array_equal(nv.view(np.uint8), jv.view(np.uint8))
    jd = np.asarray(j_sp_ref.bell_to_dense(jv, ji, 384))
    td = to_numpy(t_sp_ref.bell_to_dense(tv, ti, 384))
    assert np.array_equal(td.view(np.uint8), jd.view(np.uint8))
    assert np.array_equal(td.astype(np.float32), a.astype(np.float32))


def test_bell_to_dense_adds_repeated_indices_and_skips_pads():
    values = torch.ones(1, 3, 2, 2)
    indices = torch.tensor([[1, 1, -1]], dtype=torch.int32)
    dense = t_sp_ref.bell_to_dense(values, indices, 4)
    assert torch.equal(dense, torch.tensor([[0., 0., 2., 2.]] * 2))


def test_dense_to_bell_refuses_partial_blocks():
    with pytest.raises(ValueError, match="whole number"):
        t_sp_ref.dense_to_bell(torch.ones(100, 128), BM, BK)


def test_random_block_sparse_structure():
    gen = torch.Generator().manual_seed(5)
    a = t_sp_ref.random_block_sparse(gen, 512, 1024, BM, BK, density=0.25)
    blocks = a.reshape(8, BM, 8, BK).permute(0, 2, 1, 3)
    kept = (blocks != 0).any(dim=3).any(dim=2)
    assert a.shape == (512, 1024) and a.dtype == torch.float32
    assert bool(kept[:, 0].all())                     # no empty block row
    assert 0.1 < float(kept[:, 1:].float().mean()) < 0.5
    # a kept block is dense (standard normal entries)
    assert bool((blocks[kept] != 0).all())
    again = t_sp_ref.random_block_sparse(torch.Generator().manual_seed(5),
                                         512, 1024, BM, BK, density=0.25)
    assert torch.equal(a, again)


# ---------------------------------------------------------------------------
# wrapper refusals
# ---------------------------------------------------------------------------
def _sp(idx_dtype=torch.int32, device="cpu"):
    """SMMM operands whose index table has the given type and device."""
    i = torch.zeros(2, 1, dtype=idx_dtype, device=device)
    return torch.ones(2, 1, 4, 8), i, torch.ones(16, 3)


@pytest.mark.parametrize("fn,args,match", [
    (t_js_ops.jacobi_step, (torch.ones(3, 4), torch.ones(4), torch.ones(3)),
     "square"),
    (t_js_ops.jacobi_step, (torch.ones(3, 3), torch.ones(4), torch.ones(3)),
     "sizes differ"),
    (t_js_ops.jacobi_step, (torch.ones(3, 3), torch.ones(3),
                            torch.ones(3, device="meta")), "different devices"),
    (t_conv_ops.conv1d, (torch.ones(5), torch.ones(6)), "1 <= K <= N"),
    (t_conv_ops.conv1d, (torch.ones(5), torch.ones(0)), "1 <= K <= N"),
    (t_conv_ops.conv1d, (torch.ones(5), torch.ones(2, dtype=torch.float16)),
     "share one of"),
    (t_sp_ops.smmm, _sp(idx_dtype=torch.int64), "int32"),
    (t_sp_ops.smmm, _sp(device="meta"), "index table lies on"),
    (t_sp_ops.smmm, (torch.ones(2, 1, 4, 8), torch.zeros(2, 2, dtype=torch.int32),
                     torch.ones(16, 3)), "do not match"),
    (t_sp_ops.smmm, (torch.ones(2, 1, 4, 8), torch.zeros(2, 1, dtype=torch.int32),
                     torch.ones(12, 3)), "whole number of bk"),
])
def test_wrappers_reject_what_the_kernel_does_not_take(fn, args, match):
    with pytest.raises(ValueError, match=match):
        fn(*args)
