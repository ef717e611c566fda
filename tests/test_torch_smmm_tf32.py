"""SMMM's tensor-core kernel on the CPU: its plain model and workspace.

``csrc/spmm.cu`` runs blocked-ELL A @ B by 3×TF32 over the kept blocks: a
split pass writes the TF32 high and low parts of each kept value block and
of B transposed into a workspace padded to whole 64-row tiles and 32-deep
stages (``smmm_workspace_shapes``), and the product kernel sums each
stage's lo·hi + hi·lo + hi·hi into the float32 sums of its block row, slot
by slot.  ``smmm_tf32x3_ref`` models both: against the JAX package's SMMM
(Pallas, interpret mode) under the reference's tolerance and against a
float64 product at the card's float32 ``TOL``; pad slots, whatever they
hold, change no bit of it; models that drop a cross term fall outside that
``TOL``; the workspace's shape and padding at (bm, bk) off 64 and 32 and at
N = 1; the wrappers' refusals.

Tolerances: the reference's conformance ones (tests/test_kernels_property.py:
float32 2e-4, bfloat16 4e-2); against float64 the card's normwise 1e-5
(chip_smoke.py ``TOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import ops as j_sp_ops
from repro.kernels.spmm import ref as j_sp_ref
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.matmul.ref import tf32_split
from repro_torch.kernels.spmm import ops as t_sp_ops
from repro_torch.kernels.spmm import ref as t_sp_ref
from repro_torch.kernels.spmm import spmm as t_sp

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
#: float32 normwise tolerance of SMMM on the card
F32_NORMWISE = 1e-5
PAD_FILL = 7.0


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def bell_inputs(m, k, n, bm, bk, seed=0, density=0.4, pad=PAD_FILL):
    """Blocked-ELL parts of a random block-sparse (m, k) float32 A whose
    block row 0 has no block, pad slots filled with ``pad``, and a dense
    (k, n) B: numpy, built by the JAX package's format helper."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m // bm, k // bk)) < density
    mask[:, 0] = True
    mask[0] = False
    full = np.repeat(np.repeat(mask, bm, axis=0), bk, axis=1)
    a = rng.standard_normal((m, k)).astype(np.float32) * full
    values, indices = (np.array(v) for v in j_sp_ref.dense_to_bell(a, bm, bk))
    assert (indices[0] == -1).all() and (indices >= 0).any()
    values[indices < 0] = pad
    b = rng.standard_normal((k, n)).astype(np.float32)
    return values, indices, b


def _exact(values, indices, b):
    """The float64 product of the blocked-ELL A and B."""
    dense = j_sp_ref.bell_to_dense(values.astype(np.float64), indices, b.shape[0])
    return np.asarray(dense) @ b.astype(np.float64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(256, 256, 200), (192, 384, 70)])
def test_smmm_tf32x3_ref_matches_jax_and_float64(dtype, m, k, n):
    values, indices, b = bell_inputs(m, k, n, 64, 128)
    if dtype == "bfloat16":
        values, b = values.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    want = np.asarray(j_sp_ops.smmm(jnp.asarray(values), jnp.asarray(indices),
                                    jnp.asarray(b), interpret=True), np.float32)
    tv, ti, tb = from_numpy((values, indices, b))
    got = t_sp_ref.smmm_tf32x3_ref(tv, ti, tb)
    assert got.dtype == tb.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32), want, **TOL[dtype])
    assert not got[:64].any()                  # the all-pad block row: exact zeros
    if dtype == "float32":
        assert _normwise(to_numpy(got), _exact(values, indices, b)) <= F32_NORMWISE


@pytest.mark.parametrize("m,k,n,bm,bk", [(200, 120, 70, 100, 40), (64, 128, 1, 32, 128),
                                         (130, 99, 33, 65, 33), (12, 20, 5, 1, 1)])
def test_smmm_tf32x3_ref_off_the_tile_grid_matches_float64(m, k, n, bm, bk):
    """bm and bk off 64 and 32 and N = 1: the split pass pads, and the model
    still meets float32's normwise TOL against float64."""
    values, indices, b = bell_inputs(m, k, n, bm, bk, seed=m + bk)
    got = t_sp_ref.smmm_tf32x3_ref(*from_numpy((values, indices, b)))
    assert tuple(got.shape) == (m, n)
    assert not got[:bm].any()
    assert _normwise(to_numpy(got), _exact(values, indices, b)) <= F32_NORMWISE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_pad_slots_change_no_bit_of_the_model(dtype):
    """A pad slot holds 7.0, NaN or 0: the model's bits do not move (the
    kernel neither splits nor reads a pad slot; a pad read as block 0 would
    add 7·B[0:bk] to its row)."""
    outs = []
    for pad in (PAD_FILL, float("nan"), 0.0):
        values, indices, b = from_numpy(bell_inputs(256, 384, 100, 64, 128, pad=pad))
        outs.append(t_sp_ref.smmm_tf32x3_ref(values.to(dtype), indices, b.to(dtype)))
    assert all(torch.equal(_bits(o), _bits(outs[0])) for o in outs[1:])
    assert not torch.isnan(outs[0]).any()


def test_models_without_a_cross_term_fall_outside_the_float32_tol():
    """The three-product model meets 1e-5 against float64; with the value
    planes' lo zeroed (lo·hi dropped), B^T's lo zeroed (hi·lo dropped) or
    both (hi·hi alone, one TF32 product) it errs by ~1e-4 to ~3e-4, so the
    card's checks catch a kernel that loses either term."""
    values, indices, b = bell_inputs(256, 512, 256, 64, 128, seed=7)
    exact = _exact(values, indices, b)
    tv, ti, tb = from_numpy((values, indices, b))
    ws_v, ws_b = t_sp_ref.smmm_tf32x3_workspace(tv, ti, tb)
    half_v, half_b = ws_v.shape[0] // 2, ws_b.shape[0] // 2

    def err(ws_v, ws_b):
        return _normwise(to_numpy(t_sp_ref.smmm_tf32x3_product(ws_v, ws_b, ti, 64, 2)),
                         exact)

    no_v_lo, no_b_lo = ws_v.clone(), ws_b.clone()
    no_v_lo[half_v:] = torch.where(no_v_lo[half_v:].isnan(), no_v_lo[half_v:], 0.0)
    no_b_lo[half_b:] = 0.0
    assert err(ws_v, ws_b) <= F32_NORMWISE
    assert err(no_v_lo, ws_b) > 10 * F32_NORMWISE
    assert err(ws_v, no_b_lo) > 10 * F32_NORMWISE
    assert err(no_v_lo, no_b_lo) > 10 * F32_NORMWISE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,bm,bk", [(256, 256, 300, 64, 128), (200, 120, 70, 100, 40),
                                         (64, 128, 1, 32, 128), (12, 20, 5, 1, 1)])
def test_workspace_as_the_split_pass_writes_it(dtype, m, k, n, bm, bk):
    """The workspace has the shapes the wrapper allocates
    (``smmm_workspace_shapes``): value planes of bmp × bkp per slot (bm
    rounded up to 64, bk to 32) and B's transposed planes of K/bk·bkp
    columns, zeros in every pad row and column of a kept block and of B^T,
    NaN where a pad slot's planes are never written; float32 takes the hi
    and lo planes of ``tf32_split``, the 16-bit types one plane that holds
    the value exactly."""
    values, indices, b = from_numpy(bell_inputs(m, k, n, bm, bk, seed=bk))
    values, b = values.to(dtype), b.to(dtype)
    planes = t_sp.smmm_planes(dtype)
    assert planes == (2 if dtype == torch.float32 else 1)
    ws_v, ws_b = t_sp_ref.smmm_tf32x3_workspace(values, indices, b)
    nrows, snnz = indices.shape
    (v_rows, bkp), (b_rows, kq) = t_sp.smmm_workspace_shapes(nrows, snnz, bm, bk, k, n,
                                                             planes)
    bmp = -(-bm // 64) * 64
    assert bkp == -(-bk // 32) * 32 and kq == k // bk * bkp
    assert tuple(ws_v.shape) == (v_rows, bkp) == (planes * nrows * snnz * bmp, bkp)
    assert tuple(ws_b.shape) == (b_rows, kq) == (planes * n, kq)
    v = ws_v.reshape(planes, nrows, snnz, bmp, bkp)
    kept = indices >= 0
    assert v[:, ~kept].isnan().all()
    blocks = v[:, kept]
    assert not blocks[..., bm:, :].any() and not blocks[..., bk:].any()
    bt = ws_b.reshape(planes, n, k // bk, bkp)
    assert not bt[..., bk:].any()
    bt = bt[..., :bk].reshape(planes, n, k)
    want_v, want_b = values[kept].float(), b.float().t()
    if planes == 2:
        want_v, want_b = torch.stack(tf32_split(want_v)), torch.stack(tf32_split(want_b))
    assert torch.equal(blocks[..., :bm, :bk].reshape(want_v.shape), want_v)
    assert torch.equal(bt.reshape(want_b.shape), want_b)


def test_explicit_zero_padding_changes_no_bit_of_the_model():
    """bk = 40 padded by the split pass to 64 gives the bits of the same
    product with each block and B's block rows padded to 64 by hand: a pad
    column meets a pad column and adds an exact zero in the same stage."""
    values, indices, b = from_numpy(bell_inputs(200, 120, 70, 100, 40, seed=3))
    padded_v = torch.zeros(values.shape[:3] + (64,))
    padded_v[..., :40] = values
    padded_b = torch.zeros(3, 64, 70)
    padded_b[:, :40] = b.reshape(3, 40, 70)
    got = t_sp_ref.smmm_tf32x3_ref(values, indices, b)
    want = t_sp_ref.smmm_tf32x3_ref(padded_v, indices, padded_b.reshape(192, 70))
    assert torch.equal(_bits(got), _bits(want))


def test_model_sums_slots_in_order_over_a_long_index_row():
    """An index row of 300 slots (a tenth of them pads, block columns
    repeated): the model within float32's TOL of float64."""
    rng = np.random.default_rng(11)
    values = rng.standard_normal((2, 300, 16, 8)).astype(np.float32)
    indices = rng.integers(0, 40, (2, 300)).astype(np.int32)
    indices[:, ::10] = -1
    values[indices < 0] = PAD_FILL
    b = rng.standard_normal((320, 50)).astype(np.float32)
    got = t_sp_ref.smmm_tf32x3_ref(*from_numpy((values, indices, b)))
    assert _normwise(to_numpy(got), _exact(values, indices, b)) <= F32_NORMWISE


def test_smmm_hopper_refuses_host_tensors_and_what_it_does_not_take():
    """Host tensors and every operand ``smmm_problem`` refuses raise before
    any launch; the public op keeps the plain version on the CPU."""
    before = _cuda.launch_counts()
    values, indices, b = from_numpy(bell_inputs(128, 256, 10, 64, 128))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_sp.smmm_hopper(values, indices, b)
    bad = [((values, indices.long(), b), "int32"),
           ((values, indices[:, :1].contiguous(), b), "do not match"),
           ((values, indices, b[:200]), "whole number of bk"),
           ((values, indices, b.double()), "share one of"),
           ((values[0], indices, b), "takes values")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            t_sp.smmm_hopper(*args)
    assert _cuda.launch_counts() == before
    assert torch.equal(t_sp_ops.smmm(values, indices, b),
                       t_sp_ref.smmm_bell_ref(values, indices, b))
