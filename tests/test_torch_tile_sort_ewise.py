"""The launch plans of SORT's tile route and of EW*, and the plain models
that hold the kernels to them, on the CPU.

* ``sort_tile_plan`` puts every place of a row in exactly one slot of one
  thread at every power of two from 1 to 8192, within a block's threads
  and shared memory, and covers every row; ``sort_tile_ref`` (the
  register-resident network in the kernel's steps: slots, lane shuffles,
  shared-memory exchanges) is bit-exact with ``sort_ref`` at every such
  length, ragged ones included, and with the JAX package's ``sort_pallas``
  (interpret mode) at small shapes; with NaN of both signs, ±inf and ±0 it
  holds the plain version's values (±0 compared by value: the model orders
  −0 first) and puts NaN last.
* ``ewise_plan`` writes each of n elements once at ragged n, for aligned
  and unaligned operands; its plain model ``ewise_plan_ref`` leaves no NaN
  where the plan covers and matches ``OP_REFS`` and the JAX package's
  ``ewise_pallas`` (interpret mode) bit for bit; a plan one block short
  leaves exactly the dropped items NaN.

Inputs are numpy arrays from a seed, handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ewise import ops as j_ew_ops
from repro.kernels.sorthist import ops as j_sh_ops
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels.common import next_pow2
from repro_torch.kernels.ewise.ewise import ITEMS, THREADS, EwisePlan, ewise_plan
from repro_torch.kernels.ewise.ref import OP_REFS, ewise_plan_elements, ewise_plan_ref
from repro_torch.kernels.sorthist.ref import sort_ref, sort_tile_ref
from repro_torch.kernels.sorthist.sorthist import SORT_KEYS, SORT_TILE, sort_tile_plan

#: every power of two the tile route takes, and one ragged length below each
PLACES = [1 << p for p in range(SORT_TILE.bit_length())]
LENGTHS = sorted({n for p in PLACES for n in (p, p - 1, p // 2 + 1) if n >= 1})
#: H100's SMs, and one SM (every row in as few blocks as the block allows)
SMS = [132, 1]
#: shared memory a block may use on an H100, and its threads
SMEM_MAX = 232_448
BLOCK_THREADS_MAX = 1024
J_EW = {"mul": j_ew_ops.ewmm, "div": j_ew_ops.ewmd, "add": j_ew_ops.ewadd,
        "sub": j_ew_ops.ewsub}
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _normal(seed, *shape, dtype="float32", shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32) + shift).astype(DTYPES[dtype][0])


# ---------------------------------------------------------------------------
# SORT, tile route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", LENGTHS)
def test_sort_tile_plan_covers_every_place_once_within_the_sm(n, sms):
    for rows in (1, 3, 100, 4096, 65536):
        e, t, r, blocks = plan = sort_tile_plan(rows, n, sms)
        assert plan.places == e * t == next_pow2(n) and 1 <= e <= SORT_KEYS
        assert e & (e - 1) == 0 and t & (t - 1) == 0
        # place t·E + s ↔ (thread t, slot s): each place of the row once
        place = (torch.arange(t)[:, None] * e + torch.arange(e)[None, :]).reshape(-1)
        assert torch.equal(torch.bincount(place, minlength=plan.places),
                           torch.ones(plan.places, dtype=torch.int64))
        # whole warps, within the block's threads and the SM's shared memory
        assert plan.threads % 32 == 0 and plan.threads <= BLOCK_THREADS_MAX
        assert plan.shared_bytes <= SMEM_MAX
        assert plan.shared_bytes == max(0 if t <= 32 else 8 * r * plan.places,
                                        4 * r * (plan.places + plan.places // 32))
        # every row in a block, and no block past the rows
        assert blocks * r >= rows > (blocks - 1) * r


def test_sort_tile_plan_refuses_rows_past_the_tile():
    with pytest.raises(ValueError, match="tile route"):
        sort_tile_plan(3, SORT_TILE + 1, 132)


def test_sort_tile_plan_spreads_few_rows_and_packs_short_ones():
    # a row of 4096 is 8 warps of 16 keys a lane; 256 places are 16 lanes
    assert tuple(sort_tile_plan(4096, 4096, 132)) == (16, 256, 1, 4096)
    assert tuple(sort_tile_plan(65536, 256, 132)) == (16, 16, 8, 8192)
    # few rows take as few a block as keep whole warps
    assert tuple(sort_tile_plan(3, 256, 132)) == (16, 16, 2, 2)
    assert tuple(sort_tile_plan(3, 8192, 132)) == (16, 512, 1, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", LENGTHS)
def test_sort_tile_ref_is_bit_exact_with_sort_ref_at_every_length(n, dtype):
    g = torch.Generator().manual_seed(n)
    x = torch.randn((3, n), generator=g).to(dtype)
    got = sort_tile_ref(x, sort_tile_plan(3, n, 132))
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(sort_ref(x)))


@pytest.mark.parametrize("rows,n", [(100, 100), (37, 256), (70, 600), (9, 1025)])
def test_sort_tile_ref_with_several_rows_a_block_and_duplicates(rows, n):
    g = torch.Generator().manual_seed(rows)
    x = torch.randint(0, 16, (rows, n), generator=g).float()
    plan = sort_tile_plan(rows, n, 132)
    assert torch.equal(_bits(sort_tile_ref(x, plan)), _bits(sort_ref(x)))
    if plan.rows_per_block > 1 or plan.blocks > 1:
        # a plan one block short leaves exactly its rows NaN
        short = plan._replace(blocks=plan.blocks - 1)
        got = sort_tile_ref(x, short)
        live = short.blocks * short.rows_per_block
        assert got[live:].isnan().all() and not got[:live].isnan().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (129,), (200,), (3, 200), (2, 3, 129), (40, 64)],
                         ids=["1", "129", "200", "3x200", "2x3x129", "40x64"])
def test_sort_tile_ref_matches_jax_sort_pallas_bit_for_bit(dtype, shape):
    x = _normal(len(shape) + shape[-1], *shape, dtype=dtype)
    x.reshape(-1)[::7] = x.reshape(-1)[-1]                # duplicates
    want = np.asarray(j_sh_ops.sort(jnp.asarray(x), interpret=True))
    tx = from_numpy(x)
    n = shape[-1]
    got = sort_tile_ref(tx, sort_tile_plan(tx.numel() // n, n, 132))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(
        np.asarray(to_numpy(got), np.float32).view(np.int32),
        np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [8, 100, 129, 600, 2049])
def test_sort_tile_ref_puts_nan_last_beside_infinities_and_zeros(n, dtype):
    g = torch.Generator().manual_seed(n)
    x = torch.randn((2, n), generator=g)
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                             -float("nan")])
    place = torch.randperm(n, generator=g)[:min(n, specials.numel())]
    x[:, place] = specials[:place.numel()]
    x = x.to(dtype)
    got = sort_tile_ref(x, sort_tile_plan(2, n, 132))
    ref = sort_ref(x)
    nans = int(x[0].isnan().sum())
    assert bool(got[:, n - nans:].isnan().all()) and not bool(got[:, :n - nans].isnan().any())
    assert torch.equal(got[:, :n - nans], ref[:, :n - nans])    # ±0 by value
    # the key order puts −0 before +0; every NaN decodes to the one positive
    # float32 NaN (its 16-bit value is what the type's conversion makes of it)
    zeros = got[0][got[0] == 0]
    assert torch.equal(torch.signbit(zeros), torch.sort(torch.signbit(zeros),
                                                        descending=True).values)
    if dtype == torch.float32:
        assert torch.equal(_bits(got[:, n - nans:]), _bits(ref[:, n - nans:]))


# ---------------------------------------------------------------------------
# EW*
# ---------------------------------------------------------------------------
def _boundaries(elems, sms):
    """n at the plan's edges: one element, one item ± 1, one block's items
    ± 1 at U = 1 and at U = 4, and a full card's worth of blocks ± 1."""
    ns = {1, 2}
    for u in ITEMS:
        for items in (1, u * THREADS, u * THREADS * sms):
            ns |= {items * elems - 1, items * elems, items * elems + 1,
                   items * elems + elems - 1}
    return sorted(n for n in ns if n >= 1)


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_ewise_plan_writes_each_element_once(dtype, aligned, sms):
    for n in _boundaries(16 // dtype.itemsize if aligned else 1, sms):
        plan = ewise_plan(n, dtype, aligned, sms)
        assert plan.item_elems == (16 // dtype.itemsize if aligned else 1)
        assert plan.items_per_thread in ITEMS and plan.blocks >= 1
        idx = ewise_plan_elements(n, plan)
        assert torch.equal(torch.bincount(idx, minlength=n),
                           torch.ones(n, dtype=torch.int64)), (n, plan)


def test_ewise_plan_takes_four_items_a_thread_once_the_card_is_full():
    assert ewise_plan(8192 * 8192, torch.float32, True, 132) == EwisePlan(4, 4, 16384)
    assert ewise_plan(8192 * 8192 + 3, torch.float32, False, 132) == EwisePlan(1, 4, 65537)
    assert ewise_plan(1000, torch.bfloat16, True, 132) == EwisePlan(8, 1, 1)
    # U turns to 4 once 4 items a thread still make a block for every SM
    full = 131 * 4 * THREADS * 4
    assert ewise_plan(full, torch.float32, True, 132).items_per_thread == 1
    assert ewise_plan(full + 4, torch.float32, True, 132) == EwisePlan(4, 4, 132)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(OP_REFS))
@pytest.mark.parametrize("shape", [(37, 129), (3, 1029), (1,), (7,)])
def test_ewise_plan_ref_matches_op_refs_and_jax_ewise_pallas(dtype, op, shape):
    a = _normal(1, *shape, dtype=dtype)
    b = _normal(2, *shape, dtype=dtype, shift=3.0)
    ta, tb = from_numpy((a, b))
    want = np.asarray(J_EW[op](jnp.asarray(a), jnp.asarray(b), interpret=True), np.float32)
    for aligned in (True, False):
        for sms in (132, 1):
            plan = ewise_plan(ta.numel(), ta.dtype, aligned, sms)
            got = ewise_plan_ref(ta, tb, op, plan)
            assert not bool(got.isnan().any())
            assert torch.equal(_bits(got), _bits(OP_REFS[op](ta, tb)))
            np.testing.assert_array_equal(
                np.asarray(to_numpy(got), np.float32).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ewise_plan_ref_leaves_nan_where_a_plan_falls_short(dtype):
    n = 4 * THREADS * 8 * 3 + 5
    a = torch.randn(n).to(dtype)
    b = torch.randn(n).to(dtype) + 3
    plan = ewise_plan(n, dtype, True, 2)
    assert plan.items_per_thread == 4 and plan.blocks >= 2
    short = plan._replace(blocks=plan.blocks - 1)
    got = ewise_plan_ref(a, b, "add", short)
    covered = torch.zeros(n, dtype=torch.bool)
    covered[ewise_plan_elements(n, short)] = True
    assert bool(got[~covered].isnan().all()) and not bool(got[covered].isnan().any())
    assert torch.equal(got[covered], (a + b)[covered])
    # the short plan dropped whole items and kept the tail past them
    items = n // plan.item_elems
    assert int((~covered).sum()) == (items - short.blocks * 4 * THREADS) * plan.item_elems
