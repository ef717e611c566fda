"""The Hopper kernels on the card: each against its plain version at small
ragged shapes, plus launch counting, run-to-run reproducibility, and the
runtime's handling of the card (caller's stream, no silent fallback).

Marked ``cuda``; every test skips without a CUDA card of capability 9.0.
This file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core.agents import RuntimeAgent
from repro_torch.core.registry import KernelRecord, KernelRegistry
from repro_torch.kernels import _cuda, register_all
from repro_torch.kernels.conv1d.conv1d import conv1d_hopper
from repro_torch.kernels.conv1d.ref import conv1d_ref
from repro_torch.kernels.embed_grad.embed_grad import embed_grad_hopper
from repro_torch.kernels.embed_grad.ref import CHUNK, embed_grad_ref
from repro_torch.kernels.ewise.ewise import ITEMS, THREADS, ewise_hopper, ewise_plan
from repro_torch.kernels.ewise.ref import OP_REFS, ewise_plan_ref
from repro_torch.kernels.fft.fft import fft_chirp_hopper, fft_radix_hopper
from repro_torch.kernels.fft.ops import cached_chirp_tables, cached_radix_twiddles
from repro_torch.kernels.fft.ref import fft_chirp_ref, fft_radix_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, fa_route, flash_attention_hopper, flash_attention_mma_hopper,
    flash_attention_tf32x3_hopper, flash_attention_wgmma_hopper)
from repro_torch.kernels.flash_attention.ref import (attention_f64, attention_mma_ref,
                                                     attention_ref, attention_tf32x3_ref)
from repro_torch.kernels.fused import (ACC, MAX_INPUTS, MAX_STEPS,
                                       ewise_chain_hopper, ewise_chain_ref)
from repro_torch.kernels.jacobi.jacobi import jacobi_hopper
from repro_torch.kernels.jacobi.ops import jacobi_solve
from repro_torch.kernels.jacobi.ref import jacobi_step_ref
from repro_torch.kernels.matmul.matmul import (SKINNY_M_MAX, mmm_hopper, mmm_route,
                                               mmm_skinny_hopper, mmm_tf32x3_hopper,
                                               mmm_wgmma_hopper, wgmma_packs)
from repro_torch.kernels.matmul.ref import (mmm_ref, mmm_splitk_ref, mmm_tf32x3_ref,
                                            mmm_ulp_excess)
from repro_torch.kernels.mvm.mvm import mvm_hopper
from repro_torch.kernels.mvm.ref import mvm_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_hopper
from repro_torch.kernels.sorthist.ref import (hist_ref, sort_radix_ref, sort_ref,
                                              sort_tile_ref)
from repro_torch.kernels.sorthist import sorthist
from repro_torch.kernels.sorthist.sorthist import (SORT_TILE, hist_hopper, sort_hopper,
                                                   sort_radix_hopper, sort_route,
                                                   sort_tile_hopper, sort_tile_plan)
from repro_torch.kernels.spmm.ref import (bell_to_dense, dense_to_bell,
                                          random_block_sparse, smmm_bell_ref,
                                          smmm_tf32x3_ref)
from repro_torch.kernels.spmm.spmm import smmm_hopper
from repro_torch.kernels.vdp.ref import vdp_ref
from repro_torch.kernels.vdp.vdp import vdp_hopper

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
#: normwise relative error: float32 differs only in summation order; the
#: 16-bit types also round the output (8- or 11-bit mantissa)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
#: FLASH_ATTN's 16-bit tensor-core routes (mma, wgmma) against their plain
#: model, which takes the same 64-key tiles and roundings: only the float32
#: sum order differs.  Readings on the H100: the mma route ≤ 1.8e-4
#: bfloat16, ≤ 6e-5 float16; the wgmma route ≤ 9.0e-5 and ≤ 5.7e-5, and
#: 3.56e-4 and 1.68e-4 over 8192 keys.  A window edge one key off reads
#: ≥ 4e-3 (mma) and 5.66e-3 (wgmma, bfloat16), inside TOL
MMA_MODEL_TOL = {torch.bfloat16: 1e-3, torch.float16: 3e-4}
#: SMMM's tensor-core kernel against its plain model (the same padded
#: workspace and per-stage sums: only the order of a stage's sum differs;
#: readings on the H100 ≤ 3.2e-7 float32, ≤ 2.6e-5 bfloat16, ≤ 1.7e-5
#: float16) and, in float32, against float64 (readings ≤ 5.6e-7)
SMMM_MODEL_TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-3, torch.float16: 3e-4}
SMMM_F64_TOL = 2e-6
#: FLASH_ATTN's float32 tensor-core route (3×TF32) against its plain model
#: (the same head-dim stages, key tiles and 32-key p·v sums: only the order
#: within a tensor-core sum differs) and against float64 (readings on the
#: H100 ≤ 2.5e-7 and ≤ 2.3e-7 at these shapes, ≤ 2.9e-7 and ≤ 3.6e-7 over a
#: row of 8192 keys); a kernel that carries one p·v accumulator over a
#: long row, or drops the lo·hi product of q·kᵀ, errs past them
FA_TF32_MODEL_TOL = 1e-6
FA_TF32_F64_TOL = 1e-6


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of capability 9.0 (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rnd(card, *shape, dtype, seed=0, shift=0.0):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=card) + shift).to(dtype)


def _normwise(k, r):
    k, r = k.double(), r.double()
    return float((k - r).norm() / r.norm().clamp_min(1e-300))


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 129, 70), (128, 256, 128),
                                   (300, 17, 259), (130, 75, 137), (65, 1, 1),
                                   (200, 4095, 3)])
def test_mmm_kernel(card, dtype, m, k, n):
    """Every shape above SKINNY_M_MAX rows on the tensor cores: K and N off
    every multiple of 4 and 8, odd N (the 3×TF32 split pads K, the wgmma
    route packs A and B)."""
    a, b = _rnd(card, m, k, dtype=dtype), _rnd(card, k, n, dtype=dtype, seed=1)
    out = mmm_hopper(a, b)
    assert out.dtype == dtype and out.shape == (m, n)
    assert _normwise(out, mmm_ref(a, b)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(130, 75, 137), (512, 2560, 640)])
def test_mmm_kernel_operands_off_the_grid(card, dtype, m, k, n):
    """A and B one element into their buffers, off the 16-byte grid: the
    3×TF32 split reads them by scalar loads, the wgmma route packs both;
    two calls give the same bits."""
    a = _rnd(card, m * k + 1, dtype=dtype)[1:].view(m, k)
    b = _rnd(card, k * n + 1, dtype=dtype, seed=1)[1:].view(k, n)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    if dtype != torch.float32:
        assert wgmma_packs(k, n, False, False) == (True, True)
    out = mmm_hopper(a, b)
    assert _normwise(out, mmm_ref(a, b)) <= TOL[dtype]
    if dtype != torch.float32:
        assert mmm_ulp_excess(out, a, b) == 0
    assert torch.equal(_bits(out), _bits(mmm_hopper(a, b)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560),
                                 (2560, 32000), (777, 1001), (129, 70), (300, 2564)])
def test_mmm_skinny_kernel(card, dtype, m, k, n):
    """danube's decode projections, then a ragged N (scalar path), a short K
    and an N that is a multiple of 4 but not of 8."""
    a, b = _rnd(card, m, k, dtype=dtype), _rnd(card, k, n, dtype=dtype, seed=1)
    out = mmm_skinny_hopper(a, b)
    assert out.dtype == dtype and out.shape == (m, n)
    assert _normwise(out, mmm_ref(a, b)) <= TOL[dtype]
    assert _normwise(out, mmm_splitk_ref(a, b)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_mmm_skinny_unaligned_and_repeatable(card, dtype):
    """B off the 16-byte grid takes the scalar path; two calls give the same
    bits (the splits are summed in a fixed order)."""
    flat = _rnd(card, 2560 * 640 + 1, dtype=dtype, seed=1)
    b = flat[1:].view(2560, 640)
    assert b.data_ptr() % 16 != 0
    a = _rnd(card, 4, 2560, dtype=dtype)
    out = mmm_skinny_hopper(a, b)
    assert _normwise(out, mmm_ref(a, b)) <= TOL[dtype]
    b = _rnd(card, 2560, 640, dtype=dtype, seed=2)
    assert torch.equal(_bits(mmm_skinny_hopper(a, b)), _bits(mmm_skinny_hopper(a, b)))


def test_mmm_routes_count_apart(card):
    """bfloat16 at M = 1 and SKINNY_M_MAX: the skinny route; at
    SKINNY_M_MAX + 1: the tensor cores, also with an N off TMA's 16-byte
    stride or an A off the 16-byte grid (packed first); past SKINNY_M_MAX
    in float32: the 3×TF32 route."""
    bf16 = torch.bfloat16
    off = _rnd(card, 65 * 64 + 1, dtype=bf16, seed=2)[1:].view(65, 64)
    assert off.data_ptr() % 16
    cases = [(_rnd(card, m, 64, dtype=dt), _rnd(card, 64, n, dtype=dt, seed=1))
             for m, n, dt in ((1, 32, bf16), (SKINNY_M_MAX, 32, bf16),
                              (SKINNY_M_MAX + 1, 32, bf16),
                              (SKINNY_M_MAX + 1, 32, torch.float32),
                              (SKINNY_M_MAX + 1, 36, bf16))]
    cases.append((off, _rnd(card, 64, 32, dtype=bf16, seed=3)))
    before = _cuda.launch_counts()
    for a, b in cases:
        assert _normwise(mmm_hopper(a, b), mmm_ref(a, b)) <= TOL[a.dtype]
    after = _cuda.launch_counts()
    assert after["mmm_skinny"] == before["mmm_skinny"] + 2
    assert after["mmm_wgmma"] == before["mmm_wgmma"] + 3
    assert after["mmm_tf32x3"] == before["mmm_tf32x3"] + 1
    assert "mmm" not in after


#: the tensor-core route's shapes: danube's eight prefill projections
#: (4200 rows: 32 row tiles and 104 rows), ragged M, N and K (TMA
#: zero-fills past each), the template's 4096³, and shapes TMA cannot load
#: as they lie (K or N off a multiple of 8, odd N: packed first)
WGMMA_SHAPES = [(m, k, n) for m in (512, 4200)
                for k, n in ((2560, 2560), (2560, 640), (2560, 6912), (6912, 2560))] \
    + [(130, 72, 136), (65, 8, 8), (4096, 4096, 4096), (130, 75, 137), (4200, 2558, 6910),
       (300, 17, 259), (65, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n", WGMMA_SHAPES)
@pytest.mark.parametrize("tile_n", [None, 128, 256])
def test_mmm_wgmma_kernel(card, dtype, m, k, n, tile_n):
    """Against mmm_ref (TOL) and, element by element, within half an output
    ulp of the float32 product of the same inputs (mmm_ulp_excess), at the
    tile width wgmma_tile_n picks and at each width."""
    a, b = _rnd(card, m, k, dtype=dtype), _rnd(card, k, n, dtype=dtype, seed=1)
    out = mmm_wgmma_hopper(a, b, tile_n=tile_n)
    assert out.dtype == dtype and out.shape == (m, n)
    assert _normwise(out, mmm_ref(a, b)) <= TOL[dtype]
    assert mmm_ulp_excess(out, a, b) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_mmm_wgmma_kernel_is_repeatable(card, dtype):
    """Two calls give the same bits: each output element's K sum runs in one
    fixed order."""
    a, b = _rnd(card, 4200, 2560, dtype=dtype), _rnd(card, 2560, 640, dtype=dtype, seed=1)
    assert torch.equal(_bits(mmm_wgmma_hopper(a, b)), _bits(mmm_wgmma_hopper(a, b)))


#: the 3×TF32 route's shapes: the float32 replay's four 512-row prefill
#: projections, ragged M, N and K that are multiples of 4, M = 65, the
#: template's 4096³, and K and N off the multiple of 4 (the split pass pads
#: K; odd N is stored one value at a time): the lone request's 4096×4094 @
#: 4094×4096 among them
TF32X3_SHAPES = [(512, 2560, 2560), (512, 2560, 640), (512, 2560, 6912), (512, 6912, 2560),
                 (1000, 772, 1004), (130, 72, 136), (65, 2560, 640), (65, 8, 4),
                 (4096, 4096, 4096), (130, 1, 1), (130, 3, 5), (130, 4095, 4094),
                 (1000, 777, 1001), (4096, 4094, 4096)]


@pytest.mark.parametrize("m,k,n", TF32X3_SHAPES)
def test_mmm_tf32x3_kernel(card, m, k, n):
    """float32 within TOL of mmm_ref, of a float64 product and of the plain
    model (the three float32 products of the TF32 parts)."""
    a, b = _rnd(card, m, k, dtype=torch.float32), _rnd(card, k, n, dtype=torch.float32, seed=1)
    out = mmm_tf32x3_hopper(a, b)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    tol = TOL[torch.float32]
    assert _normwise(out, mmm_ref(a, b)) <= tol
    assert _normwise(out, a.double() @ b.double()) <= tol
    assert _normwise(out, mmm_tf32x3_ref(a, b)) <= tol


def test_mmm_tf32x3_kernel_is_repeatable(card):
    """Two calls give the same bits: each output element's K sum runs in one
    fixed order."""
    a = _rnd(card, 512, 6912, dtype=torch.float32)
    b = _rnd(card, 6912, 2560, dtype=torch.float32, seed=1)
    assert torch.equal(_bits(mmm_tf32x3_hopper(a, b)), _bits(mmm_tf32x3_hopper(a, b)))


def _non_finite_operands(card, m, k, n):
    """Normal float32 A (m, k) and B (k, n) with ±inf and NaN entries, and
    ±FLT_MAX entries whose products stay finite (times 1/8 to 1/4) or
    overflow (times 2 to 4), in rows of A and in a column of B.  No
    overflowing product meets an infinite column: whether inf plus an
    overflowed product is inf or NaN then hangs on the sum's order."""
    a, b = _rnd(card, m, k, dtype=torch.float32), _rnd(card, k, n, dtype=torch.float32, seed=1)
    g = torch.Generator(device=card).manual_seed(2)
    big = torch.finfo(torch.float32).max

    def signed(lo, hi, size):
        u = torch.rand(size, generator=g, device=card) * (hi - lo) + lo
        return torch.where(torch.rand(size, generator=g, device=card) < 0.5, -u, u)

    a[1, 5], a[2, 9], a[4, 0] = float("inf"), float("-inf"), float("nan")
    b[7, 3], b[8, 6] = float("inf"), float("-inf")
    a[3, 11], b[11] = big, signed(0.125, 0.25, n)
    a[5, 12], b[12] = -big, signed(2.0, 4.0, n)
    b[12, [3, 6]] = 0.5
    b[13, 10], a[:, 13] = big, signed(0.125, 0.25, m)
    return a, b


@pytest.mark.parametrize("m,k,n", [(130, 72, 136), (512, 2560, 640), (130, 75, 137),
                                   (513, 2558, 641)])
def test_mmm_tf32x3_kernel_keeps_infinities_and_near_max_values(card, m, k, n):
    """With ±inf, NaN and ±FLT_MAX entries: NaN and ±inf where ``mmm_ref``
    has them, and elsewhere each entry within 1e-5 of (|A|·|B|)_ij of the
    float64 product.  A split that rounds ±inf or FLT_MAX into hi makes NaN
    of whole rows and columns."""
    a, b = _non_finite_operands(card, m, k, n)
    out, want = mmm_tf32x3_hopper(a, b), mmm_ref(a, b)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(out), inf) and torch.equal(out[inf], want[inf])
    finite = torch.isfinite(want)
    err = (out.double() - a.double() @ b.double()).abs()
    scale = a.double().abs() @ b.double().abs()
    assert bool((err[finite] <= TOL[torch.float32] * scale[finite]).all())


def test_tensor_map_routes_launch_first_on_a_new_thread(card):
    """The wgmma and 3×TF32 routes encode TMA tensor maps with
    cuTensorMapEncodeTiled, which needs the device's context current on
    the calling thread: each route launches as the first CUDA work of a
    new host thread, as a request's first launch on an agent's worker
    does."""
    import threading

    a32 = _rnd(card, 256, 512, dtype=torch.float32)
    b32 = _rnd(card, 512, 256, dtype=torch.float32, seed=1)
    cases = {"wgmma": (mmm_wgmma_hopper, a32.bfloat16(), b32.bfloat16()),
             "tf32x3": (mmm_tf32x3_hopper, a32, b32)}
    torch.cuda.synchronize(card)
    for route, (fn, a, b) in cases.items():
        result = {}

        def first_launch():
            try:
                result["out"] = fn(a, b)
                torch.cuda.synchronize(card)
            except Exception as e:                # reported by the assert below
                result["error"] = e

        thread = threading.Thread(target=first_launch)
        thread.start()
        thread.join()
        assert "error" not in result, f"{route}: {result.get('error')}"
        assert _normwise(result["out"], mmm_ref(a, b)) <= TOL[a.dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(OP_REFS))
@pytest.mark.parametrize("shape", [(1,), (37, 129), (64, 128), (3, 5, 7)])
def test_ewise_kernel_is_bit_exact(card, dtype, op, shape):
    a = _rnd(card, *shape, dtype=dtype)
    b = _rnd(card, *shape, dtype=dtype, seed=1, shift=3.0)
    out = ewise_hopper(a, b, op)
    assert out.shape == a.shape and out.dtype == dtype
    assert torch.equal(_bits(out), _bits(OP_REFS[op](a, b)))


def _ewise_boundaries(card, dtype):
    """n at the edges of the kernel's plan on this card: one element, one
    16-byte vector ± 1, one block's vectors ± 1 at U = 1 and U = 4, a
    block for every SM at U = 4 ± 1 (where U turns to 4), and 8192² + 3."""
    v = 16 // dtype.itemsize
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    ns = {1, v - 1, v, v + 1, 8192 * 8192 + 3}
    for u in ITEMS:
        for items in (u * THREADS, u * THREADS * sms):
            ns |= {items * v - 1, items * v, items * v + 1}
    return sorted(n for n in ns if n >= 1), sms


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(OP_REFS))
def test_ewise_kernel_at_each_plan_boundary(card, dtype, op):
    # bit-exact with the plain version and with the plan's model, which is
    # NaN wherever the plan does not reach
    ns, sms = _ewise_boundaries(card, dtype)
    for n in ns:
        a = _rnd(card, n, dtype=dtype)
        b = _rnd(card, n, dtype=dtype, seed=1, shift=3.0)
        out = ewise_hopper(a, b, op)
        assert torch.equal(_bits(out), _bits(OP_REFS[op](a, b))), n
        plan = ewise_plan(n, dtype, True, sms)
        assert torch.equal(_bits(out), _bits(ewise_plan_ref(a, b, op, plan))), (n, plan)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ewise_kernel_unaligned_views(card, dtype):
    a = _rnd(card, 1001, dtype=dtype)[1:]
    b = _rnd(card, 1001, dtype=dtype, seed=1, shift=3.0)[1:]
    assert a.data_ptr() % 16 != 0
    for op, ref in OP_REFS.items():
        assert torch.equal(_bits(ewise_hopper(a, b, op)), _bits(ref(a, b)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k", [(1, 1), (37, 129), (64, 128), (100, 776)])
def test_mvm_kernel(card, dtype, m, k):
    a, x = _rnd(card, m, k, dtype=dtype), _rnd(card, k, dtype=dtype, seed=1)
    out = mvm_hopper(a, x)
    assert out.dtype == dtype and out.shape == (m,)
    assert _normwise(out, mvm_ref(a, x)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 7, 1024, 100_003])
def test_vdp_kernel(card, dtype, n):
    # integers in {1, 2}: every partial sum is an integer below 2^24, so any
    # summation order is exact and each element dropped or counted twice
    # moves the result by at least 1
    g = torch.Generator(device=card).manual_seed(2)
    x = (1 + (torch.rand(n, generator=g, device=card) < 0.5).float()).to(dtype)
    y = (1 + (torch.rand(n, generator=g, device=card) < 0.5).float()).to(dtype)
    out = vdp_hopper(x, y)
    assert out.dtype == torch.float32 and out.shape == ()
    assert float(out) == float((x.double() * y.double()).sum())
    assert torch.equal(out, vdp_ref(x, y))
    # mean 2: Σxy is of the order of ‖x‖‖y‖, so |k − r| / |r| is the dot
    # product's own relative error; the output is float32 and 16-bit
    # products are exact in float32, so every type differs only in the
    # order of float32 additions
    x = _rnd(card, n, dtype=dtype, shift=2.0)
    y = _rnd(card, n, dtype=dtype, seed=1, shift=2.0)
    out, ref = vdp_hopper(x, y).double(), vdp_ref(x, y).double()
    assert float((out - ref).abs() / ref.abs()) <= 1e-5
    assert all(torch.equal(vdp_hopper(x, y), vdp_hopper(x, y)) for _ in range(3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 37, 130, 1000])
def test_jacobi_kernel(card, dtype, n):
    # A + n·I with x ≠ 0: with x = 0 a kernel that skips A·x would pass
    a = _rnd(card, n, n, dtype=torch.float32)
    a.diagonal().add_(float(n))
    a = a.to(dtype)
    x, b = _rnd(card, n, dtype=dtype, seed=1), _rnd(card, n, dtype=dtype, seed=2)
    out = jacobi_hopper(a, x, b)
    assert out.dtype == dtype and out.shape == (n,)
    # against the exact sweep: the kernel leaves the diagonal out of its
    # float32 sum, so nothing cancels; the 16-bit types also round x'
    a64, x64, b64 = a.double(), x.double(), b.double()
    d = a64.diagonal()
    exact = (b64 - (a64 @ x64 - d * x64)) / d
    assert _normwise(out, exact) <= TOL[dtype]
    # the plain version cancels the diagonal after its sum and errs more:
    # the kernel agrees with it within TOL plus that error
    ref = jacobi_step_ref(a, x, b)
    scale = exact.norm()
    assert float((out.double() - ref.double()).norm() / scale) \
        <= TOL[dtype] + float((ref.double() - exact).norm() / scale)


def test_jacobi_solve_on_the_card_converges(card):
    n = 1000
    a = _rnd(card, n, n, dtype=torch.float32)
    a.diagonal().add_(float(n))
    b = _rnd(card, n, dtype=torch.float32, seed=1)
    before = _cuda.launch_counts()["jacobi"]
    x = jacobi_solve(a, b, iters=30)
    assert _cuda.launch_counts()["jacobi"] == before + 30
    resid = (a.double() @ x.double() - b.double()).norm() / b.double().norm()
    assert float(resid) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k", [(1, 1), (100, 1), (5000, 17), (2048 + 17, 17),
                                 (5000, 1025), (9000, 4097), (3000, 3000)])
def test_conv1d_kernel_is_bit_exact(card, dtype, n, k):
    # the kernel sums the taps in the plain version's order with its
    # roundings, so the two agree to the bit; 4097 taps span five staged
    # chunks, and 2048 + 17 leaves a last tile of one output
    x, w = _rnd(card, n, dtype=dtype), _rnd(card, k, dtype=dtype, seed=1)
    out = conv1d_hopper(x, w)
    assert out.dtype == dtype and out.shape == (n - k + 1,)
    assert torch.equal(_bits(out), _bits(conv1d_ref(x, w)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n,bm,bk", [(256, 256, 200, 64, 128),
                                         (384, 256, 300, 128, 64),
                                         (200, 120, 70, 100, 40),
                                         (64, 128, 1, 32, 128),
                                         (390, 99, 257, 65, 33)])
def test_smmm_kernel(card, dtype, m, k, n, bm, bk):
    """Pad slots hold 7.0 and block row 0 only pads (exactly 0 out); within
    TOL of the plain version, SMMM_MODEL_TOL of the 3×TF32 model and, in
    float32, SMMM_F64_TOL of float64, with bm and bk off 64 and 32 and N
    off the 256-column tile or 1."""
    gen = torch.Generator(device=card).manual_seed(3)
    a = random_block_sparse(gen, m, k, bm, bk, density=0.4)
    a[:bm] = 0                                   # block row 0: only pad slots
    values, indices = dense_to_bell(a.to(dtype), bm, bk)
    values[indices < 0] = 7.0                    # a pad slot read would show
    b = _rnd(card, k, n, dtype=dtype, seed=4)
    out = smmm_hopper(values, indices, b)
    assert out.dtype == dtype and out.shape == (m // bm * bm, n)
    assert not bool(out[:bm].any())              # exactly 0
    assert _normwise(out, smmm_bell_ref(values, indices, b)) <= TOL[dtype]
    assert _normwise(out, smmm_tf32x3_ref(values, indices, b)) <= SMMM_MODEL_TOL[dtype]
    if dtype == torch.float32:
        exact = bell_to_dense(values, indices, k).double() @ b.double()
        assert _normwise(out, exact) <= SMMM_F64_TOL


def _long_row(card, dtype):
    """Three block rows of 1100 slots of 16x8 blocks, a tenth of them pads
    holding 7.0, block columns repeated, and a 9600 x 300 B."""
    g = torch.Generator(device=card).manual_seed(5)
    values = torch.randn((3, 1100, 16, 8), generator=g, device=card).to(dtype)
    indices = torch.randint(0, 1200, (3, 1100), generator=g, device=card, dtype=torch.int32)
    indices[:, ::10] = -1
    values[indices < 0] = 7.0
    return values, indices, _rnd(card, 9600, 300, dtype=dtype, seed=6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_smmm_kernel_over_a_long_index_row(card, dtype):
    """1100 slots a row, far past a warp's ballot of 32: producer and
    consumers walk the same stages, and each 32-deep stage's sum starts
    afresh (one tensor-core accumulator over the row's ~990 stages errs
    past SMMM_F64_TOL)."""
    values, indices, b = _long_row(card, dtype)
    out = smmm_hopper(values, indices, b)
    assert _normwise(out, smmm_bell_ref(values, indices, b)) <= TOL[dtype]
    assert _normwise(out, smmm_tf32x3_ref(values, indices, b)) <= SMMM_MODEL_TOL[dtype]
    if dtype == torch.float32:
        exact = bell_to_dense(values, indices, 9600).double() @ b.double()
        assert _normwise(out, exact) <= SMMM_F64_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_smmm_kernel_is_repeatable(card, dtype):
    """Two calls give the same bits: slots and stages are summed in one
    fixed order."""
    values, indices, b = _long_row(card, dtype)
    assert torch.equal(_bits(smmm_hopper(values, indices, b)),
                       _bits(smmm_hopper(values, indices, b)))


def test_smmm_kernel_keeps_infinities_and_nan(card):
    """±inf and NaN in kept blocks and in B: NaN and ±inf where the plain
    version has them, and elsewhere each entry within 1e-5 of the kept
    slots' (|A|·|B|)_ij.  A split that put ±inf in hi would meet the other
    operand's lo and make NaN."""
    gen = torch.Generator(device=card).manual_seed(7)
    a = random_block_sparse(gen, 512, 1024, 64, 128, density=0.4)
    values, indices = dense_to_bell(a, 64, 128)
    b = _rnd(card, 1024, 300, dtype=torch.float32, seed=8)
    rows, slots = (indices >= 0).nonzero(as_tuple=True)
    for j, x in enumerate((float("inf"), float("-inf"), float("nan"))):
        values[rows[5 * j], slots[5 * j], 3 + j, 9 + j] = x
    b[300, 20], b[700, 200] = float("inf"), float("-inf")
    out, want = smmm_hopper(values, indices, b), smmm_bell_ref(values, indices, b)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(out), inf) and torch.equal(out[inf], want[inf])
    b3 = b.double().reshape(8, 128, 300)
    err = scale = 0
    for s in range(indices.shape[1]):
        idx = indices[:, s].long()
        keep = (idx >= 0)[:, None, None]
        v, g = values[:, s].double(), b3[idx.clamp(min=0)]
        err = err + torch.where(keep, v @ g, 0.0)
        scale = scale + torch.where(keep, v.abs() @ g.abs(), 0.0)
    err, scale = (out.double() - err.reshape(512, 300)).abs(), scale.reshape(512, 300)
    finite = torch.isfinite(want)
    assert bool((err[finite] <= TOL[torch.float32] * scale[finite]).all())


def test_smmm_kernel_launches_first_on_a_new_thread(card):
    """SMMM encodes TMA tensor maps, which needs the device's context
    current on the calling thread: it launches as the first CUDA work of a
    new host thread, as a request's first launch on an agent's worker does."""
    import threading

    values, indices, b = _long_row(card, torch.float32)
    torch.cuda.synchronize(card)
    result = {}

    def first_launch():
        try:
            result["out"] = smmm_hopper(values, indices, b)
            torch.cuda.synchronize(card)
        except Exception as e:                    # reported by the assert below
            result["error"] = e

    thread = threading.Thread(target=first_launch)
    thread.start()
    thread.join()
    assert "error" not in result, result.get("error")
    assert _normwise(result["out"], smmm_bell_ref(values, indices, b)) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 7, 100, 1000, 2999, 3000, 4093, 4095])
def test_fft_chirp_kernel(card, dtype, n):
    """Lengths that are not powers of two, the primes 2999 and 4093
    included: normwise 1e-5 against the float64 DFT and against the plain
    version (the same steps in the same order), 1-D, 3 rows and more rows
    than a block holds, and an x off the 16-byte grid; two calls give the
    same bits."""
    tables = cached_chirp_tables(n, card)
    unaligned = _rnd(card, 3 * n + 1, dtype=dtype, seed=2)[1:].view(3, n)
    for x in (_rnd(card, n, dtype=dtype), _rnd(card, 3, n, dtype=dtype, seed=1),
              _rnd(card, 1030, n, dtype=dtype, seed=3), unaligned):
        out = fft_chirp_hopper(x, tables)
        assert out.dtype == torch.complex64 and out.shape == x.shape
        wide = out.to(torch.complex128)
        exact = torch.fft.fft(x.double(), dim=-1)
        assert float((wide - exact).norm() / exact.norm()) <= 1e-5
        ref = fft_chirp_ref(x, tables).to(torch.complex128)
        assert float((wide - ref).norm() / ref.norm()) <= 1e-5
    assert torch.equal(torch.view_as_real(out), torch.view_as_real(fft_chirp_hopper(x, tables)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("j", range(13))
def test_fft_radix_kernel(card, dtype, j):
    """Every power of two: normwise 1e-5 against the float64 DFT and against
    the plain version (the same stages in the same order), 1-D, 3 rows and
    more rows than a block holds, and an x off the 16-byte grid."""
    n = 1 << j
    tw = cached_radix_twiddles(n, card)
    unaligned = _rnd(card, 3 * n + 1, dtype=dtype, seed=2)[1:].view(3, n)
    for x in (_rnd(card, n, dtype=dtype), _rnd(card, 3, n, dtype=dtype, seed=1),
              _rnd(card, 1030, n, dtype=dtype, seed=3), unaligned):
        out = fft_radix_hopper(x, tw)
        assert out.dtype == torch.complex64 and out.shape == x.shape
        wide = out.to(torch.complex128)
        exact = torch.fft.fft(x.double(), dim=-1)
        assert float((wide - exact).norm() / exact.norm()) <= 1e-5
        ref = fft_radix_ref(x, tw).to(torch.complex128)
        assert float((wide - ref).norm() / ref.norm()) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1,), (2,), (129,), (3, 8192), (2, 8193),
                                   (4, 70_000), (2, 3, 1000)])
def test_sort_kernel_is_bit_exact(card, dtype, shape):
    # 8192 places fit one shared-memory tile; 8193 and 70 000 take the radix
    # route; integers give duplicates
    x = _rnd(card, *shape, dtype=dtype)
    out = sort_hopper(x)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(_bits(out), _bits(sort_ref(x)))
    g = torch.Generator(device=card).manual_seed(5)
    d = torch.randint(0, 9, shape, generator=g, device=card).to(dtype)
    assert torch.equal(_bits(sort_hopper(d)), _bits(sort_ref(d)))


#: every power of two the tile route takes, and one ragged length below each
TILE_LENGTHS = sorted({n for p in range(SORT_TILE.bit_length())
                       for n in (1 << p, (1 << p) - 1) if n >= 1})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", TILE_LENGTHS)
def test_sort_tile_kernel_at_each_plan_shape(card, dtype, n):
    # 3 rows at every length, and as many rows as fill several blocks of
    # several rows: bit-exact with the plain version and the plan's model,
    # and two calls give the same bits
    for rows in (3, 300):
        x = _rnd(card, rows, n, dtype=dtype, seed=n)
        out = sort_tile_hopper(x)
        assert out.dtype == dtype and out.shape == x.shape
        assert torch.equal(_bits(out), _bits(sort_ref(x)))
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        assert torch.equal(_bits(out), _bits(sort_tile_ref(x, sort_tile_plan(rows, n, sms))))
        assert torch.equal(_bits(out), _bits(sort_tile_hopper(x)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [100, 256, 4096, 8192])
def test_sort_tile_kernel_unaligned_rows_and_specials(card, dtype, n):
    # rows off the 16-byte grid load by scalars; NaN of both signs, ±inf
    # and ±0 bit-exact with the model (−0 before +0), by value with the
    # plain version; duplicates
    vals = _rnd(card, 3, n, dtype=torch.float32)
    vals[:, [3, 7, 11, 20, 30, 40]] = torch.tensor(
        [float("nan"), float("inf"), float("-inf"), -0.0, 0.0, -float("nan")],
        device=card)
    flat = torch.empty(3 * n + 1, dtype=dtype, device=card)
    flat[1:] = vals.reshape(-1).to(dtype)
    x = flat[1:].view(3, n)
    assert x.data_ptr() % 16 != 0
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    out, ref = sort_tile_hopper(x), sort_ref(x)
    assert torch.equal(_bits(out), _bits(sort_tile_ref(x, sort_tile_plan(3, n, sms))))
    assert bool(((out == ref) | (out.isnan() & ref.isnan())).all())
    assert torch.equal(_bits(out), _bits(sort_tile_hopper(x)))
    g = torch.Generator(device=card).manual_seed(5)
    d = torch.randint(0, 9, (3 * n + 1,), generator=g, device=card).to(dtype)[1:].view(3, n)
    assert torch.equal(_bits(sort_tile_hopper(d)), _bits(sort_ref(d)))


def _radix_rows(card, dtype, shape, kind):
    g = torch.Generator(device=card).manual_seed(7)
    if kind == "normal":
        return torch.randn(shape, generator=g, device=card).to(dtype)
    if kind == "integers":       # the low digits are constant in every type
        return torch.randint(0, 16, shape, generator=g, device=card).to(dtype)
    if kind == "negative":
        return (-1.0 - torch.rand(shape, generator=g, device=card)).to(dtype)
    return torch.full(shape, -0.75, device=card).to(dtype)   # every pass skipped


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1,), (129,), (3, 4096), (2, 4097), (2, 8193),
                                   (3, 70_001), (2, 3, 1000)])
@pytest.mark.parametrize("kind", ["normal", "integers", "negative", "constant"])
def test_sort_radix_kernel_is_bit_exact(card, dtype, shape, kind):
    # the radix route at any row length: bit-exact with the plain version,
    # with its plain model, and with the tile route where both take the row
    x = _radix_rows(card, dtype, shape, kind)
    out = sort_radix_hopper(x)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(_bits(out), _bits(sort_ref(x)))
    assert torch.equal(_bits(out), _bits(sort_radix_ref(x)))
    if sort_route(shape[-1]) == "tile":
        assert torch.equal(_bits(out), _bits(sort_tile_hopper(x)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_radix_kernel_unaligned_rows(card, dtype):
    # rows off the 16-byte grid load by scalars; two calls give the same bits
    x = _rnd(card, 3 * 20_001 + 1, dtype=dtype)[1:].view(3, 20_001)
    assert x.data_ptr() % 16 != 0
    out = sort_radix_hopper(x)
    assert torch.equal(_bits(out), _bits(sort_ref(x)))
    assert torch.equal(_bits(out), _bits(sort_radix_hopper(x)))


def test_sort_kernel_refuses_a_short_key_buffer(card, monkeypatch):
    # the radix route sorts through key buffers and count tables the wrapper
    # allocates; were the wrapper to ask for less than the kernel needs, the
    # kernel refuses the buffers rather than write past them
    x = _rnd(card, 2, 8193, dtype=torch.float32)
    keys_len, tables_len = sorthist.radix_scratch(2, 8193)
    for short in ((keys_len - 1, tables_len), (keys_len, tables_len - 1)):
        monkeypatch.setattr(sorthist, "radix_scratch", lambda rows, n, s=short: s)
        with pytest.raises(RuntimeError, match="sort_radix kernel launch failed"):
            sort_radix_hopper(x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [100, 9000])
def test_sort_kernel_puts_nan_last(card, dtype, n):
    x = _rnd(card, 3, n, dtype=torch.float32)
    x[:, [3, 7, 11, 20, 30, 40]] = torch.tensor(
        [float("nan"), float("inf"), float("-inf"), -0.0, 0.0, -float("nan")],
        device=card)
    x = x.to(dtype)
    out, ref = sort_hopper(x), sort_ref(x)
    assert bool(((out == ref) | (out.isnan() & ref.isnan())).all())
    assert bool(out[:, -2:].isnan().all()) and not bool(out[:, :-2].isnan().any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bins,lo,hi", [(1, 0.0, 1.0), (64, 0.0, 1.0),
                                        (1000, 0.0, 1.0), (7, -2.0, 3.0),
                                        (20_000, -1.0, 1.0)])
def test_hist_kernel_is_bit_exact(card, dtype, bins, lo, hi):
    # every bin edge, a step either side, the range ends, NaN and ±inf, and
    # uniform values; 20 000 bins do not fit shared memory and count in
    # global memory; the counts are integers, so any atomic order agrees
    f32 = dict(dtype=torch.float32, device=card)
    k = torch.arange(bins + 1, **f32)
    edges = torch.tensor(lo, **f32) + k * torch.tensor((hi - lo) / bins, **f32)
    inf = torch.tensor(float("inf"), **f32)
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.cat([edges, torch.nextafter(edges, inf), torch.nextafter(edges, -inf),
                   torch.tensor([lo, hi, float("nan"), float("inf"),
                                 float("-inf"), lo - 1.0], **f32),
                   torch.rand(300_001, generator=g, **f32) * (hi - lo + 2) + lo - 1])
    x = x.to(dtype)
    out = hist_hopper(x, bins=bins, lo=lo, hi=hi)
    assert out.dtype == torch.float32 and out.shape == (bins,)
    assert torch.equal(out, hist_ref(x, bins=bins, lo=lo, hi=hi))
    one = torch.full((100_000,), 0.3, device=card).to(dtype)
    assert torch.equal(hist_hopper(one), hist_ref(one))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (3, 80), (7, 1000), (5, 1025),
                                   (4, 2560), (2, 3, 4097), (3, 8192), (1, 2560),
                                   (512, 2560), (4096, 2560), (4200, 2560)])
def test_rmsnorm_kernel(card, dtype, shape):
    # rows that fill whole 16-byte vectors (80, 1000, 2560, 8192) take the
    # rows kernel under the launch plan, 1 to 8 warps a row; the others (1,
    # 1025, 4097) take one block per row; two calls give the same bits
    x = _rnd(card, *shape, dtype=dtype, shift=0.5)
    g = _rnd(card, shape[-1], dtype=dtype, seed=1, shift=1.0)
    out = rmsnorm_hopper(x, g, 1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    assert _normwise(out, rmsnorm_ref(x, g, 1e-5)) <= TOL[dtype]
    assert torch.equal(_bits(out), _bits(rmsnorm_hopper(x, g, 1e-5)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [4, 512, 4200])
@pytest.mark.parametrize("d", [80, 512, 1000, 2560])
def test_rmsnorm_kernel_at_every_width(card, dtype, rows, d):
    """The path's row counts at widths where the launch plan picks each of
    1, 2, 4 and 8 warps a row in every type (tests/test_torch_model.py
    checks the plans reach them all): the warps of a row add their sums in
    a fixed order."""
    x = _rnd(card, rows, d, dtype=dtype, shift=0.5)
    g = _rnd(card, d, dtype=dtype, seed=1, shift=1.0)
    out = rmsnorm_hopper(x, g, 1e-5)
    assert _normwise(out, rmsnorm_ref(x, g, 1e-5)) <= TOL[dtype]
    assert torch.equal(_bits(out), _bits(rmsnorm_hopper(x, g, 1e-5)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_unaligned_rows(card, dtype):
    empty = _rnd(card, 0, 1000, dtype=dtype)
    assert rmsnorm_hopper(empty, _rnd(card, 1000, dtype=dtype)).numel() == 0
    big = _rnd(card, 64 * 999 + 1, dtype=dtype)
    x = big[1:].view(64, 999)          # rows off the 16-byte grid
    assert x.data_ptr() % 16 != 0
    g = _rnd(card, 999, dtype=dtype, seed=1)
    assert _normwise(rmsnorm_hopper(x, g), rmsnorm_ref(x, g)) <= TOL[dtype]


FA_CASES = {
    "causal": dict(sq=200, skv=200, causal=True, window=None, prefix_len=0),
    "window": dict(sq=200, skv=200, causal=True, window=37, prefix_len=0),
    "prefix+window": dict(sq=200, skv=200, causal=True, window=37, prefix_len=70),
    "sq<skv": dict(sq=17, skv=300, causal=True, window=None, prefix_len=0),
    "sq<skv window": dict(sq=65, skv=300, causal=True, window=100, prefix_len=0),
    "bidirectional": dict(sq=130, skv=130, causal=False, window=None, prefix_len=0),
    "no key seen": dict(sq=100, skv=30, causal=True, window=None, prefix_len=0),
    # the last query tile is row 128 alone, whose last key opens a key tile
    "one past a tile": dict(sq=129, skv=129, causal=True, window=None, prefix_len=0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [32, 80, 128, 256])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_kernel(card, dtype, d, case):
    # 8 query heads over 2 KV heads; ragged tiles everywhere.  "no key
    # seen": query rows 0-69 sit before every key and get the mean of v,
    # as attention_ref gives it.  v has mean 1, so the output is no
    # near-cancelling sum whose float32 reordering alone errs by ~1e-5.
    # The route fa_route picks (mma for 16-bit types up to d = 128, wgmma at
    # d = 256, tf32x3 for float32)
    c = FA_CASES[case]
    q = _rnd(card, 2, 8, c["sq"], d, dtype=dtype)
    k = _rnd(card, 2, 2, c["skv"], d, dtype=dtype, seed=1)
    v = _rnd(card, 2, 2, c["skv"], d, dtype=dtype, seed=2, shift=1.0)
    kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
    out = flash_attention_hopper(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    assert _normwise(out, attention_ref(q, k, v, **kw)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 80, 128])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_mma_kernel(card, dtype, d, case):
    # the tensor-core route: within TOL of the plain version, and within
    # MMA_MODEL_TOL of its plain model (the same tiles, p rounded to the
    # input type)
    c = FA_CASES[case]
    q = _rnd(card, 2, 8, c["sq"], d, dtype=dtype)
    k = _rnd(card, 2, 2, c["skv"], d, dtype=dtype, seed=1)
    v = _rnd(card, 2, 2, c["skv"], d, dtype=dtype, seed=2, shift=1.0)
    kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
    out = flash_attention_mma_hopper(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    assert _normwise(out, attention_ref(q, k, v, **kw)) <= TOL[dtype]
    assert _normwise(out, attention_mma_ref(q, k, v, **kw)) <= MMA_MODEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_wgmma_kernel(card, dtype, case):
    # the wgmma route (head dim 256): within TOL of the plain version, and
    # within MMA_MODEL_TOL of its plain model (64-key tiles, p rounded to
    # the input type)
    c = FA_CASES[case]
    q = _rnd(card, 2, 8, c["sq"], 256, dtype=dtype)
    k = _rnd(card, 2, 2, c["skv"], 256, dtype=dtype, seed=1)
    v = _rnd(card, 2, 2, c["skv"], 256, dtype=dtype, seed=2, shift=1.0)
    kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
    out = flash_attention_wgmma_hopper(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    assert _normwise(out, attention_ref(q, k, v, **kw)) <= TOL[dtype]
    assert _normwise(out, attention_mma_ref(q, k, v, tile=64, **kw)) <= MMA_MODEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_wgmma_kernel_is_repeatable(card, dtype):
    # key tiles in order, no atomics: the same bits
    q = _rnd(card, 1, 8, 300, 256, dtype=dtype)
    k = _rnd(card, 1, 4, 300, 256, dtype=dtype, seed=1)
    v = _rnd(card, 1, 4, 300, 256, dtype=dtype, seed=2, shift=1.0)
    out = flash_attention_wgmma_hopper(q, k, v, window=100, prefix_len=20)
    assert torch.equal(_bits(out), _bits(
        flash_attention_wgmma_hopper(q, k, v, window=100, prefix_len=20)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("off", ["q", "k", "v", "all"])
def test_flash_attention_wgmma_kernel_unaligned_views(card, dtype, off):
    # TMA loads from a 16-byte base only: an operand off the grid is first
    # copied to an aligned workspace
    def view(h, s, seed, shift=0.0, skew=False):
        n = 2 * h * s * 256
        t = _rnd(card, n + 1, dtype=dtype, seed=seed, shift=shift)
        return (t[1:] if skew else t[:n]).view(2, h, s, 256)
    q = view(8, 150, 0, skew=off in ("q", "all"))
    k = view(2, 150, 1, skew=off in ("k", "all"))
    v = view(2, 150, 2, 1.0, skew=off in ("v", "all"))
    assert sum(t.data_ptr() % 16 != 0 for t in (q, k, v)) == (3 if off == "all" else 1)
    out = flash_attention_wgmma_hopper(q, k, v, window=37)
    assert _normwise(out, attention_ref(q, k, v, window=37)) <= TOL[dtype]
    assert _normwise(out, attention_mma_ref(q, k, v, window=37)) <= MMA_MODEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_wgmma_kernel_over_a_long_row(card, dtype):
    # every query row sees all 8192 keys: 128 key tiles through the ring
    q = _rnd(card, 1, 4, 128, 256, dtype=dtype, seed=3)
    k = _rnd(card, 1, 2, 8192, 256, dtype=dtype, seed=4)
    v = _rnd(card, 1, 2, 8192, 256, dtype=dtype, seed=5, shift=1.0)
    out = flash_attention_wgmma_hopper(q, k, v, causal=False)
    assert _normwise(out, attention_ref(q, k, v, causal=False)) <= TOL[dtype]
    assert _normwise(out, attention_mma_ref(q, k, v, causal=False)) <= MMA_MODEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_wgmma_kernel_reads_no_other_heads_keys(card, dtype):
    # NaN in column 7 of KV head 1's first key: query heads 2-3 see it (NaN
    # in column 7, as in the model); heads 0-1 must not, though their last
    # key tile runs past Skv = 150, where the rows read must be zeros and not
    # KV head 1's first keys
    q = _rnd(card, 1, 4, 150, 256, dtype=dtype, seed=6)
    k = _rnd(card, 1, 2, 150, 256, dtype=dtype, seed=7)
    v = _rnd(card, 1, 2, 150, 256, dtype=dtype, seed=8, shift=1.0)
    v[:, 1, 0, 7] = float("nan")
    out, want = flash_attention_wgmma_hopper(q, k, v), attention_mma_ref(q, k, v)
    assert torch.isnan(want[:, 2:, :, 7]).all() and not torch.isnan(want[:, :2]).any()
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert _normwise(out[:, :2], want[:, :2]) <= MMA_MODEL_TOL[dtype]


def test_flash_attention_wgmma_kernel_launches_first_on_a_new_thread(card):
    """The wgmma FLASH_ATTN encodes TMA tensor maps with
    cuTensorMapEncodeTiled, which needs the device's context current on
    the calling thread: it launches as the first CUDA work of a new host
    thread, as a request's first launch on an agent's worker does."""
    import threading

    q = _rnd(card, 1, 8, 200, 256, dtype=torch.bfloat16)
    k = _rnd(card, 1, 4, 200, 256, dtype=torch.bfloat16, seed=1)
    v = _rnd(card, 1, 4, 200, 256, dtype=torch.bfloat16, seed=2, shift=1.0)
    torch.cuda.synchronize(card)
    result = {}

    def first_launch():
        try:
            result["out"] = flash_attention_wgmma_hopper(q, k, v, window=64)
            torch.cuda.synchronize(card)
        except Exception as e:                # reported by the assert below
            result["error"] = e

    thread = threading.Thread(target=first_launch)
    thread.start()
    thread.join()
    assert "error" not in result, result.get("error")
    assert _normwise(result["out"], attention_ref(q, k, v, window=64)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_mma_kernel_unaligned_views(card, dtype):
    # operands off the 16-byte grid are staged by plain loads
    def view(h, s, seed, shift=0.0):
        n = 2 * h * s * 80
        return _rnd(card, n + 1, dtype=dtype, seed=seed, shift=shift)[1:].view(2, h, s, 80)
    q, k, v = view(8, 150, 0), view(2, 150, 1), view(2, 150, 2, 1.0)
    assert q.data_ptr() % 16 != 0
    out = flash_attention_mma_hopper(q, k, v, window=37)
    assert _normwise(out, attention_ref(q, k, v, window=37)) <= TOL[dtype]
    assert _normwise(out, attention_mma_ref(q, k, v, window=37)) <= MMA_MODEL_TOL[dtype]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_tf32x3_kernel(card, d, case):
    # float32 by 3×TF32 on the tensor cores: within TOL of the plain
    # version, FA_TF32_MODEL_TOL of its plain model, FA_TF32_F64_TOL of
    # float64
    c = FA_CASES[case]
    q = _rnd(card, 2, 8, c["sq"], d, dtype=torch.float32)
    k = _rnd(card, 2, 2, c["skv"], d, dtype=torch.float32, seed=1)
    v = _rnd(card, 2, 2, c["skv"], d, dtype=torch.float32, seed=2, shift=1.0)
    kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
    out = flash_attention_tf32x3_hopper(q, k, v, **kw)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert _normwise(out, attention_ref(q, k, v, **kw)) <= TOL[torch.float32]
    assert _normwise(out, attention_tf32x3_ref(q, k, v, **kw)) <= FA_TF32_MODEL_TOL
    assert _normwise(out, attention_f64(q, k, v, **kw)) <= FA_TF32_F64_TOL


@pytest.mark.parametrize("d", [80, 256])
def test_flash_attention_tf32x3_kernel_is_repeatable(card, d):
    # key tiles in order, fixed sums, no atomics: the same bits
    q = _rnd(card, 1, 8, 300, d, dtype=torch.float32)
    k = _rnd(card, 1, 2, 300, d, dtype=torch.float32, seed=1)
    v = _rnd(card, 1, 2, 300, d, dtype=torch.float32, seed=2, shift=1.0)
    out = flash_attention_tf32x3_hopper(q, k, v, window=100, prefix_len=20)
    assert torch.equal(_bits(out), _bits(
        flash_attention_tf32x3_hopper(q, k, v, window=100, prefix_len=20)))


def test_flash_attention_tf32x3_kernel_unaligned_views(card):
    # operands off the 16-byte grid are staged by plain loads
    def view(h, s, seed, shift=0.0):
        n = 2 * h * s * 80
        return _rnd(card, n + 1, dtype=torch.float32, seed=seed,
                    shift=shift)[1:].view(2, h, s, 80)
    q, k, v = view(8, 150, 0), view(2, 150, 1), view(2, 150, 2, 1.0)
    assert q.data_ptr() % 16 != 0
    out = flash_attention_tf32x3_hopper(q, k, v, window=37)
    assert _normwise(out, attention_ref(q, k, v, window=37)) <= TOL[torch.float32]
    assert _normwise(out, attention_tf32x3_ref(q, k, v, window=37)) <= FA_TF32_MODEL_TOL


@pytest.mark.parametrize("d,skv", [(80, 8192), (256, 4096)])
def test_flash_attention_tf32x3_kernel_over_a_long_row(card, d, skv):
    # every query row sees every key: each 32 keys of p·v in a fresh
    # accumulator hold the model and float64; one accumulator over the row
    # (the tensor cores truncate its sums) errs ~1e-5
    q = _rnd(card, 1, 4, 128, d, dtype=torch.float32, seed=3)
    k = _rnd(card, 1, 2, skv, d, dtype=torch.float32, seed=4)
    v = _rnd(card, 1, 2, skv, d, dtype=torch.float32, seed=5, shift=1.0)
    out = flash_attention_tf32x3_hopper(q, k, v, causal=False)
    assert _normwise(out, attention_tf32x3_ref(q, k, v, causal=False)) <= FA_TF32_MODEL_TOL
    assert _normwise(out, attention_f64(q, k, v, causal=False)) <= FA_TF32_F64_TOL


def test_flash_attention_tf32x3_kernel_keeps_infinities_and_nan(card):
    # ±inf and NaN split whole into lo: the kernel's non-finite outputs sit
    # where its model's and the plain version's do, the rest within tolerance.
    # k: +inf in key 5 (a score of ±inf by the sign of q); v: ±inf and NaN
    # in key 9 (masked for rows 0-8, whose p = 0 then meets them); q: -inf
    # in row 100
    q = _rnd(card, 1, 8, 256, 80, dtype=torch.float32, seed=6)
    k = _rnd(card, 1, 2, 256, 80, dtype=torch.float32, seed=7)
    v = _rnd(card, 1, 2, 256, 80, dtype=torch.float32, seed=8, shift=1.0)
    k[:, :, 5, 3] = float("inf")
    v[:, :, 9, 11], v[:, :, 9, 12], v[:, :, 9, 13] = float("inf"), -float("inf"), float("nan")
    q[:, :, 100, 5] = -float("inf")
    out = flash_attention_tf32x3_hopper(q, k, v)
    for want, tol in ((attention_tf32x3_ref(q, k, v), FA_TF32_MODEL_TOL),
                      (attention_ref(q, k, v), TOL[torch.float32])):
        for special in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(special(out), special(want))
        finite = torch.isfinite(out)
        assert 0 < int(finite.sum()) < out.numel() and torch.isinf(out).any()
        assert _normwise(out[finite], want[finite]) <= tol


def _bad_operands(dev):
    x = torch.randn(4, 80, device=dev)
    q = torch.randn(1, 4, 8, 32, device=dev)
    return [
        (rmsnorm_hopper, (x.t(), x[0])),                     # not contiguous
        (rmsnorm_hopper, (x, x[0].bfloat16())),              # mixed types
        (rmsnorm_hopper, (x, x[0, :79].contiguous())),       # gamma too short
        (flash_attention_hopper, (q, q[:, :2].transpose(2, 3).contiguous()
                                  .transpose(2, 3), q[:, :2])),
        (flash_attention_hopper, (q, q[:, :2].half(), q[:, :2].half())),
        (flash_attention_hopper, (torch.randn(1, 4, 8, 264, device=dev),) * 3),  # head dim
    ]


def test_new_wrappers_refuse_host_tensors_and_bad_operands():
    # runs on any host: the wrappers check before they touch the card
    for fn, args in _bad_operands("cpu"):
        with pytest.raises(ValueError):
            fn(*args)
    x = torch.randn(4, 80)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_hopper(x, x[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        q = torch.randn(1, 2, 4, 32)
        flash_attention_hopper(q, q, q)


def test_new_wrappers_refuse_bad_operands_on_the_card(card):
    before = _cuda.launch_counts()
    for fn, args in _bad_operands(card):
        with pytest.raises(ValueError):
            fn(*args)
    after = _cuda.launch_counts()
    assert after.get("rmsnorm", 0) == before.get("rmsnorm", 0)
    for name in ("flash_attention_mma", "flash_attention_tf32x3", "flash_attention_wgmma"):
        assert after.get(name, 0) == before.get(name, 0)
    q = torch.randn(1, 4, 8, 32, device=card).bfloat16()
    with pytest.raises(ValueError, match="tf32x3 route takes float32"):
        flash_attention_tf32x3_hopper(q, q, q)
    with pytest.raises(ValueError, match="wgmma route takes bfloat16 or float16"):
        flash_attention_wgmma_hopper(q, q, q)
    with pytest.raises(ValueError, match="wgmma route takes bfloat16 or float16"):
        flash_attention_wgmma_hopper(*(torch.randn(1, 4, 8, 256, device=card),) * 3)
    assert _cuda.launch_counts() == after


def test_serve_launcher_without_a_device_refuses_a_missing_card():
    if torch.cuda.is_available() and torch.cuda.get_device_capability(0) >= (9, 0):
        pytest.skip("a capability-9.0 card is present; the refusal needs a host "
                    "without one")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA|capability"):
        serve.main(["--arch", "h2o-danube-1.8b", "--reduced"])


def test_model_on_the_card_runs_the_kernels(card):
    """Reduced danube with GQA (Hkv 2), in float32 and in bfloat16: prefill
    of 40 tokens (past the 32-token window) and 4 decode steps, once on a
    session that resolves to the kernels and once on one that prefers the
    plain versions; logits agree, and the kernels ran as the structure says:
    FLASH_ATTN on the tensor cores in both, by 3×TF32 in float32 and by the
    mma route in bfloat16 (head dim 32).  bfloat16 logits are held to chip_smoke.py's
    SERVE_TOL (2e-2): both paths round each kernel's output to bfloat16 at
    the same places, but a rounding on the other side of a boundary moves
    the next projection."""
    import dataclasses

    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import default_manifest
    from repro_torch.models import build_model
    from repro_torch.serve.kvcache import pad_caches

    cfg = get_config("h2o-danube-1.8b").reduced()
    stages = tuple(dataclasses.replace(st, pattern=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, n_kv_heads=2))
        for b in st.pattern)) for st in cfg.stages)
    cfg = dataclasses.replace(cfg, stages=stages)
    g = torch.Generator(device=card).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 40), generator=g, device=card)
    steps = torch.randint(0, cfg.vocab_size, (4, 1, 1), generator=g, device=card)
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]

    def run(model, params, manifest):
        halo.initialize(manifest=manifest, device=card)
        try:
            logits, caches = model.prefill(params, {"tokens": prompt})
            caches = pad_caches(model.cfg, caches, 48)
            out = [logits]
            for i, tok in enumerate(steps):
                logits, caches = model.decode_step(params, caches, tok, 40 + i)
                out.append(logits)
            return out
        finally:
            halo.finalize()

    for dtype, tol, route, attn in (
            (torch.float32, 1e-4, "tf32x3", "flash_attention_tf32x3"),
            (torch.bfloat16, 2e-2, "mma", "flash_attention_mma")):
        model = build_model(dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1]))
        params = model.init(torch.Generator(device=card).manual_seed(0))
        assert fa_route(dtype, model.cfg.stages[0].pattern[0].attn.head_dim) == route
        _cuda.reset_launch_counts()
        served = run(model, params, None)
        counts = _cuda.launch_counts()
        layers = model.cfg.n_layers
        # the prefill's 40 rows take the route mmm_route picks for 40 rows
        # of the model's type, its last-token unembed (one row) and the 4
        # decode passes (one row each) the skinny route
        d = model.cfg.d_model
        prefill = {"skinny": "mmm_skinny", "wgmma": "mmm_wgmma",
                   "tf32x3": "mmm_tf32x3"}[mmm_route(dtype, 40)]
        expected = {"mmm_wgmma": 0, "mmm_tf32x3": 0,
                    "mmm_skinny": 4 * (7 * layers + 1) + 1}
        expected[prefill] += 7 * layers
        assert {k: counts[k] for k in expected} == expected
        assert counts["rmsnorm"] == 5 * (2 * layers + 1)
        others = {"flash_attention_mma", "flash_attention_tf32x3",
                  "flash_attention_wgmma"} - {attn}
        assert counts[attn] == layers and all(counts[o] == 0 for o in others)
        _cuda.reset_launch_counts()
        ref = run(model, params, plain)
        assert sum(_cuda.launch_counts().values()) == 0
        for a, b in zip(served, ref):
            assert _normwise(a, b) <= tol


def test_each_launch_counts_once(card):
    a = _rnd(card, 16, 16, dtype=torch.float32)
    a.diagonal().add_(16.0)
    before = _cuda.launch_counts()
    mmm_skinny_hopper(a, a)
    mmm_wgmma_hopper(a.bfloat16(), a.bfloat16())
    mmm_tf32x3_hopper(a, a)
    ewise_hopper(a, a, "add")
    mvm_hopper(a, a[0])
    vdp_hopper(a[0], a[0])
    jacobi_hopper(a, a[0], a[1])
    conv1d_hopper(a[0], a[1, :3])
    smmm_hopper(a.view(2, 1, 8, 16), torch.zeros(2, 1, dtype=torch.int32,
                                                 device=card), a)
    fft_chirp_hopper(a[:, :12].contiguous(), cached_chirp_tables(12, card))
    fft_radix_hopper(a, cached_radix_twiddles(16, card))
    sort_tile_hopper(a)
    sort_radix_hopper(a)
    hist_hopper(a)
    rmsnorm_hopper(a, a[0])
    q = a[:, :8].reshape(1, 2, 2, 32)
    qb = q.bfloat16()
    flash_attention_mma_hopper(qb, qb[:, :1], qb[:, :1])
    flash_attention_tf32x3_hopper(q, q[:, :1], q[:, :1])
    q256 = a.reshape(1, 1, 1, 256).bfloat16()
    flash_attention_wgmma_hopper(q256, q256, q256)
    after = _cuda.launch_counts()
    for name in ("mmm_skinny", "mmm_wgmma", "mmm_tf32x3", "ewise", "mvm", "vdp",
                 "jacobi", "conv1d", "spmm", "fft_chirp", "fft_radix", "sort", "sort_radix",
                 "hist", "rmsnorm", "flash_attention_mma", "flash_attention_tf32x3",
                 "flash_attention_wgmma"):
        assert after[name] == before[name] + 1


def test_build_log_reports_registers(card):
    so = _cuda.build()
    log = (so.parent / "build.log").read_text()
    assert "registers" in log


def test_isend_launches_on_the_callers_stream(card, monkeypatch):
    reg = KernelRegistry()
    register_all(reg)
    rt = RuntimeAgent(registry=reg, device=card)
    seen = []
    real = _cuda.stream

    def spy(device):
        seen.append(real(device))
        return seen[-1]

    monkeypatch.setattr(_cuda, "stream", spy)
    side = torch.cuda.Stream(card)
    try:
        with torch.cuda.stream(side):
            # the inputs come from work queued on the side stream; a kernel
            # on another stream, with no event, could read them unfinished
            a = _rnd(card, 2048, 2048, dtype=torch.float32)
            b = (a @ a) / 2048
            cr = rt.claim("EWADD", overrides={"allowed_platforms": ["hopper"]})
            rt.send((b, b), cr)
            out = rt.recv(cr)
            assert seen == [side.cuda_stream]
            assert torch.equal(_bits(out), _bits(b + b))
    finally:
        rt.finalize()


def test_hopper_error_on_the_card_reaches_the_waiter(card):
    def broken(x):
        raise RuntimeError("kernel launch failed")

    reg = KernelRegistry()
    reg.register(KernelRecord(alias="X", fn=broken, platform="hopper"))
    reg.register(KernelRecord(alias="X", fn=lambda x: x, platform="torch",
                              is_failsafe=True))
    rt = RuntimeAgent(registry=reg, device=card)
    try:
        # unpinned: on the card the error is not re-placed or quarantined
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            rt.send((torch.ones(2, device=card),), rt.claim("X"))
        assert rt.scheduler.failed_record_keys() == []
        assert rt.agents["torch"].metrics["requests"] == 0
        # host operands keep the fail-safe ladder
        rt.send((torch.ones(2),), rt.claim("X"))
        assert rt.agents["torch"].metrics["requests"] == 1
    finally:
        rt.finalize()


#: fused chains over inputs 0..4 (the divisors — odd inputs and input 4 —
#: shifted by +3 away from 0)
CHAINS = {
    "ew4": (("mul", 0, 1), ("add", ACC, 2), ("sub", ACC, 3), ("div", ACC, 4)),
    "every op, acc second": (("sub", 0, 1), ("div", 2, ACC), ("mul", ACC, 3),
                             ("sub", 4, ACC), ("add", 1, ACC), ("div", ACC, 4)),
    "copy": (("copy", 2, None), ("mul", ACC, 0), ("copy", ACC, None),
             ("add", ACC, 3)),
    "input twice": (("mul", 0, 0), ("div", ACC, 4), ("add", ACC, 0)),
    "caps": (("copy", 0, None),) + tuple(
        (("add", "mul", "sub", "div")[s % 4], ACC, s % MAX_INPUTS)
        for s in range(1, MAX_STEPS)),
}


def _chain_inputs(card, shape, k, dtype, seed=0):
    return [_rnd(card, *shape, dtype=dtype, seed=seed + j,
                 shift=3.0 if j % 2 or j == 4 else 0.0) for j in range(k)]


def _serial_chain(xs, steps):
    acc = None
    for op, a, b in steps:
        x = acc if a == ACC else xs[a]
        acc = x.clone() if op == "copy" else ewise_hopper(
            x, acc if b == ACC else xs[b], op)
    return acc


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("shape", [(1,), (37, 129), (3, 5, 7), (100_003,)])
def test_fused_chain_kernel_is_bit_exact(card, dtype, name, shape):
    """The chain kernel equals its plain version and the serial EW kernel
    launches bit for bit in every type."""
    steps = CHAINS[name]
    k = MAX_INPUTS if name == "caps" else 5
    xs = _chain_inputs(card, shape, k, dtype)
    out = ewise_chain_hopper(*xs, steps=steps)
    assert out.dtype == dtype and out.shape == xs[0].shape
    assert torch.equal(_bits(out), _bits(ewise_chain_ref(*xs, steps=steps)))
    assert torch.equal(_bits(out), _bits(_serial_chain(xs, steps)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_chain_kernel_unaligned_views(card, dtype):
    """Pointers off the 16-byte grid take the scalar path."""
    steps = CHAINS["every op, acc second"]
    xs = [x[1:] for x in _chain_inputs(card, (4099,), 5, dtype)]
    out = ewise_chain_hopper(*xs, steps=steps)
    assert torch.equal(_bits(out), _bits(ewise_chain_ref(*xs, steps=steps)))
    assert torch.equal(_bits(out), _bits(_serial_chain(xs, steps)))


def test_fused_chain_kernel_refuses_what_it_does_not_take(card):
    xs = _chain_inputs(card, (8, 8), 2, torch.float32)
    steps = (("add", 0, 1),)
    before = _cuda.launch_counts()["fused"]
    for bad in ([xs[0], xs[1].t()], [xs[0], xs[1].to(torch.bfloat16)],
                [xs[0], xs[1][:4]], [xs[0].cpu(), xs[1].cpu()]):
        with pytest.raises(ValueError):
            ewise_chain_hopper(*bad, steps=steps)
    for steps in ((("add", ACC, 0),), (("add", 0, 2),), ()):
        with pytest.raises(ValueError):
            ewise_chain_hopper(*xs, steps=steps)
    assert _cuda.launch_counts()["fused"] == before
    ewise_chain_hopper(*xs, steps=(("add", 0, 1),))
    assert _cuda.launch_counts()["fused"] == before + 1


def _card_session(card):
    reg = KernelRegistry()
    register_all(reg)
    return RuntimeAgent(registry=reg, device=card)


@pytest.mark.parametrize("chain", ["ew", "mixed"])
def test_compiled_replay_on_the_card_runs_the_kernels(card, chain):
    """A chain compiled and replayed on the card: a 4-step EW chain is one
    chain kernel launch per replay, a chain with an RMSNORM in it is a call
    loop over the members' kernels; the result equals serial dispatch bit
    for bit."""
    from repro_torch.core.graph import halo_graph
    rt = _card_session(card)
    try:
        xs = _chain_inputs(card, (256, 300), 5, torch.float32)
        gamma = torch.ones(300, device=card)
        pin = {"allowed_platforms": ["hopper"]}
        last = "EWMD" if chain == "ew" else "RMSNORM"
        crs = [rt.claim(al, overrides=pin)
               for al in ("EWMM", "EWADD", "EWSUB", last)]

        def program(send):
            t = send(crs[0], (xs[0], xs[1]))
            for cr, j in zip(crs[1:3], (2, 3)):
                t = send(cr, (t, xs[j]))
            return send(crs[3], (t, xs[4] if chain == "ew" else gamma))

        ref = program(lambda cr, p: rt.isend(p, cr, mailbox=False).result(60))
        with halo_graph(session=rt, launch=False) as g:
            program(lambda cr, p: rt.isend(p, cr))
        cg = g.compile()
        assert cg.stats["fused_nodes"] == 1 and cg.stats["nodes"] == 1
        before = _cuda.launch_counts()
        (out,) = cg.replay(timeout=60)
        torch.cuda.synchronize(card)
        after = _cuda.launch_counts()
        want = {"fused": 1, "ewise": 0, "rmsnorm": 0} if chain == "ew" \
            else {"fused": 0, "ewise": 3, "rmsnorm": 1}
        assert {k: after[k] - before[k] for k in want} == want
        assert torch.equal(_bits(out), _bits(ref))
    finally:
        rt.finalize()


def test_graph_launches_on_the_launching_stream(card, monkeypatch):
    """Graph nodes run on the agents' workers but launch on the stream that
    was current where the graph was launched, so the work queued before it
    (the inputs) is ordered before every node."""
    from repro_torch.core.graph import halo_graph
    rt = _card_session(card)
    seen = []
    real = _cuda.stream

    def spy(device):
        seen.append(real(device))
        return seen[-1]

    monkeypatch.setattr(_cuda, "stream", spy)
    side = torch.cuda.Stream(card)
    try:
        with torch.cuda.stream(side):
            a = _rnd(card, 2048, 2048, dtype=torch.float32)
            b = (a @ a) / 2048
            pin = {"allowed_platforms": ["hopper"]}
            with halo_graph(session=rt) as g:
                t = rt.isend((b, b), rt.claim("EWADD", overrides=pin))
                rt.isend((t, b), rt.claim("EWMM", overrides=pin))
            (out,) = g.wait(timeout=60)
            g.wait_device()
        assert seen == [side.cuda_stream] * 2
        assert torch.equal(_bits(out), _bits((b + b) * b))
    finally:
        rt.finalize()


def test_failing_fused_hopper_record_on_the_card_fails_its_node(card):
    """A fused hopper record that raises on card tensors fails its node at
    once: no quarantine, no re-placement, no decomposition onto members."""
    from repro_torch.core.graph import halo_graph
    rt = _card_session(card)
    try:
        xs = _chain_inputs(card, (64, 64), 3, torch.float32)
        crs = [rt.claim(al) for al in ("EWMM", "EWADD")]
        with halo_graph(session=rt, launch=False) as g:
            t = rt.isend((xs[0], xs[1]), crs[0])
            rt.isend((t, xs[2]), crs[1])
        cg = g.compile()
        (alias,) = cg.stats["fused_aliases"]
        hop = next(r for r in rt.registry.records(alias)
                   if r.platform == "hopper")
        assert cg.templates[0].pinned is hop

        def broken(*args):
            raise RuntimeError("kernel launch failed")

        hop.fn = broken
        gr = cg.replay_async()
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            gr.wait(timeout=60)
        node = gr.nodes[0]
        assert node.attempts == ["hopper"]
        assert rt.scheduler.failed_record_keys() == []
    finally:
        rt.finalize()


# ---------------------------------------------------------------------------
# FLASH_ATTN between the instantiated head dims (MLA's 192, the reduced 48)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,route16", [(48, "mma"), (192, "wgmma")])
@pytest.mark.parametrize("hkv", [1, 4])
def test_flash_attention_padded_head_dim(card, dtype, d, route16, hkv):
    """The hopper path zero-pads q, k and v to 64 or 256 and scales by the
    real dim's D^-1/2: against attention_ref at the real dim on the route
    the type picks (tf32x3 for float32), causal over 300 tokens, and once
    over 70 queries of 300 keys; the padded columns never reach the
    output (its shape is the real dim's)."""
    route = "tf32x3" if dtype == torch.float32 else route16
    assert fa_route(dtype, d) == route
    for sq, seed in ((300, d + hkv), (70, d + hkv + 1)):
        q = _rnd(card, 1, 4, sq, d, dtype=dtype, seed=seed)
        k = _rnd(card, 1, hkv, 300, d, dtype=dtype, seed=seed + 10)
        v = _rnd(card, 1, hkv, 300, d, dtype=dtype, seed=seed + 20)
        before = _cuda.launch_counts().get(f"flash_attention_{route}", 0)
        out = flash_attention_hopper(q, k, v, causal=True)
        assert _cuda.launch_counts()[f"flash_attention_{route}"] == before + 1
        assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
        assert _normwise(out, attention_ref(q, k, v, causal=True)) <= TOL[dtype]


def test_flash_attention_mla_prefill_shape(card):
    """deepseek-v2's prefill attention, 128 heads at 128 + 64 = 192 over 2048
    tokens in bfloat16, on the wgmma route; the padded dim's scale
    (256^-1/2) would read far past TOL."""
    q, k, v = (_rnd(card, 1, 128, 2048, 192, dtype=torch.bfloat16, seed=s)
               for s in (1, 2, 3))
    out = flash_attention_wgmma_hopper(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    assert _normwise(out, want) <= TOL[torch.bfloat16]
    wrong = attention_ref(q, k, v, causal=True, scale=256 ** -0.5)
    assert _normwise(wrong, want) > 10 * TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# MoE: the MOE_FFN rows and the dispatch on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", [244, 4])
def test_moe_ffn_aten_row_against_torch_row(card, cap):
    """moonshot's experts (64 of 2048 → 1408) at its 2048-token prefill
    capacity and its 4-slot decode capacity, bfloat16: the aten row
    (float32 h and u, by bmm out_dtype) against the torch row (every
    product in bfloat16), and both against a float64 FFN of the same
    inputs, the aten row nearer it."""
    from repro_torch.kernels.moe_ffn.ops import grouped_ffn
    from repro_torch.kernels.moe_ffn.ref import grouped_ffn_ref
    xe = _rnd(card, 64, cap, 2048, dtype=torch.bfloat16, seed=1)
    wg = (_rnd(card, 64, 2048, 1408, dtype=torch.float32, seed=2) / 2048 ** 0.5).bfloat16()
    wu = (_rnd(card, 64, 2048, 1408, dtype=torch.float32, seed=3) / 2048 ** 0.5).bfloat16()
    wd = (_rnd(card, 64, 1408, 2048, dtype=torch.float32, seed=4) / 1408 ** 0.5).bfloat16()
    got, ref = grouped_ffn(xe, wg, wu, wd), grouped_ffn_ref(xe, wg, wu, wd)
    assert got.dtype == torch.bfloat16 and got.shape == xe.shape
    assert _normwise(got, ref) <= TOL[torch.bfloat16]
    h = xe.double() @ wg.double()
    exact = (torch.nn.functional.silu(h) * (xe.double() @ wu.double())) @ wd.double()
    assert _normwise(got, exact) < _normwise(ref, exact) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_moe_ffn_aten_row_takes_a_backward(card, dtype):
    """ROADMAP C4: ``bmm(..., out_dtype=float32)`` has no derivative, so a
    16-bit MoE step on the card could not take its backward.  moonshot's
    experts (64 of 2048 → 1408) at 16 slots: the aten row's forward is
    bit-identical to the three products taken outside autograd (the row
    before the repair), and its gradients for xe, w_gate, w_up and w_down
    are within the type's TOL of autograd of the torch row."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_ffn.ops import grouped_ffn
    from repro_torch.kernels.moe_ffn.ref import grouped_ffn_ref
    xe = _rnd(card, 64, 16, 2048, dtype=dtype, seed=1)
    wg = (_rnd(card, 64, 2048, 1408, dtype=torch.float32, seed=2) / 2048 ** 0.5).to(dtype)
    wu = (_rnd(card, 64, 2048, 1408, dtype=torch.float32, seed=3) / 2048 ** 0.5).to(dtype)
    wd = (_rnd(card, 64, 1408, 2048, dtype=torch.float32, seed=4) / 1408 ** 0.5).to(dtype)
    g = _rnd(card, 64, 16, 2048, dtype=dtype, seed=5)

    def grads(row):
        leaves = [t.detach().clone().requires_grad_() for t in (xe, wg, wu, wd)]
        out = row(*leaves)
        out.backward(g)
        return out.detach(), [t.grad for t in leaves]
    out, got = grads(grouped_ffn)
    _, want = grads(grouped_ffn_ref)
    with torch.no_grad():
        h = torch.bmm(xe, wg, out_dtype=torch.float32)
        u = torch.bmm(xe, wu, out_dtype=torch.float32)
        before = torch.bmm((F.silu(h) * u).to(dtype), wd)
    assert torch.equal(out, before)
    for name, a, b in zip(("xe", "w_gate", "w_up", "w_down"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _normwise(a, b) <= TOL[dtype], (name, _normwise(a, b))


def test_moe_ffn_float32_rows_hold_a_slice_bit_for_bit(card):
    """ROADMAP C3: at moonshot's decode shapes, (64, 4, 2048) @ (64, 2048,
    1408) float32, both MOE_FFN rows over experts 16-31 alone give rows
    16-31 of the 64-expert call bit for bit: an expert's bits do not
    depend on how many experts the call holds (the per-expert products)."""
    from repro_torch.kernels.moe_ffn.ops import grouped_ffn
    from repro_torch.kernels.moe_ffn.ref import grouped_ffn_ref
    xe = _rnd(card, 64, 4, 2048, dtype=torch.float32, seed=1)
    wg = _rnd(card, 64, 2048, 1408, dtype=torch.float32, seed=2) / 2048 ** 0.5
    wu = _rnd(card, 64, 2048, 1408, dtype=torch.float32, seed=3) / 2048 ** 0.5
    wd = _rnd(card, 64, 1408, 2048, dtype=torch.float32, seed=4) / 1408 ** 0.5
    for row in (grouped_ffn, grouped_ffn_ref):
        whole = row(xe, wg, wu, wd)
        part = row(*(w[16:32].clone() for w in (xe, wg, wu, wd)))
        assert whole.dtype == torch.float32 and whole.shape == xe.shape
        assert torch.equal(part, whole[16:32]), row.__name__


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh_float32_rank():
    """chip_smoke.py phase 3j (a)'s float32 decode leg in one rank."""
    return _chip_smoke().mesh_rank(("f32",))


def test_mesh_float32_decode_on_four_gloo_ranks(card):
    """Phase 3j (a)'s float32 case on the card: moonshot's MoE layer at
    published width, decode 4 × 1 under a (1, 4) mesh of four gloo ranks
    on one card: within float32's TOL of moe_layer in one process, every
    rank's expert outputs torch.equal to moe_layer's rows [16r, 16r + 16)
    (ROADMAP C3's repair), every rank's result the same bits, the
    replicated body counted in every rank.  (mesh_rank fails the rank on
    any check; run_ranks then raises.)"""
    from repro_torch.launch.mesh import run_ranks
    _cuda.lib()                              # built once, before the ranks
    ranks = run_ranks(_mesh_float32_rank, 4, backend="gloo", timeout=300,
                      device_type="cuda")
    label = "(a) 1x4 decode float32 layer 1"
    assert len({r["digests"][label] for r in ranks}) == 1
    for r in ranks:
        rec = r["records"][label]
        assert rec["mode"] == "replicated" and rec["expert_slice_equal"] is True
        assert rec["normwise"] <= TOL[torch.float32]
        assert r["body_calls"]["replicated"] > 0


def test_moe_dispatch_on_the_card_is_bit_identical_to_the_cpu(card):
    """_dispatch_indices and _gather_dispatch at moonshot's widths (2048
    tokens, 64 experts, top 6, capacity 244) with a router skewed so that
    experts 0 and 1 overflow: slot, keep and the capacity buffer on the
    card equal the same calls on the CPU bit for bit."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    m = MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2)
    t = 2048
    c = moe._capacity(t, m)
    g = torch.Generator().manual_seed(0)
    x2 = (torch.randn(t, 2048, generator=g) + 1.0).bfloat16()
    router = torch.randn(2048, 64, generator=g) * 2048 ** -0.5
    router[:, :2] += 0.01                # every token's logits favour 0 and 1
    _, eidx, _ = moe._route(x2, router, m)
    assert int((eidx == 0).sum()) > c and int((eidx == 1).sum()) > c
    slot, keep = moe._dispatch_indices(eidx, t, c, 64)
    xe = moe._gather_dispatch(x2, slot, keep, 64, c, 6)
    cs, ck = moe._dispatch_indices(eidx.to(card), t, c, 64)
    cxe = moe._gather_dispatch(x2.to(card), cs, ck, 64, c, 6)
    assert not bool(keep.all())
    assert torch.equal(cs.cpu(), slot) and torch.equal(ck.cpu(), keep)
    assert torch.equal(_bits(cxe.cpu()), _bits(xe))


def _moe_definition():
    """chip_smoke.py's float64 definition of the MoE layer (one definition
    for the card's test and the card's smoke run)."""
    return _chip_smoke().moe_definition


@pytest.mark.parametrize("t", [4, 128])
def test_moe_layer_on_the_card_against_its_definition(card, t):
    """moonshot's MoE layer (64 experts top 6, d_ff 1408, 2 shared experts)
    in bfloat16 on the card's kernels (MMM for the shared experts, MOE_FFN
    on its aten row) against chip_smoke.py's ``moe_definition``: 4 tokens
    (the decode capacity, no drop possible) and 128 (capacity 16) whose
    first 32 tokens are one token repeated, so that rows are dropped."""
    from repro_torch import halo
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    m = MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2)
    specs = moe.moe_param_specs(2048, m, torch.bfloat16)
    p = {n: (_rnd(card, *s.shape, dtype=torch.float32, seed=i)
             * s.shape[-2] ** -0.5).to(s.dtype) for i, (n, s) in enumerate(specs.items())}
    x = _rnd(card, 1, t, 2048, dtype=torch.bfloat16, seed=9)
    repeat = t // 4 if t > 4 else 1
    x[:, :repeat] = x[:, :1]
    halo.initialize()
    try:
        y, _ = moe.moe_layer(p, x, m, "swiglu")
        _, eidx, _ = moe._route(x[0], p["router"], m)
    finally:
        halo.finalize()
    want, want_eidx, kept = _moe_definition()(p, x[0], m)
    assert torch.equal(eidx, want_eidx)
    assert bool(kept.all()) == (repeat == 1)
    assert _normwise(y[0], want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,vocab", [(0, 8, 5), (1, 1, 3), (CHUNK, 3, 7),
                                       (CHUNK + 1, 257, 40), (1000, 80, 997),
                                       (2048, 2560, 32000)])
def test_embed_grad_kernel_is_bit_exact(card, dtype, n, d, vocab):
    """EMBED_GRAD against its plain version (the same order and float32
    roundings) bit for bit: no positions, one, a chunk and one past it,
    ragged widths, a danube step's shape; Zipf-like tokens with one token
    over a third of the positions; two calls the same bits."""
    g = _rnd(card, n, d, dtype=dtype, seed=n + d)
    gen = torch.Generator(device=card).manual_seed(7)
    tok = torch.randint(0, vocab, (n,), generator=gen, device=card, dtype=torch.int32)
    tok[::3] = vocab // 2
    got = embed_grad_hopper(g, tok, vocab)
    assert got.dtype == dtype and got.shape == (vocab, d)
    assert torch.equal(_bits(got), _bits(embed_grad_ref(g, tok, vocab)))
    assert torch.equal(_bits(got), _bits(embed_grad_hopper(g, tok, vocab)))


def test_embed_grad_kernel_long_run_and_shapes(card):
    """One token at 5000 of 5003 positions (157 chunks of one run), int64
    tokens shaped (B, S) with g (B, S, D), rows past every run zero, one
    launch a call."""
    g = _rnd(card, 1, 5003, 64, dtype=torch.float32, seed=3)
    tok = torch.full((1, 5003), 11, dtype=torch.int64, device=card)
    tok[0, :3] = torch.tensor([2, 40, 2], device=card)
    before = _cuda.launch_counts().get("embed_grad", 0)
    got = embed_grad_hopper(g, tok, 41)
    assert _cuda.launch_counts()["embed_grad"] == before + 1
    assert torch.equal(got, embed_grad_ref(g, tok, 41))
    want = torch.zeros((41, 64), dtype=torch.float64, device=card).index_put_(
        (tok.reshape(-1),), g.reshape(-1, 64).double(), accumulate=True)
    assert float((got.double() - want).abs().max()) < 1e-3
    assert not got[[0, 1, 3, 39]].any()


def test_embed_backward_on_the_card_repeats_bit_for_bit(card):
    """The embedding's Function on the card (EMBED_GRAD's hopper row through
    a card session): two backward passes give the same bits and match the
    plain version."""
    from repro_torch import halo
    from repro_torch.models.layers import embed_tokens
    table = _rnd(card, 1000, 96, dtype=torch.bfloat16, seed=5)
    gen = torch.Generator(device=card).manual_seed(8)
    tok = torch.randint(0, 50, (4, 512), generator=gen, device=card, dtype=torch.int32)
    g = _rnd(card, 4, 512, 96, dtype=torch.bfloat16, seed=6)
    halo.initialize()
    try:
        grads = []
        for _ in range(2):
            leaf = table.clone().requires_grad_()
            embed_tokens(leaf, tok).backward(g)
            grads.append(leaf.grad)
    finally:
        halo.finalize()
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))
    assert torch.equal(_bits(grads[0]), _bits(embed_grad_ref(g, tok, 1000)))


def test_embed_grad_kernel_refuses_what_it_does_not_take(card):
    g = _rnd(card, 4, 8, dtype=torch.float32)
    tok = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        embed_grad_hopper(g.cpu(), tok.cpu(), 3)
    with pytest.raises(ValueError, match="int32 or int64"):
        embed_grad_hopper(g, tok.float(), 3)
    with pytest.raises(ValueError, match="shape"):
        embed_grad_hopper(g, tok[:3], 3)



# ---------------------------------------------------------------------------
# Resilience on the card (DESIGN.md §11)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,route", [(4, "mmm_skinny"), (256, "mmm_wgmma")])
def test_faulty_hopper_agent_launches_the_same_kernel(card, m, route):
    """A FaultyAgent on hopper executes its non-faulting calls through a
    HopperAgent on the card: the same kernel, launched once, bit for bit."""
    from repro_torch.core.agents import HopperAgent
    from repro_torch.testing.faults import FaultPlan, FaultyAgent
    reg = KernelRegistry()
    register_all(reg)
    rec = next(r for r in reg.records("MMM") if r.platform == "hopper")
    a = _rnd(card, m, 320, dtype=torch.bfloat16, seed=1)
    b = _rnd(card, 320, 264, dtype=torch.bfloat16, seed=2)
    fa = FaultyAgent(FaultPlan(platform="hopper", mode="raise", nth=10 ** 6),
                     device=card)
    _cuda.reset_launch_counts()
    got = fa.execute(rec, a, b)
    assert _cuda.launch_counts().get(route) == 1 and fa.calls == 1
    want = HopperAgent(card).execute(rec, a, b)
    assert _cuda.launch_counts().get(route) == 2
    assert torch.equal(_bits(got), _bits(want))


def test_speculative_backup_keeps_the_winners_ready_event(card):
    """An aten MMM straggles (hang); its backup runs on hopper and wins.
    When the late aten attempt lands, its result is discarded and the
    node's ready event stays the backup's: a waiter on the node waits for
    the kernel that produced its result."""
    import time

    from repro_torch.core.agents import HealthConfig
    from repro_torch.core.graph import halo_graph
    from repro_torch.testing.faults import FaultPlan, chaos
    rt = _card_session(card)
    a = _rnd(card, 512, 2560, dtype=torch.bfloat16, seed=3)
    b = _rnd(card, 2560, 512, dtype=torch.bfloat16, seed=4)
    try:
        rt.enable_health_monitor(
            config=HealthConfig(heartbeat_timeout=60.0, straggler_multiple=1.0,
                                straggler_min_s=0.05), start=False)
        with chaos(rt, FaultPlan(platform="aten", mode="hang", delay_s=60.0)) as fa:
            cr = rt.claim("MMM", overrides={
                "allowed_platforms": ["aten", "hopper"],
                "platform_preference": ["aten", "hopper"]})
            with halo_graph(session=rt):
                node = rt.isend((a, b), cr)
            deadline = time.monotonic() + 10
            while fa.failures < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            time.sleep(0.06)
            rt.health.check()
            out = node.result(timeout=60)
            ready = node._ready
            assert isinstance(ready, torch.cuda.Event)
            fa.release()
            deadline = time.monotonic() + 10
            while fa.heartbeat()[1]:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        assert node.attempts == ["aten", "hopper+spec"] and node.platform == "hopper"
        assert node._ready is ready and node.result(timeout=0) is out
        node.wait_device()
        assert torch.equal(_bits(out), _bits(mmm_hopper(a, b)))
    finally:
        rt.finalize()


def test_card_worker_hopper_mmm_equals_in_process(card):
    """A worker process on the card serves ``hopper@tw-card``: its MMM runs
    mmm_wgmma.cu in the worker's own CUDA context on the same card, its
    launch counted there and not here, and the result comes back to the
    card torch.equal to the in-process hopper row's."""
    from repro_torch.distributed.remote import spawn_worker
    rt = _card_session(card)
    w = spawn_worker("tw-card", device="cuda")
    try:
        agent = w.agent("hopper").attach(rt)
        a = _rnd(card, 512, 2560, dtype=torch.bfloat16, seed=5)
        b = _rnd(card, 2560, 640, dtype=torch.bfloat16, seed=6)
        pin = {"allowed_platforms": [agent.platform],
               "platform_preference": [agent.platform]}
        before = w.heartbeat(timeout=60)["launches"]
        _cuda.reset_launch_counts()
        remote = rt.isend((a, b), rt.claim("MMM", overrides=pin),
                          mailbox=False).result(timeout=60)
        assert not any(_cuda.launch_counts().values())
        after = w.heartbeat(timeout=60)["launches"]
        assert after["mmm_wgmma"] - before["mmm_wgmma"] == 1
        assert remote.device == card and remote.dtype == torch.bfloat16
        assert torch.equal(_bits(remote), _bits(mmm_hopper(a, b)))
    finally:
        w.shutdown()
        w.kill()
        rt.finalize()


def test_wire_cache_hashes_an_unchanged_card_tensor_once(card, monkeypatch):
    """The wire cache keeps its digest memo for card tensors (a CPU tensor
    is hashed on every send, since numpy may alias it): a CUDA tensor sent
    twice unchanged is hashed once and goes the second time as a ref; a
    write torch counts re-hashes it."""
    from repro_torch.distributed import remote
    hashed = []
    digest = remote._digest
    monkeypatch.setattr(remote, "_digest", lambda t, data: hashed.append(
        t.device.type) or digest(t, data))
    cache = remote._WireCache()
    a = _rnd(card, 64, 64, dtype=torch.float32, seed=3)

    def mark():
        hdr, _ = remote.encode_payload({"args": (a,)}, cache)
        cache.commit()
        return hdr["__d__"][0][1]["__t__"][0]

    first, second = mark(), mark()
    assert hashed == ["cuda"]
    assert "put" in first and second == {"__aref__": first["put"], "s": [64, 64],
                                         "d": "float32"}
    a.add_(1.0)
    third = mark()
    assert hashed == ["cuda", "cuda"] and third["put"] != first["put"]


# ---------------------------------------------------------------------------
# the tuning spaces' launch plans (DESIGN.md §9): every variant against its
# plan model, two calls bit-identical
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(4, 2560, 640), (4, 2560, 32000), (64, 6912, 2560),
                                   (3, 777, 1001), (512, 2560, 640), (130, 75, 137)])
def test_mmm_every_tuned_plan(card, dtype, m, k, n):
    """Each of mmm_space's plans through mmm_hopper: a skinny split count
    against mmm_splitk_ref at that count (TOL; 16-bit also within half an
    ulp of the float32 product), a wgmma width within TOL and half an ulp,
    the tf32x3 route within TOL of mmm_ref; the default plan is the
    route's own."""
    from repro_torch.kernels.matmul.matmul import mmm_space
    a, b = _rnd(card, m, k, dtype=dtype), _rnd(card, k, n, dtype=dtype, seed=1)
    space = mmm_space(a, b)
    assert torch.equal(_bits(mmm_hopper(a, b)), _bits(mmm_hopper(a, b, **{})))
    assert space or (dtype == torch.float32 and m > SKINNY_M_MAX)
    for plan in space:
        out = mmm_hopper(a, b, **plan)
        assert out.dtype == dtype and out.shape == (m, n)
        route = plan.get("route", mmm_route(dtype, m))
        ref = mmm_splitk_ref(a, b, splits=plan["splits"]) if route == "skinny" \
            else mmm_ref(a, b)
        assert _normwise(out, ref) <= TOL[dtype], plan
        if dtype != torch.float32:
            assert mmm_ulp_excess(out, a, b) == 0, plan
        assert torch.equal(_bits(out), _bits(mmm_hopper(a, b, **plan))), plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(OP_REFS))
def test_ewise_every_tuned_plan(card, dtype, op):
    from repro_torch.kernels.ewise.ewise import ewise_space
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for n in (1, 1000, 4 * THREADS * sms * 16 // dtype.itemsize + 3):
        a = _rnd(card, n, dtype=dtype)
        b = _rnd(card, n, dtype=dtype, seed=1, shift=3.0)
        for plan in ewise_space(a, b):
            out = ewise_hopper(a, b, op, **plan)
            model = ewise_plan_ref(a, b, op, ewise_plan(n, dtype, True, sms, **plan))
            assert torch.equal(_bits(out), _bits(model)), (n, plan)
            assert torch.equal(_bits(out), _bits(OP_REFS[op](a, b))), (n, plan)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(4, 2560), (512, 2560), (4096, 2560), (3, 80),
                                    (7, 1000)])
def test_rmsnorm_every_tuned_plan(card, dtype, rows, d):
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plan_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plan, rmsnorm_space
    x = _rnd(card, rows, d, dtype=dtype, shift=0.5)
    g = _rnd(card, d, dtype=dtype, seed=1, shift=1.0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    space = rmsnorm_space(x)
    assert space
    for plan in space:
        out = rmsnorm_hopper(x, g, 1e-5, **plan)
        model = rmsnorm_plan_ref(x, g, 1e-5, rmsnorm_plan(rows, d, x.element_size(),
                                                          sms, True, **plan))
        assert torch.equal(_bits(out), _bits(model)), plan
        assert torch.equal(_bits(out), _bits(rmsnorm_hopper(x, g, 1e-5, **plan))), plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n", [(4096, 4096), (300, 100), (40, 8192), (64, 32)])
def test_sort_every_tuned_plan(card, dtype, rows, n):
    from repro_torch.kernels.sorthist.sorthist import sort_space
    x = _rnd(card, rows, n, dtype=dtype, seed=n)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for plan in sort_space(x):
        out = sort_hopper(x, **plan)
        model = sort_tile_ref(x, sort_tile_plan(rows, n, sms, **plan))
        assert torch.equal(_bits(out), _bits(model)), plan
        assert torch.equal(_bits(out), _bits(sort_ref(x))), plan


def test_tuned_plan_reaches_the_kernel_through_dispatch(card):
    """A seeded TuningDB entry at a decode k/v bucket moves the MMM from
    the skinny kernel to the wgmma one through halo dispatch; with no entry
    it stays on the skinny one."""
    from repro_torch.core.scheduler import CostModelScheduler, abstract_signature
    from repro_torch.core.tuning import TuneEntry, TuningDB
    registry = KernelRegistry()
    register_all(registry)
    a = _rnd(card, 4, 2560, dtype=torch.bfloat16)
    b = _rnd(card, 2560, 640, dtype=torch.bfloat16, seed=1)
    rec = next(r for r in registry.records("MMM") if r.platform == "hopper")
    db = TuningDB()
    for with_entry in (False, True):
        sess = RuntimeAgent(registry=registry, scheduler=CostModelScheduler(tuning_db=db),
                            device=card)
        try:
            _cuda.reset_launch_counts()
            out = sess.dispatch("MMM", a, b, overrides={"allowed_platforms": ["hopper"]})
            torch.cuda.synchronize(card)
            counts = _cuda.launch_counts()
        finally:
            sess.finalize()
        want = "mmm_wgmma" if with_entry else "mmm_skinny"
        assert counts["mmm_wgmma"] + counts["mmm_skinny"] == 1 and counts[want] == 1
        assert _normwise(out, mmm_ref(a, b)) <= TOL[torch.bfloat16]
        db.put(db.key_for(rec, abstract_signature((a, b))),
               TuneEntry(config={"route": "wgmma", "tile_n": 128}, seconds=1e-6,
                         default_seconds=1e-5, source="seed"))
