"""Port parity per kernel family: repro_torch's ops (CPU → plain version) and
ref.py against the JAX package's Pallas ops (interpret mode) and ref.py, on
the same numpy inputs, in float32 and bfloat16 at aligned and ragged shapes.

Tolerances are the reference's conformance ones
(tests/test_kernels_property.py: float32 2e-4, bfloat16 4e-2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ewise import ops as j_ew_ops
from repro.kernels.ewise import ref as j_ew_ref
from repro.kernels.matmul import ops as j_mm_ops
from repro.kernels.matmul import ref as j_mm_ref
from repro.kernels.mvm import ops as j_mvm_ops
from repro.kernels.mvm import ref as j_mvm_ref
from repro.kernels.vdp import ops as j_vdp_ops
from repro.kernels.vdp import ref as j_vdp_ref
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.conv1d import ops as t_conv_ops
from repro_torch.kernels.conv1d.conv1d import conv1d_hopper
from repro_torch.kernels.ewise import ops as t_ew_ops
from repro_torch.kernels.ewise import ref as t_ew_ref
from repro_torch.kernels.ewise.ewise import ewise_hopper
from repro_torch.kernels.fft import ops as t_fft_ops
from repro_torch.kernels.fft.fft import fft_chirp_hopper
from repro_torch.kernels.jacobi import ops as t_js_ops
from repro_torch.kernels.jacobi.jacobi import jacobi_hopper
from repro_torch.kernels.matmul import ops as t_mm_ops
from repro_torch.kernels.matmul import ref as t_mm_ref
from repro_torch.kernels.matmul.matmul import mmm_hopper
from repro_torch.kernels.mvm import ops as t_mvm_ops
from repro_torch.kernels.mvm import ref as t_mvm_ref
from repro_torch.kernels.mvm.mvm import mvm_hopper
from repro_torch.kernels.sorthist import ops as t_sh_ops
from repro_torch.kernels.sorthist.sorthist import hist_hopper, sort_hopper
from repro_torch.kernels.spmm import ops as t_sp_ops
from repro_torch.kernels.spmm.spmm import smmm_hopper
from repro_torch.kernels.vdp import ops as t_vdp_ops
from repro_torch.kernels.vdp import ref as t_vdp_ref
from repro_torch.kernels.vdp.vdp import vdp_hopper, vdp_parts

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
DTYPES = ["float32", "bfloat16"]
EW_OPS = ["mul", "div", "add", "sub"]
J_EW = {"mul": (j_ew_ops.ewmm, j_ew_ref.ewmm_ref),
        "div": (j_ew_ops.ewmd, j_ew_ref.ewmd_ref),
        "add": (j_ew_ops.ewadd, j_ew_ref.ewadd_ref),
        "sub": (j_ew_ops.ewsub, j_ew_ref.ewsub_ref)}
T_EW = {"mul": (t_ew_ops.ewmm, t_ew_ref.ewmm_ref),
        "div": (t_ew_ops.ewmd, t_ew_ref.ewmd_ref),
        "add": (t_ew_ops.ewadd, t_ew_ref.ewadd_ref),
        "sub": (t_ew_ops.ewsub, t_ew_ref.ewsub_ref)}


def _np(seed, *shapes, dtype="float32", shift=0.0):
    """Seeded numpy inputs in ``dtype`` (bfloat16 through JAX's numpy type)."""
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    return [(rng.standard_normal(s).astype(np.float32) + shift).astype(dt)
            for s in shapes]


def _both(jax_fn, torch_fn, arrays, **jax_kw):
    """Run both packages on the same numpy arrays; results as float32 numpy,
    with their dtypes."""
    j = jax_fn(*[jnp.asarray(a) for a in arrays], **jax_kw)
    t = torch_fn(*from_numpy(tuple(arrays)))
    return (np.asarray(j, np.float32), str(j.dtype),
            to_numpy(t).astype(np.float32), str(t.dtype).split(".")[-1])


def _assert_pair(pair, dtype, shape):
    j, jdt, t, tdt = pair
    assert jdt == tdt, (jdt, tdt)
    assert t.shape == j.shape == shape
    np.testing.assert_allclose(t, j, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (37, 129, 70)])
def test_mmm_matches_jax(dtype, m, k, n):
    a, b = _np(0, (m, k), (k, n), dtype=dtype)
    _assert_pair(_both(j_mm_ops.mmm, t_mm_ops.mmm, [a, b], interpret=True),
                 dtype, (m, n))
    _assert_pair(_both(j_mm_ref.mmm_ref, t_mm_ref.mmm_ref, [a, b]), dtype, (m, n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", EW_OPS)
@pytest.mark.parametrize("shape", [(64, 128), (37, 129)])
def test_ewise_matches_jax(dtype, op, shape):
    a, = _np(1, shape, dtype=dtype)
    b, = _np(2, shape, dtype=dtype, shift=3.0)
    _assert_pair(_both(J_EW[op][0], T_EW[op][0], [a, b], interpret=True),
                 dtype, shape)
    _assert_pair(_both(J_EW[op][1], T_EW[op][1], [a, b]), dtype, shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k", [(64, 128), (37, 129)])
def test_mvm_matches_jax(dtype, m, k):
    a, x = _np(3, (m, k), (k,), dtype=dtype)
    _assert_pair(_both(j_mvm_ops.mvm, t_mvm_ops.mvm, [a, x], interpret=True),
                 dtype, (m,))
    _assert_pair(_both(j_mvm_ref.mvm_ref, t_mvm_ref.mvm_ref, [a, x]), dtype, (m,))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [4096, 1001])
def test_vdp_matches_jax(dtype, n):
    x, y = _np(4, (n,), (n,), dtype=dtype)
    _assert_pair(_both(j_vdp_ops.vdp, t_vdp_ops.vdp, [x, y], interpret=True),
                 dtype, ())
    _assert_pair(_both(j_vdp_ref.vdp_ref, t_vdp_ref.vdp_ref, [x, y]), dtype, ())


@pytest.mark.parametrize("alias", ["MMM", "EWMM", "MVM", "VDP"])
def test_aten_rows_match_the_oracle(alias):
    """The library rows compute the same function as the fail-safe."""
    a, b = _np(5, (24, 40), (40, 16))
    x, = _np(6, (40,))
    e, = _np(7, (24, 40), shift=3.0)
    args = {"MMM": (a, b), "EWMM": (a, e), "MVM": (a, x), "VDP": (x, x)}[alias]
    fns = {"MMM": (t_mm_ref.mmm_ref, t_mm_ref.mmm_aten),
           "EWMM": (t_ew_ref.ewmm_ref, t_ew_ref.ewmm_aten),
           "MVM": (t_mvm_ref.mvm_ref, t_mvm_ref.mvm_aten),
           "VDP": (t_vdp_ref.vdp_ref, t_vdp_ref.vdp_aten)}[alias]
    ref, aten = (f(*from_numpy(args)) for f in fns)
    assert ref.dtype == aten.dtype and ref.shape == aten.shape
    torch.testing.assert_close(aten, ref, rtol=2e-4, atol=2e-4)


def test_ewise_reads_b_in_a_shape_without_broadcasting():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.full((6,), 2.0)
    assert torch.equal(t_ew_ops.ewmm(a, b), a * 2)
    with pytest.raises(ValueError, match="no broadcasting"):
        t_ew_ops.ewadd(a, torch.ones(3))


@pytest.mark.parametrize("fn,args,match", [
    (t_mm_ops.mmm, (torch.ones(2, 3), torch.ones(4, 2)), "inner dimensions"),
    (t_mm_ops.mmm, (torch.ones(2, 3), torch.ones(3, 2, dtype=torch.float16)),
     "share one of"),
    (t_mm_ops.mmm, (torch.ones(3, 2).t(), torch.ones(3, 2)), "contiguous"),
    (t_mvm_ops.mvm, (torch.ones(2, 3), torch.ones(2)), "inner dimensions"),
    (t_vdp_ops.vdp, (torch.ones(3), torch.ones(4)), "1-D vectors"),
    (t_vdp_ops.vdp, (torch.ones(3, dtype=torch.int32),) * 2, "share one of"),
])
def test_wrappers_reject_what_the_kernel_does_not_take(fn, args, match):
    with pytest.raises(ValueError, match=match):
        fn(*args)


@pytest.mark.parametrize("launch,args", [
    (mmm_hopper, (torch.ones(4, 4), torch.ones(4, 4))),
    (lambda a, b: ewise_hopper(a, b, "div"), (torch.ones(4), torch.ones(4))),
    (mvm_hopper, (torch.ones(4, 4), torch.ones(4))),
    (vdp_hopper, (torch.ones(4), torch.ones(4))),
    (jacobi_hopper, (torch.ones(4, 4), torch.ones(4), torch.ones(4))),
    (conv1d_hopper, (torch.ones(8), torch.ones(3))),
    (smmm_hopper, (torch.ones(2, 1, 4, 8), torch.zeros(2, 1, dtype=torch.int32),
                   torch.ones(16, 3))),
    (fft_chirp_hopper, (torch.ones(2, 12), None)),
    (sort_hopper, (torch.ones(2, 8),)),
    (hist_hopper, (torch.ones(8),)),
])
def test_kernel_wrappers_refuse_host_tensors(launch, args):
    """The kernel wrappers launch or raise: a CPU tensor never reaches a
    silent fallback there, and no launch is counted."""
    before = _cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(*args)
    assert _cuda.launch_counts() == before


def test_plain_versions_count_no_launch():
    before = _cuda.launch_counts()
    a = torch.ones(8, 8)
    t_mm_ops.mmm(a, a)
    t_ew_ops.ewsub(a, a)
    t_mvm_ops.mvm(a, a[0])
    t_vdp_ops.vdp(a[0], a[0])
    t_js_ops.jacobi_solve(a + 8 * torch.eye(8), a[0], iters=2)
    t_conv_ops.conv1d(a[0], a[1, :3])
    t_sp_ops.smmm(a.view(2, 1, 4, 8), torch.zeros(2, 1, dtype=torch.int32), a)
    t_fft_ops.fft(a)
    t_sh_ops.sort(a)
    t_sh_ops.hist(a)
    assert _cuda.launch_counts() == before
    assert set(before) >= {"mmm_skinny", "mmm_wgmma", "mmm_tf32x3", "ewise", "mvm",
                           "vdp", "jacobi", "conv1d", "spmm", "fft_radix", "fft_chirp",
                           "sort", "hist"}
    assert "mmm" not in before


def test_launch_counter_add_and_reset():
    c = _cuda.counter("test-counter")
    c.reset()
    c.add()
    c.add()
    assert _cuda.launch_counts()["test-counter"] == 2
    _cuda.reset_launch_counts()
    assert _cuda.launch_counts()["test-counter"] == 0


def test_vdp_partial_grid_is_fixed_by_input_size():
    assert vdp_parts(1, 4) == 1
    assert vdp_parts(1024, 4) == 1
    assert vdp_parts(1025, 4) == 2
    assert vdp_parts(1 << 26, 4) == 1024
    assert vdp_parts(1 << 26, 2) == 1024
