"""The skinny-M route of MMM and the radix route of FFT on the CPU.

* MMM: ``mmm_splitk_ref``, the skinny kernel's plain version (float32
  partials over the kernel's own K segments, summed in its fixed order and
  rounded once), against the JAX package's MMM (Pallas, interpret mode) on
  the same numpy inputs, at M of a decode step, with K not a multiple of
  the segment and narrow N; the segment plan; the route threshold.
* FFT: ``fft_radix_ref``, the radix kernel's plain version (the Stockham
  stages in the kernel's order), against ``np.fft.fft`` in float64 at
  every power of two up to 4096 and against the JAX package's FFT
  (interpret mode); the twiddle table; the CPU route by transform length.

Tolerances: the reference's conformance ones (tests/test_kernels_property.py:
float32 2e-4, bfloat16 4e-2, and its FFT float32 override 1e-3/5e-3); FFT
against float64 at normwise 1e-5.  From n = 2048 the reference's own FFT
errs beyond its override (its twiddle angles are formed in float32), so
there the port is held to float64 and the reference's error is pinned.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fft import ops as j_fft_ops
from repro.kernels.matmul import ops as j_mm_ops
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.fft.fft import fft_radix_hopper, fft_route
from repro_torch.kernels.fft import ops as t_fft_ops
from repro_torch.kernels.fft import ref as t_fft_ref
from repro_torch.kernels.matmul import matmul as t_mm
from repro_torch.kernels.matmul import ref as t_mm_ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=4e-2, atol=4e-2)}
FFT_TOL = dict(rtol=1e-3, atol=5e-3)
FFT_NORMWISE = 1e-5
#: danube's decode projections (K, N)
DECODE = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560), (2560, 32000)]


def _normal(seed, *shape, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _normwise(got, want):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# MMM, skinny route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 8, 16])
@pytest.mark.parametrize("k,n", [(777, 40), (130, 24), (2603, 8)],
                         ids=["777x40", "130x24", "2603x8"])
def test_mmm_splitk_ref_matches_jax(dtype, m, k, n):
    a, b = _normal(m + k, m, k, dtype=dtype), _normal(k + n, k, n, dtype=dtype)
    splits, kb, _ = t_mm.skinny_plan(m, n, k, 2 if dtype == "bfloat16" else 4)
    assert k % kb                         # K is not a multiple of the segment
    want = np.asarray(j_mm_ops.mmm(jnp.asarray(a), jnp.asarray(b), interpret=True),
                      np.float32)
    ta, tb = from_numpy(a), from_numpy(b)
    got = t_mm_ref.mmm_splitk_ref(ta, tb)
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(to_numpy(got).astype(np.float32), want, **TOL[dtype])
    np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                               to_numpy(t_mm_ref.mmm_ref(ta, tb)).astype(np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
@pytest.mark.parametrize("k,n", DECODE + [(5, 3), (0, 8), (777, 1001)])
@pytest.mark.parametrize("element_size", [2, 4])
def test_skinny_plan_covers_k_in_segments(m, k, n, element_size):
    splits, kb, kw = t_mm.skinny_plan(m, n, k, element_size)
    assert kb == t_mm.SKINNY_WARPS * kw and kw >= 1
    assert splits * kb >= k and (splits - 1) * kb < max(k, 1)
    assert splits == 1 or kb >= 32
    blocks = splits * cdiv(n, 32 * 16 // element_size) * cdiv(m, 16)
    assert splits == 1 or blocks <= 264     # one wave of two blocks per SM
    if (k, n) in DECODE and n != 640 and m <= 16:
        assert blocks >= 211                # ≥ 80 % of that wave


def test_mmm_route_threshold(monkeypatch):
    """M = SKINNY_M_MAX takes the skinny route in every type, M + 1 a
    tensor-core route at every K, N and alignment (3×TF32 in float32,
    wgmma in bfloat16, also at N = 3, which TMA cannot stride as it lies);
    SKINNY_M_MAX is the only row threshold."""
    top, f32, bf16 = t_mm.SKINNY_M_MAX, torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        assert t_mm.mmm_route(dtype, 1) == "skinny"
        assert t_mm.mmm_route(dtype, top) == "skinny"
    assert t_mm.mmm_route(f32, top + 1) == "tf32x3"
    assert t_mm.mmm_route(f32, 4096) == "tf32x3"
    assert t_mm.mmm_route(bf16, top + 1) == "wgmma"
    assert t_mm.mmm_route(bf16, 1 << 20) == "wgmma"
    routes = []
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(t_mm, "_launch", lambda route, a, b: routes.append(route))
    for m in (1, top, top + 1, 512):
        t_mm.mmm_hopper(torch.ones(m, 8), torch.ones(8, 3))
        t_mm.mmm_hopper(torch.ones(m, 8, dtype=bf16), torch.ones(8, 3, dtype=bf16))
    assert routes == ["skinny"] * 4 + ["tf32x3", "wgmma"] * 2


@pytest.mark.parametrize("launch", [t_mm.mmm_skinny_hopper, t_mm.mmm_hopper])
def test_mmm_route_wrappers_refuse_host_tensors(launch):
    before = _cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(torch.ones(4, 8), torch.ones(8, 3))
    assert _cuda.launch_counts() == before


# ---------------------------------------------------------------------------
# FFT, radix route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("j", range(13))
def test_fft_radix_ref_matches_float64(j):
    n = 1 << j
    for shape in ((3, n), (n,)):
        x = _normal(j, *shape)
        got = t_fft_ref.fft_radix_ref(from_numpy(x))
        assert got.dtype == torch.complex64 and tuple(got.shape) == shape
        exact = np.fft.fft(x.astype(np.float64), axis=-1)
        assert _normwise(to_numpy(got), exact) <= FFT_NORMWISE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", range(11))
def test_fft_radix_matches_jax(dtype, j):
    n = 1 << j
    x = _normal(100 + j, 2, n, dtype=dtype)
    want = np.asarray(j_fft_ops.fft(jnp.asarray(x), interpret=True))
    tx = from_numpy(x)
    for fn in (t_fft_ops.fft, t_fft_ref.fft_radix_ref):
        got = to_numpy(fn(tx))
        np.testing.assert_allclose(got, want, err_msg=fn.__name__, **FFT_TOL)
        exact = np.fft.fft(np.asarray(x, np.float64), axis=-1)
        assert _normwise(got, exact) <= FFT_NORMWISE, fn.__name__


@pytest.mark.parametrize("n", [2048, 4096])
def test_reference_fft_errs_beyond_its_override_from_n2048(n):
    """At n = 2048 and 4096 the reference's FFT (float32 angles) is farther
    from the float64 DFT than its own override allows; the port's radix
    route stays within 1e-5 normwise of it."""
    x = _normal(n, 2, n)
    exact = np.fft.fft(x.astype(np.float64), axis=-1)
    ref = np.asarray(j_fft_ops.fft(jnp.asarray(x), interpret=True))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ref, exact, **FFT_TOL)
    got = to_numpy(t_fft_ops.fft(from_numpy(x)))
    np.testing.assert_allclose(got, exact, **FFT_TOL)
    assert _normwise(got, exact) <= FFT_NORMWISE


def test_radix_twiddles_are_the_dft_twiddles_first_row():
    """w^j = exp(−2πi·j/n) rounded once from float64: the same bits as row 1
    of the DFT's twiddle matrices cos and −sin of 2π·((t·k) mod n)/n, built
    in numpy."""
    n = 96
    tw = t_fft_ref.radix_twiddles(n, "cpu")
    assert tw.dtype == torch.complex64 and tw.shape == (n,)
    t = np.arange(n)
    theta = (np.outer(t, t) % n).astype(np.float64) * (2.0 * np.pi / n)
    np.testing.assert_array_equal(to_numpy(tw.real), np.cos(theta[1]).astype(np.float32))
    np.testing.assert_array_equal(to_numpy(tw.imag), (-np.sin(theta[1])).astype(np.float32))


def test_radix_plan_orders_radix2_first():
    assert t_fft_ref.radix_plan(1) == []
    assert t_fft_ref.radix_plan(2) == [2]
    assert t_fft_ref.radix_plan(8) == [2, 4]
    assert t_fft_ref.radix_plan(4096) == [4] * 6
    assert t_fft_ref.radix_plan(2048) == [2] + [4] * 5


def test_fft_cpu_route_by_length(monkeypatch):
    """Powers of two take the radix plain version, other n the chirp plain
    version ``fft_chirp_ref``, with the L-point spectrum of the least power
    of two L ≥ 2n − 1."""
    assert [fft_route(n) for n in (1, 2, 64, 4096, 3, 100, 4095)] == \
        ["radix"] * 4 + ["chirp"] * 3
    calls = []
    monkeypatch.setattr(t_fft_ops, "fft_radix_ref",
                        lambda x, tw: calls.append(("radix", tuple(tw.shape))))
    monkeypatch.setattr(t_fft_ops, "fft_chirp_ref",
                        lambda x, t: calls.append(("chirp", tuple(t.spectrum.shape))))
    for n in (64, 100, 1, 7):
        t_fft_ops.fft(torch.ones(2, n))
    assert calls == [("radix", (64,)), ("chirp", (256,)), ("radix", (1,)),
                     ("chirp", (16,))]


def test_radix_twiddle_cache_is_reused():
    t_fft_ops.cached_radix_twiddles.cache_clear()
    first = t_fft_ops.cached_radix_twiddles(64, "cpu")
    assert t_fft_ops.cached_radix_twiddles(64, "cpu") is first
    t_fft_ops.cached_radix_twiddles.cache_clear()


@pytest.mark.parametrize("x", [torch.ones(2, 12), torch.ones(2, 8192)],
                         ids=["n=12", "n=8192"])
def test_fft_radix_wrapper_refuses_what_the_kernel_does_not_take(x):
    with pytest.raises(ValueError, match="FFT"):
        fft_radix_hopper(x, torch.ones(x.shape[-1], dtype=torch.complex64))
