"""The chirp route of FFT and the 3×TF32 route of MMM on the CPU.

* FFT, chirp route (``csrc/fft_chirp.cu``, every n that is not a power of
  two): ``fft_chirp_ref``, the kernel's plain version (Bluestein's chirp-z
  identity: the row times a chirp, two L-point Stockham FFTs around a
  product with the filter's spectrum), against the JAX package's FFT
  (Pallas, interpret mode) under the reference's FFT tolerance, and against
  ``np.fft.fft`` in float64 up to n = 4095; its tables (the chirp rounded
  once from a float64 angle with j² reduced mod 2n, the filter spectrum
  from a float64 FFT, L the least power of two ≥ 2n − 1) against numpy;
  the table cache; the route and the CPU dispatch by length.
* MMM, 3×TF32 route (``csrc/mmm_wgmma.cu``, float32): ``tf32_round`` bit
  for bit against an independent numpy model of round-to-nearest, ties
  away from zero, to the TF32 grid; ``mmm_tf32x3_ref`` against the
  JAX package's MMM (interpret mode) and a float64 product, also at
  shapes whose K and N are off every multiple of 4; its padded workspace
  (rows of K rounded up to 4, zeros past K) changes no bit of its result;
  models that drop the hi·lo term or keep only hi·hi fall outside the
  float32 ``TOL``; the route; the wrappers' refusals.

Tolerances: the reference's conformance ones (tests/test_kernels_property.py:
float32 2e-4, bfloat16 4e-2, and its FFT float32 override 1e-3/5e-3);
against float64 the card's: FFT normwise 1e-5, MMM float32 normwise 1e-5
(chip_smoke.py ``FFT_TOL`` and ``TOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fft import ops as j_fft_ops
from repro.kernels.matmul import ops as j_mm_ops
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.fft.fft import (CHIRP_LAUNCHES, MAX_N, fft_chirp_hopper,
                                         fft_route)
from repro_torch.kernels.fft import ops as t_fft_ops
from repro_torch.kernels.fft import ref as t_fft_ref
from repro_torch.kernels.matmul import matmul as t_mm
from repro_torch.kernels.matmul import ref as t_mm_ref

FFT_TOL = dict(rtol=1e-3, atol=5e-3)
FFT_NORMWISE = 1e-5
F32_TOL = dict(rtol=2e-4, atol=2e-4)
#: float32 normwise tolerance of the MMM routes on the card
MMM_NORMWISE = 1e-5


def _normal(seed, *shape, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _normwise(got, want):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# FFT, chirp route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [3, 7, 100, 1000])
def test_fft_chirp_ref_matches_jax(dtype, n):
    x = _normal(n, 2, n, dtype=dtype)
    want = np.asarray(j_fft_ops.fft(jnp.asarray(x), interpret=True))
    tx = from_numpy(x)
    for fn in (t_fft_ops.fft, t_fft_ref.fft_chirp_ref):
        got = fn(tx)
        assert got.dtype == torch.complex64 and tuple(got.shape) == (2, n)
        np.testing.assert_allclose(to_numpy(got), want, err_msg=fn.__name__, **FFT_TOL)


@pytest.mark.parametrize("n", [3, 7, 100, 1000, 2999, 3000, 4093, 4095])
def test_fft_chirp_ref_matches_float64(n):
    """Every row, 1-D too, within 1e-5 normwise of the float64 DFT, the
    primes 2999 and 4093 included."""
    for shape in ((3, n), (n,)):
        x = _normal(n + len(shape), *shape)
        got = t_fft_ref.fft_chirp_ref(from_numpy(x))
        assert got.dtype == torch.complex64 and tuple(got.shape) == shape
        exact = np.fft.fft(x.astype(np.float64), axis=-1)
        assert _normwise(to_numpy(got), exact) <= FFT_NORMWISE


def test_chirp_length_is_the_least_power_of_two_that_holds_the_convolution():
    for n in range(1, 4097):
        L = t_fft_ref.chirp_length(n)
        assert L & (L - 1) == 0 and L >= 2 * n - 1 and (L == 1 or L // 2 < 2 * n - 1)
    assert t_fft_ref.chirp_length(3000) == t_fft_ref.chirp_length(4095) == 8192


@pytest.mark.parametrize("n", [3, 7, 100, 2999, 4095])
def test_chirp_is_rounded_once_from_a_float64_angle(n):
    """b_j = exp(−iπ·j²/n) with j² reduced mod 2n in integers and the angle
    taken in float64: each part rounded to float32 once, bit for bit as
    numpy computes it.  The reduction matters: j² reaches 1.7e7 at
    n = 4095, where a float32 j² would already be off."""
    chirp = t_fft_ref.chirp_tables(n, "cpu").chirp
    assert chirp.dtype == torch.complex64 and chirp.shape == (n,)
    j = np.arange(n, dtype=np.int64)
    theta = ((j * j) % (2 * n)).astype(np.float64) * (np.pi / n)
    np.testing.assert_array_equal(to_numpy(chirp.real), np.cos(theta).astype(np.float32))
    np.testing.assert_array_equal(to_numpy(chirp.imag), (-np.sin(theta)).astype(np.float32))


@pytest.mark.parametrize("n", [3, 100, 3000])
def test_chirp_spectrum_is_the_float64_fft_of_the_wrapped_filter(n):
    """H = FFT(h)/L with h_j = conj(b_|j|) wrapped around L, in float64,
    rounded once: within float32's rounding of numpy's."""
    tables = t_fft_ref.chirp_tables(n, "cpu")
    L = t_fft_ref.chirp_length(n)
    j = np.arange(n, dtype=np.int64)
    b = np.exp(-1j * ((j * j) % (2 * n)).astype(np.float64) * (np.pi / n))
    h = np.zeros(L, np.complex128)
    h[:n] = np.conj(b)
    h[L - n + 1:] = np.conj(b[1:])[::-1]
    want = np.fft.fft(h) / L
    got = to_numpy(tables.spectrum)
    assert got.dtype == np.complex64 and got.shape == (L,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7 * np.abs(want).max())
    # one index off shifts the filter: far outside that
    assert np.abs(np.roll(got, 1) - want).max() > 1e-3 * np.abs(want).max()
    tw = to_numpy(tables.twiddles)
    np.testing.assert_array_equal(tw, to_numpy(t_fft_ref.radix_twiddles(L, "cpu")))


@pytest.mark.parametrize("log2L", range(1, 14))
def test_stockham_ref_is_the_complex_fft(log2L):
    """The shared Stockham stages on complex rows, 2 to 8192 points."""
    L = 1 << log2L
    rng = np.random.default_rng(log2L)
    z = (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L))).astype(np.complex64)
    got = t_fft_ref.stockham_ref(torch.from_numpy(z), t_fft_ref.radix_twiddles(L, "cpu"))
    assert _normwise(got.numpy(), np.fft.fft(z.astype(np.complex128))) <= FFT_NORMWISE


def test_chirp_table_cache_is_bounded_and_reused():
    t_fft_ops.cached_chirp_tables.cache_clear()
    first = t_fft_ops.cached_chirp_tables(100, "cpu")
    assert t_fft_ops.cached_chirp_tables(100, "cpu") is first
    for n in (3, 5, 6, 7, 9, 10, 11, 12):       # eight more: 100 goes
        t_fft_ops.cached_chirp_tables(n, "cpu")
    assert t_fft_ops.cached_chirp_tables.cache_info().currsize == 8
    assert t_fft_ops.cached_chirp_tables(100, "cpu") is not first
    t_fft_ops.cached_chirp_tables.cache_clear()


def test_fft_route_is_chirp_for_every_length_not_a_power_of_two():
    routes = {n: fft_route(n) for n in range(1, MAX_N + 1)}
    assert {n for n, r in routes.items() if r == "radix"} == {1 << j for j in range(13)}
    assert set(routes.values()) == {"radix", "chirp"}


def test_fft_chirp_hopper_refuses_host_tensors_and_what_it_does_not_take(monkeypatch):
    before = _cuda.launch_counts()
    x = torch.ones(2, 100)
    tables = t_fft_ref.chirp_tables(100, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fft_chirp_hopper(x, tables)
    # past the device check (stubbed here): a power of two, a table of
    # another n
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    with pytest.raises(ValueError, match="chirp route takes n not a power of two"):
        fft_chirp_hopper(torch.ones(2, 64), tables)
    with pytest.raises(ValueError, match="chirp table"):
        fft_chirp_hopper(torch.ones(2, 101), tables)
    with pytest.raises(ValueError, match="spectrum table"):
        fft_chirp_hopper(x, tables._replace(spectrum=tables.spectrum[:128]))
    assert _cuda.launch_counts() == before


# ---------------------------------------------------------------------------
# MMM, 3×TF32 route
# ---------------------------------------------------------------------------
def _rna_tf32_numpy(x):
    """An independent model of cvt.rna.tf32.f32, in float64 arithmetic
    (exact for these values): each finite float32 value rounded to the TF32
    grid, to nearest with ties away from zero.  TF32 keeps float32's 8-bit
    exponent and 10 stored mantissa bits, so the grid's spacing is
    2^(e − 10) for |x| in [2^e, 2^(e+1)), and 2^-136 below 2^-126 (the
    subnormals)."""
    x = np.asarray(x, np.float32).astype(np.float64)
    _, exp = np.frexp(x)                          # |x| in [2^(exp-1), 2^exp)
    step = np.ldexp(1.0, np.maximum(exp - 11, -136))
    return np.copysign(np.floor(np.abs(x) / step + 0.5) * step, x).astype(np.float32)


def _tie_values():
    """float32 patterns whose low 13 bits are exactly half (ties), just
    below and just above half, of both signs, near 1, in the subnormals and
    near the largest binade; zero and −0."""
    base = np.array([0x3F800000, 0x3FC00000, 0x00000000 + 0x4000, 0x7E800000,
                     0x40490000, 0x3E2AA000], np.uint32)
    lows = np.array([0x1000, 0x0FFF, 0x1001, 0x0000, 0x1FFF, 0x0001], np.uint32)
    bits = (base[:, None] | lows[None, :]).reshape(-1)
    vals = bits.view(np.float32)
    return np.concatenate([vals, -vals, np.array([0.0, -0.0], np.float32)])


def test_tf32_round_matches_a_numpy_model_of_rna_rounding():
    x = np.concatenate([_normal(0, 10_000), _normal(1, 1000) * 1e-30,
                        _normal(2, 1000) * 1e30, _tie_values()])
    got = to_numpy(t_mm_ref.tf32_round(from_numpy(x)))
    want = _rna_tf32_numpy(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # ties go away from zero: 1 + 2^-11 (half of TF32's last place at 1)
    # rounds up, −(1 + 2^-11) down
    half = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(to_numpy(t_mm_ref.tf32_round(from_numpy(half))),
                                  np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10)], np.float32))


def test_tf32_split_is_exact_to_22_bits():
    """hi + lo is x to within 2^-22 of |x|, and x − hi is exact in float32."""
    x = from_numpy(_normal(3, 4096))
    hi, lo = t_mm_ref.tf32_split(x)
    assert torch.equal(hi, t_mm_ref.tf32_round(x)) and torch.equal(lo, t_mm_ref.tf32_round(x - hi))
    xd = x.double()
    assert torch.equal((x - hi).double(), xd - hi.double())
    assert bool(((hi.double() + lo.double() - xd).abs() <= 2.0 ** -22 * xd.abs()).all())


def test_tf32_split_keeps_non_finite_and_near_max_values():
    """±inf and NaN go whole into lo with hi = 0; a finite value that rounding
    to nearest would carry past the largest float32 takes hi by truncation,
    and hi + lo is then still within 2^-22 of it."""
    big = np.finfo(np.float32).max
    x = from_numpy(np.array([np.inf, -np.inf, np.nan, big, -big, np.float32(big) * 0.99999,
                             1.5], np.float32))
    hi, lo = t_mm_ref.tf32_split(x)
    assert torch.equal(hi[:3], torch.zeros(3))
    assert lo[0].item() == np.inf and lo[1].item() == -np.inf and np.isnan(lo[2].item())
    assert bool(torch.isfinite(hi[3:]).all()) and bool(torch.isfinite(lo[3:]).all())
    assert not (to_numpy(hi[3:]).view(np.uint32) & 0x1FFF).any()
    xd = x[3:].double()
    assert bool(((hi[3:].double() + lo[3:].double() - xd).abs() <= 2.0 ** -22 * xd.abs()).all())


def _non_finite_operands(seed, m, k, n):
    """Normal float32 A (m, k) and B (k, n) with ±inf and NaN entries, and
    ±FLT_MAX entries whose products stay finite (times 1/8 to 1/4) or
    overflow (times 2 to 4), in rows of A and in a column of B.  No
    overflowing product meets an infinite column: whether inf plus an
    overflowed product is inf or NaN then hangs on the sum's order and on
    fused multiply-adds, in the reference too."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    big = np.finfo(np.float32).max

    def signed(lo, hi, size):
        return (rng.uniform(lo, hi, size) * rng.choice([-1.0, 1.0], size)).astype(np.float32)

    a[1, 5], a[2, 9], a[4, 0] = np.inf, -np.inf, np.nan
    b[7, 3], b[8, 6] = np.inf, -np.inf
    a[3, 11], b[11] = big, signed(0.125, 0.25, n)
    a[5, 12], b[12] = -big, signed(2.0, 4.0, n)
    b[12, [3, 6]] = 0.5
    b[13, 10], a[:, 13] = big, signed(0.125, 0.25, m)
    return a, b


def test_mmm_tf32x3_ref_keeps_infinities_and_near_max_values():
    """With ±inf, NaN and ±FLT_MAX entries the 3×TF32 model gives NaN and ±inf
    where ``mmm_ref`` does, and elsewhere each entry lies within 1e-5 of
    (|A|·|B|)_ij of the float64 product."""
    a, b = (from_numpy(t) for t in _non_finite_operands(12, 130, 72, 136))
    got, want = t_mm_ref.mmm_tf32x3_ref(a, b), t_mm_ref.mmm_ref(a, b)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf]) and int(inf.sum()) > 136
    finite = torch.isfinite(want)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert bool(((got.double() - exact).abs()[finite]
                 <= MMM_NORMWISE * scale[finite]).all())
    # the split of the seed's design (hi = tf32(x) whatever x) makes NaN
    # of every row and column an infinity or FLT_MAX reaches
    hi = t_mm_ref.tf32_round(a)
    naive = (a - hi) @ t_mm_ref.tf32_round(b) + hi @ (b - t_mm_ref.tf32_round(b)) \
        + hi @ t_mm_ref.tf32_round(b)
    assert int(torch.isnan(naive).sum()) > int(torch.isnan(want).sum())


@pytest.mark.parametrize("m,k,n", [(130, 72, 136), (65, 8, 4), (96, 640, 200)])
def test_mmm_tf32x3_ref_matches_jax_and_float64(m, k, n):
    a, b = _normal(m + k, m, k), _normal(k + n, k, n)
    want = np.asarray(j_mm_ops.mmm(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = t_mm_ref.mmm_tf32x3_ref(from_numpy(a), from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(to_numpy(got), want, **F32_TOL)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert _normwise(to_numpy(got), exact) <= MMM_NORMWISE
    assert _normwise(to_numpy(t_mm_ref.mmm_ref(from_numpy(a), from_numpy(b))),
                     exact) <= MMM_NORMWISE


def test_models_without_the_cross_terms_fall_outside_the_float32_tol():
    """At 256³: the three-product model meets 1e-5 against float64; a
    kernel that dropped hi·lo, or kept only hi·hi (one TF32 product), errs
    by ~2e-4 to ~3e-4, so the card's check catches either."""
    a, b = from_numpy(_normal(10, 256, 256)), from_numpy(_normal(11, 256, 256))
    exact = a.double() @ b.double()

    def err(c):
        return float((c.double() - exact).norm() / exact.norm())

    a_hi, a_lo = t_mm_ref.tf32_split(a)
    b_hi, b_lo = t_mm_ref.tf32_split(b)
    assert err(t_mm_ref.mmm_tf32x3_ref(a, b)) <= MMM_NORMWISE
    assert err(a_lo @ b_hi + a_hi @ b_hi) > 10 * MMM_NORMWISE
    assert err(a_hi @ b_hi) > 10 * MMM_NORMWISE


@pytest.mark.parametrize("m", [65, 512, 4096])
def test_route_sends_aligned_float32_to_tf32x3(m):
    """float32 above SKINNY_M_MAX rows takes the 3×TF32 route at every K,
    N and alignment (K or N off the multiple of 4, operands off the
    16-byte grid: the split pass pads and reads by scalar loads); up to
    SKINNY_M_MAX the skinny route."""
    assert t_mm.mmm_route(torch.float32, m) == "tf32x3"
    assert t_mm.mmm_route(torch.float32, 64) == "skinny"
    for k in (4096, 4094, 4, 1, 777):
        ws_a, ws_b = t_mm_ref.tf32x3_workspace(torch.ones(m, k), torch.ones(k, 3))
        assert tuple(ws_a.shape) == (2 * m, k + (-k) % 4)
        assert tuple(ws_b.shape) == (6, k + (-k) % 4)


def test_mmm_tf32x3_hopper_refuses_host_tensors():
    before = _cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_mm.mmm_tf32x3_hopper(torch.ones(130, 72), torch.ones(72, 136))
    assert _cuda.launch_counts() == before


@pytest.mark.parametrize("dtype,k,n,offset", [(torch.bfloat16, 72, 136, 0),
                                              (torch.float32, 70, 136, 0),
                                              (torch.float32, 72, 134, 0),
                                              (torch.float32, 72, 136, 1)])
def test_mmm_tf32x3_hopper_refuses_16bit_and_pads_what_tma_cannot_load(monkeypatch, dtype,
                                                                        k, n, offset):
    """Past the device check (stubbed here), a 16-bit operand is refused,
    not sent elsewhere; a K or N off the multiple of 4 or an A off the
    16-byte grid is launched on the 3×TF32 route, whose split pass pads."""
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    launched = []
    monkeypatch.setattr(t_mm, "_launch", lambda route, a, b: launched.append(route))
    a = torch.ones(130 * k + offset, dtype=dtype)[offset:].view(130, k)
    if dtype != torch.float32:
        with pytest.raises(ValueError, match="3xTF32 route"):
            t_mm.mmm_tf32x3_hopper(a, torch.ones(k, n, dtype=dtype))
        assert launched == []
    else:
        t_mm.mmm_tf32x3_hopper(a, torch.ones(k, n, dtype=dtype))
        assert launched == ["tf32x3"]


@pytest.mark.parametrize("m,k,n", [(70, 7, 13), (130, 1001, 3), (65, 5, 1), (96, 4094, 200)])
def test_tf32x3_padding_changes_no_bit_of_the_model(m, k, n):
    """The workspace as the split pass writes it, rows of Kp = K rounded up
    to 4 with zeros past K, gives the unpadded parts' result: the pad
    columns meet pad columns only, and each adds an exact zero.  At a K of
    a few columns the CPU's product sums them in one order and the bits
    agree; at a long K the library may block the sum differently for Kp
    than for K, so the two agree to the sum-order error.  A pad column
    left unwritten moves the result far past either."""
    a, b = from_numpy(_normal(m, m, k)), from_numpy(_normal(n, k, n))
    ws_a, ws_b = t_mm_ref.tf32x3_workspace(a, b)
    assert ws_a.shape[1] == ws_b.shape[1] == k + (-k) % 4
    assert not ws_a[:, k:].any() and not ws_b[:, k:].any()
    padded = t_mm_ref.tf32x3_product(ws_a, ws_b)
    plain = t_mm_ref.tf32x3_product(*t_mm_ref.tf32x3_workspace(a, b, kp=k))
    if k <= 8:
        assert torch.equal(padded.view(torch.int32), plain.view(torch.int32))
    else:
        assert _normwise(to_numpy(padded), to_numpy(plain).astype(np.float64)) <= 1e-6
    assert torch.equal(t_mm_ref.mmm_tf32x3_ref(a, b), padded)
    ws_a[:, k:] = 1.0
    ws_b[:, k:] = 1.0
    assert _normwise(to_numpy(t_mm_ref.tf32x3_product(ws_a, ws_b)),
                     to_numpy(plain).astype(np.float64)) > MMM_NORMWISE


@pytest.mark.parametrize("m,k,n", [(70, 7, 13), (130, 1001, 3)])
def test_mmm_tf32x3_ref_matches_jax_off_grid(m, k, n):
    """K and N off every multiple of 4 (the tile route's shapes before):
    the padded model against the JAX MMM and float64."""
    a, b = _normal(m + 1, m, k), _normal(k + 1, k, n)
    want = np.asarray(j_mm_ops.mmm(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = t_mm_ref.mmm_tf32x3_ref(from_numpy(a), from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(to_numpy(got), want, **F32_TOL)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert _normwise(to_numpy(got), exact) <= MMM_NORMWISE


def test_tf32x3_launches_count_apart():
    assert _cuda.counter("mmm_tf32x3") is t_mm.TF32X3_LAUNCHES
    assert _cuda.counter("fft_chirp") is CHIRP_LAUNCHES
    assert "fft" not in _cuda.launch_counts()
