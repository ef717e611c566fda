"""Port parity for FFT, SORT and HIST: repro_torch's ops (CPU → plain
version), oracles and library rows against the JAX package's Pallas ops
(interpret mode) and ref.py on the same numpy inputs, in float32 and
bfloat16, at ragged sizes; the wrappers' refusals; and tests that pin three
behaviours of the reference the port does not copy:

* FFT: the reference forms the twiddle angle 2π/n·t·k in float32, which
  costs ~1e-4 of normwise accuracy at n = 1000; the port takes its angles
  in float64 (the chirp's j² reduced mod 2n in integers) and rounds each
  table entry once, and is held to 1e-5 against float64.
* SORT: the reference's bitonic network takes jnp.minimum/maximum, so one
  NaN turns its whole row to NaN; the port orders NaN last, as np.sort.
* HIST: the jitted Pallas wrapper takes lo and hi as static arguments, so
  XLA turns the division by the width into a multiply by its float32
  reciprocal, and the Pallas kernel then bins some edge values one bin
  lower than the eager oracle, which divides; and XLA on the CPU flushes
  subnormal inputs to zero.  The port divides as IEEE float32 does, as the
  binning contract says.  Where the width is a power of two all agree bit
  for bit.

Tolerances: the reference's conformance ones (tests/test_kernels_property.py:
float32 2e-4, bfloat16 4e-2, and its FFT float32 override 1e-3/5e-3); FFT
against float64 at normwise 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fft import ops as j_fft_ops
from repro.kernels.sorthist import ops as j_sh_ops
from repro.kernels.sorthist import ref as j_sh_ref
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.core.registry import KernelRegistry
from repro_torch.kernels import register_all
from repro_torch.kernels.fft import ops as t_fft_ops
from repro_torch.kernels.fft import ref as t_fft_ref
from repro_torch.kernels.sorthist import ops as t_sh_ops
from repro_torch.kernels.sorthist import ref as t_sh_ref

DTYPES = ["float32", "bfloat16"]
#: the reference's FFT conformance tolerance (float32 override; bfloat16
#: inputs are exact in float32, so the same arithmetic follows)
FFT_TOL = dict(rtol=1e-3, atol=5e-3)
#: normwise error of the port's FFT against the float64 DFT
FFT_NORMWISE = 1e-5


def _dt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else np.float32


def _normal(seed, *shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32).astype(_dt(dtype))


def _normwise(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _nan_equal(a, b):
    """Equal, counting NaN as NaN (and −0.0 as +0.0)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def _ieee_hist(x, bins, lo, hi):
    """The binning contract in numpy: float32 lo, hi and width, an IEEE
    float32 division, the clip after the range test."""
    x = np.asarray(x, np.float32).reshape(-1)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    width = np.float32((hi - lo) / bins)
    keep = (x >= lo32) & (x <= hi32)
    q = np.floor((x[keep] - lo32) / width)
    ids = np.clip(q, 0, bins - 1).astype(np.int64)
    return np.bincount(ids, minlength=bins).astype(np.float32)


def hist_edge_values(bins, lo, hi, seed=0):
    """float32 values on every bin edge lo + k·width (in float32 and rounded
    from float64), one step either side of each unless that step is
    subnormal, lo, hi, nextafter(hi, +inf), below lo, NaN, ±inf, and
    uniform values over [lo − 1, hi + 1]."""
    lo32, w32 = np.float32(lo), np.float32((hi - lo) / bins)
    k = np.arange(bins + 1)
    edges = np.concatenate([lo32 + k.astype(np.float32) * w32,
                            (lo + k * ((hi - lo) / bins)).astype(np.float32)])
    steps = np.concatenate([np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf))])
    steps = steps[np.abs(steps) >= np.finfo(np.float32).tiny]
    hi32 = np.float32(hi)
    ends = np.array([lo, hi, np.nextafter(hi32, np.float32(np.inf)), lo - 1.0,
                     np.nan, np.inf, -np.inf], np.float32)
    uniform = np.random.default_rng(seed).uniform(lo - 1, hi + 1, 3000)
    return np.concatenate([edges, steps, ends, uniform.astype(np.float32)])


@pytest.fixture(scope="module")
def registry():
    reg = KernelRegistry()
    register_all(reg)
    return reg


# ---------------------------------------------------------------------------
# FFT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 128), (3, 200), (2, 1000), (200,)],
                         ids=["4x128", "3x200", "2x1000", "1-D"])
def test_fft_matches_jax_and_float64(dtype, shape):
    x = _normal(sum(shape), *shape, dtype=dtype)
    want = np.asarray(j_fft_ops.fft(jnp.asarray(x), interpret=True))
    exact = np.fft.fft(np.asarray(x, np.float64), axis=-1)
    tx = from_numpy(x)
    for fn in (t_fft_ops.fft, t_fft_ref.fft_ref, t_fft_ref.fft_aten,
               t_fft_ref.fft_chirp_ref):
        got = fn(tx)
        assert got.dtype == torch.complex64 and tuple(got.shape) == shape
        got = to_numpy(got)
        np.testing.assert_allclose(got, want, err_msg=fn.__name__, **FFT_TOL)
        assert _normwise(got, exact) <= FFT_NORMWISE, fn.__name__


def test_reference_fft_twiddles_err_above_1e5_at_n1000():
    """The reference's float32 angle 2π/n·t·k errs 7e-5 normwise at
    n = 1000; the port's chirp route, its tables rounded once from float64,
    stays within 1e-5 on the same input."""
    x = _normal(11, 4, 1000)
    exact = np.fft.fft(x.astype(np.float64), axis=-1)
    ref_err = _normwise(j_fft_ops.fft(jnp.asarray(x), interpret=True), exact)
    port_err = _normwise(to_numpy(t_fft_ops.fft(from_numpy(x))), exact)
    assert ref_err > FFT_NORMWISE, ref_err
    assert port_err <= FFT_NORMWISE, port_err


@pytest.mark.parametrize("x", [torch.ones(2, 4097), torch.ones(2, 3, 8),
                               torch.ones(8, dtype=torch.int32),
                               torch.ones(()), torch.ones(2, 0)],
                         ids=["n=4097", "3-D", "int32", "0-d", "n=0"])
def test_fft_hopper_row_refuses_what_the_kernel_does_not_take(registry, x):
    assert not t_fft_ops.fft_supported(x)
    with pytest.raises(ValueError, match="FFT"):
        t_fft_ops.fft(x)
    assert registry.select("FFT", x).platform == "aten"


# ---------------------------------------------------------------------------
# SORT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1,), (200,), (129,), (3, 200), (2, 3, 129)],
                         ids=["1", "200", "129", "3x200", "2x3x129"])
def test_sort_matches_jax_bit_for_bit(dtype, shape):
    x = _normal(len(shape) + shape[-1], *shape, dtype=dtype)
    want = np.asarray(j_sh_ops.sort(jnp.asarray(x), interpret=True))
    assert _same_bits(want, np.asarray(j_sh_ref.sort_ref(jnp.asarray(x))))
    tx = from_numpy(x)
    for fn in (t_sh_ops.sort, t_sh_ref.sort_ref, t_sh_ref.sort_aten):
        got = fn(tx)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        assert _same_bits(to_numpy(got), want), fn.__name__


def test_reference_sort_turns_a_row_with_nan_to_nan():
    """jnp.minimum/maximum pass NaN on, so one NaN poisons the reference's
    whole row; the port sorts it last, as np.sort and jnp.sort do."""
    x = _normal(5, 128)
    x[:5] = [3.0, np.nan, 1.0, 2.0, 5.0]
    ref = np.asarray(j_sh_ops.sort(jnp.asarray(x), interpret=True))
    assert np.isnan(ref).all()
    want = np.sort(x)
    assert _nan_equal(np.asarray(j_sh_ref.sort_ref(jnp.asarray(x))), want)
    assert _nan_equal(to_numpy(t_sh_ops.sort(from_numpy(x))), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [100, 129])
def test_sort_ragged_rows_keep_nan_last_and_add_no_inf(dtype, n):
    """Ragged rows hold NaN, ±inf and ±0: NaN lands in the last places and
    no +inf that padding would bring appears."""
    x = _normal(n, 2, n)
    x[:, [3, 7, 11, 20, 30]] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    x[1, 50] = np.nan
    x = x.astype(_dt(dtype))
    got = to_numpy(t_sh_ops.sort(from_numpy(x))).astype(np.float32)
    want = np.sort(x.astype(np.float32), axis=-1)
    assert _nan_equal(got, want)
    for row, nans in ((0, 1), (1, 2)):
        assert np.isnan(got[row, n - nans:]).all()
        assert np.isinf(got[row]).sum() == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_puts_nan_last_whatever_its_sign(dtype):
    """A NaN with its sign bit set sorts last too, as in np.sort and
    jnp.sort (torch.sort on the card puts it first)."""
    x = np.array([3.0, -np.nan, 1.0, np.nan, -np.inf, np.inf, -0.0, 0.0],
                 np.float32)
    assert np.signbit(x[1]) and not np.signbit(x[3])
    x = x.astype(_dt(dtype))
    want = np.sort(x.astype(np.float32))
    assert _nan_equal(np.asarray(j_sh_ref.sort_ref(jnp.asarray(x))), want)
    for fn in (t_sh_ops.sort, t_sh_ref.sort_ref):
        got = to_numpy(fn(from_numpy(x)))
        assert _nan_equal(got, want) and np.isnan(np.asarray(got[-2:], np.float32)).all()


@pytest.mark.parametrize("x", [torch.ones(4, dtype=torch.int32), torch.ones(()),
                               torch.ones(4, dtype=torch.float64)],
                         ids=["int32", "0-d", "float64"])
def test_sort_hopper_row_refuses_what_the_kernel_does_not_take(registry, x):
    assert not t_sh_ops.sort_supported(x)
    with pytest.raises(ValueError, match="SORT"):
        t_sh_ops.sort(x)
    assert registry.select("SORT", x).platform == "aten"


# ---------------------------------------------------------------------------
# HIST
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bins,lo,hi", [(64, 0.0, 1.0), (10, -2.0, 3.0)],
                         ids=["default", "10-bins-over-(-2,3)"])
def test_hist_matches_jax_bit_for_bit_on_edges(dtype, bins, lo, hi):
    """Widths 1/64 and 1/2 are powers of two, so the reference's reciprocal
    multiply is exact there and both packages follow the contract."""
    x = hist_edge_values(bins, lo, hi).astype(_dt(dtype))
    kw = dict(bins=bins, lo=lo, hi=hi)
    if (bins, lo, hi) == (64, 0.0, 1.0):
        kw = {}                                   # the defaults
    want = np.asarray(j_sh_ops.hist(jnp.asarray(x), interpret=True, **kw))
    assert _same_bits(want, np.asarray(j_sh_ref.hist_ref(jnp.asarray(x), **kw)))
    assert _same_bits(want, _ieee_hist(x, bins, lo, hi))
    tx = from_numpy(x)
    for fn in (t_sh_ops.hist, t_sh_ref.hist_ref, t_sh_ref.hist_aten):
        got = fn(tx, **kw)
        assert got.dtype == torch.float32 and got.shape == (bins,)
        assert _same_bits(to_numpy(got), want), fn.__name__


@pytest.mark.parametrize("bins,lo,hi", [(1000, 0.0, 1.0), (7, -2.0, 3.0),
                                        (1, 0.0, 1.0), (3, -1.3, 2.9)])
def test_hist_follows_the_ieee_contract_on_edges(bins, lo, hi):
    """Widths float32 does not hold exactly: the port against the contract
    in numpy and the reference's eager oracle, bit for bit, and the counts
    add up to the values in range."""
    x = hist_edge_values(bins, lo, hi, seed=bins)
    want = _ieee_hist(x, bins, lo, hi)
    assert _same_bits(np.asarray(j_sh_ref.hist_ref(jnp.asarray(x), bins=bins,
                                                   lo=lo, hi=hi)), want)
    tx = from_numpy(x)
    for fn in (t_sh_ops.hist, t_sh_ref.hist_ref, t_sh_ref.hist_aten):
        assert _same_bits(to_numpy(fn(tx, bins=bins, lo=lo, hi=hi)), want)
    in_range = (x >= np.float32(lo)) & (x <= np.float32(hi))
    assert want.sum() == in_range.sum()


def test_reference_pallas_hist_divides_by_the_reciprocal():
    """At 1000 bins over [0, 1] the width 0.001 is not a float32.  The
    reference's jitted Pallas HIST sees lo and hi as constants and XLA
    multiplies by the float32 reciprocal of the width, which bins some of
    the values k/1000 (rounded once to float32) one bin low; its eager
    oracle divides.  The port keeps the oracle's IEEE division."""
    bins = 1000
    x = (np.arange(bins + 1) / bins).astype(np.float32)
    ieee = _ieee_hist(x, bins, 0.0, 1.0)
    ref = np.asarray(j_sh_ref.hist_ref(jnp.asarray(x), bins=bins))
    pallas = np.asarray(j_sh_ops.hist(jnp.asarray(x), bins=bins, interpret=True))
    assert _same_bits(ref, ieee)
    assert not np.array_equal(pallas, ieee) and pallas.sum() == ieee.sum()
    got = to_numpy(t_sh_ops.hist(from_numpy(x), bins=bins))
    assert _same_bits(got, ieee)


def test_reference_hist_counts_a_subnormal_below_lo():
    """XLA on the CPU reads the subnormal −1.4e-45 as −0.0, which lies in
    [0, 1]; the contract drops it (it is below lo = 0)."""
    x = np.array([-np.float32(1.4e-45), 0.5], np.float32)
    assert x[0] < 0
    ref = np.asarray(j_sh_ref.hist_ref(jnp.asarray(x)))
    got = to_numpy(t_sh_ops.hist(from_numpy(x)))
    assert ref.sum() == 2 and got.sum() == 1
    assert _same_bits(got, _ieee_hist(x, 64, 0.0, 1.0))


def test_hist_flattens_and_widens_16_bit_inputs():
    x = _normal(3, 4, 50, 3, dtype="bfloat16")
    tx = from_numpy(x)
    got = t_sh_ops.hist(tx, bins=16, lo=-2.0, hi=2.0)
    assert torch.equal(got, t_sh_ops.hist(tx.float().reshape(-1), bins=16,
                                          lo=-2.0, hi=2.0))
    assert _same_bits(to_numpy(got), _ieee_hist(np.asarray(x, np.float32), 16,
                                                -2.0, 2.0))


def test_hist_one_bin_takes_every_value_in_range():
    x = from_numpy(np.full(10_000, 0.3, np.float32))
    got = t_sh_ops.hist(x)
    assert float(got[19]) == 10_000 and float(got.sum()) == 10_000


@pytest.mark.parametrize("x,kw,match", [
    (torch.ones(4, dtype=torch.int32), {}, "share one of"),
    (torch.ones(4), dict(bins=0), "bin count"),
    (torch.ones(4), dict(lo=1.0, hi=1.0), "lo < hi"),
    (torch.ones(4), dict(lo=0.0, hi=float("inf")), "finite"),
], ids=["int32", "bins=0", "lo=hi", "hi=inf"])
def test_hist_hopper_row_refuses_what_the_kernel_does_not_take(registry, x, kw,
                                                               match):
    assert not t_sh_ops.hist_supported(x, **kw)
    with pytest.raises(ValueError, match=match):
        t_sh_ops.hist(x, **kw)
    if not kw:
        assert registry.select("HIST", x).platform == "aten"


def test_plain_hist_builds_no_values_by_bins_matrix(monkeypatch):
    """The plain version bins with bincount; a one-hot (n × bins) matrix, as
    the reference's oracle builds, would be 16 GB at the phase-3 size."""
    def refuse(*a, **k):
        raise AssertionError("one_hot called")
    monkeypatch.setattr(torch.nn.functional, "one_hot", refuse)
    x = from_numpy(np.linspace(0, 1, 1000, dtype=np.float32))
    assert float(t_sh_ref.hist_ref(x, bins=4096).sum()) == 1000
