"""The slice as a whole on the CPU: repro_torch.quickstart's 13 aliases,
blocking and asynchronous, against the JAX package's repro.halo
claim/send/recv with claims pinned to its Pallas records (interpret mode),
on the same numpy inputs.

The reference's SMMM Pallas record is never feasible (its ``_floaty``
check refuses the int32 index table), so its pinned claim falls to the jnp
fail-safe; test_torch_hpc.py holds SMMM to the Pallas kernel itself.
FFT is held at the reference's FFT tolerance (its twiddle angles are
float32; test_torch_fft_sorthist.py holds the port to float64), SORT and
HIST bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import halo as jhalo
from repro.kernels.spmm.ref import dense_to_bell
from repro_torch import halo, quickstart
from repro_torch.core.compute_object import from_numpy, to_numpy

N = 128
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
#: the reference's FFT override (tests/test_kernels_property.py)
FFT_TOL = dict(rtol=1e-3, atol=5e-3)
#: aliases whose results both packages give bit for bit
EXACT = ("SORT", "HIST")


def _numpy_jobs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32

    def normal(*shape, shift=0.0):
        return (rng.standard_normal(shape).astype(np.float32) + shift).astype(dt)

    a, b = normal(N, N), normal(N, N, shift=3.0)
    x = normal(N)
    # JS: diagonally dominant, x ≠ 0 so the sweep's A·x term counts
    a_dd = (rng.standard_normal((N, N)).astype(np.float32)
            + N * np.eye(N, dtype=np.float32)).astype(dt)
    sig, taps = normal(1000), normal(17)
    # SMMM: 2x1 blocks of 64x128, block row 1 empty, pad slots hold 7.0
    sp = rng.standard_normal((N, N)).astype(np.float32)
    sp[64:] = 0.0
    vals, idx = (np.array(v) for v in dense_to_bell(sp, 64, 128))
    vals[idx < 0] = 7.0
    # HIST: sigmoid(normal) in [0, 1], binned with the defaults
    unit = (1 / (1 + np.exp(-rng.standard_normal(5000)))).astype(np.float32)
    return {"MMM": (a, b), "EWMM": (a, b), "EWMD": (a, b), "EWADD": (a, b),
            "EWSUB": (a, b), "MVM": (a, x), "VDP": (x, x),
            "JS": (a_dd, x, normal(N)), "1DCONV": (sig, taps),
            "SMMM": (vals.astype(dt), idx, normal(N, 96)),
            "FFT": (normal(N // 2, N),), "SORT": (normal(1000),),
            "HIST": (unit.astype(dt),)}


def _host(out):
    """A result as numpy: complex64 for FFT, else float32."""
    out = np.asarray(out)
    return out.astype(np.complex64 if np.iscomplexobj(out) else np.float32)


def _jax_results(jobs):
    jhalo.initialize()
    try:
        out = {}
        for alias, args in jobs.items():
            cr = jhalo.claim(alias, overrides={"allowed_platforms": ["pallas"]})
            jhalo.send(tuple(jnp.asarray(a) for a in args), cr)
            out[alias] = _host(jhalo.recv(cr))
        return out
    finally:
        jhalo.finalize()


@pytest.fixture()
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


@pytest.mark.parametrize("pin", [{"allowed_platforms": ["hopper"]}, None],
                         ids=["pinned-hopper", "selected"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quickstart_matches_jax_halo(cpu_session, dtype, pin):
    np_jobs = _numpy_jobs(dtype)
    ref = _jax_results(np_jobs)
    sync, asyn = quickstart.run(from_numpy(np_jobs), overrides=pin)
    assert list(sync) == list(asyn) == list(quickstart.ALIASES)
    for alias in quickstart.ALIASES:
        for mode, out in (("sync", sync[alias]), ("async", asyn[alias])):
            got = _host(to_numpy(out))
            assert got.shape == ref[alias].shape, (alias, mode)
            if alias in EXACT:
                np.testing.assert_array_equal(got, ref[alias],
                                              err_msg=f"{alias} {mode}")
            np.testing.assert_allclose(
                got, ref[alias], err_msg=f"{alias} {mode}",
                **(FFT_TOL if alias == "FFT" else TOL[dtype]))
        want = {"VDP": torch.float32, "HIST": torch.float32,
                "FFT": torch.complex64}.get(alias, getattr(torch, dtype))
        assert sync[alias].dtype == want
    # every request ran on the hopper substrate (plain versions on the CPU)
    assert cpu_session.agents["hopper"].metrics["requests"] == 26
    assert cpu_session.scheduler.failed_record_keys() == []


def test_make_jobs_shapes_and_seed():
    sizes = {"MMM": 8, "EW": 6, "MVM": 5, "VDP": 33, "JS": 7, "1DCONV": 40,
             "SMMM": 200, "FFT": 12, "SORT": 77, "HIST": 300}
    jobs = quickstart.make_jobs(sizes, "cpu", seed=3)
    assert list(jobs) == list(quickstart.ALIASES)
    assert [tuple(t.shape) for t in jobs["MMM"]] == [(8, 8), (8, 8)]
    assert [tuple(t.shape) for t in jobs["EWMD"]] == [(6, 6), (6, 6)]
    assert bool((jobs["EWMD"][1] > 0).float().mean() > 0.9)     # shifted +3
    assert [tuple(t.shape) for t in jobs["MVM"]] == [(5, 5), (5,)]
    assert [tuple(t.shape) for t in jobs["VDP"]] == [(33,), (33,)]
    assert float(jobs["VDP"][0] @ jobs["VDP"][1]) > 0           # mean 1 each
    a, x, b = jobs["JS"]
    assert [tuple(t.shape) for t in jobs["JS"]] == [(7, 7), (7,), (7,)]
    assert bool((x != 0).all())                                 # x ≠ 0
    off = a.abs().sum(dim=1) - a.diagonal().abs()
    assert bool((a.diagonal().abs() > off).all())               # dominant
    assert [tuple(t.shape) for t in jobs["1DCONV"]] == [(40,), (17,)]
    values, indices, b_sp = jobs["SMMM"]                        # 200 -> 256
    assert values.shape[0] == 4 and values.shape[2:] == (64, 128)
    assert indices.dtype == torch.int32 and tuple(b_sp.shape) == (256, 100)
    assert bool((indices[:, 0] == 0).all())                     # column 0 kept
    assert [tuple(t.shape) for t in jobs["FFT"]] == [(6, 12)]   # n/2 signals
    assert [tuple(t.shape) for t in jobs["SORT"]] == [(77,)]
    unit, = jobs["HIST"]
    assert unit.shape == (300,) and bool(((unit > 0) & (unit < 1)).all())
    again = quickstart.make_jobs(sizes, "cpu", seed=3)
    assert all(torch.equal(u, v) for k in jobs for u, v in zip(jobs[k], again[k]))
    assert all(t.dtype == torch.float32 for k, v in jobs.items() for t in v
               if not (k == "SMMM" and t.dtype == torch.int32))


def test_quickstart_main_on_cpu(capsys):
    quickstart.main(["--device", "cpu", "--n", "32"])
    out = capsys.readouterr().out
    for alias in quickstart.ALIASES:
        assert f"{alias}" in out
    assert "all finite=True" in out
    assert "T1 per call" in out
