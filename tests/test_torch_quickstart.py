"""The slice as a whole on the CPU: repro_torch.quickstart's seven aliases,
blocking and asynchronous, against the JAX package's repro.halo
claim/send/recv with claims pinned to its Pallas records (interpret mode),
on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import halo as jhalo
from repro_torch import halo, quickstart
from repro_torch.core.compute_object import from_numpy, to_numpy

N = 128
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _numpy_jobs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32

    def normal(*shape, shift=0.0):
        return (rng.standard_normal(shape).astype(np.float32) + shift).astype(dt)

    a, b = normal(N, N), normal(N, N, shift=3.0)
    x = normal(N)
    return {"MMM": (a, b), "EWMM": (a, b), "EWMD": (a, b), "EWADD": (a, b),
            "EWSUB": (a, b), "MVM": (a, x), "VDP": (x, x)}


def _jax_results(jobs):
    jhalo.initialize()
    try:
        out = {}
        for alias, args in jobs.items():
            cr = jhalo.claim(alias, overrides={"allowed_platforms": ["pallas"]})
            jhalo.send(tuple(jnp.asarray(a) for a in args), cr)
            out[alias] = np.asarray(jhalo.recv(cr), np.float32)
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
            got = to_numpy(out).astype(np.float32)
            assert got.shape == ref[alias].shape, (alias, mode)
            np.testing.assert_allclose(got, ref[alias], err_msg=f"{alias} {mode}",
                                       **TOL[dtype])
        want = torch.float32 if alias == "VDP" else getattr(torch, dtype)
        assert sync[alias].dtype == want
    # every request ran on the hopper substrate (plain versions on the CPU)
    assert cpu_session.agents["hopper"].metrics["requests"] == 14
    assert cpu_session.scheduler.failed_record_keys() == []


def test_make_jobs_shapes_and_seed():
    sizes = {"MMM": 8, "EW": 6, "MVM": 5, "VDP": 33}
    jobs = quickstart.make_jobs(sizes, "cpu", seed=3)
    assert [tuple(t.shape) for t in jobs["MMM"]] == [(8, 8), (8, 8)]
    assert [tuple(t.shape) for t in jobs["EWMD"]] == [(6, 6), (6, 6)]
    assert bool((jobs["EWMD"][1] > 0).float().mean() > 0.9)     # shifted +3
    assert [tuple(t.shape) for t in jobs["MVM"]] == [(5, 5), (5,)]
    assert [tuple(t.shape) for t in jobs["VDP"]] == [(33,), (33,)]
    assert float(jobs["VDP"][0] @ jobs["VDP"][1]) > 0           # mean 1 each
    again = quickstart.make_jobs(sizes, "cpu", seed=3)
    assert all(torch.equal(u, v) for k in jobs for u, v in zip(jobs[k], again[k]))
    assert all(t.dtype == torch.float32 for v in jobs.values() for t in v)


def test_quickstart_main_on_cpu(capsys):
    quickstart.main(["--device", "cpu", "--n", "32"])
    out = capsys.readouterr().out
    for alias in quickstart.ALIASES:
        assert f"{alias}" in out
    assert "all finite=True" in out
    assert "T1 per call" in out
