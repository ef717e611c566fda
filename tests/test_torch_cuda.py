"""The Hopper kernels on the card: each against its plain version at small
ragged shapes, plus launch counting, run-to-run reproducibility, and the
runtime's handling of the card (caller's stream, no silent fallback).

Marked ``cuda``; every test skips without a CUDA card of capability 9.0.
This file imports no JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.agents import RuntimeAgent
from repro_torch.core.registry import KernelRecord, KernelRegistry
from repro_torch.kernels import _cuda, register_all
from repro_torch.kernels.ewise.ewise import ewise_hopper
from repro_torch.kernels.ewise.ref import OP_REFS
from repro_torch.kernels.matmul.matmul import mmm_hopper
from repro_torch.kernels.matmul.ref import mmm_ref
from repro_torch.kernels.mvm.mvm import mvm_hopper
from repro_torch.kernels.mvm.ref import mvm_ref
from repro_torch.kernels.vdp.ref import vdp_ref
from repro_torch.kernels.vdp.vdp import vdp_hopper

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
#: normwise relative error: float32 differs only in summation order; the
#: 16-bit types also round the output (8- or 11-bit mantissa)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


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
                                   (300, 17, 259)])
def test_mmm_kernel(card, dtype, m, k, n):
    a, b = _rnd(card, m, k, dtype=dtype), _rnd(card, k, n, dtype=dtype, seed=1)
    out = mmm_hopper(a, b)
    assert out.dtype == dtype and out.shape == (m, n)
    assert _normwise(out, mmm_ref(a, b)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(OP_REFS))
@pytest.mark.parametrize("shape", [(1,), (37, 129), (64, 128), (3, 5, 7)])
def test_ewise_kernel_is_bit_exact(card, dtype, op, shape):
    a = _rnd(card, *shape, dtype=dtype)
    b = _rnd(card, *shape, dtype=dtype, seed=1, shift=3.0)
    out = ewise_hopper(a, b, op)
    assert out.shape == a.shape and out.dtype == dtype
    assert torch.equal(_bits(out), _bits(OP_REFS[op](a, b)))


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


def test_each_launch_counts_once(card):
    a = _rnd(card, 16, 16, dtype=torch.float32)
    before = _cuda.launch_counts()
    mmm_hopper(a, a)
    ewise_hopper(a, a, "add")
    mvm_hopper(a, a[0])
    vdp_hopper(a[0], a[0])
    after = _cuda.launch_counts()
    for name in ("mmm", "ewise", "mvm", "vdp"):
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
