"""The tensor-core route of MMM (``csrc/mmm_wgmma.cu``) on the CPU.

* ``mmm_route`` as a pure function of type and rows: 16-bit operands
  above SKINNY_M_MAX rows take ``wgmma`` and float32 there ``tf32x3``, at
  any K, N and alignment (the CUDA-core tile route is retired); up to
  SKINNY_M_MAX rows every type takes ``skinny``.  ``wgmma_packs``: which
  16-bit operands the tensor-core route packs into its aligned workspace
  (A when K is off a multiple of 8 or A is off the 16-byte grid, B when
  N is off a multiple of 8 or B is off the grid), and ``pack_ref``, the
  pack pass's plain version.
* ``wgmma_tile_n``, the exact tile-width rule, at danube's prefill shapes.
* ``mmm_ulp_excess``, the half-ulp check the card holds the kernel to: 0
  for a sound product, many for one with a K slice dropped, B misread or
  its result rounded toward zero.
* ``mmm_ref`` against the JAX package's MMM (Pallas, interpret mode) in
  bfloat16 at a ragged shape, within the reference's conformance tolerance
  (tests/test_kernels_property.py: bfloat16 4e-2) and within half an ulp
  of the float32 product.
* ``mmm_wgmma_hopper`` refuses host tensors and float32 operands, and
  takes 16-bit operands that TMA cannot load as they lie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import ops as j_mm_ops
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.matmul import matmul as t_mm
from repro_torch.kernels.matmul import ref as t_mm_ref

BF16_TOL = dict(rtol=4e-2, atol=4e-2)
HALF = [torch.bfloat16, torch.float16]
#: danube's prefill projections (K, N): q/o, k/v, gate/up, down
PREFILL = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560)]
H100_SMS = 132


def _normal(seed, *shape, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m", [65, 512, 4200])
@pytest.mark.parametrize("k,n", PREFILL + [(8, 8), (72, 136)])
def test_route_sends_aligned_16bit_prefills_to_wgmma(dtype, m, k, n):
    """Aligned operands are read where they lie; the same shapes off the
    16-byte grid are packed first, on the same route."""
    assert t_mm.mmm_route(dtype, m) == "wgmma"
    assert t_mm.wgmma_packs(k, n, True, True) == (False, False)
    assert t_mm.wgmma_packs(k, n, False, False) == (True, True)


@pytest.mark.parametrize("m", [65, 512, 4096, 4200])
def test_route_sends_float32_above_64_rows_to_tf32x3(m):
    """float32 above SKINNY_M_MAX rows takes the 3×TF32 route at every K, N
    and alignment, where the tile kernel took K or N off the multiple of 4:
    the split pass pads the workspace's rows to Kp = K rounded up to 4."""
    for k, n in PREFILL + [(4096, 4096)]:
        for kk, nn in ((k, n), (k + 2, n), (k, n + 2), (k + 3, n + 1)):
            assert t_mm.mmm_route(torch.float32, m) == "tf32x3"
            ws_a, ws_b = t_mm_ref.tf32x3_workspace(torch.ones(2, kk), torch.ones(kk, 3))
            assert ws_a.shape[1] == ws_b.shape[1] == kk + (-kk) % 4


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("k,n,packs", [(2560, 644, (False, True)),
                                       (2564, 2560, (True, False)),
                                       (777, 1001, (True, True)),
                                       (4, 8, (True, False)), (8, 4, (False, True)),
                                       (0, 8, (False, False)), (8, 0, (False, False))])
def test_route_keeps_k_or_n_off_tma_strides_on_wgmma_and_packs(dtype, k, n, packs):
    """A K or N off TMA's
    16-byte stride stays on the tensor-core route: A is packed when K is
    off a multiple of 8, B when N is; B's rows past K are TMA's zero fill,
    so a K off the multiple needs no copy of B."""
    assert t_mm.mmm_route(dtype, 512) == "wgmma"
    assert t_mm.wgmma_packs(k, n, True, True) == packs


@pytest.mark.parametrize("dtype", HALF + [torch.float32])
@pytest.mark.parametrize("m", [1, 4, 16, 64])
def test_route_sends_few_rows_to_skinny_in_every_type(dtype, m):
    assert t_mm.mmm_route(dtype, m) == "skinny"
    assert t_mm.mmm_route(dtype, t_mm.SKINNY_M_MAX + m) != "skinny"


def test_mmm_hopper_routes_by_type_shape_and_alignment(monkeypatch):
    """The public wrapper passes the operands' type and rows to mmm_route
    and launches what it picks: 16-bit operands TMA cannot load as they
    lie (K off a multiple of 8, A off the 16-byte grid) stay on the
    tensor-core route."""
    routes = []
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(t_mm, "_launch", lambda route, a, b: routes.append(route))
    bf = torch.bfloat16
    off = torch.ones(130 * 72 + 1, dtype=bf)[1:].view(130, 72)
    assert off.data_ptr() % 16
    cases = [(torch.ones(4, 72, dtype=bf), torch.ones(72, 136, dtype=bf)),
             (torch.ones(130, 72, dtype=bf), torch.ones(72, 136, dtype=bf)),
             (torch.ones(130, 72), torch.ones(72, 136)),
             (torch.ones(130, 70, dtype=bf), torch.ones(70, 136, dtype=bf)),
             (off, torch.ones(72, 136, dtype=bf))]
    for a, b in cases:
        t_mm.mmm_hopper(a, b)
    assert routes == ["skinny", "wgmma", "tf32x3", "wgmma", "wgmma"]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("rows,cols,cols_p", [(3, 5, 8), (130, 2558, 2560), (7, 8, 8)])
def test_pack_ref_copies_bits_and_pads_zeros(dtype, rows, cols, cols_p):
    """The pack pass's plain version: the rows' bits where they were, +0 in
    the pad columns; a product of packed operands equals the product of
    the originals (the pad meets zeros)."""
    x = _normal(rows * cols, rows, cols, dtype=dtype)
    packed = t_mm_ref.pack_ref(x, cols_p)
    assert packed.dtype == dtype and tuple(packed.shape) == (rows, cols_p)
    assert torch.equal(packed[:, :cols].view(torch.int16), x.view(torch.int16))
    assert not packed[:, cols:].view(torch.int16).any()
    b = _normal(cols, cols, 9, dtype=dtype)
    padded_b = torch.cat([b, b.new_zeros((cols_p - cols, 9))])
    assert torch.equal(packed.double() @ padded_b.double(), x.double() @ b.double())


# ---------------------------------------------------------------------------
# the tile width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,want", [
    # columns per SM: waves × width, narrow against wide
    (4200, 2560, 128),      # 660 tiles: 5 × 128, against 330: 3 × 256
    (4200, 640, 256),       # 165: 2 × 128, against 99: 1 × 256 (a tie)
    (4200, 6912, 256),      # 1782: 14 × 128, against 891: 7 × 256 (a tie)
    (512, 2560, 128),       # 80: 1 × 128, against 40: 1 × 256
    (512, 640, 128),        # 20: 1 × 128, against 12: 1 × 256
    (512, 6912, 256),       # 216: 2 × 128, against 108: 1 × 256 (a tie)
    (4096, 4096, 256),      # 1024: 8 × 128, against 512: 4 × 256 (a tie)
    (65, 8, 128),           # one tile either way
    (4200, 384, 128),       # 99: 1 × 128, against 66: 1 × 256, a third padding
    (8448, 640, 128),       # 330: 3 × 128, against 198: 2 × 256, a fifth padding
])
def test_wgmma_tile_n_counts_waves_over_the_sms(m, n, want):
    assert t_mm.wgmma_tile_n(m, n, H100_SMS) == want


def test_wgmma_tile_n_follows_the_sm_count():
    """The rule reads the SM count: on a card of 264 SMs 4200x2560 fills
    3 waves of narrow tiles against 2 of wide ones (= 4)."""
    assert t_mm.wgmma_tile_n(4200, 2560, H100_SMS) == 128
    assert t_mm.wgmma_tile_n(4200, 2560, 2 * H100_SMS) == 128
    assert t_mm.wgmma_tile_n(4200, 2560, 660) == 128
    assert t_mm.wgmma_tile_n(4200, 2560, 330) == 256


# ---------------------------------------------------------------------------
# the half-ulp check and the plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m,k,n", [(130, 72, 136), (65, 8, 8), (96, 640, 200)])
def test_ulp_check_passes_a_sound_product_and_fails_a_lost_k_slice(dtype, m, k, n):
    a, b = _normal(m + k, m, k, dtype=dtype), _normal(k + n, k, n, dtype=dtype)
    assert t_mm.mmm_route(dtype, m) == "wgmma"
    assert t_mm_ref.mmm_ulp_excess(t_mm_ref.mmm_ref(a, b), a, b) == 0
    # one K step of 8 (the least TMA can load) left out
    cut = (a[:, 8:].float() @ b[8:].float()).to(dtype)
    assert t_mm_ref.mmm_ulp_excess(cut, a, b) > m * n // 4
    # B's last K step of 8 rows read one column off
    shifted = torch.cat([b[:k - 8], b[k - 8:].roll(1, dims=1)])
    wrong = (a.float() @ shifted.float()).to(dtype)
    assert t_mm_ref.mmm_ulp_excess(wrong, a, b) > m * n // 4


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("m,k,n", [(130, 72, 136), (96, 640, 200), (512, 2560, 640)])
def test_ulp_check_fails_a_product_rounded_toward_zero(dtype, m, k, n):
    """An epilogue that truncates moves an element by up to one ulp: past
    half an ulp wherever r's dropped bits exceed half of |r|'s ulp, a share
    of the elements (in float16 a smaller one: the sum-order term is wider
    there beside half an ulp); the normwise tolerance does not see it."""
    a, b = _normal(m + k, m, k, dtype=dtype), _normal(k + n, k, n, dtype=dtype)
    r = a.float() @ b.float()
    near = r.to(dtype)
    truncated = torch.where(near.float().abs() > r.abs(),
                            torch.nextafter(near, torch.zeros_like(near)), near)
    assert (truncated.float().abs() <= r.abs()).all()
    assert t_mm_ref.mmm_ulp_excess(truncated, a, b) > m * n // 50
    ratios = t_mm_ref.mmm_ulp_ratios(near, a, b)
    assert float(ratios.max()) <= 1.0
    rel = ((truncated.float() - r).norm() / r.norm()).item()
    assert rel < {torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]


def test_mmm_ref_matches_jax_in_bfloat16():
    a = np.random.default_rng(0).standard_normal((130, 72)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((72, 136)).astype(np.float32)
    a, b = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    want = j_mm_ops.mmm(jnp.asarray(a), jnp.asarray(b), interpret=True)
    ta, tb = from_numpy(a), from_numpy(b)
    got = t_mm_ref.mmm_ref(ta, tb)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (130, 136)
    np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                               np.asarray(want, np.float32), **BF16_TOL)
    # both round a float32 sum to nearest: each within half an ulp of the
    # float32 product
    assert t_mm_ref.mmm_ulp_excess(got, ta, tb) == 0
    assert t_mm_ref.mmm_ulp_excess(from_numpy(np.asarray(want)), ta, tb) == 0


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------
def test_mmm_wgmma_hopper_refuses_host_tensors():
    before = _cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_mm.mmm_wgmma_hopper(torch.ones(130, 72, dtype=torch.bfloat16),
                              torch.ones(72, 136, dtype=torch.bfloat16))
    assert _cuda.launch_counts() == before


@pytest.mark.parametrize("dtype,k,n,offset", [(torch.float32, 72, 136, 0),
                                              (torch.bfloat16, 70, 136, 0),
                                              (torch.float16, 72, 132, 0),
                                              (torch.bfloat16, 72, 136, 1)])
def test_mmm_wgmma_hopper_refuses_float32_and_packs_what_tma_cannot_load(monkeypatch, dtype,
                                                                         k, n, offset):
    """Past the device check (stubbed here), float32 is refused, not sent
    elsewhere; a K or N off the multiple of 8 or an A off the 16-byte grid
    is launched on the tensor-core route, which packs what TMA cannot
    load."""
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    launched = []
    monkeypatch.setattr(t_mm, "_launch", lambda route, a, b, **kw: launched.append(route))
    a = torch.ones(130 * k + offset, dtype=dtype)[offset:].view(130, k)
    b = torch.ones(k, n, dtype=dtype)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="tensor-core route"):
            t_mm.mmm_wgmma_hopper(a, b)
        assert launched == []
    else:
        t_mm.mmm_wgmma_hopper(a, b)
        assert launched == ["wgmma"]
        assert t_mm.wgmma_packs(k, n, _cuda.aligned(a), _cuda.aligned(b)) \
            == (k % 8 != 0 or offset != 0, n % 8 != 0)
