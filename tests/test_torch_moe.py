"""Port parity for the mixture-of-experts FFN: the MOE_FFN rows (``torch``
oracle, ``aten`` batched float32 products) against the JAX package's
``grouped_ffn_ref`` and ``grouped_ffn``; the router, the capacity-slot
dispatch and the gate-combine of ``models/moe.py`` against the JAX
package's, slot for slot where tokens are dropped; the reference's routing
invariants (tests/test_moe.py) on the port; ``moe_layer`` with shared
experts against JAX.

Inputs are made in numpy from a seed and fed to both packages; the port
runs on the CPU through a session made with ``device="cpu"``.  Tolerances
are the reference's conformance tolerances (tests/test_kernels_property.py:
float32 rtol = atol = 2e-4, bfloat16 4e-2: records that reduce in another
order differ by ~1e-2 in an 8-bit mantissa)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.kernels.moe_ffn import ops as j_moe_ops
from repro.kernels.moe_ffn import ref as j_moe_ref
from repro.models import moe as j_moe
from repro_torch import halo
from repro_torch.configs.base import MoEConfig
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.kernels.moe_ffn import ops as t_moe_ops
from repro_torch.kernels.moe_ffn import ref as t_moe_ref
from repro_torch.models import moe as t_moe

CONFORMANCE_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
                   "bfloat16": dict(rtol=4e-2, atol=4e-2)}
DTYPES = ["float32", "bfloat16"]
#: a router margin below this may order two experts either way: the two
#: packages sum the same float32 logit products in another order
TIE_MARGIN = 1e-5


def _np(dtype, a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                            else np.float32)


def _close(got, want, dtype):
    got = to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **CONFORMANCE_TOL[dtype])


def _cfgs(**kw):
    fields = dict(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=2.0)
    fields.update(kw)
    return MoEConfig(**fields), JMoEConfig(**fields)


@pytest.fixture(scope="module")
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


def _ffn_inputs(dtype, e=4, c=6, d=24, f=40, seed=0):
    rng = np.random.default_rng(seed)
    return (_np(dtype, rng.standard_normal((e, c, d))),
            _np(dtype, rng.standard_normal((e, d, f)) * d ** -0.5),
            _np(dtype, rng.standard_normal((e, d, f)) * d ** -0.5),
            _np(dtype, rng.standard_normal((e, f, d)) * f ** -0.5))


# ---------------------------------------------------------------------------
# (a) the MOE_FFN rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row", ["torch", "aten"])
@pytest.mark.parametrize("shape", [(4, 6, 24, 40), (8, 4, 64, 32)])
def test_moe_ffn_rows_match_jax(dtype, row, shape):
    """torch row against ``grouped_ffn_ref`` (every product in the input
    type), aten row against ``grouped_ffn`` (float32 h and u)."""
    args = _ffn_inputs(dtype, *shape)
    jfn, tfn = {"torch": (j_moe_ref.grouped_ffn_ref, t_moe_ref.grouped_ffn_ref),
                "aten": (j_moe_ops.grouped_ffn, t_moe_ops.grouped_ffn)}[row]
    want = jfn(*map(jnp.asarray, args))
    got = tfn(*from_numpy(args))
    assert got.dtype == from_numpy(args[0]).dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype)


def test_moe_ffn_aten_row_keeps_h_and_u_in_float32():
    """In bfloat16 the aten row rounds only silu(h)·u and the output: it is
    nearer a float64 FFN of the same inputs than the torch row, which
    rounds h and u too."""
    args = from_numpy(_ffn_inputs("bfloat16", 8, 32, 64, 128, seed=3))
    x, wg, wu, wd = (t.double() for t in args)
    h, u = x @ wg, x @ wu
    exact = (torch.nn.functional.silu(h) * u) @ wd
    err = {name: float((fn(*args).double() - exact).norm() / exact.norm())
           for name, fn in (("aten", t_moe_ops.grouped_ffn),
                            ("torch", t_moe_ref.grouped_ffn_ref))}
    assert err["aten"] < err["torch"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_f32_product_backward_is_the_widened_paths(dtype):
    """ROADMAP C4: the aten row's float32 product of 16-bit CUDA operands
    (bmm with out_dtype, no derivative in torch) takes f32_product_vjp as
    its backward.  Run here on the operands widened as the CPU path widens
    them, the formula gives autograd of that path bit for bit: dx = g·wᵀ,
    dw = xᵀ·g from the float32 cotangent, each rounded once."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 8, 32, generator=g).to(dtype).requires_grad_()
    w = (torch.randn(4, 32, 16, generator=g) / 32 ** 0.5).to(dtype).requires_grad_()
    ct = torch.randn(4, 8, 16, generator=g)
    torch.bmm(x.float(), w.float()).backward(ct)
    dx, dw = t_moe_ops.f32_product_vjp(x.detach(), w.detach(), ct)
    assert dx.dtype == dtype and dw.dtype == dtype
    assert torch.equal(dx, x.grad) and torch.equal(dw, w.grad)


# ---------------------------------------------------------------------------
# (b) routing, dispatch and combine against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,k", [(8, 2), (64, 6)])
def test_route_matches_jax(dtype, e, k):
    """Gates, indices and the aux loss.  The two packages sum the float32
    logit products in another order, so two experts whose probabilities
    lie within TIE_MARGIN may come out in either order (JAX's top_k puts
    the lower index first on an exact tie; torch.topk promises no order);
    every index mismatch must be such a near-tie."""
    tc, jc = _cfgs(n_experts=e, top_k=k)
    rng = np.random.default_rng(e)
    x = _np(dtype, rng.standard_normal((96, 32)))
    w = rng.standard_normal((32, e)).astype(np.float32) * 0.5
    jg, je, jaux = j_moe._route(jnp.asarray(x), jnp.asarray(w), jc)
    tx, tw = from_numpy((x, w))
    tg, te, taux = t_moe._route(tx, tw, tc)
    assert tg.dtype == torch.float32 and te.shape == (96, k)
    probs = t_moe._router_probs(tx, tw)
    te_np, je_np = to_numpy(te), np.asarray(je)
    for r, j in zip(*np.nonzero(te_np != je_np)):
        assert abs(float(probs[r, te_np[r, j]] - probs[r, je_np[r, j]])) < TIE_MARGIN
    _close(tg, jg, "float32")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(to_numpy(tg.sum(-1)), 1.0, rtol=1e-5)


def test_router_logits_are_float32_products():
    """A bfloat16 product would round the logits: the port's probabilities
    are those of float32 products of the bfloat16-rounded operands."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)) / 16
    want = torch.softmax(x.double() @ w.bfloat16().double(), dim=-1)
    got = t_moe._router_probs(x, w)
    rounded = torch.softmax((x @ w.bfloat16()).double(), dim=-1)
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-6
    assert float((rounded - want).abs().max()) > 1e-4


@pytest.mark.parametrize("t", [1, 4, 7, 64, 244, 2048])
def test_capacity_matches_jax(t):
    for e, k in ((8, 2), (64, 6), (160, 6)):
        tc, jc = _cfgs(n_experts=e, top_k=k, capacity_factor=1.25)
        assert t_moe._capacity(t, tc) == j_moe._capacity(t, jc)


def _skewed_eidx(t, e, k, seed=0):
    """Expert choices where experts 0 and 1 take most rows: every row
    names 0 or 1 first, so both overflow any capacity near T·k/E."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 2, (t, 1))
    rest = np.stack([rng.permutation(np.arange(2, e))[:k - 1] for _ in range(t)])
    return np.concatenate([first, rest], axis=1).astype(np.int32)


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (96, 16, 4)])
def test_dispatch_indices_equal_jax_under_drops(t, e, k):
    """Slots are claimed in flattened (token, k) order: with experts 0 and 1
    overflowing, slot and keep equal JAX's element for element, so the
    same rows are dropped; the gathered capacity buffer is equal too."""
    tc, jc = _cfgs(n_experts=e, top_k=k, capacity_factor=1.0)
    c = t_moe._capacity(t, tc)
    eidx = _skewed_eidx(t, e, k)
    js, jk = j_moe._dispatch_indices(jnp.asarray(eidx), t, c, e)
    ts, tk = t_moe._dispatch_indices(torch.from_numpy(eidx).long(), t, c, e)
    assert not np.asarray(jk).all()                       # some rows dropped
    np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk))
    np.testing.assert_array_equal(to_numpy(ts), np.asarray(js))
    x = np.random.default_rng(1).standard_normal((t, 8)).astype(np.float32)
    jxe = j_moe._gather_dispatch(jnp.asarray(x), js, jk, e, c, k)
    txe = t_moe._gather_dispatch(torch.from_numpy(x), ts, tk, e, c, k)
    np.testing.assert_array_equal(to_numpy(txe), np.asarray(jxe))
    gates = np.random.default_rng(2).random((t, k)).astype(np.float32)
    ye = np.random.default_rng(3).standard_normal((e, c, 8)).astype(np.float32)
    want = j_moe._combine(jnp.asarray(ye), js, jk, jnp.asarray(gates), t, k)
    got = t_moe._combine(torch.from_numpy(ye), ts, tk, torch.from_numpy(gates), t, k)
    _close(got, want, "float32")


# ---------------------------------------------------------------------------
# (c) the reference's invariants (tests/test_moe.py), on the port
# ---------------------------------------------------------------------------
def _params(cfg, d, seed, dtype=torch.float32, shared=False):
    g = torch.Generator().manual_seed(seed)
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {"router": torch.randn(d, e, generator=g),
         "we_g": torch.randn(e, d, f, generator=g) * 0.2,
         "we_u": torch.randn(e, d, f, generator=g) * 0.2,
         "we_d": torch.randn(e, f, d, generator=g) * 0.2}
    if shared:
        fs = cfg.n_shared * f
        p.update(ws_g=torch.randn(d, fs, generator=g) * 0.2,
                 ws_u=torch.randn(d, fs, generator=g) * 0.2,
                 ws_d=torch.randn(fs, d, generator=g) * 0.2)
    return {n: (t if n == "router" else t.to(dtype)) for n, t in p.items()}


def test_dispatch_slots_unique_and_capped():
    cfg, _ = _cfgs()
    t = 64
    c = t_moe._capacity(t, cfg)
    g = torch.Generator().manual_seed(0)
    _, eidx, _ = t_moe._route(torch.randn(t, 16, generator=g),
                              torch.randn(16, cfg.n_experts, generator=g), cfg)
    slot, keep = t_moe._dispatch_indices(eidx, t, c, cfg.n_experts)
    kept = slot.reshape(-1)[keep.reshape(-1)]
    assert kept.unique().numel() == kept.numel()
    assert int(kept.max()) < cfg.n_experts * c


def test_dispatch_combine_roundtrip_identity():
    """gather-dispatch → identity expert → gather-combine gives each kept
    token its input times the sum of its kept gates."""
    cfg, _ = _cfgs()
    t, d = 32, 16
    c = t_moe._capacity(t, cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(t, d, generator=g)
    gates, eidx, _ = t_moe._route(x, torch.randn(d, cfg.n_experts, generator=g), cfg)
    slot, keep = t_moe._dispatch_indices(eidx, t, c, cfg.n_experts)
    xe = t_moe._gather_dispatch(x, slot, keep, cfg.n_experts, c, cfg.top_k)
    y = t_moe._combine(xe, slot, keep, gates, t, cfg.top_k)
    w_tot = (gates * keep).sum(-1, keepdim=True)
    torch.testing.assert_close(y, x * w_tot, rtol=1e-4, atol=1e-5)


def test_moe_local_no_drops_matches_dense_mixture(cpu_session):
    """With top_k == n_experts and ample capacity, the MoE is the explicit
    softmax-weighted mixture of every expert."""
    cfg, _ = _cfgs()
    cfg = dataclasses.replace(cfg, top_k=cfg.n_experts, capacity_factor=4.0)
    d, t = 16, 24
    p = _params(cfg, d, 2)
    x = torch.randn(t, d, generator=torch.Generator().manual_seed(3))
    y, _ = t_moe._moe_local(p, x, cfg, "swiglu")
    probs = torch.softmax(x @ p["router"], dim=-1)
    ref = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(x @ p["we_g"][e]) * (x @ p["we_u"][e])
        ref += probs[:, e:e + 1] * (h @ p["we_d"][e])
    torch.testing.assert_close(y, ref, rtol=2e-2, atol=2e-3)


def test_capacity_drops_give_zero_rows(cpu_session):
    """Dropped tokens produce zero output rows, never garbage."""
    cfg, _ = _cfgs(capacity_factor=0.1)
    d, t = 16, 64
    p = _params(cfg, d, 4)
    x = torch.randn(t, d, generator=torch.Generator().manual_seed(5))
    y, _ = t_moe._moe_local(p, x, cfg, "swiglu")
    assert bool(torch.isfinite(y).all())
    assert int((y.abs().amax(dim=1) < 1e-6).sum()) > t // 2


def test_param_specs_match_jax():
    """Shapes, dtypes (the router float32), logical axes and init kinds."""
    tc, jc = _cfgs(n_shared=2)
    t = t_moe.moe_param_specs(48, tc, torch.bfloat16)
    j = j_moe.moe_param_specs(48, jc, jnp.bfloat16)
    assert sorted(t) == sorted(j) == ["router", "we_d", "we_g", "we_u",
                                      "ws_d", "ws_g", "ws_u"]
    for name in t:
        assert (t[name].shape, t[name].logical, t[name].init_kind) == \
            (j[name].shape, j[name].logical, j[name].init_kind)
        assert str(t[name].dtype).split(".")[-1] == jnp.dtype(j[name].dtype).name
    assert t["ws_g"].shape == (48, 2 * tc.d_ff_expert)


# ---------------------------------------------------------------------------
# (d) the whole layer against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_layer_matches_jax(cpu_session, dtype, n_shared):
    """x (2,20,32) through shared experts (dense, MMM) and 8 routed experts
    top-2 at capacity factor 1.25 (some rows dropped), on the same numpy
    weights: output and the weighted aux loss."""
    tc, jc = _cfgs(n_shared=n_shared, capacity_factor=1.25, d_ff_expert=24)
    d = 32
    rng = np.random.default_rng(7 + n_shared)
    specs = j_moe.moe_param_specs(d, jc, jnp.bfloat16 if dtype == "bfloat16"
                                  else jnp.float32)
    w = {n: (rng.standard_normal(s.shape) * s.shape[-2] ** -0.5).astype(np.float32)
         for n, s in specs.items()}
    w = {n: (a if n == "router" else _np(dtype, a)) for n, a in w.items()}
    x = _np(dtype, rng.standard_normal((2, 20, d)))
    jy, jaux = j_moe.moe_layer({n: jnp.asarray(a) for n, a in w.items()},
                               jnp.asarray(x), jc, "swiglu")
    ty, taux = t_moe.moe_layer({n: from_numpy(a) for n, a in w.items()},
                               from_numpy(x), tc, "swiglu")
    assert ty.dtype == from_numpy(x).dtype and tuple(ty.shape) == x.shape
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the layer drops rows at this capacity in both packages
    t = 40
    _, eidx, _ = t_moe._route(from_numpy(x).reshape(t, d), from_numpy(w["router"]), tc)
    _, keep = t_moe._dispatch_indices(eidx, t, t_moe._capacity(t, tc), tc.n_experts)
    assert 0 < int(keep.sum()) <= t * tc.top_k


def test_init_params_draws_stacked_leaves_one_slab_at_a_time(cpu_session):
    """Each slab of a stacked expert leaf is its own draw (no two slabs
    equal), with the spec's scale N(0, 1/fan_in), in the spec's type."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(),
                              dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    we_g = params["stages"][1][0]["moe"]["we_g"]           # (R, E, D, F)
    assert we_g.dtype == torch.bfloat16 and we_g.shape[0] == 2
    assert not torch.equal(we_g[0], we_g[1])
    std = float(we_g.float().std())
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert params["stages"][1][0]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# (e) expert parallelism over a C²MPI device group (DESIGN.md §15)
# ---------------------------------------------------------------------------
#: port member mixes and their JAX counterparts (hopper ↔ pallas: neither
#: has a MOE_FFN row of its own, so both run the registry's fail-safe)
EP_MIXES = {"aten2": (["aten", "aten"], ["xla", "xla"]),
            "mixed4": (["aten", "hopper", "torch", "aten"],
                       ["xla", "pallas", "jnp", "xla"])}


def _ep_inputs(dtype, seed=11):
    """8 experts top-2 at capacity factor 1.25 (rows dropped) with 2 shared
    experts, d 32, x (2,20,32): numpy weights and input."""
    tc, jc = _cfgs(n_shared=2, capacity_factor=1.25, d_ff_expert=24)
    d = 32
    rng = np.random.default_rng(seed)
    specs = j_moe.moe_param_specs(d, jc, jnp.float32)
    w = {n: (rng.standard_normal(s.shape) * s.shape[-2] ** -0.5).astype(np.float32)
         for n, s in specs.items()}
    w = {n: (a if n == "router" else _np(dtype, a)) for n, a in w.items()}
    return tc, jc, w, _np(dtype, rng.standard_normal((2, 20, d)))


def _ep_port(session, platforms, w, x, tc):
    comm = session.comm_split(platforms)
    try:
        return t_moe.moe_expert_parallel({n: from_numpy(a) for n, a in w.items()},
                                         from_numpy(x), tc, "swiglu", comm)
    finally:
        comm.free()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mix", sorted(EP_MIXES))
def test_expert_parallel_matches_jax(cpu_session, dtype, mix):
    """The port's ``moe_expert_parallel`` against the JAX package's on the
    same numpy weights and input, over the matching member mixes: output
    within the conformance tolerance, the weighted aux loss to 1e-5."""
    from repro.core.c2mpi import MPIX_Initialize, halo_session
    tc, jc, w, x = _ep_inputs(dtype)
    t_plats, j_plats = EP_MIXES[mix]
    MPIX_Initialize()
    jcomm = halo_session().comm_split(j_plats)
    try:
        jy, jaux = j_moe.moe_expert_parallel({n: jnp.asarray(a) for n, a in w.items()},
                                             jnp.asarray(x), jc, "swiglu", jcomm)
    finally:
        jcomm.free()
    ty, taux = _ep_port(cpu_session, t_plats, w, x, tc)
    assert ty.dtype == from_numpy(x).dtype and tuple(ty.shape) == x.shape
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype,platforms", [
    ("float32", ["aten", "aten"]),
    ("float32", ["aten", "hopper", "torch", "aten"]),
    ("bfloat16", ["aten", "aten"]),
    ("bfloat16", ["aten"] * 4)])
def test_expert_parallel_is_bit_identical_to_moe_layer(cpu_session, dtype, platforms):
    """Split over the members, the layer changes no bit of ``moe_layer``'s
    single-shard path where every member runs that path's MOE_FFN record
    (aten).  In float32 the torch row's bits equal aten's, so the mixed
    group holds too; in bfloat16 they differ (the torch row rounds h and u
    to bfloat16), so only all-aten groups are held there."""
    tc, _, w, x = _ep_inputs(dtype)
    y0, a0 = t_moe.moe_layer({n: from_numpy(a) for n, a in w.items()},
                             from_numpy(x), tc, "swiglu")
    y, a = _ep_port(cpu_session, platforms, w, x, tc)
    assert torch.equal(y, y0) and torch.equal(a, a0)


def test_expert_parallel_rejects_indivisible_groups(cpu_session):
    tc, _, w, x = _ep_inputs("float32")
    with pytest.raises(ValueError, match="divide"):
        _ep_port(cpu_session, ["aten", "aten", "aten"], w, x, tc)  # 8 % 3


def test_expert_parallel_places_moe_ffn_on_each_members_row(cpu_session):
    """Each member's MOE_FFN node runs on its own substrate's row; a member
    pinned to ``hopper``, which has no MOE_FFN row, runs the registry's
    fail-safe (the torch row), as the reference's ``pallas`` member runs
    its ``jnp`` one.  The scatter's COPY stages stay on the members."""
    tc, _, w, x = _ep_inputs("float32")
    comm = cpu_session.comm_split(["aten", "hopper", "torch", "aten"])
    nodes = {}
    for verb in ("imap", "iscatter"):
        real = getattr(comm, verb)

        def spy(*a, _real=real, _verb=verb, **k):
            out = _real(*a, **k)
            nodes.setdefault(_verb, []).append(out)
            return out
        setattr(comm, verb, spy)
    try:
        t_moe.moe_expert_parallel({n: from_numpy(a) for n, a in w.items()},
                                  from_numpy(x), tc, "swiglu", comm)
    finally:
        del comm.imap, comm.iscatter
        comm.free()
    (ffn,) = nodes["imap"]
    assert [n.alias for n in ffn] == ["MOE_FFN"] * 4
    assert [n.platform for n in ffn] == ["aten", "torch", "torch", "aten"]
    assert len(nodes["iscatter"]) == 4
    for copies in nodes["iscatter"]:
        assert [n.platform for n in copies] == ["aten", "hopper", "torch", "aten"]

