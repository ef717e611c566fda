"""Port parity for the paged KV cache and chunked prefill: the BlockPool
under the reference's randomized invariant loop (and its counters
against the JAX BlockPool's, op by op), the paged device ops bit for bit
against the JAX functions on the same arenas and tables, the chunk
attentions, gqa_forward's two chunk branches, MLA's chunk step and
Model.prefill_chunk against JAX, and the PagedEngine's greedy tokens
against the port's dense engine and the JAX PagedEngine.

Inputs and weights are made once in numpy from a seed and fed to both
packages (weights through ``params_from_numpy``); the port runs on the
CPU through a session made with ``device="cpu"``.  The chunk paths are
float32 einsums on both sides: rtol/atol 2e-4 (the model tests' 1e-4
normwise, elementwise)."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models import build_model as j_build_model
from repro.serve import kvcache as j_kv
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import StepScheduler as JStepScheduler
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.models import attention as t_attention
from repro_torch.models import build_model
from repro_torch.serve import kvcache as t_kv
from repro_torch.serve.engine import (AdmissionError, AdmissionPolicy,
                                      PagedEngine, QoSClass, SlotEngine,
                                      StepScheduler)

RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


def _pair(jc, tc, seed=0):
    """JAX and port models of the same configuration on the JAX weights."""
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


def _reduced(arch, **kw):
    return _pair(j_get_config(arch).reduced(), get_config(arch).reduced(), **kw)


def _dense_ffn(cfg):
    """deepseek-v2 with dense FFNs in place of its MoE ones: MLA alone."""
    return dataclasses.replace(cfg, stages=tuple(dataclasses.replace(
        st, pattern=tuple(dataclasses.replace(b, moe=None, d_ff=64)
                          for b in st.pattern)) for st in cfg.stages))


@pytest.fixture(scope="module")
def danube(cpu_session):
    return _reduced("h2o-danube-1.8b")


@pytest.fixture(scope="module")
def mamba(cpu_session):
    return _reduced("mamba2-370m")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# (a) the BlockPool under the reference's randomized invariant loop
# ---------------------------------------------------------------------------
BS = 4            # block size for the model-based loop
CAP = 16          # pool capacity (num_blocks - 1)


def _ceil_div(a, b):
    return -(-a // b)


class _Lane:
    """Shadow of one serving lane: its block chain + unspent reservation."""

    def __init__(self, blocks, resv, prompt, pos, limit):
        self.blocks, self.resv, self.prompt = blocks, resv, prompt
        self.pos, self.limit = pos, limit


def _alloc(pool, lane):
    """The engine's allocation rule: spend the lane's reservation first."""
    if lane.resv > 0:
        lane.resv -= 1
        return pool.alloc(reserved=True)
    return pool.alloc()


def _admit(kv, pool, rng, lanes, stems):
    """Reserve worst case, reuse a matched prefix chain, alloc the rest."""
    stem = rng.choice(stems)
    s0 = rng.randrange(1, 4 * BS)
    prompt = (stem + [rng.randrange(256) for _ in range(64)])[:s0]
    max_new = rng.randrange(1, 2 * BS)
    need = _ceil_div(s0 + max_new, BS)
    if not pool.can_reserve(need):
        return                                     # admission gated: no lane
    pool.reserve(need)
    keys = kv.prefix_block_keys(prompt, BS, limit=(s0 - 1) // BS)
    blocks = list(pool.match_prefix(keys))
    lane = _Lane(blocks, need, prompt, len(blocks) * BS, s0 + max_new)
    lanes.append(lane)
    pool.check()
    while lane.pos < s0:                           # prefill the remainder
        blocks.append(_alloc(pool, lane))
        pool.check()
        lane.pos = min(s0, lane.pos + BS)


def _decode(pool, rng, lanes):
    """Write one token: tail alloc at a block boundary; a wrap-style write
    into an existing block forks it when shared, unregisters it when not."""
    if not lanes:
        return
    lane = rng.choice(lanes)
    if lane.pos >= lane.limit:                     # lane exhausted its budget
        return
    if lane.pos % BS == 0 and rng.random() < 0.7:
        lane.blocks.append(_alloc(pool, lane))
    elif lane.blocks:
        i = rng.randrange(len(lane.blocks))        # ring wrap lands anywhere
        bid = lane.blocks[i]
        if pool.refcount(bid) > 1:
            if lane.resv > 0:
                lane.resv -= 1
                lane.blocks[i] = pool.fork(bid, reserved=True)
            elif pool.available() - pool.reserved >= 1:
                lane.blocks[i] = pool.fork(bid)
        elif pool.is_registered(bid):
            pool.unregister(bid)
    lane.pos += 1


def _retire(kv, pool, rng, lanes):
    if not lanes:
        return
    lane = lanes.pop(rng.randrange(len(lanes)))
    if rng.random() < 0.6:                         # publish prompt blocks
        for i, key in enumerate(kv.prefix_block_keys(lane.prompt, BS)):
            if i < len(lane.blocks) and pool.refcount(lane.blocks[i]) >= 1:
                pool.register_prefix(lane.blocks[i], key)
    for bid in lane.blocks:
        pool.deref(bid)
    pool.unreserve(lane.resv)


def drive(seed, steps=60, kv=t_kv):
    """One random interleaving on ``kv``'s BlockPool; checks invariants
    after every operation and returns (pool, stats after every op)."""
    rng = random.Random(seed)
    pool = kv.BlockPool(CAP + 1, BS)
    stems = [[rng.randrange(256) for _ in range(3 * BS)] for _ in range(3)]
    lanes, trace = [], []
    for _ in range(steps):
        op = rng.random()
        if op < 0.25:
            _admit(kv, pool, rng, lanes, stems)
        elif op < 0.8:
            _decode(pool, rng, lanes)
        else:
            _retire(kv, pool, rng, lanes)
        pool.check()
        trace.append(pool.stats())
    while lanes:                                   # drain
        _retire(kv, pool, rng, lanes)
        pool.check()
        trace.append(pool.stats())
    assert pool.live_blocks() == 0                 # every refcount back at 0
    assert pool.reserved == 0
    assert pool.available() == pool.capacity       # zero leaked blocks
    return pool, trace


def test_random_interleavings_never_leak():
    """520 random admit/decode/fork/retire interleavings: no leak, no
    double free, refcounts back to zero at drain; the sweep reaches prefix
    hits, forks and evictions."""
    hits = forks = evictions = 0
    for seed in range(520):
        pool, _ = drive(seed)
        hits += pool.prefix_hits
        forks += pool.forks
        evictions += pool.evictions
    assert hits > 100 and forks > 100 and evictions > 20


def test_pool_counts_what_the_reference_counts():
    """The same interleavings on the JAX BlockPool: every stats() after
    every operation equal, counters (allocs, forks, evictions, prefix hits
    and queries) included."""
    for seed in range(0, 520, 13):
        _, got = drive(seed, kv=t_kv)
        _, want = drive(seed, kv=j_kv)
        assert got == want, seed


@given(seed=st.integers(0, 2**32 - 1), steps=st.integers(1, 120))
@settings(max_examples=10, deadline=None, database=None)
def test_random_interleavings_hypothesis(seed, steps):
    drive(seed, steps)


def test_double_free_raises():
    pool = t_kv.BlockPool(8, BS)
    bid = pool.alloc()
    pool.deref(bid)
    with pytest.raises(ValueError, match="double free"):
        pool.deref(bid)
    pool.check()


def test_exhaustion_raises_not_corrupts():
    pool = t_kv.BlockPool(4, BS)                   # capacity 3
    bids = [pool.alloc() for _ in range(3)]
    with pytest.raises(t_kv.NoFreeBlocks):
        pool.alloc()
    pool.check()
    for b in bids:
        pool.deref(b)
    assert pool.available() == pool.capacity


def test_reservations_gate_unreserved_allocs():
    pool = t_kv.BlockPool(6, BS)                   # capacity 5
    pool.reserve(4)
    pool.alloc()                                   # 1 beside the reservation
    with pytest.raises(t_kv.NoFreeBlocks):
        pool.alloc()                               # would invade it
    assert pool.alloc(reserved=True) is not None   # the reservation itself
    pool.check()
    with pytest.raises(ValueError):
        pool.unreserve(4)                          # only 3 still reserved


def test_fork_requires_sharing_and_moves_one_ref():
    pool = t_kv.BlockPool(8, BS)
    bid = pool.alloc()
    with pytest.raises(ValueError, match="unshared"):
        pool.fork(bid)
    pool.ref(bid)                                  # second lane joins
    new = pool.fork(bid)                           # second lane goes private
    assert new != bid
    assert pool.refcount(bid) == 1 and pool.refcount(new) == 1
    pool.check()


def test_match_revives_from_reusable_and_eviction_unregisters():
    pool = t_kv.BlockPool(4, BS)                   # capacity 3
    keys = t_kv.prefix_block_keys([1, 2, 3, 4, 5, 6, 7, 8], BS)
    chain = [pool.alloc(), pool.alloc()]
    for bid, key in zip(chain, keys):
        assert pool.register_prefix(bid, key)
    for bid in chain:
        pool.deref(bid)                            # park on the reusable LRU
    assert pool.live_blocks() == 0
    assert pool.match_prefix(keys) == chain        # revived, ref'd again
    for bid in chain:
        pool.deref(bid)
    # allocation pressure evicts LRU reusable blocks and their registration
    got = [pool.alloc() for _ in range(3)]
    assert pool.evictions >= 2 and set(chain) <= set(got)
    assert pool.match_prefix(keys) == []
    pool.check()


def test_prefix_block_keys_chain():
    toks = list(range(10))
    keys = t_kv.prefix_block_keys(toks, 4)
    assert keys == [(0, 1, 2, 3), (0, 1, 2, 3, 4, 5, 6, 7)]
    assert t_kv.prefix_block_keys(toks, 4, limit=1) == [(0, 1, 2, 3)]
    assert t_kv.prefix_block_keys(toks[:3], 4) == []
    assert keys == j_kv.prefix_block_keys(toks, 4)


def _seq_arenas(layout, paged):
    return [(ls, a) for ls, a in zip(pytree.tree_leaves(layout),
                                     pytree.tree_leaves(paged)) if ls.kind == "seq"]


def test_cow_fork_never_mutates_shared_block():
    """Fork a shared block, write the fork: the source block's bytes stay,
    and a reader tabled on the original still sees them."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    bs, nblocks, max_len = 4, 9, 16
    layout = t_kv.leaf_layout(cfg, max_len)
    paged = t_kv.init_paged(cfg, slots=2, max_len=max_len, num_blocks=nblocks,
                            block_size=bs)
    for _, a in _seq_arenas(layout, paged):
        a[:, 1] = 1.0
    before = [a[:, 1].clone() for _, a in _seq_arenas(layout, paged)]
    t_kv.copy_block(layout, paged, 1, 2)           # slot 1 forks block 1 -> 2
    for _, a in _seq_arenas(layout, paged):
        a[:, 2] *= -3.0                            # and overwrites its copy
    for (_, a), b in zip(_seq_arenas(layout, paged), before):
        assert torch.equal(a[:, 1], b)
        assert bool((a[:, 2] == -3.0).all())
    views = t_kv.gather_views(layout, paged, torch.tensor([[1, 0, 0, 0], [2, 0, 0, 0]]), bs)
    for ls, v in zip(pytree.tree_leaves(layout), pytree.tree_leaves(views)):
        first = torch.movedim(v, ls.seq_axis, -1)[..., :bs]
        assert bool((first[:, 0] == 1.0).all()) and bool((first[:, 1] == -3.0).all())


# ---------------------------------------------------------------------------
# (b) the paged device ops, bit for bit against the JAX functions
# ---------------------------------------------------------------------------
def _mla_dense():
    return (_dense_ffn(j_get_config("deepseek-v2-236b").reduced()),
            _dense_ffn(get_config("deepseek-v2-236b").reduced()))


PAGED_CFGS = {"danube": lambda: (j_get_config("h2o-danube-1.8b").reduced(),
                                 get_config("h2o-danube-1.8b").reduced()),
              "zamba2": lambda: (j_get_config("zamba2-1.2b").reduced(),
                                 get_config("zamba2-1.2b").reduced()),
              "deepseek-mla": _mla_dense}


def _random_arenas(cfg, slots, max_len, nblocks, bs, rng):
    """The same random arenas as numpy (for JAX) and torch (for the port);
    block 0 stays zero."""
    paged = t_kv.init_paged(cfg, slots, max_len, nblocks, bs)
    layout = t_kv.leaf_layout(cfg, max_len)
    for ls, a in zip(pytree.tree_leaves(layout), pytree.tree_leaves(paged)):
        vals = torch.from_numpy(rng.standard_normal(tuple(a.shape)).astype(np.float32))
        a.copy_(vals.to(a.dtype))
        if ls.kind == "seq":
            a[:, 0] = 0
    return layout, paged


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _assert_tree_equal(got, want):
    g, w = pytree.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(PAGED_CFGS))
def test_paged_ops_match_jax_bit_for_bit(name):
    """leaf_layout and ring_lengths as JAX plans them; gather_views,
    scatter_token (inactive lanes to the null block), scatter_slots and
    copy_block on the same random arenas and block tables as JAX's, bit
    for bit (GQA rings and full leaves, MLA's latent leaves, Mamba lane
    leaves)."""
    jc, tc = PAGED_CFGS[name]()
    rng = np.random.default_rng(7)
    slots, max_len, bs, nblocks = 3, 40, 4, 40
    layout, paged = _random_arenas(tc, slots, max_len, nblocks, bs, rng)
    jlayout = j_kv.leaf_layout(jc, max_len)
    assert [dataclasses.astuple(s) for s in pytree.tree_leaves(layout)] == \
        [dataclasses.astuple(s) for s in jax.tree.leaves(
            jlayout, is_leaf=lambda x: isinstance(x, j_kv.LeafSpec))]
    assert t_kv.ring_lengths(layout, max_len) == j_kv.ring_lengths(jlayout, max_len)
    jpaged = _to_jax(paged)
    tables = rng.permutation(np.arange(1, nblocks))[:slots * 10].reshape(slots, 10)
    tables[2, 7:] = 0                                   # padded entries
    views = t_kv.gather_views(layout, paged, torch.from_numpy(tables), bs)
    jviews = j_kv.gather_views(jlayout, jpaged, jnp.asarray(tables, jnp.int32), bs)
    _assert_tree_equal(views, jviews)

    # the decode step's written entries: new random views, then the scatter
    for v in pytree.tree_leaves(views):
        v.copy_(torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)))
    pos, active = np.array([5, 37, 12]), np.array([True, True, False])
    jviews = _to_jax(views)
    t_kv.scatter_token(layout, paged, views, torch.from_numpy(tables),
                       torch.from_numpy(pos), torch.from_numpy(active), bs)
    jpaged = j_kv.scatter_token(jlayout, jpaged, jviews, jnp.asarray(tables, jnp.int32),
                                jnp.asarray(pos, jnp.int32), jnp.asarray(active), bs)
    _assert_tree_equal(paged, jpaged)
    for ls, a in zip(pytree.tree_leaves(layout), pytree.tree_leaves(paged)):
        if ls.kind == "seq":
            assert not bool(a[:, 0].any())              # the null block stays 0

    for ls, a, v, jls, ja, jv in zip(pytree.tree_leaves(layout), pytree.tree_leaves(paged),
                                     pytree.tree_leaves(views),
                                     jax.tree.leaves(jlayout, is_leaf=lambda x: isinstance(
                                         x, j_kv.LeafSpec)),
                                     jax.tree.leaves(jpaged), jax.tree.leaves(jviews)):
        if ls.kind != "seq":
            continue
        n = min(9, ls.length)
        slots_ = (11 + np.arange(n)) % ls.length
        one = v.narrow(1, 1, 1).contiguous()
        t_kv.scatter_slots(ls, a, one, torch.from_numpy(tables[1]),
                           torch.from_numpy(slots_), bs)
        want = j_kv.scatter_slots(jls, ja, jax.lax.slice_in_dim(jv, 1, 2, axis=1),
                                  jnp.asarray(tables[1], jnp.int32),
                                  jnp.asarray(slots_, jnp.int32), bs)
        assert np.array_equal(a.numpy(), np.asarray(want))
    jpaged = _to_jax(paged)
    t_kv.copy_block(layout, paged, int(tables[0, 3]), int(tables[2, 1]))
    jpaged = j_kv.copy_block(jlayout, jpaged, jnp.int32(tables[0, 3]),
                             jnp.int32(tables[2, 1]))
    _assert_tree_equal(paged, jpaged)


# ---------------------------------------------------------------------------
# (c) the chunk attentions, gqa_forward's chunk branches, MLA's chunk step
# ---------------------------------------------------------------------------
def _attn_cfg(window):
    a = get_config("h2o-danube-1.8b").reduced().stages[0].pattern[0].attn
    return dataclasses.replace(a, n_heads=4, n_kv_heads=2, window=window)


@pytest.mark.parametrize("p0", [[0, 16], [24, 40], [50, 8]])
def test_chunk_attentions_match_jax(p0):
    """chunk_attention over a full-length cache (window mask, and a prefix)
    and chunk_ring_attention over a 32-slot ring (before the wrap, across
    it, and long after), lanes at different positions, float32."""
    rng = np.random.default_rng(sum(p0))
    b, c, dh, lc = 2, 8, 32, 32
    q = rng.standard_normal((b, 4, c, dh)).astype(np.float32)
    full_k, full_v = (rng.standard_normal((b, 2, 64, dh)).astype(np.float32) for _ in "kv")
    ring_k, ring_v = (rng.standard_normal((b, 2, lc, dh)).astype(np.float32) for _ in "kv")
    kn, vn = (rng.standard_normal((b, 2, c, dh)).astype(np.float32) for _ in "kv")
    p0 = np.asarray(p0)
    t = torch.from_numpy
    for a_t, prefix in ((_attn_cfg(None), 0), (_attn_cfg(20), 0), (_attn_cfg(20), 6)):
        a_j = dataclasses.replace(j_get_config("h2o-danube-1.8b").reduced().stages[0]
                                  .pattern[0].attn, **{f.name: getattr(a_t, f.name) for f in
                                                       dataclasses.fields(a_t)})
        got = t_attention.chunk_attention(t(q), t(full_k), t(full_v), t(p0), a_t,
                                          prefix_len=prefix)
        want = j_attention.chunk_attention(q, full_k, full_v, jnp.asarray(p0), a_j,
                                           prefix_len=prefix)
        _close(got, want)
    a_t = _attn_cfg(lc)
    a_j = dataclasses.replace(j_get_config("h2o-danube-1.8b").reduced().stages[0]
                              .pattern[0].attn, n_heads=4, n_kv_heads=2, window=lc)
    got = t_attention.chunk_ring_attention(t(q), t(ring_k), t(ring_v), t(kn), t(vn),
                                           t(p0), a_t)
    want = j_attention.chunk_ring_attention(q, ring_k, ring_v, kn, vn, jnp.asarray(p0), a_j)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 32])
def test_gqa_chunk_branches_match_jax(cpu_session, window):
    """gqa_forward's multi-token cache step: a 32-slot ring (attend over
    old ring ‖ chunk, then write) and a full-length 64-slot cache (write,
    then per-query masks), on the JAX weights; output and both caches."""
    jm, jp, tm, tp = _reduced("h2o-danube-1.8b")
    a_t = dataclasses.replace(tm.cfg.stages[0].pattern[0].attn, window=window)
    a_j = dataclasses.replace(jm.cfg.stages[0].pattern[0].attn, window=window)
    jw = jax.tree.map(lambda t: t[0], jp["stages"][0][0]["attn"])
    tw = pytree.tree_map(lambda t: t[0], tp["stages"][0][0]["attn"])
    rng = np.random.default_rng(3)
    b, c, lc = 2, 8, 32 if window else 64
    x = rng.standard_normal((b, c, tm.cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, a_t.n_kv_heads, lc, a_t.head_dim)).astype(np.float32)
              for _ in "kv")
    p0 = np.array([20, 44])
    positions = p0[:, None] + np.arange(c)
    want, (jk, jv) = j_attention.gqa_forward(
        jw, jnp.asarray(x), a_j, positions=jnp.asarray(positions),
        cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_pos=jnp.asarray(p0))
    got, (tk, tv) = t_attention.gqa_forward(
        tw, torch.from_numpy(x), a_t, positions=torch.from_numpy(positions),
        cache=(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())),
        cache_pos=torch.from_numpy(p0))
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)


def _chunked_prefill_pair(jm, jp, tm, tp, prompt, chunk, max_len):
    """``prompt`` through prefill_chunk from an empty cache, ``chunk``
    tokens at a time, on both packages: every chunk's logits and the final
    caches compared."""
    jcache = jm.init_cache(1, max_len)
    tcache = tm.init_cache(1, max_len)
    step = jax.jit(jm.prefill_chunk)
    for p0 in range(0, prompt.shape[1], chunk):
        toks = prompt[:, p0:p0 + chunk]
        jl, jcache = step(jp, jcache, jnp.asarray(toks), jnp.int32(p0))
        tl, tcache = tm.prefill_chunk(tp, tcache, torch.from_numpy(toks).long(), p0)
        _close(tl, jl)
    for a, b in zip(pytree.tree_leaves(tcache), jax.tree.leaves(jcache)):
        _close(a, b)
    return tl


PREFILL_CHUNK_CASES = ["h2o-danube-1.8b", "gemma3-4b", "deepseek-mla"]


@pytest.mark.parametrize("arch", PREFILL_CHUNK_CASES)
def test_prefill_chunk_matches_jax(cpu_session, arch):
    """Model.prefill_chunk from an empty cache, chunks of 20 over a
    40-token prompt: danube's 32-slot rings wrap, gemma3-4b's 5 local ring
    layers beside its global full-length one, the dense-FFN deepseek's
    latent cache; every chunk's logits and the caches against JAX; the
    last chunk's logits against a whole-prompt prefill too."""
    if arch == "deepseek-mla":
        jm, jp, tm, tp = _pair(*_mla_dense())
    else:
        jm, jp, tm, tp = _reduced(arch)
    assert tm.supports_chunked_prefill() == jm.supports_chunked_prefill() is True
    prompt = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (1, 40)).astype(np.int32)
    last = _chunked_prefill_pair(jm, jp, tm, tp, prompt, 20, 48)
    whole, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()})
    assert float((last - whole).norm() / whole.norm()) <= 1e-4


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-236b", "paligemma-3b", "musicgen-large",
                                  "h2o-danube-1.8b", "gemma3-4b", "gemma-7b",
                                  "mistral-large-123b"])
def test_supports_chunked_prefill_as_the_reference(arch):
    """Mamba and MoE blocks, stub frontends and prefix-LM configurations
    report False, as the reference's do."""
    got = build_model(get_config(arch)).supports_chunked_prefill()
    assert got == j_build_model(j_get_config(arch)).supports_chunked_prefill()


# ---------------------------------------------------------------------------
# (d) the PagedEngine against the dense engine and the JAX PagedEngine
# ---------------------------------------------------------------------------
def _serve(engine, prompts, max_new, seed=3):
    sched = StepScheduler(engine, seed=seed)
    futs = [sched.submit(list(p), max_new=n) for p, n in zip(prompts, max_new)]
    sched.drain()
    return [f.result(timeout=60) for f in futs]


def _serve_jax(engine, prompts, max_new):
    sched = JStepScheduler(engine, seed=3)
    futs = [sched.submit(list(p), max_new=n) for p, n in zip(prompts, max_new)]
    sched.drain()
    return [f.result(timeout=60) for f in futs]


def _drive_pair(model, params, prompts, max_new, *, max_len=48, slots=2, **paged_kw):
    """The same workload through the dense and paged engines; returns
    (dense outputs, paged outputs, paged engine)."""
    dense = _serve(SlotEngine(model, params, slots=slots, max_len=max_len), prompts, max_new)
    eng = PagedEngine(model, params, slots=slots, max_len=max_len, **paged_kw)
    return dense, _serve(eng, prompts, max_new), eng


def test_paged_whole_prompt_bit_parity(danube):
    """chunk_tokens=0: the dense engine's prefill, so greedy outputs equal
    the dense engine's and the JAX PagedEngine's — decode past the SWA
    ring wrap included (prompt 30 + 14 > window 32); every block back."""
    jm, jp, tm, tp = danube
    prompts = [[3, 1, 4, 1, 5], list(range(1, 31)), [9, 9, 8], [2] * 12]
    budgets = [3, 14, 6, 4]
    dense, paged, eng = _drive_pair(tm, tp, prompts, budgets, block_size=8, chunk_tokens=0)
    assert dense == paged
    assert paged == _serve_jax(JPagedEngine(jm, jp, slots=2, max_len=48, block_size=8,
                                            chunk_tokens=0), prompts, budgets)
    eng.pool.check()
    assert eng.pool.live_blocks() == 0 and eng.pool.reserved == 0


def test_paged_whole_prompt_bit_parity_lane_state(mamba):
    """Mamba lanes carry O(1) state (no sequence axis): the paged engine
    still serves them (admission accounting only), tokens equal the dense
    engine's, and the lane leaves are the dense pool's bit for bit."""
    _, _, tm, tp = mamba
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12, 13]]
    dense_eng = SlotEngine(tm, tp, slots=2, max_len=24)
    dense = _serve(dense_eng, prompts, [4, 6, 2])
    eng = PagedEngine(tm, tp, slots=2, max_len=24, block_size=8)
    assert _serve(eng, prompts, [4, 6, 2]) == dense
    assert all(s.kind == "lane" for s in pytree.tree_leaves(eng.layout))
    eng.pool.check()
    assert eng.pool.live_blocks() == 0


def test_paged_chunked_prefill_matches_dense(danube):
    """Greedy outputs across chunked-prefill boundaries (prompt 30, chunk
    16, block 8) equal the dense engine's and the JAX PagedEngine's, and
    admission really was chunked."""
    jm, jp, tm, tp = danube
    assert tm.supports_chunked_prefill()
    prompts = [list(range(1, 31)), [7, 7, 7], list(range(40, 58))]
    budgets = [6, 4, 6]
    dense, paged, eng = _drive_pair(tm, tp, prompts, budgets, block_size=8, chunk_tokens=16)
    assert dense == paged
    assert paged == _serve_jax(JPagedEngine(jm, jp, slots=2, max_len=48, block_size=8,
                                            chunk_tokens=16), prompts, budgets)
    assert eng.chunk_tokens == 16 and eng.tokens_cached == sum(map(len, prompts)) + sum(
        n - 1 for n in budgets)
    eng.pool.check()


def test_paged_shared_prefix_reuses_blocks_and_forks_on_write(danube):
    """A second request arriving once the first is decoding reuses its
    registered 24-token prefix chain (prefix hits); the SWA ring wrap then
    writes into a shared block while both lanes are live, forcing a COW
    fork.  Outputs equal the dense engine's, the counters the JAX
    engine's, and every block returns at drain."""
    jm, jp, tm, tp = danube
    shared = list(range(100, 124))                 # exactly 3 blocks of 8
    prompts = [shared + [1, 2, 3, 4, 5], shared + [9, 8, 7, 6, 5, 4]]
    dense = _serve(SlotEngine(tm, tp, slots=2, max_len=48), prompts, [14, 14])

    def run(eng, sched):
        f1 = sched.submit(prompts[0], max_new=14)
        while sched.active() == 0 or any(
                lane is not None and lane.prefilling for lane in sched._lanes):
            sched.step()                           # finish req 1's prefill
        f2 = sched.submit(prompts[1], max_new=14)  # arrives mid-decode
        sched.drain()
        return [f1.result(timeout=60), f2.result(timeout=60)], eng.stats()

    eng = PagedEngine(tm, tp, slots=2, max_len=48, block_size=8, chunk_tokens=16)
    got, st_ = run(eng, StepScheduler(eng, seed=3))
    jeng = JPagedEngine(jm, jp, slots=2, max_len=48, block_size=8, chunk_tokens=16)
    jgot, jst = run(jeng, JStepScheduler(jeng, seed=3))
    assert got == dense == jgot
    assert st_["prefix_hits"] >= 3                 # chain reused at admit
    assert st_["forks"] >= 1                       # COW on the wrap write
    assert st_ == jst
    eng.pool.check()
    assert eng.pool.live_blocks() == 0 and eng.pool.reserved == 0


def test_paged_admission_depth_cap_rejects(danube):
    _, _, tm, tp = danube
    eng = PagedEngine(tm, tp, slots=1, max_len=48, block_size=8)
    sched = StepScheduler(eng, policy=AdmissionPolicy(classes={"bulk": QoSClass(max_depth=1)}))
    keep = sched.submit([1, 2, 3], max_new=2, qos="bulk")
    with pytest.raises(AdmissionError, match="queue is full"):
        sched.submit([4, 5, 6], max_new=2, qos="bulk")
    other = sched.submit([4, 5, 6], max_new=2)     # other classes unaffected
    sched.drain()
    assert len(keep.result(timeout=60)) == 2 and len(other.result(timeout=60)) == 2
    assert sched.rejected == 1


def test_paged_admission_max_delay_expires_queued(danube):
    """A queued request older than its class max_delay fails with
    AdmissionError at the next step instead of waiting forever."""
    _, _, tm, tp = danube
    eng = PagedEngine(tm, tp, slots=1, max_len=48, block_size=8)
    sched = StepScheduler(eng, policy=AdmissionPolicy(classes={"rt": QoSClass(max_delay=0.0)}))
    doomed = sched.submit([1, 2, 3], max_new=4, qos="rt")
    sched.drain()
    with pytest.raises(AdmissionError, match="waited"):
        doomed.result(timeout=60)
    assert sched.expired == 1
    ok = sched.submit([1, 2, 3], max_new=2)        # engine still serves
    sched.drain()
    assert len(ok.result(timeout=60)) == 2


def test_paged_watermark_defers_admission_until_blocks_free(danube):
    """A request that would dip the arena below the watermark waits in the
    queue until a lane retires, then serves (deferred, not dropped)."""
    _, _, tm, tp = danube
    # capacity 13: each (prompt 8 + max_new 8) lane needs 2 blocks
    eng = PagedEngine(tm, tp, slots=2, max_len=48, block_size=8, num_blocks=14)
    sched = StepScheduler(eng, policy=AdmissionPolicy(watermark=0.77))
    futs = [sched.submit([i] * 8, max_new=8) for i in range(3)]
    # floor = int(0.77 * 13) = 10: the empty arena (13 - 2 = 11) admits one
    # lane; with it holding a block and a reservation the next must wait
    assert sched.step()
    assert sched.active() == 1 and sched.pending() == 2
    sched.drain()
    for f in futs:
        assert len(f.result(timeout=60)) == 8
    eng.pool.check()


def test_paged_failed_decode_releases_blocks(danube):
    """A decode failure frees every failed lane's blocks (no arena leak),
    and later submissions serve as the dense engine does."""
    _, _, tm, tp = danube
    eng = PagedEngine(tm, tp, slots=2, max_len=48, block_size=8)
    sched = StepScheduler(eng)
    real_decode = eng.decode_step

    def exploding_decode(*args, **kwargs):
        raise RuntimeError("injected paged decode failure")

    eng.decode_step = exploding_decode
    fut = sched.submit(list(range(1, 10)), max_new=6)
    with pytest.raises(RuntimeError, match="injected"):
        sched.step()
    with pytest.raises(RuntimeError):
        fut.result(timeout=60)
    eng.pool.check()
    assert eng.pool.live_blocks() == 0 and eng.pool.reserved == 0
    assert eng.pool.available() == eng.pool.capacity
    assert eng.ensure_caches()
    eng.decode_step = real_decode
    assert _serve(eng, [[1, 2, 3]], [4]) == _serve(SlotEngine(tm, tp, 2, 48), [[1, 2, 3]], [4])


def test_paged_failed_chunk_releases_blocks(danube):
    """A chunk that fails mid-prefill releases its lane's blocks and the
    slot; the scheduler goes on serving."""
    _, _, tm, tp = danube
    eng = PagedEngine(tm, tp, slots=1, max_len=48, block_size=8, chunk_tokens=8)
    sched = StepScheduler(eng)
    real = eng.continue_admission
    eng.continue_admission = lambda slot: (_ for _ in ()).throw(RuntimeError("injected chunk"))
    fut = sched.submit(list(range(1, 20)), max_new=2)
    sched.step()
    with pytest.raises(RuntimeError, match="injected chunk"):
        fut.result(timeout=60)
    assert eng.pool.live_blocks() == 0 and eng.pool.reserved == 0 and sched.active() == 0
    eng.continue_admission = real
    assert len(_serve(eng, [list(range(1, 20))], [3])[0]) == 3


def test_paged_stats_keys_match_the_reference(danube):
    jm, jp, tm, tp = danube
    got = PagedEngine(tm, tp, slots=2, max_len=48, block_size=8).stats()
    want = JPagedEngine(jm, jp, slots=2, max_len=48, block_size=8).stats()
    assert sorted(got) == sorted(want) and got == want


def _fork_bound_loop(eng, prompt_len, max_new):
    """The reference's _fork_bound: the wrapped ring slots' blocks, position
    by position, within the registered block range."""
    if not eng.prefix_sharing or not eng._rings:
        return 0
    if any(prompt_len > length for length in eng._rings):
        return 0
    wrapped = set()
    for length in eng._rings:
        for p in range(prompt_len, prompt_len + max_new):
            if p >= length:
                wrapped.add((p % length) // eng.block_size)
    return len(wrapped & set(range(prompt_len // eng.block_size)))


def _windows(cfg, windows):
    """``cfg`` with its attention blocks' windows replaced in turn."""
    st0 = cfg.stages[0]
    pattern = tuple(dataclasses.replace(b, attn=dataclasses.replace(b.attn, window=w))
                    for b, w in zip(st0.pattern * len(windows), windows))
    return dataclasses.replace(cfg, stages=(dataclasses.replace(st0, pattern=pattern,
                                                                repeats=1),))


def test_fork_bound_closed_form_equals_the_reference_loop(cpu_session):
    """The closed-form _fork_bound against the reference's loop over every
    prompt length and budget up to max_len, at ring sets {32}, {20, 32}
    and {12}, block sizes 4, 8 and 5."""
    for windows in ((32,), (20, 32), (12,)):
        tc = _windows(get_config("h2o-danube-1.8b").reduced(), windows)
        tm = build_model(tc)
        tp = tm.init(torch.Generator().manual_seed(0))
        for bs in (4, 8, 5):
            eng = PagedEngine(tm, tp, slots=1, max_len=48, block_size=bs, num_blocks=4)
            assert eng._rings == sorted(set(windows))
            for p_len in range(1, 48):
                for n in range(1, 49 - p_len):
                    assert eng._fork_bound(p_len, n) == _fork_bound_loop(eng, p_len, n), \
                        (windows, bs, p_len, n)


@pytest.mark.parametrize("arch,slots,max_len,bs,chunk", [
    ("h2o-danube-1.8b", 2, 48, 8, None), ("h2o-danube-1.8b", 4, 100, 16, 16),
    ("h2o-danube-1.8b", 3, 61, 5, 0), ("gemma3-4b", 2, 70, 8, 16),
    ("mamba2-370m", 2, 24, 8, None), ("deepseek-mla", 2, 40, 4, 8)])
def test_default_num_blocks_equals_the_reference(cpu_session, arch, slots, max_len, bs, chunk):
    if arch == "deepseek-mla":
        jm, jp, tm, tp = _pair(*_mla_dense())
    else:
        jm, jp, tm, tp = _reduced(arch)
    got = PagedEngine(tm, tp, slots, max_len, block_size=bs, chunk_tokens=chunk)
    want = JPagedEngine(jm, jp, slots, max_len, block_size=bs, chunk_tokens=chunk)
    assert (got.num_blocks, got.chunk_tokens, got.prefix_sharing, got.blocks_per_lane) \
        == (want.num_blocks, want.chunk_tokens, want.prefix_sharing, want.blocks_per_lane)


def test_paged_engine_refuses_a_foreign_device(cpu_session):
    """Parameters on another device than the session's are refused: the
    engine never moves the model, and never falls back to the CPU."""
    tm = build_model(get_config("h2o-danube-1.8b").reduced())
    tp = pytree.tree_map(lambda t: t.to("meta"), tm.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="HALO session runs on cpu"):
        PagedEngine(tm, tp, 1, 32)


# ---------------------------------------------------------------------------
# (e) the chip's shared-system-prompt traffic, on a narrow twin
# ---------------------------------------------------------------------------
def test_shared_system_prompt_traffic_hits_56_blocks(cpu_session):
    """The traffic of the card's chunked paged danube leg on a 2-layer,
    narrow danube whose window stays 4096: 8 requests of 512 and 4200
    tokens on 4 slots, block 16, chunk 256, budgets 16/12/8/4 twice;
    requests 5 and 7 begin with request 1's first 448 tokens (28 blocks).
    Request 1 registers its 32 blocks after its second chunk; 5 and 7 each
    match 28 of them (56 hits), no block is evicted, and every block comes
    back at drain."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    st0 = cfg.stages[0]
    cfg = dataclasses.replace(cfg, stages=(dataclasses.replace(st0, pattern=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, window=4096))
        for b in st0.pattern)),))
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (512, 4200)[i % 2]).tolist() for i in range(8)]
    for i in (4, 6):
        prompts[i][:448] = prompts[0][:448]
    budgets = [16, 12, 8, 4] * 2
    max_len = 4200 + 16 + 8
    eng = PagedEngine(tm, tp, slots=4, max_len=max_len, block_size=16, chunk_tokens=256)
    assert eng.num_blocks == 4 * (264 + 8) + 1
    out = _serve(eng, prompts, budgets)
    assert [len(r) for r in out] == budgets
    st_ = eng.stats()
    assert st_["prefix_hits"] == 56 and st_["evictions"] == 0 and st_["forks"] == 0
    eng.pool.check()
    assert eng.pool.live_blocks() == 0 and eng.pool.reserved == 0
