"""Port parity for the state-space half of the model path: the SSD rows
(``torch`` scan, ``aten`` chunked form) and SSD_DECODE against the JAX
package's ``ssd_ref``, ``ssd_chunked`` and ``ssd_decode_step``; the
GQA_DECODE rows against the JAX rows; ``mamba_forward`` (prefill, then
decode through its O(1) cache) on the same numpy weights; whole reduced
mamba2-370m and zamba2-1.2b on the JAX package's weights, their slot-engine
tokens against the JAX StepScheduler's, and an inactive lane's state left
bit for bit.

Inputs are made in numpy from a seed and fed to both packages; the port
runs on the CPU through a session made with ``device="cpu"``.  Tolerances
are normwise relative errors: float32 1e-5 for one row (the two sum the
same float32 terms in another order), 1e-4 for a whole model's logits
(rounding differences compound over the layers), bfloat16 1e-2 (an 8-bit
mantissa rounds the output).  The SSM state is float32 in both types."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as j_get_config
from repro.configs.base import SSMConfig as JSSMConfig
from repro.core.registry import KernelRegistry as JKernelRegistry
from repro.kernels import register_all as j_register_all
from repro.kernels.ssd import ops as j_ssd_ops
from repro.kernels.ssd import ref as j_ssd_ref
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro.serve import kvcache as j_kvcache
from repro.serve.engine import SlotEngine as JSlotEngine
from repro.serve.engine import StepScheduler as JStepScheduler
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.configs.base import SSMConfig
from repro_torch.core.compute_object import from_numpy, to_numpy
from repro_torch.core.registry import KernelRegistry
from repro_torch.kernels import register_all
from repro_torch.kernels.ssd import ops as t_ssd_ops
from repro_torch.kernels.ssd import ref as t_ssd_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.models import ssm as t_ssm
from repro_torch.serve import kvcache as t_kvcache
from repro_torch.serve.engine import SlotEngine, StepScheduler

KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
STATE_TOL = 1e-5
MODEL_TOL = 1e-4
DTYPES = ["float32", "bfloat16"]
SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b"]


def _np(dtype, a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                            else np.float32)


def _normwise(got, want) -> float:
    got = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(to_numpy(want) if isinstance(want, torch.Tensor) else want,
                      np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


@pytest.fixture(scope="module")
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


# ---------------------------------------------------------------------------
# (a) SSD and SSD_DECODE
# ---------------------------------------------------------------------------
#: (B, S, H, P, G, N, chunk): S a multiple of the chunk, S off it (the dt = 0
#: padding), two groups on four and on eight heads, S shorter than a chunk
SSD_CASES = {"aligned": (2, 32, 4, 8, 1, 16, 8),
             "ragged": (1, 37, 4, 8, 1, 16, 16),
             "groups2": (2, 21, 4, 8, 2, 16, 8),
             "groups2-h8": (1, 40, 8, 4, 2, 8, 16),
             "short": (2, 5, 4, 8, 1, 16, 16)}


def ssd_inputs(dtype, bsz, seq, h, p, g, n, seed=0):
    """x, b, c in ``dtype``; dt (softplus of a normal), a (negative) and d
    in float32, as mamba_forward feeds them."""
    rng = np.random.default_rng(seed)
    x = _np(dtype, rng.standard_normal((bsz, seq, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((bsz, seq, h)) - 1.0)).astype(np.float32)
    a = (-np.exp(rng.uniform(0.0, 1.5, h))).astype(np.float32)
    b = _np(dtype, rng.standard_normal((bsz, seq, g, n)) * 0.5)
    c = _np(dtype, rng.standard_normal((bsz, seq, g, n)) * 0.5)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, b, c, d


@functools.lru_cache(maxsize=None)
def jax_ssd(dtype, case):
    """The JAX package's scan and chunked form, (y, state) each, on
    ``ssd_inputs`` of ``case`` (computed once for both rows' tests)."""
    bsz, seq, h, p, g, n, q = SSD_CASES[case]
    jargs = [jnp.asarray(v) for v in ssd_inputs(dtype, bsz, seq, h, p, g, n)]
    return (j_ssd_ref.ssd_ref(*jargs, return_state=True),
            j_ssd_ops.ssd_chunked(*jargs, chunk=q, return_state=True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(SSD_CASES))
@pytest.mark.parametrize("row", ["torch", "aten"])
def test_ssd_rows_match_jax(dtype, case, row):
    """The torch row (scan) against ``ssd_ref`` and the aten row (chunked)
    against ``ssd_chunked``, y and the final state; each row also against
    the other package's other form."""
    bsz, seq, h, p, g, n, q = SSD_CASES[case]
    args = ssd_inputs(dtype, bsz, seq, h, p, g, n)
    j_scan, j_chunk = jax_ssd(dtype, case)
    fn = t_ssd_ref.ssd_ref if row == "torch" else t_ssd_ops.ssd_chunked
    y, state = fn(*from_numpy(args), chunk=q, return_state=True)
    assert y.dtype == from_numpy(args[0]).dtype and y.shape == (bsz, seq, h, p)
    assert state.dtype == torch.float32 and state.shape == (bsz, h, p, n)
    same, other = (j_scan, j_chunk) if row == "torch" else (j_chunk, j_scan)
    for want in (same, other):
        assert _normwise(y, want[0]) <= KERNEL_TOL[dtype]
        assert _normwise(state, want[1]) <= STATE_TOL
    # without return_state: y alone, the same values
    assert torch.equal(fn(*from_numpy(args), chunk=q), y)


@pytest.mark.parametrize("q", [16, 37, 5])
def test_ssd_chunked_padding_leaves_the_state_unchanged(q):
    """dt = 0 steps are identity updates: the state of 37 positions read in
    chunks of ``q`` (16 pads to 48; 37 is one chunk; 5 divides nothing)
    equals the scan's."""
    args = from_numpy(ssd_inputs("float32", 1, 37, 4, 8, 1, 16, seed=3))
    _, want = t_ssd_ref.ssd_ref(*args, return_state=True)
    _, got = t_ssd_ops.ssd_chunked(*args, chunk=q, return_state=True)
    assert _normwise(got, want) <= STATE_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_step_matches_jax(dtype, groups):
    rng = np.random.default_rng(groups)
    bsz, h, p, n = 3, 4, 8, 16
    hst = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    x_t = _np(dtype, rng.standard_normal((bsz, h, p)))
    dt_t = np.abs(rng.standard_normal((bsz, h))).astype(np.float32)
    a = (-np.exp(rng.uniform(0, 1, h))).astype(np.float32)
    b_t = _np(dtype, rng.standard_normal((bsz, groups, n)))
    c_t = _np(dtype, rng.standard_normal((bsz, groups, n)))
    d = rng.standard_normal(h).astype(np.float32)
    args = (hst, x_t, dt_t, a, b_t, c_t, d)
    jh, jy = j_ssd_ops.ssd_decode_step(*[jnp.asarray(v) for v in args])
    targs = from_numpy(args)
    th, ty = t_ssd_ops.ssd_decode_step(*targs)
    assert ty.dtype == targs[1].dtype and th.dtype == torch.float32
    assert _normwise(th, jh) <= STATE_TOL
    assert _normwise(ty, jy) <= KERNEL_TOL[dtype]
    assert torch.equal(targs[0], from_numpy(hst))        # h is not written


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["ragged", "groups2"])
def test_ssd_decode_fed_every_step_reaches_the_scans_state(dtype, case):
    """SSD_DECODE fed S steps from a zero state: each y_t is the scan's and
    the last state its final one."""
    bsz, seq, h, p, g, n, _ = SSD_CASES[case]
    x, dt, a, b, c, d = from_numpy(ssd_inputs(dtype, bsz, seq, h, p, g, n, seed=5))
    y_scan, h_scan = t_ssd_ref.ssd_ref(x, dt, a, b, c, d, return_state=True)
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for t in range(seq):
        state, y_t = t_ssd_ops.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                               b[:, t], c[:, t], d)
        ys.append(y_t)
    assert _normwise(state, h_scan) <= STATE_TOL
    assert _normwise(torch.stack(ys, 1), y_scan) <= KERNEL_TOL[dtype]


# ---------------------------------------------------------------------------
# (b) the registry rows
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def registries():
    treg, jreg = KernelRegistry(), JKernelRegistry()
    register_all(treg)
    j_register_all(jreg)
    return treg, jreg


@pytest.mark.parametrize("alias", ["SSD", "SSD_DECODE", "GQA_DECODE", "MOE_FFN"])
def test_rows_are_torch_and_aten_only(registries, alias):
    treg, jreg = registries
    rows = {r.platform: r for r in treg.records(alias)}
    assert set(rows) == {"torch", "aten"}
    assert rows["torch"].is_failsafe and rows["torch"].priority == 0
    assert rows["aten"].priority == 10
    assert {r.platform for r in jreg.records(alias)} == {"jnp", "xla"}


def test_port_registers_twenty_of_the_references_aliases(registries):
    """Twenty when SSD, SSD_DECODE and GQA_DECODE came; MOE_FFN made 21;
    the training aliases LM_GRAD and ADAMW_STEP (ROADMAP A8) make all 23,
    each on torch, aten and hopper rows."""
    treg, jreg = registries
    assert set(jreg.aliases()) - set(treg.aliases()) == set()
    assert len(set(treg.aliases()) & set(jreg.aliases())) == 23
    for alias in ("LM_GRAD", "ADAMW_STEP"):
        rows = {r.platform: r.fn for r in treg.records(alias)}
        assert set(rows) == {"torch", "aten", "hopper"}
        assert len(set(rows.values())) == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row", ["torch", "aten"])
@pytest.mark.parametrize("window", [None, 6])
def test_gqa_decode_rows_match_jax(registries, dtype, row, window):
    """One query row (and three) over 17 cached keys on 2 KV heads for 8
    heads: the end-aligned causal mask, with and without a window."""
    treg, jreg = registries
    tfn = next(r.fn for r in treg.records("GQA_DECODE") if r.platform == row)
    jfn = next(r.fn for r in jreg.records("GQA_DECODE")
               if r.platform == {"torch": "jnp", "aten": "xla"}[row])
    rng = np.random.default_rng(11)
    for sq in (1, 3):
        q = _np(dtype, rng.standard_normal((2, 8, sq, 32)))
        k = _np(dtype, rng.standard_normal((2, 2, 17, 32)))
        v = _np(dtype, rng.standard_normal((2, 2, 17, 32)))
        want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
        got = tfn(*from_numpy((q, k, v)), window=window)
        assert got.dtype == from_numpy(q).dtype
        assert _normwise(got, want) <= KERNEL_TOL[dtype]


def test_cpu_session_dispatches_ssd_to_the_aten_row(cpu_session):
    args = from_numpy(ssd_inputs("float32", 1, 16, 4, 8, 1, 16))
    rec = cpu_session._select("SSD", args)
    assert rec.platform == "aten" and rec.fn is t_ssd_ops.ssd_chunked
    assert cpu_session._select("SSD_DECODE", args).platform == "aten"


# ---------------------------------------------------------------------------
# (c) mamba_forward on the same numpy weights
# ---------------------------------------------------------------------------
SSM_KW = dict(state_dim=16, head_dim=8, expand=2, n_groups=2, conv_width=4, chunk=8)
D_MODEL = 32


def mamba_weights(dtype, seed=0):
    """Numpy weights for one block in the shapes of mamba_param_specs."""
    rng = np.random.default_rng(seed)
    specs = t_ssm.mamba_param_specs(D_MODEL, SSMConfig(**SSM_KW), torch.float32)
    out = {}
    for name, s in specs.items():
        if name == "a_log":
            w = np.log(np.arange(1, s.shape[0] + 1))
        elif name == "dt_bias":
            w = np.log(np.expm1(rng.uniform(1e-3, 1e-1, s.shape)))
        elif name in ("norm", "d_skip"):
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name.startswith("conv"):
            w = 0.3 * rng.standard_normal(s.shape)
        else:
            w = rng.standard_normal(s.shape) * s.shape[0] ** -0.5
        out[name] = (w.astype(np.float32) if name in ("a_log", "dt_bias", "d_skip")
                     else _np(dtype, w))
    return out


def _zero_conv_bias(w):
    return dict(w, conv_x_b=np.zeros_like(w["conv_x_b"]),
                conv_bc_b=np.zeros_like(w["conv_bc_b"]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [1, 3, 19])
def test_mamba_forward_prefill_then_decode_matches_jax(cpu_session, dtype, seq):
    """A prefill of ``seq`` tokens returns y and a decode-ready cache, then
    3 decode steps through it; y and every cache leaf against JAX.  19 is
    off the chunk; 3 = W−1 fills the conv states exactly.  Below W−1 (1)
    the reference's conv fails (see the next test), so JAX reads the
    prompt left-padded with zero rows to W−1, with the conv biases zero:
    a zero row then projects, convolves and scans to zero, leaves the state
    at zero and is a zero in the conv states, which is what the port's
    left padding of the cache writes."""
    w = mamba_weights(dtype)
    keep = SSM_KW["conv_width"] - 1
    if seq < keep:
        w = _zero_conv_bias(w)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = from_numpy(w)
    js, ts = JSSMConfig(**SSM_KW), SSMConfig(**SSM_KW)
    rng = np.random.default_rng(seq)
    x = _np(dtype, rng.standard_normal((2, seq, D_MODEL)))
    jx = np.concatenate([np.zeros((2, keep - seq, D_MODEL), x.dtype), x], 1) \
        if seq < keep else x
    j_prefill = jax.jit(lambda w_, x_: j_ssm.mamba_forward(w_, x_, js, want_cache=True))
    j_decode = jax.jit(lambda w_, x_, c_: j_ssm.mamba_forward(w_, x_, js, cache=c_))
    jy, jcache = j_prefill(jw, jnp.asarray(jx))
    ty, tcache = t_ssm.mamba_forward(tw, from_numpy(x), ts)
    tol = KERNEL_TOL[dtype] if dtype == "bfloat16" else 1e-4
    assert ty.dtype == from_numpy(x).dtype
    assert _normwise(ty, jy[:, -seq:]) <= tol
    assert [tuple(t.shape) for t in tcache] == [j.shape for j in jcache]
    assert [t.dtype for t in tcache] == [from_numpy(x).dtype] * 2 + [torch.float32]
    for tc, jc in zip(tcache, jcache):
        assert _normwise(tc, jc) <= tol
    if seq < SSM_KW["conv_width"] - 1:
        assert not tcache[0][..., :SSM_KW["conv_width"] - 1 - seq].any()
    tcache = tuple(t.contiguous() for t in tcache)
    for step in range(3):
        xt = _np(dtype, rng.standard_normal((2, 1, D_MODEL)))
        jy, jcache = j_decode(jw, jnp.asarray(xt), jcache)
        ty, out_cache = t_ssm.mamba_forward(tw, from_numpy(xt), ts, cache=tcache)
        assert out_cache is tcache                       # updated in place
        assert _normwise(ty, jy) <= tol, step
        for tc, jc in zip(tcache, jcache):
            assert _normwise(tc, jc) <= tol, step


def test_reference_causal_conv_fails_below_the_conv_width():
    """A fault of the reference, pinned: ``_causal_conv_seq`` pads
    ``u[:, :-shift]`` by ``shift``, which is S long only while shift ≤ S,
    so a prompt shorter than W−1 tokens raises in the reference's Mamba
    prefill (whose cache code pads for that very case).  The port pads u
    and cuts it to S: a shift past S adds zeros, as a causal conv should,
    and from S ≥ W−1 both agree."""
    w = mamba_weights("float32")
    rng = np.random.default_rng(4)
    for seq in (1, 2):
        u = rng.standard_normal((1, seq, 64)).astype(np.float32)
        with pytest.raises(TypeError, match="incompatible shapes"):
            j_ssm._causal_conv_seq(jnp.asarray(u), jnp.asarray(w["conv_x_w"]),
                                   jnp.asarray(w["conv_x_b"]))
        got = t_ssm._causal_conv_seq(*from_numpy((u, w["conv_x_w"], w["conv_x_b"])))
        want = sum(np.pad(u, ((0, 0), (s, 0), (0, 0)))[:, :seq] * w["conv_x_w"][:, 3 - s]
                   for s in range(4)) + w["conv_x_b"]
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6, atol=1e-6)
    u = rng.standard_normal((1, 7, 64)).astype(np.float32)
    args = (u, w["conv_x_w"], w["conv_x_b"])
    assert _normwise(t_ssm._causal_conv_seq(*from_numpy(args)),
                     j_ssm._causal_conv_seq(*map(jnp.asarray, args))) <= 1e-6


def test_mamba_cache_specs_keep_the_state_in_float32():
    specs = t_ssm.mamba_cache_specs(D_MODEL, SSMConfig(**SSM_KW), 3, torch.bfloat16)
    jspecs = j_ssm.mamba_cache_specs(D_MODEL, JSSMConfig(**SSM_KW), 3, jnp.bfloat16)
    assert [s.shape for s in specs] == [s.shape for s in jspecs]
    assert [s.dtype for s in specs] == [torch.bfloat16, torch.bfloat16, torch.float32]
    pspecs = t_ssm.mamba_param_specs(D_MODEL, SSMConfig(**SSM_KW), torch.bfloat16)
    jp = j_ssm.mamba_param_specs(D_MODEL, JSSMConfig(**SSM_KW), jnp.bfloat16)
    assert {k: s.shape for k, s in pspecs.items()} == {k: s.shape for k, s in jp.items()}
    assert {k for k, s in pspecs.items() if s.dtype == torch.float32} \
        == {"a_log", "dt_bias", "d_skip"}
    assert {k: s.init_kind for k, s in pspecs.items()} \
        == {k: s.init_kind for k, s in jp.items()}


# ---------------------------------------------------------------------------
# (d) whole reduced models on the JAX package's weights
# ---------------------------------------------------------------------------
def _models(arch, dtype="float32"):
    jc = dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype)
    tc = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jm, tm = j_build_model(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def test_ssm_model_short_prompt_prefill_and_decode_match_jax(cpu_session):
    """zamba2 (Mamba layers and the shared block's GQA cache), a 3-token
    prompt (the conv's W−1, the shortest the reference takes;
    tests/test_torch_model.py holds both reduced configurations at a
    36-token one, off the reduced chunk of 16), then 5 decode steps: logits
    ≤ 1e-4 and every padded cache leaf ≤ 1e-4 normwise."""
    prompt_len = 3
    jm, jp, tm, tp = _models("zamba2-1.2b")
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(0, tm.cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    jl, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()})
    assert _normwise(tl, jl) <= MODEL_TOL
    jcache = j_kvcache.pad_caches(jm.cfg, jcache, 32)
    tcache = t_kvcache.pad_caches(tm.cfg, tcache, 32)
    for jc, tc in zip(jax.tree.leaves(jcache), pytree.tree_leaves(tcache)):
        assert _normwise(tc, jc) <= MODEL_TOL
    decode = jax.jit(jm.decode_step)
    for i in range(5):
        tok = rng.integers(0, tm.cfg.vocab_size, (1, 1)).astype(np.int32)
        jl, jcache = decode(jp, jcache, jnp.asarray(tok), jnp.int32(prompt_len + i))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                    prompt_len + i)
        assert _normwise(tl, jl) <= MODEL_TOL, i


def test_zamba2_shared_block_has_one_weight_copy(cpu_session):
    """zamba2's shared block: its weights live once in params["shared"]
    (swiglu FFN), its pattern slots hold none, and its cache is a GQA cache
    of cfg.shared_attn stacked over the stage's repeats."""
    _, jp, tm, tp = _models("zamba2-1.2b")
    cfg = tm.cfg
    assert set(tp["shared"]) == {"ln1", "ln2", "attn", "ffn"}
    assert set(tp["shared"]["ffn"]) == {"wg", "wu", "wd"}
    kinds = [b.kind for b in cfg.stages[0].pattern]
    assert tp["stages"][0][kinds.index("shared_attn")] == {}
    assert np.array_equal(to_numpy(tp["shared"]["attn"]["wq"]),
                          np.asarray(jp["shared"]["attn"]["wq"]))
    caches = tm.init_cache(3, 40)
    a = cfg.shared_attn
    ck, cv = caches[0][kinds.index("shared_attn")]
    assert ck.shape == cv.shape == (cfg.stages[0].repeats, 3, a.n_kv_heads, 40, a.head_dim)


@pytest.mark.parametrize("idle", [0, 1])
def test_inactive_lane_state_is_bit_identical_after_decode(cpu_session, idle):
    """zamba2 (Mamba layers and the shared block): a decode step with lane
    ``idle`` inactive leaves every leaf of that lane — Mamba's conv and SSM
    states, the shared block's keys and values — as it was, bit for bit;
    the other lane advances its state."""
    _, _, tm, tp = _models("zamba2-1.2b")
    caches = tm.init_cache(2, 40)
    gen = torch.Generator().manual_seed(5)
    for leaf in pytree.tree_leaves(caches):
        leaf.normal_(generator=gen)
    before = [t.clone() for t in pytree.tree_leaves(caches)]
    busy = 1 - idle
    tm.decode_step(tp, caches, torch.tensor([[3], [4]]), torch.tensor([20, 7]),
                   torch.arange(2) == busy)
    after = pytree.tree_leaves(caches)
    for old, new in zip(before, after):
        assert torch.equal(old[:, idle], new[:, idle])    # the idle lane wrote nothing
        assert not torch.equal(old[:, busy], new[:, busy])  # the busy one advanced
    # and with every lane inactive, nothing moves
    tm.decode_step(tp, caches, torch.tensor([[3], [4]]), torch.tensor([21, 8]),
                   torch.tensor([False, False]))
    for old, new in zip(after, pytree.tree_leaves(caches)):
        assert torch.equal(old, new)


def test_float32_state_survives_a_bfloat16_slot_pool(cpu_session):
    """In a bfloat16 zamba2 the SSM state leaves stay float32: insert_slot
    writes a prefill's state into the pool with its bits, beside bfloat16
    conv states and keys, and evict_slot zeroes the lane."""
    tm = build_model(dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                                         dtype="bfloat16"))
    tp = tm.init(torch.Generator().manual_seed(0))
    engine = SlotEngine(tm, tp, slots=2, max_len=32)
    _, one = tm.prefill(tp, {"tokens": torch.tensor([[5, 6, 7, 8, 9]])})
    padded = t_kvcache.pad_caches(tm.cfg, one, 32)
    t_kvcache.insert_slot(engine.caches, padded, 1)
    types = set()
    for pool, lane in zip(pytree.tree_leaves(engine.caches), pytree.tree_leaves(padded)):
        assert pool.dtype == lane.dtype
        types.add(pool.dtype)
        assert torch.equal(pool[:, 1], lane[:, 0])
        assert not pool[:, 0].any()
    assert types == {torch.bfloat16, torch.float32}
    engine.release_slot(1)
    assert not any(t.any() for t in pytree.tree_leaves(engine.caches))


# ---------------------------------------------------------------------------
# (e) the slot engine against the JAX StepScheduler
# ---------------------------------------------------------------------------
SERVE_CASES = [([3, 1, 4, 1, 5], 4), (list(range(40, 51)), 6),
               ([9, 9, 2, 6, 6], 5), ([7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], 3)]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_step_scheduler_greedy_tokens_match_jax(cpu_session, arch):
    """Four requests on two slots (lanes join and retire mid-flight; two
    prompt lengths, so the JAX engine compiles two admissions): the same
    greedy tokens as the JAX StepScheduler, and the retired lanes
    zeroed."""
    jm, jp, tm, tp = _models(arch)
    jsched = JStepScheduler(JSlotEngine(jm, jp, slots=2, max_len=32))
    tsched = StepScheduler(SlotEngine(tm, tp, slots=2, max_len=32))
    jf = [jsched.submit(p, max_new=n) for p, n in SERVE_CASES]
    tf = [tsched.submit(p, max_new=n) for p, n in SERVE_CASES]
    jsched.drain()
    tsched.drain()
    for (p, n), a, b in zip(SERVE_CASES, jf, tf):
        assert b.result(timeout=60) == a.result(timeout=60)
        assert len(b.result()) == n
    assert tsched.completed == len(SERVE_CASES) and tsched.active() == 0
    assert all(not bool(t.any()) for t in pytree.tree_leaves(tsched.engine.caches))


def test_serve_launcher_serves_mamba2_on_the_cpu(capsys):
    results = t_serve.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                            "--slots", "4", "--requests", "6", "--max-new", "4"])
    assert [len(r) for r in results] == t_serve.mixed_budgets(6, 4)
    assert "served 6 requests" in capsys.readouterr().out
