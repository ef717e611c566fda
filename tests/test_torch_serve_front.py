"""Port parity for the whole-batch serving front: ServeEngine.generate (the
slot path and the lockstep path with the stub frontends' ``batch_extra``)
and _generate_lockstep against the JAX ServeEngine, RequestQueue's flush
(no echo lanes, each row at its own budget) and background drain, the
launcher's ``--paged`` and ``--legacy`` paths, and a fault of the
reference pinned: its lockstep loop cannot decode a ``frame_embed`` model.

Weights are the JAX package's, carried across by ``params_from_numpy``;
the port runs on the CPU through a session made with ``device="cpu"``.
Greedy tokens are compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import halo
from repro_torch.configs import get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.serve.engine import RequestQueue, ServeEngine


@pytest.fixture(scope="module")
def cpu_session():
    session = halo.initialize(device="cpu")
    yield session
    halo.finalize()


def _pair(arch):
    jm = j_build_model(j_get_config(arch).reduced())
    tm = build_model(get_config(arch).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def danube(cpu_session):
    return _pair("h2o-danube-1.8b")


@pytest.fixture(scope="module")
def mamba(cpu_session):
    return _pair("mamba2-370m")


@pytest.fixture(scope="module")
def paligemma(cpu_session):
    return _pair("paligemma-3b")


def _rows(x):
    return np.asarray(x).tolist()


def test_generate_matches_jax_on_the_slot_path(danube):
    """Token frontend: generate submits one request per row to a width-B
    slot pool; the tokens equal the JAX ServeEngine's and its own
    lockstep loop's, at two widths."""
    jm, jp, tm, tp = danube
    jeng, teng = JServeEngine(jm, max_len=48), ServeEngine(tm, max_len=48)
    rng = np.random.default_rng(0)
    for b in (2, 3):
        prompts = rng.integers(0, tm.cfg.vocab_size, (b, 9)).astype(np.int32)
        want = _rows(jeng.generate(jp, jnp.asarray(prompts), 6))
        assert _rows(teng.generate(tp, prompts, 6)) == want
        assert _rows(teng._generate_lockstep(tp, prompts, 6)) == want
        assert _rows(jeng._generate_lockstep(jp, jnp.asarray(prompts), 6)) == want
    assert sorted(teng._scheds) == [2, 3]


def test_generate_keeps_at_most_four_widths(danube):
    _, _, tm, tp = danube
    eng = ServeEngine(tm, max_len=32)
    for b in (1, 2, 3, 4, 5, 2):
        assert eng.generate(tp, [[1, 2, 3]] * b, 2).shape == (b, 2)
    assert list(eng._scheds) == [3, 4, 5, 2]          # LRU order, 1 evicted


def test_generate_patch_embed_matches_jax_lockstep(paligemma):
    """paligemma-3b (patch_embed): generate takes the lockstep path with
    the patches in ``batch_extra``, decodes from s0 + prefix_len, and
    returns the JAX package's tokens; without patches the slot pool is
    never built."""
    jm, jp, tm, tp = paligemma
    cfg = tm.cfg
    assert cfg.frontend == "patch_embed" and cfg.prefix_len == 8
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    patches = rng.standard_normal((2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    max_len = cfg.prefix_len + 6 + 5
    want = _rows(JServeEngine(jm, max_len=max_len).generate(
        jp, jnp.asarray(prompts), 5, batch_extra={"patches": jnp.asarray(patches)}))
    teng = ServeEngine(tm, max_len=max_len)
    got = teng.generate(tp, prompts, 5, batch_extra={"patches": torch.from_numpy(patches)})
    assert _rows(got) == want and not teng._scheds
    with pytest.raises(ValueError, match="exceeds max_len"):
        ServeEngine(tm, max_len=max_len - 1).generate(
            tp, prompts, 5, batch_extra={"patches": torch.from_numpy(patches)})


def test_reference_lockstep_cannot_decode_frame_embed(cpu_session):
    """Reference fault: the JAX lockstep loop feeds the sampled (B, 1)
    tokens back into decode_step, which takes (B, 1, D) frame embeddings
    for ``frame_embed`` — musicgen-large raises on unpacking.  The port
    refuses the same call with a ValueError naming the frontend and the
    model-level path, which serves it (prefill over frames, decode over
    frame embeddings; tests/test_torch_model.py)."""
    jm = j_build_model(j_get_config("musicgen-large").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    frames = np.random.default_rng(2).standard_normal((1, 6, jm.cfg.d_model))
    with pytest.raises(ValueError, match="not enough values to unpack"):
        JServeEngine(jm, max_len=16).generate(
            jp, jnp.zeros((1, 6), jnp.int32), 3,
            batch_extra={"frames": jnp.asarray(frames, jnp.float32)})
    tm = build_model(get_config("musicgen-large").reduced())
    tp = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frame_embed.*Model.prefill and Model.decode_step"):
        ServeEngine(tm, max_len=16).generate(
            tp, torch.zeros((1, 6), dtype=torch.long), 3,
            batch_extra={"frames": torch.from_numpy(frames).float()})


def test_request_queue_flush_has_no_echo_lanes(mamba):
    """A partial flush serves only live rows through one fixed-width slot
    pool; each request retires at its own max_new, and the outputs match
    the JAX lockstep loop on the framed prompts."""
    jm, jp, tm, tp = mamba
    engine = ServeEngine(tm, max_len=32)
    seen = []
    engine.generate = lambda *a, **kw: seen.append(a)    # must never be hit
    q = RequestQueue(engine, tp, batch_size=8, prompt_len=8)
    f1 = q.submit([1, 2, 3], max_new=2)
    f2 = q.submit([4, 5, 6, 7], max_new=5)
    assert [r.uid for r in q.flush()] == [1, 2]
    assert seen == [] and q._sched.engine.slots == 8 and q._sched.completed == 2
    out1, out2 = f1.result(timeout=60), f2.result(timeout=60)
    assert len(out1) == 2 and len(out2) == 5
    jeng = JServeEngine(jm, max_len=32)
    for prompt, out in ([1, 2, 3], out1), ([4, 5, 6, 7], out2):
        padded = (prompt + [0] * 8)[:8]
        ref = jeng._generate_lockstep(jp, jnp.asarray([padded], jnp.int32), len(out))
        assert out == _rows(ref)[0]


def test_request_queue_eos_and_batches(danube):
    """Rows stop at their own EOS; three requests on a batch of 2 take two
    flushes whose futures see what the flushes report."""
    _, _, tm, tp = danube
    engine = ServeEngine(tm, max_len=48)
    prompt = [5, 6, 7, 8]
    ref = _rows(engine.generate(tp, [prompt], 8))[0]
    eos = ref[3]
    q = RequestQueue(engine, tp, batch_size=2, prompt_len=len(prompt))
    futs = [q.submit(prompt, max_new=8, eos_id=eos), q.submit(prompt, max_new=3),
            q.submit(prompt, max_new=8)]
    done = []
    while q.pending():
        done.extend(q.flush())
    assert [f.result(timeout=5) for f in futs] == [r.result for r in done]
    assert futs[0].result() == ref[:ref.index(eos) + 1]
    assert futs[1].result() == ref[:3] and futs[2].result() == ref
    with pytest.raises(ValueError, match="exceeds"):
        q.submit(prompt, max_new=45)


def test_request_queue_background_drain_partial_batch(mamba):
    """The drain loop flushes a partial batch once the oldest submission
    passes max_delay — no flush() from the client; stop() drains."""
    _, _, tm, tp = mamba
    q = RequestQueue(ServeEngine(tm, max_len=32), tp, batch_size=4, prompt_len=8,
                     max_delay=0.02)
    with q:
        futs = [q.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new=2) for _ in range(3)]
        results = [f.result(timeout=120) for f in futs]
    assert all(len(r) == 2 for r in results) and q.pending() == 0
    with pytest.raises(RuntimeError, match="stopped"):
        q.submit([1], max_new=1)


def test_request_queue_failed_flush_fails_the_whole_batch(mamba):
    """Whole-batch failure: every live row's future carries the error, the
    flush raises, and the next batch serves normally."""
    _, _, tm, tp = mamba
    q = RequestQueue(ServeEngine(tm, max_len=32), tp, batch_size=2, prompt_len=4)
    sched = q._flush_sched()
    real = sched.engine.decode_step
    sched.engine.decode_step = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected"))
    futs = [q.submit([1, 2], max_new=3), q.submit([3, 4], max_new=3)]
    with pytest.raises(RuntimeError, match="injected"):
        q.flush()
    for f in futs:
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=5)
    sched.engine.decode_step = real
    ok = q.submit([1, 2], max_new=3)
    q.flush()
    assert len(ok.result(timeout=5)) == 3 and sched.pending() == 0


def test_serve_launcher_paged_prints_the_arena(capsys):
    results = t_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
                            "--paged", "--chunk", "16", "--prompt-len", "40",
                            "--slots", "2", "--requests", "4", "--max-new", "4"])
    assert [len(r) for r in results] == t_serve.mixed_budgets(4, 4)
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "T1_us" in out
    assert "paged arena: capacity=" in out and "evictions=0" in out


def test_serve_launcher_legacy_serves_every_request(capsys):
    results = t_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
                            "--legacy", "--slots", "2", "--requests", "5",
                            "--max-new", "4"])
    assert [len(r) for r in results] == t_serve.mixed_budgets(5, 4)
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "paged arena" not in out


def test_paligemma_prefix_keys_move_attention_far_past_the_tolerance():
    """At paligemma-3b's prefill shape (2×8 heads on 1 KV head, 512 rows,
    a 256-key bidirectional prefix; head dim cut to 64 here), the prefix
    keys a query sees past its diagonal move the output by far more than
    FLASH_ATTN's bfloat16 tolerance (1e-2): a kernel that dropped them
    fails the card's phase-2 case at that shape.  The plain version
    equals the JAX reference on the prefix mask."""
    from repro.kernels.flash_attention import ref as j_fa_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(9)
    q, k = (rng.standard_normal(s).astype(np.float32) for s in ((2, 8, 512, 64),
                                                                 (2, 1, 512, 64)))
    v = rng.standard_normal((2, 1, 512, 64)).astype(np.float32) + 1.0
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with_prefix = attention_ref(tq, tk, tv, causal=True, prefix_len=256)
    causal_only = attention_ref(tq, tk, tv, causal=True)
    gap = float((with_prefix - causal_only).norm() / with_prefix.norm())
    assert gap > 10 * 1e-2, gap
    want = j_fa_ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True, prefix_len=256)
    np.testing.assert_allclose(with_prefix.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
