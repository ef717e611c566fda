"""Multi-process C²MPI in the port (DESIGN.md §13): the wire codec and the
content-addressed wire cache held byte for byte to the JAX package's, the
frame transport, and live CPU workers — the cases of tests/test_remote.py.

The codec: round trips over shapes and dtypes (bfloat16 included, with no
``ml_dtypes`` in the port), a nested tree, callables refused, the exception
marker; the frame's bytes identical to the reference's ``send_frame`` for
the same numpy-built tree, and for the same tree built from torch tensors.
The wire cache: pin once then refs, small tensors and numpy arrays raw, the
cap shipping raw, an unpinned ref refused, and the port's own case — torch
tensors are mutable, so an in-place write between two sends ships the new
bytes.

Live workers run on the CPU (``spawn_worker(device="cpu")``), where the
hopper rows run their plain versions: one module-scoped worker for the
clones, every alias with a hopper row on ``hopper@tw0`` against the
in-process row (``torch.equal``), repeated operands elided, the heartbeat
op, quarantine reaching the host and the mixed-group Jacobi against the
JAX package's; private workers for the destructive cases (a worker killed
mid-Jacobi replaying bit-identically, a dead worker's heartbeat classified
DEAD) and for the launcher's refusal of the card where there is none.  No
worker imports JAX, ``repro`` or ``ml_dtypes``.  Every live wait is bounded,
and a watchdog kills the worker of a test that overruns its budget, so a
transport that never answers fails that test and not the suite."""
import importlib.util
import io
import json
import socket
import struct
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import remote as j_remote
from repro_torch import collective_jacobi as t_cj
from repro_torch import halo
from repro_torch import multiproc_jacobi as t_mpj
from repro_torch.core.agents import (AgentDeadError, AgentState, HaloFuture,
                                     HealthConfig, HealthMonitor)
from repro_torch.core.scheduler import _record_key
from repro_torch.distributed.remote import (RemoteExecutionError,
                                            RemoteWorkerError, WorkerClient,
                                            WorkerRuntime, _WireCache,
                                            decode_payload, encode_payload,
                                            recv_frame, send_frame,
                                            spawn_worker)
from repro_torch.kernels.spmm.ref import dense_to_bell, random_block_sparse
from repro_torch.train.step_kernels import param_size, resolve_arch

ROOT = Path(__file__).resolve().parent.parent
#: seconds a live-worker test may take before its watchdog kills the worker
LIVE_TIMEOUT = 60.0
#: one request's bound inside a live test
TIMEOUT = 30.0
#: the f32 conformance tolerance of tests/test_kernels_property.py
F32_TOL = dict(rtol=2e-4, atol=2e-4)

DTYPES = ["float32", "float64", "int32", "int8", "bool", "bfloat16"]
SHAPES = [(), (1,), (3, 5), (2, 3, 4)]


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------
def _np_array(dtype: str, shape):
    """A numpy array of ``dtype`` (bfloat16 through ml_dtypes, as the
    reference builds it) from a seed."""
    rng = np.random.default_rng([DTYPES.index(dtype), len(shape), *shape])
    data = rng.uniform(-4, 4, size=shape)
    if dtype == "bfloat16":
        return np.asarray(data, np.float32).astype(ml_dtypes.bfloat16)
    return np.asarray(data).astype(dtype)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """The torch tensor holding ``arr``'s bytes (bfloat16 by a uint16 view)."""
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _roundtrip(obj):
    header, bufs = encode_payload(obj)
    json.dumps(header)                    # header must be pure JSON
    return decode_payload(header, bufs)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() \
        if t.numel() else b""


def _assert_tree_equal(got, want):
    """Same structure, tensors bit-exact in dtype and shape."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _bits(got) == _bits(want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    else:
        assert got == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_payload_roundtrip_shapes_dtypes(dtype, shape):
    t = _tensor(_np_array(dtype, shape))
    out = _roundtrip(t)
    assert isinstance(out, torch.Tensor)
    assert out.shape == t.shape and out.dtype == t.dtype
    assert _bits(out) == _bits(t)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_numpy_payload_matches_reference_encoding(dtype, shape):
    """The same numpy array (and the torch tensor over its bytes) encodes to
    the reference's header and buffers byte for byte; the port decodes the
    reference's encoding to the same tensor."""
    arr = _np_array(dtype, shape)
    jh, jb = j_remote.encode_payload(arr)
    for leaf in (arr, _tensor(arr)):
        h, b = encode_payload(leaf)
        assert h == jh and [bytes(x) for x in b] == [bytes(x) for x in jb]
    _assert_tree_equal(decode_payload(jh, jb), _tensor(arr))


def _tree(leaf):
    """A nested tree with bfloat16, float32 and int leaves, scalars, None,
    strings, empty containers and a numpy scalar."""
    return {"a": (np.float32(1.5), None, "tag"),
            "b": [leaf(_np_array("bfloat16", (2, 3))), {"k": 7, "f": 2.25}],
            "c": (), "d": {}, "flag": True,
            "e": leaf(_np_array("float32", (4, 4))),
            "i": leaf(_np_array("int32", (5,)))}


def test_payload_roundtrip_nested_tree():
    tree = _tree(_tensor)
    out = _roundtrip(tree)
    want = dict(tree, a=(torch.tensor(1.5), None, "tag"))   # scalars decode 0-d
    _assert_tree_equal(out, want)


class _Capture:
    """A socket stand-in that keeps every byte sent."""

    def __init__(self):
        self.data = io.BytesIO()

    def sendall(self, b):
        self.data.write(bytes(b))


def test_frame_byte_identical_to_reference():
    """A whole frame (length prefix, header JSON, buffers) of a tree with
    bfloat16 leaves is the reference's ``send_frame`` output byte for byte,
    whether the tree holds numpy arrays or torch tensors over their bytes."""
    msg = {"op": "exec", "uid": 3, "alias": "MMM", "args": _tree(np.asarray)}
    ref = _Capture()
    j_remote.send_frame(ref, msg)
    for leaf in (np.asarray, _tensor):
        got = _Capture()
        send_frame(got, dict(msg, args=_tree(leaf)))
        assert got.data.getvalue() == ref.data.getvalue()


def test_payload_rejects_callables():
    with pytest.raises(TypeError, match="cannot serialize"):
        encode_payload({"fn": lambda: 1})


def test_payload_exception_marker():
    out = _roundtrip({"exc": ValueError("boom")})
    assert isinstance(out["exc"], RemoteExecutionError)
    assert "ValueError" in str(out["exc"]) and "boom" in str(out["exc"])


def test_frame_roundtrip_over_socket():
    a, b = socket.socketpair()
    try:
        msg = {"op": "exec", "uid": 3,
               "args": [_tensor(_np_array("float32", (4, 4))),
                        _tensor(_np_array("bfloat16", (2,)))]}
        send_frame(a, msg)
        out = recv_frame(b.makefile("rb"))
        assert out["op"] == "exec" and out["uid"] == 3
        _assert_tree_equal(out["args"], msg["args"])
    finally:
        a.close()
        b.close()


def test_frame_eof_raises():
    a, b = socket.socketpair()
    rf = b.makefile("rb")
    a.close()
    with pytest.raises(EOFError):
        recv_frame(rf)
    b.close()


def test_frame_corrupt_length_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">QI", 1 << 40, 4))
        with pytest.raises(RemoteWorkerError, match="corrupt frame"):
            recv_frame(b.makefile("rb"))
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# The core pieces the transport needs, against the reference's
# ---------------------------------------------------------------------------
def test_clone_record_takes_a_fresh_uid():
    from repro.core.registry import KernelRecord as JRecord
    from repro.core.registry import clone_record as j_clone
    from repro_torch.core.registry import KernelRecord, clone_record
    for Rec, clone in ((KernelRecord, clone_record), (JRecord, j_clone)):
        rec = Rec(alias="MVM", fn=len, platform="hopper", priority=20,
                  is_failsafe=True)
        c = clone(rec, platform="hopper@w0", is_failsafe=False)
        assert (c.alias, c.fn, c.priority, c.attrs) == \
            (rec.alias, rec.fn, rec.priority, rec.attrs)
        assert (c.platform, c.is_failsafe) == ("hopper@w0", False)
        assert c.uid != rec.uid and rec.platform == "hopper"
        assert clone(rec, uid=rec.uid).uid == rec.uid    # an explicit uid wins


def test_mark_failed_key_quarantines_by_raw_key():
    """The cross-process form of ``mark_failed``: the same key set, epoch
    and selection effect as the reference's scheduler."""
    from repro.core.scheduler import CostModelScheduler as JScheduler
    from repro_torch.core.registry import KernelRecord
    from repro_torch.core.scheduler import CostModelScheduler
    rec = KernelRecord(alias="EWADD", fn=len, platform="hopper@w0", priority=20)
    key = _record_key(rec)
    assert key == "EWADD|hopper@w0|20:1.0.0"
    for sched in (CostModelScheduler(), JScheduler()):
        e0 = sched.epoch
        sched.mark_failed_key(key)
        sched.mark_failed_key(key)
        assert sched.failed_record_keys() == [key] and sched.epoch == e0 + 2
    assert CostModelScheduler().is_failed(rec) is False
    sched = CostModelScheduler()
    sched.mark_failed_key(key)
    assert sched.is_failed(rec)
    sched.mark_failed(rec)                     # mark_failed is mark_failed_key
    assert sched._failed[key] == 2


def test_fail_item_completes_the_future_and_can_be_suppressed():
    """``VirtualizationAgent._fail_item`` is where the worker loop fails an
    item's future; an agent overriding it can drop a transport error (the
    RemoteAgent does, once dead), and the loop still goes on."""
    from repro_torch.core.agents import VirtualizationAgent
    agent = VirtualizationAgent(name="t")
    try:
        fut = agent.submit(lambda: 1 / 0)
        assert isinstance(fut.exception(timeout=TIMEOUT), ZeroDivisionError)
        dropped = []
        agent._fail_item = lambda f, exc: dropped.append(exc)
        quiet = agent.submit(lambda: 1 / 0)
        assert agent.submit(lambda: 7).result(timeout=TIMEOUT) == 7
        assert not quiet.done() and isinstance(dropped[0], ZeroDivisionError)
    finally:
        agent.shutdown()


def _card_rule_session(monkeypatch, exc, survivor=None, path="request"):
    """A CPU session whose card rule sees the CPU tensors as the card's
    (``_card_device`` of the request ``path``'s module: ``agents`` for
    the request path, ``graph`` for an execution graph), with a ``hopper@w9`` member whose EWADD raises ``exc`` and,
    optionally, a ``survivor``: the local ``hopper`` row, or a clone of it
    served by another worker's member ``hopper@w8``.  Returns the session,
    the failing record and the overrides that prefer it, then the survivor,
    then torch."""
    from repro_torch.core import agents, graph
    from repro_torch.core.agents import (HopperAgent, RuntimeAgent,
                                         VirtualizationAgent)
    from repro_torch.core.registry import (KernelRecord, KernelRegistry,
                                           clone_record)
    from repro_torch.kernels import register_all
    from repro_torch.testing.faults import failing

    def member(platform):
        return type("_Member", (VirtualizationAgent,), {"platform": platform})()

    registry = KernelRegistry()
    register_all(registry)
    rec = registry.register(KernelRecord(
        alias="EWADD", fn=failing(str(exc), type(exc)), platform="hopper@w9",
        priority=20))
    members = [agents.TorchAgent(), member("hopper@w9")]
    if survivor == "hopper":
        members.append(HopperAgent(device="cpu"))
    elif survivor is not None:
        hop = next(r for r in registry.records("EWADD") if r.platform == "hopper")
        registry.register(clone_record(hop, platform=survivor, is_failsafe=False))
        members.append(member(survivor))
    sess = RuntimeAgent(registry=registry, device="cpu", agents=members)
    monkeypatch.setattr(agents if path == "request" else graph, "_card_device",
                        lambda tree: torch.device("cuda"))
    order = ["hopper@w9"] + ([survivor] if survivor else []) + ["torch"]
    return sess, rec, {"allowed_platforms": order, "platform_preference": order}


@pytest.mark.parametrize("exc", [RemoteExecutionError("kernel failed"),
                                 RemoteWorkerError("transport lost")],
                         ids=["kernel", "transport"])
def test_card_rule_covers_a_workers_hopper_clone(monkeypatch, exc):
    """On card tensors (``_card_device`` made to see the CPU tensors as the
    card's) a worker's ``hopper@<w>`` record whose kernel raises surfaces
    at once, unquarantined, as a local hopper record does.  A lost
    transport (an AgentDeadError) is no kernel failure: the clone is
    quarantined and the request may re-place, but onto hopper records only,
    never the torch row — with none left, the transport error surfaces."""
    sess, rec, overrides = _card_rule_session(monkeypatch, exc)
    x = torch.ones(4)
    cr = sess.claim("EWADD", overrides=overrides)
    try:
        with pytest.raises(type(exc), match=str(exc)):
            sess._execute_record(rec, cr, (x, x), {})
        if isinstance(exc, RemoteWorkerError):
            assert sess.scheduler.failed_record_keys() == [_record_key(rec)]
        else:
            assert not sess.scheduler.failed_record_keys()
        assert sess.agents["torch"].metrics["completed"] == 0
    finally:
        sess.finalize()


@pytest.mark.parametrize("path", ["request", "graph"])
@pytest.mark.parametrize("survivor", ["hopper", "hopper@w8"])
def test_a_lost_clone_on_the_card_re_places_onto_hopper(monkeypatch, survivor,
                                                        path):
    """A card request whose ``hopper@w9`` clone lost its worker re-places
    onto the next hopper record the claim allows — the local hopper row or
    another worker's clone — ahead of the torch row, on the request path
    (``RuntimeAgent._execute_record``) and in an execution graph
    (``_attempt_failed``); with no hopper record left both raise the
    transport error and the torch row never runs."""
    from repro_torch.core.graph import halo_graph
    for left in (survivor, None):
        sess, rec, overrides = _card_rule_session(
            monkeypatch, RemoteWorkerError("transport lost"), left, path)
        x, y = torch.ones(4), torch.full((4,), 2.0)
        try:
            if path == "request":
                cr = sess.claim("EWADD", overrides=overrides)
                run = lambda: sess._execute_record(rec, cr, (x, y), {})  # noqa: E731
            else:
                def run():
                    with halo_graph(session=sess):
                        node = sess.dispatch("EWADD", x, y, overrides=overrides)
                    assert node.attempts[0] == "hopper@w9"
                    return node.result(timeout=TIMEOUT)
            if left is None:
                with pytest.raises(RemoteWorkerError, match="transport lost"):
                    run()
            else:
                assert torch.equal(run(), x + y)
                assert sess.agents[left].metrics["completed"] == 1
            assert sess.agents["torch"].metrics["completed"] == 0
            assert sess.scheduler.failed_record_keys() == [_record_key(rec)]
        finally:
            sess.finalize()


def test_failing_and_faulty_record_as_the_reference():
    """``failing`` raises its type and message and records its calls;
    ``faulty_record`` wraps it in a record that quarantines and re-places
    onto the next row, as the reference's does."""
    from repro.testing import faults as j_faults
    from repro_torch.testing import faults
    for mod in (faults, j_faults):
        calls = []
        fn = mod.failing("boom", ValueError, calls=calls)
        with pytest.raises(ValueError, match="boom"):
            fn(1, 2, k=3)
        assert calls == [(1, 2)]
        with pytest.raises(mod.FaultError, match="injected fault"):
            mod.failing()()
    rec = faults.faulty_record("EWADD", priority=99)
    jrec = j_faults.faulty_record("EWADD", priority=99)
    assert (rec.alias, rec.priority, rec.is_failsafe) == \
        (jrec.alias, jrec.priority, jrec.is_failsafe)
    assert rec.platform == "aten" and jrec.platform == "xla"
    with pytest.raises(faults.FaultError, match="EWADD on aten died"):
        rec.fn()
    from repro_torch.core.agents import RuntimeAgent
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.kernels import register_all
    registry = KernelRegistry()
    register_all(registry)
    registry.register(rec)
    sess = RuntimeAgent(registry=registry, device="cpu")
    try:
        x, y = torch.ones(8), torch.full((8,), 2.0)
        cr = sess.claim("EWADD", overrides={"platform_preference": ["aten"]})
        out = sess.isend((x, y), cr, mailbox=False).result(TIMEOUT)
        assert torch.equal(out, x + y)
        assert _record_key(rec) in sess.scheduler.failed_record_keys()
    finally:
        sess.finalize()


# ---------------------------------------------------------------------------
# Content-addressed wire buffer cache
# ---------------------------------------------------------------------------
def _cached_roundtrip(cache, store, msg):
    hdr, bufs = encode_payload(msg, cache)
    cache.commit()
    return hdr, decode_payload(hdr, bufs, store)


def _marks(h):
    return h["__d__"][0][1]["__t__"]


def test_wire_cache_pins_once_then_refs():
    cache, store = _WireCache(), {}
    a = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)  # 16 KiB
    h1, d1 = _cached_roundtrip(cache, store, {"args": (a,)})
    h2, d2 = _cached_roundtrip(cache, store, {"args": (a,)})
    m1, m2 = _marks(h1)[0], _marks(h2)[0]
    assert "put" in m1 and "__a__" in m1        # first send ships raw + pins
    assert "__aref__" in m2 and "__a__" not in m2   # later sends elide bytes
    assert d2["args"][0] is d1["args"][0]       # one shared pinned buffer
    assert torch.equal(d1["args"][0], a)
    assert cache.stats()["bytes_saved"] == a.numel() * 4
    # the key is the reference's digest of the same bytes, then the dtype
    # and shape
    jcache = j_remote._WireCache()
    jh, _ = j_remote.encode_payload({"args": (jnp.asarray(a.numpy()),)}, jcache)
    assert m1["put"] == jh["__d__"][0][1]["__t__"][0]["put"] + ":float32:64x64"


def test_wire_cache_skips_numpy_and_small_tensors():
    cache, store = _WireCache(), {}
    big_np = np.ones((64, 64), np.float32)      # numpy ships raw
    small = torch.ones(4)                       # under WIRE_CACHE_MIN
    for _ in range(2):
        h, _ = _cached_roundtrip(cache, store, {"args": (big_np, small)})
        for mark in _marks(h):
            assert "__a__" in mark and "put" not in mark
    assert not store and cache.stats()["pinned_buffers"] == 0


def test_wire_cache_cap_ships_raw_instead_of_promising():
    cache, store = _WireCache(), {}
    cache.cap_bytes = 100                       # below any eligible tensor
    a = torch.ones((64, 64))
    for _ in range(2):
        h, d = _cached_roundtrip(cache, store, {"a": a})
        mark = h["__d__"][0][1]
        assert "__a__" in mark and "put" not in mark
        assert torch.equal(d["a"], a)
    assert cache.stats()["pinned_bytes"] == 0


def test_wire_cache_never_hashes_a_tensor_over_the_whole_cap(monkeypatch):
    """A tensor larger than the whole cap could never have been pinned: it
    ships raw without being hashed (hashing runs at ~1 GB/s on the host)."""
    from repro_torch.distributed import remote
    hashed = []
    real = remote.hashlib.blake2b
    monkeypatch.setattr(remote.hashlib, "blake2b",
                        lambda data, **kw: hashed.append(len(data)) or real(data, **kw))
    cache, store = _WireCache(), {}
    cache.cap_bytes = 64 * 64 * 4 - 1
    big, fits = torch.ones((64, 64)), torch.ones((32, 64))
    h, _ = _cached_roundtrip(cache, store, {"args": (big, fits)})
    m_big, m_fits = _marks(h)
    assert "put" not in m_big and "put" in m_fits
    assert hashed == [32 * 64 * 4]


@pytest.mark.parametrize("pair", [
    ((64, 64), torch.float32, (4096,), torch.float32),
    ((4096,), torch.float32, (4096,), torch.int32),
    ((8192,), torch.bfloat16, (8192,), torch.float16),
    ((64, 64), torch.float32, (4096,), torch.int32),
], ids=["shape", "dtype", "bf16-f16", "both"])
def test_wire_cache_keys_equal_bytes_by_dtype_and_shape(pair):
    """Zeros of one byte size under two shapes or two dtypes have the same
    bytes but are different operands: each pins on its own and decodes
    with its own shape and dtype, on the first send and on the refs after."""
    s1, t1, s2, t2 = pair
    cache, store = _WireCache(), {}
    a, b = torch.zeros(s1, dtype=t1), torch.zeros(s2, dtype=t2)
    for _ in range(2):
        h, d = _cached_roundtrip(cache, store, {"args": (a, b)})
        for sent, got in zip((a, b), d["args"]):
            assert got.dtype == sent.dtype and got.shape == sent.shape
            assert torch.equal(got, sent)
    m_a, m_b = _marks(h)
    assert "__aref__" in m_a and "__aref__" in m_b
    assert m_a["__aref__"] != m_b["__aref__"]
    assert cache.stats()["pinned_buffers"] == 2 == len(store)


def test_wire_cache_unpinned_ref_rejected():
    with pytest.raises(RemoteWorkerError, match="unpinned"):
        decode_payload({"__aref__": "deadbeef", "s": [2], "d": "float32"},
                       [], {})


@pytest.mark.parametrize("write", ["add_", "view", "copy_", "out=", "numpy",
                                   ".data"])
def test_wire_cache_in_place_write_ships_new_bytes(write):
    """A torch tensor is mutable: an in-place write between two sends —
    on the tensor, through a view of it, by ``copy_``, as an ``out=``
    target, through a numpy array that shares its memory, or through
    ``.data`` (the last two bump no version counter the tensor sees) —
    makes the second send re-hash and ship the new bytes (a new pin)
    instead of a ref to the stale ones."""
    cache, store = _WireCache(), {}
    if write == "numpy":
        base = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
        a = torch.from_numpy(base)
    else:
        a = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    h1, d1 = _cached_roundtrip(cache, store, {"args": (a,)})
    if write == "add_":
        a.add_(1.0)
    elif write == "view":
        a[3].fill_(-7.0)
    elif write == "copy_":
        a.copy_(torch.flip(a, (0,)))
    elif write == "out=":
        torch.mul(a, 2.0, out=a)
    elif write == "numpy":
        base[:] = 5.0
    else:
        a.data.add_(1.0)
    h2, d2 = _cached_roundtrip(cache, store, {"args": (a,)})
    m1, m2 = _marks(h1)[0], _marks(h2)[0]
    assert "put" in m2 and m2["put"] != m1["put"]
    assert torch.equal(d2["args"][0], a) and not torch.equal(d1["args"][0], a)
    assert cache.stats()["bytes_saved"] == 0
    h3, d3 = _cached_roundtrip(cache, store, {"args": (a,)})    # unchanged now
    assert _marks(h3)[0] == {"__aref__": m2["put"], "s": [64, 64], "d": "float32"}


def test_wire_cache_hashes_a_cpu_tensor_on_every_send(monkeypatch):
    """A CPU tensor's digest is never memoized (numpy may write its memory
    uncounted): each send hashes it again, and an unchanged one still goes
    as a ref to its pin."""
    from repro_torch.distributed import remote
    hashed = []
    digest = remote._digest
    monkeypatch.setattr(remote, "_digest", lambda t, data: hashed.append(
        t.device.type) or digest(t, data))
    cache, store = _WireCache(), {}
    a = torch.ones((64, 64))
    marks = [_marks(_cached_roundtrip(cache, store, {"args": (a,)})[0])[0]
             for _ in range(3)]
    assert hashed == ["cpu"] * 3
    assert marks[1] == marks[2] == {"__aref__": marks[0]["put"], "s": [64, 64],
                                    "d": "float32"}


def test_wire_cache_inference_tensor_ships_raw():
    """An inference tensor has no version counter to validate a memo: it
    ships raw every time."""
    cache, store = _WireCache(), {}
    with torch.inference_mode():
        a = torch.ones((64, 64))
    for _ in range(2):
        h, d = _cached_roundtrip(cache, store, {"a": a})
        assert "put" not in h["__d__"][0][1]
        assert torch.equal(d["a"], a)


# ---------------------------------------------------------------------------
# Live worker fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sess():
    """The process's HALO session on the CPU: the serial Jacobi and
    LM_GRAD's own dispatches go through it."""
    s = halo.initialize(device="cpu")
    yield s
    halo.finalize()


@pytest.fixture(scope="module")
def worker():
    w = spawn_worker("tw0", device="cpu")
    try:
        yield w
    finally:
        w.shutdown()
        w.kill()


@pytest.fixture(scope="module")
def ragent(sess, worker):
    return worker.agent("hopper").attach(sess)


@pytest.fixture
def watchdog(worker):
    """Kill the module's worker if the test overruns its budget: every
    request in flight then fails instead of hanging the run."""
    timer = threading.Timer(LIVE_TIMEOUT, worker.kill)
    timer.daemon = True
    timer.start()
    yield
    timer.cancel()


def _guard(w):
    timer = threading.Timer(LIVE_TIMEOUT, w.kill)
    timer.daemon = True
    timer.start()
    return timer


def _pinned(sess, alias, platform):
    return sess.claim(alias, overrides={"allowed_platforms": [platform],
                                        "platform_preference": [platform]})


def _exec_on(sess, alias, platform, args, kwargs):
    return sess.isend(tuple(args), _pinned(sess, alias, platform),
                      mailbox=False, **kwargs)


_STEP_KW = dict(arch="h2o-danube-1.8b", reduced=True)


def _alias_payloads():
    """One (args, kwargs) per alias with a hopper row, from a seed: shapes
    small enough for the CPU, large enough to take each row's real path."""
    gen = torch.Generator().manual_seed(11)

    def a(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    n = 16
    diag_dom = a((n, n)) + n * torch.eye(n)
    values, indices = dense_to_bell(random_block_sparse(gen, 16, 16, 4, 4), 4, 4)
    q, k, v = a((1, 2, 64, 16)), a((1, 2, 64, 16)), a((1, 2, 64, 16))
    p = param_size(**_STEP_KW)
    vocab = resolve_arch(**_STEP_KW).vocab_size
    toks = torch.randint(0, vocab, (2, 16), generator=gen)
    return {
        "MMM": ((a((16, 12)), a((12, 8))), {}),
        "EWMM": ((a((8, 8)), a((8, 8))), {}),
        "EWMD": ((a((8, 8)), a((8, 8)).abs() + 1.0), {}),
        "EWADD": ((a((8, 8)), a((8, 8))), {}),
        "EWSUB": ((a((8, 8)), a((8, 8))), {}),
        "MVM": ((a((8, 8)), a((8,))), {}),
        "VDP": ((a((16,)), a((16,))), {}),
        "JS": ((diag_dom, a((n,)), a((n,))), {}),
        "1DCONV": ((a((32,)), a((5,))), {}),
        "RMSNORM": ((a((4, 16)), torch.ones(16)), {}),
        "FLASH_ATTN": ((q, k, v), {}),
        "SMMM": ((values, indices, a((16, 8))), {}),
        "COPY": ((a((8, 8)),), {}),
        "CONCAT": ((a((4, 4)), a((4, 4))), {}),
        "FFT": ((a((4, 32)),), {}),
        "SORT": ((a((33,)),), {}),
        "HIST": ((torch.sigmoid(a((200,))),), {}),
        "EMBED_GRAD": ((a((24, 16), torch.bfloat16),
                        torch.randint(0, 40, (24,), generator=gen), 40), {}),
        "LM_GRAD": ((a((p,)) * 0.02, toks, toks.roll(-1, 1),
                     torch.ones((2, 16))), _STEP_KW),
        "ADAMW_STEP": ((a((p + 1,)) * 0.01, a((p,)) * 0.02, torch.zeros(p),
                        torch.zeros(p), torch.tensor(0, dtype=torch.int32)),
                       dict(_STEP_KW, n_micro=2)),
    }


def test_attach_clones_every_alias(sess, worker, ragent):
    """Every alias with a hopper row that the worker also serves is cloned
    under ``hopper@tw0``; a record the host made for itself (here a fused
    alias's, registered after the hello) is not."""
    expected = {al for al in sess.registry.aliases()
                if any(r.platform == "hopper" for r in sess.registry.records(al))
                and al in worker.hello["aliases"]}
    assert {r.alias for r in ragent._clones} == expected
    assert not any(al.startswith("FUSED:") for al in worker.hello["aliases"])
    for al in expected:
        recs = sess.registry.records(al)
        clone = next(r for r in recs if r.platform == ragent.platform)
        local = next(r for r in recs if r.platform == "hopper")
        assert clone.uid != local.uid and clone.fn is local.fn
        assert (clone.priority, clone.attrs) == (local.priority, local.attrs)
        assert not clone.is_failsafe
        assert sess.registry.failsafe(al).platform == "torch"


def test_attach_skips_a_record_the_worker_lacks(worker, watchdog):
    """A hopper record only the host has (as a compiled graph's fused
    alias is) gets no ``hopper@tw0`` clone: the worker could not run it."""
    from repro_torch.core.agents import RuntimeAgent
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.distributed.remote import RemoteAgent
    from repro_torch.kernels import register_all
    from repro_torch.testing.faults import faulty_record
    registry = KernelRegistry()
    register_all(registry)
    registry.register(faulty_record("HOST_ONLY", platform="hopper"))
    host = RuntimeAgent(registry=registry, device="cpu")
    try:
        agent = RemoteAgent(worker, "hopper").attach(host)
        cloned = {r.alias for r in agent._clones}
        assert "HOST_ONLY" not in cloned and "MVM" in cloned
        assert [r.platform for r in registry.records("HOST_ONLY")] == ["hopper"]
    finally:
        host.finalize()


def test_remote_parity_all_hopper_aliases(sess, worker, ragent, watchdog):
    """Every alias with a hopper row, sent to ``hopper@tw0`` and to the
    in-process hopper row concurrently: torch.equal trees (the worker runs
    the same record on the same substrate), nothing quarantined, and the
    worker's own hopper agent served every request."""
    payloads = _alias_payloads()
    assert set(payloads) == {r.alias for r in ragent._clones}
    served0 = worker.heartbeat(timeout=TIMEOUT)["served"]
    futures = [(alias, _exec_on(sess, alias, "hopper", args, kwargs),
                _exec_on(sess, alias, ragent.platform, args, kwargs))
               for alias, (args, kwargs) in payloads.items()]
    for alias, f_local, f_remote in futures:
        local, remote = f_local.result(TIMEOUT), f_remote.result(TIMEOUT)
        _assert_tree_equal(remote, local)
    assert not sess.scheduler.failed_record_keys()
    served = worker.heartbeat(timeout=TIMEOUT)["served"]
    assert served["hopper"] - served0.get("hopper", 0) == len(payloads)
    assert served.get("aten", 0) == served0.get("aten", 0)
    assert served.get("torch", 0) == served0.get("torch", 0)


def test_wire_cache_elides_repeated_operands(sess, worker, ragent, watchdog):
    """The same matrix sent twice ships its bytes once: the second exec
    travels as a digest ref through a live worker and returns the
    bit-identical result."""
    a = torch.arange(48 * 48, dtype=torch.float32).reshape(48, 48)  # 9 KiB
    x = torch.ones(48)
    first = _exec_on(sess, "MVM", ragent.platform, (a, x), {}).result(TIMEOUT)
    saved0 = worker.client.wire_stats()["bytes_saved"]
    second = _exec_on(sess, "MVM", ragent.platform, (a, x), {}).result(TIMEOUT)
    assert torch.equal(second, first)
    stats = worker.client.wire_stats()
    assert stats["bytes_saved"] - saved0 >= a.numel() * 4
    assert stats["pinned_bytes"] >= a.numel() * 4
    assert worker.heartbeat(timeout=TIMEOUT)["pins"] == stats["pinned_buffers"]


def test_worker_heartbeat_op_and_imports(worker, watchdog):
    hb = worker.heartbeat(timeout=TIMEOUT)
    assert hb["name"] == worker.name == "tw0"
    assert "devices" not in hb                       # no XLA fan-out
    assert hb["device"] == worker.device == "cpu"
    assert set(hb["platforms"]) == {"hopper", "aten", "torch"}
    assert set(hb["launches"]) >= {"mmm_wgmma", "mvm", "ewise"}
    assert not any(hb["launches"].values())          # plain versions here
    imports = set(worker.hello["imports"])
    assert {"torch", "repro_torch"} <= imports
    assert not imports & {"jax", "jaxlib", "repro", "ml_dtypes"}


def test_worker_quarantine_propagates_to_host(sess, worker, ragent, watchdog):
    """A record that fails only *inside* the worker: its quarantine key
    reaches the host under the remote member's record key even on the
    error reply (an attempt that the host does not itself quarantine), the
    local hopper record stays selectable, and a claim that also allows the
    local row re-places onto it with the in-process result."""
    args, kwargs = _alias_payloads()["EWADD"]
    clone = next(r for r in sess.registry.records("EWADD")
                 if r.platform == ragent.platform)
    local_rec = next(r for r in sess.registry.records("EWADD")
                     if r.platform == "hopper")
    worker.chaos(platform="hopper", mode="raise", aliases=["EWADD"], times=1)
    try:
        with pytest.raises(RemoteExecutionError, match="FaultError"):
            sess._execute_on(ragent, clone, None, args, kwargs)
        failed = sess.scheduler.failed_record_keys()
        assert failed == [_record_key(clone)]
        assert _record_key(local_rec) not in failed
        sess.scheduler.clear_failures()
        ragent._applied_quarantine.clear()
        worker.release()
        worker.chaos(platform="hopper", mode="raise", aliases=["EWADD"], times=1)
        both = [ragent.platform, "hopper"]
        cr = sess.claim("EWADD", overrides={"allowed_platforms": both,
                                            "platform_preference": both})
        remote = sess.isend(args, cr, mailbox=False, **kwargs).result(TIMEOUT)
        local = _exec_on(sess, "EWADD", "hopper", args, kwargs).result(TIMEOUT)
        assert torch.equal(remote, local)
        assert _record_key(clone) in sess.scheduler.failed_record_keys()
        assert _record_key(local_rec) not in sess.scheduler.failed_record_keys()
    finally:
        worker.release()
        sess.scheduler.clear_failures()
        ragent._applied_quarantine.clear()


def _example():
    spec = importlib.util.spec_from_file_location(
        "collective_jacobi_example", ROOT / "examples" / "collective_jacobi.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mixed_group_jacobi_against_reference(sess, worker, ragent, watchdog):
    """The port's collective Jacobi over ``["hopper", "hopper@tw0"]`` —
    eager and captured — equals serial hopper bit for bit, and the JAX
    package's ``collective_jacobi`` over ``["xla", "jnp"]`` on the same
    numpy inputs within the f32 conformance tolerance."""
    from repro import halo as jhalo
    n, iters = 48, 6
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    d = np.diagonal(a).copy()
    jhalo.initialize()
    try:
        jcomm = jhalo.comm_split(["xla", "jnp"])
        jx, jres = _example().collective_jacobi(
            jcomm, *(jnp.asarray(v) for v in (a, b, d)), iters)
        jx = np.asarray(jx)
    finally:
        jhalo.finalize()
    ta, tb, td = (torch.from_numpy(v) for v in (a, b, d))
    x_ser, _ = t_cj.serial_jacobi(ta, tb, td, iters, "hopper")
    comm = sess.comm_split(["hopper", ragent.platform])
    try:
        x_e, res_e = t_cj.collective_jacobi(comm, ta, tb, td, iters)
        _, x_g, res_g = t_cj.collective_jacobi_graph(comm, ta, tb, td, iters)
    finally:
        comm.free()
    assert torch.equal(x_e, x_ser) and torch.equal(x_g, x_e) and res_g == res_e
    np.testing.assert_allclose(x_e.numpy(), jx, **F32_TOL)
    assert res_e == pytest.approx(float(jres), rel=1e-2, abs=1e-12)


def _spy_imap(comm, nodes):
    real = comm.imap

    def spy(*a, **k):
        out = real(*a, **k)
        nodes.extend(out)
        return out
    comm.imap = spy


def test_expert_parallel_over_a_worker_member(sess, worker, ragent, watchdog):
    """``moe_expert_parallel`` over ``["aten", "aten@tw0"]`` is
    bit-identical to ``moe_layer``: the worker's aten agent serves that
    member's four scatter COPYs and its MOE_FFN.  Over ``["aten",
    "hopper@tw0"]`` the worker serves the COPYs on its hopper agent, but
    the member's MOE_FFN runs on the host's torch fail-safe (hopper has no
    MOE_FFN row, so the worker has no clone of one); in float32 that row's
    bits are aten's, so the layer is still bit-identical."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import moe_expert_parallel, moe_layer, moe_param_specs
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=24, capacity_factor=1.25,
                    n_shared=2)
    gen = torch.Generator().manual_seed(3)
    p = {n: torch.randn(s.shape, generator=gen) * s.shape[-2] ** -0.5
         for n, s in moe_param_specs(32, cfg, torch.float32).items()}
    x = torch.randn(2, 20, 32, generator=gen)
    y0, a0 = moe_layer(p, x, cfg, "swiglu")
    aten = worker.agent("aten").attach(sess)
    try:
        served = [worker.heartbeat(timeout=TIMEOUT)["served"]]
        for member in (aten.platform, ragent.platform):
            comm, nodes = sess.comm_split(["aten", member]), []
            _spy_imap(comm, nodes)
            try:
                y, a = moe_expert_parallel(p, x, cfg, "swiglu", comm)
            finally:
                del comm.imap
                comm.free()
            served.append(worker.heartbeat(timeout=TIMEOUT)["served"])
            assert torch.equal(y, y0) and torch.equal(a, a0)
            assert [n.platform for n in nodes] == \
                ["aten", aten.platform if member == aten.platform else "torch"]
        assert served[1]["aten"] - served[0]["aten"] == 5      # 4 COPYs + MOE_FFN
        assert served[1]["hopper"] == served[0]["hopper"]
        assert served[2]["hopper"] - served[1]["hopper"] == 4  # the COPYs only
        assert served[2]["aten"] == served[1]["aten"]
    finally:
        aten._deregister_clones()
        sess.detach_agent(aten.platform)


# ---------------------------------------------------------------------------
# Failure semantics (destructive: private workers)
# ---------------------------------------------------------------------------
def test_dead_worker_mid_jacobi_replays_bit_identical(sess):
    """The worker's hopper MVM wedges mid-collective; killing the process
    then drives transport EOF -> handle_dead_agent -> mark_dead (clones
    deregistered, queue collected) -> comm re-bind -> replay on the
    survivors — and the iterate stays bit-identical to the fault-free run."""
    w = spawn_worker("tw-kill", device="cpu")
    timer = _guard(w)
    try:
        a, b, d = t_cj.problem(48, "cpu", seed=1)
        x_ref, _ = t_cj.serial_jacobi(a, b, d, 3, "hopper")
        agent = w.agent("hopper").attach(sess)
        comm = sess.comm_split(["hopper", agent.platform])
        (x_mix, _), dead_ms = t_mpj.kill_mid_solve(
            w, lambda: t_cj.collective_jacobi(comm, a, b, d, 3),
            timeout=TIMEOUT)
        assert agent.dead and w.dead and dead_ms < 10_000
        assert agent._clones == []        # clones left the registry
        assert not any(r.platform == agent.platform
                       for al in sess.registry.aliases()
                       for r in sess.registry.records(al))
        assert agent.platform not in comm.platforms and comm.size == 2
        assert torch.equal(x_mix, x_ref)
        comm.free()
    finally:
        timer.cancel()
        w.kill()


def test_dead_worker_heartbeat_classifies_dead():
    """The monitor path (DESIGN.md §11): a busy remote agent whose process
    died reports an infinitely stale heartbeat, so a single sweep marks it
    DEAD regardless of the configured timeout."""
    w = spawn_worker("tw-hb", device="cpu", platforms=("torch",))
    timer = _guard(w)
    agent = w.agent("torch")              # deliberately unattached
    gate = threading.Event()
    agent.submit(lambda: gate.wait(TIMEOUT), future=HaloFuture())
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not agent.heartbeat()[1]:
            time.sleep(0.01)
        assert agent.heartbeat()[1]       # busy
        w.kill()
        w.proc.wait(timeout=TIMEOUT)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not w.dead:
            time.sleep(0.01)
        beats, busy, last = agent.heartbeat()
        assert busy and last == float("-inf")
        mon = HealthMonitor(HealthConfig(heartbeat_timeout=30.0))
        mon.register(agent)
        mon.check(now=time.monotonic())
        assert mon.state(agent) == AgentState.DEAD
    finally:
        gate.set()
        timer.cancel()
        agent.shutdown(cancel_pending=True, wait=True)
        w.kill()


def test_request_to_dead_worker_raises():
    """Transport level: a client whose process is gone refuses new requests
    with RemoteWorkerError (no silent hangs); it is an AgentDeadError."""
    a, b = socket.socketpair()
    client = WorkerClient(a, name="dead")
    b.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not client.dead:
        time.sleep(0.01)
    assert client.dead
    with pytest.raises(RemoteWorkerError):
        client.request("ping")
    assert issubclass(RemoteWorkerError, AgentDeadError)


def test_worker_for_the_card_raises_without_one():
    """A worker asked for the card raises where no capability-9.0 card is
    present — in process, and through the launcher, whose exit
    ``spawn_worker`` reports at once — and never serves on the CPU."""
    assert not torch.cuda.is_available()
    a, b = socket.socketpair()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            WorkerRuntime(a, name="tw-card", device="cuda")
    finally:
        a.close()
        b.close()
    t0 = time.monotonic()
    with pytest.raises(RemoteWorkerError):
        spawn_worker("tw-card", device="cuda", timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT


def test_multiproc_jacobi_template(capsys):
    """``python -m repro_torch.multiproc_jacobi --device cpu``: the mixed
    group bit-identical to serial hopper, then the kill drill, with one
    worker (its death leaves the in-process member alone)."""
    t_mpj.main(["--device", "cpu", "--n", "32", "--iters", "3",
                "--workers", "1"])
    out = capsys.readouterr().out
    assert "== serial hopper bit for bit: True" in out
    assert "bit-identical" in out and out.rstrip().endswith("OK")
