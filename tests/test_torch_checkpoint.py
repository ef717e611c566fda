"""The port's checkpointing and fault-tolerance hooks
(``repro_torch.train.checkpoint``, ``repro_torch.train.fault_tolerance``):
the reference's round trip, GC, corrupt skip, atomic write and async save,
with a bfloat16 leaf kept bit for bit through its uint16 file, leaf files
in ``jax.tree``'s order, a TrainState restored onto its own structure, and
the launcher going on after the checkpointed step (the reference's replays
it: pinned).  A checkpoint written under a mesh (rank 0 alone) and
restored on another mesh and on none is in test_torch_mesh_train.py; a
comm-mode checkpoint's round trip through the single-device trainer is in
test_torch_train_parallel.py.
"""
import json
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.optim.adamw import AdamWState
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import HeartbeatJournal, StragglerPolicy
from repro_torch.train.trainer import TrainState


def _state(seed: int = 0, scale: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    # keys out of sorted order: the files follow jax.tree's sorted order
    return {"w": torch.randn((16, 8), generator=g) * scale,
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "mu": torch.zeros((16, 8))},
            "emb": (torch.randn((4, 6), generator=g) * scale).to(torch.bfloat16)}


def _leaves_equal(a, b):
    from repro_torch.core.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip_keeps_bfloat16_bits(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    state = _state()
    cm.save(10, state, wait=True)
    restored, step = cm.restore_latest(like=_state(seed=1))
    assert step == 10
    _leaves_equal(restored, state)
    meta = json.loads((tmp_path / "step_00000010" / "meta.json").read_text())
    assert meta["dtypes"] == ["bfloat16", "float32", "int32", "float32"]
    assert np.load(tmp_path / "step_00000010" / "leaf_00000.npy").dtype == np.uint16


def test_leaf_files_follow_jax_tree_order(tmp_path):
    """leaf_i holds the i-th leaf of jax.tree.flatten of the same tree."""
    cm = CheckpointManager(str(tmp_path))
    state = _state()
    cm.save(1, state, wait=True)
    as_np = jax.tree.map(lambda t: t.float().numpy(), state,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    for i, want in enumerate(jax.tree.leaves(as_np)):
        got = np.load(tmp_path / "step_00000001" / f"leaf_{i:05d}.npy")
        if got.dtype == np.uint16:
            got = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_train_state_roundtrip(tmp_path):
    p = {"b": torch.randn(3).to(torch.bfloat16), "a": torch.randn(2, 2)}
    zeros = {k: torch.zeros(v.shape) for k, v in p.items()}
    state = TrainState(params=p, opt=AdamWState(torch.tensor(7, dtype=torch.int32),
                                                zeros, {k: v + 1 for k, v in zeros.items()}))
    cm = CheckpointManager(str(tmp_path))
    cm.save(7, state, wait=True)
    like = TrainState(params={k: torch.zeros_like(v) for k, v in p.items()},
                      opt=AdamWState(torch.tensor(0, dtype=torch.int32), zeros, zeros))
    restored, step = cm.restore_latest(like=like)
    assert step == 7 and isinstance(restored, TrainState)
    assert restored.err_fb is None and int(restored.opt.step) == 7
    _leaves_equal(restored, state)


def test_keep_n_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _state(s, s), wait=True)
    assert cm.list_steps() == [3, 4]


def test_corrupt_checkpoint_skipped(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    cm.save(1, _state(1, 1.0), wait=True)
    cm.save(2, _state(2, 2.0), wait=True)
    # corrupt the newest checkpoint
    victim = Path(tmp_path) / "step_00000002" / "leaf_00000.npy"
    victim.write_bytes(b"garbage")
    restored, step = cm.restore_latest(like=_state())
    assert step == 1            # fell back to the previous valid checkpoint
    _leaves_equal(restored, _state(1, 1.0))
    with pytest.raises(IOError, match="invalid checkpoint"):
        cm.restore(2, like=_state())


def test_atomic_no_partial_dirs(tmp_path, monkeypatch):
    """A save that dies mid-write leaves only its .tmp dir, never a step_
    dir: the last good checkpoint stays the newest."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, _state(), wait=True)
    names = [p.name for p in Path(tmp_path).iterdir()]
    assert not any(n.startswith(".tmp") for n in names)

    def boom(fn, arr, allow_pickle):
        raise OSError("disk gone")
    monkeypatch.setattr(t_ckpt.np, "save", boom)
    with pytest.raises(OSError, match="disk gone"):
        cm.save(6, _state(), wait=True)
    monkeypatch.undo()
    assert cm.list_steps() == [5]
    assert cm.restore_latest(like=_state())[1] == 5


def test_async_save_writes_on_a_background_thread(tmp_path, monkeypatch):
    cm = CheckpointManager(str(tmp_path))
    release, writers = threading.Event(), []
    orig = CheckpointManager._write

    def slow_write(self, step, leaves):
        writers.append(threading.get_ident())
        assert release.wait(timeout=30)
        return orig(self, step, leaves)
    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    t0 = time.perf_counter()
    cm.save(1, _state())              # returns before file IO completes
    assert time.perf_counter() - t0 < 5.0
    assert cm.list_steps() == []
    release.set()
    cm.wait()
    assert cm.list_steps() == [1]
    assert writers and writers[0] != threading.get_ident()


def test_heartbeat_journal(tmp_path):
    hb = HeartbeatJournal(str(tmp_path / "hb.jsonl"), worker="w3")
    assert hb.stalled(stall_after_s=1.0)          # no beats yet
    hb.beat(12)
    assert not hb.stalled(stall_after_s=60.0)
    assert hb.resume_step() == 12
    assert hb.stalled(stall_after_s=0.0, now=time.time() + 100)


def test_straggler_policy():
    sp = StragglerPolicy(factor=3.0)
    flags = [sp.observe(1.0) for _ in range(10)]
    assert not any(flags)
    assert sp.observe(10.0)                        # 10× median → straggler
    assert sp.recommendation() == "drain-slow-host-at-next-checkpoint"
    sp.observe(1.0)
    assert sp.recommendation() == "ok"


def _beats(path: Path):
    return [json.loads(line)["step"] for line in path.read_text().splitlines()]


def test_launch_train_resumes_after_the_checkpointed_step(tmp_path):
    """A run of 3 steps saves step 2, which holds step 2's update; a run of
    5 from that checkpoint goes on with steps 3 and 4."""
    from repro_torch.launch import train as t_launch
    flags = ["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
             "--seq-len", "8", "--batch", "2", "--ckpt-dir", str(tmp_path / "ck"),
             "--heartbeat", str(tmp_path / "hb.jsonl")]
    t_launch.main(flags + ["--steps", "3"])
    hist = t_launch.main(flags + ["--steps", "5"])
    assert _beats(tmp_path / "hb.jsonl") == [0, 1, 2, 3, 4]
    assert [s for s, _ in hist] == [4]
    assert CheckpointManager(str(tmp_path / "ck")).list_steps() == [2, 4]


def test_reference_launcher_resume_replays_the_checkpointed_step(tmp_path):
    """Pinned fault of the reference (ROADMAP §C): its launcher resumes at
    the checkpoint's step, whose update the checkpoint already holds, so
    step 1's batch is applied twice."""
    from repro.launch import train as j_launch
    flags = ["--arch", "h2o-danube-1.8b", "--reduced", "--seq-len", "8", "--batch", "2",
             "--ckpt-dir", str(tmp_path / "ck"), "--heartbeat", str(tmp_path / "hb.jsonl")]
    j_launch.main(flags + ["--steps", "2"])
    j_launch.main(flags + ["--steps", "3"])
    assert _beats(tmp_path / "hb.jsonl") == [0, 1, 1, 2]
