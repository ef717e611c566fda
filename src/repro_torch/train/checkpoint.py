"""Fault-tolerant checkpointing: atomic, async, integrity-checked — port of
``repro.train.checkpoint``.

* **Atomic**: write into ``<dir>/.tmp-<step>`` then ``os.replace`` to
  ``step_<N>`` — a crash mid-save never corrupts the latest checkpoint.
* **Async**: the device→host copy happens synchronously, file I/O on a
  background thread so the step loop is not blocked.
* **Integrity**: per-file CRC32 recorded in meta.json and verified on
  restore; a corrupt or partial checkpoint is skipped and the previous
  one used.
* **GC**: keep the newest ``keep`` checkpoints.

Leaves are written in ``jax.tree``'s order (``core.tree``), one
``leaf_{i:05d}.npy`` each, whole (logical shapes).  numpy has no bfloat16:
such a leaf is stored as its uint16 bit pattern, and meta.json records
every leaf's dtype.  The trainer's comm mode saves the same
``TrainState`` leaves as the single-device trainer (``Trainer._comm_state``),
so a checkpoint of either mode restores into the other.

Under a mesh (``distributed.sharding.mesh_context`` with a process group)
every rank holds the whole state (the global view), so rank 0 alone
writes: the other ranks' saves write nothing, and no two ranks ever touch
one ``.tmp-<step>``.  A waited save ends at a barrier of every rank, and
a restore starts at one (rank 0 first finishes its save in flight) and
ends at another, so no rank reads a checkpoint before it is whole or
while another is being written.  Leaves are whole, so a checkpoint
restores onto any mesh or none (the reference's elastic reshard, in the
global view).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import logging
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.tree import tree_flatten, tree_unflatten
from ..distributed.sharding import current_context

log = logging.getLogger("repro_torch.ckpt")
PyTree = Any


def _host(t) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype name); bfloat16 as its bits."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    name = str(t.dtype).split(".")[-1]
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy(), name
    return t.numpy().copy(), name


def _mesh_rank() -> Optional[int]:
    """This process's rank under a mesh with a process group, else None."""
    if current_context().mesh is None or not dist.is_initialized():
        return None
    return dist.get_rank()


def _tensor(arr: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: PyTree, wait: bool = False) -> None:
        """Write ``state`` as ``step`` (rank 0 alone under a mesh); with
        ``wait``, return once it is on disk (under a mesh, on every rank)."""
        rank = _mesh_rank()
        if not rank:
            leaves, _ = tree_flatten(state)
            host = [_host(x) for x in leaves]
            self.wait()                     # one in flight at a time
            self._pending = self._pool.submit(self._write, step, host)
            if wait:
                self.wait()
        if wait and rank is not None:
            dist.barrier()

    def _write(self, step: int, leaves) -> None:
        base = Path(self.directory)
        tmp = base / f".tmp-{step}"
        final = base / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        crcs = []
        for i, (arr, _) in enumerate(leaves):
            fn = tmp / f"leaf_{i:05d}.npy"
            np.save(fn, arr, allow_pickle=False)
            crcs.append(zlib.crc32(fn.read_bytes()) & 0xFFFFFFFF)
        meta = {"step": step, "n_leaves": len(leaves), "crcs": crcs,
                "dtypes": [name for _, name in leaves]}
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        log.info("checkpoint saved: %s", final)
        self._gc()

    def _gc(self) -> None:
        ckpts = self.list_steps()
        for step in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(Path(self.directory) / f"step_{step:08d}",
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def list_steps(self):
        out = []
        for p in Path(self.directory).glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def _valid(self, path: Path) -> bool:
        meta_f = path / "meta.json"
        if not meta_f.exists():
            return False
        meta = json.loads(meta_f.read_text())
        for i, crc in enumerate(meta["crcs"]):
            fn = path / f"leaf_{i:05d}.npy"
            if not fn.exists():
                return False
            if (zlib.crc32(fn.read_bytes()) & 0xFFFFFFFF) != crc:
                log.warning("CRC mismatch in %s (leaf %d)", path, i)
                return False
        return True

    @contextlib.contextmanager
    def _reading(self):
        """Under a mesh: rank 0's save in flight finished and every rank
        at a barrier before the read, and again after it."""
        rank = _mesh_rank()
        if rank is None:
            yield
            return
        if rank == 0:
            self.wait()
        dist.barrier()
        yield
        dist.barrier()

    def restore(self, step: int, like: PyTree) -> PyTree:
        """The checkpoint of ``step`` as a tree shaped like ``like``, each
        leaf on ``like``'s leaf's device and in its dtype."""
        with self._reading():
            return self._read(step, like)

    def _read(self, step: int, like: PyTree) -> PyTree:
        path = Path(self.directory) / f"step_{step:08d}"
        if not self._valid(path):
            raise IOError(f"invalid checkpoint at {path}")
        dtypes = json.loads((path / "meta.json").read_text())["dtypes"]
        flat_like, spec = tree_flatten(like)
        if len(flat_like) != len(dtypes):
            raise IOError(f"{path} holds {len(dtypes)} leaves, the state "
                          f"{len(flat_like)}")
        leaves = [_tensor(np.load(path / f"leaf_{i:05d}.npy", allow_pickle=False),
                          dtypes[i], ref) for i, ref in enumerate(flat_like)]
        return tree_unflatten(spec, leaves)

    def restore_latest(self, like: PyTree) -> Tuple[Optional[PyTree], int]:
        """Newest *valid* checkpoint (skipping corrupt ones), or (None, 0);
        on every rank under a mesh."""
        with self._reading():
            for step in reversed(self.list_steps()):
                path = Path(self.directory) / f"step_{step:08d}"
                if self._valid(path):
                    return self._read(step, like), step
                log.warning("skipping invalid checkpoint %s", path)
            return None, 0

    def wait(self):
        """Block until the save in flight is on disk; re-raise its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()
