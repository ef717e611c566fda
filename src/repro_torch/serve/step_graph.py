"""Decode steps captured once into a CUDA graph and replayed — the port's
counterpart of the reference's ``jax.jit(decode, donate_argnums=(1,))``
(``repro.serve.engine``: ``SlotEngine``, ``PagedEngine`` and
``ServeEngine``'s lockstep loop).

The reference compiles its decode step once, at a fixed ``(slots, 1)``
token shape, and runs the program on every later step.  A
:class:`StepGraph` does the same on the card:

* the first step under a key runs the body eagerly, on the device's
  capture stream: it builds the kernel library, sets the kernels'
  attributes, makes cuBLAS's per-stream state and fills the allocator,
  outside any capture.  It is a real step (its caches advance once), so
  no warm-up loop runs the body twice on live lanes.  Every step graph of
  the process shares that stream, so its eager steps and captures take
  turns: work another thread queued on a stream while it captures would
  be recorded into the capture and never run;
* the second step copies its inputs into static buffers and captures the
  body into a CUDA graph (``capture_error_mode="thread_local"``: the
  scheduler steps on its own thread beside the health monitor's and the
  agents').  Capture executes nothing, so no cache is written twice; the
  graph then replays once for the step's own result;
* every later step copies its inputs into the static buffers and replays.

Selection (``RuntimeAgent.dispatch``), the TuningDB merge and the kernel
wrappers' checks run once, at capture.  What they read is the key
(:func:`capture_key`): the session, the registry's records, the
quarantine, the TuningDB and its generation, the platforms the session may
run on, and the storage of every parameter and cache leaf.  A key that
moves drops the graph, and the next step starts over with an eager step:
a rebound parameter tree never replays stale addresses, while an in-place
write to a parameter is seen as the reference sees new values.

A replay runs no wrapper, so it counts no launch itself: the capture's
launches are noted (``kernels._cuda.recording_launches``) and credited to
the counters on every later replay, and a replay makes no dispatch, so
dispatch counts and T1 count one pass a capture.  Sampling stays outside
the graph, and a step returns a fresh tensor, not the static output the
next replay overwrites.  The CPU, and sessions whose decode cannot be
captured — under a device mesh (the ``shard_map`` bodies) or with an agent
that runs its records off the caller's stream, a worker process or the
sharded substrate (``RuntimeAgent.capturable_platforms``) — run every step
eagerly, and :attr:`StepGraph.eager_steps` says so.  A capture or a
replay that raises propagates; nothing falls back to the eager body.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree

from ..core.c2mpi import halo_session
from ..distributed.sharding import current_context
from ..kernels import _cuda

PyTree = Any

#: one capture stream a device index, shared by every step graph as
#: ``torch.cuda.graph`` shares its own: cuBLAS keeps a workspace for each
#: (handle, stream) pair it meets for the life of the process, so a
#: stream a graph would grow that memory with every engine made
_STREAMS: Dict[int, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()
#: held while work runs on a capture stream (an eager step or a capture):
#: another thread's work queued there during a capture would be recorded
#: into it, not run
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector off for the block: a collection on the
    capturing thread that frees another CUDA graph destroys it, a call
    refused while the stream captures, which invalidates the capture.  The
    switch is the process's, so the block runs under ``_CAPTURE_LOCK``."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    with _STREAMS_LOCK:
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in _STREAMS:
            _STREAMS[index] = torch.cuda.Stream(device)
        return _STREAMS[index]


def _storage(tree: PyTree) -> tuple:
    """Address, shape and type of every tensor leaf."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


def capture_key(device: torch.device, params: PyTree,
                caches: PyTree) -> Optional[tuple]:
    """What a captured decode step froze, or None where the step must run
    eagerly: on the CPU, under a device mesh, or where an agent of the
    session runs its records off the caller's stream."""
    if device.type != "cuda" or current_context().mesh is not None:
        return None
    session = halo_session()
    platforms = session.capturable_platforms()
    if platforms is None:
        return None
    sched = session.scheduler
    tuning = sched.tuning if sched is not None else None
    return (session, session.registry.generation, platforms,
            tuple(sched.failed_record_keys()) if sched is not None else (),
            tuning, tuning.generation if tuning is not None else 0,
            _storage(params), _storage(caches))


class StepGraph:
    """One decode step, captured once into a CUDA graph and replayed.

    Call the graph with the step's key (:func:`capture_key`), its body and
    its inputs, on the host or on the card: ``body(*inputs)`` computes the
    step from device tensors and returns its (B, V) logits, and may update
    caches in place.  With ``key`` None the step runs the body eagerly on
    the current stream.  The graph keeps no reference to the body (an
    engine's bound method), so an engine and its graph form no cycle and
    free their device memory as soon as the engine is dropped."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self._key: Optional[tuple] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: list = []
        self._out: Optional[torch.Tensor] = None
        self._launches: Dict[_cuda.LaunchCounter, int] = {}
        self._lock = threading.Lock()

    def stats(self) -> Dict[str, int]:
        """Steps by how they ran: captured (each then replayed once),
        replayed, and run eagerly."""
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps}

    def _drop(self) -> None:
        self._key, self._graph, self._out = None, None, None
        self._static, self._launches = [], {}

    def __call__(self, key: Optional[tuple], body: Callable[..., torch.Tensor],
                 *inputs: torch.Tensor) -> torch.Tensor:
        with self._lock:
            if key is None:
                self.eager_steps += 1
                return body(*(x.to(self.device) for x in inputs))
            if self._graph is None or key != self._key:
                if key != self._key:
                    self._drop()
                    self._key = key
                    self.eager_steps += 1
                    return self._side(body, *inputs)
                self._capture(body, inputs)
            else:
                for s, x in zip(self._static, inputs):
                    s.copy_(x)
                _cuda.credit_launches(self._launches)
            self._graph.replay()
            self.replays += 1
            return self._out.clone()

    def _side(self, fn, *inputs) -> Any:
        """``fn`` on the device's capture stream, ordered after and before
        the caller's stream, one thread at a time in the process.  Memory
        the capture stream frees is reused only by later work on it, which
        waits for its caller's stream first."""
        side = _capture_stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                out = fn(*(x.to(self.device) for x in inputs))
            caller.wait_stream(side)
        return out

    def _capture(self, body, inputs) -> None:
        """Capture the body on the capture stream the eager step ran on;
        its launches count once here, for the replay that follows."""
        self._static = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                        for x in inputs]
        for s, x in zip(self._static, inputs):
            s.copy_(x)
        graph = torch.cuda.CUDAGraph()

        def capture(*static):
            with _no_collection():
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = body(*static)
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:   # noqa: BLE001 — the body's error is the one to raise
                        pass
                    raise
                graph.capture_end()
            return out

        with _cuda.recording_launches() as noted:
            out = self._side(capture, *self._static)
        self._graph, self._out, self._launches = graph, out, dict(noted)
        self.captures += 1
