"""Slot-based continuous-batching serving stack — port of
``repro.serve.engine``.

Two layers:

* :class:`SlotEngine` — device-facing core: a fixed pool of ``slots``
  decode lanes backed by one persistent slot-indexed cache, updated in
  place.  Admission prefills one request and writes its padded cache into
  a free lane; a decode step runs one batched forward over all lanes with
  per-slot positions and an active-slot mask.
* :class:`StepScheduler` — the host loop.  Each iteration (a) admits queued
  requests into free slots, (b) runs one batched decode step across all
  occupied slots, and (c) retires slots independently on per-request EOS or
  ``max_new``.  ``submit`` returns a :class:`~repro_torch.core.agents.
  HaloFuture` at once, with per-token streaming hooks; host time (T1) and
  blocked device time (T3) accumulate into a
  :class:`~repro_torch.core.portability.ServeReport`.

Not ported yet: PagedEngine and chunked prefill (ROADMAP A7), ServeEngine
and RequestQueue (A7), and the health hooks ``heartbeat``/``attach_health``
(A11).  The port's cache is updated in place and never donated, so the
reference's ``ensure_caches`` rebuild has nothing to do here.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.agents import HaloFuture
from ..core.portability import ServeReport
from ..models.transformer import Model
from .kvcache import evict_slot, insert_slot, pad_caches

log = logging.getLogger("repro_torch.serve.engine")

PyTree = Any


class AdmissionError(RuntimeError):
    """Request rejected by the admission/QoS policy: its class queue-depth
    cap was hit at submit, or it aged out of the queue past ``max_delay``."""


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """Per-class admission limits.  ``max_depth`` caps how many requests of
    the class may sit queued (submit past it raises
    :class:`AdmissionError`); ``max_delay`` bounds how long a queued request
    may wait before it is failed instead of admitted (seconds)."""
    max_depth: Optional[int] = None
    max_delay: Optional[float] = None


@dataclasses.dataclass
class AdmissionPolicy:
    """Admission/QoS policy for :class:`StepScheduler`: ``classes`` maps a
    QoS class name (``submit(qos=...)``) to its limits; unknown classes get
    ``default``.  The paged arena's watermark comes with PagedEngine."""
    classes: Dict[str, QoSClass] = dataclasses.field(default_factory=dict)
    default: QoSClass = QoSClass()

    def qos(self, name: str) -> QoSClass:
        return self.classes.get(name, self.default)


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float) -> torch.Tensor:
    """(B, V) logits → (B,) next tokens: the argmax (first of ties) when
    ``temperature <= 0``, else a draw from softmax(logits / temperature)
    with ``generator``, which lies on the logits' device."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int] = None
    qos: str = "default"
    result: Optional[List[int]] = None
    future: Optional[HaloFuture] = None
    submitted_at: float = 0.0
    started_at: Optional[float] = None      # admission (prefill-into-slot)
    finished_at: Optional[float] = None
    # streaming hook: called as on_token(token, index) from the step thread
    on_token: Optional[Callable[[int, int], None]] = None

    def stream(self, tok: int, index: int) -> None:
        if self.on_token is not None:
            try:
                self.on_token(tok, index)
            except Exception:
                log.exception("on_token hook raised (request %d)", self.uid)


# ---------------------------------------------------------------------------
# Slot engine: fixed decode-lane pool over a slot-indexed cache
# ---------------------------------------------------------------------------
class SlotEngine:
    """Fixed pool of ``slots`` decode lanes over one persistent cache on the
    parameters' device.  Device-facing only — no queueing policy lives
    here."""

    def __init__(self, model: Model, params: PyTree, slots: int,
                 max_len: int):
        if model.cfg.frontend != "none":   # token-embedding frontend only
            raise ValueError("SlotEngine serves token frontends")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.caches = model.init_cache(slots, max_len, device=self.device)

    # -- device bodies -------------------------------------------------------
    def _admit_logits(self, slot: int, toks: torch.Tensor) -> torch.Tensor:
        """Prefill one request (toks (1, S)), write its padded cache into
        lane ``slot``; returns its last-token logits (1, V)."""
        logits, one = self.model.prefill(self.params, {"tokens": toks})
        insert_slot(self.caches, pad_caches(self.model.cfg, one, self.max_len),
                    slot)
        return logits

    def _decode_logits(self, tok: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
        """One batched decode step over every lane; (B, V) logits."""
        logits, _ = self.model.decode_step(self.params, self.caches,
                                           tok[:, None], pos, active)
        return logits

    # -- host surface --------------------------------------------------------
    def prefill_into_slot(self, slot: int, prompt: List[int],
                          generator: Optional[torch.Generator],
                          temperature: float = 0.0) -> int:
        """Admit ``prompt`` into lane ``slot``; returns its first token."""
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits = self._admit_logits(slot, toks)
        return int(sample_tokens(logits, generator, temperature)[0])

    def decode_step(self, tok, pos, active,
                    generator: Optional[torch.Generator],
                    temperature: float = 0.0) -> np.ndarray:
        """One batched decode step across all lanes.  ``tok``/``pos``/
        ``active`` are host (B,) arrays; returns the host (B,) next tokens
        (entries of inactive lanes are garbage — they wrote nothing)."""
        dev = self.device
        logits = self._decode_logits(
            torch.as_tensor(np.asarray(tok), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(pos), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(active), dtype=torch.bool, device=dev))
        return sample_tokens(logits, generator, temperature).cpu().numpy()

    def release_slot(self, slot: int) -> None:
        """Zero a retired lane (see kvcache.evict_slot)."""
        evict_slot(self.caches, slot)


@dataclasses.dataclass
class _Lane:
    """One occupied slot: its request plus the decode cursor."""
    req: Request
    pos: int                 # next cache position this lane writes
    last_tok: int
    tokens: List[int]


# ---------------------------------------------------------------------------
# Step scheduler: admission / step / retirement loop
# ---------------------------------------------------------------------------
class StepScheduler:
    """Continuous-batching loop over a :class:`SlotEngine`.

    ``submit`` returns a future at once; requests are admitted into free
    slots mid-flight and retire independently on their own EOS or
    ``max_new``.  Drive the loop synchronously (``step``/``drain``) or in
    the background (``start``/``stop``, or ``with sched:``)."""

    def __init__(self, engine: SlotEngine, temperature: float = 0.0,
                 seed: int = 0, policy: Optional[AdmissionPolicy] = None):
        self.engine = engine
        self.temperature = temperature
        self.policy = policy or AdmissionPolicy()
        self.rejected = 0        # submits refused at the QoS depth cap
        self.expired = 0         # queued requests aged out past max_delay
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._queue: "collections.deque[Request]" = collections.deque()
        self._lanes: List[Optional[_Lane]] = [None] * engine.slots
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._uid = 0
        self.completed = 0
        # T1/T3 scorecard accumulators (core.portability.ServeReport)
        self._t1 = 0.0
        self._t3 = 0.0
        self._steps = 0
        self._tokens = 0

    # -- submission ----------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16, *,
               eos_id: Optional[int] = None, qos: str = "default",
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> HaloFuture:
        """Enqueue a request; returns a future for its generated tokens.

        ``qos`` names an :class:`AdmissionPolicy` class: a full class queue
        rejects the submit with :class:`AdmissionError`.  ``on_token(token,
        index)`` streams every token (the one sampled from the prefill
        included) from the stepping thread as it lands."""
        prompt = list(map(int, prompt))
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(prompt) + max_new > self.engine.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds the "
                f"engine max_len ({self.engine.max_len})")
        cap = self.policy.qos(qos).max_depth
        with self._cond:
            if self._stop:
                raise RuntimeError(
                    "StepScheduler is stopped; start() it again to submit")
            if cap is not None:
                depth = sum(1 for r in self._queue if r.qos == qos)
                if depth >= cap:
                    self.rejected += 1
                    raise AdmissionError(
                        f"QoS class {qos!r} queue is full "
                        f"({depth}/{cap} queued); rejected")
            self._uid += 1
            fut = HaloFuture(uid=self._uid, alias="generate")
            self._queue.append(Request(self._uid, prompt, max_new,
                                       eos_id=eos_id, qos=qos, future=fut,
                                       submitted_at=time.monotonic(),
                                       on_token=on_token))
            self._cond.notify_all()
        return fut

    # -- introspection -------------------------------------------------------
    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    def active(self) -> int:
        with self._cond:
            return sum(lane is not None for lane in self._lanes)

    def busy(self) -> bool:
        with self._cond:
            return bool(self._queue) or any(lane is not None
                                            for lane in self._lanes)

    def report(self) -> ServeReport:
        return ServeReport(t1_s=self._t1, t3_s=self._t3, steps=self._steps,
                           tokens=self._tokens)

    def reset_stats(self) -> None:
        self._t1 = self._t3 = 0.0
        self._steps = self._tokens = 0

    # -- engine iteration ----------------------------------------------------
    def _fail_active(self, exc: BaseException) -> None:
        """Fail every occupied lane (its cache state is unrecoverable)."""
        with self._cond:
            lanes = [lane for lane in self._lanes if lane is not None]
            self._lanes = [None] * self.engine.slots
        for lane in lanes:
            if lane.req.future is not None:
                lane.req.future.set_exception(exc)

    def _finish(self, req: Request, tokens: List[int]) -> None:
        req.result = tokens
        req.finished_at = time.monotonic()
        self.completed += 1
        if req.future is not None:
            req.future.set_result(list(tokens))

    def _expire_queued(self) -> None:
        """Fail queued requests that aged past their QoS class max_delay."""
        now = time.monotonic()
        expired: List[Request] = []
        with self._cond:
            if not self._queue:
                return
            keep: "collections.deque[Request]" = collections.deque()
            for r in self._queue:
                limit = self.policy.qos(r.qos).max_delay
                if limit is not None and now - r.submitted_at > limit:
                    expired.append(r)
                else:
                    keep.append(r)
            self._queue = keep
        for r in expired:
            self.expired += 1
            if r.future is not None:
                r.future.set_exception(AdmissionError(
                    f"request {r.uid} waited > {self.policy.qos(r.qos).max_delay}s "
                    f"queued (QoS class {r.qos!r}); dropped"))

    def _finish_admission(self, slot: int, req: Request, tok: int) -> None:
        """Take a completed prefill's first token: retire at once on EOS or
        max_new == 1, else occupy the slot."""
        self._tokens += 1
        req.stream(tok, 0)
        if (req.eos_id is not None and tok == req.eos_id) or req.max_new == 1:
            self.engine.release_slot(slot)
            self._finish(req, [tok])
            return
        with self._cond:
            self._lanes[slot] = _Lane(req, pos=len(req.prompt), last_tok=tok,
                                      tokens=[tok])

    def step(self) -> bool:
        """One engine iteration: admit → decode → retire.

        Returns True if any work was done.  Call from a single thread at a
        time (the background loop, or the caller when not started)."""
        t0 = time.perf_counter()
        dev = 0.0
        worked = False
        self._expire_queued()

        # (a) admission: prefill queued requests into free slots, FCFS
        while True:
            with self._cond:
                free = [i for i, lane in enumerate(self._lanes) if lane is None]
                req = self._queue.popleft() if free and self._queue else None
            if req is None:
                break
            slot = free[0]
            worked = True
            req.started_at = time.monotonic()
            d0 = time.perf_counter()
            try:
                tok = self.engine.prefill_into_slot(slot, req.prompt,
                                                    self._gen, self.temperature)
            except Exception as exc:
                dev += time.perf_counter() - d0
                if req.future is not None:
                    req.future.set_exception(exc)
                continue
            dev += time.perf_counter() - d0
            self._finish_admission(slot, req, tok)

        # (b) one batched decode step across all occupied slots
        with self._cond:
            occupied = [(i, lane) for i, lane in enumerate(self._lanes)
                        if lane is not None]
        if occupied:
            worked = True
            b = self.engine.slots
            tok = np.zeros((b,), np.int64)
            pos = np.zeros((b,), np.int64)
            act = np.zeros((b,), bool)
            for i, lane in occupied:
                tok[i], pos[i], act[i] = lane.last_tok, lane.pos, True
            d0 = time.perf_counter()
            try:
                nxt = self.engine.decode_step(tok, pos, act, self._gen,
                                              self.temperature)
            except Exception as exc:
                dev += time.perf_counter() - d0
                self._fail_active(exc)
                self._t3 += dev
                self._t1 += (time.perf_counter() - t0) - dev
                raise
            dev += time.perf_counter() - d0

            # (c) retirement: each slot checks its own EOS / max_new
            for i, lane in occupied:
                t = int(nxt[i])
                lane.tokens.append(t)
                lane.last_tok = t
                lane.pos += 1
                self._tokens += 1
                lane.req.stream(t, len(lane.tokens) - 1)
                if (lane.req.eos_id is not None and t == lane.req.eos_id) \
                        or len(lane.tokens) >= lane.req.max_new:
                    with self._cond:
                        self._lanes[i] = None
                    self.engine.release_slot(i)
                    self._finish(lane.req, lane.tokens)

        if worked:
            self._steps += 1
        self._t3 += dev
        self._t1 += (time.perf_counter() - t0) - dev
        return worked

    def drain(self) -> None:
        """Synchronously step until no queued or in-flight work remains."""
        while self.busy():
            self.step()

    # -- background loop -----------------------------------------------------
    def start(self) -> "StepScheduler":
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._loop,
                                            name="slot-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the loop; by default serve queued + in-flight work first."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.drain()       # step() ignores _stop; only submit is gated
        else:
            with self._cond:
                dropped = list(self._queue)
                self._queue.clear()
                lanes = [lane for lane in self._lanes if lane is not None]
                self._lanes = [None] * self.engine.slots
            for r in dropped:
                if r.future is not None:
                    r.future.cancel()
            for lane in lanes:
                if lane.req.future is not None:
                    lane.req.future.cancel()

    __enter__ = start

    def __exit__(self, *exc_info) -> None:
        self.stop(drain=exc_info[0] is None)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._queue and \
                        not any(lane is not None for lane in self._lanes):
                    self._cond.wait()
                if self._stop:
                    return
            try:
                self.step()
            except Exception:
                # the failed iteration's futures already carry the error;
                # the loop must survive to serve later submissions
                log.exception("slot engine step failed; loop continues")
