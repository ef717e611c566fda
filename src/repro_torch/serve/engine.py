"""Slot-based continuous-batching serving stack — port of
``repro.serve.engine``.

Three layers:

* :class:`SlotEngine` — device-facing core: a fixed pool of ``slots``
  decode lanes backed by one persistent slot-indexed cache, updated in
  place.  Admission prefills one request and writes its padded cache into
  a free lane; a decode step runs one batched forward over all lanes with
  per-slot positions and an active-slot mask.  :class:`PagedEngine` has
  the same surface over block-paged storage, with copy-on-write prefix
  sharing and chunked prefill.
* :class:`StepScheduler` — the host loop.  Each iteration (a) admits queued
  requests into free slots, (a') runs one chunk of every chunked prefill
  in flight, (b) runs one batched decode step across all decoding slots,
  and (c) retires slots independently on per-request EOS or ``max_new``.
  ``submit`` returns a :class:`~repro_torch.core.agents.HaloFuture` at
  once, with per-token streaming hooks; host time (T1) and blocked device
  time (T3) accumulate into a
  :class:`~repro_torch.core.portability.ServeReport`.
* :class:`ServeEngine` / :class:`RequestQueue` — the whole-batch front:
  batch ``generate`` submits one request per prompt row to a slot pool and
  drains it synchronously (stub frontends take the lockstep path);
  ``RequestQueue.flush`` joins requests at batch boundaries with no echo
  lanes.

A :class:`StepScheduler` is a liveness target (DESIGN.md §11): it beats
once per engine iteration, and ``attach_health`` hands it to a
:class:`~repro_torch.core.agents.HealthMonitor`, which fails every queued
and in-flight request with ``AgentDeadError`` when a stepping thread
wedged inside a device call stops the beats.  The port's caches are updated in place and never donated, so the
reference's ``ensure_caches`` rebuild has nothing to do here.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.agents import AgentDeadError, AgentState, HaloFuture
from ..core.c2mpi import halo_session
from ..core.portability import ServeReport
from ..models.transformer import Model
from .kvcache import (BlockPool, copy_block, evict_slot, gather_views,
                      init_paged, insert_slot, leaf_layout, pad_caches,
                      prefix_block_keys, ring_lengths, scatter_slots,
                      scatter_token)

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
    """Admission/QoS policy for :class:`StepScheduler`.

    ``classes`` maps a QoS class name (``submit(qos=...)``) to its limits;
    unknown classes get ``default``.  ``watermark`` is the fraction of the
    paged arena that must remain unreserved *after* an admission — requests
    that would dip below it stay queued (and eventually age out via their
    class ``max_delay``), so sustained overload degrades into bounded
    queueing + rejections instead of an allocator failure mid-decode.
    Dense slot engines ignore it (their memory is fixed at construction)."""
    classes: Dict[str, QoSClass] = dataclasses.field(default_factory=dict)
    default: QoSClass = QoSClass()
    watermark: float = 0.0

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


def _session_device(params: PyTree) -> torch.device:
    """The device of ``params``, which must be the live HALO session's: a
    session made with no device is the card, and raises without one (the
    engines never fall back to the CPU unless ``device="cpu"`` was asked
    for)."""
    dev = params["embed"].device
    session = halo_session().device
    if dev.type != session.type:
        raise ValueError(f"the parameters lie on {dev}, the HALO session runs "
                         f"on {session}")
    return dev


# ---------------------------------------------------------------------------
# Paged engine: block-paged cache with COW prefix sharing + chunked prefill
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _SlotMeta:
    """Host bookkeeping for one paged lane."""
    prompt: List[int]
    generator: Optional[torch.Generator]   # sampling the first token
    temperature: float
    resv: int                   # reservation remaining to draw down
    nblocks: int = 0            # populated block-table entries
    pos: int = 0                # next prompt position to prefill


class PagedEngine:
    """Block-paged drop-in for :class:`SlotEngine`.

    Same host surface (``decode_step`` / ``release_slot``) over block-paged
    storage on the session's device: every sequence-bearing cache leaf
    lives in one preallocated arena of ``block_size``-token blocks, each
    lane maps logical positions through a per-slot block table, and a
    :class:`~repro_torch.serve.kvcache.BlockPool` refcounts the blocks.  On
    top of the dense engine it adds:

    * **copy-on-write prefix sharing** — full prompt blocks are registered
      under content keys; a later admission whose prefix matches reuses the
      resident chain (no prefill compute, no new blocks) and forks a
      private copy the first time it writes a shared block (SWA ring wrap
      included); it is on exactly when the engine chunks;
    * **chunked prefill** — long prompts prefill ``chunk_tokens`` at a time
      (``begin_admission`` → ``continue_admission``), so one long prompt
      interleaves with decode steps instead of stalling active lanes;
    * **admission accounting** — a lane reserves its worst-case block count
      up front (``can_admit``), so decode never exhausts the arena
      mid-flight: overload surfaces at admission, as policy.

    Decode gathers each lane's blocks into a dense per-lane view, runs the
    *unmodified* ``model.decode_step`` on it, and scatters the one written
    entry per leaf back — masked garbage beyond each lane's position scores
    exactly -1e30 either way, so paged decode is bit-identical to the dense
    slot engine.  ``release_slot`` is host-only bookkeeping (refcounts, no
    device work), which is what lets failed lanes free their blocks."""

    def __init__(self, model: Model, params: PyTree, slots: int,
                 max_len: int, *, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 chunk_tokens: Optional[int] = None):
        if model.cfg.frontend != "none":   # token-embedding frontend only
            raise ValueError(
                "PagedEngine serves token frontends; patch/frame stub "
                "frontends go through ServeEngine's lockstep path")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = _session_device(params)
        self.block_size = int(block_size)
        self.blocks_per_lane = -(-max_len // self.block_size)
        self.layout = leaf_layout(model.cfg, max_len)
        self._rings = ring_lengths(self.layout, max_len)
        # chunk length: whole blocks, clamped to the smallest ring so one
        # chunk never writes the same ring slot twice (models.attention)
        cap = min(self._rings) if self._rings else max_len
        if chunk_tokens is None:
            chunk_tokens = 2 * self.block_size
        self.chunk_tokens = (min(int(chunk_tokens), cap)
                             // self.block_size * self.block_size)
        self._chunkable = (model.supports_chunked_prefill()
                           and self.chunk_tokens > 0)
        self.prefix_sharing = self._chunkable
        if num_blocks is None:
            # parity capacity with the dense engine (+1 for the null block),
            # plus per-slot headroom for the worst-case COW fork bound so a
            # full arena of shared-prefix lanes stays admissible
            slack = max((self._fork_bound(s0, max_len - s0)
                         for s0 in range(1, max_len)), default=0)
            num_blocks = slots * (self.blocks_per_lane + slack) + 1
        self.num_blocks = num_blocks
        self.pool = BlockPool(num_blocks, self.block_size)
        self.paged = init_paged(model.cfg, slots, max_len, num_blocks,
                                self.block_size, device=self.device)
        self.tables = np.zeros((slots, self.blocks_per_lane), np.int64)
        self._meta: List[Optional[_SlotMeta]] = [None] * slots
        self.tokens_cached = 0          # positions written (prompt + decode)

    # -- device bodies -------------------------------------------------------
    def _table(self, rows) -> torch.Tensor:
        return torch.as_tensor(self.tables[rows], device=self.device)

    def _admit_logits(self, slot: int, toks: torch.Tensor) -> torch.Tensor:
        """Whole-prompt admission: the dense engine's prefill and pad
        (bit-identical logits), then the padded row scattered into the
        lane's blocks — ring leaves arrive in ring layout already, so every
        leaf writes ring slots 0..min(S0, length).  (1, V) logits."""
        logits, one = self.model.prefill(self.params, {"tokens": toks})
        one = pad_caches(self.model.cfg, one, self.max_len)
        s0 = toks.shape[1]
        row = self._table(slot)
        for ls, arena, view in zip(pytree.tree_leaves(self.layout),
                                   pytree.tree_leaves(self.paged),
                                   pytree.tree_leaves(one)):
            if ls.kind == "lane":
                arena[:, slot] = view[:, 0].to(arena.dtype)
            else:
                scatter_slots(ls, arena, view, row,
                              torch.arange(min(s0, ls.length), device=self.device),
                              self.block_size)
        return logits

    def _chunk_logits(self, slot: int, toks: torch.Tensor, p0: int
                      ) -> torch.Tensor:
        """One prefill chunk for one lane: gather its view, run the chunk,
        scatter the chunk's ring slots back.  Chunkable configurations have
        no lane leaves (no Mamba), so only sequence arenas update.  The
        chunk's last-token (1, V) logits."""
        row = self._table(slot)
        views = gather_views(self.layout, self.paged, row[None, :],
                             self.block_size)
        logits, views = self.model.prefill_chunk(self.params, views, toks, p0)
        c = toks.shape[1]
        for ls, arena, view in zip(pytree.tree_leaves(self.layout),
                                   pytree.tree_leaves(self.paged),
                                   pytree.tree_leaves(views)):
            slots = torch.remainder(
                p0 + torch.arange(c, device=self.device), ls.length)
            scatter_slots(ls, arena, view, row, slots, self.block_size)
        return logits

    def _decode_logits(self, tok: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
        """Gather every lane's view, the unchanged ``decode_step`` on the
        views, the one written entry per leaf scattered back; (B, V)."""
        tables = self._table(slice(None))
        views = gather_views(self.layout, self.paged, tables, self.block_size)
        logits, views = self.model.decode_step(self.params, views,
                                               tok[:, None], pos, active)
        scatter_token(self.layout, self.paged, views, tables, pos, active,
                      self.block_size)
        return logits

    # -- block bookkeeping (host) --------------------------------------------
    def _fork_bound(self, prompt_len: int, max_new: int) -> int:
        """Worst-case COW forks the linear budget does not already cover.

        A *matched* block's fork spends its own (unspent) table-entry unit,
        but a block this lane allocated fresh, registered, and saw another
        lane match can be forced into a fork by a ring-wrap write — a
        second draw for the same entry.  That can only hit registered
        (full-prompt) blocks, and registration only happens when the prompt
        itself never wrapped, so the bound is the wrapped ring slots of the
        decode phase intersected with the registered block range.

        The reference counts those blocks position by position; here in
        closed form: with the prompt within every ring, positions
        [L, P + N) of a ring of L slots wrap onto slots [0, min(P + N − L,
        L)), a prefix of the blocks, so the union over rings is the longest
        such prefix, cut to the prompt's P // bs whole blocks."""
        if not self.prefix_sharing or not self._rings:
            return 0
        if any(prompt_len > length for length in self._rings):
            return 0      # prompt wrapped: its blocks are never registered
        end = prompt_len + max_new
        wrapped = max((-(-min(end - length, length) // self.block_size)
                       for length in self._rings if end > length), default=0)
        return min(wrapped, prompt_len // self.block_size)

    def blocks_for(self, prompt_len: int, max_new: int) -> int:
        """Worst-case blocks one request can consume (tail + COW forks)."""
        return (-(-(prompt_len + max_new) // self.block_size)
                + self._fork_bound(prompt_len, max_new))

    def can_admit(self, prompt_len: int, max_new: int, *,
                  watermark: float = 0.0) -> bool:
        """True when the arena can reserve the request's worst case and
        stay above ``watermark`` (fraction of capacity) afterwards."""
        need = self.blocks_for(prompt_len, max_new)
        floor = int(watermark * self.pool.capacity)
        return self.pool.available() - self.pool.reserved - need >= floor

    def _lane_alloc(self, meta: _SlotMeta) -> int:
        if meta.resv > 0:
            meta.resv -= 1
            return self.pool.alloc(reserved=True)
        return self.pool.alloc()

    def _grow_table(self, slot: int, upto: int) -> None:
        """Extend the lane's block chain to cover positions [0, upto)."""
        meta = self._meta[slot]
        need = -(-upto // self.block_size)
        while meta.nblocks < need:
            self.tables[slot, meta.nblocks] = self._lane_alloc(meta)
            meta.nblocks += 1

    def _prepare_writes(self, slot: int, start: int, count: int) -> None:
        """COW fence: make every block the next write burst touches private.

        The write set for positions [start, start+count) is the full-leaf
        block range plus, per distinct ring length, the wrapped ring slots'
        blocks.  Shared blocks (refcount > 1) fork — host alloc + arena row
        copy — and registered-but-unshared blocks leave the prefix cache,
        since their content is about to stop matching their key.  Forked
        *originals* keep their registration: their content is frozen, so
        later admissions can still match them."""
        meta = self._meta[slot]
        touched = set(range(start // self.block_size,
                            (start + count - 1) // self.block_size + 1))
        for length in self._rings:
            touched.update((p % length) // self.block_size
                           for p in range(start, start + count))
        for j in sorted(touched):
            if j >= meta.nblocks:
                continue                       # fresh block, never shared
            bid = int(self.tables[slot, j])
            if self.pool.refcount(bid) > 1:
                use_resv = meta.resv > 0
                if use_resv:
                    meta.resv -= 1
                new = self.pool.fork(bid, reserved=use_resv)
                copy_block(self.layout, self.paged, bid, new)
                self.tables[slot, j] = new
            elif self.pool.is_registered(bid):
                self.pool.unregister(bid)

    def _register_prompt(self, slot: int, meta: _SlotMeta) -> None:
        if not self.prefix_sharing:
            return
        if any(len(meta.prompt) > length for length in self._rings):
            # the SWA ring wrapped during prefill: these blocks no longer
            # hold the prefix keys their content key would promise
            return
        for i, key in enumerate(prefix_block_keys(meta.prompt,
                                                  self.block_size)):
            bid = int(self.tables[slot, i])
            if not self.pool.is_registered(bid):
                self.pool.register_prefix(bid, key)

    # -- host surface --------------------------------------------------------
    def begin_admission(self, slot: int, prompt: List[int], max_new: int,
                        generator: Optional[torch.Generator],
                        temperature: float = 0.0) -> Optional[int]:
        """Admit ``prompt`` into lane ``slot``.  Returns its first sampled
        token when the prefill completed in this call, or None when a
        chunked prefill is now in flight (drive it with
        ``continue_admission``, one chunk per engine iteration)."""
        s0 = len(prompt)
        need = self.blocks_for(s0, max_new)
        self.pool.reserve(need)
        meta = _SlotMeta(prompt=list(prompt), generator=generator,
                         temperature=float(temperature), resv=need)
        self._meta[slot] = meta
        if self.prefix_sharing:
            # never match the whole prompt: >= 1 suffix token must prefill
            keys = prefix_block_keys(prompt, self.block_size,
                                     limit=(s0 - 1) // self.block_size)
            for i, bid in enumerate(self.pool.match_prefix(keys)):
                self.tables[slot, i] = bid
                meta.nblocks += 1
        meta.pos = meta.nblocks * self.block_size
        if not self._chunkable or (meta.nblocks == 0
                                   and s0 <= self.chunk_tokens):
            return self._admit_whole(slot, meta)
        return self.continue_admission(slot)

    def _admit_whole(self, slot: int, meta: _SlotMeta) -> int:
        s0 = len(meta.prompt)
        self._grow_table(slot, s0)
        toks = torch.tensor([meta.prompt], dtype=torch.long, device=self.device)
        logits = self._admit_logits(slot, toks)
        meta.pos = s0
        self.tokens_cached += s0
        self._register_prompt(slot, meta)
        return int(sample_tokens(logits, meta.generator, meta.temperature)[0])

    def continue_admission(self, slot: int) -> Optional[int]:
        """Run one prefill chunk; returns the first sampled token once the
        whole prompt is in cache, else None."""
        meta = self._meta[slot]
        s0 = len(meta.prompt)
        c = min(self.chunk_tokens, s0 - meta.pos)
        self._grow_table(slot, meta.pos + c)
        self._prepare_writes(slot, meta.pos, c)
        toks = torch.tensor([meta.prompt[meta.pos:meta.pos + c]],
                            dtype=torch.long, device=self.device)
        logits = self._chunk_logits(slot, toks, meta.pos)
        meta.pos += c
        self.tokens_cached += c
        if meta.pos < s0:
            return None
        self._register_prompt(slot, meta)
        return int(sample_tokens(logits, meta.generator, meta.temperature)[0])

    def decode_step(self, tok, pos, active,
                    generator: Optional[torch.Generator],
                    temperature: float = 0.0) -> np.ndarray:
        """One batched decode step; same contract as the dense engine.

        Host prep per active lane: grow the tail block if this position
        crosses a block boundary, then COW-fence the write set — after
        which every block written this step is private, so the gather →
        decode → scatter touches no shared storage."""
        for i, on in enumerate(active):
            if on:
                p = int(pos[i])
                self._grow_table(i, p + 1)
                self._prepare_writes(i, p, 1)
                self.tokens_cached += 1
        dev = self.device
        logits = self._decode_logits(
            torch.as_tensor(np.asarray(tok), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(pos), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(active), dtype=torch.bool, device=dev))
        return sample_tokens(logits, generator, temperature).cpu().numpy()

    def release_slot(self, slot: int) -> None:
        """Host-only retirement: deref the lane's chain and return its
        unused reservation.  No device work — stale arena rows are masked
        by the next reader and overwritten by the next owner — so failed
        lanes release their blocks the same way."""
        meta = self._meta[slot]
        if meta is None:
            return
        for j in range(meta.nblocks):
            self.pool.deref(int(self.tables[slot, j]))
        self.pool.unreserve(meta.resv)
        self.tables[slot, :] = 0
        self._meta[slot] = None

    # failed lanes use the same host-only path (no device call to fail)
    abandon_slot = release_slot

    def ensure_caches(self) -> bool:
        """True: the arenas are intact after a failed call.  The reference
        rebuilds them when a failed jitted call consumed its donated
        buffers; the port updates them in place and never donates, so
        there is nothing to check."""
        return True

    def stats(self) -> Dict[str, Any]:
        """Allocator + sharing scorecard."""
        s = dict(self.pool.stats())
        s["tokens_cached"] = self.tokens_cached
        s["prefix_hit_rate"] = (self.pool.prefix_hits
                                / max(1, self.pool.prefix_queries))
        s["blocks_per_token"] = (self.pool.allocs
                                 / max(1, self.tokens_cached))
        return s


@dataclasses.dataclass
class _Lane:
    """One occupied slot: its request plus the decode cursor.  A lane with
    ``prefilling=True`` is mid chunked-prefill: it owns its slot and blocks
    but does not join the decode batch until admission completes."""
    req: Request
    pos: int                 # next cache position this lane writes
    last_tok: int
    tokens: List[int]
    prefilling: bool = False


# ---------------------------------------------------------------------------
# Step scheduler: admission / step / retirement loop
# ---------------------------------------------------------------------------
class StepScheduler:
    """Continuous-batching loop over a :class:`SlotEngine` or
    :class:`PagedEngine`.

    ``submit`` returns a future at once; requests are admitted into free
    slots mid-flight and retire independently on their own EOS or
    ``max_new``.  Drive the loop synchronously (``step``/``drain``) or in
    the background (``start``/``stop``, or ``with sched:``)."""

    _seq = itertools.count(1)

    def __init__(self, engine, temperature: float = 0.0,
                 seed: int = 0, policy: Optional[AdmissionPolicy] = None):
        self.engine = engine
        self.temperature = temperature
        self.policy = policy or AdmissionPolicy()
        self.rejected = 0        # submits refused at the QoS depth cap
        self.expired = 0         # queued requests aged out past max_delay
        self.name = f"slot-engine-{next(StepScheduler._seq)}"
        self._beats = 0
        self._last_beat = time.monotonic()
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._queue: "collections.deque[Request]" = collections.deque()
        self._lanes: List[Optional[_Lane]] = [None] * engine.slots
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._uid = 0
        # held by callers that drive this scheduler end to end (submit +
        # drain): one stepping thread when one scheduler is shared
        # (ServeEngine.generate, RequestQueue.flush)
        self.drive_lock = threading.Lock()
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
            if not self._queue and not any(lane is not None
                                           for lane in self._lanes):
                # a busy period starts now: the liveness stall clock runs
                # from here, not from whenever the last request finished
                self._last_beat = time.monotonic()
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

    def heartbeat(self):
        """Liveness probe for :class:`~repro_torch.core.agents.HealthMonitor`:
        ``(progress counter, busy, last activity)``.  Busy means queued or
        in-flight requests exist; the counter advances once per engine
        iteration (and once more when it did work), so a stepping thread
        wedged inside a device call, or a scheduler nobody drives, stalls
        and gets flagged."""
        with self._cond:
            busy = bool(self._queue) or any(lane is not None
                                            for lane in self._lanes)
            return self._beats, busy, self._last_beat

    def _beat(self) -> None:
        with self._cond:
            self._beats += 1
            self._last_beat = time.monotonic()

    def attach_health(self, monitor) -> "StepScheduler":
        """Register with a :class:`~repro_torch.core.agents.HealthMonitor`:
        when the monitor declares this scheduler DEAD (its stepping thread
        stopped advancing while work was pending), every queued and
        in-flight request fails with :class:`AgentDeadError`, and a paged
        engine's failed lanes give their blocks back, instead of leaving
        clients blocked on futures that never resolve."""
        monitor.register(self)
        monitor.on_transition(self._on_health_transition)
        return self

    def _on_health_transition(self, target, old: str, new: str) -> None:
        if target is not self or new != AgentState.DEAD:
            return
        exc = AgentDeadError(
            f"{self.name} declared dead (engine loop stopped making "
            f"progress); queued and in-flight requests failed")
        log.error("%s", exc)
        with self._cond:
            dropped = list(self._queue)
            self._queue.clear()
        for r in dropped:
            if r.future is not None:
                r.future.set_exception(exc)
        self._fail_active(exc)

    def report(self) -> ServeReport:
        return ServeReport(t1_s=self._t1, t3_s=self._t3, steps=self._steps,
                           tokens=self._tokens)

    def reset_stats(self) -> None:
        self._t1 = self._t3 = 0.0
        self._steps = self._tokens = 0

    # -- engine iteration ----------------------------------------------------
    def _abandon(self, slot: int) -> None:
        """Release a failed lane's blocks.  Paged engines expose the
        host-only ``abandon_slot`` (refcount bookkeeping); the dense
        engine's lane state is garbage the next ``insert_slot`` overwrites
        whole, so it has nothing to release."""
        release = getattr(self.engine, "abandon_slot", None)
        if release is None:
            return
        try:
            release(slot)
        except Exception:
            log.exception("abandon_slot(%d) failed", slot)

    def _fail_active(self, exc: BaseException) -> None:
        """Fail every occupied lane (its cache state is unrecoverable)."""
        with self._cond:
            lanes = [(i, lane) for i, lane in enumerate(self._lanes)
                     if lane is not None]
            self._lanes = [None] * self.engine.slots
        for i, lane in lanes:
            self._abandon(i)
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

    def _admissible(self, req: Request) -> bool:
        """Free-memory gate: paged engines must cover the request's
        worst-case blocks and stay above the policy watermark; dense
        engines always admit (their memory is fixed per slot)."""
        can = getattr(self.engine, "can_admit", None)
        if can is None:
            return True
        return can(len(req.prompt), req.max_new,
                   watermark=self.policy.watermark)

    def _finish_admission(self, slot: int, req: Request, tok: int) -> None:
        """Take a completed prefill's first token: retire at once on EOS or
        max_new == 1, else occupy the slot."""
        self._tokens += 1
        req.stream(tok, 0)
        if (req.eos_id is not None and tok == req.eos_id) or req.max_new == 1:
            with self._cond:
                self._lanes[slot] = None
            self.engine.release_slot(slot)
            self._finish(req, [tok])
            return
        with self._cond:
            self._lanes[slot] = _Lane(req, pos=len(req.prompt), last_tok=tok,
                                      tokens=[tok])

    def _admission_failed(self, slot: int, req: Request,
                          exc: BaseException) -> None:
        with self._cond:
            self._lanes[slot] = None
        self._abandon(slot)
        if req.future is not None:
            req.future.set_exception(exc)

    def step(self) -> bool:
        """One engine iteration: admit → prefill chunks → decode → retire.

        Returns True if any work was done.  Call from a single thread at a
        time (the background loop, or the caller when not started)."""
        t0 = time.perf_counter()
        dev = 0.0
        worked = False
        self._beat()          # claim the iteration: a hang inside it stalls
        self._expire_queued()

        # (a) admission: prefill queued requests into free slots.  FCFS — a
        # head-of-queue request the watermark cannot cover yet blocks later
        # ones (no starvation of big prompts); it ages out via its QoS
        # max_delay if the arena never drains enough
        begin = getattr(self.engine, "begin_admission", None)
        while True:
            with self._cond:
                free = [i for i, lane in enumerate(self._lanes) if lane is None]
                req = None
                if free and self._queue and self._admissible(self._queue[0]):
                    req = self._queue.popleft()
            if req is None:
                break
            slot = free[0]
            worked = True
            req.started_at = time.monotonic()
            d0 = time.perf_counter()
            try:
                if begin is not None:
                    with self._cond:
                        # hold the slot before the device call: a chunked
                        # admission spans iterations
                        self._lanes[slot] = _Lane(req, pos=0, last_tok=-1,
                                                  tokens=[], prefilling=True)
                    tok = begin(slot, req.prompt, req.max_new, self._gen,
                                self.temperature)
                else:
                    tok = self.engine.prefill_into_slot(
                        slot, req.prompt, self._gen, self.temperature)
            except Exception as exc:
                dev += time.perf_counter() - d0
                self._admission_failed(slot, req, exc)
                continue
            dev += time.perf_counter() - d0
            if tok is not None:            # else a chunked prefill in flight
                self._finish_admission(slot, req, tok)

        # (a') chunked prefills: one chunk per prefilling lane per iteration,
        # so a long prompt interleaves with decode instead of stalling it
        with self._cond:
            prefilling = [(i, lane) for i, lane in enumerate(self._lanes)
                          if lane is not None and lane.prefilling]
        for i, lane in prefilling:
            worked = True
            d0 = time.perf_counter()
            try:
                tok = self.engine.continue_admission(i)
            except Exception as exc:
                dev += time.perf_counter() - d0
                self._admission_failed(i, lane.req, exc)
                continue
            dev += time.perf_counter() - d0
            if tok is not None:              # else more chunks to go
                self._finish_admission(i, lane.req, tok)

        # (b) one batched decode step across all decoding slots
        with self._cond:
            occupied = [(i, lane) for i, lane in enumerate(self._lanes)
                        if lane is not None and not lane.prefilling]
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
            self._beat()
        self._t3 += dev
        self._t1 += (time.perf_counter() - t0) - dev
        return worked

    def drain(self) -> None:
        """Synchronously step until no queued or in-flight work remains."""
        while self.busy():
            self.step()

    def cancel_pending(self) -> None:
        """Cancel queued (not yet admitted) requests — synchronous callers
        use it to recover from a failed drain, so leftovers never leak into
        their next batch."""
        with self._cond:
            dropped = list(self._queue)
            self._queue.clear()
        for r in dropped:
            if r.future is not None:
                r.future.cancel()

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
                lanes = [(i, lane) for i, lane in enumerate(self._lanes)
                         if lane is not None]
                self._lanes = [None] * self.engine.slots
            for r in dropped:
                if r.future is not None:
                    r.future.cancel()
            for i, lane in lanes:
                self._abandon(i)
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


# ---------------------------------------------------------------------------
# Whole-batch front (thin wrappers over the slot engine)
# ---------------------------------------------------------------------------
def _as_rows(prompts, device) -> torch.Tensor:
    """(B, S0) prompts (a tensor or nested lists) as int64 on ``device``."""
    return torch.as_tensor(prompts, dtype=torch.long, device=device)


@dataclasses.dataclass
class ServeEngine:
    """Whole-batch front: ``generate`` is a thin wrapper over the slot
    engine — one request per prompt row, drained synchronously.  Non-token
    frontends (patch/frame stubs) and ``batch_extra`` callers take the
    lockstep loop (``_generate_lockstep``)."""

    model: Model
    max_len: int = 256

    #: distinct batch widths kept warm by ``generate`` — each holds its own
    #: slot pool, so the path stays bounded even when a RequestQueue
    #: produces every live-batch width in 1..batch_size
    MAX_CACHED_WIDTHS = 4

    def __post_init__(self):
        self._scheds: "collections.OrderedDict[int, StepScheduler]" = \
            collections.OrderedDict()
        self._scheds_lock = threading.Lock()      # guards the width cache

    def _sched_for(self, b: int, params) -> StepScheduler:
        """Width-``b`` scheduler from the LRU cache (dict access only — the
        caller takes the scheduler's own ``drive_lock`` before driving it,
        so different widths run concurrently)."""
        with self._scheds_lock:
            sched = self._scheds.get(b)
            if sched is None:
                sched = StepScheduler(SlotEngine(self.model, params, b,
                                                 self.max_len))
                self._scheds[b] = sched
                while len(self._scheds) > self.MAX_CACHED_WIDTHS:  # LRU evict
                    self._scheds.popitem(last=False)
            else:
                self._scheds.move_to_end(b)
        return sched

    def generate(self, params, prompts, max_new: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 batch_extra: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """prompts (B, S0) → (B, max_new) int64 generated tokens, on the
        parameters' device (the HALO session's).

        Rows are submitted to a width-``B`` slot pool and drained
        synchronously, so admission prefills row by row; latency-sensitive
        traffic should drive a long-lived :class:`StepScheduler` instead.
        ``generator`` (default: seed 0 on the device) draws the samples
        when ``temperature > 0``."""
        dev = _session_device(params)
        rows = _as_rows(prompts, dev)
        b, s0 = rows.shape
        if s0 + max_new > self.max_len:
            raise ValueError(f"prompt ({s0}) + max_new ({max_new}) exceeds "
                             f"max_len ({self.max_len})")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if batch_extra or self.model.cfg.frontend != "none":
            return self._generate_lockstep(params, rows, max_new,
                                           temperature=temperature,
                                           generator=generator,
                                           batch_extra=batch_extra)
        sched = self._sched_for(b, params)
        with sched.drive_lock:       # same-width calls serialize; different
            sched.engine.params = params       # widths proceed concurrently
            sched.temperature = temperature
            sched._gen = generator
            futs = [sched.submit(r, max_new=max_new) for r in rows.tolist()]
            sched.drain()
        return torch.tensor([f.result() for f in futs], dtype=torch.long,
                            device=dev)

    def _generate_lockstep(self, params, prompts, max_new: int, *,
                           temperature: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           batch_extra: Optional[Dict[str, torch.Tensor]] = None
                           ) -> torch.Tensor:
        """The whole-batch path: one batched prefill (with ``batch_extra``,
        e.g. ``patches``), then lockstep decode at a scalar position —
        ``s0 + prefix_len`` onward for ``patch_embed``.  Serves the stub
        frontends, and is the slot engine's parity reference.

        ``frame_embed`` is refused: lockstep decoding feeds the sampled
        tokens back, where that frontend's ``decode_step`` takes (B, 1, D)
        frame embeddings, and the stub has no codec that maps one to the
        other.  The reference fails there too (it unpacks the (B, 1) token
        as embeddings).  Drive such a model through ``Model.prefill`` and
        ``Model.decode_step`` with frame embeddings."""
        cfg = self.model.cfg
        if cfg.frontend == "frame_embed":
            raise ValueError(
                f"{cfg.name}: lockstep decoding feeds sampled tokens where the "
                f"frame_embed frontend takes (B, 1, D) frame embeddings; drive "
                f"Model.prefill and Model.decode_step with frames instead")
        dev = params["embed"].device
        prompts = _as_rows(prompts, dev)
        b, s0 = prompts.shape
        prefix = cfg.prefix_len if cfg.frontend == "patch_embed" else 0
        if s0 + prefix + max_new > self.max_len:
            raise ValueError(f"prefix ({prefix}) + prompt ({s0}) + max_new "
                             f"({max_new}) exceeds max_len ({self.max_len})")
        batch = {"tokens": prompts, **(batch_extra or {})}
        logits, caches = self.model.prefill(params, batch)
        caches = pad_caches(cfg, caches, self.max_len)
        pos = s0 + prefix                      # next cache slot to write
        tok = sample_tokens(logits, generator, temperature)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, caches = self.model.decode_step(params, caches, tok, pos + i)
            tok = sample_tokens(logits, generator, temperature)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)


class RequestQueue:
    """Whole-batch front for the serving engine.

    ``submit`` enqueues and returns a future for the request's generated
    tokens.  Batches run either synchronously via ``flush`` or from the
    background drain loop (``start``/``stop``, or ``with queue:``), which
    flushes as soon as the batch is full or the oldest submission is
    ``max_delay`` seconds old.  Requests *join* only at batch boundaries,
    but each flush drives one dedicated ``batch_size``-wide slot pool, so
    there are no pad lanes and every request retires at its own
    ``max_new`` / ``eos_id`` instead of the batch max.  For mid-flight
    join/leave use :class:`StepScheduler` directly."""

    def __init__(self, engine: ServeEngine, params, batch_size: int,
                 prompt_len: int, max_delay: float = 0.05,
                 temperature: float = 0.0):
        self.engine = engine
        self.params = params
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.max_delay = max_delay
        self.temperature = temperature
        self._queue: List[Request] = []
        self._cond = threading.Condition()
        self._drain: Optional[threading.Thread] = None
        self._stop = False
        self._uid = 0
        self._sched: Optional[StepScheduler] = None

    def _flush_sched(self) -> StepScheduler:
        """The queue's fixed-width slot pool, built once, under the queue
        lock; the caller drives the scheduler under its ``drive_lock``."""
        with self._cond:
            if self._sched is None:
                self._sched = StepScheduler(
                    SlotEngine(self.engine.model, self.params,
                               self.batch_size, self.engine.max_len))
            return self._sched

    def submit(self, prompt: List[int], max_new: int = 16,
               eos_id: Optional[int] = None) -> HaloFuture:
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        # flush frames every prompt to prompt_len, so that is the bound
        if self.prompt_len + max_new > self.engine.max_len:
            raise ValueError(
                f"prompt_len ({self.prompt_len}) + max_new ({max_new}) "
                f"exceeds the engine max_len ({self.engine.max_len})")
        with self._cond:
            if self._stop:
                raise RuntimeError(
                    "RequestQueue is stopped; start() it again to submit")
            self._uid += 1
            fut = HaloFuture(uid=self._uid, alias="generate")
            self._queue.append(Request(self._uid, list(prompt), max_new,
                                       eos_id=eos_id, future=fut,
                                       submitted_at=time.monotonic()))
            self._cond.notify_all()
        return fut

    def ready(self) -> bool:
        return len(self._queue) >= self.batch_size

    def pending(self) -> int:
        return len(self._queue)

    def flush(self) -> List[Request]:
        """Serve the oldest queued requests through the flush pool,
        completing their futures.  Only live rows are submitted — no pad
        lanes — and each row retires at its own ``max_new`` / ``eos_id``
        (prompts keep the fixed ``prompt_len`` framing)."""
        with self._cond:
            live = self._queue[: self.batch_size]
            self._queue = self._queue[self.batch_size:]
        if not live:
            return []
        sched = self._flush_sched()
        try:
            with sched.drive_lock:   # client flush() vs background drain loop
                sched.engine.params = self.params
                sched.temperature = self.temperature
                futs = [sched.submit(
                    (r.prompt + [0] * self.prompt_len)[: self.prompt_len],
                    max_new=r.max_new, eos_id=r.eos_id) for r in live]
                sched.drain()
            outs = [f.result(timeout=1.0) for f in futs]
        except Exception as exc:
            # whole-batch failure semantics: leftovers are cancelled so
            # they never leak into the next batch
            sched.cancel_pending()
            for r in live:
                if r.future is not None and not r.future.done():
                    r.future.set_exception(exc)
            raise
        for r, out in zip(live, outs):
            r.result = out
            if r.future is not None:
                r.future.set_result(out)
        return live

    # -- background drain loop -----------------------------------------------
    def start(self) -> "RequestQueue":
        if self._drain is None or not self._drain.is_alive():
            self._stop = False
            self._drain = threading.Thread(target=self._drain_loop,
                                           name="serve-drain", daemon=True)
            self._drain.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the loop; by default serve whatever is still queued first."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._drain is not None:
            self._drain.join()
            self._drain = None
        if drain:
            while self._queue:
                try:
                    self.flush()
                except Exception:   # that batch's futures carry the error
                    log.exception("flush failed during drain")
        else:
            with self._cond:
                dropped, self._queue = self._queue, []
            for r in dropped:
                if r.future is not None:
                    r.future.cancel()

    __enter__ = start

    def __exit__(self, *exc_info) -> None:
        self.stop(drain=exc_info[0] is None)

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._queue:
                    self._cond.wait()
                if self._stop:
                    return
                # deadline batching: run as soon as the batch is full or the
                # oldest request has waited long enough
                while not self._stop and len(self._queue) < self.batch_size:
                    left = (self._queue[0].submitted_at + self.max_delay
                            - time.monotonic()) if self._queue else None
                    if left is None or left <= 0:
                        break
                    self._cond.wait(timeout=left)
                if self._stop or not self._queue:
                    continue
            try:
                self.flush()
            except Exception:
                # the failed batch's futures already carry the exception; the
                # loop must survive to serve later submissions
                log.exception("flush failed; drain loop continues")
