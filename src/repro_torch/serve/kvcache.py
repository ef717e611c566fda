"""KV/SSM cache utilities for the serving pool — port of
``repro.serve.kvcache``.

Two storage models over the same model-produced cache tree, both updated
in place on the engine's device:

* **Dense slots** — every leaf is stacked ``(R, B, ...)`` (leading R = the
  stage's stacked layers) and a *slot* is a batch lane on axis 1:
  ``insert_slot`` / ``evict_slot`` / ``pad_caches``.  Leaves keep their
  own types (Mamba's float32 SSM state beside bfloat16 conv states and
  keys).
* **Block-paged** — sequence-bearing leaves are laid out as one arena of
  fixed-size blocks per leaf, ``(R, num_blocks, ..., block_size, ...)``,
  indexed through a per-slot block table: :class:`BlockPool` (host
  refcounted allocator with prefix reuse), ``leaf_layout`` / ``init_paged``
  (planning), ``gather_views`` (blocks → dense per-lane view for the
  unmodified decode math), ``scatter_token`` / ``scatter_slots`` (written
  entries → arena), ``copy_block`` (COW fork).  Plain indexing
  (``index_select``, advanced-index assignment): the reference has no
  kernel here either.

Block 0 of every arena is the *null block*: never allocated, kept all-zero
(inactive-lane scatters are value-zeroed and redirected to it), so padded
block-table entries always point at valid, masked-out storage.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..configs.base import ArchConfig
from ..models.transformer import cache_specs, ring_len

PyTree = Any


def insert_slot(full: PyTree, one: PyTree, slot: int) -> None:
    """Write a padded single-request cache (batch-1 lanes) into lane
    ``slot`` of the pooled cache, in place.  The whole lane is replaced, so
    nothing a retired occupant left behind leaks into the new request."""
    for f, o in zip(pytree.tree_leaves(full), pytree.tree_leaves(one)):
        f[:, slot] = o[:, 0].to(f.dtype)


def evict_slot(full: PyTree, slot: int) -> None:
    """Zero lane ``slot`` in place — retirement hygiene: correctness never
    depends on it (``insert_slot`` overwrites the whole lane and decode
    masks inactive lanes), but a freed slot holds no stale keys."""
    for f in pytree.tree_leaves(full):
        f[:, slot].zero_()


def _to_ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """(R,B,H,S0,dh) prefill keys → (R,B,H,window,dh) ring buffer: position
    p lives at slot p % window, as the decode writer puts it."""
    s0 = k.shape[3]
    if s0 <= window:
        return F.pad(k, (0, 0, 0, window - s0))
    return torch.roll(k[:, :, :, s0 - window:], s0 % window, dims=3)


def pad_caches(cfg: ArchConfig, caches: PyTree, target_len: int) -> PyTree:
    """Grow every attention cache's sequence axis to its serving length:
    GQA (R,B,Hkv,S,dh) ×2, the shared block's included → pad axis 3,
    ring-rolled for sliding-window layers; MLA's latent and rope key
    (R,B,S,lat), (R,B,S,rdh) → pad axis 2.  Mamba's conv and SSM states are
    O(1) and pass through unchanged."""
    out = []
    for i, st in enumerate(cfg.stages):
        blocks = []
        for j, spec in enumerate(st.pattern):
            if spec.kind == "mamba":
                blocks.append(caches[i][j])
                continue
            a = cfg.shared_attn if spec.kind == "shared_attn" else spec.attn
            if a.kv_lora:
                pad = (0, 0, 0, target_len - caches[i][j][0].shape[2])
                blocks.append(tuple(F.pad(c, pad) for c in caches[i][j]))
                continue
            tgt = ring_len(cfg, a, target_len)
            ck, cv = caches[i][j]
            if tgt < target_len:                       # SWA ring layer
                blocks.append((_to_ring(ck, tgt), _to_ring(cv, tgt)))
            else:
                pad = (0, 0, 0, tgt - ck.shape[3])
                blocks.append((F.pad(ck, pad), F.pad(cv, pad)))
        out.append(tuple(blocks))
    return out


# ---------------------------------------------------------------------------
# Block-paged layout planning
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Paging metadata for one cache leaf.

    ``kind`` is ``"seq"`` for sequence-bearing leaves (GQA K/V, MLA latent
    and rope caches — paged into blocks along their sequence axis) or
    ``"lane"`` for O(1) per-lane state (Mamba conv/SSM — kept dense and
    slot-indexed).  ``seq_axis``/``length`` describe the stacked
    ``(R, B, ...)`` dense leaf; position ``p`` lives at ring slot
    ``p % length`` (identity for full-length leaves)."""
    kind: str
    seq_axis: int = 0
    length: int = 0


def _zip_map(fn, layout: PyTree, *trees: PyTree) -> PyTree:
    """``fn(spec, *leaves)`` over the :class:`LeafSpec` leaves of
    ``layout`` and the matching leaves of ``trees`` (same nesting); the
    results in ``layout``'s nesting."""
    specs, treedef = pytree.tree_flatten(layout)
    others = [pytree.tree_leaves(t) for t in trees]
    return pytree.tree_unflatten(
        [fn(ls, *leaves) for ls, *leaves in zip(specs, *others)], treedef)


def leaf_layout(cfg: ArchConfig, max_len: int) -> PyTree:
    """A tree of :class:`LeafSpec` mirroring the model's cache tree."""
    out = []
    for st in cfg.stages:
        blocks = []
        for spec in st.pattern:
            a = cfg.shared_attn if spec.kind == "shared_attn" else spec.attn
            if spec.kind == "mamba":
                blocks.append((LeafSpec("lane"),) * 3)   # conv_x, conv_bc, ssm
            elif a.kv_lora:
                blocks.append((LeafSpec("seq", 2, max_len),
                               LeafSpec("seq", 2, max_len)))
            else:
                lr = ring_len(cfg, a, max_len)
                blocks.append((LeafSpec("seq", 3, lr), LeafSpec("seq", 3, lr)))
        out.append(tuple(blocks))
    return out


def ring_lengths(layout: PyTree, max_len: int) -> List[int]:
    """Distinct SWA ring lengths (< max_len) across all sequence leaves."""
    return sorted({s.length for s in pytree.tree_leaves(layout)
                   if s.kind == "seq" and s.length < max_len})


def init_paged(cfg: ArchConfig, slots: int, max_len: int, num_blocks: int,
               block_size: int, device="cpu") -> PyTree:
    """Zero-initialized paged cache tree on ``device``: sequence leaves
    become ``(R, num_blocks, ..., block_size, ...)`` arenas, lane leaves
    stay the dense ``(R, slots, ...)`` slot-indexed state."""
    def build(ls: LeafSpec, sp):
        shape = list(sp.shape)
        if ls.kind == "seq":
            shape[1] = num_blocks
            shape[ls.seq_axis] = block_size
        return torch.zeros(tuple(shape), dtype=sp.dtype, device=device)

    return _zip_map(build, leaf_layout(cfg, max_len),
                    cache_specs(cfg, slots, max_len))


# ---------------------------------------------------------------------------
# Paged device ops
# ---------------------------------------------------------------------------
def gather_views(layout: PyTree, paged: PyTree, tables: torch.Tensor,
                 block_size: int) -> PyTree:
    """Blocks → dense per-lane views, ``(R, B, ..., length, ...)`` per leaf.

    ``tables`` is the (B, max_blocks) int64 block table on the arenas'
    device.  Each sequence leaf gathers the first ``ceil(length /
    block_size)`` table entries and flattens them back into a contiguous
    sequence axis, cut to exactly the dense row length — so the unmodified
    decode/chunk attention math runs on the view and never sees the block
    structure.  Unwritten positions read whatever their block holds (zeros
    from the null block, stale keys from a reused one); the per-lane
    position masks exclude them exactly, so decode on a gathered view is
    bit-identical to decode on the dense slot cache.  A lane leaf's view is
    its arena itself, which the model advances in place."""
    b = tables.shape[0]

    def g(ls: LeafSpec, arena: torch.Tensor):
        if ls.kind == "lane":
            return arena
        m = -(-ls.length // block_size)
        rows = arena.index_select(1, tables[:, :m].reshape(-1))
        rows = rows.reshape(arena.shape[:1] + (b, m) + arena.shape[2:])
        rows = torch.movedim(rows, 2, ls.seq_axis)       # block dim beside bs
        view = rows.reshape(rows.shape[:ls.seq_axis] + (m * block_size,)
                            + rows.shape[ls.seq_axis + 2:])
        return view.narrow(ls.seq_axis, 0, ls.length)

    return _zip_map(g, layout, paged)


def scatter_token(layout: PyTree, paged: PyTree, views: PyTree,
                  tables: torch.Tensor, pos: torch.Tensor,
                  active: torch.Tensor, block_size: int) -> None:
    """Write each lane's single decode-step cache entry back into the arenas,
    in place.

    ``pos``/``active`` are (B,) — every sequence leaf wrote exactly ring
    slot ``pos % length`` in its view; that entry is read out and scattered
    to ``(tables[lane, slot // bs], slot % bs)``.  Inactive lanes are
    redirected to the null block with a zero value, so block 0 stays
    all-zero and no shared block is ever touched (COW forking made every
    written block private before this runs).  Lane leaves (Mamba state)
    were advanced in place by the model, inactive lanes masked."""
    b = tables.shape[0]
    lane = torch.arange(b, device=tables.device)

    def s(ls: LeafSpec, arena: torch.Tensor, view: torch.Tensor):
        if ls.kind == "lane":
            return
        slot = torch.remainder(pos, ls.length)
        bid = torch.where(active, tables[lane, slot // block_size], 0)
        off = torch.where(active, torch.remainder(slot, block_size), 0)
        loc: list = [slice(None)] * view.ndim
        loc[1], loc[ls.seq_axis] = lane, slot
        # (B, R, ...) when the two index tensors are apart, (R, B, ...) when
        # they sit side by side: the same layout the arena's write takes
        val = view[tuple(loc)]
        lane_axis = 1 if ls.seq_axis == 2 else 0
        keep = active.reshape((1,) * lane_axis + (b,)
                              + (1,) * (val.ndim - lane_axis - 1))
        val = torch.where(keep, val, torch.zeros((), dtype=val.dtype,
                                                 device=val.device))
        loc[1], loc[ls.seq_axis] = bid, off
        arena[tuple(loc)] = val.to(arena.dtype)

    _zip_map(s, layout, paged, views)


def scatter_slots(ls: LeafSpec, arena: torch.Tensor, view: torch.Tensor,
                  table_row: torch.Tensor, slots: torch.Tensor,
                  block_size: int) -> None:
    """Scatter ring slots ``slots`` of a single-lane view into the arena, in
    place.

    Admission building block: the whole-prompt path writes slots
    ``0..min(S0, length)`` of the padded prefill cache, the chunk path
    writes ``(p0 + arange(C)) % length`` (injective while C ≤ ring length,
    which the engine's chunk clamp guarantees)."""
    bid = table_row[slots // block_size]
    off = torch.remainder(slots, block_size)
    val = view.index_select(ls.seq_axis, slots)[:, 0]   # drop the lane dim
    if ls.seq_axis != 2:
        # the two index tensors sit apart: the arena's write puts them first
        val = torch.movedim(val, ls.seq_axis - 1, 0)
    loc: list = [slice(None)] * arena.ndim
    loc[1], loc[ls.seq_axis] = bid, off
    arena[tuple(loc)] = val.to(arena.dtype)


def copy_block(layout: PyTree, paged: PyTree, src: int, dst: int) -> None:
    """COW fork: copy arena row ``src`` into ``dst`` on every sequence leaf,
    in place (one block id indexes the same row across all arenas)."""
    def c(ls: LeafSpec, arena: torch.Tensor):
        if ls.kind == "seq":
            arena[:, dst] = arena[:, src]

    _zip_map(c, layout, paged)


# ---------------------------------------------------------------------------
# Host-side block allocator
# ---------------------------------------------------------------------------
class NoFreeBlocks(RuntimeError):
    """The arena has no free or evictable block left."""


def prefix_block_keys(tokens: Sequence[int], block_size: int,
                      limit: Optional[int] = None) -> List[Tuple[int, ...]]:
    """Content keys for each whole block of a token prefix.

    Key ``i`` is the exact token tuple covering blocks ``0..i`` — chained
    content addressing with no hash collisions (a block is reusable only
    when everything before it matched too).  ``limit`` caps the number of
    keys (admission never matches the *entire* prompt: at least one suffix
    token must run through prefill to produce the first sampled logits)."""
    n = len(tokens) // block_size
    if limit is not None:
        n = min(n, limit)
    return [tuple(tokens[:(i + 1) * block_size]) for i in range(n)]


class BlockPool:
    """Refcounted host allocator over a fixed arena of KV blocks.

    Block 0 is the null block — reserved at construction, never allocated.
    The remaining ids are partitioned into three disjoint states:

    * **free** — on the free list, content garbage;
    * **live** — refcount ≥ 1 (one reference per lane block-table entry);
    * **reusable** — refcount 0 but still registered in the prefix cache:
      an LRU of retired prompt blocks that a later ``match_prefix`` can
      revive without recomputing their keys, evicted on allocation pressure.

    ``reserve``/``alloc(reserved=True)`` implement admission-time
    worst-case accounting: a lane reserves ``ceil((S0 + max_new) / bs)``
    blocks up front (enough to cover every later tail allocation *and*
    every COW fork of a matched block), so decode can never hit
    :class:`NoFreeBlocks` mid-flight.  ``check()`` asserts the full
    invariant set — the property tests call it after every operation."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.reset()

    def reset(self) -> None:
        """Drop all bookkeeping back to the empty-arena state."""
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._reusable: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self._key_of: Dict[int, tuple] = {}
        self._bid_of: Dict[tuple, int] = {}
        self.reserved = 0
        self.allocs = 0
        self.forks = 0
        self.evictions = 0
        self.prefix_hits = 0
        self.prefix_queries = 0

    # -- introspection -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    def free_blocks(self) -> int:
        return len(self._free)

    def live_blocks(self) -> int:
        return len(self._ref)

    def available(self) -> int:
        """Blocks an allocation could obtain: free + evictable reusable."""
        return len(self._free) + len(self._reusable)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def is_registered(self, bid: int) -> bool:
        return bid in self._key_of

    def stats(self) -> Dict[str, int]:
        return {"capacity": self.capacity, "free": len(self._free),
                "live": len(self._ref), "reusable": len(self._reusable),
                "reserved": self.reserved, "allocs": self.allocs,
                "forks": self.forks, "evictions": self.evictions,
                "prefix_hits": self.prefix_hits,
                "prefix_queries": self.prefix_queries}

    # -- reservations ------------------------------------------------------
    def can_reserve(self, n: int) -> bool:
        return self.available() - self.reserved >= n

    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise NoFreeBlocks(
                f"cannot reserve {n} blocks ({self.available()} available, "
                f"{self.reserved} already reserved)")
        # Reservations are honored from the free list alone: a later
        # match_prefix may revive reusable blocks (moving them live without
        # an alloc), which must never strand a reservation.  Evict LRU
        # reusable blocks up front until the free list covers every unit.
        while len(self._free) - self.reserved < n:
            bid, _ = self._reusable.popitem(last=False)
            self._drop_registration(bid)
            self._free.append(bid)
            self.evictions += 1
        self.reserved += n

    def unreserve(self, n: int) -> None:
        if n > self.reserved:
            raise ValueError(f"unreserve({n}) exceeds reserved "
                             f"({self.reserved})")
        self.reserved -= n

    # -- allocation / refcounting -----------------------------------------
    def alloc(self, *, reserved: bool = False) -> int:
        """Take a block (refcount 1).  ``reserved=True`` draws down a prior
        ``reserve``; otherwise the allocation must fit beside every
        outstanding reservation."""
        if reserved:
            # reserve() pre-evicted into the free list: reserved <= free
            if self.reserved < 1:
                raise ValueError("alloc(reserved=True) with no reservation")
            self.reserved -= 1
            bid = self._free.pop()
        else:
            if self.available() - self.reserved < 1:
                raise NoFreeBlocks(
                    f"arena exhausted ({self.available()} available, "
                    f"{self.reserved} reserved)")
            # never dip the free list below the reserved floor — evict a
            # reusable block instead so reservations stay honorable
            if len(self._free) > self.reserved:
                bid = self._free.pop()
            else:
                bid, _ = self._reusable.popitem(last=False)   # evict LRU
                self._drop_registration(bid)
                self.evictions += 1
        self._ref[bid] = 1
        self.allocs += 1
        return bid

    def ref(self, bid: int) -> None:
        if bid not in self._ref:
            raise ValueError(f"ref of non-live block {bid}")
        self._ref[bid] += 1

    def deref(self, bid: int) -> None:
        """Drop one reference.  At zero the block parks on the reusable LRU
        if still prefix-registered, else returns to the free list."""
        c = self._ref.get(bid)
        if c is None:
            raise ValueError(f"double free of block {bid}")
        if c > 1:
            self._ref[bid] = c - 1
            return
        del self._ref[bid]
        key = self._key_of.get(bid)
        if key is not None:
            self._reusable[bid] = key
            self._reusable.move_to_end(bid)
        else:
            self._free.append(bid)

    def fork(self, bid: int, *, reserved: bool = False) -> int:
        """COW: allocate a private target for shared block ``bid`` and drop
        this lane's reference to the original.  The device copy
        (``copy_block``) is the caller's job."""
        if self.refcount(bid) < 2:
            raise ValueError(f"fork of unshared block {bid} "
                             f"(refcount {self.refcount(bid)})")
        new = self.alloc(reserved=reserved)
        self.deref(bid)
        self.forks += 1
        return new

    # -- prefix cache ------------------------------------------------------
    def _drop_registration(self, bid: int) -> None:
        key = self._key_of.pop(bid, None)
        if key is not None:
            self._bid_of.pop(key, None)

    def register_prefix(self, bid: int, key: tuple) -> bool:
        """Publish a live block as holding the prefix ``key``; False if the
        key (or block) is already registered."""
        if key in self._bid_of or bid in self._key_of:
            return False
        if bid not in self._ref:
            raise ValueError(f"register of non-live block {bid}")
        self._key_of[bid] = key
        self._bid_of[key] = bid
        return True

    def unregister(self, bid: int) -> None:
        """Withdraw a live block from the prefix cache — the engine calls
        this before writing a registered unshared block in place, since its
        content is about to stop matching its key."""
        self._drop_registration(bid)

    def match_prefix(self, keys: Sequence[tuple]) -> List[int]:
        """Longest resident chain matching ``keys``; every matched block
        gains a reference (revived off the reusable LRU when parked)."""
        out: List[int] = []
        for key in keys:
            self.prefix_queries += 1
            bid = self._bid_of.get(key)
            if bid is None:
                break
            self.prefix_hits += 1
            if bid in self._reusable:
                del self._reusable[bid]
                self._ref[bid] = 1
            else:
                self._ref[bid] += 1
            out.append(bid)
        return out

    # -- invariants --------------------------------------------------------
    def check(self) -> None:
        """Assert every allocator invariant; raises AssertionError on the
        first violation.  O(blocks) — cheap enough to run after every
        operation in the property tests."""
        def inv(cond: bool, msg: str) -> None:
            if not cond:
                raise AssertionError(f"BlockPool invariant violated: {msg}\n"
                                     f"  stats={self.stats()}")

        free, reuse, live = (set(self._free), set(self._reusable),
                             set(self._ref))
        inv(len(free) == len(self._free), "free list holds duplicates")
        inv(not free & reuse and not free & live and not reuse & live,
            "free/reusable/live states overlap")
        inv(free | reuse | live == set(range(1, self.num_blocks)),
            "blocks leaked or fabricated (partition != 1..N-1)")
        inv(0 not in free | reuse | live, "null block 0 entered circulation")
        inv(all(c >= 1 for c in self._ref.values()),
            "live block with refcount < 1")
        inv(0 <= self.reserved <= len(self._free),
            "reservations exceed the free list (a reserved alloc would "
            "have to evict or fail)")
        inv(len(self._key_of) == len(self._bid_of)
            and all(self._bid_of[k] == b for b, k in self._key_of.items()),
            "prefix registry is not a bijection")
        inv(all(b in self._key_of for b in reuse),
            "reusable block without a prefix registration")
