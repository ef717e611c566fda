"""KV cache utilities for the serving pool — port of the dense-slot half of
``repro.serve.kvcache``.

Every leaf of the model's cache tree is stacked ``(R, B, ...)`` (leading
R = the stage's stacked layers) and a *slot* is a batch lane on axis 1;
leaves keep their own types (Mamba's float32 SSM state beside bfloat16
conv states and keys).
``insert_slot`` and ``evict_slot`` write the pooled slot cache in place;
``pad_caches`` grows a prefill cache to its serving length.  The
block-paged arena (``BlockPool``, block tables, COW) comes with
PagedEngine (ROADMAP A7).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..configs.base import ArchConfig
from ..models.transformer import ring_len

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
