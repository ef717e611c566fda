"""Shared tiling arithmetic for the kernel region (port of
``repro.kernels.common``).

The reference's TPU-only helpers (backend probes, interpret-mode default,
Mosaic compiler params, the interpret-mode size cap) have no counterpart
here: the device checks live in :mod:`repro_torch.kernels._cuda`.
"""
from __future__ import annotations

from typing import Tuple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pick_block(size: int, preferred: int, align: int) -> int:
    """Largest aligned block ≤ preferred that does not overshoot wildly."""
    if size >= preferred:
        return preferred
    return max(align, round_up(size, align))


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (1 for n ≤ 1)."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def clamp_block(block: int, size: int, align: int) -> int:
    """Clamp a requested (tuned) block into [align, round_up(size, align)]
    and re-align it, so a config tuned on one shape bucket never produces a
    degenerate or wildly over-padded grid on a smaller shape."""
    padded = round_up(max(1, size), align)
    return max(align, min(round_up(int(block), align), padded))


def block_choices(size: int, align: int, *, limit: int = 3) -> Tuple[int, ...]:
    """Deterministic candidate block sizes for one tiled dimension.

    Candidates depend only on the dimension's power-of-two bucket: the
    standard tile sizes (128…2048) that fit the bucket, plus the bucket
    extent itself, at most ``limit`` of them, evenly spaced with the
    smallest and the bucket extent always kept."""
    bucket = round_up(next_pow2(size), align)
    cands = {bucket}
    for c in (128, 256, 512, 1024, 2048):
        if align <= c <= bucket:
            cands.add(c)
    out = sorted(cands)
    if len(out) > limit:
        step = (len(out) - 1) / (limit - 1)
        out = sorted({out[round(i * step)] for i in range(limit)})
    return tuple(out)
