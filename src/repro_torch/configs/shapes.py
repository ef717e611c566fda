"""Input-shape applicability rules (assignment: long_500k needs sub-quadratic
attention — skipped for pure full-attention archs, documented in DESIGN.md §5)."""
from __future__ import annotations

from .base import ArchConfig, InputShape


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True
