"""Test-support layer: fault injection for the self-healing runtime
(DESIGN.md §11) — port of ``repro.testing``.

Importable from production code and tests alike, but nothing in the
runtime depends on it: the dependency arrow points from tests to here to
:mod:`repro_torch.core`.
"""
from .faults import (EngineFault, FaultError, FaultPlan, FaultyAgent, chaos,
                     engine_chaos)

__all__ = ["EngineFault", "FaultError", "FaultPlan", "FaultyAgent", "chaos",
           "engine_chaos"]
